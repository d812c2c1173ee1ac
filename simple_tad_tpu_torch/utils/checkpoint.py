"""Training checkpoints with the reference's retention semantics, on
``torch.save``.

Port of simple_tad_tpu/utils/checkpoint.py (reference: utils.py:450-545
and run_frame_finetuning.py:668-700), in <output_dir>:
  * ``checkpoint-last.pth``: the full train state {params (fp32 masters),
    optimizer state, step, epoch, the mask generator's state, ema},
    overwritten every epoch and read by auto-resume;
  * ``checkpoint-best<metric>.pth``: weights-only snapshots kept per
    tracked metric (auroc, ap, acc, mccauc);
  * ``checkpoint-<N>.pth``: periodic weights-only snapshots.
Weights-only files hold {'model': state_dict}, so the eval CLI's
``--finetune`` reads them.  These files are not readable by the JAX
package, nor its checkpoints by the port.  Writes go to a temporary file
that is then renamed over the target.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

LAST = "checkpoint-last.pth"


def _path(output_dir: str, name: str) -> str:
    return os.path.join(os.path.abspath(output_dir), name)


def _save(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree.detach().cpu() if torch.is_tensor(tree) else tree


def save_train_state(output_dir: str, state, epoch: int,
                     name: str = LAST) -> None:
    """The full training state for resume.  In a data-parallel run every
    rank calls it (the optimizer gathers its ZeRO shards) and rank 0
    writes, with every rank's drop-path generator state."""
    from simple_tad_tpu_torch.parallel import multihost
    optimizer = _cpu(state.optimizer.state_dict())
    generators = multihost.allgather_object(state.generator.get_state())
    if not multihost.is_main_process():
        return
    _save({"params": _cpu(state.model.state_dict()),
           "optimizer": optimizer,
           "step": state.step, "epoch": epoch,
           "generator": generators[0], "generators": generators,
           "ema": _cpu(state.ema)}, _path(output_dir, name))


def load_train_state(output_dir: str, state, name: str = LAST):
    """Restore ``state`` in place from checkpoint-last -> (state, next
    epoch), or (state, 0) if there is none.  Every rank of a data-parallel
    run loads the file (written at any world size); each rank's drop-path
    generator takes the state saved for its rank, or, for a rank the file
    has none for, rank 0's re-seeded with the rank folded in."""
    path = _path(output_dir, name)
    if not os.path.exists(path):
        return state, 0
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state.model.load_state_dict(ckpt["params"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
    from simple_tad_tpu_torch.parallel import multihost
    from simple_tad_tpu_torch.parallel.mesh import rank_seed
    rank = multihost.rank()
    saved = ckpt.get("generators") or [ckpt["generator"]]
    state.generator.set_state(saved[min(rank, len(saved) - 1)])
    if rank >= len(saved):
        state.generator.manual_seed(rank_seed(
            state.generator.initial_seed() + state.step, rank))
    if state.ema is not None and ckpt["ema"] is not None:
        for n, t in state.ema.items():
            t.copy_(ckpt["ema"][n])
    return state, int(ckpt["epoch"]) + 1


def save_weights(output_dir: str, weights: Dict[str, torch.Tensor],
                 name: str) -> None:
    """Weights-only snapshot (best-metric / periodic), by rank 0."""
    from simple_tad_tpu_torch.parallel.multihost import is_main_process
    if not is_main_process():
        return
    _save({"model": _cpu(dict(weights))}, _path(output_dir, name + ".pth"))


class BestTracker:
    """Tracks best-so-far metrics and writes best-metric snapshots
    (run_frame_finetuning.py:668-700 semantics: auroc, ap, acc, mccauc)."""

    METRICS = ("auroc", "ap", "acc", "mccauc")

    def __init__(self, output_dir: str):
        self.output_dir = output_dir
        self.best: Dict[str, float] = {m: -np.inf for m in self.METRICS}

    def update(self, weights, values: Dict[str, float]) -> Dict[str, float]:
        improved = {}
        for m in self.METRICS:
            if m in values and values[m] > self.best[m]:
                self.best[m] = values[m]
                save_weights(self.output_dir, weights, f"checkpoint-best{m}")
                improved[m] = values[m]
        return improved
