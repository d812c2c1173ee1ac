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

Under tensor parallelism (the model built with a parallel/tp.py:
ModelParallel) the files hold whole, unpadded tensors all the same: the
model ranks of data rank 0 gather their shares of the parameters, the
optimizer state and the EMA (parallel/tp.py:gather_state_dict) and rank 0
writes; a load slices each tensor to the loading rank's share
(parallel/tp.py:shard_state_dict), so a checkpoint reads back at any world
size and any model-parallel size, as it does across ZeRO partitions.
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


def _model_parallel(model):
    """The model's parallel/tp.py:ModelParallel where it is split over more
    than one rank, else None."""
    tp = getattr(model, "tp", None)
    return tp if tp is not None and tp.size > 1 else None


def _whole(tree, model, tp):
    """{name: this rank's share} (or None) -> the whole tensors, gathered
    over the model group (a collective of the model group)."""
    if tree is None:
        return None
    from simple_tad_tpu_torch.parallel.tp import gather_state_dict
    return gather_state_dict(tree, model.cfg.num_heads, tp)


def _share(tree, model, tp):
    """{name: whole tensor} (or None) -> this model rank's shares."""
    if tree is None or tp is None:
        return tree
    from simple_tad_tpu_torch.parallel.tp import shard_state_dict
    return shard_state_dict(tree, model.cfg.num_heads, tp.size, tp.rank)


def save_train_state(output_dir: str, state, epoch: int,
                     name: str = LAST) -> None:
    """The full training state for resume.  In a data-parallel run every
    rank calls it (the optimizer gathers its ZeRO shards) and rank 0
    writes, with every data rank's drop-path generator state.  Under
    tensor parallelism the model ranks of data rank 0 gather the whole
    tensors first (the grid is parallel/tp.py:make_2d_mesh's: data rank =
    rank // model size)."""
    from simple_tad_tpu_torch.parallel import multihost
    optimizer = state.optimizer.state_dict()
    params, ema = state.model.state_dict(), state.ema
    tp = _model_parallel(state.model)
    dp = state.optimizer.dp
    if tp is not None and (dp is None or dp.rank == 0):
        params, ema = (_whole(t, state.model, tp) for t in (params, ema))
        optimizer["state"] = {slot: _whole(v, state.model, tp)
                              for slot, v in optimizer["state"].items()}
        optimizer["acc"] = _whole(optimizer["acc"], state.model, tp)
    generators = multihost.allgather_object(state.generator.get_state())
    if tp is not None:
        # one per data rank: its model ranks draw alike (model rank 0's)
        generators = generators[::tp.size]
    if not multihost.is_main_process():
        return
    _save({"params": _cpu(params),
           "optimizer": _cpu(optimizer),
           "step": state.step, "epoch": epoch,
           "generator": generators[0], "generators": generators,
           "ema": _cpu(ema)}, _path(output_dir, name))


def load_train_state(output_dir: str, state, name: str = LAST):
    """Restore ``state`` in place from checkpoint-last -> (state, next
    epoch), or (state, 0) if there is none.  Every rank of a data-parallel
    run loads the file (written at any world size and model-parallel size;
    a tensor-parallel rank takes its share); each rank's drop-path
    generator takes the state saved for its data rank (the model ranks of
    one replica alike), or, for a data rank the file has none for, data
    rank 0's re-seeded with the data rank folded in."""
    path = _path(output_dir, name)
    if not os.path.exists(path):
        return state, 0
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    tp = _model_parallel(state.model)
    state.model.load_state_dict(_share(ckpt["params"], state.model, tp))
    opt = dict(ckpt["optimizer"])
    if tp is not None:
        opt["state"] = {slot: _share(v, state.model, tp)
                        for slot, v in opt["state"].items()}
        opt["acc"] = _share(opt.get("acc"), state.model, tp)
    state.optimizer.load_state_dict(opt)
    state.step = int(ckpt["step"])
    from simple_tad_tpu_torch.parallel import multihost
    from simple_tad_tpu_torch.parallel.mesh import rank_seed
    rank = multihost.rank() // (tp.size if tp is not None else 1)
    saved = ckpt.get("generators") or [ckpt["generator"]]
    state.generator.set_state(saved[min(rank, len(saved) - 1)])
    if rank >= len(saved):
        state.generator.manual_seed(rank_seed(
            state.generator.initial_seed() + state.step, rank))
    if state.ema is not None and ckpt["ema"] is not None:
        ema = _share(ckpt["ema"], state.model, tp)
        for n, t in state.ema.items():
            t.copy_(ema[n])
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
