"""Rank discovery and cross-rank gathers over torch.distributed.

Port of simple_tad_tpu/parallel/multihost.py (reference:
init_distributed_mode, utils.py:283-333, and the padded all_gather of
utils.py:759-789).  The launch is the reference's: ``torchrun
--nproc_per_node=N -m simple_tad_tpu_torch.cli.<cli> ...`` (``--standalone``
on one node), one process per card.  ``initialize`` reads torchrun's
RANK / WORLD_SIZE / LOCAL_RANK / MASTER_ADDR / MASTER_PORT and starts the
default process group: NCCL with each process on ``cuda:LOCAL_RANK``, or
gloo for ``--device cpu``.  Without a torchrun environment it returns
False and everything here degenerates to one process.  A card run never
falls back to gloo or to one process: a world size above 1 with a missing
variable, or a failed NCCL start, raises.

Numeric gathers go through tensors on the backend's device; string ids
stay on their rank and each rank's CSV shard is merged on rank 0 with the
csv module (``merge_csv_shards``).
"""

from __future__ import annotations

import csv
import datetime
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT")


def initialize(device_type: str = "cuda", timeout_s: float = 600.0) -> bool:
    """Start the default process group from torchrun's environment ->
    True, or False when there is none (WORLD_SIZE unset or 1).
    ``device_type`` 'cuda' takes NCCL and sets the current card to
    LOCAL_RANK; 'cpu' takes gloo."""
    if dist.is_available() and dist.is_initialized():
        return True
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    missing = [v for v in TORCHRUN_VARS if v not in os.environ]
    if missing:
        raise RuntimeError(f"WORLD_SIZE={world} without {', '.join(missing)}"
                           f": launch with torchrun")
    rank = int(os.environ["RANK"])
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        backend = "nccl"
    elif device_type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for {device_type!r}")
    dist.init_process_group(backend, init_method="env://", world_size=world,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    return rank() == 0


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def allgather_object(obj) -> list:
    """Every rank's picklable ``obj``, in rank order (one process: [obj])."""
    if world_size() == 1:
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def _comm_device() -> torch.device:
    """Where a collective's tensors live: the current card under NCCL."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _gather_equal(x: np.ndarray) -> np.ndarray:
    """All ranks' arrays of one shape -> stacked (world, *shape)."""
    t = torch.from_numpy(np.ascontiguousarray(x)).to(_comm_device())
    out = [torch.empty_like(t) for _ in range(world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).cpu().numpy()


def allgather_metrics(tree: Any) -> Any:
    """Numeric metrics of every rank, each leaf stacked on a new leading
    rank axis (the JAX process_allgather); one process: the leaves as
    numpy arrays."""
    if isinstance(tree, dict):
        return {k: allgather_metrics(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        tree = tree.detach().cpu().numpy()
    if world_size() == 1:
        return np.asarray(tree)
    return _gather_equal(np.asarray(tree))


def allgather_ragged_1d(tree: Any) -> Any:
    """1-D arrays of unequal length on each rank -> their concatenation in
    rank order, on every rank: each leaf is padded to the longest, gathered
    and cut back to each rank's length.  One process: unchanged."""
    if isinstance(tree, dict):
        return {k: allgather_ragged_1d(v) for k, v in tree.items()}
    x = np.asarray(tree)
    if world_size() == 1:
        return x
    lens = _gather_equal(np.asarray([x.shape[0]], np.int64))[:, 0]
    pad = np.zeros((int(lens.max()) - x.shape[0],) + x.shape[1:], x.dtype)
    stacked = _gather_equal(np.concatenate([x, pad]))
    return np.concatenate([stacked[r][:int(n)] for r, n in enumerate(lens)])


def merge_csv_shards(output_dir: str, basename: str, n_shards: int,
                     out_name: Optional[str] = None) -> Optional[str]:
    """On rank 0: '<basename>.<r>.csv' for r < n_shards, in rank order,
    into '<basename>.csv' (one header) -> its path; None elsewhere or when
    no shard exists."""
    if not is_main_process():
        return None
    header, rows = None, []
    for r in range(n_shards):
        path = os.path.join(output_dir, f"{basename}.{r}.csv")
        if not os.path.exists(path):
            continue
        with open(path, newline="") as f:
            reader = csv.reader(f)
            head = next(reader)
            if header is not None and head != header:
                raise ValueError(f"{path}: columns {head} differ from "
                                 f"{header}")
            header = head
            rows.extend(reader)
    if header is None:
        return None
    out = os.path.join(output_dir, out_name or f"{basename}.csv")
    with open(out, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(header)
        writer.writerows(rows)
    return out
