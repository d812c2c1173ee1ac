"""The data-parallel group of the trainers: ranks, gradient averaging and
the ZeRO partition of the optimizer state.

Port of simple_tad_tpu/parallel/mesh.py (reference: plain DDP, utils.py:
283-333, with DeepSpeed ZeRO-2 as an option, utils.py:547-594).  The JAX
package shards each batch over a 1-D data mesh and lets XLA insert the
gradient psum; here one process drives each card (torchrun) and:

* each rank takes rows [r*b, (r+1)*b) of the global batch that one
  process would draw at batch b*world, and decodes only those
  (``rank_rows``);
* the optimizer averages the gradients across ranks with bucketed
  all-reduces after ``backward`` (``DataParallel.all_reduce_mean``), before
  the norm and the clip, so both are the global ones;
* under ZeRO each rank owns the optimizer state of a share of the JAX
  leaves (``DataParallel.partition``), updates that share and broadcasts
  it (``DataParallel.broadcast``): the counterpart of
  optimizer_state_sharding;
* each rank's augmentation and drop-path generators are seeded with its
  rank folded in (``rank_seed``).

Under tensor parallelism (parallel/tp.py:make_2d_mesh) the world is a
(data x model) grid and ``DataParallel`` runs over its data group: its
``world`` and ``rank`` are the data-parallel size and rank, which the rows
(``rank_rows``) and the generator seeds (``rank_seed``) take, so the model
ranks of one data replica decode the same rows and draw the same masks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from simple_tad_tpu_torch.parallel import multihost

BUCKET_BYTES = 32 * 2 ** 20


@dataclasses.dataclass(frozen=True, eq=False)
class DataParallel:
    """(world, rank, device) of this process, and the collectives of the
    data-parallel step over ``group`` (None: the default process group);
    without a process group (world 1) they leave the tensors as they are.
    ``world`` and ``rank`` are the size of the group and this process's
    rank in it.  It unpacks, and compares with a tuple, as (world, rank,
    device)."""
    world: int
    rank: int
    device: torch.device
    group: Optional[object] = None

    def __iter__(self):
        return iter((self.world, self.rank, self.device))

    def __eq__(self, other):
        if isinstance(other, DataParallel):
            return tuple(self) == tuple(other) and self.group is other.group
        if isinstance(other, tuple):
            return tuple(self) == other
        return NotImplemented

    def global_rank(self, rank: int) -> int:
        """The default group's rank of this group's ``rank``."""
        if self.group is None:
            return rank
        return dist.get_global_rank(self.group, rank)

    @property
    def active(self) -> bool:
        """Is there a process group to communicate over (world 1 included:
        a one-process group runs the collectives too)?"""
        return dist.is_available() and dist.is_initialized()

    def _buckets(self, tensors: Sequence[torch.Tensor]
                 ) -> List[List[torch.Tensor]]:
        buckets, cur, size, key = [], [], 0, None
        for t in tensors:
            k = (t.dtype, t.device)
            nbytes = t.numel() * t.element_size()
            if cur and (k != key or size + nbytes > BUCKET_BYTES):
                buckets.append(cur)
                cur, size = [], 0
            cur.append(t)
            size += nbytes
            key = k
        if cur:
            buckets.append(cur)
        return buckets

    @torch.no_grad()
    def all_reduce_mean(self, tensors: Sequence[torch.Tensor]) -> None:
        """Replace each tensor by its mean over the ranks, in place: the
        tensors are packed into flat buckets, summed across ranks and
        divided by the world size."""
        if not self.active:
            return
        for bucket in self._buckets(tensors):
            flat = torch.cat([t.reshape(-1) for t in bucket])
            dist.all_reduce(flat, group=self.group)
            flat.div_(self.world)
            off = 0
            for t in bucket:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()

    @torch.no_grad()
    def broadcast(self, tensors: Sequence[torch.Tensor], src: int) -> None:
        """Each tensor from rank ``src`` to every rank, in place (flat
        buckets)."""
        if not self.active:
            return
        for bucket in self._buckets(tensors):
            flat = (torch.cat([t.reshape(-1) for t in bucket])
                    if self.rank == src else
                    torch.empty(sum(t.numel() for t in bucket),
                                dtype=bucket[0].dtype,
                                device=bucket[0].device))
            dist.broadcast(flat, self.global_rank(src), group=self.group)
            if self.rank != src:
                off = 0
                for t in bucket:
                    t.copy_(flat[off:off + t.numel()].view_as(t))
                    off += t.numel()

    def partition(self, sizes: Dict[str, int]) -> Dict[str, int]:
        """{leaf: element count} -> {leaf: owning rank}: the largest leaves
        first, each to the rank that owns the fewest elements so far (ties
        by rank), the same on every rank."""
        load = [0] * self.world
        owner = {}
        for key in sorted(sizes, key=lambda k: (-sizes[k], k)):
            r = int(np.argmin(load))
            owner[key] = r
            load[r] += sizes[key]
        return owner


def data_parallel_setup(device: str = "cuda") -> DataParallel:
    """Start the torchrun process group if there is one (multihost.
    initialize) -> (world, rank, device): the device is ``cuda:LOCAL_RANK``
    for a card run, the CPU for ``--device cpu``, and ``device`` as given
    at world 1."""
    device = torch.device(device)
    if not multihost.initialize(device.type):
        return DataParallel(1, 0, device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    return DataParallel(multihost.world_size(), multihost.rank(), device)


def rank_rows(batch: int, rank: int, world: int) -> slice:
    """The rows of a global batch of ``batch`` that ``rank`` takes."""
    if batch % world:
        raise ValueError(f"global batch {batch} does not split over "
                         f"{world} ranks")
    b = batch // world
    return slice(rank * b, (rank + 1) * b)


def rank_seed(seed: int, rank: int) -> int:
    """A generator seed with the rank folded in (rank 0 keeps ``seed``)."""
    return int(seed) + (int(rank) << 32)
