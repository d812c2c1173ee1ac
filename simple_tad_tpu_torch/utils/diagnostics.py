"""Training diagnostics: per-layer / per-head gradient norms, the
profiler and the allocator's memory counters, in PyTorch.

Port of simple_tad_tpu/utils/diagnostics.py (reference: the grad-norm
tracer of utils.py:813-1011, whose per-layer qkv / proj / patch-embed
norms go to grad_norms/gradnorm_ep{N}.npz, run_frame_finetuning.py:
643-647, and print_memory_usage, utils.py:624-635).  The norms are taken
in fp32 on the gradients' device, one small tensor per key; the port's
parameter names and layouts are read as the JAX package reads its tree:
the qkv weight is a Linear's (3C, C), rows in (q | k | v, head, head dim)
order, where the JAX kernel is its transpose.  The keys follow the JAX
tree's: ``fc1`` / ``fc2`` for the ViT's blocks only (InternVideo2's MLP
is not under an 'mlp' node there), ``patch_embed`` where the JAX tree has
one (not InternVideo2's flat patch kernel), nothing for the pre-training
models (their blocks are under 'encoder' / 'decoder').
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch


def _norm(t: torch.Tensor, dims=None) -> torch.Tensor:
    sq = t.float().square()
    return (sq.sum() if dims is None else sq.sum(dims)).sqrt()


def grad_norm_summary(named_grads: Mapping[str, torch.Tensor],
                      num_heads: int) -> Dict[str, torch.Tensor]:
    """{parameter name: gradient} -> the JAX package's summary, fp32 on the
    gradients' device: qkv (L, H, 3) per layer, head and q / k / v; proj
    (L,); fc1 / fc2 (L,); patch_embed ()."""
    g = named_grads
    out: Dict[str, torch.Tensor] = {}
    iv2 = "blocks.0.ls1.gamma" in g
    if "blocks.0.attn.qkv.weight" in g:
        depth = 1 + max(int(n.split(".")[1]) for n in g
                        if n.startswith("blocks."))
        qkv, proj, fc1, fc2 = [], [], [], []
        for i in range(depth):
            pre = f"blocks.{i}."
            w = g[pre + "attn.qkv.weight"]                 # (3C, C)
            C = w.shape[1]
            q3 = w.reshape(3, num_heads, C // num_heads, C)
            qkv.append(_norm(q3, (2, 3)).T)                # (H, 3)
            proj.append(_norm(g[pre + "attn.proj.weight"]))
            if not iv2:
                fc1.append(_norm(g[pre + "mlp.fc1.weight"]))
                fc2.append(_norm(g[pre + "mlp.fc2.weight"]))
        out["qkv"] = torch.stack(qkv)
        out["proj"] = torch.stack(proj)
        if not iv2:
            out["fc1"] = torch.stack(fc1)
            out["fc2"] = torch.stack(fc2)
    # InternVideo2's trunk keeps a flat patch kernel in the JAX tree; the
    # distillation student (clip_pos_embed) a patch_embed node
    if "patch_embed.proj.weight" in g and (not iv2
                                           or "clip_pos_embed" in g):
        out["patch_embed"] = _norm(g["patch_embed.proj.weight"])
    return out


class GradNormAccumulator:
    """Sums the step summaries of an epoch (on their device, in fp64) and
    writes grad_norms/gradnorm_ep{N}.npz, the file the reference's
    analysis notebooks read: ``count`` and the summed norms."""

    def __init__(self, output_dir: Optional[str], num_heads: int):
        self.dir = (os.path.join(output_dir, "grad_norms")
                    if output_dir else None)
        self.num_heads = num_heads
        self.sums: Dict[str, torch.Tensor] = {}
        self.count = 0

    def update(self, summary: Mapping[str, torch.Tensor]) -> None:
        """Add one step's ``grad_norm_summary`` (the train step's
        ``metrics['grad_norms']``)."""
        for k, v in summary.items():
            v = v.detach().double()
            self.sums[k] = self.sums[k] + v if k in self.sums else v
        self.count += 1

    def save_epoch(self, epoch: int) -> Optional[str]:
        if self.dir is None or not self.count:
            return None
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, f"gradnorm_ep{epoch}.npz")
        np.savez(path, count=self.count,
                 **{k: v.cpu().numpy() for k, v in self.sums.items()})
        self.sums, self.count = {}, 0
        return path


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """A torch.profiler trace of the block (host and, where there is one,
    the card), written to ``log_dir`` as a Chrome trace; a no-op when
    ``log_dir`` is falsy."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """Per card, the allocator's bytes in use and its peak, in MB
    (torch.cuda.memory_stats); ``{'cpu': {}}`` without a card, as the JAX
    package reports a device without allocator counters."""
    if not torch.cuda.is_available():
        return {"cpu": {}}
    stats = {}
    for i in range(torch.cuda.device_count()):
        m = torch.cuda.memory_stats(i)
        stats[f"cuda:{i}"] = {
            "bytes_in_use_mb": m.get("allocated_bytes.all.current", 0)
            / 2 ** 20,
            "peak_bytes_mb": m.get("allocated_bytes.all.peak", 0) / 2 ** 20}
    return stats
