"""A/B of the packed attention kernels between this checkout and another.

A1 (inference), C1 (training forward with lse) and C2 (training backward)
on the packed qkv run on the same seeded inputs at ViT-B's shapes in both
checkouts, each in a fresh process (the two packages share a name), in the
order other, this, this, other, all on one card.  Each process builds its
checkout's kernels from its own sources.  Printed per kernel: whether the
outputs of all four runs are bit-equal (a digest of their bytes), the
median CUDA-event time of each run, and this checkout's mean time over the
other's.

    git archive <commit> | tar -x -C build/parent
    python -m simple_tad_tpu_torch.kernels.ab_checkouts --other build/parent
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys

SEED = 0
RUNS = 30
# kernel -> (batch, tokens, heads): ViT-B 16x224 at the eval batch (A1) and
# the fine-tuning job's batch (C1, C2)
SHAPES = {"attention": (32, 1568, 12), "attention_fwd_lse": (56, 1568, 12),
          "attention_bwd": (56, 1568, 12)}


def _worker(root: str) -> dict:
    """Run in a fresh process with ``root`` first on the path -> {kernel:
    {"digest", "ms"}}."""
    sys.path[0] = os.path.abspath(root)
    import torch

    from simple_tad_tpu_torch.kernels import build as kbuild
    from simple_tad_tpu_torch.ops import flash_attention as fa
    kbuild.load()
    dev = torch.device("cuda")
    out = {}
    for name, (B, N, heads) in SHAPES.items():
        C = 64 * heads
        scale = 64 ** -0.5
        g = torch.Generator(device=dev).manual_seed(SEED)
        qkv = torch.randn((B, N, 3 * C), generator=g,
                          device=dev).to(torch.bfloat16)
        if name == "attention":
            def fn():
                return (fa.flash_attention_qkv(qkv, heads, scale),)
        elif name == "attention_fwd_lse":
            def fn():
                return fa.flash_attention_qkv_fwd_lse(qkv, heads, scale)
        else:
            o, lse = fa.flash_attention_qkv_fwd_lse_plain(qkv, heads, scale)
            dout = torch.randn((B, N, C), generator=g,
                               device=dev).to(torch.bfloat16)

            def fn():
                return (fa.flash_attention_qkv_bwd(qkv, o, lse, dout, heads,
                                                   scale),)
        h = hashlib.sha256()
        for t in fn():
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        for _ in range(3):
            fn()
        times = []
        for _ in range(RUNS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        out[name] = {"digest": h.hexdigest(), "ms": statistics.median(times)}
        del qkv, fn
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other",
                    help="root of the other checkout (e.g. the parent)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(_worker(args.worker)))
        return 0
    if not args.other:
        ap.error("--other is required")
    this = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    order = [("other", args.other), ("this", this), ("this", this),
             ("other", args.other)]
    runs = []
    for label, root in order:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", root],
            capture_output=True, text=True)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout + proc.stderr)
            raise RuntimeError(f"the {label} run failed ({root})")
        runs.append((label, json.loads(proc.stdout.splitlines()[-1])))
    ok = True
    for name, shape in SHAPES.items():
        digests = {r[name]["digest"] for _, r in runs}
        ms = [r[name]["ms"] for _, r in runs]
        mine = statistics.mean(m for (lbl, _), m in zip(runs, ms)
                               if lbl == "this")
        theirs = statistics.mean(m for (lbl, _), m in zip(runs, ms)
                                 if lbl == "other")
        equal = len(digests) == 1
        ok &= equal
        print(f"[ab] {name} {shape}: outputs "
              f"{'bit-equal' if equal else 'DIFFER'} across the four runs; "
              f"ms (other, this, this, other) "
              f"{' '.join(f'{m:.4f}' for m in ms)}; this / other "
              f"{mine / theirs:.4f}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
