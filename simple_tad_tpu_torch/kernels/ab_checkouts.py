"""A/B of the attention and norm kernels between this checkout and another.

A1 (inference), C1 (training forward with lse) and C2 (training backward)
on the packed qkv, C3-fwd and C3-bwd (the same on separate operands, at
IV2-S's N = 2049 and the job's batch 56, v strided), the int8-storage
attention packed (B2) and on separate operands (D2, IV2-S, v strided), and
the row norms of csrc/layernorm.cu (A2 LayerNorm and B1 LayerNorm->int8 on
ViT-B's (32 * 1568, 768) bf16, D3 RMSNorm->int8 on IV2-S's (32 * 2049,
384)), run on the same seeded inputs at ViT-B's (and IV2-S's) shapes in
both checkouts, each in a fresh process (the two packages share a name), in the
order other, this, this, other, all on one card.  Each process builds its
checkout's kernels from its own sources.  Printed per kernel: whether the
outputs of all four runs are bit-equal (a digest of their bytes), the
median CUDA-event time of each run, and this checkout's mean time over the
other's.  A kernel named in ``--changed`` (one whose summation order the
change moved on purpose) must agree bit for bit within each checkout and is
reported, not failed, where the two checkouts differ; every other kernel
must be bit-equal in all four runs.  With ``--steps`` each checkout also
times its own fine-tuning step (its chip_smoke.py's phase-6 / phase-9
FinetuneTrainer timing: ViT-B 16x224 and IV2-S 8x224 at the jobs' batch
56, the median of its timed steps), in a fresh process per run, in the
same order.

    git archive <commit> | tar -x -C build/parent
    python -m simple_tad_tpu_torch.kernels.ab_checkouts --other build/parent \
        [--changed attention_bwd,attention_sep_bwd] [--steps]
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
# the fine-tuning job's batch (C1, C2); IV2-S 8x224 at the job's batch (C3)
# and the eval batch (D2)
SHAPES = {"attention": (32, 1568, 12), "attention_fwd_lse": (56, 1568, 12),
          "attention_bwd": (56, 1568, 12),
          "attention_sep_fwd_lse": (56, 2049, 6),
          "attention_sep_bwd": (56, 2049, 6), "attention_i8": (32, 1568, 12),
          "attention_i8_sep": (32, 2049, 6), "layernorm": (32, 1568, 12),
          "layernorm_quant": (32, 1568, 12), "rmsnorm_quant": (32, 2049, 6)}
NORMS = ("layernorm", "layernorm_quant", "rmsnorm_quant")
# --steps: chip_smoke.py's training families (ViT-B, IV2-S)
STEP_FAMILIES = ("vit", "iv2")
# the norms take ~0.07 ms, about the host's time in a wrapper call, which a
# single call's event pair would include: they are timed CALLS_PER_EVENT
# calls to an event pair, so the calls queue up on the card
CALLS_PER_EVENT = 20


def _worker(root: str) -> dict:
    """Run in a fresh process with ``root`` first on the path -> {kernel:
    {"digest", "ms"}}."""
    sys.path[0] = os.path.abspath(root)
    import torch

    from simple_tad_tpu_torch.kernels import build as kbuild
    from simple_tad_tpu_torch.ops import flash_attention as fa
    from simple_tad_tpu_torch.ops import ln
    kbuild.load()
    dev = torch.device("cuda")
    out = {}
    for name, (B, N, heads) in SHAPES.items():
        C = 64 * heads
        scale = 64 ** -0.5
        g = torch.Generator(device=dev).manual_seed(SEED)
        qkv = torch.randn((B, N, 3 * C), generator=g,
                          device=dev).to(torch.bfloat16)
        if name in NORMS:
            x = qkv[..., :C].reshape(B * N, C) * 2 + 0.5
            w = torch.randn(C, generator=g, device=dev) * 0.2 + 1
            b = torch.randn(C, generator=g, device=dev) * 0.1
            amax = torch.full((), 4.0, device=dev)
            if name == "layernorm":
                def fn():
                    return (ln.layernorm(x, w, b),)
            elif name == "layernorm_quant":
                def fn():
                    return (ln.layernorm_quant(x, w, b, amax),)
            else:
                inv = 127.0 / (w.abs() * 4)

                def fn():
                    return (ln.rmsnorm_quant(x, w, inv),)
        elif name in ("attention_i8", "attention_i8_sep"):
            amax = qkv.float().view(B, N, 3, heads, 64).abs().amax(
                dim=(0, 1, 4))
            inv = (127.0 / amax).reshape(-1).repeat_interleave(64)
            q8 = torch.clamp(torch.round(qkv.float() * inv), -127,
                             127).to(torch.int8)
            out_amax = torch.ones((), device=dev)
            if name == "attention_i8":
                def fn():
                    return (fa.flash_attention_qkv_i8d(q8, amax, heads, scale,
                                                       out_amax),)
            else:
                ops = (q8[..., :C].contiguous(),
                       q8[..., C:2 * C].contiguous(), q8[..., 2 * C:])

                def fn():
                    return (fa.flash_attention_i8d(*ops, amax, heads, scale,
                                                   out_amax),)
        elif name == "attention":
            def fn():
                return (fa.flash_attention_qkv(qkv, heads, scale),)
        elif name == "attention_fwd_lse":
            def fn():
                return fa.flash_attention_qkv_fwd_lse(qkv, heads, scale)
        elif name in ("attention_sep_fwd_lse", "attention_sep_bwd"):
            ops = (qkv[..., :C].contiguous(), qkv[..., C:2 * C].contiguous(),
                   qkv[..., 2 * C:], heads, scale)
            if name == "attention_sep_fwd_lse":
                def fn():
                    return fa.flash_attention_fwd_lse(*ops)
            else:
                o, lse = fa.flash_attention_fwd_lse_plain(*ops)
                dout = torch.randn((B, N, C), generator=g,
                                   device=dev).to(torch.bfloat16)

                def fn():
                    return fa.flash_attention_bwd(*ops[:3], o, lse, dout,
                                                  *ops[3:])
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
        calls = CALLS_PER_EVENT if name in NORMS else 1
        times = []
        for _ in range(RUNS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / calls)
        out[name] = {"digest": h.hexdigest(), "ms": statistics.median(times)}
        del qkv, fn
        torch.cuda.empty_cache()
    return out


def _step_worker(root: str, family: str) -> dict:
    """Run in a fresh process with ``root`` first on the path -> the median
    step ms of that checkout's own training timing."""
    sys.path[0] = os.path.abspath(root)
    import chip_smoke
    r = chip_smoke.time_training_process(SEED, profile=False, family=family)
    return {"batch": r.get("batch"), "ms": statistics.median(r["step_ms"])}


def _runs(order, *args) -> list:
    """Run this script's worker once per (label, root) of ``order`` ->
    [(label, its JSON result)]."""
    runs = []
    for label, root in order:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), *args, root],
            capture_output=True, text=True)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout + proc.stderr)
            raise RuntimeError(f"the {label} run failed ({root})")
        runs.append((label, json.loads(proc.stdout.splitlines()[-1])))
    return runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other",
                    help="root of the other checkout (e.g. the parent)")
    ap.add_argument("--changed", default="",
                    help="comma-separated kernels expected to differ from "
                         "the other checkout in their last bits")
    ap.add_argument("--steps", action="store_true",
                    help="also time each checkout's fine-tuning steps")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--step-worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.step_worker:
        family, root = args.step_worker.split(":", 1)
        print(json.dumps(_step_worker(root, family)))
        return 0
    changed = {name for name in args.changed.split(",") if name}
    if changed - set(SHAPES):
        ap.error(f"--changed: unknown kernels {sorted(changed - set(SHAPES))}")
    if args.worker:
        print(json.dumps(_worker(args.worker)))
        return 0
    if not args.other:
        ap.error("--other is required")
    this = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    order = [("other", args.other), ("this", this), ("this", this),
             ("other", args.other)]
    runs = _runs(order, "--worker")
    ok = True
    for name, shape in SHAPES.items():
        digests = {r[name]["digest"] for _, r in runs}
        ms = [r[name]["ms"] for _, r in runs]
        mine = statistics.mean(m for (lbl, _), m in zip(runs, ms)
                               if lbl == "this")
        theirs = statistics.mean(m for (lbl, _), m in zip(runs, ms)
                                 if lbl == "other")
        equal = len(digests) == 1
        if name in changed:
            within = all(len({r[name]["digest"] for lbl, r in runs
                              if lbl == side}) == 1
                         for side in ("this", "other"))
            ok &= within
            if not within:
                verdict = "DIFFER within a checkout"
            elif equal:
                verdict = "bit-equal across the four runs"
            else:
                verdict = ("bit-equal within each checkout, different from "
                           "the other's (expected: --changed)")
        else:
            ok &= equal
            verdict = ("bit-equal" if equal else "DIFFER") + \
                " across the four runs"
        print(f"[ab] {name} {shape}: outputs {verdict}; "
              f"ms (other, this, this, other) "
              f"{' '.join(f'{m:.4f}' for m in ms)}; this / other "
              f"{mine / theirs:.4f}")
    for family in STEP_FAMILIES if args.steps else ():
        steps = [(label, r) for (label, _), (_, r) in zip(order, _runs(
            [(label, f"{family}:{root}") for label, root in order],
            "--step-worker"))]
        ms = [r["ms"] for _, r in steps]
        mine = statistics.mean(r["ms"] for lbl, r in steps if lbl == "this")
        theirs = statistics.mean(r["ms"] for lbl, r in steps
                                 if lbl == "other")
        print(f"[ab] {family} train step, batch "
              f"{'/'.join(str(r['batch']) for _, r in steps)}: median ms "
              f"(other, this, this, other) "
              f"{' '.join(f'{m:.2f}' for m in ms)}; this / other "
              f"{mine / theirs:.4f}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
