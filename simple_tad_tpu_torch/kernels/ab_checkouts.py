"""A/B of the port's kernels between this checkout and another.

A1 (inference), C1 (training forward with lse) and C2 (training backward)
on the packed qkv, C3-fwd and C3-bwd (the same on separate operands, at
IV2-S's N = 2049 and the job's batch 56, v strided), A1 on separate
operands (IV2-S batch 32, v strided), B3 (A1 with an int8 output) packed
at ViT-B batch 32 and on separate operands at IV2-S batch 32 with keys
masked at n_kv < N (``N_KV``), the dropout attention C4 (forward and
backward, mask and Philox forms, rate 0.1, on the packed qkv's views at
ViT-B's job batch), the int8-storage
attention packed (B2) and on separate operands (D2, IV2-S, v strided), the
int8-compute attention (E2, ViT-B batch 32), the bf16
forward and backward at the head dims beyond 64 (``WIDE``: A1 on
separate operands at IV2-1B's probe (4, 4097) H=16, head dim 88, and
IV2-6B's (2, 4097) H=25, head dim 128, v strided; A1 packed at ViT-H's
(2, 1568) H=16, head dim 80; C2 and C4-bwd in both keep forms at ViT-H's
(2, 1568) H=16, C3-bwd at IV2-1B's (4, 2049) H=16 and at an IV2-6B
tensor-parallel rank's (2, 2049) H=13, head dim 128, v strided; B2 at
ViT-H's (2, 1568) H=16, D2 at IV2-1B's eval batch (32, 2049) H=16, head
dim 88, and IV2-6B's (2, 2049) H=25, v strided), and
the row norms of csrc/layernorm.cu (A2 LayerNorm, B1 LayerNorm->int8 and
E1 add + LayerNorm->int8 on ViT-B's (32 * 1568, 768) bf16, D3
RMSNorm->int8 on IV2-S's (32 * 2049, 384); 20 queued calls to an event
pair, on two copies of their inputs in turn), and the static int8 GEMM and
MLP (B4) at chip_smoke.py phase 2's shapes (``GEMMS``, ``MLPS``; 20 queued
calls to an event pair), run on the same seeded inputs in both checkouts,
each in a fresh
process (the two packages share a name), in the order other, this, this,
other, all on one card.  Each process builds its
checkout's kernels from its own sources.  Printed per kernel: whether the
outputs of all four runs are bit-equal (a digest of their bytes), the
median CUDA-event time of each run, and this checkout's mean time over the
other's.  A kernel named in ``--changed`` (one whose summation order the
change moved on purpose) must agree bit for bit within each checkout and is
reported, not failed, where the two checkouts differ; every other kernel
must be bit-equal in all four runs.  With ``--steps`` each checkout also
times its own fine-tuning step (its chip_smoke.py's phase-6 / phase-9 /
phase-11 FinetuneTrainer timing: ViT-B 16x224, IV2-S 8x224, and ViT-B with
attention dropout 0.1 in the Philox and the mask form, at the jobs' batch
56, the median of its timed steps), in a fresh process per run, in the
same order; with ``--evals`` its bf16 serving (its chip_smoke.py's phase 3
``run_eval``, ViT-B, and phase 7 ``run_eval_iv2``, IV2-S) and its static
int8 serving on the fused GEMMs (phase 10's ``run_eval_fused``: ViT-B with
the int8-storage attention and with B3, IV2-S with fused_rmsq) and its
unfused static int8 ViT-B (phase 5's, on B2) and with int8_attn (phase 12's,
on E2), windows/s as the median of its evaluate runs, the same way.

    git archive <commit> | tar -x -C build/parent
    python -m simple_tad_tpu_torch.kernels.ab_checkouts --other build/parent \
        [--changed attention,attention_sep] [--steps] [--evals]

A change of the bf16 forward's route at the wide head dims names those
kernels: ``--changed attention_sep_dh88,attention_sep_dh128,attention_dh80``;
of the backward's, ``--changed attention_bwd_dh80,attention_sep_bwd_dh88,``
``attention_sep_bwd_dh128,attention_drop_bwd_dh80,``
``attention_drop_rng_bwd_dh80``; of the int8-storage attention's,
``--changed attention_i8_dh80,attention_i8_sep_dh88,attention_i8_sep_dh128``.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import json
import os
import statistics
import subprocess
import sys

SEED = 0
RUNS = 30
# kernel -> (batch, tokens, heads): ViT-B 16x224 at the eval batch (A1, B3)
# and the fine-tuning job's batch (C1, C2); IV2-S 8x224 at the job's batch
# (C3) and the eval batch (A1 and B3 on separate operands, D2)
SHAPES = {"attention": (32, 1568, 12), "attention_fwd_lse": (56, 1568, 12),
          "attention_bwd": (56, 1568, 12),
          "attention_sep": (32, 2049, 6), "attention_q8": (32, 1568, 12),
          "attention_q8_sep": (32, 2049, 6),
          "attention_sep_fwd_lse": (56, 2049, 6),
          "attention_sep_bwd": (56, 2049, 6), "attention_i8": (32, 1568, 12),
          "attention_drop_fwd": (56, 1568, 12),
          "attention_drop_bwd": (56, 1568, 12),
          "attention_drop_rng_fwd": (56, 1568, 12),
          "attention_drop_rng_bwd": (56, 1568, 12),
          "attention_i8_sep": (32, 2049, 6),
          "attention_int8": (32, 1568, 12), "layernorm": (32, 1568, 12),
          "layernorm_quant": (32, 1568, 12),
          "add_layernorm_quant": (32, 1568, 12),
          "rmsnorm_quant": (32, 2049, 6),
          "attention_sep_dh88": (4, 4097, 16),
          "attention_sep_dh128": (2, 4097, 25),
          "attention_dh80": (2, 1568, 16),
          "attention_bwd_dh80": (2, 1568, 16),
          "attention_sep_bwd_dh88": (4, 2049, 16),
          "attention_sep_bwd_dh128": (2, 2049, 13),
          "attention_drop_bwd_dh80": (2, 1568, 16),
          "attention_drop_rng_bwd_dh80": (2, 1568, 16),
          "attention_i8_dh80": (2, 1568, 16),
          "attention_i8_sep_dh88": (32, 2049, 16),
          "attention_i8_sep_dh128": (2, 2049, 25)}
# the bf16 forward and backward beyond head dim 64: kernel -> (head dim,
# the entry it calls); every other kernel runs at head dim 64
WIDE = {"attention_sep_dh88": (88, "attention_sep"),
        "attention_sep_dh128": (128, "attention_sep"),
        "attention_dh80": (80, "attention"),
        "attention_bwd_dh80": (80, "attention_bwd"),
        "attention_sep_bwd_dh88": (88, "attention_sep_bwd"),
        "attention_sep_bwd_dh128": (128, "attention_sep_bwd"),
        "attention_drop_bwd_dh80": (80, "attention_drop_bwd"),
        "attention_drop_rng_bwd_dh80": (80, "attention_drop_rng_bwd"),
        "attention_i8_dh80": (80, "attention_i8"),
        "attention_i8_sep_dh88": (88, "attention_i8_sep"),
        "attention_i8_sep_dh128": (128, "attention_i8_sep")}
NORMS = ("layernorm", "layernorm_quant", "add_layernorm_quant",
         "rmsnorm_quant")
# C4's rate (chip_smoke.py's ATTN_DROP) and its Philox seed words
DROP_RATE = 0.1
DROP_SEED = (12345, -678)
# B3 on separate operands: keys at or beyond this masked (chip_smoke.py
# phase 2's IV2-S case)
N_KV = 2040
# B4 at phase 2's shapes: GEMM (M, K, N, x dtype, bias), MLP (M, dim,
# hidden, x dtype): ViT-B batch 32 qkv, proj and the per-GEMM fc2 (fp32 x),
# IV2-S batch 32 qkv (bf16 x); the ViT-B and IV2-S MLPs
GEMMS = {"int8_gemm": (32 * 1568, 768, 2304, "int8", False),
         "int8_gemm_proj": (32 * 1568, 768, 768, "int8", True),
         "int8_gemm_fc2": (32 * 1568, 3072, 768, "float32", True),
         "int8_gemm_iv2": (32 * 2049, 384, 1152, "bfloat16", False)}
MLPS = {"int8_mlp": (32 * 1568, 768, 3072, "int8"),
        "int8_mlp_iv2": (32 * 2049, 384, 1536, "bfloat16")}
KERNELS = {**SHAPES, **GEMMS, **MLPS}
# --steps: chip_smoke.py's training timings (label -> the keywords of its
# time_training_process): ViT-B, IV2-S, ViT-B with attention dropout in
# each keep form
STEP_FAMILIES = {"vit": {}, "iv2": {"family": "iv2"},
                 "vit drop rng": {"attn_drop": DROP_RATE, "form": "rng"},
                 "vit drop mask": {"attn_drop": DROP_RATE, "form": "mask"}}
# --evals: chip_smoke.py phases 3 and 7's bf16 serving (label, function),
# and phase 10's (family, (label, qkv_i8, fused_rmsq))
BF16_EVALS = (("vit bf16", "run_eval"), ("iv2 bf16", "run_eval_iv2"))
EVAL_CASES = (("vit", ("vit fused", True, False)),
              ("vit", ("vit fused q8", False, False)),
              ("iv2", ("iv2 fused rmsq", True, True)))
# and the unfused static int8 ViT-B of phase 5 (B2 on torch._int_mm) and
# with phase 12's int8_attn (E2): label -> FrameEvaluator options
INT8_EVALS = {"vit int8": {}, "vit int8_attn": {"int8_attn": True}}
EVAL_LABELS = tuple(label for label, _ in BF16_EVALS) + tuple(
    label for _, (label, *_) in EVAL_CASES) + tuple(INT8_EVALS)
# the norms take 0.02-0.14 ms, about the host's time in a wrapper call,
# which a single call's event pair would include: they are timed
# CALLS_PER_EVENT calls to an event pair, so the calls queue up on the card
# (B4's 0.1-1 ms calls too), the norms' taken in turn on two copies of
# their inputs, so that each reads device memory, not the L2
CALLS_PER_EVENT = 20
# the root of this checkout
_THIS = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _b4_fn(name, dev, g):
    """The B4 call of ``name`` on seeded operands (chip_smoke.py's: x, its
    0.999-quantile absmax, per-channel int8 weights, a bias)."""
    import torch

    from simple_tad_tpu_torch.ops import int8_gemm
    from simple_tad_tpu_torch.ops.ln import quantize_static

    def operands(M, K, N, dtype):
        x = torch.randn((M, K), generator=g, device=dev)
        amax = torch.quantile(x[:4096].abs().flatten(), 0.999)
        if dtype == torch.int8:
            x = quantize_static(x, amax)
        w = torch.randn((N, K), generator=g, device=dev) * 0.02
        w_s = torch.clamp(w.abs().amax(dim=1) / 127.0, min=1e-12)
        w_q = torch.clamp(torch.round(w / w_s[:, None]), -127,
                          127).to(torch.int8)
        b = torch.randn(N, generator=g, device=dev) * 0.1
        return x.to(dtype), w_q, w_s, amax, b

    if name in GEMMS:
        M, K, N, dtype, bias = GEMMS[name]
        x, w_q, w_s, amax, b = operands(M, K, N, getattr(torch, dtype))
        args = (x, w_q, w_s, amax, b if bias else None, None, torch.bfloat16)
        return lambda: (int8_gemm.w8a8_gemm(*args),)
    M, dim, hidden, dtype = MLPS[name]
    x, w1, s1, a1, b1 = operands(M, dim, hidden, getattr(torch, dtype))
    _, w2, s2, _, b2 = operands(8, hidden, dim, torch.float32)
    h = int8_gemm.w8a8_gemm_plain(x[:4096], w1, s1, a1, b1, "gelu_tanh",
                                  torch.float32)
    a2 = torch.quantile(h.abs().flatten(), 0.999)
    args = (x, w1, s1, a1, b1, w2, s2, a2, b2, "gelu_tanh", torch.bfloat16)
    return lambda: (int8_gemm.w8a8_mlp(*args),)


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
    for name in KERNELS:
        g = torch.Generator(device=dev).manual_seed(SEED)
        if name not in SHAPES:
            _time(name, _b4_fn(name, dev, g), out)
            continue
        B, N, heads = SHAPES[name]
        D, entry = WIDE.get(name, (64, name))
        C = D * heads
        scale = D ** -0.5
        qkv = torch.randn((B, N, 3 * C), generator=g,
                          device=dev).to(torch.bfloat16)
        if name in NORMS:
            x = qkv[..., :C].reshape(B * N, C) * 2 + 0.5
            w = torch.randn(C, generator=g, device=dev) * 0.2 + 1
            b = torch.randn(C, generator=g, device=dev) * 0.1
            amax = torch.full((), 4.0, device=dev)
            inv = 127.0 / (w.abs() * 4)
            # E1's residual: another column block of qkv
            res = qkv[..., C:2 * C].reshape(B * N, C) * 3
            call = {"layernorm": lambda x, r: (ln.layernorm(x, w, b),),
                    "layernorm_quant": lambda x, r: (
                        ln.layernorm_quant(x, w, b, amax),),
                    "add_layernorm_quant": lambda x, r:
                        ln.add_layernorm_quant(x, r, w, b, amax),
                    "rmsnorm_quant": lambda x, r: (
                        ln.rmsnorm_quant(x, w, inv),)}[name]
            fn = tuple(functools.partial(call, *copy) for copy in
                       ((x, res), (x.clone(), res.clone())))
        elif entry in ("attention_i8", "attention_i8_sep", "attention_int8"):
            amax = qkv.float().view(B, N, 3, heads, D).abs().amax(
                dim=(0, 1, 4))
            inv = (127.0 / amax).reshape(-1).repeat_interleave(D)
            q8 = torch.clamp(torch.round(qkv.float() * inv), -127,
                             127).to(torch.int8)
            out_amax = torch.ones((), device=dev)
            if entry == "attention_i8":
                def fn():
                    return (fa.flash_attention_qkv_i8d(q8, amax, heads, scale,
                                                       out_amax),)
            elif entry == "attention_int8":
                def fn():
                    return (fa.flash_attention_qkv_int8(q8, amax, heads,
                                                        scale),)
            else:
                ops = (q8[..., :C].contiguous(),
                       q8[..., C:2 * C].contiguous(), q8[..., 2 * C:])

                def fn():
                    return (fa.flash_attention_i8d(*ops, amax, heads, scale,
                                                   out_amax),)
        elif entry == "attention":
            def fn():
                return (fa.flash_attention_qkv(qkv, heads, scale),)
        elif entry in ("attention_sep", "attention_q8_sep"):
            ops = (qkv[..., :C].contiguous(), qkv[..., C:2 * C].contiguous(),
                   qkv[..., 2 * C:], heads, scale)
            if entry == "attention_sep":
                def fn():
                    return (fa.flash_attention(*ops),)
            else:
                out_amax = torch.full((), 0.5, device=dev)

                def fn():
                    return (fa.flash_attention_q8(*ops, out_amax, N_KV),)
        elif name == "attention_q8":
            out_amax = torch.full((), 0.5, device=dev)

            def fn():
                return (fa.flash_attention_qkv_q8(qkv, heads, scale,
                                                  out_amax),)
        elif name == "attention_fwd_lse":
            def fn():
                return fa.flash_attention_qkv_fwd_lse(qkv, heads, scale)
        elif name.startswith("attention_drop"):
            fn = _drop_fn(name, qkv, heads, scale, g)
        elif entry in ("attention_sep_fwd_lse", "attention_sep_bwd"):
            ops = (qkv[..., :C].contiguous(), qkv[..., C:2 * C].contiguous(),
                   qkv[..., 2 * C:], heads, scale)
            if entry == "attention_sep_fwd_lse":
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
        _time(name, fn, out)
        del qkv, fn
    return out


def _drop_fn(name, qkv, heads, scale, g):
    """The C4 call of ``name`` on the packed qkv's (q, k, v) views: a seeded
    keep mask (mask form) or DROP_SEED (Philox form); the backward on the
    plain forward's out and lse and a seeded dout."""
    import torch

    from simple_tad_tpu_torch.ops import flash_attention as fa
    B, N, C3 = qkv.shape
    C = C3 // 3
    args = (*qkv.view(B, N, 3, C).unbind(2), heads, scale, DROP_RATE)
    if "_rng_" in name:
        src = {"seed": torch.tensor(DROP_SEED, dtype=torch.int32,
                                    device=qkv.device)}
    else:
        src = {"mask": (torch.rand((B, heads, N, N), generator=g,
                                   device=qkv.device) >= DROP_RATE
                        ).to(torch.int8)}
    if name.endswith("_fwd"):
        return lambda: fa.flash_attention_drop_fwd(*args, **src)
    out, lse = fa.flash_attention_drop_fwd_plain(*args, **src)
    dout = torch.randn((B, N, C), generator=g,
                       device=qkv.device).to(torch.bfloat16)
    bargs = (*args[:3], out, lse, dout, *args[3:])
    return lambda: fa.flash_attention_drop_bwd(*bargs, **src)


def _time(name, fn, out) -> None:
    """out[name] = the digest of fn()'s outputs and its median time; fn is
    a call, or a tuple of calls (the same on copies of the inputs) taken in
    turn, the first digested."""
    import torch
    fns = fn if isinstance(fn, tuple) else (fn,)
    h = hashlib.sha256()
    for t in fns[0]():
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    for i in range(3):
        fns[i % len(fns)]()
    calls = 1 if name in SHAPES and name not in NORMS else CALLS_PER_EVENT
    times = []
    for _ in range(RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(calls):
            fns[i % len(fns)]()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    out[name] = {"digest": h.hexdigest(), "ms": statistics.median(times)}
    torch.cuda.empty_cache()


def _step_worker(root: str, label: str) -> dict:
    """Run in a fresh process with ``root`` first on the path -> the median
    step ms of that checkout's own training timing of ``label``
    (STEP_FAMILIES)."""
    sys.path[0] = os.path.abspath(root)
    import chip_smoke
    r = chip_smoke.time_training_process(SEED, profile=False,
                                         **STEP_FAMILIES[label])
    return {"batch": r.get("batch"), "ms": statistics.median(r["step_ms"])}


def _eval_worker(root: str) -> dict:
    """Run in a fresh process with ``root`` first on the path -> {label:
    windows/s} of that checkout's own phase-3, 7 and 10 runs (phase 10's
    logit drift from bf16 is printed against 0, not measured)."""
    sys.path[0] = os.path.abspath(root)
    import torch

    import chip_smoke
    dev = torch.device("cuda")
    out = {}
    for label, fn in BF16_EVALS:
        _, stats = getattr(chip_smoke, fn)(dev, SEED)
        out[label] = stats["windows_per_sec"]
        torch.cuda.empty_cache()
    for family, (label, qkv_i8, fused_rmsq) in EVAL_CASES:
        r = chip_smoke.run_eval_fused(
            dev, SEED, family,
            [(label, qkv_i8, fused_rmsq, chip_smoke.EVAL_RUNS)], 0.0)
        out[label] = r[label]["windows_per_sec"]
        torch.cuda.empty_cache()
    for label, options in INT8_EVALS.items():
        out[label] = _int8_eval(chip_smoke, dev, options)
        torch.cuda.empty_cache()
    return out


def _int8_eval(chip_smoke, dev, options) -> float:
    """The windows/s of the static int8 ViT-B with FrameEvaluator
    ``options``, set up by chip_smoke.py's ``static_int8_evaluator`` (phases
    5 and 12: seeded fp32 masters, explicit calibration, phase 3's clip at
    its batch, a warm-up) and timed as the median of EVAL_RUNS evaluates.
    A checkout whose chip_smoke.py predates that helper is set up by this
    checkout's, on its own package."""
    import importlib.util

    import torch
    if not hasattr(chip_smoke, "static_int8_evaluator"):
        spec = importlib.util.spec_from_file_location(
            "chip_smoke_this", os.path.join(_THIS, "chip_smoke.py"))
        chip_smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(chip_smoke)
    masters = chip_smoke.vit_b("cpu", SEED, torch.float32).state_dict()
    ev, ds, *_ = chip_smoke.static_int8_evaluator(
        chip_smoke.vit_b(dev, SEED, torch.bfloat16), dev, SEED, masters,
        options)
    return statistics.median(ev.evaluate(ds).windows_per_sec
                             for _ in range(chip_smoke.EVAL_RUNS))


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
    ap.add_argument("--evals", action="store_true",
                    help="also time each checkout's bf16 and int8 serving")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--step-worker", help=argparse.SUPPRESS)
    ap.add_argument("--eval-worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.eval_worker:
        print(json.dumps(_eval_worker(args.eval_worker)))
        return 0
    if args.step_worker:
        label, root = args.step_worker.split(":", 1)
        print(json.dumps(_step_worker(root, label)))
        return 0
    changed = {name for name in args.changed.split(",") if name}
    if changed - set(KERNELS):
        ap.error(f"--changed: unknown kernels {sorted(changed - set(KERNELS))}")
    if args.worker:
        print(json.dumps(_worker(args.worker)))
        return 0
    if not args.other:
        ap.error("--other is required")
    order = [("other", args.other), ("this", _THIS), ("this", _THIS),
             ("other", args.other)]
    runs = _runs(order, "--worker")
    ok = True
    for name, shape in KERNELS.items():
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
    if args.evals:
        evals = _runs(order, "--eval-worker")
        for label in EVAL_LABELS:
            rates = [r[label] for _, r in evals]
            mine = statistics.mean(r[label] for (lbl, _), (_, r)
                                   in zip(order, evals) if lbl == "this")
            theirs = statistics.mean(r[label] for (lbl, _), (_, r)
                                     in zip(order, evals) if lbl == "other")
            print(f"[ab] {label} evaluate: windows/s (other, this, this, "
                  f"other) {' '.join(f'{w:.2f}' for w in rates)}; this / "
                  f"other {mine / theirs:.4f}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
