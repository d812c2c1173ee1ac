#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases (any failure raises, so the exit code is non-zero):
  0. device check: a CUDA device must be present; prints the card's name
     and power limit (nvidia-smi), torch and CUDA versions;
  1. build: compiles simple_tad_tpu_torch/csrc/*.cu (nvcc, sm_90a) and
     prints the build seconds and the ptxas register / spill report;
  2. kernels against their plain PyTorch versions on the card, at the
     shapes the main path gives them, each within its stated tolerance,
     timed with CUDA events (median of 30 runs after warm-up).  Every
     LayerNorm case and every bf16 attention case also runs a control: the
     plain version with one required numerics step left out (LayerNorm:
     unbiased variance; attention: probabilities not rounded to bf16
     before PV and the denominator).  The control must fail the bound, so
     the bound is shown to catch it;
  3. sliding-window evaluation at full width: ViT-B 16x224 bf16 with
     seeded weights on a synthetic 96-frame 360x640 clip (81 windows),
     device resize, token path, batch 32, through FrameEvaluator, timed
     over 5 runs; the launch counters must show 12 attention and 25
     LayerNorm launches per chunk forward, and the logits must agree with
     the same model run through the plain versions on the card (and the
     model run through the controls must not);
  4. streaming: 16 batch-1 steps of cli/inference.py's StreamingScorer.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import time
from unittest import mock

import numpy as np
import torch

# Bounds against the plain version on the same inputs.  Each sits between
# the kernels' largest reading and the controls' smallest, read on an
# NVIDIA H100 80GB HBM3 at these shapes (PERF.md, Findings):
#   bf16 outputs differing   layernorm  < 5e-5 vs control 0.0833
#                            attention  0.0019 vs control 0.4208
#   logits, max |err| / max |logit|     4.535e-3 vs controls 7.234e-3
# Readings are bit-for-bit the same from run to run on one card and
# software stack (no atomics; fixed seeds).
BF16_TOL = dict(atol=1e-2, rtol=1e-2)    # ~1 bf16 ulp (2^-7 relative)
# share of bf16 outputs that may differ from the plain version in any bit
BF16_MISMATCH = {"layernorm": 0.01, "attention": 0.03}
F32_TOL = dict(atol=1e-5, rtol=1e-5)     # fp32 summation order
LOGIT_RTOL = 5.7e-3      # max |logit error| / max |logit|, 12 bf16 layers
EVAL_RUNS = 5


def cuda_ms(fn, runs: int = 30, warmup: int = 3) -> float:
    """Median device time of fn() in ms, CUDA events around each run."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_check() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none found")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"device {torch.cuda.get_device_name(0)}")
    return torch.cuda.get_device_name(0)


def build_kernels() -> None:
    from simple_tad_tpu_torch.kernels import build as kbuild
    t0 = time.perf_counter()
    kbuild.load()
    print(f"[build] {time.perf_counter() - t0:.1f} s -> "
          f"{kbuild.library_path()}")
    log = kbuild.library_path().parent / "build.log"
    if log.exists():
        for line in log.read_text().splitlines():
            if "Used" in line or "spill" in line or "Compiling" in line:
                print("[ptxas]", line.strip())


def attention_control(qkv, num_heads: int, scale: float):
    """The plain attention without the probability rounding: fp32
    probabilities go into PV and the denominator, as a kernel that skipped
    that step would compute."""
    from simple_tad_tpu_torch.ops.flash_attention import LOG2E
    B, N, C3 = qkv.shape
    q, k, v = qkv.view(B, N, 3, num_heads, -1).permute(2, 0, 3, 1, 4)
    qs = (q.float() * (scale * LOG2E)).to(qkv.dtype)
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    p = torch.exp2(s - torch.ceil(s.amax(dim=-1, keepdim=True)))
    o = torch.matmul(p, v.float()) / p.sum(dim=-1, keepdim=True)
    return o.to(qkv.dtype).permute(0, 2, 1, 3).reshape(B, N, C3 // 3)


def layernorm_control(x, weight, bias, eps: float = 1e-6, out_dtype=None):
    """The plain LayerNorm with the unbiased variance, as a kernel that got
    that step wrong would compute."""
    x32 = x.float()
    xc = x32 - x32.mean(dim=-1, keepdim=True)
    var = (xc * xc).sum(dim=-1, keepdim=True) / (x.shape[-1] - 1)
    y = xc * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return y.to(out_dtype or x.dtype)


def compare(name, got, want):
    """-> (max abs error, share of elements that differ, within the bounds
    of kernel ``name``)."""
    err = (got.float() - want.float()).abs().max().item()
    share = (got != want).float().mean().item()
    if got.dtype == torch.bfloat16:
        ok = (torch.allclose(got.float(), want.float(), **BF16_TOL)
              and share <= BF16_MISMATCH[name])
    else:
        ok = torch.allclose(got, want, **F32_TOL)
    return err, share, ok


def check_kernels(dev, seed: int) -> dict:
    """Phase 2 -> {kernel name: {max_abs_err, ms, plain_ms}}; the times are
    those of the main-path shape (first case of each kernel)."""
    from simple_tad_tpu_torch.ops import flash_attention as fa
    from simple_tad_tpu_torch.ops import ln
    g = torch.Generator(device=dev).manual_seed(seed)
    results = {}
    failures = []

    def run_case(name, case, kernel, plain, control=None):
        got, want = kernel(), plain()
        err, share, ok = compare(name, got, want)
        ms, plain_ms = cuda_ms(kernel), cuda_ms(plain, runs=20)
        print(f"[{name}] {case}: max_abs_err {err:.3e} differ {share:.4f} "
              f"{'ok' if ok else 'FAIL'}  kernel {ms:.4f} ms  "
              f"plain {plain_ms:.4f} ms")
        if not ok:
            failures.append(f"{name} {case}")
        if control is not None:
            c_err, c_share, c_ok = compare(name, control(), want)
            print(f"[{name}] {case}: control max_abs_err {c_err:.3e} "
                  f"differ {c_share:.4f} "
                  f"{'NOT CAUGHT' if c_ok else 'caught'}")
            if c_ok:
                failures.append(f"{name} {case}: the bounds let the "
                                f"control through")
        r = results.setdefault(name, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if "ms" not in r:
            r["ms"], r["plain_ms"] = ms, plain_ms

    print(f"[bounds] bf16: allclose {BF16_TOL} and at most this share of "
          f"outputs differing {BF16_MISMATCH}; fp32: allclose {F32_TOL}")
    ln_cases = [((32 * 1568, 768), torch.bfloat16),   # norm1/norm2, ViT-B b32
                ((32, 768), torch.bfloat16),          # fc_norm
                ((4096, 384), torch.float32),
                ((1000, 1280), torch.bfloat16)]
    for shape, dt in ln_cases:
        C = shape[-1]
        x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5).to(dt)
        w = torch.randn(C, generator=g, device=dev) * 0.2 + 1
        b = torch.randn(C, generator=g, device=dev) * 0.1
        run_case("layernorm", f"{shape} {dt}",
                 lambda: ln.layernorm(x, w, b),
                 lambda: ln.layernorm_plain(x, w, b),
                 lambda: layernorm_control(x, w, b))

    attn_cases = [((32, 1568, 2304), 12, torch.bfloat16),   # ViT-B b32
                  ((8, 1568, 2304), 12, torch.bfloat16),    # ViT-B
                  ((8, 1568, 1152), 6, torch.bfloat16),     # ViT-S
                  ((4, 1568, 3072), 16, torch.bfloat16),    # ViT-L
                  ((2, 200, 384), 2, torch.float32),        # masked tail
                  ((2, 1568, 3840), 16, torch.bfloat16)]    # ViT-H, Dh=80
    for shape, heads, dt in attn_cases:
        qkv = torch.randn(shape, generator=g, device=dev).to(dt)
        scale = (shape[-1] // 3 // heads) ** -0.5
        run_case("attention", f"{shape} H={heads} {dt}",
                 lambda: fa.flash_attention_qkv(qkv, heads, scale),
                 lambda: fa.flash_attention_qkv_plain(qkv, heads, scale),
                 # in fp32 the rounding the control leaves out is exact
                 (lambda: attention_control(qkv, heads, scale))
                 if dt == torch.bfloat16 else None)
        del qkv
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"kernel checks failed: {failures}")
    return results


class MemoryClipDataset:
    """One in-memory clip with the two methods FrameEvaluator calls."""

    def __init__(self, frames: np.ndarray, view_len: int, seed: int):
        from simple_tad_tpu_torch.data.frame_datasets import (ClipEvalView,
                                                              ClipInfo)
        rng = np.random.default_rng(seed)
        n = frames.shape[0]
        labels = (rng.random(n) < 0.3).astype(np.int64)
        names = [f"{t:06d}.jpg" for t in range(n)]
        clip = ClipInfo(
            name="synthetic", zip_path="", frame_names=names,
            timesteps=np.arange(n), binary_labels=labels, cat_labels=labels,
            ego=False, night=False, ttc=np.zeros(n),
            smoothed=np.stack([1.0 - labels, labels], 1).astype(np.float32))
        windows = np.stack([np.arange(s, s + view_len)
                            for s in range(n - view_len + 1)])
        last = windows[:, -1]
        self.frames = frames
        self.view = ClipEvalView(
            clip=clip, unique_frames=np.arange(n),
            window_idx=windows.astype(np.int32), labels=labels[last],
            smoothed=clip.smoothed[last], ttc=clip.ttc[last],
            frame_names=[names[i] for i in last])

    def clip_eval_views(self):
        return [self.view]

    def decode_clip_frames(self, view, resize_on_host=True):
        if resize_on_host:
            raise ValueError("the in-memory clip is resized on the device")
        return self.frames


@contextlib.contextmanager
def routed(layernorm_fn, attention_fn):
    """Route the model's LayerNorm and attention through other versions
    (the plain versions or the controls, for the comparison runs only)."""
    from simple_tad_tpu_torch.models import layers
    from simple_tad_tpu_torch.ops import attention
    with mock.patch.object(layers, "layernorm", layernorm_fn), \
            mock.patch.object(attention, "flash_attention_qkv", attention_fn):
        yield


def logits_of(res) -> np.ndarray:
    return np.stack([res.rows["logits_safe"], res.rows["logits_risk"]], 1)


def run_eval(dev, seed: int):
    """Phase 3 -> (model, stats dict)."""
    n_frames, height, width, batch = 96, 360, 640, 32
    from simple_tad_tpu_torch.eval.engine import FrameEvaluator
    from simple_tad_tpu_torch.models import create_model
    from simple_tad_tpu_torch.ops import flash_attention, ln
    model = create_model("vit_base_patch16_224", device=dev,
                         dtype=torch.bfloat16,
                         generator=torch.Generator().manual_seed(seed),
                         init_scale=1.0)
    cfg = model.cfg
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (n_frames, height, width, 3), np.uint8)
    ds = MemoryClipDataset(frames, cfg.all_frames, seed)
    n_windows = ds.view.window_idx.shape[0]
    chunks = -(-n_windows // batch)
    ev = FrameEvaluator(model, device=dev, batch_size=batch,
                        resize_on_host=False, precompute_tubelets=True)
    ev.evaluate(ds)                                  # warm-up

    ln.LAUNCHES = 0
    flash_attention.LAUNCHES = 0
    res = ev.evaluate(ds)
    launches = {"layernorm": ln.LAUNCHES, "attention": flash_attention.LAUNCHES}
    rates = [res.windows_per_sec] + [ev.evaluate(ds).windows_per_sec
                                     for _ in range(EVAL_RUNS - 1)]
    logits = logits_of(res)
    with routed(ln.layernorm_plain, flash_attention.flash_attention_qkv_plain):
        plain_res = ev.evaluate(ds)
    with routed(layernorm_control, attention_control):
        control = logits_of(ev.evaluate(ds))
    plain = logits_of(plain_res)
    scale = float(np.abs(plain).max())
    err = float(np.abs(logits - plain).max()) / scale
    control_err = float(np.abs(control - plain).max()) / scale
    rate = statistics.median(rates)
    print(f"[eval] vit_base_patch16_224 bf16 batch {batch}: windows "
          f"{res.n_windows}, chunks {chunks}; evaluate median {rate:.2f} "
          f"windows/s over {EVAL_RUNS} runs (min {min(rates):.2f}, max "
          f"{max(rates):.2f}); plain versions {plain_res.windows_per_sec:.2f} "
          f"windows/s (one run)")
    print(f"[eval] AUROC {res.metrics.auroc:.4f}  AUC-MCC "
          f"{res.metrics.mcc_auc:.4f} (seeded labels: shows the metrics "
          f"path runs)")
    print(f"[eval] launches {launches}; logits vs plain: max_abs_err / max "
          f"|logit| {err:.3e}, controls {control_err:.3e} (bound "
          f"{LOGIT_RTOL:.3e}, max |logit| {scale:.3e})")
    assert res.n_windows == n_windows == n_frames - cfg.all_frames + 1
    assert np.isfinite(logits).all(), "non-finite logits"
    assert launches["attention"] == cfg.depth * chunks, launches
    assert launches["layernorm"] == (2 * cfg.depth + 1) * chunks, launches
    assert err <= LOGIT_RTOL, f"logits disagree with the plain run: {err}"
    assert control_err > LOGIT_RTOL, \
        f"the logit bound lets the controls through: {control_err}"
    return model, {"windows_per_sec": rate, "launches": launches,
                   "logits_err": err}


def run_stream(model, dev, seed: int, steps: int = 16) -> float:
    """Phase 4 -> median ms per streamed frame (host clock, synchronised)."""
    from simple_tad_tpu_torch.cli.inference import StreamingScorer
    cfg = model.cfg
    rng = np.random.default_rng(seed + 1)
    frames = torch.from_numpy(rng.integers(
        0, 256, (cfg.all_frames + steps, cfg.img_size, cfg.img_size, 3),
        np.uint8)).to(dev)
    scorer = StreamingScorer(model)
    window = frames[:cfg.all_frames]
    window, risk = scorer.step(window, window[-1])          # warm-up
    times, risks = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        window, risk = scorer.step(window, frames[cfg.all_frames + i])
        risks.append(float(risk))                            # synchronises
        times.append((time.perf_counter() - t0) * 1e3)
    assert all(0.0 <= r <= 1.0 for r in risks), risks
    ms = statistics.median(times)
    print(f"[stream] {steps} batch-1 steps: median {ms:.3f} ms/frame "
          f"(min {min(times):.3f}, max {max(times):.3f})")
    return ms


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    kind = device_check()
    dev = torch.device("cuda", 0)
    build_kernels()
    kstats = check_kernels(dev, args.seed)
    model, estats = run_eval(dev, args.seed)
    run_stream(model, dev, args.seed)

    sources = {
        "layernorm": ("simple_tad_tpu_torch/csrc/layernorm.cu",
                      "simple_tad_tpu/ops/ln.py:27"),
        "attention": ("simple_tad_tpu_torch/csrc/attention.cu",
                      "simple_tad_tpu/ops/flash_attention.py:293"),
    }
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": estats["launches"][name],
         "max_abs_err": kstats[name]["max_abs_err"],
         "ms": kstats[name]["ms"], "plain_ms": kstats[name]["plain_ms"]}
        for name, (src, rep) in sources.items()]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
