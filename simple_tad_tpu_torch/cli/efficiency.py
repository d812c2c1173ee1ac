"""Model-efficiency benchmark harness, in the port.

Port of simple_tad_tpu/cli/efficiency.py (reference: test_efficiency.py:
12-197): per model, the forward's latency and throughput at each batch of
a sweep, and the peak device memory; and, with ``--train_input``, the host
side of a training step (decoded windows/s through the port's TrainLoader
and the FrameLRU hit rate).  On the card each batch's calls are timed
with CUDA events around a chunk of calls on distinct host-made inputs
(the fastest of three chunks, per call); the peak is
``torch.cuda.max_memory_allocated`` over that batch's calls, reported in
the JAX rows' ``peak_hbm_mb`` key so that the rows keep their keys.  With
``--device cpu`` the chunks are timed by the host clock and the peak is
None.  The JAX package's compile cache (utils/cache.py) has no
counterpart.

Usage:
  python -m simple_tad_tpu_torch.cli.efficiency \\
      --model vit_base_patch16_224 --batches 1 8 32 --iters 50
  python -m simple_tad_tpu_torch.cli.efficiency --train_input \\
      --data_path <dota_root> [--native_decoder]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def benchmark_model(name: str, *, batches=(1, 8, 32), iters: int = 50,
                    num_frames: int = 16, input_size: int = 224,
                    dtype=torch.bfloat16, device="cuda", seed: int = 0):
    """Rows {model, batch, latency_ms, clips_per_sec, params_m,
    peak_hbm_mb} of ``name``'s forward (2 classes, weights seeded from
    ``seed``) at each batch, each also printed as a JSON line."""
    from simple_tad_tpu_torch.models import create_model
    dev = torch.device(device)
    model = create_model(name, device=dev,
                         generator=torch.Generator().manual_seed(seed),
                         num_classes=2, all_frames=num_frames,
                         img_size=input_size, dtype=dtype)
    n_params = sum(p.numel() for p in model.parameters())
    cuda = dev.type == "cuda"
    rows = []
    for b in batches:
        shape = (b, num_frames, input_size, input_size, 3)
        # every timed call reads its own input; the pool bounded to ~4 GB
        buf_bytes = int(np.prod(shape)) * torch.finfo(dtype).bits // 8
        nbuf = int(max(6, min(3 * iters, 4e9 // max(buf_bytes, 1))))
        rng = np.random.default_rng(1)
        bufs = [torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32) * 0.5).to(dev, dtype)
            for _ in range(nbuf + 1)]
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        per_rep = max(nbuf // 3, 1)
        times = []
        with torch.inference_mode():
            model(bufs[-1]).cpu()                             # warm-up
            for rep in range(3):
                chunk = bufs[rep * per_rep:(rep + 1) * per_rep] or bufs[:1]
                if cuda:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for x in chunk:
                        model(x)
                    end.record()
                    end.synchronize()
                    times.append(start.elapsed_time(end) / len(chunk))
                else:
                    t0 = time.perf_counter()
                    for x in chunk:
                        model(x)
                    times.append((time.perf_counter() - t0) * 1e3
                                 / len(chunk))
        ms = min(times)
        peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 20
                if cuda else 0.0)
        rows.append({"model": name, "batch": b,
                     "latency_ms": round(ms, 2),
                     "clips_per_sec": round(b / (ms / 1000), 1),
                     "params_m": round(n_params / 1e6, 1),
                     "peak_hbm_mb": round(peak, 1) or None})
        print(json.dumps(rows[-1]))
        del bufs
    return rows


def benchmark_train_input(dataset, *, batch_size: int = 24, steps: int = 20,
                          num_threads: int = 4, resize_scale: float = 1.1,
                          num_sample: int = 1, step_ms: float = 0.0):
    """The HOST side of a training step: decoded windows/s through
    TrainLoader (threaded zip decode + the frame LRU) in a cold epoch and
    a warm one, the LRU's hit rate, and, given the device step time, the
    input occupancy (host decode time a batch over the step time: below 1
    the host keeps up)."""
    import itertools

    from simple_tad_tpu_torch.data.zipreader import frame_cache
    from simple_tad_tpu_torch.train.engine import TrainLoader

    cache = frame_cache()
    if cache is not None:
        cache.clear()
    loader = TrainLoader(dataset, batch_size, num_threads=num_threads,
                         resize_scale=resize_scale, num_sample=num_sample)
    steps = min(steps, loader.steps_per_epoch())
    if steps < 1:
        print(json.dumps({"phase": "train_input", "skipped":
                          "dataset shorter than one batch"}))
        return []
    # epoch 0 = cold cache; epoch 1 = steady state (the LRU holds frames
    # shared between overlapping windows)
    rows = []
    for epoch in (0, 1):
        t0 = time.perf_counter()
        n = 0
        for batch in itertools.islice(loader.epoch(epoch), steps):
            n += batch["video_u8"].shape[0]
        dt = time.perf_counter() - t0
        wps = n / dt
        row = {"phase": f"train_input_epoch{epoch}",
               "windows_per_sec": round(wps, 1),
               "frames_per_sec": round(wps * dataset.view_len, 1),
               "cache_hit_rate": round(
                   cache.hits / max(cache.hits + cache.misses, 1), 3)
               if cache is not None else None}
        if step_ms > 0:
            row["input_occupancy"] = round(
                (batch_size / wps) / (step_ms / 1000.0), 3)
        rows.append(row)
        print(json.dumps(row))
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser("simple_tad_tpu_torch efficiency "
                                     "benchmark")
    parser.add_argument("--model", nargs="+",
                        default=["vit_small_patch16_224",
                                 "vit_base_patch16_224"])
    parser.add_argument("--batches", nargs="+", type=int, default=[1, 8, 32])
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--num_frames", type=int, default=16)
    parser.add_argument("--input_size", type=int, default=224)
    parser.add_argument("--attn_impl", default="auto",
                        help="accepted for the JAX CLI's command lines; the "
                             "port has one attention path")
    parser.add_argument("--dtype", default="bfloat16")
    parser.add_argument("--device", default="cuda")
    # host input-pipeline probe (no device needed)
    parser.add_argument("--train_input", action="store_true",
                        help="measure TrainLoader decode throughput instead")
    parser.add_argument("--data_path", default=None)
    parser.add_argument("--data_set", default="DoTA",
                        choices=["DoTA", "DADA2K"])
    parser.add_argument("--batch_size", type=int, default=24)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--num_threads", type=int, default=4)
    parser.add_argument("--step_ms", type=float, default=0.0,
                        help="known device step time for occupancy")
    parser.add_argument("--native_decoder", action="store_true",
                        help="decode the zips with the C++ decoder")
    args = parser.parse_args(argv)

    if args.train_input:
        import types

        from simple_tad_tpu_torch.data.builders import build_frame_dataset
        ds_args = types.SimpleNamespace(
            data_path=args.data_path, data_set=args.data_set,
            num_frames=args.num_frames, sampling_rate=1, view_fps=10,
            input_size=args.input_size, ttc_TT=2.0, ttc_TA=1.0,
            native_decoder=args.native_decoder)
        dataset, _ = build_frame_dataset(True, False, ds_args)
        return benchmark_train_input(
            dataset, batch_size=args.batch_size, steps=args.steps,
            num_threads=args.num_threads, step_ms=args.step_ms)

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    out = []
    for name in args.model:
        out += benchmark_model(name, batches=tuple(args.batches),
                               iters=args.iters, num_frames=args.num_frames,
                               input_size=args.input_size, dtype=dtype,
                               device=args.device)
    return out


if __name__ == "__main__":
    main()
