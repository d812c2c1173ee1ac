"""A data-parallel check across the ranks of a torchrun launch.

    torchrun --standalone --nproc_per_node N -m simple_tad_tpu_torch.parallel.check [--device cpu]

ViT fine-tune steps (fp32 compute, so that the comparison is sharp; drop
path 0) with a batch of 8 clips split over the ranks: the gradient the
ranks average (FinetuneOptimizer.reduce_grads) is held to the whole
batch's on rank 0 alone, and the parameters after the steps with
``zero_stage`` 1 and 2 to stage 0's, bit for bit; each rank's share of
the optimizer state is printed.  On the card the model is ViT-B 16x224,
on the CPU (gloo) a 2-block ViT-S at 32 x 32.  Exits non-zero on a
failed check.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed

BATCH, STEPS = 8, 2
GRAD_RTOL = 1e-5        # fp32: the order of the sums differs, nothing else


def _model(dev):
    from simple_tad_tpu_torch.models import create_model
    cpu = dev.type == "cpu"
    return create_model("vit_small_patch16_224" if cpu
                        else "vit_base_patch16_224", device=dev,
                        dtype=torch.float32, param_dtype=torch.float32,
                        drop_path_rate=0.0,
                        generator=torch.Generator().manual_seed(0),
                        **(dict(img_size=32, depth=2) if cpu else {}))


def _batches(dev):
    rng = np.random.default_rng(1)
    size = 32 if dev.type == "cpu" else 224
    out = []
    for _ in range(STEPS):
        labels = rng.integers(0, 2, BATCH)
        video = rng.standard_normal((BATCH, 16, size, size, 3)).astype(
            np.float32) + 0.5 * labels[:, None, None, None, None]
        out.append((torch.from_numpy(video).to(dev),
                    torch.from_numpy(labels).to(dev)))
    return out


def run(dev, dp, rows, zero_stage: int):
    """STEPS steps on ``rows`` of each batch -> (the first step's averaged
    gradients, the parameters after the last, this rank's state
    elements)."""
    from simple_tad_tpu_torch.train.losses import cross_entropy
    from simple_tad_tpu_torch.train.optim import FinetuneOptimizer
    model = _model(dev).train()
    opt = FinetuneOptimizer(dict(model.named_parameters()), lr_schedule=1e-4,
                            weight_decay=0.05, layer_decay=0.75,
                            depth=model.cfg.depth, clip_grad=1.0,
                            data_parallel=dp, zero_stage=zero_stage)
    first = None
    for video, labels in _batches(dev):
        opt.zero_grad()
        cross_entropy(model(video[rows]), labels[rows]).backward()
        opt.reduce_grads()
        if first is None:
            first = {n: p.grad.detach().clone()
                     for n, p in model.named_parameters()}
        opt.step()
    held = sum(t.numel() for slot in opt.state.values()
               for t in slot.values())
    return first, {n: p.detach().clone()
                   for n, p in model.named_parameters()}, held


def main(argv=None) -> None:
    from simple_tad_tpu_torch.parallel import multihost
    from simple_tad_tpu_torch.parallel.mesh import (data_parallel_setup,
                                                    rank_rows)
    from simple_tad_tpu_torch.train.optim import global_norm
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dp = data_parallel_setup(args.device)
    world, rank, dev = dp
    if world < 2:
        raise SystemExit("launch with torchrun --nproc_per_node N (N > 1)")
    rows = rank_rows(BATCH, rank, world)
    out = {z: run(dev, dp, rows, z) for z in (0, 1, 2)}
    held = {z: multihost.allgather_object(out[z][2]) for z in (0, 1, 2)}
    ok = True
    if rank == 0:
        want = run(dev, None, slice(None), 0)[0]
        got = out[0][0]
        err = (global_norm([got[n] - want[n] for n in want])
               / global_norm(want.values())).item()
        worst = max(((got[n] - want[n]).norm()
                     / want[n].norm().clamp_min(1e-30)).item()
                    for n in want)
        name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu")
        print(f"world {world} on {name}: the averaged gradient against the "
              f"whole batch's on one rank: {err:.3e} of the global norm, "
              f"worst parameter {worst:.3e} (bound {GRAD_RTOL:.0e})")
        ok = err <= GRAD_RTOL
        for z in (1, 2):
            same = all(torch.equal(out[z][1][n], out[0][1][n])
                       for n in out[0][1])
            print(f"zero_stage {z}: parameters bit-equal to stage 0's: "
                  f"{same}; state elements a rank {held[z]} (stage 0: "
                  f"{held[0][0]} on each)")
            ok = ok and same and sum(held[z]) == held[0][0]
    multihost.barrier()
    torch.distributed.destroy_process_group()
    if not ok:
        raise SystemExit(1)
    if rank == 0:
        print("data-parallel check ok")


if __name__ == "__main__":
    main()
