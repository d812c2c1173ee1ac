"""A data-parallel (and tensor-parallel) check across the ranks of a
torchrun launch.

    torchrun --standalone --nproc_per_node N -m simple_tad_tpu_torch.parallel.check [--device cpu] [--model_parallel M]

ViT fine-tune steps (fp32 compute, so that the comparison is sharp; drop
path 0) with a batch of 8 clips split over the ranks: the gradient the
ranks average (FinetuneOptimizer.reduce_grads) is held to the whole
batch's on rank 0 alone, and the parameters after the steps with
``zero_stage`` 1 and 2 to stage 0's, bit for bit; each rank's share of
the optimizer state is printed.  On the card the model is ViT-B 16x224,
on the CPU (gloo) a 2-block ViT-S at 32 x 32.  Exits non-zero on a
failed check.

``--model_parallel M`` (M > 1) is the port's counterpart of the JAX
package's dryrun_multichip (__graft_entry__.py): the world is a (data x M)
grid (parallel/tp.py:make_2d_mesh), the block weights are cut over each
model group and the data groups average the gradients, with the dry run's
hyperparameters: drop path 0.1, AdamW at lr 1e-3 with layer decay 0.75,
weight decay 0.05, clip_grad 5.0, ZeRO-1 over the data group.  For ViT-B
16x224 and IV2-6B 8x224 at full width (IV2-6B cut to TP_IV2_DEPTH blocks;
on the CPU a tiny ViT of 4 heads and a tiny IV2 of 3, padded) in fp32, a
batch of 4 clips a data replica: the eval logits, the loss, the gradient
(its global norm and each tensor, gathered whole) and the parameters after
one step against one rank's whole model on the whole batch, each data
shard's masks drawn from that shard's generator; each rank's peak GiB is
printed.  At M = 4 on the card it then takes two IV2-6B full-depth (48
blocks) fine-tune steps in bf16 with gradient checkpointing at batch 2,
with no whole-model run to compare with (one card cannot hold its state):
the loss, that it is finite, the attention backward's calls by route (all
on the wgmma kernels), the second step's ms and each card's peak GiB.
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


# --model_parallel: the dry run's hyperparameters (__graft_entry__.py:58-74)
TP_LR, TP_DROP_PATH = 1e-3, 0.1
TP_OPT = dict(weight_decay=0.05, layer_decay=0.75, clip_grad=5.0)
TP_BATCH = 4                 # clips a data replica
TP_IV2_DEPTH = 4             # IV2-6B's depth in the whole-model comparison
TP_RTOL = 1e-5               # fp32: the order of the sums differs
FULL_BATCH, FULL_STEPS = 2, 2
# registry name, card overrides, CPU overrides
TP_MODELS = {
    "vit": ("vit_base_patch16_224", {},
            dict(img_size=32, all_frames=4, embed_dim=128, depth=2,
                 num_heads=4, init_values=0.1, init_scale=1.0)),
    "iv2": ("internvideo2_6B_patch14_224",
            dict(depth=TP_IV2_DEPTH, num_frames=8),
            dict(img_size=28, num_frames=4, embed_dim=96, depth=2,
                 num_heads=3, attn_pool_num_heads=3, clip_embed_dim=64,
                 init_values=0.1, init_scale=1.0)),
}


def tp_model(family: str, dev, tp=None):
    """The seeded fp32 model of ``family`` at --model_parallel's geometry
    (this rank's share with ``tp``)."""
    from simple_tad_tpu_torch.models import create_model
    name, card, cpu = TP_MODELS[family]
    return create_model(name, device=dev, tp=tp,
                        generator=torch.Generator().manual_seed(0),
                        dtype=torch.float32, param_dtype=torch.float32,
                        drop_path_rate=TP_DROP_PATH,
                        **(cpu if dev.type == "cpu" else card))


def tp_batch(model, batch: int, dev):
    """Seeded clips of the model's geometry, labels 0 / 1, on ``dev``."""
    cfg = model.cfg
    rng = np.random.default_rng(1)
    labels = rng.integers(0, 2, batch)
    video = rng.standard_normal((batch, cfg.all_frames, cfg.img_size,
                                 cfg.img_size, 3)).astype(np.float32)
    video += 0.5 * labels[:, None, None, None, None]
    return torch.from_numpy(video).to(dev), torch.from_numpy(labels).to(dev)


def tp_optimizer(model, dp=None, tp=None, **kw):
    """The dry run's AdamW over ``model``'s parameters."""
    from simple_tad_tpu_torch.train.optim import FinetuneOptimizer
    return FinetuneOptimizer(dict(model.named_parameters()),
                             lr_schedule=TP_LR,
                             depth=model.cfg.depth, data_parallel=dp,
                             model_parallel=tp, **dict(TP_OPT, **kw))


def shard_step(model, opt, video, labels, shards, seed: int, dev,
               keep_grads: bool = True):
    """One fine-tune step whose loss is the mean over ``shards`` (each a
    (rows, data rank)) of the loss of those rows, the masks of each drawn
    from a generator seeded with that data rank folded in (as each data
    replica seeds its own: parallel/mesh.py:rank_seed) -> (loss, a copy of
    the gradients the optimizer reads (None without ``keep_grads``), their
    global norm).  One data replica's rows at data parallelism; every
    replica's on one rank."""
    from simple_tad_tpu_torch.parallel.mesh import rank_seed
    from simple_tad_tpu_torch.train.losses import cross_entropy
    model.train()
    opt.zero_grad()
    loss = 0.0
    for rows, d in shards:
        gen = torch.Generator(device=dev)
        gen.manual_seed(rank_seed(seed, d))
        loss = loss + cross_entropy(model(video[rows], generator=gen),
                                    labels[rows]) / len(shards)
    loss.backward()
    with torch.no_grad():
        opt.reduce_grads()
        grads = ({n: p.grad.detach().clone()
                  for n, p in model.named_parameters()}
                 if keep_grads else None)
        norm = opt.grad_norm()
        opt.step()
    return loss.detach(), grads, norm


def _peak_gib(dev) -> float:
    return (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else 0.0)


def tp_check(family: str, dev, dp, tp, seed: int = 2) -> bool:
    """--model_parallel's comparison for ``family`` (every rank calls it)
    -> passed (on rank 0; True elsewhere)."""
    from simple_tad_tpu_torch.parallel import multihost
    from simple_tad_tpu_torch.parallel.mesh import rank_rows
    from simple_tad_tpu_torch.parallel.tp import gather_state_dict
    from simple_tad_tpu_torch.train.optim import global_norm
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    model = tp_model(family, dev, tp)
    heads = model.cfg.num_heads
    batch = TP_BATCH * dp.world
    video, labels = tp_batch(model, batch, dev)
    with torch.no_grad():
        logits = model.eval()(video)
    opt = tp_optimizer(model, dp, tp, zero_stage=1)
    rows = rank_rows(batch, dp.rank, dp.world)
    loss, grads, norm = shard_step(model, opt, video, labels,
                                   [(rows, dp.rank)], seed, dev)
    loss = loss.clone()
    dp.all_reduce_mean([loss])
    grads = gather_state_dict(grads, heads, tp)
    params = gather_state_dict({n: p.detach() for n, p in
                                model.named_parameters()}, heads, tp)
    peaks = multihost.allgather_object(_peak_gib(dev))
    del model, opt
    ok = True
    if multihost.rank() == 0:
        grads = {n: g.to(dev) for n, g in grads.items()}
        params = {n: t.to(dev) for n, t in params.items()}
        whole = tp_model(family, dev)
        with torch.no_grad():
            want_logits = whole.eval()(video)
        wopt = tp_optimizer(whole)
        shards = [(rank_rows(batch, d, dp.world), d) for d in range(dp.world)]
        want_loss, want_grads, want_norm = shard_step(
            whole, wopt, video, labels, shards, seed, dev)
        errs = {
            "logits": ((logits - want_logits).abs().max()
                       / want_logits.abs().max()).item(),
            "loss": abs(loss - want_loss).item() / abs(want_loss).item(),
            "grad_norm": abs(norm - want_norm).item() / want_norm.item(),
            "grads": (global_norm([grads[n] - want_grads[n]
                                   for n in want_grads])
                      / want_norm).item()}
        step_err = max((params[n] - p).abs().max().item()
                       for n, p in whole.named_parameters())
        name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu")
        label = (TP_MODELS[family][0] if dev.type == "cuda"
                 else f"a tiny {family}")
        print(f"[tp {family}] {label} depth "
              f"{whole.cfg.depth}, {heads} heads over {tp.size} model ranks "
              f"x {dp.world} data ranks on {name}, fp32, batch {batch}: "
              + ", ".join(f"{k} rel err {v:.3e}" for k, v in errs.items())
              + f" (bound {TP_RTOL:.0e}); parameters after the step max abs "
              f"err {step_err:.3e} (bound {2.5 * TP_LR:.1e}: AdamW's first "
              f"step moves an element by at most lr); loss "
              f"{want_loss.item():.6f}; peak GiB a rank "
              f"{' '.join(f'{x:.2f}' for x in peaks)}", flush=True)
        ok = (max(errs.values()) <= TP_RTOL and step_err <= 2.5 * TP_LR)
        del whole, wopt
    multihost.barrier()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return ok


def _bwd_routes() -> dict:
    """-> {route: calls} of the training attention backward so far."""
    from simple_tad_tpu_torch.ops import flash_attention as fa
    return {r: getattr(fa, name) for r, name in fa._BWD_COUNTERS.items()}


def full_depth_step(dev, dp, tp) -> bool:
    """IV2-6B at full depth, bf16 with fp32 masters and gradient
    checkpointing, FULL_STEPS steps at FULL_BATCH a data replica ->
    finite losses (on every rank)."""
    import time
    from simple_tad_tpu_torch.models import create_model
    from simple_tad_tpu_torch.parallel import multihost
    from simple_tad_tpu_torch.parallel.mesh import rank_rows
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    model = create_model("internvideo2_6B_patch14_224", device=dev,
                         generator=gen, tp=tp, num_frames=8,
                         dtype=torch.bfloat16, param_dtype=torch.float32,
                         drop_path_rate=TP_DROP_PATH, remat=True)
    init_s = time.perf_counter() - t0
    batch = FULL_BATCH * dp.world
    video, labels = tp_batch(model, batch, dev)
    video = video.to(torch.bfloat16)
    opt = tp_optimizer(model, dp, tp, zero_stage=1)
    rows = rank_rows(batch, dp.rank, dp.world)
    losses, times = [], []
    routes = _bwd_routes()
    for _ in range(FULL_STEPS):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        loss, _, norm = shard_step(model, opt, video, labels,
                                   [(rows, dp.rank)], 3, dev,
                                   keep_grads=False)
        torch.cuda.synchronize(dev)
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(loss.item())
    routes = {r: n - routes[r] for r, n in _bwd_routes().items()}
    n_local = sum(p.numel() for p in model.parameters())
    peaks = multihost.allgather_object(_peak_gib(dev))
    # every backward call on the wgmma kernels (head dim 128)
    ok = bool(np.isfinite(losses).all()) and routes["mma_sync"] == 0 \
        and routes["wgmma"] > 0
    if multihost.rank() == 0:
        print(f"[tp iv2 full depth] internvideo2_6B_patch14_224 8x224, "
              f"{model.cfg.depth} blocks, {model.cfg.num_heads} heads padded "
              f"to "
              f"{model.blocks[0].attn.local_heads * tp.size} over {tp.size} "
              f"model ranks x {dp.world} data ranks on "
              f"{torch.cuda.get_device_name(dev)}, bf16 with fp32 masters, "
              f"use_checkpoint, batch {batch}: losses "
              f"{' '.join(f'{x:.6f}' for x in losses)} (finite: {ok}), "
              f"grad_norm {norm.item():.4e}; attention backward calls "
              f"a rank by route {routes}; step ms "
              f"{' '.join(f'{t:.1f}' for t in times)} (the last is one "
              f"check's reading, not a benchmark); seeded init "
              f"{init_s:.1f} s; parameters a rank {n_local / 1e9:.3f} B; "
              f"peak GiB a card {' '.join(f'{x:.2f}' for x in peaks)}",
              flush=True)
    multihost.barrier()
    return ok


def tp_main(args, dev_name: str) -> bool:
    from simple_tad_tpu_torch.parallel import multihost
    from simple_tad_tpu_torch.parallel.tp import make_2d_mesh
    if not multihost.initialize(torch.device(dev_name).type):
        raise SystemExit("launch with torchrun --nproc_per_node N (N > 1)")
    dp, tp = make_2d_mesh(args.model_parallel, dev_name)
    dev = dp.device
    ok = all([tp_check(family, dev, dp, tp) for family in TP_MODELS])
    if dev.type == "cuda" and tp.size == 4:
        ok = full_depth_step(dev, dp, tp) and ok
    return ok


def main(argv=None) -> None:
    from simple_tad_tpu_torch.parallel import multihost
    from simple_tad_tpu_torch.parallel.mesh import (data_parallel_setup,
                                                    rank_rows)
    from simple_tad_tpu_torch.train.optim import global_norm
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--model_parallel", type=int, default=1)
    args = ap.parse_args(argv)
    if args.model_parallel > 1:
        ok = tp_main(args, args.device)
        ok = all(multihost.allgather_object(ok))
        rank = multihost.rank()
        torch.distributed.destroy_process_group()
        if not ok:
            raise SystemExit(1)
        if rank == 0:
            print("tensor-parallel check ok")
        return
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
