"""Tensor parallelism of the port (simple_tad_tpu_torch/parallel/tp.py)
against the JAX package and the port's world-1 model, on the CPU.

In one process: the parameter specs (tests/test_tp.py::test_param_specs on
the port's names), the shard / merge round trip with head padding, IV2-6B
at model-parallel 4 on the meta device (the counterpart of
tests/test_tp.py::test_iv2_6b_tp_compiles_shape_only), the q/k RMSNorm
Function at one rank against the whole-width RMSNorm, the Philox keep mask
at a head offset against the slice of the whole mask, the dropout dispatch
under a head offset, and the refusals.

One ``torchrun --standalone --nproc_per_node 4`` launch over gloo (one
torch thread a process, a free port, a time limit) runs this file as its
worker, as tests/test_torch_ddp.py does, on a (data x model) grid of
2 x 2 and then 1 x 4 (parallel/tp.py:make_2d_mesh), with a tiny ViT
(4 heads of 32) and a tiny InternVideo2 with q/k-norms (3 heads of 32,
padded to 4), both from the JAX package's weights (from_jax_params, then
shard_state_dict).  The test then holds what the ranks computed:

* the eval logits against the JAX forward, within 1e-5 of their largest
  magnitude (fp32);
* one fine-tune step with SGD momentum through the whole chain (see
  tests/test_torch_ddp.py: the cross-rank sums round differently, and
  Adam's first step turns the last bits of a cancelling gradient into up
  to ~lr) against the JAX make_finetune_train_step and the port's world-1
  step, each parameter within 1e-5 of its leaf's largest magnitude;
* the same step with drop path 0.1 and, for the ViT, attention dropout 0.3
  in both forms ('rng', 'mask'): against the port's world-1 step (each data
  shard's masks drawn from that shard's generator, parallel/check.py:
  shard_step) and against the JAX chain on the JAX model's gradients, its
  blocks unscanned and fed the world-1 step's masks (the JAX
  make_dropout_mask and jax.random.bernoulli monkeypatched, as
  tests/test_torch_train_dropout.py and tests/test_torch_iv2_train.py feed
  them), within 1e-5 of each leaf's largest magnitude;
* an AdamW + clip_grad 5.0 step with drop path 0.1 (dryrun_multichip's
  hyperparameters): loss and global gradient norm against world 1 within
  1e-5 relative; ZeRO-1 over the data group bit-equal to stage 0;
* the q/k RMSNorm on each rank's columns against the whole-width one,
  forward and backward; the padded heads' weights and gradients exactly 0
  after a step;
* a checkpoint written at model-parallel 2 read at world 1 and at
  model-parallel 4, with equal logits (1e-5);
* parallel/check.py --model_parallel 2 passes.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

VIT = dict(img_size=32, all_frames=4, patch_size=16, tubelet_size=2,
           embed_dim=128, depth=2, num_heads=4, num_classes=2,
           init_scale=1.0, init_values=0.1)
IV2 = dict(img_size=28, patch_size=14, embed_dim=96, depth=2, num_heads=3,
           mlp_ratio=4.0, num_frames=2, attn_pool_num_heads=3,
           clip_embed_dim=32, init_scale=1.0, num_classes=2)
FAMILIES = {"vit": VIT, "iv2": IV2}
B = 4
LR = 5e-4
# SGD momentum through the whole chain (module docstring)
OPT = dict(weight_decay=0.05, layer_decay=0.75, depth=2, clip_grad=1.0,
           opt="momentum")
# dryrun_multichip's (__graft_entry__.py:58-74)
ADAMW = dict(weight_decay=0.05, layer_decay=0.75, depth=2, clip_grad=5.0)
DROP_PATH, ATTN_DROP = 0.1, 0.3
STEP_SEED = 5             # its drop-path draws drop a sample in every case
MPS = (2, 4)
WORLD = 4
# the step cases: (family, case) -> the model's config overrides
CASES = {
    ("vit", "sgd"): dict(drop_path_rate=0.0),
    ("iv2", "sgd"): dict(drop_path_rate=0.0),
    ("vit", "rng"): dict(drop_path_rate=DROP_PATH, attn_drop_rate=ATTN_DROP,
                         attn_dropout_form="rng"),
    ("vit", "mask"): dict(drop_path_rate=DROP_PATH,
                          attn_drop_rate=ATTN_DROP,
                          attn_dropout_form="mask"),
    ("iv2", "drop_path"): dict(drop_path_rate=DROP_PATH),
    ("vit", "adamw"): dict(drop_path_rate=DROP_PATH),
    ("iv2", "adamw"): dict(drop_path_rate=DROP_PATH),
}
LAUNCH_TIMEOUT_S = 300
RTOL = 1e-5


# ------------------------------------------------------ shared with workers --

def _port(family, state_dict, tp=None, **cfg):
    """The port's fp32-master model of ``family`` with ``state_dict`` (the
    whole model's; a tensor-parallel rank loads its share)."""
    from simple_tad_tpu_torch.models.internvideo2 import (IV2Config,
                                                          InternVideo2)
    from simple_tad_tpu_torch.models.vit import ViTConfig, VisionTransformer
    from simple_tad_tpu_torch.parallel.tp import shard_state_dict
    if family == "vit":
        model = VisionTransformer(ViTConfig(**VIT, param_dtype=torch.float32,
                                            **cfg), device="cpu", tp=tp)
    else:
        model = InternVideo2(IV2Config(**dict(dict(drop_path_rate=0.0),
                                              **IV2, **cfg),
                                       param_dtype=torch.float32),
                             device="cpu", tp=tp)
    if tp is not None:
        state_dict = shard_state_dict(state_dict,
                                      FAMILIES[family]["num_heads"], tp.size,
                                      tp.rank)
    model.load_state_dict(state_dict)
    return model


def _optimizer(model, case, dp=None, tp=None, zero_stage=0):
    from simple_tad_tpu_torch.train.optim import FinetuneOptimizer
    kw = ADAMW if case == "adamw" else OPT
    return FinetuneOptimizer(dict(model.named_parameters()), lr_schedule=LR,
                             data_parallel=dp, model_parallel=tp,
                             zero_stage=zero_stage, **kw)


def _step(inputs, family, case, shards, dp=None, tp=None, zero_stage=0):
    """One step of ``case`` on the whole batch's ``shards`` -> (model,
    optimizer, loss, grads, grad norm)."""
    from simple_tad_tpu_torch.parallel.check import shard_step
    model = _port(family, inputs[family], tp, **CASES[family, case])
    opt = _optimizer(model, case, dp, tp, zero_stage)
    video, labels = inputs["batch"][family]
    loss, grads, norm = shard_step(model, opt, video, labels, shards,
                                   STEP_SEED, torch.device("cpu"))
    return model, opt, loss, grads, norm


# ------------------------------------------------------------- the worker --

def _cut_last(t, size, rank):
    """The columns of model rank ``rank`` of (..., C) ``t``, cut by head as
    the q/k-norm's input is."""
    from simple_tad_tpu_torch.parallel.tp import ParamSpec, shard_tensor
    spec = ParamSpec("column", 0, True)
    lead = t.shape[:-1]
    cut = shard_tensor(t.reshape(-1, t.shape[-1]).T, spec,
                       IV2["num_heads"], size, rank)
    return cut.T.reshape(*lead, -1).contiguous()


def _merge_last(parts, t_like):
    from simple_tad_tpu_torch.parallel.tp import ParamSpec, merge_tensors
    spec = ParamSpec("column", 0, True)
    whole = merge_tensors([p.reshape(-1, p.shape[-1]).T for p in parts],
                          spec, IV2["num_heads"])
    return whole.T.reshape(t_like.shape)


def _qk_norm_errors(tp):
    """The q/k RMSNorm on this rank's columns against the whole-width one
    -> (forward, input-gradient, weight-gradient) max relative errors."""
    from simple_tad_tpu_torch.models.internvideo2 import rmsnorm_plain
    from simple_tad_tpu_torch.parallel.tp import qk_rmsnorm
    C = IV2["embed_dim"]
    rng = np.random.default_rng(7)
    x, dy = (torch.from_numpy(rng.standard_normal((2, 5, C)).astype(
        np.float32)) for _ in range(2))
    w = torch.from_numpy(1 + 0.1 * rng.standard_normal(C).astype(
        np.float32))
    xw, ww = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    want = rmsnorm_plain(xw, ww, 1e-6, torch.float32)
    want.backward(dy)
    xl = _cut_last(x, tp.size, tp.rank).requires_grad_(True)
    wl = _cut_last(w[None], tp.size, tp.rank)[0].requires_grad_(True)
    got = qk_rmsnorm(xl, wl, 1e-6, torch.float32, C, tp)
    got.backward(_cut_last(dy, tp.size, tp.rank))
    pairs = [(got.detach(), want.detach()), (xl.grad, xw.grad),
             (wl.grad[None], ww.grad[None])]
    out = []
    for local, whole in pairs:
        merged = _merge_last(tp.all_gather(local), whole)
        out.append(((merged - whole).abs().max()
                    / whole.abs().max()).item())
    return out


def _padded_zero(model, grads, tp):
    """On this rank: are the padded heads' qkv rows, q/k-norm entries and
    proj columns, and their gradients, all exactly 0?  (True where the rank
    holds no padding.)"""
    from simple_tad_tpu_torch.parallel.tp import padded_heads
    H = IV2["num_heads"]
    hl = padded_heads(H, tp.size) // tp.size
    real = max(0, min(hl, H - tp.rank * hl))
    if real == hl:
        return True
    d = IV2["embed_dim"] // H
    ok = True
    for i, blk in enumerate(model.blocks):
        pre = f"blocks.{i}.attn."
        for name, dim, groups in (("qkv.weight", 0, 3),
                                  ("q_norm.weight", 0, 1),
                                  ("k_norm.weight", 0, 1),
                                  ("proj.weight", 1, 1)):
            for t in (model.get_parameter(pre + name).detach(),
                      grads[pre + name]):
                shape = list(t.shape)
                shape[dim:dim + 1] = [groups, hl, d]
                pad = t.reshape(shape).narrow(dim + 1, real, hl - real)
                ok = ok and bool((pad == 0).all())
    return ok


def _resumed_step(inputs, state, tp=None):
    """One drop-path step of the ViT on the whole batch from a loaded
    ``state``, its masks drawn from the loaded generator -> the whole
    parameters after it."""
    from simple_tad_tpu_torch.parallel.tp import gather_state_dict
    from simple_tad_tpu_torch.train.losses import cross_entropy
    from simple_tad_tpu_torch.train.steps import backward_and_update
    video, labels = inputs["batch"]["vit"]
    model = state.model.train()
    state.optimizer.zero_grad()
    backward_and_update(state.optimizer, cross_entropy(
        model(video, generator=state.generator), labels))
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return (params if tp is None
            else gather_state_dict(params, VIT["num_heads"], tp))


def _worker(work):
    from simple_tad_tpu_torch.parallel import multihost
    from simple_tad_tpu_torch.parallel.mesh import rank_rows, rank_seed
    from simple_tad_tpu_torch.parallel.tp import (gather_state_dict,
                                                  make_2d_mesh)
    from simple_tad_tpu_torch.train.steps import TrainState
    from simple_tad_tpu_torch.utils import checkpoint as ckpt
    torch.set_num_threads(1)
    assert multihost.initialize("cpu") and multihost.world_size() == WORLD
    inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    main = multihost.is_main_process()
    out = {}
    for mp in MPS:
        dp, tp = make_2d_mesh(mp, "cpu")
        res = out[mp] = {}
        shards = [(rank_rows(B, dp.rank, dp.world), dp.rank)]
        for family in FAMILIES:
            heads = FAMILIES[family]["num_heads"]
            model = _port(family, inputs[family], tp)
            with torch.no_grad():
                res[family, "logits"] = model.eval()(
                    inputs["batch"][family][0])
        for (family, case) in CASES:
            heads = FAMILIES[family]["num_heads"]
            model, opt, loss, grads, norm = _step(inputs, family, case,
                                                  shards, dp, tp)
            loss = loss.clone()
            dp.all_reduce_mean([loss])
            res[family, case] = {
                "loss": loss, "grad_norm": norm,
                "params": gather_state_dict(dict(model.named_parameters()),
                                            heads, tp)}
            if family == "iv2" and case == "adamw":
                res["padded_zero"] = multihost.allgather_object(
                    _padded_zero(model, grads, tp))
            if family == "vit" and case == "adamw" and mp == 2:
                zero = _step(inputs, family, case, shards, dp, tp,
                             zero_stage=1)[0]
                res["zero1_equal"] = all(torch.equal(
                    p, model.get_parameter(n))
                    for n, p in zero.named_parameters())
                gen = torch.Generator().manual_seed(rank_seed(STEP_SEED,
                                                              dp.rank))
                ckpt.save_train_state(work, TrainState(model, opt, gen), 0)
                multihost.barrier()
        res["qk_norm"] = _qk_norm_errors(tp)
        if mp == 4:
            model = _port("vit", inputs["vit"], tp, **CASES["vit", "adamw"])
            state = TrainState(model, _optimizer(model, "adamw", dp, tp),
                               torch.Generator())
            ckpt.load_train_state(work, state)
            with torch.no_grad():
                res["ckpt_logits"] = model.eval()(inputs["batch"]["vit"][0])
            res["ckpt_generators"] = multihost.allgather_object(
                state.generator.get_state())
            res["ckpt_step"] = _resumed_step(inputs, state, tp)
    from simple_tad_tpu_torch.parallel.check import main as check_main
    check_main(["--device", "cpu", "--model_parallel", "2"])
    out["check"] = True
    if main:
        torch.save(out, os.path.join(work, "results.pt"))


# ---------------------------------------------------------------- the JAX --

def _jax_params(family, seed):
    """JAX init, every leaf moved by seeded noise (LayerScale and norms by
    0.1, so the trunk moves the loss)."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    if family == "vit":
        from simple_tad_tpu.models.vit import ViTConfig as JC
        from simple_tad_tpu.models.vit import VisionTransformer as JM
        params = JM(JC(**VIT)).init_params(jax.random.PRNGKey(seed))
    else:
        from simple_tad_tpu.models.internvideo2 import IV2Config as JC
        from simple_tad_tpu.models.internvideo2 import InternVideo2 as JM
        params = JM(JC(**IV2, drop_path_rate=0.0)).init(
            jax.random.PRNGKey(seed), jnp.zeros((1, 2, 28, 28, 3)))["params"]

    def move(path, a):
        big = any(k in jax.tree_util.keystr(path)
                  for k in ("scale", "gamma"))
        return np.asarray(a, np.float32) + (0.1 if big else 0.02) * \
            rng.standard_normal(a.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(move, params)


def _jax_model(family, scan=True, **cfg):
    if family == "vit":
        from simple_tad_tpu.models.vit import ViTConfig as JC
        from simple_tad_tpu.models.vit import VisionTransformer as JM
        return JM(JC(**VIT, attn_impl="naive", scan_blocks=scan, **cfg))
    from simple_tad_tpu.models.internvideo2 import IV2Config as JC
    from simple_tad_tpu.models.internvideo2 import InternVideo2 as JM
    return JM(JC(**dict(dict(drop_path_rate=0.0), **IV2, **cfg),
                 attn_impl="xla", scan_blocks=scan))


def _jax_batch(inputs, family):
    video, labels = inputs["batch"][family]
    return {"video": video.numpy(), "label": labels.numpy().astype(np.int32),
            "smoothed": np.zeros((B, 2), np.float32),
            "ttc": np.zeros(B, np.float32)}


def _jax_step(inputs, family):
    """make_finetune_train_step with SGD momentum on the whole batch."""
    import jax
    import jax.numpy as jnp
    from simple_tad_tpu.train import losses as JL
    from simple_tad_tpu.train import optim as JO
    from simple_tad_tpu.train.steps import TrainState as JS
    from simple_tad_tpu.train.steps import make_finetune_train_step
    params = inputs["jax"][family]
    tx = JO.create_optimizer(params, lr_schedule=LR, **OPT)
    step = make_finetune_train_step(_jax_model(family), tx,
                                    JL.create_criterion("crossentropy"),
                                    donate=False)
    state = JS.create(jax.tree_util.tree_map(jnp.asarray, params), tx,
                      jax.random.PRNGKey(1))
    state, _ = step(state, jax.tree_util.tree_map(
        jnp.asarray, _jax_batch(inputs, family)))
    return state.params


def _unscanned(params, depth):
    import jax
    out = dict(params)
    blocks = out.pop("blocks")
    for i in range(depth):
        out[f"blocks_{i}"] = jax.tree_util.tree_map(lambda a: a[i], blocks)
    return out


def _rescanned(tree, depth):
    import jax
    import jax.numpy as jnp
    out = dict(tree)
    layers = [out.pop(f"blocks_{i}") for i in range(depth)]
    out["blocks"] = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *layers)
    return out


def _jax_fed_step(inputs, family, case, attn_masks, path_masks, monkeypatch):
    """The JAX chain (create_optimizer: clip, SGD momentum, weight decay,
    layer decay) on the gradients of the JAX model with its blocks
    unscanned, whose attention dropout and stochastic depth take
    ``attn_masks`` and ``path_masks`` in call order -> params."""
    import jax
    import jax.numpy as jnp
    import optax
    import simple_tad_tpu.ops.attention as jattn
    from simple_tad_tpu.train import losses as JL
    from simple_tad_tpu.train import optim as JO
    cfg = {k: v for k, v in CASES[family, case].items()
           if k != "attn_dropout_form"}
    depth = FAMILIES[family]["depth"]
    params = inputs["jax"][family]
    attn_it, path_it = iter(attn_masks), iter(path_masks)
    monkeypatch.setattr(jattn, "make_dropout_mask",
                        lambda rng, rate, b, h, n: jnp.asarray(next(attn_it)))
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape: (
        jnp.asarray(next(path_it)).reshape(shape)))
    model = _jax_model(family, scan=False, **cfg)
    batch = _jax_batch(inputs, family)

    def loss_fn(p):
        logits = model.apply({"params": p}, jnp.asarray(batch["video"]),
                             deterministic=False,
                             rngs={"dropout": jax.random.PRNGKey(2),
                                   "droppath": jax.random.PRNGKey(3)})
        return JL.cross_entropy(logits, jnp.asarray(batch["label"]))

    grads = jax.grad(loss_fn)(jax.tree_util.tree_map(
        jnp.asarray, _unscanned(params, depth)))
    monkeypatch.undo()
    assert next(attn_it, None) is None and next(path_it, None) is None
    tx = JO.create_optimizer(params, lr_schedule=LR, **OPT)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    updates, _ = tx.update(_rescanned(grads, depth), tx.init(jparams),
                           jparams)
    return optax.apply_updates(jparams, updates)


def _recorded_world1_step(inputs, family, case, n_data, monkeypatch):
    """The port's world-1 step of ``case`` over ``n_data`` data shards,
    recording each attention keep mask and stochastic-depth mask it draws
    -> (its result, the JAX feeds: attention masks, path masks)."""
    from simple_tad_tpu_torch.models import internvideo2, layers
    from simple_tad_tpu_torch.ops import attention as attn
    from simple_tad_tpu_torch.ops import flash_attention as fa
    from simple_tad_tpu_torch.parallel.mesh import rank_rows
    cfg = FAMILIES[family]
    b, depth = B // n_data, cfg["depth"]
    attn_drawn, path_drawn = [], []
    draw_mask, draw_seed = attn.make_dropout_mask, attn.draw_dropout_seed
    drop_path = layers.drop_path
    n_tokens = (VIT["all_frames"] // VIT["tubelet_size"]
                * (VIT["img_size"] // VIT["patch_size"]) ** 2)

    def mask(generator, rate, bb, h, n, device=None):
        m = draw_mask(generator, rate, bb, h, n, device)
        attn_drawn.append(m.numpy())
        return m

    def seed(generator, device=None):
        s = draw_seed(generator, device)
        attn_drawn.append(fa.dropout_keep_plain(
            s, b, cfg["num_heads"], n_tokens, ATTN_DROP).numpy())
        return s

    def path(x, rate, training, generator=None, mask=None):
        if training and rate > 0.0:
            mask = torch.rand(x.shape[0], generator=generator,
                              device=x.device) < 1.0 - rate
            path_drawn.append(mask.numpy())
        return drop_path(x, rate, training, generator, mask)

    monkeypatch.setattr(attn, "make_dropout_mask", mask)
    monkeypatch.setattr(attn, "draw_dropout_seed", seed)
    monkeypatch.setattr(layers, "drop_path", path)
    monkeypatch.setattr(internvideo2, "drop_path", path)
    shards = [(rank_rows(B, d, n_data), d) for d in range(n_data)]
    result = _step(inputs, family, case, shards)
    monkeypatch.undo()
    # per shard, in call order: each layer's attention draw; the path
    # draws of every layer with a positive rate (1 to depth - 1), two each
    attn_feed = [np.concatenate([attn_drawn[s * depth + i]
                                 for s in range(n_data)])
                 for i in range(len(attn_drawn) // n_data)]
    per = len(path_drawn) // n_data
    path_feed = [np.ones(B, bool)] * 2 + [
        np.concatenate([path_drawn[s * per + j] for s in range(n_data)])
        for j in range(per)]
    assert per == 2 * (depth - 1)
    return result, attn_feed, path_feed


# --------------------------------------------------------------- the test --

def _leaves_close(got_tree, want_tree, rel, what):
    import jax
    want = dict(jax.tree_util.tree_leaves_with_path(want_tree))
    got = jax.tree_util.tree_leaves_with_path(got_tree)
    assert len(got) == len(want), what
    for p, g in got:
        w = np.asarray(want[p], np.float32)
        np.testing.assert_allclose(
            np.asarray(g), w, rtol=0, atol=rel * float(np.abs(w).max()),
            err_msg=f"{what} {jax.tree_util.keystr(p)}")


def _close(got, want, rel, what):
    for n, w in want.items():
        w = w.detach().numpy()
        np.testing.assert_allclose(got[n].detach().numpy(), w, rtol=0,
                                   atol=rel * float(np.abs(w).max()),
                                   err_msg=f"{what} {n}")


def _launch(work: str) -> None:
    """Write the inputs to ``work``, run the world-4 launch on them and keep
    its results there."""
    from simple_tad_tpu_torch.utils import torch_convert as tc
    rng = np.random.default_rng(0)
    jax_params = {f: _jax_params(f, i) for i, f in enumerate(FAMILIES)}
    batch = {}
    for family, cfg in FAMILIES.items():
        frames = cfg.get("all_frames", cfg.get("num_frames"))
        labels = np.array([1, 0, 1, 1])
        video = rng.standard_normal((B, frames, cfg["img_size"],
                                     cfg["img_size"], 3)).astype(np.float32)
        video += 0.5 * labels[:, None, None, None, None]
        batch[family] = (torch.from_numpy(video), torch.from_numpy(labels))
    inputs = {"batch": batch, "jax": jax_params,
              **{f: tc.from_jax_params(p) for f, p in jax_params.items()}}
    torch.save(inputs, os.path.join(work, "inputs.pt"))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [repo] + os.environ.get("PYTHONPATH", "").split(
                       os.pathsep)))
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        env.pop(var, None)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(WORLD), os.path.abspath(__file__), work]
    proc = subprocess.run(cmd, env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT,
                          timeout=LAUNCH_TIMEOUT_S)
    log = proc.stdout.decode(errors="replace")
    assert proc.returncode == 0, log[-6000:]


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """The world-4 launch, once a pytest run (under pytest-xdist the
    first worker to take the lock launches it, the others read its
    results) -> (inputs, results, dir)."""
    import fcntl
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    work = os.path.join(str(base), "torch_tp_world4")
    os.makedirs(work, exist_ok=True)
    with open(os.path.join(work, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not os.path.exists(os.path.join(work, "results.pt")):
                _launch(work)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    results = torch.load(os.path.join(work, "results.pt"),
                         weights_only=False)
    return inputs, results, work


GRID = [(f, mp) for f in FAMILIES for mp in MPS]
GRID_IDS = [f"{f}-mp{mp}" for f, mp in GRID]


@pytest.mark.parametrize("family,mp", GRID, ids=GRID_IDS)
def test_tp_forward_matches_jax(world4, family, mp):
    import jax.numpy as jnp
    inputs, results, _ = world4
    want = np.asarray(_jax_model(family).apply(
        {"params": jax_tree(inputs["jax"][family])},
        jnp.asarray(inputs["batch"][family][0].numpy())))
    got = results[mp][family, "logits"].numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * np.abs(want).max())


def jax_tree(params):
    import jax
    import jax.numpy as jnp
    return jax.tree_util.tree_map(jnp.asarray, params)


@pytest.mark.parametrize("family,mp", GRID, ids=GRID_IDS)
def test_tp_step_matches_jax_and_world1(world4, family, mp):
    from simple_tad_tpu_torch.parallel.mesh import rank_rows
    from simple_tad_tpu_torch.utils import torch_convert as tc
    inputs, results, _ = world4
    got = results[mp][family, "sgd"]["params"]
    n_data = WORLD // mp
    shards = [(rank_rows(B, d, n_data), d) for d in range(n_data)]
    model = _step(inputs, family, "sgd", shards)[0]
    _close(got, dict(model.named_parameters()), RTOL, "world 1")
    _leaves_close(tc.to_jax_params(got), _jax_step(inputs, family), RTOL,
                  "jax")


DROP_CASES = [("vit", "rng"), ("vit", "mask"), ("iv2", "drop_path")]


@pytest.mark.parametrize("family,case,mp",
                         [(f, c, mp) for f, c in DROP_CASES for mp in MPS],
                         ids=[f"{f}-{c}-mp{mp}" for f, c in DROP_CASES
                              for mp in MPS])
def test_tp_dropout_step_matches_world1_and_jax(world4, family, case, mp,
                                                monkeypatch):
    from simple_tad_tpu_torch.utils import torch_convert as tc
    inputs, results, _ = world4
    got = results[mp][family, case]
    (model, _, loss, _, norm), attn_feed, path_feed = _recorded_world1_step(
        inputs, family, case, WORLD // mp, monkeypatch)
    assert len(attn_feed) == (FAMILIES[family]["depth"]
                              if family == "vit" else 0)
    assert any(not m.all() for m in path_feed)
    _close(got["params"], dict(model.named_parameters()), RTOL, "world 1")
    np.testing.assert_allclose(float(got["loss"]), float(loss), rtol=RTOL)
    want = _jax_fed_step(inputs, family, case, attn_feed, path_feed,
                         monkeypatch)
    _leaves_close(tc.to_jax_params(got["params"]), want, RTOL, "jax")


@pytest.mark.parametrize("family,mp", GRID, ids=GRID_IDS)
def test_tp_adamw_clip_step_matches_world1(world4, family, mp):
    from simple_tad_tpu_torch.parallel.mesh import rank_rows
    inputs, results, _ = world4
    got = results[mp][family, "adamw"]
    n_data = WORLD // mp
    shards = [(rank_rows(B, d, n_data), d) for d in range(n_data)]
    _, _, loss, _, norm = _step(inputs, family, "adamw", shards)
    np.testing.assert_allclose(float(got["loss"]), float(loss), rtol=RTOL)
    np.testing.assert_allclose(float(got["grad_norm"]), float(norm),
                               rtol=RTOL)


def test_tp_zero1_bit_equal_to_stage0(world4):
    _, results, _ = world4
    assert results[2]["zero1_equal"] is True


@pytest.mark.parametrize("mp", MPS)
def test_tp_qk_rmsnorm_sharded_matches_whole_width(world4, mp):
    _, results, _ = world4
    fwd, dx, dw = results[mp]["qk_norm"]
    assert fwd <= 1e-6 and dx <= 1e-5 and dw <= 1e-5, (fwd, dx, dw)


@pytest.mark.parametrize("mp", MPS)
def test_tp_padded_heads_stay_zero(world4, mp):
    _, results, _ = world4
    assert results[mp]["padded_zero"] == [True] * WORLD


def test_tp_checkpoint_reads_at_world1_and_mp4(world4):
    """Written at model-parallel 2 (data 2) after the AdamW step: the
    world-1 model and the model-parallel-4 ranks read it and give the same
    logits; the four ranks of the one replica at model-parallel 4 restore
    one drop-path generator, data rank 0's, as world 1 does, so a drop-path
    step from the loaded state matches world 1's."""
    from simple_tad_tpu_torch.train.steps import TrainState
    from simple_tad_tpu_torch.utils import checkpoint as ckpt
    inputs, results, work = world4
    model = _port("vit", inputs["vit"], **CASES["vit", "adamw"])
    state = TrainState(model, _optimizer(model, "adamw"), torch.Generator())
    _, epoch = ckpt.load_train_state(work, state)
    assert epoch == 1 and state.optimizer.count == 1
    _close(dict(model.named_parameters()),
           results[2]["vit", "adamw"]["params"], 0.0, "checkpoint")
    with torch.no_grad():
        want = model.eval()(inputs["batch"]["vit"][0]).numpy()
    np.testing.assert_allclose(results[4]["ckpt_logits"].numpy(), want,
                               rtol=0, atol=RTOL * np.abs(want).max())
    gens = results[4]["ckpt_generators"]
    assert len(gens) == WORLD
    for g in gens:
        assert torch.equal(g, state.generator.get_state())
    want = _resumed_step(inputs, state)
    _close(results[4]["ckpt_step"], want, RTOL, "resumed step")


def test_parallel_check_passes_at_model_parallel_2(world4):
    """parallel/check.py --model_parallel 2 on the launch's 4 ranks (it
    exits non-zero on a failed check, which fails the launch)."""
    _, results, _ = world4
    assert results["check"] is True


# ------------------------------------------------------- in one process --

def test_param_specs_mirror_the_jax_specs():
    """tests/test_tp.py::test_param_specs on the port's names: qkv and fc1
    column-parallel, proj and fc2 row-parallel, fc2's bias, the norms, the
    patch embedding and the head replicated; and what goes with the heads
    (q_bias, v_bias, IV2's q/k-norm weights) cut by head."""
    from simple_tad_tpu_torch.models.internvideo2 import (IV2Config,
                                                          InternVideo2)
    from simple_tad_tpu_torch.models.vit import ViTConfig, VisionTransformer
    from simple_tad_tpu_torch.parallel.tp import ParamSpec, vit_param_specs
    vit = vit_param_specs(VisionTransformer(ViTConfig(**VIT),
                                            device="meta"))
    iv2 = vit_param_specs(InternVideo2(IV2Config(**IV2), device="meta"))
    col, row = ParamSpec("column", 0), ParamSpec("row", 1)
    heads = ParamSpec("column", 0, True)
    for specs in (vit, iv2):
        assert specs["blocks.1.attn.qkv.weight"] == ParamSpec("column", 0,
                                                             True, 3)
        assert specs["blocks.0.attn.proj.weight"] == ParamSpec("row", 1,
                                                              True)
        assert specs["blocks.0.mlp.fc1.weight"] == col
        assert specs["blocks.0.mlp.fc1.bias"] == col
        assert specs["blocks.0.mlp.fc2.weight"] == row
        for name in ("blocks.0.mlp.fc2.bias", "blocks.0.attn.proj.bias",
                     "blocks.0.norm1.weight", "patch_embed.proj.weight",
                     "head.weight"):
            assert specs[name].split == "replicated", name
    assert vit["blocks.0.attn.q_bias"] == vit["blocks.0.attn.v_bias"] == heads
    assert vit["blocks.0.gamma_1"].split == "replicated"
    assert iv2["blocks.0.attn.q_norm.weight"] == heads
    assert iv2["blocks.0.ls1.gamma"].split == "replicated"
    assert iv2["clip_projector.cross_attn.q.weight"].split == "replicated"


@pytest.mark.parametrize("family,mp", GRID, ids=GRID_IDS)
def test_shard_merge_round_trip(family, mp):
    """shard_state_dict then merge_state_dicts gives the whole state back;
    each rank's share has its own model's shapes; the padded heads (IV2's
    3 over 2 or 4 ranks: 4) are zero."""
    from simple_tad_tpu_torch.models.internvideo2 import (IV2Config,
                                                          InternVideo2)
    from simple_tad_tpu_torch.models.vit import ViTConfig, VisionTransformer
    from simple_tad_tpu_torch.parallel.tp import (ModelParallel,
                                                  merge_state_dicts,
                                                  shard_state_dict)
    cfg = FAMILIES[family]
    build = ((lambda tp: VisionTransformer(ViTConfig(**VIT), device="cpu",
                                           tp=tp))
             if family == "vit" else
             (lambda tp: InternVideo2(IV2Config(**IV2), device="cpu",
                                      tp=tp)))
    whole = build(None).init_weights(torch.Generator().manual_seed(0))
    state = whole.state_dict()
    shares = [shard_state_dict(state, cfg["num_heads"], mp, r)
              for r in range(mp)]
    for r, share in enumerate(shares):
        local = build(ModelParallel(mp, r)).state_dict()
        assert {n: t.shape for n, t in share.items()} == \
            {n: t.shape for n, t in local.items()}
    back = merge_state_dicts(shares, cfg["num_heads"])
    assert all(torch.equal(back[n], t) for n, t in state.items())
    if family == "iv2":
        # 3 heads padded to 4: the last rank holds head 3, the padding
        last = shares[-1]["blocks.0.attn.qkv.weight"].view(3, 4 // mp, 32,
                                                           96)
        assert (last[:, -1] == 0).all()
        assert mp == 4 or (last[:, 0] != 0).all(dim=(1, 2)).all()


def test_iv2_6b_meta_shard_at_mp4():
    """IV2-6B (25 heads of 128, 48 blocks, width 3200) at model-parallel
    4 on the meta device, no weights on the host: 28 heads, 7 a rank; each
    rank's qkv 3 x 7 x 128 rows, proj 896 input columns, fc1 3200 rows,
    fc2 3200 columns, and the whole model's shares slice to those shapes;
    a quarter of the block parameters a rank and the padded heads' share
    (the attention at 28 / 25 of its width)."""
    from simple_tad_tpu_torch.models import create_model
    from simple_tad_tpu_torch.parallel.tp import (ModelParallel,
                                                  shard_state_dict)
    whole = create_model("internvideo2_6B_patch14_224", device="meta")
    assert (whole.cfg.embed_dim, whole.cfg.depth, whole.cfg.num_heads) == \
        (3200, 48, 25)
    n_whole = sum(p.numel() for n, p in whole.named_parameters()
                  if n.startswith("blocks."))
    assert n_whole > 5.8e9
    state = whole.state_dict()
    for r in range(4):
        mine = create_model("internvideo2_6B_patch14_224", device="meta",
                            tp=ModelParallel(4, r))
        attn = mine.blocks[47].attn
        assert attn.local_heads == 7 and attn.width == 896
        assert mine.blocks[0].attn.qkv.weight.shape == (3 * 896, 3200)
        assert mine.blocks[0].attn.proj.weight.shape == (3200, 896)
        assert mine.blocks[0].attn.proj.bias.shape == (3200,)
        assert mine.blocks[0].attn.q_norm.weight.shape == (896,)
        assert mine.blocks[0].mlp.fc1.weight.shape == (3200, 3200)
        assert mine.blocks[0].mlp.fc2.weight.shape == (3200, 3200)
        share = shard_state_dict(
            {n: t for n, t in state.items() if n.startswith("blocks.47.")},
            25, 4, r)
        local = mine.state_dict()
        assert all(t.shape == local[n].shape for n, t in share.items())
        n_mine = sum(p.numel() for n, p in mine.named_parameters()
                     if n.startswith("blocks."))
        assert 0.25 < n_mine / n_whole < 0.27     # the padding: 28 / 25


def test_qk_rmsnorm_at_one_rank_is_the_whole_width_rmsnorm():
    """QKRMSNorm at a model group of 1 against models/internvideo2.py:
    rmsnorm_plain under autograd (forward, input and weight gradients),
    and its plain version qk_rmsnorm_plain at the full width."""
    from simple_tad_tpu_torch.models.internvideo2 import rmsnorm_plain
    from simple_tad_tpu_torch.parallel.tp import (ModelParallel, qk_rmsnorm,
                                                  qk_rmsnorm_plain)
    rng = np.random.default_rng(3)
    x, dy = (torch.from_numpy(rng.standard_normal((2, 7, 64)).astype(
        np.float32)) for _ in range(2))
    w = torch.from_numpy(1 + 0.1 * rng.standard_normal(64).astype(
        np.float32))
    grads = []
    for fn in (lambda a, b: rmsnorm_plain(a, b, 1e-6, torch.float32),
               lambda a, b: qk_rmsnorm(a, b, 1e-6, torch.float32, 64,
                                       ModelParallel(1, 0))):
        a, b = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        y = fn(a, b)
        y.backward(dy)
        grads.append((y.detach(), a.grad, b.grad))
    for got, want in zip(*grads[::-1]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(qk_rmsnorm_plain(x, w, 1e-6, torch.float32,
                                                64), grads[0][0])


def test_philox_keep_at_a_head_offset_is_the_whole_masks_slice():
    """dropout_keep_plain at (head_offset, total_heads) is the slice of the
    whole model's keep mask; the defaults are the whole mask; the dropout
    forward's plain version at an offset equals the whole one's slice."""
    from simple_tad_tpu_torch.ops import flash_attention as fa
    seed = torch.tensor([1234, -5678], dtype=torch.int32)
    whole = fa.dropout_keep_plain(seed, 2, 6, 37, 0.3)
    assert torch.equal(fa.dropout_keep_plain(seed, 2, 6, 37, 0.3, 0, 6),
                       whole)
    for h0, hl in ((0, 2), (2, 2), (4, 2), (3, 3), (5, 1)):
        got = fa.dropout_keep_plain(seed, 2, hl, 37, 0.3, h0, 6)
        assert torch.equal(got, whole[:, h0:h0 + hl]), (h0, hl)
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 37, 6 * 16)).astype(
        np.float32)) for _ in range(3))
    out, lse = fa.flash_attention_drop_fwd_plain(q, k, v, 6, 0.25, 0.3,
                                                 seed=seed)
    cols = slice(2 * 16, 5 * 16)
    got, glse = fa.flash_attention_drop_fwd_plain(
        q[..., cols], k[..., cols], v[..., cols], 3, 0.25, 0.3, seed=seed,
        head_offset=2, total_heads=6)
    torch.testing.assert_close(got, out[..., cols])
    torch.testing.assert_close(glse, lse[:, 2:5])


@pytest.mark.parametrize("form", ["rng", "mask"])
def test_dropout_dispatch_at_a_head_offset(form):
    """The dispatch at a rank's heads draws the whole model's keep source
    (the generator ends where the whole call leaves it) and computes the
    whole call's output columns of those heads; heads past the model's
    count (padding) keep everything."""
    from simple_tad_tpu_torch.ops import attention as attn
    rng = np.random.default_rng(1)
    H, D, N = 4, 16, 21
    qkv = torch.from_numpy(rng.standard_normal((2, N, 3 * H * D)).astype(
        np.float32))
    g_whole, g_rank = (torch.Generator().manual_seed(9) for _ in range(2))
    whole = attn.dot_product_attention_qkv(
        qkv, num_heads=H, scale=D ** -0.5, dropout_rate=0.3,
        generator=g_whole, dropout_form=form)
    cols = [torch.arange(c * H * D + 1 * D, c * H * D + 3 * D)
            for c in range(3)]
    got = attn.dot_product_attention_qkv(
        qkv[..., torch.cat(cols)], num_heads=2, scale=D ** -0.5,
        dropout_rate=0.3, generator=g_rank, dropout_form=form,
        head_offset=1, total_heads=H)
    assert torch.equal(g_whole.get_state(), g_rank.get_state())
    torch.testing.assert_close(got, whole[..., 1 * D:3 * D])
    if form == "mask":
        mask = attn._rank_mask(torch.Generator().manual_seed(9), 0.3, 2, N,
                               2, 3, H, "cpu")
        assert mask.shape == (2, 2, N, N) and (mask[:, 1] == 1).all()


def test_tensor_parallel_refusals():
    """No fallback: the int8 model, a split that would pad more heads than
    there are, an MLP width the group does not divide, the per-leaf-norm
    optimizers, the MAE family, a seeded init of a share and per-head
    gradient norms raise."""
    from simple_tad_tpu_torch.models import create_model
    from simple_tad_tpu_torch.models.vit import ViTConfig, VisionTransformer
    from simple_tad_tpu_torch.parallel.tp import (ModelParallel, local_hidden,
                                                  padded_heads)
    from simple_tad_tpu_torch.train.optim import FinetuneOptimizer
    from simple_tad_tpu_torch.train.steps import (TrainState,
                                                  make_finetune_train_step)
    tp = ModelParallel(2, 0)
    with pytest.raises(ValueError, match="int8"):
        VisionTransformer(ViTConfig(**VIT, quant=True), device="meta", tp=tp)
    assert padded_heads(25, 4) == 28 and padded_heads(3, 4) == 4
    with pytest.raises(ValueError, match="do not split"):
        padded_heads(1, 4)
    with pytest.raises(ValueError, match="does not split"):
        local_hidden(100, 3)
    model = VisionTransformer(ViTConfig(**VIT, param_dtype=torch.float32),
                              device="cpu", tp=tp)
    for opt in ("lamb", "novograd", "adafactor"):
        with pytest.raises(ValueError, match="tensor parallelism"):
            FinetuneOptimizer(dict(model.named_parameters()),
                              lr_schedule=1e-3, opt=opt, model_parallel=tp)
    with pytest.raises(ValueError, match="init_sharded"):
        model.init_weights(torch.Generator())
    with pytest.raises(ValueError, match="ViT and InternVideo2"):
        create_model("pretrain_videomae_small_patch16_224", device="meta",
                     tp=tp)
    # refused before the forward: the empty batch is never read
    step = make_finetune_train_step(None, grad_norm_heads=VIT["num_heads"])
    opt = FinetuneOptimizer(dict(model.named_parameters()), lr_schedule=1e-3,
                            model_parallel=tp)
    with pytest.raises(ValueError, match="grad_norm_heads"):
        step(TrainState(model, opt, torch.Generator()), {})


def test_seeded_share_is_the_whole_models_slice():
    """create_model(tp=..., generator=...) fills each rank's share block by
    block from the whole model's draws: the shares merge to the model
    create_model seeds whole."""
    from simple_tad_tpu_torch.models import create_model
    from simple_tad_tpu_torch.parallel.tp import (ModelParallel,
                                                  merge_state_dicts)
    kw = dict(img_size=28, num_frames=2, embed_dim=96, depth=2, num_heads=3,
              attn_pool_num_heads=3, clip_embed_dim=32)
    name = "internvideo2_small_patch14_224"
    whole = create_model(name, device="cpu",
                         generator=torch.Generator().manual_seed(4), **kw)
    shares = [create_model(name, device="cpu", tp=ModelParallel(2, r),
                           generator=torch.Generator().manual_seed(4),
                           **kw).state_dict() for r in range(2)]
    back = merge_state_dicts(shares, 3)
    assert all(torch.equal(back[n], t) for n, t in whole.state_dict().items())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_tp_operators_without_a_model_group_are_the_whole_models(dtype):
    """Without ``tp``, f is its input and the row-parallel Linear is the
    Linear rounded to the compute dtype, bit for bit: the whole model runs
    the ops it ran before tensor parallelism; the Linear without its bias
    is the product alone."""
    import torch.nn.functional as F
    from simple_tad_tpu_torch.models.layers import Linear
    from simple_tad_tpu_torch.parallel.tp import (copy_to_model,
                                                  row_parallel_linear)
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, 5, 16), generator=g)
    assert copy_to_model(x, None) is x
    lin = Linear(16, 8, dtype=dtype, param_dtype=torch.float32)
    lin.init_weights(g)
    with torch.no_grad():
        lin.bias.copy_(torch.randn(8, generator=g))
    w = lin.weight.to(dtype)
    assert torch.equal(row_parallel_linear(x, lin, None, dtype),
                       F.linear(x.to(dtype), w, lin.bias.to(dtype)))
    assert torch.equal(lin(x, bias=False), F.linear(x.to(dtype), w))


if __name__ == "__main__":
    _worker(sys.argv[1])
