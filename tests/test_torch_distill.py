"""The port's InternVideo2 distillation (simple_tad_tpu_torch.models.
internvideo2's ``return_taps`` / ``features_only``, models/iv2_distill.py,
train/distill.py, the distill tree of utils/torch_convert.py) against the
JAX package on the CPU, on tiny fp32 trunks: a student 128 wide, 3 deep,
2 heads, and a teacher 192 wide, 4 deep, 3 heads (head dim 64 both), on 2
frames of 28 x 28 (8 patches and the CLS token), both sides from the same
weights (from_jax_params), the JAX side through its plain attention
(attn_impl 'xla'; the port's attention and its kernels are held to the
Pallas kernels by tests/test_torch_iv2_train_attention.py and
tests/test_torch_iv2_ops.py).  Stochastic depth is off (drop path
0): the two frameworks' random bits cannot match.  The attention mask's
Gumbel noise is JAX's draw, fed to the port.

Tolerances: the teacher's taps, pooled feature and attention and the
student's decoded taps and final feature (l2-normalized, fp32) within
2e-5 absolute; the masks equal; losses 1e-5 relative; every gradient leaf
1e-4 of its largest magnitude, parameters and Adam moments after each
step 1e-5 (tests/test_torch_iv2_train.py's bounds, with its handling of
the pooling head's key biases, whose gradient is zero in exact
arithmetic); the parameter round trip exact.  The steps run at the IV2-S
distillation job's lr 1e-3 scaled to this batch over 256, as the CLI
scales it, with the reference recipe's AdamW (betas 0.9 / 0.98, eps 1e-6,
weight decay 0.05): Adam's first steps divide each gradient by its own
magnitude plus eps, so at eps 1e-8 an element whose gradient is ~1e-8
turns fp32 summation noise into a visible part of the lr.
"""

import functools

import numpy as np
import pytest
import torch

import flax.linen as jnn
import jax
import jax.numpy as jnp

from simple_tad_tpu.cli import distill as jax_distill
from simple_tad_tpu.models.internvideo2 import IV2Config as JaxIV2Config
from simple_tad_tpu.models.internvideo2 import InternVideo2 as JaxIV2
from simple_tad_tpu.models.iv2_distill import \
    DistillInternVideo2 as JaxDistill
from simple_tad_tpu.models.iv2_distill import \
    DistillIV2Config as JaxDistillConfig
from simple_tad_tpu.models.mae import mask_partition as jax_mask_partition
from simple_tad_tpu.train import losses as JL
from simple_tad_tpu.train import optim as JO
from simple_tad_tpu.train.steps import TrainState as JaxTrainState
from simple_tad_tpu.utils import torch_convert as jax_tc
from simple_tad_tpu_torch.models.internvideo2 import IV2Config, InternVideo2
from simple_tad_tpu_torch.models.iv2_distill import (DistillInternVideo2,
                                                     DistillIV2Config)
from simple_tad_tpu_torch.models.mae import mask_partition
from simple_tad_tpu_torch.train import distill as D
from simple_tad_tpu_torch.train import optim as O
from simple_tad_tpu_torch.train.steps import TrainState
from simple_tad_tpu_torch.utils import torch_convert as tc
from tests.test_distill_recipe import _add_decoder_sd
from tests.test_internvideo2 import make_iv2_sd
from tests.test_torch_iv2_train import _tree_close
from tests.test_torch_train_optim import _assert_trees_equal
from tests.test_torch_train_step import _adam_moments
from tests.test_torch_vit import (  # noqa: F401
    drop_checkpoints, one_torch_thread)

COMMON = dict(img_size=28, patch_size=14, mlp_ratio=4.0, num_frames=2,
              attn_pool_num_heads=2)
TEACHER = dict(COMMON, embed_dim=192, depth=4, num_heads=3,
               clip_embed_dim=32, init_scale=1.0, num_classes=2)
STUDENT = dict(COMMON, embed_dim=128, depth=3, num_heads=2,
               clip_embed_dim=32, clip_teacher_embed_dim=192,
               clip_teacher_final_dim=32, clip_return_layer=2,
               drop_path_rate=0.0)
B, N_PATCH, NUM_MASKED = 4, 8, 5
TAPS = (3, 1)                   # teacher taps, unsorted on purpose
LR = dict(base=1e-3 * B / 256, final=1e-6 * B / 256, steps=4)


def _moved(params, seed):
    """Every leaf moved by seeded noise (norms and LayerScale gammas by
    0.1, so the trunk moves the features)."""
    rng = np.random.default_rng(seed)

    def move(path, leaf):
        a = np.asarray(leaf, np.float32)
        name = jax.tree_util.keystr(path)
        big = "scale" in name or "gamma" in name
        return a + (0.1 if big else 0.02) * rng.standard_normal(
            a.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(move, params)


def _jax_teacher(**cfg):
    return JaxIV2(JaxIV2Config(**{**TEACHER, "drop_path_rate": 0.0,
                                  "attn_impl": "xla", **cfg}))


def _jax_student(**cfg):
    return JaxDistill(JaxDistillConfig(**{**STUDENT, "attn_impl": "xla",
                                          **cfg}))


@functools.lru_cache(maxsize=None)
def _teacher_tree(seed, items):
    x = jnp.zeros((1, 2, 28, 28, 3))
    model = _jax_teacher(**dict(items))
    return _moved(jax.jit(model.init)(jax.random.PRNGKey(seed), x)["params"],
                  seed)


@functools.lru_cache(maxsize=None)
def _student_tree(seed, items):
    model = _jax_student(**dict(items))
    mask = np.zeros((1, N_PATCH + 1), bool)
    mask[:, 1:NUM_MASKED + 1] = True
    init = jax.jit(lambda key: model.init(
        key, jnp.zeros((1, 2, 28, 28, 3)), jnp.asarray(mask), NUM_MASKED,
        deterministic=True))
    return _moved(init(jax.random.PRNGKey(seed))["params"], seed)


def _teacher_params(seed=0, **cfg):
    """JAX teacher params (cached; read only)."""
    return _teacher_tree(seed, tuple(sorted(cfg.items())))


def _student_params(seed=1, **cfg):
    """JAX student params (cached; read only)."""
    return _student_tree(seed, tuple(sorted(cfg.items())))


def _port_teacher(params, **cfg):
    model = InternVideo2(IV2Config(**{**TEACHER, "drop_path_rate": 0.0,
                                      **cfg}), device="cpu")
    model.load_state_dict(tc.from_jax_params(params), strict=True)
    return model.eval()


def _port_student(params, **cfg):
    model = DistillInternVideo2(DistillIV2Config(
        **{**STUDENT, "param_dtype": torch.float32, **cfg}), device="cpu")
    model.load_state_dict(tc.from_jax_params(params), strict=True)
    return model


def _video(seed=2, n=B):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 2, 28, 28, 3)).astype(np.float32)


def _tube_masks(seed=3, n=B):
    """(n, N) bool, NUM_MASKED True a row (the loader's masks)."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((n, N_PATCH), bool)
    for b in range(n):
        mask[b, rng.permutation(N_PATCH)[:NUM_MASKED]] = True
    return mask


def _tj(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _student_apply(model, params, video, mask):
    """The JAX student's eval forward (jitted)."""
    return jax.jit(lambda p, x, m: model.apply(
        {"params": p}, x, m, NUM_MASKED, deterministic=True))(
            _tj(params), jnp.asarray(video), jnp.asarray(mask))


def test_return_taps_and_features_only_match_jax():
    params = _teacher_params()
    video = _video()
    jm = _jax_teacher()
    z, fin, attn = jax.jit(lambda p, x: jm.apply(
        {"params": p}, x, deterministic=True, return_taps=TAPS))(
            _tj(params), jnp.asarray(video))
    feats = jax.jit(lambda p, x: jm.apply(
        {"params": p}, x, deterministic=True, features_only=True))(
            _tj(params), jnp.asarray(video))
    model = _port_teacher(params)
    with torch.no_grad():
        got = model(torch.from_numpy(video), return_taps=TAPS)
        got_feats = model(torch.from_numpy(video), features_only=True)
    assert got[0].shape == (2, B, N_PATCH + 1, 192)
    assert got[0].dtype == got[1].dtype == got[2].dtype == torch.float32
    for g, w in zip(got, (z, fin, attn)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=2e-5)
    # the final feature takes no fc_norm, features_only does
    assert not np.allclose(got_feats.numpy(), got[1].numpy(), atol=1e-2)
    np.testing.assert_allclose(got_feats.numpy(), np.asarray(feats),
                               rtol=0, atol=2e-5)


@pytest.mark.parametrize("decoder", ["mlp", "linear"])
def test_student_on_jax_tree_matches_jax(decoder):
    params = _student_params(clip_student_decoder=decoder)
    mask = np.concatenate([np.zeros((B, 1), bool), _tube_masks()], 1)
    video = _video()
    mid, fin = _student_apply(_jax_student(clip_student_decoder=decoder),
                              params, video, mask)
    model = _port_student(params, clip_student_decoder=decoder).eval()
    assert model.cfg.return_index == (1, 2)
    with torch.no_grad():
        got_mid, got_fin = model(torch.from_numpy(video),
                                 torch.from_numpy(mask), NUM_MASKED)
    assert got_mid.shape == (2, B, N_PATCH + 1 - NUM_MASKED, 192)
    np.testing.assert_allclose(got_mid.numpy(), np.asarray(mid), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(got_fin.numpy(), np.asarray(fin), rtol=0,
                               atol=2e-5)


def test_student_taps_ascending_for_unsorted_return_index():
    cfg = dict(clip_return_index=(2, 0))
    params = _student_params(**cfg)
    mask = np.concatenate([np.zeros((B, 1), bool), _tube_masks()], 1)
    video = _video()
    mid, _ = _student_apply(_jax_student(**cfg), params, video, mask)
    model = _port_student(params, **cfg).eval()
    assert model.cfg.return_index == (0, 2)
    with torch.no_grad():
        got, _ = model(torch.from_numpy(video), torch.from_numpy(mask),
                       NUM_MASKED)
    np.testing.assert_allclose(got.numpy(), np.asarray(mid), rtol=0,
                               atol=2e-5)


def test_to_jax_params_inverts_from_jax_params():
    for decoder in ("mlp", "linear"):
        params = jax.tree_util.tree_map(np.asarray, _student_params(
            clip_student_decoder=decoder))
        back = tc.to_jax_params(tc.from_jax_params(params))
        assert (jax.tree_util.tree_structure(back)
                == jax.tree_util.tree_structure(params))
        _assert_trees_equal(back, params)


def test_student_pth_loader_matches_jax(tmp_path):
    """A reference DistInternVideo2 state dict (seeded, the reference's key
    names) through the port's .pth loader and through the JAX package's
    torch_to_distill_iv2_params: the same outputs."""
    g = torch.Generator().manual_seed(3)
    sd = make_iv2_sd(0, 128, 3, 2, 32, frames=2, grid=2)
    del sd["fc_norm.weight"], sd["fc_norm.bias"]
    del sd["head.weight"], sd["head.bias"]
    sd["clip_pos_embed"] = torch.randn(1, N_PATCH + 1, 128,
                                       generator=g) * 0.05
    for k in range(2):
        _add_decoder_sd(sd, g, f"clip_decoder.{k}.", 128, 192)
    _add_decoder_sd(sd, g, "final_clip_decoder.", 32, 32)
    path = str(tmp_path / "student.pth")
    torch.save({"model": sd}, path)
    model = DistillInternVideo2(DistillIV2Config(**STUDENT), device="cpu")
    assert set(tc.load_checkpoint_auto(path, model)) == set(
        model.state_dict())
    params = jax_tc.torch_to_distill_iv2_params(
        {k: v.numpy() for k, v in sd.items()}, depth=3, clip_return_layer=2)
    mask = np.concatenate([np.zeros((B, 1), bool), _tube_masks(4)], 1)
    video = _video(5)
    mid, fin = _student_apply(_jax_student(), params, video, mask)
    with torch.no_grad():
        got_mid, got_fin = model(torch.from_numpy(video),
                                 torch.from_numpy(mask), NUM_MASKED)
    np.testing.assert_allclose(got_mid.numpy(), np.asarray(mid), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(got_fin.numpy(), np.asarray(fin), rtol=0,
                               atol=2e-5)
    del sd["blocks.2.attn.qkv.weight"]
    torch.save({"model": sd}, path)
    with pytest.raises(KeyError, match="blocks.2.attn.qkv.weight"):
        tc.load_checkpoint_auto(path, model)


@pytest.mark.parametrize("ties", [False, True])
def test_attention_mask_matches_jax(ties):
    """The threshold form on JAX's Gumbel draw, mask for mask; with ties
    (equal importances and zero noise) both mask only what lies strictly
    below the threshold."""
    rng = np.random.default_rng(6)
    n, N, num_masked = 64, 32, 24
    attn = rng.random((n, N)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    gumbel = np.asarray(jax.random.gumbel(key, (n, N), jnp.float32))
    if ties:
        attn = np.round(attn * 3).astype(np.float32) / 3
        gumbel = np.zeros_like(gumbel)
        # the JAX function draws its own noise: its threshold form on zero
        # noise, restated in numpy
        keys = np.log(np.maximum(attn, 1e-20))
        thresh = np.sort(keys, 1)[:, num_masked][:, None]
        want = np.concatenate([np.zeros((n, 1), bool), keys < thresh], 1)
    else:
        want = np.asarray(jax_distill.attention_mask_from_importance(
            jnp.asarray(attn), num_masked, key))
    got = D.attention_mask_from_importance(
        torch.from_numpy(attn), num_masked, torch.from_numpy(gumbel.copy()))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[:, 0].any()
    if ties:
        assert (got.sum(1) < num_masked).any()
    else:
        assert (got.sum(1) == num_masked).all()


def test_mask_partition_matches_jax_on_cls_masks():
    mask = np.concatenate([np.zeros((B, 1), bool), _tube_masks(8)], 1)
    want = [np.asarray(a) for a in jax_mask_partition(jnp.asarray(mask),
                                                       NUM_MASKED)]
    got = mask_partition(torch.from_numpy(mask), NUM_MASKED)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def _optimizers(params, model):
    """AdamW of the reference's stage-2 recipe (S14_dist_1B_stage2.sh:
    betas 0.9 / 0.98, eps 1e-6, weight decay 0.05) on both sides."""
    lr = JO.cosine_scheduler(LR["base"], LR["final"], 1, LR["steps"])
    kw = dict(weight_decay=0.05, betas=(0.9, 0.98), eps=1e-6)
    tx = JO.create_optimizer(params, lr_schedule=JO.array_schedule(lr), **kw)
    opt = O.FinetuneOptimizer(dict(model.named_parameters()),
                              lr_schedule=O.array_schedule(lr), **kw)
    return tx, opt


def _grads(model):
    """{name: gradient}, zeros where the loss does not reach a parameter
    (the classifier under ``features_only``; JAX's gradient there is 0)."""
    return {n: torch.zeros_like(p) if p.grad is None else p.grad
            for n, p in model.named_parameters()}


@functools.partial(jax.jit, static_argnums=(5,))
def _jax_masked_grads(s_params, t_params, video, mask_u, key, mask_type):
    """The JAX step's loss and gradients (make_masked_distill_step's
    loss_fn on the step's own key split)."""
    student, teacher = _jax_student(), _jax_teacher()
    _, d1, d2, mkey = jax.random.split(key, 4)
    t_mid, t_fin, t_attn = teacher.apply({"params": t_params}, video,
                                         deterministic=True,
                                         return_taps=TAPS)
    if mask_type == "attention":
        mask = jax_distill.attention_mask_from_importance(t_attn, NUM_MASKED,
                                                          mkey)
    else:
        mask = jnp.concatenate([jnp.zeros((B, 1), bool), mask_u], 1)
    vis, _ = jax_mask_partition(mask, NUM_MASKED)
    tgt = jnp.take_along_axis(t_mid, vis[None, :, :, None], axis=2)

    def loss_fn(p):
        s_mid, s_fin = student.apply({"params": p}, video, mask, NUM_MASKED,
                                     deterministic=False,
                                     rngs={"dropout": d1, "droppath": d2})
        l_mid = jnp.mean(2.0 - 2.0 * jnp.sum(s_mid * tgt, -1))
        l_fin = jnp.mean(2.0 - 2.0 * jnp.sum(s_fin * t_fin, -1))
        return l_mid + l_fin

    return jax.value_and_grad(loss_fn)(s_params), mkey


@pytest.mark.parametrize("mask_type", ["tube", "attention"])
def test_masked_feature_steps_match_jax(mask_type):
    t_params, s_params = _tj(_teacher_params()), _student_params()
    model = _port_student(s_params)
    teacher = _port_teacher(t_params)
    tx, opt = _optimizers(s_params, model)
    jstep = jax_distill.make_masked_distill_step(
        _jax_student(), _jax_teacher(), tx, num_masked=NUM_MASKED,
        teacher_taps=TAPS, loss_ratio=(1.0, 1.0), mask_type=mask_type)
    jstate = JaxTrainState.create(_tj(s_params), tx, jax.random.PRNGKey(1))
    step = D.make_masked_distill_step(teacher, num_masked=NUM_MASKED,
                                      teacher_taps=TAPS, mask_type=mask_type)
    state = TrainState.create(model, opt, torch.Generator())
    for i in range(2):
        video, mask = _video(10 + i), _tube_masks(20 + i)
        (want_loss, want_grads), mkey = _jax_masked_grads(
            jstate.params, t_params, jnp.asarray(video), jnp.asarray(mask),
            jstate.rng, mask_type)
        batch = {"video": torch.from_numpy(video),
                 "mask": torch.from_numpy(mask)}
        if mask_type == "attention":
            batch["gumbel"] = torch.from_numpy(np.array(jax.random.gumbel(
                mkey, (B, N_PATCH), jnp.float32)))
        jstate, (jm, _) = jstep(jstate, {"video": jnp.asarray(video),
                                         "mask": jnp.asarray(mask)},
                                t_params)
        m = step(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["loss"]), float(want_loss),
                                   rtol=1e-5)
        for k in ("loss_clip_middle", "loss_clip_final", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=k)
        _tree_close(tc.to_jax_params(_grads(model)), want_grads, 1e-4,
                    f"grad at step {i + 1}")
        _tree_close(tc.to_jax_params(model.state_dict()), jstate.params,
                    1e-5, f"params after step {i + 1}")
    assert state.step == 2 and opt.count == 2
    mu, nu = _adam_moments(jstate.opt_state)
    _tree_close(tc.to_jax_params(opt.mu), mu, 1e-5, "mu")
    _tree_close(tc.to_jax_params(opt.nu), nu, 1e-5, "nu")


def test_feature_step_with_aligner_matches_jax():
    """The feature objective: a student of clip width 32 against a teacher
    of 48, so the Linear aligner is in the trainable tree."""
    t_params = _tj(_teacher_params(clip_embed_dim=48))
    s_tree = _teacher_params(seed=1)        # an IV2 student, clip width 32
    student_j, teacher_j = _jax_teacher(), _jax_teacher(clip_embed_dim=48)
    aligner_j = jnn.Dense(48, dtype=jnp.float32)
    al = jax.tree_util.tree_map(np.asarray, aligner_j.init(
        jax.random.PRNGKey(4), jnp.zeros((1, 32)))["params"])
    params = {"student": s_tree, "aligner": al}

    student = InternVideo2(IV2Config(**{**TEACHER, "drop_path_rate": 0.0,
                                        "param_dtype": torch.float32}),
                           device="cpu")
    student.load_state_dict(tc.from_jax_params(s_tree), strict=True)
    model = D.FeatureStudent(student, 32, 48)
    with torch.no_grad():
        model.aligner.weight.copy_(torch.from_numpy(al["kernel"].T.copy()))
        model.aligner.bias.copy_(torch.from_numpy(al["bias"]))
    teacher = _port_teacher(t_params, clip_embed_dim=48)
    tx, opt = _optimizers(params, model)
    jstep = jax_distill.make_feature_distill_step(student_j, teacher_j,
                                                  aligner_j, tx)
    jstate = JaxTrainState.create(_tj(params), tx, jax.random.PRNGKey(1))
    video = _video(30)

    def l2n(x):
        return x / jnp.maximum(jnp.linalg.norm(x, axis=-1, keepdims=True),
                               1e-6)

    t_feat = l2n(teacher_j.apply({"params": t_params}, jnp.asarray(video),
                                 features_only=True))

    def loss_fn(p):
        s = student_j.apply({"params": p["student"]}, jnp.asarray(video),
                            deterministic=False, features_only=True,
                            rngs={"dropout": jax.random.PRNGKey(0),
                                  "droppath": jax.random.PRNGKey(0)})
        s = l2n(aligner_j.apply({"params": p["aligner"]}, s))
        return jnp.mean(2.0 - 2.0 * jnp.sum(s * t_feat, -1))

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(
        jstate.params)
    jstate, (jm, _) = jstep(jstate, {"video": jnp.asarray(video)}, t_params)
    state = TrainState.create(model, opt, torch.Generator())
    m = D.make_feature_distill_step(teacher)(state,
                                             {"video": torch.from_numpy(video)})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["loss"]), float(want_loss), rtol=1e-5)

    def tree(named):
        s = {n[len("student."):]: v for n, v in named.items()
             if n.startswith("student.")}
        return {"student": tc.to_jax_params(s),
                "aligner": {"kernel": named["aligner.weight"].detach().numpy().T,
                            "bias": named["aligner.bias"].detach().numpy()}}

    for got, want, rel, what in (
            (tree(_grads(model)), want_grads, 1e-4, "grad"),
            (tree(dict(model.named_parameters())), jstate.params, 1e-5,
             "params"),
            (tree(opt.mu), _adam_moments(jstate.opt_state)[0], 1e-5, "mu"),
            (tree(opt.nu), _adam_moments(jstate.opt_state)[1], 1e-5, "nu")):
        _tree_close(got["student"], want["student"], rel, what)
        for k in ("kernel", "bias"):
            w = np.asarray(want["aligner"][k])
            np.testing.assert_allclose(got["aligner"][k], w, rtol=0,
                                       atol=rel * np.abs(w).max(),
                                       err_msg=f"{what} aligner {k}")


def test_logit_kd_step_matches_jax():
    t_params = _tj(_teacher_params())
    s_params = _teacher_params(seed=1)
    student_j, teacher_j = _jax_teacher(), _jax_teacher()
    student = InternVideo2(IV2Config(**{**TEACHER, "drop_path_rate": 0.0,
                                        "param_dtype": torch.float32}),
                           device="cpu")
    student.load_state_dict(tc.from_jax_params(s_params), strict=True)
    teacher = _port_teacher(t_params)
    tx, opt = _optimizers(s_params, student)
    jstep = jax_distill.make_distill_step(student_j, teacher_j, tx,
                                          alpha=0.5, temperature=2.0)
    jstate = JaxTrainState.create(_tj(s_params), tx, jax.random.PRNGKey(1))
    video = _video(40)
    labels = np.array([1, 0, 1, 1], np.int32)
    T = 2.0
    t_soft = jax.nn.softmax(teacher_j.apply(
        {"params": t_params}, jnp.asarray(video)) / T, -1)

    def loss_fn(p):
        s = student_j.apply({"params": p}, jnp.asarray(video),
                            deterministic=False,
                            rngs={"dropout": jax.random.PRNGKey(0),
                                  "droppath": jax.random.PRNGKey(0)})
        kd = -jnp.mean(jnp.sum(t_soft * jax.nn.log_softmax(s / T, -1),
                               -1)) * T * T
        return 0.5 * kd + 0.5 * JL.cross_entropy(s, jnp.asarray(labels))

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(
        jstate.params)
    jstate, (jm, _) = jstep(jstate, {"video": jnp.asarray(video),
                                     "label": jnp.asarray(labels)}, t_params)
    state = TrainState.create(student, opt, torch.Generator())
    m = D.make_distill_step(teacher, alpha=0.5, temperature=2.0)(
        state, {"video": torch.from_numpy(video),
                "label": torch.from_numpy(labels).long()})
    for k in ("loss", "kd", "ce", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(float(m["loss"]), float(want_loss), rtol=1e-5)
    _tree_close(tc.to_jax_params(_grads(student)), want_grads, 1e-4, "grad")
    _tree_close(tc.to_jax_params(student.state_dict()), jstate.params, 1e-5,
                "params")
    mu, nu = _adam_moments(jstate.opt_state)
    _tree_close(tc.to_jax_params(opt.mu), mu, 1e-5, "mu")
    _tree_close(tc.to_jax_params(opt.nu), nu, 1e-5, "nu")
