"""Every name of the optimizer menu (simple_tad_tpu_torch.train.optim.
FinetuneOptimizer) against the JAX package's create_optimizer: the same
tiny-ViT parameters and the same seeded gradients, through the whole chain
(weight-decay mask, layer decay 0.75, lr and wd schedules, clip_grad).
Parameters and every optimizer state slot after the steps agree within
1e-6 of each tensor's largest magnitude (1 at least).  radam runs 7 steps,
so that its rectification (ro >= 5 from the 6th) is reached."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from simple_tad_tpu.models.vit import ViTConfig as JaxViTConfig
from simple_tad_tpu.models.vit import VisionTransformer as JaxViT
from simple_tad_tpu.train import optim as JO
from simple_tad_tpu_torch.models.vit import ViTConfig, VisionTransformer
from simple_tad_tpu_torch.train import optim as O
from simple_tad_tpu_torch.utils import torch_convert as tc
from tests.test_torch_vit import one_torch_thread  # noqa: F401

# embed 128: the qkv, proj, MLP and patch kernels have two dims >= 128, so
# adafactor factors them (proj square: the tie-break of the two dims)
TINY = dict(img_size=32, all_frames=4, embed_dim=128, depth=3, num_heads=2,
            num_classes=2, init_values=0.1)
SLOTS = ("mu", "nu", "trace", "e_g", "e_x", "v_row", "v_col", "v")
TOL = 1e-6


_PARAMS = []


def _model():
    if not _PARAMS:
        _PARAMS.append(jax.tree_util.tree_map(np.asarray, JaxViT(
            JaxViTConfig(**TINY)).init_params(jax.random.PRNGKey(0))))
    params = _PARAMS[0]
    model = VisionTransformer(ViTConfig(**TINY, param_dtype=torch.float32),
                              device="cpu")
    model.load_state_dict(tc.from_jax_params(params))
    return params, model


def _grads(params, seed):
    leaves, treedef = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(treedef, [
        (rng.standard_normal(np.shape(x)) * 0.3).astype(np.float32)
        for x in leaves])


def _jax_slots(opt_state):
    """{slot: tree} of the direction's state in a chain state."""
    found = {}

    def walk(s):
        if hasattr(s, "_fields"):
            for f in s._fields:
                if f in SLOTS:
                    found[f] = getattr(s, f)
                else:
                    walk(getattr(s, f))
        elif isinstance(s, (tuple, list)):
            for x in s:
                walk(x)
    walk(opt_state)
    return found


def _where(named):
    """port name -> (JAX leaf path, block index or None), read off the
    converter with every parameter filled with its own number."""
    names = list(named)
    tree = tc.to_jax_params({n: torch.full_like(p, float(k))
                             for k, (n, p) in enumerate(named.items())})
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = tuple(getattr(k, "key", str(k)) for k in path)
        leaf = np.asarray(leaf)
        if keys[0] == "blocks":
            for i in range(leaf.shape[0]):
                out[names[int(leaf[i].flat[0])]] = (keys, i)
        else:
            out[names[int(leaf.flat[0])]] = (keys, None)
    return out


def _leaf(tree, keys, i):
    for k in keys:
        tree = tree[k]
    a = np.asarray(tree)
    return a if i is None else a[i]


def _close(got, want, what):
    """Within TOL of the tensor's largest magnitude (1 at least): the
    directions that divide by a root of a tiny second moment (rmsprop,
    adafactor) carry the last-bit differences of their inputs (XLA fuses
    multiply-adds where PyTorch rounds twice) into entries far from the
    tensor's scale."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale,
                               err_msg=what)


@pytest.mark.parametrize("name", O.OPTIMIZER_MENU)
def test_optimizer_matches_jax(name):
    steps = 7 if name == "radam" else 3
    params, model = _model()
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    lr = O.cosine_scheduler(1e-3, 1e-5, 1, steps, warmup_epochs=0,
                            warmup_steps=2)
    wd = O.cosine_scheduler(0.05, 0.1, 1, steps)
    kw = dict(weight_decay=0.05, layer_decay=0.75, depth=3, clip_grad=4.0,
              opt=name)
    tx = JO.create_optimizer(params, lr_schedule=JO.array_schedule(lr),
                             wd_schedule=JO.array_schedule(wd), **kw)
    opt = O.FinetuneOptimizer(named, lr_schedule=O.array_schedule(lr),
                              wd_schedule=O.array_schedule(wd), **kw)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = tx.init(jparams)

    @jax.jit
    def update(g, jstate, jparams):
        updates, jstate = tx.update(g, jstate, jparams)
        return optax.apply_updates(jparams, updates), jstate
    for s in range(steps):
        g = _grads(params, 100 + s)
        jparams, jstate = update(jax.tree_util.tree_map(jnp.asarray, g),
                                 jstate, jparams)
        for n, t in tc.from_jax_params(g).items():
            if n in named:
                named[n].grad = t.clone()
        assert opt.step()
    assert opt.count == steps
    want = tc.to_jax_params(model.state_dict())
    jax.tree_util.tree_map(lambda a, b: _close(a, b, f"{name} params"),
                           want, jax.tree_util.tree_map(np.asarray, jparams))
    where = _where(named)
    jslots = _jax_slots(jstate)
    assert sorted(jslots) == sorted(opt.state), (jslots.keys(), opt.state)
    for slot, mine in opt.state.items():
        for n, t in mine.items():
            keys, i = where[n]
            if (slot == "nu" and name == "novograd") or (
                    slot in ("v_row", "v_col", "v") and t.shape == (1,)):
                # one second moment for the whole stacked leaf; adafactor's
                # (1,) placeholder of the slots a leaf does not use
                i = None
            ref = _leaf(jslots[slot], keys, i)
            t = (O.jax_view(n, t) if t.shape == named[n].shape else t)
            if slot in ("v_row", "v_col", "v") and t.shape == (1,):
                assert ref.shape == (1,) and not ref.any() and not t.any()
                continue
            _close(t.detach().numpy(), ref, f"{name} {slot} {n}")


def test_optimizer_menu_names():
    _, model = _model()
    named = dict(model.named_parameters())
    for name in ("AdamW", "LAMB", "rmsPropTF"):
        assert O.FinetuneOptimizer(named, lr_schedule=1e-3,
                                   opt=name).opt == name.lower()
    with pytest.raises(ValueError, match="unknown optimizer"):
        O.FinetuneOptimizer(named, lr_schedule=1e-3, opt="nope")
