"""The port's class fine-tuning and probing (simple_tad_tpu_torch.cli.
class_finetune, cli.linear_probe, FinetuneOptimizer.detach_frozen)
against the JAX package.

The steps run the tiny fp32 IV2 of tests/test_torch_iv2_train.py (depth 2,
dim 128, 2 heads, 2 frames of 28 x 28), from the same weights, the JAX
side through its Pallas kernels in interpret mode, with seeded soft
targets fed to both sides' soft-target cross entropy; the tolerances are
that module's (loss 1e-5 relative; parameters and Adam moments 1e-5 of
each leaf's largest magnitude, the pooling head's key biases, whose
gradient is zero in exact arithmetic, of the tree's).  Probing: with the
frozen parameters detached their Adam moments stay zero where the JAX
package fills them, so the JAX moments are compared with the frozen leaves
zeroed; the frozen parameters themselves are bit-unchanged on both sides.
The CLIs run on the JAX tests' synthetic videos (tests/test_class_
finetune.py) at input 28 with the InternVideo2-S widths.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simple_tad_tpu.train import losses as JL
from simple_tad_tpu.train import optim as JO
from simple_tad_tpu.train.steps import TrainState as JaxTrainState
from simple_tad_tpu.train.steps import make_finetune_train_step as jax_step
from simple_tad_tpu_torch.cli import class_finetune as CF
from simple_tad_tpu_torch.train import optim as O
from simple_tad_tpu_torch.train.steps import (TrainState,
                                              make_finetune_train_step)
from simple_tad_tpu_torch.utils import torch_convert as tc
from tests.test_class_finetune import _make_index_videos, video_root  # noqa: F401,E501
from tests.test_torch_iv2_train import (B, _batches, _jax_model, _params,
                                        _port_model, _tree_close, pallas)  # noqa: F401,E501
from tests.test_torch_train_step import _adam_moments, _torch_batch
from tests.test_torch_vit import (  # noqa: F401
    drop_checkpoints, one_torch_thread)

DEPTH = 2
# the IV2-B K710 job's lr 2e-4 scaled by batch / 256 over a 4-step cosine
LR = dict(base=2e-4 * B / 256, final=1e-6, steps=4)


def _soft_batches(n, seed=3):
    """_batches' clips with seeded soft targets (label-smoothed mixes of
    two classes, as mixup leaves them)."""
    rng = np.random.default_rng(seed)
    out = []
    for b in _batches(n):
        lam = rng.uniform(0.2, 0.8, (B, 1)).astype(np.float32)
        onehot = np.eye(2, dtype=np.float32)[b["label"]] * 0.9 + 0.05
        b = dict(b, smoothed=lam * onehot + (1 - lam) * onehot[::-1])
        out.append(b)
    return out


def _soft_ce_jax(lg, lb, sm, ttc):
    return JL.cross_entropy(lg, sm)


def _steps(params, *, layer_decay=0.75, freeze=None, clip_grad=None,
           detach=True):
    """Two steps of each side's optimizer and step from ``params`` ->
    (port state, JAX state, port metrics, JAX metrics, port model)."""
    lr = JO.cosine_scheduler(LR["base"], LR["final"], 1, LR["steps"])
    kw = dict(weight_decay=0.05, layer_decay=layer_decay, depth=DEPTH,
              clip_grad=clip_grad, freeze_layers=freeze)
    tx = JO.create_optimizer(params, lr_schedule=JO.array_schedule(lr), **kw)
    jstep = jax_step(_jax_model(), tx, _soft_ce_jax, donate=False)
    jstate = JaxTrainState.create(jax.tree_util.tree_map(jnp.asarray, params),
                                  tx, jax.random.PRNGKey(1))
    model = _port_model(params)
    opt = O.FinetuneOptimizer(dict(model.named_parameters()),
                              lr_schedule=O.array_schedule(lr), **kw)
    if freeze and detach:
        opt.detach_frozen()
    state = TrainState.create(model, opt, torch.Generator())
    step = make_finetune_train_step(CF.soft_target_criterion)
    for b in _soft_batches(2):
        jstate, (jm, _) = jstep(jstate, jax.tree_util.tree_map(jnp.asarray,
                                                               b))
        m, _ = step(state, _torch_batch(b))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    return state, jstate, model


def test_class_finetune_steps_match_jax(pallas):
    """Two steps of the CLI's criterion (soft-target CE) and optimizer
    (layer decay 0.75 over the depth, constant weight decay) against
    make_finetune_train_step with the same soft targets: loss, every
    parameter and both Adam moments."""
    state, jstate, _ = _steps(_params())
    _tree_close(tc.to_jax_params(state.model.state_dict()), jstate.params,
                1e-5, "params")
    mu, nu = _adam_moments(jstate.opt_state)
    _tree_close(tc.to_jax_params(state.optimizer.mu), mu, 1e-5, "mu")
    _tree_close(tc.to_jax_params(state.optimizer.nu), nu, 1e-5, "nu")


def _trunk_output_grad_fn(model, video):
    """The last block's output in one train-mode forward: its grad_fn."""
    seen = []
    hook = model.blocks[-1].register_forward_hook(
        lambda mod, inp, out: seen.append(out.grad_fn))
    try:
        model.train()
        model(torch.from_numpy(video))
    finally:
        hook.remove()
    return seen[0]


@pytest.mark.parametrize("spec", ["probe;0;0", "probe;0;1", "probe;1;0"])
def test_probe_steps_match_jax(spec, pallas):
    """The probing freeze by detaching (layer decay 1.0, as the probe
    jobs): the parameters after two steps equal the JAX update-masked
    ones, the frozen ones bit-unchanged; the open leaves' Adam moments
    equal JAX's and the frozen leaves' stay zero; with open_block_num 0
    the trunk's output has no grad_fn (the trunk runs forward only), with
    1 it has."""
    params = _params()
    before = tc.from_jax_params(params)
    state, jstate, model = _steps(params, layer_decay=1.0, freeze=spec)
    mask = O.freeze_mask_tree(list(before), spec, DEPTH)
    frozen = sorted(n for n, m in mask.items() if m == 0.0)
    assert sorted(state.optimizer.detached) == frozen
    assert all(not model.get_parameter(n).requires_grad for n in frozen)
    after = model.state_dict()
    for n in frozen:
        assert torch.equal(after[n], before[n]), n
    assert not torch.equal(after["head.weight"], before["head.weight"])
    _tree_close(tc.to_jax_params(after), jstate.params, 1e-5, "params")
    jmask = JO.freeze_mask_tree(params, spec, DEPTH)
    mu, nu = (jax.tree_util.tree_map(lambda m, x: np.asarray(x) * m, jmask,
                                     t)
              for t in _adam_moments(jstate.opt_state))
    for n in frozen:
        assert not state.optimizer.mu[n].any(), n
    _tree_close(tc.to_jax_params(state.optimizer.mu), mu, 1e-5, "mu")
    _tree_close(tc.to_jax_params(state.optimizer.nu), nu, 1e-5, "nu")
    video = _batches(1)[0]["video"]
    grad_fn = _trunk_output_grad_fn(model, video)
    assert (grad_fn is None) == spec.startswith("probe;0")


def test_probe_with_clip_grad_keeps_the_whole_graph(pallas):
    """--clip_grad: the JAX global norm counts the frozen leaves'
    gradients, so the port keeps the mask alone (detach_frozen refuses),
    and parameters and both moments equal JAX's everywhere."""
    params = _params()
    model = _port_model(params)
    opt = O.FinetuneOptimizer(dict(model.named_parameters()),
                              lr_schedule=1e-4, clip_grad=0.5,
                              freeze_layers="probe;0;1", depth=DEPTH)
    with pytest.raises(ValueError, match="clip_grad"):
        opt.detach_frozen()
    state, jstate, model = _steps(params, layer_decay=1.0,
                                  freeze="probe;0;1", clip_grad=0.5,
                                  detach=False)
    assert not state.optimizer.detached
    _tree_close(tc.to_jax_params(model.state_dict()), jstate.params, 1e-5,
                "params")
    mu, nu = _adam_moments(jstate.opt_state)
    _tree_close(tc.to_jax_params(state.optimizer.mu), mu, 1e-5, "mu")
    _tree_close(tc.to_jax_params(state.optimizer.nu), nu, 1e-5, "nu")


def _cli(root, anno, out, *extra):
    return ["--anno_train", anno, "--data_path", root,
            "--model", "internvideo2_small_patch14_224", "--nb_classes", "2",
            "--num_frames", "8", "--sampling_rate", "2", "--input_size", "28",
            "--short_side_size", "40", "--dtype", "float32",
            "--device", "cpu", "--output_dir", out, *extra]


def test_class_finetune_cli_train_and_eval(video_root, tmp_path):  # noqa: F811,E501
    """jobs/finetune/IV2-B_ft_K710.sh's flags at a tiny size (IV2-S widths,
    input 28): one epoch (4 clips, batch 2: two steps, mixup / cutmix,
    RandAugment, erasing on), a checkpoint; then --eval's multi-view test
    (2 segments x 2 crops) -> top-1 / top-5 (2 classes: top-5 100)."""
    from simple_tad_tpu_torch.cli.class_finetune import main
    root, anno = video_root
    out = str(tmp_path / "cls")
    state = main(_cli(root, anno, out, "--batch_size", "2", "--epochs", "1",
                      "--warmup_epochs", "0", "--lr", "2e-4",
                      "--weight_decay", "0.05", "--layer_decay", "0.75",
                      "--opt", "adamw", "--opt_betas", "0.9", "0.999",
                      "--sparse_sampling", "--drop_path", "0.1",
                      "--test_num_segment", "4", "--test_num_crop", "3"))
    assert state.step == 2 and state.optimizer.count == 2
    assert not state.optimizer.detached
    assert os.path.exists(os.path.join(out, "checkpoint-last.pth"))
    top1, top5 = main(_cli(root, anno, "", "--anno_test", anno, "--eval",
                           "--batch_size", "3", "--test_num_segment", "2",
                           "--test_num_crop", "2"))
    assert 0.0 <= top1 <= 100.0 and top5 == 100.0


def test_linear_probe_cli_anet_freezes_the_trunk(tmp_path):
    """jobs/probe/IV2-6B_ap_ANet.sh's flags (--data_set ANet, the attentive
    probe, no RandomErasing) at a tiny size: one epoch; every trunk
    parameter bit-unchanged and detached, the pooling head and classifier
    moved."""
    from simple_tad_tpu_torch.cli.linear_probe import main
    paths = _make_index_videos(tmp_path, n=2, frames=40)
    anno = tmp_path / "anet_train.txt"
    anno.write_text("".join(f"{p} 4.0 0.5 3.5 {i}\n"
                            for i, p in enumerate(paths)))
    argv = ["--data_set", "ANet", "--anno_train", str(anno),
            "--data_path", "", "--model", "internvideo2_small_patch14_224",
            "--nb_classes", "2", "--num_frames", "4", "--input_size", "28",
            "--short_side_size", "32", "--batch_size", "2", "--epochs", "1",
            "--warmup_epochs", "0", "--open_block_num", "0",
            "--open_clip_projector", "--lr", "2e-4", "--min_lr", "0",
            "--weight_decay", "0", "--drop_path", "0.0", "--reprob", "0.0",
            "--dtype", "float32", "--device", "cpu",
            "--output_dir", str(tmp_path / "lp")]
    state = main(argv)
    assert state.step == 1
    before = CF.build_model(CF.get_args(argv + ["--anno_train", "x"]),
                            "cpu").state_dict()
    after = state.model.state_dict()
    detached = state.optimizer.detached
    trunk = [n for n in after if n.startswith(("blocks.", "patch_embed.",
                                               "pos_embed", "cls_token"))]
    assert trunk and set(trunk) <= detached
    for n in trunk:
        assert torch.equal(after[n], before[n]), n
    for n in ("clip_projector.cross_attn.q.weight", "head.weight"):
        assert n not in detached and not torch.equal(after[n], before[n]), n
