"""Data parallelism of the port (simple_tad_tpu_torch/parallel) at world 2
on the CPU: one ``torchrun --standalone --nproc_per_node 2`` launch over
gloo (one torch thread a process, a free port, a time limit) runs this
file as its worker (``--standalone`` takes a free port itself), and the
test holds what the ranks computed:

* a tiny-ViT fine-tune step and a tiny MAE step, each rank taking half of
  a batch given already augmented (drop path 0), with SGD momentum through
  the whole chain (see ``OPT``): the parameters after the step against the
  JAX package's step on the whole batch, within 1e-5 of each leaf's
  largest magnitude;
* the fine-tune step with ``zero_stage`` 1, and two micro-steps with
  ``update_freq`` 2, all with ``clip_grad``: the parameters and the
  optimizer state equal the port's world-1 run on the whole batch within
  1e-5 of each tensor's largest magnitude (the cross-rank mean rounds
  differently from the whole-batch mean: the patch-embedding bias's
  gradient, a sum over every token, differs at ~3e-6 of its largest
  element), and under ZeRO each rank holds about half of the state's
  elements;
* ``cli/eval_frames.py --dist_eval``: the merged predictions.csv equals the
  world-1 run's, row for row (tests/test_multihost.py holds the JAX CLI
  so);
* ``simple_tad_tpu_torch.parallel.check``, the multi-card check, passes.
"""

import csv
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

VIT = dict(img_size=32, all_frames=4, patch_size=16, tubelet_size=2,
           embed_dim=128, depth=2, num_heads=2, num_classes=2,
           init_scale=1.0, init_values=0.1)
MAE = dict(img_size=32, patch_size=16, all_frames=4, tubelet_size=2,
           encoder_embed_dim=128, encoder_depth=2, encoder_num_heads=2,
           decoder_embed_dim=64, decoder_depth=2, decoder_num_heads=1,
           decoder_num_classes=1536, init_values=0.1)
B = 4
# SGD with momentum (optax trace) through the whole chain: the cross-rank
# mean of the gradients rounds differently from the whole-batch mean, and
# Adam's first step divides each gradient by its own magnitude, which turns
# the last bits of a gradient element that nearly cancels into up to ~lr of
# update; the trace's update is linear in the gradient.  The direction
# itself is held to optax per name in tests/test_torch_optim_menu.py.
LR = 5e-4
OPT = dict(weight_decay=0.05, layer_decay=0.75, depth=2, clip_grad=1.0,
           opt="momentum")
EVAL_ARGS = ["--data_set", "DoTA", "--model", "vit_small_patch16_224",
             "--input_size", "32", "--num_frames", "16", "--batch_size", "4",
             "--dtype", "float32", "--device", "cpu"]
LAUNCH_TIMEOUT_S = 240


# ------------------------------------------------------------- the worker --

def _vit_port(state_dict, **opt):
    from simple_tad_tpu_torch.models.vit import ViTConfig, VisionTransformer
    from simple_tad_tpu_torch.train import optim as O
    model = VisionTransformer(ViTConfig(**VIT, param_dtype=torch.float32),
                              device="cpu")
    model.load_state_dict(state_dict)
    kw = dict(OPT, **opt)
    opt_ = O.FinetuneOptimizer(dict(model.named_parameters()),
                               lr_schedule=LR, **kw)
    return model, opt_


def _vit_steps(inputs, dp=None, rows=slice(None), **opt):
    """The ViT fine-tune step(s) on ``rows`` of each batch -> (params,
    optimizer state, this rank's moment elements)."""
    from simple_tad_tpu_torch.train import losses as L
    from simple_tad_tpu_torch.train.steps import (TrainState,
                                                  make_finetune_train_step)
    model, opt = _vit_port(inputs["vit"], data_parallel=dp, **opt)
    state = TrainState.create(model, opt, torch.Generator().manual_seed(0))
    step = make_finetune_train_step(L.create_criterion("crossentropy"))
    for batch in inputs["vit_batches"][:opt.update_freq]:
        step(state, {k: v[rows] for k, v in batch.items()})
    held = sum(t.numel() for slot in opt.state.values()
               for t in slot.values())
    return ({n: p.detach().clone() for n, p in model.named_parameters()},
            opt.state_dict(), held)


def _mae_step(inputs, dp=None, rows=slice(None)):
    from simple_tad_tpu_torch.models import mae
    from simple_tad_tpu_torch.train import optim as O
    from simple_tad_tpu_torch.train.steps import (TrainState,
                                                  make_mae_train_step)
    model = mae.PretrainVideoMAE(mae.MAEConfig(**MAE,
                                               param_dtype=torch.float32),
                                 device="cpu")
    model.load_state_dict(inputs["mae"])
    opt = O.FinetuneOptimizer(dict(model.named_parameters()),
                              lr_schedule=1.5e-4, weight_decay=0.05,
                              opt="momentum", data_parallel=dp)
    state = TrainState.create(model, opt, torch.Generator().manual_seed(0))
    batch = inputs["mae_batch"]
    step = make_mae_train_step(num_masked=inputs["num_masked"])
    step(state, {k: v[rows] for k, v in batch.items()})
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _worker(work):
    from simple_tad_tpu_torch.cli.eval_frames import main as eval_main
    from simple_tad_tpu_torch.parallel import multihost
    from simple_tad_tpu_torch.parallel.mesh import (data_parallel_setup,
                                                    rank_rows)
    torch.set_num_threads(1)
    dp = data_parallel_setup("cpu")
    assert dp.world == 2 and multihost.world_size() == 2
    inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    rows = rank_rows(B, dp.rank, dp.world)
    out = {"vit": _vit_steps(inputs, dp, rows)[0],
           "mae": _mae_step(inputs, dp, rows)}
    params, state, held = _vit_steps(inputs, dp, rows, zero_stage=1)
    out["vit_zero"] = (params, state,
                       multihost.allgather_object(held))
    out["vit_freq2"] = _vit_steps(inputs, dp, rows, update_freq=2)[:2]
    eval_main(EVAL_ARGS + ["--data_path", inputs["eval_root"],
                           "--dist_eval", "--output_dir",
                           os.path.join(work, "world2")])
    main_rank = multihost.is_main_process()
    from simple_tad_tpu_torch.parallel.check import main as check_main
    check_main(["--device", "cpu"])  # SystemExit(1) if it fails; ends the group
    out["check"] = True
    if main_rank:
        torch.save(out, os.path.join(work, "results.pt"))


# --------------------------------------------------------------- the test --

def _jax_vit_step(params, batch):
    import jax
    import jax.numpy as jnp
    from simple_tad_tpu.models.vit import ViTConfig as JaxViTConfig
    from simple_tad_tpu.models.vit import VisionTransformer as JaxViT
    from simple_tad_tpu.train import losses as JL
    from simple_tad_tpu.train import optim as JO
    from simple_tad_tpu.train.steps import TrainState as JaxTrainState
    from simple_tad_tpu.train.steps import make_finetune_train_step
    tx = JO.create_optimizer(params, lr_schedule=LR, **OPT)
    model = JaxViT(JaxViTConfig(**VIT, attn_impl="xla"))
    step = make_finetune_train_step(model, tx,
                                    JL.create_criterion("crossentropy"),
                                    donate=False)
    state = JaxTrainState.create(jax.tree_util.tree_map(jnp.asarray, params),
                                 tx, jax.random.PRNGKey(1))
    state, _ = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    return state.params


def _jax_mae_step(params, batch, num_masked):
    import jax
    import jax.numpy as jnp
    import simple_tad_tpu.models.mae as jax_mae
    from simple_tad_tpu.train import optim as JO
    from simple_tad_tpu.train.steps import TrainState as JaxTrainState
    from simple_tad_tpu.train.steps import make_mae_train_step
    tx = JO.create_optimizer(params, lr_schedule=1.5e-4, weight_decay=0.05,
                             opt="momentum")
    model = jax_mae.PretrainVideoMAE(jax_mae.MAEConfig(**MAE,
                                                       attn_impl="xla"))
    step = make_mae_train_step(model, tx, num_masked=num_masked,
                               donate=False)
    state = JaxTrainState.create(jax.tree_util.tree_map(jnp.asarray, params),
                                 tx, jax.random.PRNGKey(1))
    state, _ = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    return state.params


def _leaves_close(got_tree, want_tree, rel, what):
    import jax
    want = dict(jax.tree_util.tree_leaves_with_path(want_tree))
    got = jax.tree_util.tree_leaves_with_path(got_tree)
    assert len(got) == len(want), what
    for path, g in got:
        w = np.asarray(want[path], np.float32)
        np.testing.assert_allclose(
            np.asarray(g), w, rtol=0, atol=rel * float(np.abs(w).max()),
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


def _close(got, want, rel, what):
    for n, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(got[n].numpy(), w, rtol=0,
                                   atol=rel * float(np.abs(w).max()),
                                   err_msg=f"{what} {n}")


def _rows(path):
    with open(path, newline="") as f:
        return sorted(csv.reader(f))


def _launch(work: str) -> None:
    """Write the inputs to ``work``, run the world-2 launch on them and
    keep its results there (results.pt, world2/)."""
    import jax
    import simple_tad_tpu.models.mae as jax_mae
    from simple_tad_tpu.data.masking import TubeMaskingGenerator
    from simple_tad_tpu.models.vit import ViTConfig as JaxViTConfig
    from simple_tad_tpu.models.vit import VisionTransformer as JaxViT
    from simple_tad_tpu_torch.utils import torch_convert as tc
    from tests.fixtures import make_synthetic_dota_full
    rng = np.random.default_rng(0)
    vit = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.02 * rng.standard_normal(a.shape).astype(np.float32),
        JaxViT(JaxViTConfig(**VIT)).init_params(jax.random.PRNGKey(0)))
    gen = TubeMaskingGenerator((2, 2, 2), 0.75)
    mask = gen.batch(B, np.random.default_rng(3))
    mae_params = jax_mae.PretrainVideoMAE(jax_mae.MAEConfig(**MAE)).init(
        jax.random.PRNGKey(1), np.zeros((1, 4, 32, 32, 3), np.float32),
        mask[:1], gen.total_masks)["params"]
    mae_params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.02 * rng.standard_normal(a.shape).astype(np.float32),
        mae_params)
    vit_batches = []
    for _ in range(2):
        labels = np.array([1, 0, 0, 1], np.int32)
        video = rng.standard_normal((B, 4, 32, 32, 3)).astype(np.float32)
        vit_batches.append({"video": video + 0.5 * labels[:, None, None,
                                                          None, None],
                            "label": labels,
                            "smoothed": np.zeros((B, 2), np.float32),
                            "ttc": np.zeros(B, np.float32)})
    mae_batch = {"video": rng.standard_normal((B, 4, 32, 32, 3)).astype(
        np.float32), "mask": mask}
    eval_root = make_synthetic_dota_full(os.path.join(work, "data"),
                                         n_clips=3, frames_per_clip=24,
                                         h=48, w=64)
    inputs = {
        "vit": tc.from_jax_params(vit), "mae": tc.from_jax_params(mae_params),
        "vit_batches": [{k: torch.from_numpy(v).long() if k == "label"
                         else torch.from_numpy(v) for k, v in b.items()}
                        for b in vit_batches],
        "mae_batch": {k: torch.from_numpy(v) for k, v in mae_batch.items()},
        "num_masked": gen.total_masks, "eval_root": eval_root,
        "jax": {"vit": vit, "mae": mae_params, "vit_batches": vit_batches,
                "mae_batch": mae_batch}}
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
           "--nproc_per_node", "2", os.path.abspath(__file__), work]
    proc = subprocess.run(cmd, env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT,
                          timeout=LAUNCH_TIMEOUT_S)
    log = proc.stdout.decode(errors="replace")
    assert proc.returncode == 0, log[-6000:]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """The world-2 launch, once a test session: under pytest-xdist the
    first worker to take the lock launches it and the others read its
    results -> (inputs, results, dir)."""
    import fcntl
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent                   # shared by the session's workers
    work = os.path.join(str(base), "torch_ddp_world2")
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


def test_world2_steps_match_the_jax_whole_batch_step(world2):
    from simple_tad_tpu_torch.utils import torch_convert as tc
    inputs, results, _ = world2
    jax_inputs = inputs["jax"]
    want = _jax_vit_step(jax_inputs["vit"], jax_inputs["vit_batches"][0])
    _leaves_close(tc.to_jax_params(results["vit"]), want, 1e-5, "vit")
    want = _jax_mae_step(jax_inputs["mae"], jax_inputs["mae_batch"],
                         inputs["num_masked"])
    _leaves_close(tc.to_jax_params(results["mae"]), want, 1e-5, "mae")


@pytest.mark.parametrize("case", ["vit_zero", "vit_freq2"])
def test_world2_zero_and_update_freq_match_world1(world2, case):
    inputs, results, _ = world2
    opt = {"zero_stage": 1} if case == "vit_zero" else {"update_freq": 2}
    want_params, want_state, held = _vit_steps(inputs, **opt)
    got_params, got_state = results[case][:2]
    _close(got_params, want_params, 1e-5, f"{case} params")
    assert got_state["count"] == want_state["count"] == 1
    _close(got_state["state"]["trace"], want_state["state"]["trace"], 1e-5,
           f"{case} trace")
    if case == "vit_zero":
        per_rank = results[case][2]
        assert sum(per_rank) == held
        assert all(abs(h - held / 2) < 0.15 * held for h in per_rank), (
            per_rank, held)


def test_parallel_check_passes_at_world2(world2):
    """The averaged gradient within 1e-5 of the whole batch's, ZeRO 1 and 2
    bit-equal to stage 0 (the module exits non-zero otherwise, which fails
    the launch)."""
    _, results, _ = world2
    assert results["check"] is True


def test_dist_eval_two_processes_matches_world1(world2, tmp_path):
    from simple_tad_tpu_torch.cli.eval_frames import main
    inputs, _, work = world2
    out1 = str(tmp_path / "world1")
    main(EVAL_ARGS + ["--data_path", inputs["eval_root"], "--output_dir",
                      out1])
    out2 = os.path.join(work, "world2")
    shards = [_rows(os.path.join(out2, f"predictions.{r}.csv"))
              for r in range(2)]
    ref = _rows(os.path.join(out1, "predictions.csv"))
    got = _rows(os.path.join(out2, "predictions.csv"))
    assert all(0 < len(s) - 1 < len(ref) - 1 for s in shards)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        if a[0] == "clip":
            assert a == b
            continue
        assert a[:2] == b[:2] and a[4:] == b[4:]
        np.testing.assert_allclose(np.float64(a[2:4]), np.float64(b[2:4]),
                                   rtol=1e-5, atol=1e-5)
    with open(os.path.join(out1, "stats.txt")) as f1, \
            open(os.path.join(out2, "stats.txt")) as f2:
        s1 = dict(line.split(": ") for line in f1.read().splitlines())
        s2 = dict(line.split(": ") for line in f2.read().splitlines())
    for key in ("auroc", "ap", "mcc_auc"):
        assert abs(float(s1[key]) - float(s2[key])) < 1e-6, key


if __name__ == "__main__":
    _worker(sys.argv[1])
