"""The port's efficiency harness (simple_tad_tpu_torch/cli/efficiency.py)
against the JAX package's, on CPU: ``benchmark_model`` on a tiny ViT
(``device="cpu"``, 2 iterations) returns rows with the JAX rows' keys and
the same parameter count; ``benchmark_train_input`` through the port's
builders and TrainLoader on the synthetic DoTA root counts the same
windows as the JAX one, in the same batches (one decode thread each;
exact).  The hit rates depend on how far each loader's thread decodes
ahead of the consumer, and the rates are timings: those are checked for
range only (the warm epoch's hit rate above the cold one's).
"""

import json

import jax.numpy as jnp
import pytest
import torch

from simple_tad_tpu.cli import efficiency as jax_eff
from simple_tad_tpu_torch.cli import efficiency as eff
from tests.fixtures import make_synthetic_dota_full
from tests.test_torch_vit import (  # noqa: F401
    drop_checkpoints, one_torch_thread)

TINY = dict(num_frames=4, input_size=32)


def test_benchmark_model_rows_have_the_jax_keys(capsys):
    got = eff.benchmark_model("vit_small_patch16_224", batches=(1, 2),
                              iters=2, dtype=torch.float32, device="cpu",
                              **TINY)
    printed = [json.loads(line) for line in
               capsys.readouterr().out.splitlines()]
    assert printed == got
    want = jax_eff.benchmark_model("vit_small_patch16_224", batches=(1,),
                                   iters=2, dtype=jnp.float32, **TINY)
    assert [sorted(r) for r in got] == [sorted(want[0])] * 2
    assert [r["batch"] for r in got] == [1, 2]
    assert got[0]["params_m"] == want[0]["params_m"]
    for r in got:
        assert r["model"] == "vit_small_patch16_224"
        assert r["latency_ms"] > 0 and r["clips_per_sec"] > 0
        assert r["peak_hbm_mb"] is None            # no device memory on CPU


@pytest.fixture(scope="module")
def dota_root(tmp_path_factory):
    return make_synthetic_dota_full(str(tmp_path_factory.mktemp("dota")),
                                    n_clips=2, frames_per_clip=30, h=48,
                                    w=64)


def _count_windows(monkeypatch, engine):
    """-> the list that receives the size of every batch ``engine``'s
    TrainLoader yields."""
    sizes = []
    epoch = engine.TrainLoader.epoch

    def counted(self, *a, **k):
        for batch in epoch(self, *a, **k):
            sizes.append(batch["video_u8"].shape[0])
            yield batch
    monkeypatch.setattr(engine.TrainLoader, "epoch", counted)
    return sizes


def test_train_input_counts_match_jax(dota_root, monkeypatch):
    from simple_tad_tpu.config import FinetuneConfig
    from simple_tad_tpu.data import native
    from simple_tad_tpu.data.builders import build_frame_dataset
    from simple_tad_tpu.train import engine as jax_engine
    from simple_tad_tpu_torch.data import builders
    from simple_tad_tpu_torch.train import engine
    monkeypatch.setattr(native, "decode_zip_frames_native",
                        lambda *a, **k: None)
    sizes = _count_windows(monkeypatch, engine)
    jax_sizes = _count_windows(monkeypatch, jax_engine)
    args = FinetuneConfig(data_set="DoTA", data_path=dota_root,
                          num_frames=8, view_fps=10, sampling_rate=1,
                          input_size=32)
    port_ds, _ = builders.build_frame_dataset(True, False, args)
    jax_ds, _ = build_frame_dataset(True, False, args)
    assert len(port_ds) == len(jax_ds) > 0
    kw = dict(batch_size=4, steps=3, num_threads=1, step_ms=100.0)
    got = eff.benchmark_train_input(port_ds, **kw)
    want = jax_eff.benchmark_train_input(jax_ds, **kw)
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert sizes == jax_sizes == [4] * 6
    assert 0 < got[0]["cache_hit_rate"] < got[1]["cache_hit_rate"] <= 1
    for r in got:
        assert r["windows_per_sec"] > 0 and r["input_occupancy"] > 0


def test_train_input_cli_with_the_native_decoder(dota_root, capsys):
    rows = eff.main(["--train_input", "--data_path", dota_root,
                     "--num_frames", "8", "--input_size", "32",
                     "--batch_size", "4", "--steps", "2",
                     "--num_threads", "1", "--native_decoder"])
    assert [r["phase"] for r in rows] == ["train_input_epoch0",
                                          "train_input_epoch1"]
    assert len(capsys.readouterr().out.splitlines()) == 2
