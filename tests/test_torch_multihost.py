"""The port's data-parallel helpers (simple_tad_tpu_torch/parallel) in one
process, mirroring tests/test_multihost.py for the JAX package: no torchrun
environment means world 1 and every gather degenerates; a partial one is
refused; the CSV shards merge with the csv module; the ZeRO partition, the
rank rows and seeds; the loaders' rank rows put together give the world-1
batch; FrameEvaluator's ``devices`` lanes score as one device.  The world-2
runs are in tests/test_torch_ddp.py."""

import csv
import os

import numpy as np
import pytest
import torch

from simple_tad_tpu_torch.parallel import mesh, multihost
from tests.test_torch_vit import one_torch_thread  # noqa: F401

TORCHRUN = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@pytest.fixture
def no_torchrun(monkeypatch):
    for var in TORCHRUN:
        monkeypatch.delenv(var, raising=False)


def test_initialize_noop_single_host(no_torchrun, monkeypatch):
    assert multihost.initialize("cpu") is False
    assert multihost.is_main_process()
    assert (multihost.world_size(), multihost.rank()) == (1, 0)
    assert mesh.data_parallel_setup("cpu") == (1, 0, torch.device("cpu"))
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert multihost.initialize("cpu") is False


def test_initialize_refuses_a_partial_torchrun_env(no_torchrun, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="LOCAL_RANK.*torchrun"):
        multihost.initialize("cpu")
    for var in TORCHRUN[2:]:
        monkeypatch.setenv(var, "0")
    with pytest.raises(ValueError, match="backend"):
        multihost.initialize("mps")


def test_allgather_metrics_single_process():
    out = multihost.allgather_metrics({"a": torch.tensor([1.0, 2.0]),
                                       "b": {"c": np.int64(3)}})
    np.testing.assert_array_equal(out["a"], [1.0, 2.0])
    assert out["b"]["c"] == 3
    ragged = multihost.allgather_ragged_1d({"p": np.arange(3.0)})
    np.testing.assert_array_equal(ragged["p"], [0.0, 1.0, 2.0])
    assert multihost.allgather_object("x") == ["x"]


def test_merge_csv_shards(tmp_path):
    for r in (0, 2):
        with open(tmp_path / f"predictions.{r}.csv", "w", newline="") as f:
            csv.writer(f).writerows([["v", "w"], [r, "a"], [r + 1, "b"]])
    out = multihost.merge_csv_shards(str(tmp_path), "predictions", 3)
    assert out == os.path.join(str(tmp_path), "predictions.csv")
    with open(out, newline="") as f:
        rows = list(csv.reader(f))
    assert rows == [["v", "w"], ["0", "a"], ["1", "b"], ["2", "a"],
                    ["3", "b"]]
    assert multihost.merge_csv_shards(str(tmp_path), "nothing", 2) is None
    with open(tmp_path / "predictions.1.csv", "w", newline="") as f:
        csv.writer(f).writerows([["v"], [9]])
    with pytest.raises(ValueError, match="columns"):
        multihost.merge_csv_shards(str(tmp_path), "predictions", 3)


def test_rank_rows_seeds_and_partition():
    assert mesh.rank_rows(8, 1, 2) == slice(4, 8)
    assert mesh.rank_rows(8, 0, 1) == slice(0, 8)
    with pytest.raises(ValueError, match="split"):
        mesh.rank_rows(7, 0, 2)
    assert mesh.rank_seed(5, 0) == 5
    assert len({mesh.rank_seed(5, r) for r in range(4)}) == 4
    dp = mesh.DataParallel(3, 1, torch.device("cpu"))
    sizes = {"a": 100, "b": 60, "c": 50, "d": 40, "e": 10}
    owner = dp.partition(sizes)
    assert owner == mesh.DataParallel(3, 2, torch.device("cpu")).partition(
        sizes)
    load = [sum(sizes[k] for k, r in owner.items() if r == rank)
            for rank in range(3)]
    # largest first, each to the least-loaded rank: 100 | 60 + 10 | 50 + 40
    assert load == [100, 70, 90]
    # world 1: the collectives leave the tensors as they are
    one = mesh.DataParallel(1, 0, torch.device("cpu"))
    t = torch.arange(4.0)
    one.all_reduce_mean([t])
    one.broadcast([t], src=0)
    assert torch.equal(t, torch.arange(4.0))


def test_loaders_rank_rows_make_the_world1_batch(tmp_path):
    from simple_tad_tpu_torch.data.frame_datasets import (FrameDataset,
                                                          read_dota_clips)
    from simple_tad_tpu_torch.train.engine import TrainLoader
    from tests.fixtures import make_synthetic_dota_full
    root = make_synthetic_dota_full(str(tmp_path), n_clips=2,
                                    frames_per_clip=24, h=48, w=64)
    clips = read_dota_clips(root, "train_split.txt", orig_fps=10)
    ds = FrameDataset(clips, mode="train", view_len=16, target_fps=10,
                      orig_fps=10, view_step=1, crop_size=32)

    def first(**kw):
        loader = TrainLoader(ds, 4, seed=3, num_threads=1, **kw)
        return next(iter(loader.epoch(1))), loader.steps_per_epoch()
    whole, steps = first()
    parts = [first(rank=r, world=2) for r in range(2)]
    assert all(s == steps for _, s in parts)
    for key, value in whole.items():
        np.testing.assert_array_equal(
            np.concatenate([p[key] for p, _ in parts]), value, err_msg=key)


def test_evaluator_devices_lanes_score_as_one_device(tmp_path):
    """FrameEvaluator(devices=[...]): one device is the evaluator's own;
    two lanes (here both on the CPU) score the clips round-robin with the
    same rows as one device."""
    from simple_tad_tpu_torch.data.frame_datasets import (FrameDataset,
                                                          read_dota_clips)
    from simple_tad_tpu_torch.eval.engine import FrameEvaluator
    from simple_tad_tpu_torch.models import create_model
    from tests.fixtures import make_synthetic_dota_full
    root = make_synthetic_dota_full(str(tmp_path), n_clips=3,
                                    frames_per_clip=24, h=48, w=64)
    ds = FrameDataset(read_dota_clips(root, "val_split.txt", orig_fps=10),
                      mode="test", view_len=16, target_fps=10, orig_fps=10,
                      view_step=1, crop_size=32)
    model = create_model("vit_small_patch16_224", device="cpu", img_size=32,
                         depth=2, num_classes=2,
                         generator=torch.Generator().manual_seed(0))
    one = FrameEvaluator(model, device="cpu", batch_size=8,
                         devices=["cpu"])
    assert one.lanes is None
    want = one.evaluate(ds)
    two = FrameEvaluator(model, device="cpu", batch_size=8,
                         devices=["cpu", "cpu"])
    assert len(two.lanes) == 2
    got = two.evaluate(ds)
    assert got.rows == want.rows
    assert got.metrics.auroc == want.metrics.auroc


def test_loader_threads_hand_batches_over_in_order(tmp_path):
    """With several decode threads the port's loaders give the batches of
    one thread, in the epoch's order (data/prefetch.py): each rank's k-th
    batch must be its rows of the same global batch."""
    from simple_tad_tpu_torch.data.frame_datasets import (FrameDataset,
                                                          read_dota_clips)
    from simple_tad_tpu_torch.data.prefetch import ordered_batches
    from simple_tad_tpu_torch.train.engine import TrainLoader
    from tests.fixtures import make_synthetic_dota_full
    root = make_synthetic_dota_full(str(tmp_path), n_clips=2,
                                    frames_per_clip=24, h=48, w=64)
    ds = FrameDataset(read_dota_clips(root, "train_split.txt", orig_fps=10),
                      mode="train", view_len=16, target_fps=10, orig_fps=10,
                      view_step=1, crop_size=32)
    one, three = (list(TrainLoader(ds, 2, seed=5, num_threads=n).epoch(0))
                  for n in (1, 3))
    assert len(one) == len(three) > 3
    for a, b in zip(one, three):
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    import time

    def slow_first(row):                 # the first batch finishes last
        time.sleep(0.05 if row == 0 else 0.0)
        return row
    assert list(ordered_batches(list(range(7)), slow_first, 3, 3)) == \
        list(range(7))

    def fails(row):
        if row == 4:
            raise OSError("bad clip")
        return row
    with pytest.raises(OSError, match="bad clip"):
        list(ordered_batches(list(range(7)), fails, 2, 2))
