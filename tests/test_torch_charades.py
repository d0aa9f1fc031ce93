"""Charades and the multi-label path in the port (``vtm_torch/data/charades.py``,
``data/ptv.py``, ``DATA.MULTI_LABEL`` in ``tools/train_net.py`` and
``tools/test_net.py``, the mAP of ``eval/meters.py``) against ``vtm``'s on
the CPU, on a frame-list tree the test writes with cv2 (3 videos of 30
JPEG frames, 157 classes, two labels a frame): the label helpers; every
clip's frame indices in test mode and, under the same ``random`` seed, in
train mode (with the long cycle's sampling rate too); every item in both
modes under the same seeds, equal exactly; the mAP against scikit-learn's
average precision; and one epoch of multi-label ``train`` (``bce_logit``)
on a tiny R(2+1)D followed by ``test`` over 2 views x 3 crops, each against
``vtm``'s from the same weights: the losses, the val and test mAP. About
40 s."""

import random

import numpy as np
import pytest
import torch

import tools.test_net as jax_test_net
import tools.train_net as jax_train_net
import vtm.eval.meters as jax_meters
from vtm.checkpoints.convert import convert_pyslowfast
from vtm.data import charades as jax_charades
from vtm.data.loader import DATASET_REGISTRY as JAX_DATASETS
from vtm.models.build import build_model as jax_build_model

import vtm_torch.eval.meters as meters
from vtm_torch.data import charades
from vtm_torch.data.loader import DATASET_REGISTRY
from vtm_torch.models import build_model
from vtm_torch.tools import test_net, train_net

from torch_conv_cases import cfgs, ptv_opts

torch.set_num_threads(2)

# the losses of the two runs, relative (the same weights and clips; each
# package's fp32 convolutions; the shipped init)
LOSS_TOL = 1e-5
# mAP: average precision is a rank statistic; the two packages' scores
# differ in fp32 rounding only, which reorders no two clips here
MAP_TOL = 1e-12
CLASSES = 157


def write_charades_tree(root, num_videos: int = 3, frames_per_video: int = 30, classes: int = CLASSES):
    """``tests/test_charades_imagenet.py``'s tree: ``train.csv`` and
    ``val.csv`` frame lists (``original_vido_id video_id frame_id path
    labels``) over JPEG frames of 48 x 64 under ``frames/``."""
    import cv2

    rng = np.random.default_rng(0)
    frame_dir = root / "frames"
    frame_dir.mkdir(parents=True, exist_ok=True)
    lines = ["original_vido_id video_id frame_id path labels"]
    for v in range(num_videos):
        vid = f"vid{v:03d}"
        (frame_dir / vid).mkdir(exist_ok=True)
        for f in range(frames_per_video):
            rel = f"{vid}/{vid}_{f:06d}.jpg"
            cv2.imwrite(str(frame_dir / rel), rng.integers(0, 255, (48, 64, 3), dtype=np.uint8))
            labels = sorted(random.Random(v * 100 + f).sample(range(classes), k=2))
            lines.append(f"{vid} {v} {f} {rel} \"{','.join(str(x) for x in labels)}\"")
    for split in ("train", "val"):
        (root / f"{split}.csv").write_text("\n".join(lines) + "\n")
    return frame_dir


def charades_opts(root, *extra) -> list:
    return ["DATA.PATH_TO_DATA_DIR", str(root), "DATA.PATH_PREFIX", str(root / "frames"), "DATA.NUM_FRAMES", "8",
            "DATA.SAMPLING_RATE", "3", "DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "32",
            "DATA.TRAIN_JITTER_SCALES", "[36, 48]", "MODEL.NUM_CLASSES", str(CLASSES),
            "TEST.NUM_ENSEMBLE_VIEWS", "2", "TEST.NUM_SPATIAL_CROPS", "3", *extra]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("charades")
    write_charades_tree(root)
    return root


def test_label_helpers_match_vtm():
    label_list = [[3, 1], [1, 9], [], [5]]
    assert charades.aggregate_labels(label_list) == jax_charades.aggregate_labels(label_list) == [1, 3, 5, 9]
    video_labels = [[[3, 1], [9]], [[2], []]]
    assert charades.convert_to_video_level_labels(video_labels) == jax_charades.convert_to_video_level_labels(
        video_labels) == [[[1, 3, 9], [1, 3, 9]], [[2], [2]]]
    got, want = charades.as_binary_vector([4, 0, 4], 6), jax_charades.as_binary_vector([4, 0, 4], 6)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode, long_rate", [("test", 0), ("train", 0), ("train", 6)])
def test_seq_frames_match_vtm(tree, mode, long_rate):
    """Test mode: the views' evenly spaced starts. Train mode: a random start
    (and, with ``MULTIGRID.LONG_CYCLE_SAMPLING_RATE``, a random rate) from
    the module-level ``random``, seeded alike in both packages."""
    cfg, jcfg = cfgs(charades_opts(tree, "MULTIGRID.LONG_CYCLE_SAMPLING_RATE", str(long_rate)))
    ours, theirs = charades.Charades(cfg, mode), jax_charades.Charades(jcfg, mode)
    assert len(ours) == len(theirs) == (18 if mode == "test" else 3)
    for index in range(len(ours)):
        random.seed(index)
        got = ours.get_seq_frames(index)
        random.seed(index)
        assert got == theirs.get_seq_frames(index), index


@pytest.mark.parametrize("mode", ["train", "val", "test"])
def test_items_match_vtm(tree, mode):
    """``__getitem__`` under the same ``random`` and ``np.random`` seeds:
    frames (normalised, scaled, cropped, flipped), the multi-hot label over
    the sampled window ``seq[0]..seq[-1]`` (the video's labels outside
    train) and the index; a short-cycle (index, phase) item in train mode
    at the phase's crop; ``ptvcharades`` the same class in both."""
    cfg, jcfg = cfgs(charades_opts(tree, "MULTIGRID.DEFAULT_S", "32"))
    ours, theirs = charades.Charades(cfg, mode), jax_charades.Charades(jcfg, mode)
    indices = list(range(len(ours))) + ([(1, 0), (2, 1)] if mode == "train" else [])
    for index in indices:
        items = []
        for ds in (ours, theirs):
            random.seed(7)
            np.random.seed(7)
            items.append(ds[index])
        got, want = items
        assert set(got) == set(want) == {"frames", "label", "index"}
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{index} {k}")
        crop = {0: 16, 1: 23}.get(index[1], 32) if isinstance(index, tuple) else 32
        assert got["frames"].shape == (8, crop, crop, 3) and got["label"].shape == (CLASSES,)
        assert got["label"].sum() >= 2
    assert issubclass(DATASET_REGISTRY["ptvcharades"], charades.Charades)
    assert issubclass(JAX_DATASETS["ptvcharades"], jax_charades.Charades)


def test_map_matches_scikit_learn():
    """``get_map`` (numpy) against ``vtm``'s (scikit-learn), ties included;
    classes without a positive dropped; none left gives 0."""
    rng = np.random.default_rng(0)
    for trial in range(50):
        labels = (rng.random((int(rng.integers(2, 30)), 9)) < 0.3).astype(np.float32)
        preds = rng.random(labels.shape).astype(np.float32)
        if trial % 2:
            preds = np.round(preds * 4) / 4
        assert abs(meters.get_map(preds, labels) - jax_meters.get_map(preds, labels)) <= MAP_TOL, trial
    assert meters.get_map(preds, np.zeros_like(labels)) == jax_meters.get_map(preds, np.zeros_like(labels)) == 0.0


class _Recorder:
    """The train meter's losses and the val epoch's stats, of each package."""

    def __init__(self, monkeypatch, meter_module):
        self.losses, self.val = [], []
        update, log = meter_module.TrainMeter.update_stats, meter_module.ValMeter.log_epoch_stats

        def record_update(meter, top1, top5, loss, lr, mb):
            assert top1 is None and top5 is None  # multi-label: the loss only
            self.losses.append(float(loss))
            return update(meter, top1, top5, loss, lr, mb)

        def record_log(meter, cur_epoch):
            stats = log(meter, cur_epoch)
            self.val.append(stats)
            return stats

        monkeypatch.setattr(meter_module.TrainMeter, "update_stats", record_update)
        monkeypatch.setattr(meter_module.ValMeter, "log_epoch_stats", record_log)


def test_multi_label_train_and_test_match_vtm(tree, tmp_path, monkeypatch):
    """``DATA.MULTI_LABEL`` with ``bce_logit`` on a tiny R(2+1)D, ``charades``
    for train, val and test. ``train``: one epoch of the train split (B2), the
    val epoch's mAP; then ``test`` of the port's checkpoint and of the same
    weights in ``vtm`` (2 views x 3 crops, 3 videos): the mAP, the ensembled
    predictions and the multi-hot video labels. ``vtm`` starts from the port's
    seeded init (its ``build_model`` given those weights)."""
    opts = ptv_opts("r2plus1d", "RESNET.ZERO_INIT_FINAL_BN", "True", *charades_opts(tree),
                    "DATA.MULTI_LABEL", "True", "MODEL.LOSS_FUNC", "bce_logit", "TRAIN.DATASET", "charades",
                    "TEST.DATASET", "charades", "TRAIN.BATCH_SIZE", "2", "TEST.BATCH_SIZE", "4",
                    "SOLVER.OPTIMIZING_METHOD", "sgd", "SOLVER.BASE_LR", "0.01", "SOLVER.MAX_EPOCH", "1",
                    "TRAIN.EVAL_PERIOD", "1", "TRAIN.CHECKPOINT_PERIOD", "1", "TRAIN.AUTO_RESUME", "False",
                    "DATA_LOADER.NUM_WORKERS", "0")
    cfg, jcfg = cfgs(opts + ["OUTPUT_DIR", str(tmp_path / "port")])
    jcfg.OUTPUT_DIR = str(tmp_path / "vtm")
    port, ref = _Recorder(monkeypatch, meters), _Recorder(monkeypatch, jax_meters)
    sd = {k: v.numpy() for k, v in build_model(cfg, "cpu", fp32_params=True).module.state_dict().items()}
    params, stats = convert_pyslowfast(sd)

    def with_port_weights(jcfg_, init: bool = True):
        bundle = jax_build_model(jcfg_, init=False)
        bundle.params, bundle.batch_stats = params, stats
        return bundle

    monkeypatch.setattr(jax_train_net, "build_model", with_port_weights)
    monkeypatch.setattr(jax_test_net, "build_model", with_port_weights)
    random.seed(0)
    module = train_net.train(cfg, device="cpu")
    random.seed(0)
    assert jax_train_net.train(jcfg) is not None
    assert len(port.losses) == len(ref.losses) == 1 and np.isfinite(port.losses[0])
    for loss, jloss in zip(port.losses, ref.losses):
        assert abs(loss - jloss) <= LOSS_TOL * abs(jloss), (loss, jloss)
    assert len(port.val) == len(ref.val) == 1
    assert 0.0 <= port.val[0]["map"] <= 1.0
    assert abs(port.val[0]["map"] - ref.val[0]["map"]) <= MAP_TOL, (port.val, ref.val)

    # test: the port from its checkpoint of that epoch, vtm from the same
    # (trained) weights in its own layout
    sd = {k: v.numpy() for k, v in module.state_dict().items()}
    params, stats = convert_pyslowfast(sd)
    seen = {}
    for name, pkg in (("port", meters), ("vtm", jax_meters)):
        finalize = pkg.TestMeter.finalize_metrics

        def record(meter, ks=(1, 5), name=name, finalize=finalize):
            seen[name] = (meter.video_preds.copy(), meter.video_labels.copy())
            return finalize(meter, ks)

        monkeypatch.setattr(pkg.TestMeter, "finalize_metrics", record)
    cfg.OUTPUT_DIR = str(tmp_path / "port")  # test loads the last checkpoint there
    results = test_net.test(cfg, device="cpu")
    jcfg.OUTPUT_DIR = str(tmp_path / "vtm_test")
    jresults = jax_test_net.test(jcfg)
    (views, stats_), (jviews, jstats) = results[0], jresults[0]
    assert views == jviews == 2
    assert 0.0 <= float(stats_["map"]) <= 100.0 and stats_["map"] == jstats["map"], (stats_, jstats)
    np.testing.assert_array_equal(seen["port"][1], seen["vtm"][1])
    assert seen["port"][1].shape == (3, CLASSES)
    np.testing.assert_allclose(seen["port"][0], seen["vtm"][0], rtol=0, atol=1e-6)
