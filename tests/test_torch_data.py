"""The port's copies of the real datasets' code (Kinetics, SSv2,
EPIC-KITCHENS, with the decoder, transforms and RandAugment) against the
JAX package's, on videos and frame folders this file writes with cv2:
test mode gives equal frames, labels and indices at every index, train
mode equal clips under the same ``random`` and ``np.random`` seeds."""

import json
import random

import jax  # noqa: F401  (keeps the JAX package's CPU setup first, as the other parity tests do)
import numpy as np
import pandas as pd
import pytest
import torch

import vtm.data as jax_data
import vtm_torch.data as data
from vtm.config import get_cfg as jax_get_cfg
from vtm_torch.config import get_cfg
from vtm_torch.data import decoder

torch.set_num_threads(2)

cv2 = pytest.importorskip("cv2")


def _cfgs(opts):
    cfg, jcfg = get_cfg(), jax_get_cfg()
    cfg.merge_from_list(list(opts))
    jcfg.merge_from_list(list(opts))
    return cfg, jcfg


def _frames(rng, n, h=24, w=32):
    return [rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8) for _ in range(n)]


def _kinetics_dir(tmp_path):
    """Two MJPG videos, 48 and 60 frames at 30 fps, and the three csvs."""
    rng = np.random.default_rng(0)
    rows = []
    for i, (n, label) in enumerate(((48, 3), (60, 1))):
        path = tmp_path / f"v{i}.avi"
        writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 30, (32, 24))
        for frame in _frames(rng, n):
            writer.write(frame)
        writer.release()
        rows.append(f"{path} {label}")
    for split in ("train", "val", "test"):
        (tmp_path / f"{split}.csv").write_text("\n".join(rows) + "\n")
    return ["DATA.PATH_TO_DATA_DIR", str(tmp_path)]


def _ssv2_dir(tmp_path):
    """Two videos of 11 and 17 JPEG frames, the label jsons and the frame lists."""
    rng = np.random.default_rng(1)
    templates = ["Pushing [something]", "Holding [something]"]
    (tmp_path / "something-something-v2-labels.json").write_text(
        json.dumps({t.replace("[", "").replace("]", ""): str(i) for i, t in enumerate(templates)}))
    videos = [{"id": 101, "template": templates[1]}, {"id": 102, "template": templates[0]}]
    for split in ("train", "validation"):
        (tmp_path / f"something-something-v2-{split}.json").write_text(json.dumps(videos))
    lines = ["original_vido_id video_id frame_id path labels"]
    for vid, n in ((101, 11), (102, 17)):
        (tmp_path / str(vid)).mkdir()
        for j, frame in enumerate(_frames(rng, n)):
            rel = f"{vid}/{j:06d}.jpg"
            cv2.imwrite(str(tmp_path / rel), frame)
            lines.append(f'{vid} {vid} {j} {rel} ""')
    for split in ("train", "val"):
        (tmp_path / f"{split}.csv").write_text("\n".join(lines) + "\n")
    return ["DATA.PATH_TO_DATA_DIR", str(tmp_path), "DATA.PATH_PREFIX", str(tmp_path)]


def _epic_dir(tmp_path):
    """Two narrations of one EPIC-KITCHENS-100 video (50 fps), its JPEG
    frames 1-120, and the annotation pickles."""
    rng = np.random.default_rng(2)
    frames_dir = tmp_path / "rgb" / "P01" / "P01_101"
    frames_dir.mkdir(parents=True)
    for j, frame in enumerate(_frames(rng, 120), start=1):
        cv2.imwrite(str(frames_dir / f"frame_{j:010d}.jpg"), frame)
    table = pd.DataFrame(
        {"participant_id": ["P01", "P01"], "video_id": ["P01_101", "P01_101"],
         "start_timestamp": ["00:00:00.10", "00:00:01.00"], "stop_timestamp": ["00:00:01.20", "00:00:02.20"],
         "verb_class": [4, 2], "noun_class": [6, 1]},
        index=pd.Index(["P01_101_0", "P01_101_1"], name="narration_id"))
    for name in ("train.pkl", "val.pkl"):
        table.to_pickle(tmp_path / name)
    return ["EPICKITCHENS.VISUAL_DATA_DIR", str(tmp_path), "EPICKITCHENS.ANNOTATIONS_DIR", str(tmp_path),
            "EPICKITCHENS.TRAIN_LIST", "train.pkl", "EPICKITCHENS.VAL_LIST", "val.pkl",
            "EPICKITCHENS.TEST_LIST", "val.pkl", "EPICKITCHENS.NUM_CLASSES", "[5, 7]",
            "EPICKITCHENS.PARTICIPANT_FIRST", "False"]


DATASETS = {"kinetics": _kinetics_dir, "ssv2": _ssv2_dir, "epickitchens": _epic_dir}
COMMON = ["DATA.NUM_FRAMES", "4", "DATA.SAMPLING_RATE", "2", "DATA.TEST_CROP_SIZE", "16",
          "DATA.TRAIN_CROP_SIZE", "16", "DATA.TRAIN_JITTER_SCALES", "[16, 20]"]
# train-mode augmentation under test: none; RandAugment (PIL; RandomErasing
# draws from a fresh unseeded generator in both packages, so it stays off);
# and, for Kinetics, the SSL multi-view clips with the SSL colour jitter
TRAIN_AUGS = {
    "plain": [],
    "randaugment": ["AUG.ENABLE", "True", "AUG.AA_TYPE", "rand-m7-n4-mstd0.5-inc1", "AUG.RE_PROB", "0.0"],
    "ssl": ["DATA.TRAIN_CROP_NUM_TEMPORAL", "2", "DATA.TRAIN_CROP_NUM_SPATIAL", "2",
            "DATA.SSL_COLOR_JITTER", "True"],
}


def _assert_items_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in got:
        if isinstance(got[key], np.ndarray):
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        else:
            assert got[key] == want[key], key


@pytest.mark.parametrize("name", list(DATASETS))
@pytest.mark.parametrize("crops", [1, 3])
def test_test_mode_matches_vtm_at_every_index(name, crops, tmp_path):
    cfg, jcfg = _cfgs(DATASETS[name](tmp_path) + COMMON + [
        "TEST.NUM_ENSEMBLE_VIEWS", "2", "TEST.NUM_SPATIAL_CROPS", str(crops)])
    ds = data.DATASET_REGISTRY[name](cfg, "test")
    jds = jax_data.DATASET_REGISTRY[name](jcfg, "test")
    assert len(ds) == len(jds) == 2 * 2 * crops
    for index in range(len(ds)):
        item = ds[index]
        assert item["index"] == index and item["frames"].shape == (4, 16, 16, 3)
        _assert_items_equal(item, jds[index])


@pytest.mark.parametrize("name, aug", [(n, a) for n in DATASETS for a in TRAIN_AUGS
                                       if a != "ssl" or n == "kinetics"])
def test_train_mode_matches_vtm_under_the_same_seeds(name, aug, tmp_path):
    cfg, jcfg = _cfgs(DATASETS[name](tmp_path) + COMMON + TRAIN_AUGS[aug])
    ds = data.DATASET_REGISTRY[name](cfg, "train")
    jds = jax_data.DATASET_REGISTRY[name](jcfg, "train")
    assert len(ds) == len(jds) == 2
    for index in range(len(ds)):
        items = []
        for d in (ds, jds):
            random.seed(index)
            np.random.seed(index)
            items.append(d[index])
        _assert_items_equal(*items)
        if aug == "ssl":
            assert items[0]["clips"].shape == (4, 4, 16, 16, 3)


def test_test_loader_batches_match_vtm(tmp_path):
    """EPIC-KITCHENS through both packages' loaders: the collated frames,
    verb/noun labels, indices and narration ids."""
    opts = _epic_dir(tmp_path) + COMMON + ["TEST.DATASET", "epickitchens", "TEST.BATCH_SIZE", "4",
                                           "TEST.NUM_ENSEMBLE_VIEWS", "1", "TEST.NUM_SPATIAL_CROPS", "3",
                                           "DATA_LOADER.NUM_WORKERS", "2"]
    cfg, jcfg = _cfgs(opts)
    batches = list(data.construct_loader(cfg, "test"))
    jbatches = list(jax_data.construct_loader(jcfg, "test"))
    assert [b["frames"].shape[0] for b in batches] == [4, 2]
    for b, jb in zip(batches, jbatches, strict=True):
        np.testing.assert_array_equal(b["frames"], jb["frames"])
        np.testing.assert_array_equal(b["index"], jb["index"])
        for key in ("verb", "noun"):
            np.testing.assert_array_equal(b["label"][key], jb["label"][key])
        np.testing.assert_array_equal(b["metadata"]["narration_id"], jb["metadata"]["narration_id"])


def test_decode_matches_vtm(tmp_path):
    """The window decode and the whole-video read of one mp4."""
    from vtm.data import decoder as jax_decoder

    path = str(tmp_path / "clip.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 24, (32, 32))
    for frame in _frames(np.random.default_rng(3), 50, 32, 32):
        writer.write(frame)
    writer.release()
    for clip_idx in (0, 1, 2):
        got = decoder.decode(path, 2, 8, clip_idx=clip_idx, num_clips=3)
        assert got.shape == (8, 32, 32, 3)
        np.testing.assert_array_equal(got, jax_decoder.decode(path, 2, 8, clip_idx=clip_idx, num_clips=3))
    frames, fps = decoder.read_video_cv2(path)
    jframes, jfps = jax_decoder.read_video_cv2(path)
    assert fps == jfps
    np.testing.assert_array_equal(frames, jframes)


def test_test_net_on_kinetics_matches_vtm(tmp_path):
    """The tiny Motionformer of test_torch_test_net.py, one checkpoint file,
    through each package's ``test`` on the Kinetics videos above (2 views x
    3 crops): equal stats and labels, predictions within its PREDS_ATOL."""
    import pickle

    import tools.test_net as jax_test_net
    from test_torch_test_net import PREDS_ATOL, _motionformer_opts, _write_checkpoint
    from vtm_torch.tools import test_net

    opts = _motionformer_opts(*_kinetics_dir(tmp_path), "EPICKITCHENS.NUM_CLASSES", "None",
                              "MODEL.NUM_CLASSES", "7", "TEST.DATASET", "kinetics", "DATA.SAMPLING_RATE", "2",
                              "TEST.NUM_ENSEMBLE_VIEWS", "2", "TEST.NUM_SPATIAL_CROPS", "3")
    ckpt = tmp_path / "model.pyth"
    _write_checkpoint(ckpt, opts)
    saved = {}
    for pkg in ("torch", "jax"):
        run = [*opts, "TEST.CHECKPOINT_FILE_PATH", str(ckpt), "OUTPUT_DIR", str(tmp_path / pkg),
               "TEST.SAVE_RESULTS_PATH", str(tmp_path / f"{pkg}.pkl")]
        cfg, jcfg = _cfgs(run)
        saved[pkg] = test_net.test(cfg, device="cpu") if pkg == "torch" else jax_test_net.test(jcfg)
        with open(tmp_path / f"{pkg}.pkl", "rb") as f:
            saved[pkg] = (saved[pkg], pickle.load(f))
    (stats, got), (jstats, want) = saved["torch"], saved["jax"]
    assert stats == jstats
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_array_equal(got["labels"], [3, 1])
    np.testing.assert_allclose(got["preds"], want["preds"], rtol=0, atol=PREDS_ATOL)
