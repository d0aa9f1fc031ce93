"""The port's AVA data path against ``vtm``'s on the CPU, on a tree the test
writes (``torch_ava_cases.write_ava_tree``: 2 videos of 160 JPEG frames of
32 x 48, keyframes at seconds 902-905, 1-3 person boxes with 1-3 labels
each, predicted boxes above and below the threshold, one excluded
keyframe): ``utils/pathmgr.py``, ``imagenet.lighting_jitter`` and the
``imagenet`` dataset, every function of ``data/cv2_transform.py`` under the
same ``np.random`` seed, ``load_image_lists``, ``parse_bboxes_file``,
``load_boxes_and_labels`` (train, val with and without
``AVA.FULL_TEST_ON_VAL``, test), ``get_keyframe_data``, ``get_sequence``,
every ``Ava`` item of every split (train under the same ``random`` and
``np.random`` seeds, with and without the colour augmentation; a forced
flip and BGR at test) and the loaders' collated batches, all equal
exactly; and chip_smoke's ``AVA_OPTS`` and the tree its ``ava`` phase
writes. About 10 s."""

import random

import numpy as np
import pytest

import vtm.data.ava as jax_ava
import vtm.data.cv2_transform as jax_cv2
import vtm.data.imagenet as jax_imagenet
import vtm.data.loader as jax_loader
import vtm.utils.pathmgr as jax_pathmgr

import vtm_torch.data.loader as loader
from vtm_torch.data import ava, cv2_transform, imagenet
from vtm_torch.utils import pathmgr

from torch_ava_cases import CLASSES, SECS, ava_data_opts, conv_opts, write_ava_tree
from torch_conv_cases import cfgs


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("ava")
    write_ava_tree(root)
    return root


def _ava_cfgs(root, *extra):
    return cfgs(conv_opts("SlowFast", "slowfast") + ava_data_opts(root) + list(extra))


def _assert_same(got, want, what=""):
    """Equal exactly, through dicts, lists and tuples; arrays with their dtype."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), what
        for k in want:
            _assert_same(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{what}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype and got.shape == want.shape, what
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert got == want and type(got) is type(want), (what, got, want)


# ---------------------------------------------------------------- pathmgr


def test_pathmgr_matches_vtm(tmp_path):
    """Every method on local paths in both packages' managers, the same
    results and the same files; an unregistered scheme raises ValueError
    with ``vtm``'s message, and a handler whose package is absent
    ImportError naming the scheme, fsspec and the import's own error."""
    outs = []
    for name, pm in (("port", pathmgr.PathManager()), ("vtm", jax_pathmgr.PathManager())):
        root = tmp_path / name
        with pm.open(str(root / "a" / "b.txt"), "w") as f:
            f.write("x,1\n")
        pm.mkdirs(str(root / "c" / "d"))
        pm.copy(str(root / "a" / "b.txt"), str(root / "c" / "e.txt"))
        with pm.open(str(root / "c" / "e.txt")) as f:
            copied = f.read()
        seen = [pm.exists(str(root / "a" / "b.txt")), pm.isdir(str(root / "c")), pm.ls(str(root)),
                pm.ls(str(root / "c")), copied]
        pm.rm(str(root / "c"))
        seen += [pm.exists(str(root / "c")), pm.ls(str(root))]
        with pytest.raises(ValueError) as unknown:
            pm.open("zz://bucket/x")

        def absent():
            raise ImportError("No module named 'gcsfs'")

        pm.register("gs", absent)
        with pytest.raises(ImportError) as missing:
            pm.exists("gs://bucket/x")
        assert all(w in str(missing.value) for w in ("gs://", "fsspec", "gcsfs"))
        outs.append((seen, str(unknown.value)))
    assert outs[0] == outs[1]
    assert isinstance(pathmgr.pathmgr, pathmgr.PathManager)


# ---------------------------------------------------------------- imagenet


def test_lighting_jitter_matches_vtm():
    im = np.random.default_rng(0).random((6, 7, 3)).astype(np.float32)
    eigval, eigvec = [0.225, 0.224, 0.229], [[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.814],
                                              [-0.5836, -0.6948, 0.4203]]
    for alphastd in (0.1, 0.0):
        np.random.seed(3)
        got = imagenet.lighting_jitter(im, alphastd, eigval, eigvec)
        np.random.seed(3)
        _assert_same(got, jax_imagenet.lighting_jitter(im, alphastd, eigval, eigvec))


@pytest.mark.parametrize("mode", ["train", "val"])
def test_imagenet_items_match_vtm(tmp_path, mode):
    """The ``imagenet`` dataset (registered in the port too) on per-class
    JPEG folders: the imdb and every item, train under the same seeds."""
    import cv2

    rng = np.random.default_rng(1)
    for split in ("train", "val"):
        for c in ("n01440764", "n01443537"):
            (tmp_path / split / c).mkdir(parents=True, exist_ok=True)
            for i in range(2):
                cv2.imwrite(str(tmp_path / split / c / f"{c}_{i}.JPEG"), rng.integers(0, 255, (40, 50, 3), np.uint8))
    cfg, jcfg = cfgs(["DATA.PATH_TO_DATA_DIR", str(tmp_path), "DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE",
                      "32", "MODEL.NUM_CLASSES", "2"])
    ours, theirs = loader.DATASET_REGISTRY["imagenet"](cfg, mode), jax_loader.DATASET_REGISTRY["imagenet"](jcfg, mode)
    assert ours._imdb == theirs._imdb and len(ours) == 4
    for index in range(len(ours)):
        items = []
        for ds in (ours, theirs):
            random.seed(index)
            np.random.seed(index)
            items.append(ds[index])
        _assert_same(items[0], items[1], f"{mode} {index}")


# ------------------------------------------------------------ cv2_transform


def _imgs(n=3, h=24, w=32, seed=0, chw=False):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 255, (3, h, w) if chw else (h, w, 3)).astype(np.float32) for _ in range(n)]


def _boxes(seed=1, n=3, h=24, w=32):
    rng = np.random.default_rng(seed)
    x1, y1 = rng.uniform(0, w / 2, n), rng.uniform(0, h / 2, n)
    return np.stack([x1, y1, x1 + rng.uniform(1, w / 2, n), y1 + rng.uniform(1, h / 2, n)], 1).astype(np.float32)


EIG = ([0.225, 0.224, 0.229], [[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.814], [-0.5836, -0.6948, 0.4203]])
# (function, calls: each a function of nothing that returns fresh arguments;
# in-place functions get fresh copies every call)
CV2_CALLS = {
    "clip_boxes_to_image": [lambda: (_boxes() * 2 - 5, 24, 32)],
    "flip_boxes": [lambda: (_boxes(), 32)],
    "crop_boxes": [lambda: (_boxes(), 3, 4)],
    "scale_boxes": [lambda: (16, _boxes(), 24, 32), lambda: (24, _boxes(), 24, 32), lambda: (20, _boxes(), 40, 30)],
    "revert_scaled_boxes": [lambda: (16, _boxes(), 24, 32)],
    "scale": [lambda: (16, _imgs(1)[0]), lambda: (24, _imgs(1)[0]), lambda: (20, _imgs(1, 40, 30)[0])],
    "random_short_side_scale_jitter_list": [lambda: (_imgs(), 16, 40, [_boxes()]), lambda: (_imgs(), 24, 24, None)],
    "random_scale_jitter": [lambda: (_imgs(1)[0], 16, 40)],
    "random_scale_jitter_list": [lambda: (_imgs(), 16, 40)],
    "horizontal_flip": [lambda: (0.5, _imgs(1, chw=True)[0], "CHW"), lambda: (1.0, _imgs(1)[0], "HWC"),
                        lambda: (0.0, _imgs(1)[0], "HWC")],
    "horizontal_flip_list": [lambda: (1.0, _imgs(chw=True), "CHW", [_boxes()]),
                             lambda: (1.0, _imgs(), "HWC", [_boxes()]), lambda: (0.0, _imgs(), "HWC", None)],
    "spatial_shift_crop_list": [lambda p=p, hw=hw: (16, _imgs(2, *hw), p, [_boxes()])
                                for p in (0, 1, 2) for hw in ((24, 32), (32, 24))],
    "pad_image": [lambda: (_imgs(1, chw=True)[0], 2, "CHW"), lambda: (_imgs(1)[0], 3, "HWC")],
    "random_crop_list": [lambda: (_imgs(chw=True), 16, 2, "CHW", [_boxes()]), lambda: (_imgs(), 16, 0, "HWC", None),
                         lambda: (_imgs(2, 16, 16), 16, 0, "HWC", None)],
    "center_crop": [lambda: (16, _imgs(1)[0])],
    "random_sized_crop": [lambda: (_imgs(1)[0], 16, 0.08), lambda: (_imgs(1)[0], 16, 0.99)],
    "random_sized_crop_list": [lambda: (_imgs(), 16, 0.08), lambda: (_imgs(), 16, 0.99)],
    "CHW2HWC": [lambda: (_imgs(1, chw=True)[0],)],
    "HWC2CHW": [lambda: (_imgs(1)[0],)],
    "blend": [lambda: (_imgs(1)[0], _imgs(1, seed=2)[0], 0.3)],
    "grayscale": [lambda: (_imgs(1, chw=True)[0],)],
    "saturation": [lambda: (0.4, _imgs(1, chw=True)[0])],
    "brightness": [lambda: (0.4, _imgs(1, chw=True)[0])],
    "contrast": [lambda: (0.4, _imgs(1, chw=True)[0])],
    "saturation_list": [lambda: (0.4, _imgs(chw=True))],
    "brightness_list": [lambda: (0.4, _imgs(chw=True))],
    "contrast_list": [lambda: (0.4, _imgs(chw=True))],
    "color_jitter": [lambda: (_imgs(1, chw=True)[0], 0.4, 0.4, 0.4), lambda: (_imgs(1, chw=True)[0], 0, 0.4, 0),
                     lambda: (_imgs(1, chw=True)[0], 0, 0, 0)],
    "color_jitter_list": [lambda: (_imgs(chw=True), 0.4, 0.4, 0.4), lambda: (_imgs(chw=True), 0.4, 0, 0.4)],
    "lighting": [lambda: (_imgs(1, chw=True)[0], 0.1, *EIG), lambda: (_imgs(1, chw=True)[0], 0.0, *EIG)],
    "lighting_list": [lambda: (_imgs(chw=True), 0.1, *EIG), lambda: (_imgs(chw=True), 0.0, *EIG)],
    "color_normalization": [lambda: (_imgs(1, chw=True)[0], [0.45] * 3, [0.225] * 3)],
}


def test_cv2_transform_has_every_function_of_vtm():
    public = {n for n, f in vars(jax_cv2).items() if callable(f) and not n.startswith("_")
              and getattr(f, "__module__", "") == jax_cv2.__name__}
    ours = {n for n, f in vars(cv2_transform).items() if callable(f) and not n.startswith("_")
            and getattr(f, "__module__", "") == cv2_transform.__name__}
    assert public == ours == set(CV2_CALLS)


@pytest.mark.parametrize("name", sorted(CV2_CALLS))
def test_cv2_transform_matches_vtm(name):
    """Each call in both packages under ``np.random.seed(7)``, on fresh
    copies of the same arguments: equal exactly, and so is the state of
    numpy's generator after it (the same draws in the same order)."""
    for i, make in enumerate(CV2_CALLS[name]):
        np.random.seed(7)
        got = getattr(cv2_transform, name)(*make())
        after = np.random.random()
        np.random.seed(7)
        want = getattr(jax_cv2, name)(*make())
        assert np.random.random() == after, (name, i)
        _assert_same(got, want, f"{name}[{i}]")


# -------------------------------------------------------------------- AVA


def test_helpers_match_vtm(tree):
    """The frame lists, the box files (train, val at the mini rate 4 and with
    FULL_TEST_ON_VAL, test), the keyframes and the frame windows."""
    cfg, jcfg = _ava_cfgs(tree, "AVA.TRAIN_PREDICT_BOX_LISTS", "['ava_train_predicted_boxes.csv']")
    for is_train in (True, False):
        _assert_same(ava.load_image_lists(cfg, is_train), jax_ava.load_image_lists(jcfg, is_train))
    ann = tree / "annotations"
    files = [str(ann / "ava_train_v2.2.csv"), str(ann / "ava_val_predicted_boxes.csv")]
    for rate in (1, 4):
        for thresh in (0.8, 0.5):
            got = ava.parse_bboxes_file(files, [True, False], thresh, rate)
            assert got == jax_ava.parse_bboxes_file(files, [True, False], thresh, rate)
    full = cfgs(conv_opts("SlowFast", "slowfast") + ava_data_opts(tree) + ["AVA.FULL_TEST_ON_VAL", "True"])
    seen = {}
    for c, jc, tag in ((cfg, jcfg, "mini"), (*full, "full")):
        for mode in ("train", "val", "test"):
            got = ava.load_boxes_and_labels(c, mode)
            assert got == jax_ava.load_boxes_and_labels(jc, mode), (tag, mode)
            seen[tag, mode] = got
    kept = {sec for v in seen["mini", "val"].values() for sec, b in v.items() if b}
    assert kept == {s for s in SECS if s % 4 == 0}  # the val split's boxes_sample_rate 4
    assert {sec for v in seen["full", "val"].values() for sec, b in v.items() if b} == set(SECS)
    # the predicted boxes below the threshold are dropped: one box fewer a keyframe
    n_pred = sum(len(b) for v in seen["full", "test"].values() for b in v.values())
    assert n_pred == len((ann / "ava_val_predicted_boxes.csv").read_text().splitlines()) - 2 * len(SECS)
    videos = [seen["full", "train"][n] for n in ("vid0", "vid1")]
    _assert_same(ava.get_keyframe_data(videos), jax_ava.get_keyframe_data(videos))
    for center, half, rate, n in ((60, 8, 2, 160), (2, 8, 2, 160), (158, 16, 4, 160), (10, 3, 1, 12)):
        assert ava.get_sequence(center, half, rate, n) == jax_ava.get_sequence(center, half, rate, n)
    assert ava.sec_to_frame(905) == jax_ava.sec_to_frame(905) == 150


SPLIT_OPTS = {
    "train": (),
    "train_color": ("AVA.TRAIN_USE_COLOR_AUGMENTATION", "True", "AVA.TRAIN_PCA_JITTER_ONLY", "False"),
    "train_pca": ("AVA.TRAIN_USE_COLOR_AUGMENTATION", "True", "DATA.RANDOM_FLIP", "False"),
    "val": (),
    "test": (),
    "test_flip_bgr": ("AVA.TEST_FORCE_FLIP", "True", "AVA.BGR", "True"),
}


@pytest.mark.parametrize("case", sorted(SPLIT_OPTS))
def test_items_match_vtm(tree, case):
    """Every item of the split in both packages, under the same ``random``
    and ``np.random`` seeds: frames, labels, boxes, original boxes,
    metadata and the index, equal exactly."""
    split = case.split("_")[0]
    cfg, jcfg = _ava_cfgs(tree, *SPLIT_OPTS[case])
    ours, theirs = ava.Ava(cfg, split), jax_ava.Ava(jcfg, split)
    assert len(ours) == len(theirs) == (2 if split == "val" else 2 * len(SECS))
    assert ours._video_idx_to_name == theirs._video_idx_to_name == ["vid0", "vid1"]
    for index in range(len(ours)):
        items = []
        for ds in (ours, theirs):
            random.seed(index)
            np.random.seed(index)
            items.append(ds[index])
        got, want = items
        _assert_same(got, want, f"{case} {index}")
        n = len(got["boxes"])
        assert got["label"].shape == (n, CLASSES) and got["metadata"].shape == (n, 2)
        crop = cfg.DATA.TRAIN_CROP_SIZE if split == "train" else cfg.DATA.TEST_CROP_SIZE
        t, h, w, _ = got["frames"].shape
        assert t == cfg.DATA.NUM_FRAMES and h == crop and w == (crop if split != "test" else 48)
        assert (got["boxes"][:, [0, 2]] <= w - 1).all() and (got["boxes"][:, [1, 3]] <= h - 1).all()


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_collated_batches_match_vtm(tree, split):
    """The loaders' batches (B3, one worker): the detection collate's
    frames, the boxes and original boxes with their batch-index column, the
    labels and metadata concatenated in item order."""
    cfg, jcfg = _ava_cfgs(tree, "TRAIN.BATCH_SIZE", "3", "TEST.BATCH_SIZE", "3")
    batches = []
    for construct in (loader.construct_loader, jax_loader.construct_loader):
        random.seed(5)
        np.random.seed(5)
        batches.append(list(construct(cfg if construct is loader.construct_loader else jcfg, split)))
    assert len(batches[0]) == len(batches[1]) >= 1
    for i, (got, want) in enumerate(zip(*batches)):
        _assert_same(got, want, f"{split} batch {i}")
        assert set(got) == {"frames", "index", "label", "boxes", "ori_boxes", "metadata"}
        assert got["boxes"].shape[1] == 5 and set(got["boxes"][:, 0]) <= set(range(len(got["index"])))


def test_chip_smoke_ava_tree_and_opts(tmp_path):
    """chip_smoke's ``ava`` phase: ``AVA_OPTS`` changes the SlowFast config
    in the keys of PySlowFast's AVA SlowFast 32x2 R50 shape only, and the
    tree ``write_ava`` writes reads as the phase counts on it: 16 keyframes
    whose 64-frame windows lie in the list, predicted boxes above the
    threshold only, the val split's ``sec % 4 == 0`` keyframes, 60 of 80
    classes evaluated, one excluded keyframe."""
    import chip_smoke
    from vtm_torch.eval import ava_eval

    opts = chip_smoke.write_ava(tmp_path)
    cfg, base = chip_smoke.ava_cfg(*opts), chip_smoke.sf_cfg().to_dict()
    changed = {f"{sec}.{k}" for sec, node in chip_smoke.ava_cfg().to_dict().items() if isinstance(node, dict)
               for k, v in node.items() if base[sec][k] != v}
    assert changed == {"TRAIN.DATASET", "TEST.DATASET", "DATA.TEST_CROP_SIZE", "RESNET.SPATIAL_STRIDES",
                       "RESNET.SPATIAL_DILATIONS", "DETECTION.ENABLE", "MODEL.NUM_CLASSES", "MODEL.HEAD_ACT",
                       "MODEL.LOSS_FUNC", "AVA.DETECTION_SCORE_THRESH"}
    test, val, train = (ava.Ava(cfg, split) for split in ("test", "val", "train"))
    assert (len(test), len(val), len(train)) == (16, 4, 16)
    assert all(len(paths) == chip_smoke.AVA_FRAMES for paths in test._image_paths)
    for _, _, _, center in test._keyframe_indices:
        seq = ava.get_sequence(center, 32, 2, chip_smoke.AVA_FRAMES)
        assert seq == list(range(center - 32, center + 32, 2))
    pred = (tmp_path / "annotations" / "ava_val_predicted_boxes.csv").read_text().splitlines()
    kept = sum(len(b) for video in test._keyframe_boxes_and_labels for b in video)
    assert kept == len(pred) - 16 == sum(float(r.split(",")[-1]) >= 0.8 for r in pred)
    categories, ids = ava_eval.read_labelmap(str(tmp_path / "annotations" / "labels.pbtxt"))
    assert len(ids) == 60 and ids <= set(range(1, 81))
    assert ava_eval.read_exclusions(str(tmp_path / "annotations" / "exclusions.csv")) == {"ava002,0903"}
    item = test[0]
    assert item["frames"].shape == (32, 224, 297, 3) and item["label"].shape[1] == 80
