"""The port's AVA frame-mAP evaluator (``vtm_torch/eval/ava_eval.py``) and
``AVAMeter`` (``eval/meters.py``) against ``vtm``'s on the CPU:
``PascalDetectionEvaluator`` on seeded random scenes (near hits, misses,
difficult boxes, score ties, classes without ground truth) within MAP_TOL;
``read_csv``, ``read_exclusions``, ``read_labelmap``, ``get_ava_eval_data``,
``run_evaluation`` and ``evaluate_ava`` on arrays, the written
``detections_latest.csv`` and ``groundtruth_latest.csv`` equal byte for
byte; ``AVAMeter`` in test, val (the mini ground truth, and the full one
under ``AVA.FULL_TEST_ON_VAL``) and train mode fed the same batches. A few
seconds."""

import numpy as np
import pytest

import vtm.eval.ava_eval as jax_ava_eval
import vtm.eval.meters as jax_meters

import vtm_torch.eval.meters as meters
from vtm_torch.eval import ava_eval

from torch_ava_cases import SECS, ava_data_opts, conv_opts, write_ava_tree
from torch_conv_cases import cfgs

MAP_TOL = 1e-12


def _scene(rng, images: int = 8, classes: int = 5, ties: bool = False, difficult: bool = False):
    """Ground truth and detections per image key: detections copied from
    ground truth with jitter (hits), with another class, or drawn at random
    (misses); scores rounded to quarters under ``ties``."""
    gts, dets = {}, {}
    for i in range(images):
        key = f"vid,{i:04d}"
        n_gt = int(rng.integers(1, 5))
        y1x1 = rng.random((n_gt, 2)) * 0.5
        boxes = np.concatenate([y1x1, y1x1 + rng.random((n_gt, 2)) * 0.4 + 0.1], axis=1)
        labels = rng.integers(1, classes, n_gt)  # the last class has no ground truth
        hard = rng.random(n_gt) < 0.2 if difficult else None
        gts[key] = (boxes, labels, hard)
        d_boxes, d_labels = [], []
        for _ in range(int(rng.integers(1, 9))):
            if rng.random() < 0.6:
                j = int(rng.integers(0, n_gt))
                d_boxes.append(boxes[j] + rng.normal(0, 0.02, 4))
                d_labels.append(labels[j] if rng.random() < 0.8 else int(rng.integers(1, classes + 1)))
            else:
                p = rng.random(2) * 0.5
                d_boxes.append(np.concatenate([p, p + rng.random(2) * 0.4 + 0.05]))
                d_labels.append(int(rng.integers(1, classes + 1)))
        scores = rng.random(len(d_boxes))
        if ties:
            scores = np.round(scores * 4) / 4
        dets[key] = (np.asarray(d_boxes), np.asarray(d_labels), scores)
    return gts, dets


@pytest.mark.parametrize("seed, ties, difficult", [(0, False, False), (1, True, False), (2, True, True),
                                                   (3, False, True), (4, True, False)])
def test_pascal_evaluator_matches_vtm(seed, ties, difficult):
    rng = np.random.default_rng(seed)
    categories = [{"id": c, "name": f"class{c}"} for c in range(1, 6)]
    gts, dets = _scene(rng, ties=ties, difficult=difficult)
    results = []
    for mod in (ava_eval, jax_ava_eval):
        ev = mod.PascalDetectionEvaluator(categories)
        for key, (boxes, labels, hard) in gts.items():
            ev.add_single_ground_truth_image_info(key, boxes, labels, hard)
        for key, (boxes, labels, scores) in dets.items():
            ev.add_single_detected_image_info(key, boxes, labels, scores)
        results.append(ev.evaluate())
    got, want = results
    assert list(got) == list(want) and len(got) == 5  # the mAP and 4 classes with ground truth
    for k in want:
        assert abs(got[k] - want[k]) <= MAP_TOL, (k, got[k], want[k])
    assert 0.0 <= got["PascalBoxes_Precision/mAP@0.5IOU"] <= 1.0


def test_iou_and_average_precision_match_vtm():
    rng = np.random.default_rng(5)
    a, b = rng.random((6, 4)), rng.random((4, 4))
    a[:, 2:] += a[:, :2]
    b[:, 2:] += b[:, :2]
    b[1] = [0.2, 0.2, 0.2, 0.2]  # no area
    np.testing.assert_array_equal(ava_eval._iou_matrix(a, b), jax_ava_eval._iou_matrix(a, b))
    for n in (0, 1, 7):
        p, r = rng.random(n), np.sort(rng.random(n))
        assert ava_eval.compute_average_precision(p.copy(), r) == jax_ava_eval.compute_average_precision(p.copy(), r)


def _arrays(seed: int, n: int = 12, classes: int = 6):
    rng = np.random.default_rng(seed)
    preds = rng.random((n, classes))
    preds[::3, 0] = preds[1::3, 0][: len(preds[::3, 0])]  # tied scores
    x1, y1 = rng.random(n) * 0.4, rng.random(n) * 0.4
    boxes = np.stack([np.arange(n) % 2, x1, y1, x1 + 0.3 + rng.random(n) * 0.2, y1 + 0.3 + rng.random(n) * 0.2], 1)
    metadata = np.stack([np.arange(n) % 2, np.asarray(SECS)[np.arange(n) % len(SECS)]], 1)
    return preds, boxes, metadata


def test_files_and_evaluate_ava_match_vtm(tmp_path):
    """The csv readers on a written tree; ``get_ava_eval_data`` and
    ``evaluate_ava`` with an excluded keyframe and a class left out of the
    whitelist; the two csv files each package writes, byte for byte."""
    write_ava_tree(tmp_path)
    ann = tmp_path / "annotations"
    labelmap = ava_eval.read_labelmap(str(ann / "labels.pbtxt"))
    assert labelmap == jax_ava_eval.read_labelmap(str(ann / "labels.pbtxt"))
    categories, whitelist = labelmap
    excluded = ava_eval.read_exclusions(str(ann / "exclusions.csv"))
    assert excluded == jax_ava_eval.read_exclusions(str(ann / "exclusions.csv")) == {"vid1,0903"}
    assert ava_eval.read_exclusions("") == set()
    gt = ava_eval.read_csv(str(ann / "ava_val_v2.2.csv"), whitelist)
    assert gt == jax_ava_eval.read_csv(str(ann / "ava_val_v2.2.csv"), whitelist)
    pred_file = str(ann / "ava_val_predicted_boxes.csv")
    with open(pred_file) as f:
        rows = [r.replace(",,", ",1,") for r in f.read().splitlines()]
    (tmp_path / "scored.csv").write_text("\n".join(rows) + "\n")
    assert ava_eval.read_csv(str(tmp_path / "scored.csv"), None, load_score=True) == \
        jax_ava_eval.read_csv(str(tmp_path / "scored.csv"), None, load_score=True)
    preds, boxes, metadata = _arrays(6)
    names = ["vid0", "vid1"]
    assert ava_eval.get_ava_eval_data(preds, boxes, metadata, whitelist, names) == \
        jax_ava_eval.get_ava_eval_data(preds, boxes, metadata, whitelist, names)
    maps = []
    for name, mod in (("port", ava_eval), ("vtm", jax_ava_eval)):
        out = tmp_path / name
        out.mkdir()
        maps.append(mod.evaluate_ava(preds, boxes, metadata.tolist(), excluded, whitelist, categories,
                                     groundtruth=gt, video_idx_to_name=names, output_dir=str(out)))
    assert 0.0 <= maps[0] <= 1.0 and abs(maps[0] - maps[1]) <= MAP_TOL
    for f in ("detections_latest.csv", "groundtruth_latest.csv"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "vtm" / f).read_bytes(), f
    want = jax_ava_eval.run_evaluation(categories, gt, gt, excluded)
    got = ava_eval.run_evaluation(categories, gt, gt, excluded)
    assert got == want and got["PascalBoxes_Precision/mAP@0.5IOU"] == 1.0


@pytest.mark.parametrize("mode, full", [("test", False), ("val", False), ("val", True), ("train", False)])
def test_ava_meter_matches_vtm(tmp_path, mode, full):
    """Both meters fed the same three batches: test and val finalise to the
    same mAP and the same ``detections_latest.csv`` (val against the
    ``sec % 4 == 0`` ground truth unless FULL_TEST_ON_VAL); train keeps the
    loss and the lr only; ``reset`` empties them."""
    write_ava_tree(tmp_path)
    extra = ["AVA.FULL_TEST_ON_VAL", str(full), "LOG_PERIOD", "2"]
    cfg, jcfg = cfgs(conv_opts("SlowFast", "slowfast") + ava_data_opts(tmp_path) + extra)
    cfg.OUTPUT_DIR, jcfg.OUTPUT_DIR = str(tmp_path / "port"), str(tmp_path / "vtm")
    ours, theirs = meters.AVAMeter(3, cfg, mode), jax_meters.AVAMeter(3, jcfg, mode)
    for m in (ours, theirs):
        m.video_idx_to_name = ["vid0", "vid1"]
    assert ours.mini_groundtruth == theirs.mini_groundtruth and ours.full_groundtruth == theirs.full_groundtruth
    assert ours.excluded_keys == theirs.excluded_keys and ours.categories == theirs.categories
    for i in range(3):
        preds, boxes, metadata = _arrays(10 + i)
        for m in (ours, theirs):
            m.iter_tic()
            m.update_stats(preds, boxes, metadata, loss=0.5 + i, lr=0.1 * (i + 1))
            m.iter_toc()
            m.log_iter_stats(i)
    if mode == "train":
        assert ours.loss.get_win_median() == theirs.loss.get_win_median()
        assert (ours.loss_total, ours.num_samples, ours.lr) == (theirs.loss_total, theirs.num_samples, theirs.lr)
        assert ours.all_preds == theirs.all_preds == []
        ours.log_epoch_stats(0)
    else:
        for m in (ours, theirs):
            (tmp_path / ("port" if m is ours else "vtm")).mkdir()
        got, want = ours.finalize_metrics(), theirs.finalize_metrics()
        assert got["split"] == want["split"] == f"{mode}_final"
        assert 0.0 <= got["map"] <= 1.0 and abs(got["map"] - want["map"]) <= MAP_TOL
        for f in ("detections_latest.csv", "groundtruth_latest.csv"):
            assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "vtm" / f).read_bytes(), f
        lines = (tmp_path / "port" / "groundtruth_latest.csv").read_text().splitlines()
        gt_secs = {line.split(",")[1] for line in lines}
        assert gt_secs == ({f"{s:04d}" for s in SECS} if mode == "test" or full else {"0904"})
    for m in (ours, theirs):
        m.reset()
    assert ours.all_preds == [] and ours.num_samples == 0 and ours.loss_total == 0.0
