"""Test, train and validation meters (copy of ``TestMeter``,
``EPICTestMeter``, ``ScalarMeter``, ``TrainMeter``, ``ValMeter``,
``EPICTrainMeter``, ``EPICValMeter`` and ``EpochTimer`` of
``vtm/eval/meters.py``). Stats are numpy, host-side.

``TestMeter`` accumulates multi-view clip predictions into per-video
ensembles in fp64 (sum or max) and finalises top-k accuracies as
``"%.2f"`` strings, or the mAP for multi-label data; ``EPICTestMeter``
keeps the verb/noun pair and reports verb/noun/action top-1/5.
``TEST.CLIP_LENGTH_HISTOGRAM`` also writes each video's (length,
outcome) csv from the lengths ``analysis.dataset_tools.save_lengths``
cached. The detection meter is not ported."""

from __future__ import annotations

import datetime
from collections import deque
from typing import Dict, Tuple

import numpy as np

from vtm_torch.eval import metrics
from vtm_torch.utils.logging import get_logger, log_json_stats
from vtm_torch.utils.timer import Timer

logger = get_logger(__name__)


def get_map(preds: np.ndarray, labels: np.ndarray) -> float:
    """Multi-label mAP (reference meters.py:874-900): classes with no
    positive example anywhere are dropped, then macro-averaged
    average-precision over the rest."""
    from sklearn.metrics import average_precision_score

    keep = ~np.all(labels == 0, axis=0)
    preds, labels = preds[:, keep], labels[:, keep]
    try:
        aps = average_precision_score(labels, preds, average=None)
    except ValueError:
        logger.warning(
            "Average precision requires a sufficient number of samples; "
            "returning 0"
        )
        aps = np.array([0.0])
    return float(np.mean(aps))


class TestMeter:
    def __init__(
        self,
        num_videos: int,
        num_clips: int,
        num_cls: int,
        overall_iters: int,
        multi_view_ensemble_method: str = "sum",
        cfg=None,
        multi_label: bool = False,
    ):
        self.cfg = cfg
        self.num_clips = num_clips
        self.overall_iters = overall_iters
        self.ensemble_method = multi_view_ensemble_method
        self.multi_label = multi_label
        self.video_preds = np.zeros((num_videos, num_cls), dtype=np.float64)
        if multi_label:
            # a -1e10 floor so "max" ensembling starts below any real
            # logit (constant per video, rank-invariant for the mAP under
            # "sum")
            self.video_preds -= 1e10
        self.video_labels = (
            np.zeros((num_videos, num_cls), dtype=np.float64)
            if multi_label
            else np.zeros((num_videos,), dtype=np.int64)
        )
        self.clip_count = np.zeros((num_videos,), dtype=np.int64)
        self.iter_timer = Timer()
        self.data_timer = Timer()
        self.net_timer = Timer()
        self.stats: Dict[str, object] = {}

    def reset(self):
        self.video_preds[:] = 0
        if self.multi_label:
            self.video_preds -= 1e10
        self.video_labels[:] = 0
        self.clip_count[:] = 0

    def update_stats(self, preds: np.ndarray, labels: np.ndarray, clip_ids: np.ndarray):
        """preds [N, C]; clip_ids are global clip indices: video index =
        clip_id // num_clips. Multi-label labels are [N, C] multi-hot
        vectors."""
        for i in range(preds.shape[0]):
            vid_id = int(clip_ids[i]) // self.num_clips
            if self.multi_label:
                if self.video_labels[vid_id].sum() > 0:
                    assert np.array_equal(self.video_labels[vid_id], labels[i])
                self.video_labels[vid_id] = labels[i]
            else:
                if self.clip_count[vid_id] > 0:
                    assert self.video_labels[vid_id] == int(labels[i])
                self.video_labels[vid_id] = int(labels[i])
            if self.ensemble_method == "sum":
                self.video_preds[vid_id] += preds[i]
            elif self.ensemble_method == "max":
                self.video_preds[vid_id] = np.maximum(self.video_preds[vid_id], preds[i])
            else:
                raise NotImplementedError(self.ensemble_method)
            self.clip_count[vid_id] += 1

    def log_iter_stats(self, cur_iter: int):
        eta_sec = self.iter_timer.seconds() * (self.overall_iters - cur_iter)
        stats = {
            "split": "test_iter",
            "cur_iter": f"{cur_iter + 1}",
            "eta": str(datetime.timedelta(seconds=int(eta_sec))),
            "time_diff": self.iter_timer.seconds(),
        }
        log_json_stats(stats, logger)

    def iter_tic(self):
        self.iter_timer.reset()
        self.data_timer.reset()

    def iter_toc(self):
        self.iter_timer.pause()
        self.net_timer.pause()

    def data_toc(self):
        self.data_timer.pause()
        self.net_timer.reset()

    def finalize_metrics(self, ks=(1, 5)) -> Dict[str, object]:
        if not np.all(self.clip_count == self.num_clips):
            logger.warning(
                "clip count %s ~= num clips %s",
                ", ".join(
                    f"{i}: {c}"
                    for i, c in enumerate(self.clip_count)
                    if c != self.num_clips
                ),
                self.num_clips,
            )
        stats = {"split": "test_final"}
        if self.multi_label:
            # the mAP as the metric, reported under map AND top1/top5 keys
            mean_ap = get_map(self.video_preds, self.video_labels)
            map_str = f"{mean_ap * 100.0:.2f}"
            stats["map"] = map_str
            stats["top1_acc"] = map_str
            stats["top5_acc"] = map_str
        else:
            num_topks = metrics.topks_correct(self.video_preds, self.video_labels, ks)
            topks = [x / self.video_preds.shape[0] * 100.0 for x in num_topks]
            for k, topk in zip(ks, topks):
                stats[f"top{k}_acc"] = f"{topk:.2f}"
        if self.cfg is not None and self.cfg.TEST.CLIP_LENGTH_HISTOGRAM:
            self._write_length_histogram()
        log_json_stats(stats, logger)
        self.stats = stats
        return stats


    def _write_length_histogram(self):
        """Per-video (length, outcome) csv for accuracy-vs-length curves,
        beside the data as ``<checkpoint stem>_r_<R_VALUE>.csv``."""
        from vtm_torch.analysis.dataset_tools import load_lengths

        lengths = load_lengths(self.cfg)
        outcomes = self.video_preds.argmax(axis=-1) == self.video_labels
        n = min(len(lengths), len(outcomes))
        df = lengths.iloc[:n].assign(outcome=outcomes[:n])
        stem = (
            self.cfg.TEST.CHECKPOINT_FILE_PATH.split("/")[-1].split(".")[0]
            or "random_init"
        )
        out = f"{self.cfg.DATA.PATH_TO_DATA_DIR}/{stem}_r_{self.cfg.TOME.R_VALUE}.csv"
        df.to_csv(out, index=False)
        logger.info("clip-length histogram -> %s", out)


class EPICTestMeter:
    """Verb/noun/action multi-view ensembling."""

    def __init__(
        self,
        num_videos: int,
        num_clips: int,
        num_cls: Tuple[int, int],
        overall_iters: int,
        multi_view_ensemble_method: str = "sum",
    ):
        self.num_clips = num_clips
        self.overall_iters = overall_iters
        self.ensemble_method = multi_view_ensemble_method
        self.verb_preds = np.zeros((num_videos, num_cls[0]), dtype=np.float64)
        self.noun_preds = np.zeros((num_videos, num_cls[1]), dtype=np.float64)
        self.verb_labels = np.zeros((num_videos,), dtype=np.int64)
        self.noun_labels = np.zeros((num_videos,), dtype=np.int64)
        self.metadata = np.empty(num_videos, dtype=object)
        self.clip_count = np.zeros((num_videos,), dtype=np.int64)
        self.iter_timer = Timer()
        self.data_timer = Timer()
        self.net_timer = Timer()
        self.stats: Dict[str, object] = {}

    def reset(self):
        self.verb_preds[:] = 0
        self.noun_preds[:] = 0
        self.verb_labels[:] = 0
        self.noun_labels[:] = 0
        self.metadata[:] = None
        self.clip_count[:] = 0

    def update_stats(self, preds, labels, metadata, clip_ids):
        verb_p, noun_p = preds
        verb_l, noun_l = labels
        for i in range(verb_p.shape[0]):
            vid_id = int(clip_ids[i]) // self.num_clips
            self.verb_labels[vid_id] = int(verb_l[i])
            self.noun_labels[vid_id] = int(noun_l[i])
            if metadata is not None:
                self.metadata[vid_id] = metadata[i]
            if self.ensemble_method == "sum":
                self.verb_preds[vid_id] += verb_p[i]
                self.noun_preds[vid_id] += noun_p[i]
            elif self.ensemble_method == "max":
                self.verb_preds[vid_id] = np.maximum(self.verb_preds[vid_id], verb_p[i])
                self.noun_preds[vid_id] = np.maximum(self.noun_preds[vid_id], noun_p[i])
            else:
                # a max fallback on zero-initialised preds would clamp
                # negative logits and report wrong-but-plausible numbers
                raise NotImplementedError(self.ensemble_method)
            self.clip_count[vid_id] += 1

    iter_tic = TestMeter.iter_tic
    iter_toc = TestMeter.iter_toc
    data_toc = TestMeter.data_toc
    log_iter_stats = TestMeter.log_iter_stats

    def finalize_metrics(self, ks=(1, 5)) -> Dict[str, object]:
        if not np.all(self.clip_count == self.num_clips):
            logger.warning("incomplete clip counts at finalize")
        stats = {"split": "test_final"}
        verb_topks = metrics.topk_accuracies(self.verb_preds, self.verb_labels, ks)
        noun_topks = metrics.topk_accuracies(self.noun_preds, self.noun_labels, ks)
        action_topks = metrics.multitask_topk_accuracies(
            (self.verb_preds, self.noun_preds), (self.verb_labels, self.noun_labels), ks
        )
        for k, v, n, a in zip(ks, verb_topks, noun_topks, action_topks):
            stats[f"verb_top{k}_acc"] = f"{v:.2f}"
            stats[f"noun_top{k}_acc"] = f"{n:.2f}"
            stats[f"action_top{k}_acc"] = f"{a:.2f}"
        log_json_stats(stats, logger)
        self.stats = stats
        return stats


class ScalarMeter:
    """Windowed scalar tracking (reference meters.py ScalarMeter)."""

    def __init__(self, window_size: int = 10):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def reset(self):
        self.deque.clear()
        self.total = 0.0
        self.count = 0

    def add_value(self, value: float):
        self.deque.append(value)
        self.count += 1
        self.total += value

    def get_win_median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    def get_win_avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    def get_global_avg(self) -> float:
        return self.total / max(self.count, 1)


class TrainMeter:
    """Training progress meter (reference meters.py TrainMeter)."""

    def __init__(self, epoch_iters: int, cfg):
        self.cfg = cfg
        self.epoch_iters = epoch_iters
        self.max_iter = cfg.SOLVER.MAX_EPOCH * epoch_iters
        self.iter_timer = Timer()
        self.data_timer = Timer()
        self.net_timer = Timer()
        self.loss = ScalarMeter(cfg.LOG_PERIOD)
        self.loss_total = 0.0
        self.lr = None
        self.num_top1_mis = 0
        self.num_top5_mis = 0
        self.num_samples = 0

    def reset(self):
        self.loss.reset()
        self.loss_total = 0.0
        self.num_top1_mis = 0
        self.num_top5_mis = 0
        self.num_samples = 0

    def iter_tic(self):
        self.iter_timer.reset()
        self.data_timer.reset()

    def iter_toc(self):
        self.iter_timer.pause()
        self.net_timer.pause()

    def data_toc(self):
        self.data_timer.pause()
        self.net_timer.reset()

    def update_stats(self, top1_err, top5_err, loss, lr, mb_size):
        self.loss.add_value(loss)
        self.lr = lr
        self.loss_total += loss * mb_size
        if top1_err is not None:
            # multi-label (charades) training tracks loss only
            # (reference train_net.py:286-293 passes no errors)
            self.num_top1_mis += top1_err * mb_size
            self.num_top5_mis += top5_err * mb_size
            self.has_errors = True
        self.num_samples += mb_size

    def log_epoch_stats(self, cur_epoch: int):
        if self.num_samples == 0:
            return
        stats = {
            "split": "train_epoch",
            "epoch": f"{cur_epoch + 1}/{self.cfg.SOLVER.MAX_EPOCH}",
            "loss": self.loss_total / self.num_samples,
            "lr": self.lr,
        }
        if getattr(self, "has_errors", False):
            stats["top1_err"] = self.num_top1_mis / self.num_samples
            stats["top5_err"] = self.num_top5_mis / self.num_samples
        log_json_stats(stats, logger)

    def log_iter_stats(self, cur_epoch: int, cur_iter: int):
        if (cur_iter + 1) % self.cfg.LOG_PERIOD != 0:
            return
        stats = {
            "split": "train_iter",
            "epoch": f"{cur_epoch + 1}/{self.cfg.SOLVER.MAX_EPOCH}",
            "iter": f"{cur_iter + 1}/{self.epoch_iters}",
            "loss": self.loss.get_win_median(),
            "lr": self.lr,
            "time_diff": self.iter_timer.seconds(),
        }
        log_json_stats(stats, logger)


class ValMeter:
    """Validation meter (reference meters.py ValMeter)."""

    def __init__(self, max_iter: int, cfg):
        self.cfg = cfg
        self.max_iter = max_iter
        self.iter_timer = Timer()
        self.data_timer = Timer()
        self.net_timer = Timer()
        self.num_top1_mis = 0
        self.num_top5_mis = 0
        self.num_samples = 0
        self.min_top1_err = 100.0
        self.all_preds = []
        self.all_labels = []

    def reset(self):
        self.num_top1_mis = 0
        self.num_top5_mis = 0
        self.num_samples = 0
        self.all_preds = []
        self.all_labels = []

    iter_tic = TrainMeter.iter_tic
    iter_toc = TrainMeter.iter_toc
    data_toc = TrainMeter.data_toc

    def update_stats(self, top1_err, top5_err, mb_size):
        self.num_top1_mis += top1_err * mb_size
        self.num_top5_mis += top5_err * mb_size
        self.num_samples += mb_size

    def update_predictions(self, preds, labels):
        """Full prediction/label capture for the multi-label mAP epoch
        metric (reference meters.py:802-811)."""
        self.all_preds.append(np.asarray(preds))
        self.all_labels.append(np.asarray(labels))

    def log_epoch_stats(self, cur_epoch: int):
        stats = {
            "split": "val_epoch",
            "epoch": f"{cur_epoch + 1}/{self.cfg.SOLVER.MAX_EPOCH}",
        }
        if self.cfg.DATA.MULTI_LABEL:
            if not self.all_preds:
                return {}
            stats["map"] = get_map(
                np.concatenate(self.all_preds), np.concatenate(self.all_labels)
            )
        else:
            if self.num_samples == 0:
                return {}
            top1 = self.num_top1_mis / self.num_samples
            self.min_top1_err = min(self.min_top1_err, top1)
            stats["top1_err"] = top1
            stats["top5_err"] = self.num_top5_mis / self.num_samples
            stats["min_top1_err"] = self.min_top1_err
        log_json_stats(stats, logger)
        return stats


class EPICTrainMeter:
    """EPIC-KITCHENS training meter: verb/noun/action losses and
    accuracies (reference meters.py EPICTrainMeter)."""

    def __init__(self, epoch_iters: int, cfg):
        self.cfg = cfg
        self.epoch_iters = epoch_iters
        self.iter_timer = Timer()
        self.data_timer = Timer()
        self.net_timer = Timer()
        self.loss = ScalarMeter(cfg.LOG_PERIOD)
        self.loss_verb = ScalarMeter(cfg.LOG_PERIOD)
        self.loss_noun = ScalarMeter(cfg.LOG_PERIOD)
        self.lr = None
        self.reset()

    def reset(self):
        for m in (self.loss, self.loss_verb, self.loss_noun):
            m.reset()
        self.totals = np.zeros(3)  # verb/noun/action loss sums
        self.correct = np.zeros((3, 2))  # [verb,noun,action] x [top1,top5]
        self.num_samples = 0

    iter_tic = TrainMeter.iter_tic
    iter_toc = TrainMeter.iter_toc
    data_toc = TrainMeter.data_toc

    def update_stats(self, accuracies, losses, lr, mb_size):
        """accuracies: ((v1,v5),(n1,n5),(a1,a5)) in %, losses:
        (verb, noun, total)."""
        (v1, v5), (n1, n5), (a1, a5) = accuracies
        lv, ln, lt = losses
        self.loss_verb.add_value(lv)
        self.loss_noun.add_value(ln)
        self.loss.add_value(lt)
        self.lr = lr
        self.totals += np.array([lv, ln, lt]) * mb_size
        self.correct += (
            np.array([[v1, v5], [n1, n5], [a1, a5]]) / 100.0 * mb_size
        )
        self.num_samples += mb_size

    def log_iter_stats(self, cur_epoch: int, cur_iter: int):
        if (cur_iter + 1) % self.cfg.LOG_PERIOD != 0:
            return
        log_json_stats(
            {
                "split": "train_iter",
                "epoch": f"{cur_epoch + 1}/{self.cfg.SOLVER.MAX_EPOCH}",
                "iter": f"{cur_iter + 1}/{self.epoch_iters}",
                "verb_loss": self.loss_verb.get_win_median(),
                "noun_loss": self.loss_noun.get_win_median(),
                "loss": self.loss.get_win_median(),
                "lr": self.lr,
                "time_diff": self.iter_timer.seconds(),
            },
            logger,
        )

    def log_epoch_stats(self, cur_epoch: int):
        if self.num_samples == 0:
            return
        acc = self.correct / self.num_samples * 100.0
        log_json_stats(
            {
                "split": "train_epoch",
                "epoch": f"{cur_epoch + 1}/{self.cfg.SOLVER.MAX_EPOCH}",
                "verb_top1_acc": acc[0, 0],
                "verb_top5_acc": acc[0, 1],
                "noun_top1_acc": acc[1, 0],
                "noun_top5_acc": acc[1, 1],
                "top1_acc": acc[2, 0],
                "top5_acc": acc[2, 1],
                "verb_loss": self.totals[0] / self.num_samples,
                "noun_loss": self.totals[1] / self.num_samples,
                "loss": self.totals[2] / self.num_samples,
                "lr": self.lr,
            },
            logger,
        )


class EPICValMeter:
    """EPIC-KITCHENS validation meter (reference meters.py EPICValMeter)."""

    def __init__(self, max_iter: int, cfg):
        self.cfg = cfg
        self.max_iter = max_iter
        self.iter_timer = Timer()
        self.data_timer = Timer()
        self.net_timer = Timer()
        self.max_top1_acc = -1.0
        self.reset()

    def reset(self):
        self.correct = np.zeros((3, 2))
        self.num_samples = 0

    iter_tic = TrainMeter.iter_tic
    iter_toc = TrainMeter.iter_toc
    data_toc = TrainMeter.data_toc

    def update_stats(self, accuracies, mb_size):
        (v1, v5), (n1, n5), (a1, a5) = accuracies
        self.correct += (
            np.array([[v1, v5], [n1, n5], [a1, a5]]) / 100.0 * mb_size
        )
        self.num_samples += mb_size

    def log_epoch_stats(self, cur_epoch: int):
        if self.num_samples == 0:
            return {}
        acc = self.correct / self.num_samples * 100.0
        is_best = acc[2, 0] > self.max_top1_acc
        self.max_top1_acc = max(self.max_top1_acc, acc[2, 0])
        stats = {
            "split": "val_epoch",
            "epoch": f"{cur_epoch + 1}/{self.cfg.SOLVER.MAX_EPOCH}",
            "verb_top1_acc": acc[0, 0],
            "verb_top5_acc": acc[0, 1],
            "noun_top1_acc": acc[1, 0],
            "noun_top5_acc": acc[1, 1],
            "top1_acc": acc[2, 0],
            "top5_acc": acc[2, 1],
            "max_top1_acc": self.max_top1_acc,
            "is_best_epoch": bool(is_best),
        }
        log_json_stats(stats, logger)
        return stats


class EpochTimer:
    """Per-epoch wall timing."""

    def __init__(self):
        self.timer = Timer()
        self.epoch_durations = []

    def reset(self):
        self.timer.reset()
        self.epoch_durations = []

    def epoch_tic(self):
        self.timer.reset()

    def epoch_toc(self):
        self.timer.pause()
        self.epoch_durations.append(self.timer.seconds())

    def last_epoch_time(self):
        return self.epoch_durations[-1]

    def avg_epoch_time(self):
        return float(np.mean(self.epoch_durations))

    def median_epoch_time(self):
        return float(np.median(self.epoch_durations))
