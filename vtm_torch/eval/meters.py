"""Train and validation meters (copy of ``ScalarMeter``, ``TrainMeter``,
``ValMeter``, ``EPICTrainMeter`` and ``EPICValMeter`` of
``vtm/eval/meters.py``). Stats are numpy, host-side. The test and
detection meters are ported with the test entry point."""

from __future__ import annotations

from collections import deque

import numpy as np

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
