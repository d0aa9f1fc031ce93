"""Multigrid training schedule (Wu et al., 2019): copy of
``vtm/train/multigrid.py`` (upstream slowfast/utils/multigrid.py and the
short-cycle batch sizes of slowfast/datasets/multigrid_helper.py).

The long cycle changes cfg between epochs (``DATA.NUM_FRAMES``,
``DATA.TRAIN_CROP_SIZE``, ``TRAIN.BATCH_SIZE``, the BN settings). The conv
families' parameters do not depend on the shape, so they carry over: in
``vtm`` unchanged arrays, here the same ``Parameter`` objects, which the
optimizer and its momentum keep holding. ``adapt_batch_stats`` re-shapes the
module in place for the new cfg: each BatchNorm's splits (the eval
statistics carry over, split statistics of another count start from their
init) and each head's pool.
"""

from __future__ import annotations

import numpy as np
from torch import nn

from vtm_torch.utils.logging import get_logger

logger = get_logger(__name__)


class MultigridSchedule:
    """The reference schedule's arithmetic (multigrid.py:13-216)."""

    def init_multigrid(self, cfg):
        self.schedule = None
        cfg.MULTIGRID.DEFAULT_B = cfg.TRAIN.BATCH_SIZE
        cfg.MULTIGRID.DEFAULT_T = cfg.DATA.NUM_FRAMES
        cfg.MULTIGRID.DEFAULT_S = cfg.DATA.TRAIN_CROP_SIZE

        if cfg.MULTIGRID.LONG_CYCLE:
            self.schedule = self.get_long_cycle_schedule(cfg)
            cfg.SOLVER.STEPS = [0] + [s[-1] for s in self.schedule]
            # fine-tuning phase
            cfg.SOLVER.STEPS[-1] = (cfg.SOLVER.STEPS[-2] + cfg.SOLVER.STEPS[-1]) // 2
            cfg.SOLVER.LRS = [
                cfg.SOLVER.GAMMA ** s[0] * s[1][0] for s in self.schedule
            ]
            cfg.SOLVER.LRS = cfg.SOLVER.LRS[:-1] + [
                cfg.SOLVER.LRS[-2],
                cfg.SOLVER.LRS[-1],
            ]
            cfg.SOLVER.MAX_EPOCH = self.schedule[-1][-1]
        elif cfg.MULTIGRID.SHORT_CYCLE:
            cfg.SOLVER.STEPS = [
                int(s * cfg.MULTIGRID.EPOCH_FACTOR) for s in cfg.SOLVER.STEPS
            ]
            cfg.SOLVER.MAX_EPOCH = int(
                cfg.SOLVER.MAX_EPOCH * cfg.MULTIGRID.EPOCH_FACTOR
            )
        return cfg

    def update_long_cycle(self, cfg, cur_epoch):
        """Returns (cfg, changed)."""
        base_b, base_t, base_s = get_current_long_cycle_shape(
            self.schedule, cur_epoch
        )
        if base_s == cfg.DATA.TRAIN_CROP_SIZE and base_t == cfg.DATA.NUM_FRAMES:
            return cfg, False
        cfg.DATA.NUM_FRAMES = base_t
        cfg.DATA.TRAIN_CROP_SIZE = base_s
        cfg.TRAIN.BATCH_SIZE = base_b * cfg.MULTIGRID.DEFAULT_B

        bs_factor = (
            float(cfg.TRAIN.BATCH_SIZE / cfg.NUM_GPUS) / cfg.MULTIGRID.BN_BASE_SIZE
        )
        if bs_factor < 1:
            # the port's BatchNorms take their statistics over the data
            # group's global batch under every NORM_TYPE: on one process,
            # plain BN, as under vtm's mesh
            cfg.BN.NORM_TYPE = "sync_batchnorm"
            cfg.BN.NUM_SYNC_DEVICES = int(1.0 / bs_factor)
        elif bs_factor > 1:
            cfg.BN.NORM_TYPE = "sub_batchnorm"
            cfg.BN.NUM_SPLITS = int(bs_factor)
        else:
            cfg.BN.NORM_TYPE = "batchnorm"

        cfg.MULTIGRID.LONG_CYCLE_SAMPLING_RATE = cfg.DATA.SAMPLING_RATE * (
            cfg.MULTIGRID.DEFAULT_T // cfg.DATA.NUM_FRAMES
        )
        logger.info(
            "Long cycle updates: BN.NORM_TYPE=%s B=%d TxSR=%dx%d S=%d",
            cfg.BN.NORM_TYPE,
            cfg.TRAIN.BATCH_SIZE,
            cfg.DATA.NUM_FRAMES,
            cfg.MULTIGRID.LONG_CYCLE_SAMPLING_RATE,
            cfg.DATA.TRAIN_CROP_SIZE,
        )
        return cfg, True

    def get_long_cycle_schedule(self, cfg):
        steps = cfg.SOLVER.STEPS
        default_size = float(cfg.DATA.NUM_FRAMES * cfg.DATA.TRAIN_CROP_SIZE ** 2)
        default_iters = steps[-1]

        avg_bs = []
        all_shapes = []
        for t_factor, s_factor in cfg.MULTIGRID.LONG_CYCLE_FACTORS:
            base_t = int(round(cfg.DATA.NUM_FRAMES * t_factor))
            base_s = int(round(cfg.DATA.TRAIN_CROP_SIZE * s_factor))
            if cfg.MULTIGRID.SHORT_CYCLE:
                shapes = [
                    [base_t, cfg.MULTIGRID.DEFAULT_S * cfg.MULTIGRID.SHORT_CYCLE_FACTORS[0]],
                    [base_t, cfg.MULTIGRID.DEFAULT_S * cfg.MULTIGRID.SHORT_CYCLE_FACTORS[1]],
                    [base_t, base_s],
                ]
            else:
                shapes = [[base_t, base_s]]
            shapes = [
                [int(round(default_size / (s[0] * s[1] * s[1]))), s[0], s[1]]
                for s in shapes
            ]
            avg_bs.append(np.mean([s[0] for s in shapes]))
            all_shapes.append(shapes)

        total_iters = 0
        schedule = []
        for step_index in range(len(steps) - 1):
            step_epochs = steps[step_index + 1] - steps[step_index]
            for long_cycle_index, shapes in enumerate(all_shapes):
                cur_epochs = step_epochs * avg_bs[long_cycle_index] / sum(avg_bs)
                cur_iters = cur_epochs / avg_bs[long_cycle_index]
                total_iters += cur_iters
                schedule.append((step_index, shapes[-1], cur_epochs))

        iter_saving = default_iters / total_iters
        final_step_epochs = cfg.SOLVER.MAX_EPOCH - steps[-1]
        ft_epochs = final_step_epochs / iter_saving * avg_bs[-1]
        schedule.append((step_index + 1, all_shapes[-1][-1], ft_epochs))

        x = (
            cfg.SOLVER.MAX_EPOCH
            * cfg.MULTIGRID.EPOCH_FACTOR
            / sum(s[-1] for s in schedule)
        )
        final_schedule = []
        total_epochs = 0
        for s in schedule:
            epochs = s[2] * x
            total_epochs += epochs
            final_schedule.append((s[0], s[1], int(round(total_epochs))))
        for s in final_schedule:
            logger.info("long cycle %s shape %s until epoch %s", *s)
        return final_schedule


def get_current_long_cycle_shape(schedule, epoch):
    for s in schedule:
        if epoch < s[-1]:
            return s[1]
    return schedule[-1][1]


def short_cycle_batch_sizes(batch_size: int, cfg):
    """Per-phase batch sizes of the short cycle
    (multigrid_helper.py:44-59)."""
    bs_factor = [
        int(round((float(cfg.DATA.TRAIN_CROP_SIZE) / (s * cfg.MULTIGRID.DEFAULT_S)) ** 2))
        for s in cfg.MULTIGRID.SHORT_CYCLE_FACTORS
    ]
    return [batch_size * bs_factor[0], batch_size * bs_factor[1], batch_size]


def adapt_batch_stats(module: nn.Module, rebuilt: nn.Module) -> None:
    """Re-shape ``module`` in place to ``rebuilt``, the same model built from
    the cfg after a long-cycle flip (``vtm``'s ``adapt_batch_stats``, which
    re-inits the stat tree and overlays every leaf of the same path and
    shape): each BatchNorm takes ``rebuilt``'s splits
    (``BatchNorm.set_num_splits``: mean and var carry over, split statistics
    of another count start from their init); each module with a
    ``pool_size`` (the heads) and the model's spec take ``rebuilt``'s.
    Parameters, their values and the optimizer's state keyed by them stay as
    they are; a parameter whose shape would change raises."""
    from vtm_torch.models.convnet import BatchNorm

    own = dict(module.named_parameters())
    for name, p in rebuilt.named_parameters():
        if name not in own or own[name].shape != p.shape:
            raise ValueError(f"the rebuilt model's {name} {tuple(p.shape)} does not fit the trained one's")
    built = dict(rebuilt.named_modules())
    for name, m in module.named_modules():
        new = built[name]
        if isinstance(m, BatchNorm):
            m.set_num_splits(new.num_splits)
            m.spec = new.spec
        if hasattr(new, "pool_size"):
            m.pool_size = new.pool_size
    for attr in ("spec", "config"):
        if hasattr(rebuilt, attr):
            setattr(module, attr, getattr(rebuilt, attr))
