"""Fine-tuning entry point of the PyTorch package (port of ``tools/train_net.py``).

    python -m vtm_torch.tools.train_net --cfg CONFIG.yaml --opts KEY VALUE ...

``train(cfg)``: build the model with fp32 parameters and the configured
compute dtype, the optimizer, the train and eval steps, loaders and
meters; auto-resume from the last checkpoint of ``OUTPUT_DIR``; then the
epoch loop: learning rate set per iteration, the step (forward, loss,
backward through the attention kernels and the merge, optimizer update),
logging, an eval epoch every ``TRAIN.EVAL_PERIOD`` and a checkpoint every
``TRAIN.CHECKPOINT_PERIOD``. Returns the trained module. Without a
checkpoint to resume from, ``TRAIN.CHECKPOINT_FILE_PATH`` names a torch
checkpoint to start from, loaded as ``TEST.CHECKPOINT_FILE_PATH`` is
(``checkpoints.checkpoint.load_test_checkpoint``: partial, the name patterns
cleared), as in the JAX package.

Ported: the supervised transformer path (VideoMAE, Motionformer, TimeSformer
and ViViT; single head and the EPIC-KITCHENS verb/noun heads; mixup). A Motionformer built
from a config keeps its softmax head (``build_model`` sets no
``train_mode``, as in the JAX package), so its loss sees probabilities. Contrastive, detection and masked
pretraining, multigrid, the BatchNorm families, the chunked-csv rotation,
tensorboard and wandb are not ported yet and raise where a config asks
for them. ``TRAIN.KILL_LOSS_EXPLOSION_FACTOR`` stops the run on a NaN or
infinite loss only, as in the JAX package.

Runs on the first CUDA device; a machine without one raises. The CPU
(``device="cpu"``, plain versions of the kernels) is for tests only.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable, Optional

import numpy as np
import torch

from vtm_torch.checkpoints import checkpoint as cu
from vtm_torch.checkpoints.checkpoint import load_test_checkpoint
from vtm_torch.config import assert_and_infer_cfg, load_config, parse_args
from vtm_torch.data import construct_loader, shuffle_dataset
from vtm_torch.eval.meters import EPICTrainMeter, EPICValMeter, TrainMeter, ValMeter
from vtm_torch.eval.metrics import multitask_topk_accuracies, topk_accuracies, topk_errors
from vtm_torch.models import ModelBundle, build_model
from vtm_torch.train.mixup import MixUp
from vtm_torch.train.optimizer import construct_optimizer, set_lr
from vtm_torch.train.train_step import make_eval_step, make_train_step
from vtm_torch.utils.logging import get_logger, setup_logging

logger = get_logger(__name__)


def _epic_accuracies(logits, labels):
    """((v1, v5), (n1, n5), (a1, a5)) in %."""
    verb = np.asarray(logits[0])
    noun = np.asarray(logits[1])
    lv = np.asarray(labels["verb"])
    ln = np.asarray(labels["noun"])
    v1, v5 = topk_accuracies(verb, lv, (1, 5))
    n1, n5 = topk_accuracies(noun, ln, (1, 5))
    a1, a5 = multitask_topk_accuracies((verb, noun), (lv, ln), (1, 5))
    return ((v1, v5), (n1, n5), (a1, a5))


def _step_generator(device: torch.device, seed: int, *path: int) -> torch.Generator:
    """Per-step generator for the dropout and stochastic-depth masks and
    the random merge modes' scores, seeded from (seed, *path): (seed,
    epoch, iter) in training, so a resumed run draws the same masks;
    (seed, iter) in testing."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([seed, *path]).generate_state(1)[0]))
    return gen


def _labels_of(batch, multi_head: bool, device: torch.device):
    if multi_head:
        return {
            "verb": torch.as_tensor(np.asarray(batch["label"]["verb"]), device=device),
            "noun": torch.as_tensor(np.asarray(batch["label"]["noun"]), device=device),
        }
    return torch.as_tensor(np.asarray(batch["label"]), device=device)


def _host(logits):
    """Logits (or the pair of them) as fp32 numpy arrays."""
    if isinstance(logits, (tuple, list)):
        return tuple(l.float().cpu().numpy() for l in logits)
    return logits.float().cpu().numpy()


def _unsupported(cfg) -> None:
    """Raise for what the JAX package's train loop does and this one does not yet."""
    if cfg.MODEL.MODEL_NAME == "ContrastiveModel":
        raise NotImplementedError("contrastive pretraining is not ported yet")
    for on, what in (
        (cfg.MULTIGRID.LONG_CYCLE or cfg.MULTIGRID.SHORT_CYCLE, "MULTIGRID: multigrid training"),
        (cfg.MASK.ENABLE, "MASK.ENABLE: MAE / MaskFeat pretraining"),
        (cfg.DETECTION.ENABLE, "DETECTION.ENABLE: detection training"),
        (cfg.TENSORBOARD.ENABLE, "TENSORBOARD.ENABLE: the tensorboard writer"),
        (cfg.WANDB.ENABLE, "WANDB.ENABLE: wandb logging"),
        (cfg.DATA.LOADER_CHUNK_SIZE > 0, "DATA.LOADER_CHUNK_SIZE: chunked-csv rotation"),
        (cfg.DATA.MULTI_LABEL, "DATA.MULTI_LABEL: multi-label training"),
    ):
        if on:
            raise NotImplementedError(f"{what} is not ported yet")


def train_epoch(loader, train_step, optimizer, lr_at, cur_epoch, meter, cfg, device,
                multi_head, mixup_fn=None):
    data_size = len(loader)
    meter.iter_tic()
    for cur_iter, batch in enumerate(loader):
        lr = lr_at(cur_epoch + float(cur_iter) / data_size)
        set_lr(optimizer, lr)
        if mixup_fn is not None:
            mixed, targets = mixup_fn(np.asarray(batch["frames"]), np.asarray(batch["label"]))
            frames = torch.as_tensor(mixed, device=device)
            labels = torch.as_tensor(targets, device=device)
        else:
            frames = torch.as_tensor(np.asarray(batch["frames"]), device=device)
            labels = _labels_of(batch, multi_head, device)
        meter.data_toc()
        loss, logits, aux = train_step(
            frames, labels, _step_generator(device, cfg.RNG_SEED, cur_epoch, cur_iter)
        )
        loss = float(loss)
        if cfg.TRAIN.KILL_LOSS_EXPLOSION_FACTOR and not np.isfinite(loss):
            raise RuntimeError(f"NaN/inf loss at epoch {cur_epoch} iter {cur_iter}")
        mb = batch["frames"].shape[0]
        meter.iter_toc()
        if multi_head:
            accs = _epic_accuracies(_host(logits), batch["label"])
            meter.update_stats(accs, (float(aux[0]), float(aux[1]), loss), lr, mb)
        else:
            top1_err, top5_err = topk_errors(_host(logits), np.asarray(batch["label"]), (1, 5))
            meter.update_stats(top1_err, top5_err, loss, lr, mb)
        meter.log_iter_stats(cur_epoch, cur_iter)
        meter.iter_tic()
    meter.log_epoch_stats(cur_epoch)
    meter.reset()


def eval_epoch(loader, eval_step, meter, cur_epoch, device, multi_head):
    meter.iter_tic()
    for batch in loader:
        # an uneven last batch runs as it is: nothing here needs a fixed shape
        frames = np.asarray(batch["frames"])
        n_valid = frames.shape[0]
        meter.data_toc()
        logits = _host(eval_step(torch.as_tensor(frames, device=device)))
        meter.iter_toc()
        if multi_head:
            meter.update_stats(_epic_accuracies(logits, batch["label"]), n_valid)
        else:
            top1_err, top5_err = topk_errors(logits, np.asarray(batch["label"]), (1, 5))
            meter.update_stats(top1_err, top5_err, n_valid)
        meter.iter_tic()
    meter.log_epoch_stats(cur_epoch)
    meter.reset()


@dataclasses.dataclass
class Trainer:
    """What ``train`` steps with: the module (fp32 parameters, on the
    device), its optimizer and schedule, and the two steps."""

    module: torch.nn.Module
    optimizer: torch.optim.Optimizer
    lr_at: Callable[[float], float]
    train_step: Callable
    eval_step: Callable
    multi_head: bool
    device: torch.device
    bundle: ModelBundle  # the built model; its name picks a foreign checkpoint's converter


def build_trainer(cfg, device: Optional[torch.device | str] = None) -> Trainer:
    """Model, optimizer and steps for ``cfg`` on the first CUDA device
    (or on ``device``, which tests set to the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("train_net needs a CUDA device and found none")
        device = "cuda"
    device = torch.device(device)
    _unsupported(cfg)
    bundle = build_model(cfg, device, fp32_params=True)
    module = bundle.module
    multi_head = module.config.multi_head
    optimizer, lr_at = construct_optimizer(cfg, module, num_layers=module.config.depth)
    train_step = make_train_step(
        module, optimizer, cfg.MODEL.LOSS_FUNC, multi_head,
        accumulate_steps=cfg.SOLVER.ACCUMULATE_STEPS,
    )
    return Trainer(module, optimizer, lr_at, train_step, make_eval_step(module), multi_head, device, bundle)


def train(cfg, device: Optional[torch.device | str] = None):
    trainer = build_trainer(cfg, device)
    module, optimizer, lr_at = trainer.module, trainer.optimizer, trainer.lr_at
    train_step, eval_step = trainer.train_step, trainer.eval_step
    multi_head, device = trainer.multi_head, trainer.device
    setup_logging(cfg.OUTPUT_DIR)
    np.random.seed(cfg.RNG_SEED)
    logger.info("Train with config:\n%s", json.dumps(cfg.to_dict(), indent=1, sort_keys=True))

    start_epoch = 0
    if cfg.TRAIN.AUTO_RESUME and cu.get_last_checkpoint(cfg.OUTPUT_DIR):
        last = cu.get_last_checkpoint(cfg.OUTPUT_DIR)
        start_epoch, _ = cu.load_checkpoint(last, module, optimizer)
        start_epoch += 1
        logger.info("Auto-resumed from %s (epoch %d)", last, start_epoch)
    elif cfg.TRAIN.CHECKPOINT_FILE_PATH:
        # tools/train_net.py:473-481: TRAIN's file through the test loader,
        # into the parameters the optimizer already holds. A torch file
        # carries no epoch, so the run starts at 0 with or without
        # TRAIN.CHECKPOINT_EPOCH_RESET, as there.
        saved = cfg.TEST.CHECKPOINT_FILE_PATH
        cfg.TEST.CHECKPOINT_FILE_PATH = cfg.TRAIN.CHECKPOINT_FILE_PATH
        try:
            load_test_checkpoint(cfg, trainer.bundle)
        finally:
            cfg.TEST.CHECKPOINT_FILE_PATH = saved

    train_loader = construct_loader(cfg, "train")
    val_loader = construct_loader(cfg, "val")
    if multi_head:
        train_meter = EPICTrainMeter(len(train_loader), cfg)
        val_meter = EPICValMeter(len(val_loader), cfg)
    else:
        train_meter = TrainMeter(len(train_loader), cfg)
        val_meter = ValMeter(len(val_loader), cfg)

    mixup_fn = None
    if cfg.MIXUP.ENABLE and not multi_head:
        mixup_fn = MixUp(
            mixup_alpha=cfg.MIXUP.ALPHA,
            cutmix_alpha=cfg.MIXUP.CUTMIX_ALPHA,
            mix_prob=cfg.MIXUP.PROB,
            switch_prob=cfg.MIXUP.SWITCH_PROB,
            label_smoothing=cfg.MIXUP.LABEL_SMOOTH_VALUE,
            num_classes=cfg.MODEL.NUM_CLASSES,
            seed=cfg.RNG_SEED,
        )

    for cur_epoch in range(start_epoch, cfg.SOLVER.MAX_EPOCH):
        shuffle_dataset(train_loader, cur_epoch)
        train_epoch(train_loader, train_step, optimizer, lr_at, cur_epoch, train_meter, cfg,
                    device, multi_head, mixup_fn=mixup_fn)
        if (cur_epoch + 1) % cfg.TRAIN.CHECKPOINT_PERIOD == 0:
            cu.save_checkpoint(cfg.OUTPUT_DIR, module, optimizer, cur_epoch, cfg)
        if (cur_epoch + 1) % cfg.TRAIN.EVAL_PERIOD == 0:
            eval_epoch(val_loader, eval_step, val_meter, cur_epoch, device, multi_head)
    return module


def main():
    args = parse_args()
    for path in args.cfg_files or [None]:
        cfg = load_config(args, path)
        assert_and_infer_cfg(cfg)
        train(cfg)


if __name__ == "__main__":
    main()
