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
and ViViT; single head and the EPIC-KITCHENS verb/noun heads; mixup), and the
conv families (SlowFast, ResNet, X3D) with their BatchNorm: the running
statistics update in the train step (kept under ``MODEL.FROZEN_BN``), the
BatchNorm parameter group's ``BN.WEIGHT_DECAY``, and on checkpoint and eval
epochs first precise statistics (``BN.USE_PRECISE_STATS``,
``train/precise_bn.py``) and then the SubBatchNorm fold
(``BN.NORM_TYPE sub_batchnorm``, live in the PTV families), in ``vtm``'s
order. Multigrid (``train/multigrid.py``): the schedule sets the solver's
steps before the model is built; at each long-cycle flip the model is
re-shaped in place (BatchNorm splits, head pool; the parameters and the
optimizer's state stay the same tensors) and the train loader rebuilt for
the new batch; the short cycle's three phases come from the loader.
``DATA.MULTI_LABEL`` (Charades): the train meter tracks the loss only and
the eval epoch's metric is the mAP. A Motionformer built
from a config keeps its softmax head (``build_model`` sets no
``train_mode``, as in the JAX package), so its loss sees probabilities.
Masked pretraining (``MASK.ENABLE``, ``MODEL.MODEL_NAME MaskMViT``): each
batch's loader mask (``AUG.GEN_MASK_LOADER``) goes to the device with its
frames (an MAE under ``MASK.MAE_RND_MASK`` needs none, where ``vtm`` reads
one all the same); MaskFeat's HOG or pixel targets are made there from the frames
(``models/masked.py::maskfeat_labels``), the MAE makes its own in the
forward; the step (``train_step.make_{mae,maskfeat}_train_step``) draws from
the step generator; the meter gets the loss only, and no eval epoch runs.
As in ``vtm``, it runs in one process: ``main`` starts one, and a process
group of more raises. Contrastive pretraining (``MODEL.MODEL_NAME
ContrastiveModel``; ``train_contrastive``, ``vtm``'s SSL loop): the views of
each batch's ``clips`` go in as separate single-pathway clips with
``index % CONTRASTIVE.LENGTH``; MoCo's first ``QUEUE_LEN / batch``
iterations of epoch 0 fill the queue without an update; a checkpoint every
``TRAIN.CHECKPOINT_PERIOD`` holds the parameters, the optimizer and the
model's whole state (BatchNorm statistics, the momentum encoder, queues and
banks); with ``CONTRASTIVE.KNN_ON`` a kNN eval over the val set every
``TRAIN.EVAL_PERIOD`` (eval mode, running statistics) logs
``ssl_knn_eval`` with ``knn_top1``. It runs in one process too.
Detection (``DETECTION.ENABLE``, AVA on SlowFast, ResNet or MViT): each
batch's frames, [N, 5] boxes and multi-hot labels go through
``make_detection_train_step`` (``vtm``'s per-box loss, dropout from the
step generator); the train ``AVAMeter`` keeps the loss and lr; the eval
epoch is ``test_net.perform_detection_test`` over the val split into the
val ``AVAMeter`` (frame mAP, ``detections_latest.csv``), which is then
reset. Precise BatchNorm statistics run the backbone alone
(``precise_bn.py``): the ROI head has no BatchNorm. It runs in one process,
as ``vtm``'s single-device step does. ``DATA.LOADER_CHUNK_SIZE``: each
epoch after the first reads the next slab of the train csv
(``rotate_chunked_csv``; the meters keep their epoch-0 construction, as in
``vtm``), in ``train`` and ``train_contrastive``. ``TENSORBOARD.ENABLE``
writes each supervised train step's ``Train/loss`` and ``Train/lr`` at step
``epoch * len(loader) + iter`` (not the masked or detection steps, as in
``vtm``); ``WANDB.ENABLE`` opens a wandb run for the loop
(``utils/wandb_utils.py``: a no-op without the package); both on rank 0.
``TRAIN.KILL_LOSS_EXPLOSION_FACTOR`` stops the run on a NaN or infinite loss
only, as in the JAX package.

Parallelism (``vtm_torch/parallel``): ``main`` runs ``train`` in one process
per CUDA device the batch can use (``parallel.launch.run``; torchrun
works too). Under a process group ``build_trainer`` builds the
('data', 'model') mesh of ``TPU.MODEL_PARALLEL``, cuts VideoMAE or ViViT
for tensor parallelism (other families raise, ROADMAP.md Queue 1, item
15), and wraps the module in DDP over the data group; each data rank
loads and steps on its rows of each global batch, with step generators
seeded from (seed, epoch, iter, data rank), so that the ranks of one
model group draw the same masks. Meters get the global batch's loss and
errors (all-reduced), logging is rank 0's, and checkpoints hold the
whole model (every rank saves, rank 0 writes). The conv families'
BatchNorms take their statistics over the data group's global batch, for
every ``BN.NORM_TYPE`` (``convnet.set_sync_group``; ``BN.NUM_SYNC_DEVICES``
is ignored, as in ``vtm``); nothing of theirs is cut at a model width
above 1 (``vtm``'s name rules cut none of their matrices), so the ranks of a
model group are replicas. Mixup pairs row i with
row B - 1 - i of each rank's rows (upstream SlowFast mixes per GPU
alike), where ``vtm`` mixes the global batch, so a data-parallel run
with mixup is not ``vtm``'s; λ and the box come from one seed, the same
on every rank.

Runs on the first CUDA device; a machine without one raises. The CPU
(``device="cpu"``, plain versions of the kernels) is for tests only.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Callable, Optional

import numpy as np
import torch
from torch.nn.parallel import DistributedDataParallel

from vtm_torch.checkpoints import checkpoint as cu
from vtm_torch.checkpoints.checkpoint import load_test_checkpoint
from vtm_torch.config import assert_and_infer_cfg, load_config, parse_args
from vtm_torch.data import construct_loader, shuffle_dataset
from vtm_torch.eval.meters import AVAMeter, EPICTrainMeter, EPICValMeter, TrainMeter, ValMeter
from vtm_torch.eval.metrics import multitask_topk_accuracies, topk_accuracies, topk_errors
from vtm_torch.models import ModelBundle, build_model
from vtm_torch.models.contrastive import ContrastiveModel, build_contrastive_model, knn_predict, moco_iters_noupdate
from vtm_torch.models.convnet import aggregate_subbn_stats, batchnorms, set_sync_group
from vtm_torch.models.masked import maskfeat_labels
from vtm_torch.parallel import launch
from vtm_torch.parallel.mesh import Mesh, all_mean, entry_device, gather_rows, make_mesh, replicate
from vtm_torch.parallel.sharding import check_tensor_parallel, shard_module
from vtm_torch.train.mixup import MixUp
from vtm_torch.train.multigrid import MultigridSchedule, adapt_batch_stats
from vtm_torch.train.optimizer import construct_optimizer, set_lr
from vtm_torch.train.precise_bn import compute_precise_bn_stats
from vtm_torch.train.train_step import (
    make_contrastive_train_step,
    make_detection_eval_step,
    make_detection_train_step,
    make_eval_step,
    make_mae_train_step,
    make_maskfeat_train_step,
    make_train_step,
)
from vtm_torch.utils import wandb_utils
from vtm_torch.utils.logging import get_logger, setup_logging

logger = get_logger(__name__)


def rotate_chunked_csv(cfg, cur_epoch: int, data_rank: int = 0, data_ways: int = 1):
    """Per-epoch chunked-csv rotation (copy of ``vtm``'s
    ``tools/train_net.py::rotate_chunked_csv``; reference
    tools/train_net.py:793-804): epochs walk disjoint ``LOADER_CHUNK_SIZE``
    slabs of the overall csv, by setting ``DATA.SKIP_ROWS``. Returns a newly
    built train loader (this data rank's rows), or None when rotation is off
    or at epoch 0. ``LOADER_CHUNK_OVERALL_SIZE`` left at 0 counts as one
    chunk (the reference divides by zero there)."""
    if cur_epoch <= 0 or cfg.DATA.LOADER_CHUNK_SIZE <= 0:
        return None
    num_chunks = max(math.ceil(cfg.DATA.LOADER_CHUNK_OVERALL_SIZE / cfg.DATA.LOADER_CHUNK_SIZE), 1)
    skip_rows = cur_epoch % num_chunks * cfg.DATA.LOADER_CHUNK_SIZE
    logger.info("chunked csv: epoch %d num_chunks %d skip_rows %d", cur_epoch, num_chunks, skip_rows)
    cfg.DATA.SKIP_ROWS = skip_rows
    return construct_loader(cfg, "train", data_rank, data_ways)


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
    check_tensor_parallel(cfg)
    for on, what in (
        (cfg.DETECTION.ENABLE and cfg.TPU.MODEL_PARALLEL > 1,
         "DETECTION.ENABLE with TPU.MODEL_PARALLEL > 1: detection runs in one process, as vtm's "
         "single-device step (ROADMAP.md Queue 1, item 15)"),
    ):
        if on:
            raise NotImplementedError(f"{what} is not ported yet")


def _errors(logits, labels, multi_head: bool):
    """The meter's accuracy figures of one batch, flattened: top-1/5
    errors, or the verb, noun and action top-1/5 accuracies."""
    if multi_head:
        return [a for pair in _epic_accuracies(logits, labels) for a in pair]
    return list(topk_errors(logits, np.asarray(labels), (1, 5)))


def _update(meter, figures, multi_head: bool, *rest):
    if multi_head:
        meter.update_stats(tuple(zip(figures[0::2], figures[1::2])), *rest)
    else:
        meter.update_stats(*figures, *rest)


def train_epoch(loader, train_step, optimizer, lr_at, cur_epoch, meter, cfg, device,
                multi_head, mixup_fn=None, mesh: Mesh = Mesh(), tb_writer=None):
    data_size = len(loader)
    meter.iter_tic()
    for cur_iter, batch in enumerate(loader):
        lr = lr_at(cur_epoch + float(cur_iter) / data_size)
        set_lr(optimizer, lr)
        generator = _step_generator(device, cfg.RNG_SEED, cur_epoch, cur_iter, *mesh.rank_path)
        if cfg.MASK.ENABLE:  # the pretraining step: frames and mask
            frames = torch.as_tensor(np.asarray(batch["frames"]), device=device)
            # none without AUG.GEN_MASK_LOADER: the MAE then draws its noise
            mask = batch.get("mask")
            mask = None if mask is None else torch.as_tensor(np.asarray(mask), device=device)
            meter.data_toc()
            loss, _ = train_step(frames, mask, generator)
        elif cfg.DETECTION.ENABLE:  # the batch's boxes and their multi-hot labels
            frames = torch.as_tensor(np.asarray(batch["frames"]), device=device)
            boxes = torch.as_tensor(np.asarray(batch["boxes"], np.float32), device=device)
            labels = torch.as_tensor(np.asarray(batch["label"], np.float32), device=device)
            meter.data_toc()
            loss, _ = train_step(frames, boxes, labels, generator=generator)
        else:
            if mixup_fn is not None:
                mixed, targets = mixup_fn(np.asarray(batch["frames"]), np.asarray(batch["label"]))
                frames = torch.as_tensor(mixed, device=device)
                labels = torch.as_tensor(targets, device=device)
            else:
                frames = torch.as_tensor(np.asarray(batch["frames"]), device=device)
                labels = _labels_of(batch, multi_head, device)
            meter.data_toc()
            loss, logits, aux = train_step(frames, labels, generator)
        loss = float(loss)
        if cfg.TRAIN.KILL_LOSS_EXPLOSION_FACTOR and not np.isfinite(loss):
            raise RuntimeError(f"NaN/inf loss at epoch {cur_epoch} iter {cur_iter}")
        meter.iter_toc()
        if cfg.DETECTION.ENABLE:  # the AVAMeter keeps the loss and lr
            meter.update_stats(None, None, None, loss, lr)
            meter.log_iter_stats(cur_iter)
            meter.iter_tic()
            continue
        mb = batch["frames"].shape[0] * mesh.data
        if cfg.MASK.ENABLE:  # no errors to count
            meter.update_stats(0.0, 0.0, loss, lr, mb)
        elif cfg.DATA.MULTI_LABEL:  # the loss only; the epoch's metric is the val mAP
            meter.update_stats(None, None, loss, lr, mb)
        else:
            figures = all_mean(_errors(_host(logits), batch["label"], multi_head), mesh.data_group, device)
            if multi_head:
                _update(meter, figures, True, (float(aux[0]), float(aux[1]), loss), lr, mb)
            else:
                _update(meter, figures, False, loss, lr, mb)
        if tb_writer is not None and not cfg.MASK.ENABLE:
            tb_writer.add_scalars({"Train/loss": loss, "Train/lr": lr}, global_step=data_size * cur_epoch + cur_iter)
        meter.log_iter_stats(cur_epoch, cur_iter)
        meter.iter_tic()
    meter.log_epoch_stats(cur_epoch)
    meter.reset()


def eval_epoch(loader, eval_step, meter, cur_epoch, device, multi_head, mesh: Mesh = Mesh(),
               multi_label: bool = False):
    meter.iter_tic()
    for batch in loader:
        # an uneven last batch runs as it is (one process), or padded to the
        # data width with its padding rows dropped after the gather
        frames = np.asarray(batch["frames"])
        meter.data_toc()
        logits = eval_step(torch.as_tensor(frames, device=device))
        if mesh.data > 1:
            logits, batch = gather_rows(mesh, logits, batch)
        else:
            logits = _host(logits)
        n_valid = (logits[0] if multi_head else logits).shape[0]
        meter.iter_toc()
        if multi_label:  # every row kept for the epoch's mAP
            meter.update_predictions(logits, batch["label"])
        else:
            _update(meter, _errors(logits, batch["label"], multi_head), multi_head, n_valid)
        meter.iter_tic()
    meter.log_epoch_stats(cur_epoch)
    meter.reset()


@dataclasses.dataclass
class Trainer:
    """What ``train`` steps with: the module (fp32 parameters, on the
    device, cut for this rank under tensor parallelism), its optimizer and
    schedule, the two steps, and the mesh."""

    module: torch.nn.Module
    optimizer: torch.optim.Optimizer
    lr_at: Callable[[float], float]
    train_step: Callable
    eval_step: Callable
    multi_head: bool
    device: torch.device
    bundle: ModelBundle  # the built model; its name picks a foreign checkpoint's converter
    mesh: Mesh = Mesh()


def build_trainer(cfg, device: Optional[torch.device | str] = None,
                  bundle: Optional[ModelBundle] = None) -> Trainer:
    """Model, optimizer and steps for ``cfg`` on the first CUDA device
    (or on ``device``, which tests set to the CPU). ``bundle``: the model to
    train, on the device with fp32 parameters (built from ``cfg`` when None).
    Under a process group: the mesh, the cuts and DDP (module docstring)."""
    device = entry_device(device, "train_net", _process_batch(cfg), cfg.TPU.MODEL_PARALLEL)
    _unsupported(cfg)
    mesh = make_mesh(cfg.TPU.MODEL_PARALLEL, batch_cap=cfg.TRAIN.BATCH_SIZE, device_type=device.type)
    if cfg.MASK.ENABLE:
        _one_process("masked pretraining")
    if cfg.DETECTION.ENABLE:
        _one_process("detection training")
    if bundle is None:
        bundle = build_model(cfg, device, fp32_params=True)
    module = bundle.module
    multi_head = module.config.multi_head
    if mesh.model > 1:
        shard_module(replicate(mesh, module), mesh)
    optimizer, lr_at = construct_optimizer(cfg, module, num_layers=module.config.depth)
    optimizer.model_group = mesh.model_group if mesh.model > 1 else None
    set_sync_group(module, mesh.data_group if mesh.data > 1 else None)
    stepped = module
    if mesh.device_mesh is not None:
        stepped = DistributedDataParallel(
            # BatchNorm statistics are the data group's, equal on every rank:
            # a broadcast of rank 0's buffers would only cost a collective
            module, device_ids=[device] if device.type == "cuda" else None,
            process_group=mesh.data_group, broadcast_buffers=False,
            # every parameter of every family gets a gradient in every step,
            # a zero one included (the k biases under a softmax, Motionformer's
            # last trajectory projections): tests/test_torch_parallel.py
            find_unused_parameters=False,
        )
    eval_step = make_eval_step(module)
    if cfg.MASK.ENABLE:
        train_step = masked_train_step(cfg, module, optimizer)
    elif cfg.DETECTION.ENABLE:
        train_step = make_detection_train_step(module, optimizer, cfg.MODEL.LOSS_FUNC,
                                               cfg.SOLVER.ACCUMULATE_STEPS)
        eval_step = make_detection_eval_step(module)
    else:
        train_step = make_train_step(
            stepped, optimizer, cfg.MODEL.LOSS_FUNC, multi_head,
            accumulate_steps=cfg.SOLVER.ACCUMULATE_STEPS,
            data_group=mesh.data_group if mesh.data > 1 else None,
        )
    return Trainer(module, optimizer, lr_at, train_step, eval_step, multi_head, device, bundle, mesh)


def _process_batch(cfg) -> int:
    """The batch that sizes the process group: 1 for masked and contrastive
    pretraining and for detection, which run in one process."""
    one = cfg.MASK.ENABLE or cfg.DETECTION.ENABLE or cfg.MODEL.MODEL_NAME == "ContrastiveModel"
    return 1 if one else cfg.TRAIN.BATCH_SIZE


def _one_process(what: str) -> None:
    if torch.distributed.is_initialized() and torch.distributed.get_world_size() > 1:
        raise NotImplementedError(f"{what} runs in one process, as in vtm: start it without a process group "
                                  "of more")


def masked_train_step(cfg, module, optimizer) -> Callable:
    """``step(frames, mask, generator) -> (loss, per-depth losses)`` on the
    device of ``frames``: the MAE step, or the MaskFeat step given its HOG
    or pixel targets made from ``frames`` (``masked.maskfeat_labels``)."""
    if cfg.MASK.MAE_ON:
        mae = make_mae_train_step(module, optimizer, cfg.SOLVER.ACCUMULATE_STEPS)
        return lambda frames, mask, generator: mae(frames, mask, generator=generator)
    maskfeat = make_maskfeat_train_step(module, optimizer, cfg.SOLVER.ACCUMULATE_STEPS)
    return lambda frames, mask, generator: maskfeat(
        frames, mask, maskfeat_labels(cfg, module.spec, frames), generator=generator)


def knn_eval(model: ContrastiveModel, loader, train_labels, device: torch.device) -> float:
    """The kNN top-1 of the val ``loader`` against the model's bank: each
    clip's normalised projection in eval mode, voted by its 200 nearest
    bank rows (``contrastive.knn_predict``)."""
    correct = total = 0
    for batch in loader:
        frames = torch.as_tensor(np.asarray(batch["frames"], np.float32), device=device)
        preds = knn_predict(model, model.features([frames]), train_labels, model.cc.num_classes_downstream)
        labels = np.asarray(batch["label"])
        correct += int((preds.argmax(dim=1).cpu().numpy() == labels).sum())
        total += len(labels)
    return correct / max(total, 1)


def train_contrastive(cfg, device: Optional[torch.device | str] = None) -> ContrastiveModel:
    """Contrastive pretraining (``MODEL.MODEL_NAME ContrastiveModel``; the
    module's docstring). Returns the trained model."""
    device = entry_device(device, "train_net", 1, cfg.TPU.MODEL_PARALLEL)
    _unsupported(cfg)
    _one_process("contrastive pretraining")
    setup_logging(cfg.OUTPUT_DIR)
    np.random.seed(cfg.RNG_SEED)
    logger.info("SSL train with config:\n%s", json.dumps(cfg.to_dict(), indent=1, sort_keys=True))
    model, _ = build_contrastive_model(cfg, device)
    cc = model.cc
    optimizer, lr_at = construct_optimizer(cfg, model)
    step = make_contrastive_train_step(model, optimizer)

    start_epoch = 0
    last = cu.get_last_checkpoint(cfg.OUTPUT_DIR) if cfg.TRAIN.AUTO_RESUME else None
    if last:
        start_epoch = cu.load_checkpoint(last, model, optimizer)[0] + 1
        logger.info("SSL auto-resumed from %s (epoch %d)", last, start_epoch)

    train_loader = construct_loader(cfg, "train")
    data_size = len(train_loader)
    # the kNN eval's label of each bank row
    train_labels = np.asarray(getattr(train_loader.dataset, "_labels", np.zeros(cc.length)), np.int64)
    iters_noupdate = moco_iters_noupdate(cc, cfg.TRAIN.BATCH_SIZE) if cc.type == "moco" else 0
    meter = TrainMeter(data_size, cfg)
    for cur_epoch in range(start_epoch, cfg.SOLVER.MAX_EPOCH):
        rotated = rotate_chunked_csv(cfg, cur_epoch)
        if rotated is not None:  # the meter and the kNN labels keep epoch 0's, as in vtm
            train_loader = rotated
            data_size = len(train_loader)
        shuffle_dataset(train_loader, cur_epoch)
        meter.iter_tic()
        for cur_iter, batch in enumerate(train_loader):
            epoch_exact = cur_epoch + float(cur_iter) / data_size
            lr = lr_at(epoch_exact)
            set_lr(optimizer, lr)
            views = np.asarray(batch["clips"], np.float32)
            clips = [[torch.as_tensor(views[:, i], device=device)] for i in range(views.shape[1])]
            index = torch.as_tensor(np.asarray(batch["index"]) % cc.length, device=device)
            meter.data_toc()
            update = not (cc.type == "moco" and cur_iter < iters_noupdate and epoch_exact < 1)
            loss, _ = step(clips, index, epoch_exact, _step_generator(device, cfg.RNG_SEED, cur_epoch, cur_iter),
                           update_param=update)
            loss = float(loss)
            if cfg.TRAIN.KILL_LOSS_EXPLOSION_FACTOR and not np.isfinite(loss):
                raise RuntimeError(f"NaN/inf SSL loss at epoch {cur_epoch} iter {cur_iter}")
            meter.iter_toc()
            meter.update_stats(0.0, 0.0, loss, lr, views.shape[0])
            meter.log_iter_stats(cur_epoch, cur_iter)
            meter.iter_tic()
        meter.log_epoch_stats(cur_epoch)
        meter.reset()
        if (cur_epoch + 1) % cfg.TRAIN.CHECKPOINT_PERIOD == 0 or cur_epoch + 1 == cfg.SOLVER.MAX_EPOCH:
            cu.save_checkpoint(cfg.OUTPUT_DIR, model, optimizer, cur_epoch, cfg)
        if cc.knn_on and (cur_epoch + 1) % cfg.TRAIN.EVAL_PERIOD == 0:
            top1 = knn_eval(model, construct_loader(cfg, "val"), train_labels, device)
            logger.info('json_stats: {"_type": "ssl_knn_eval", "epoch": %d, "knn_top1": %.4f}', cur_epoch, top1)
    return model


def train(cfg, device: Optional[torch.device | str] = None):
    if cfg.MODEL.MODEL_NAME == "ContrastiveModel":
        return train_contrastive(cfg, device)
    multigrid = None
    if cfg.MULTIGRID.LONG_CYCLE or cfg.MULTIGRID.SHORT_CYCLE:
        # before the model and the optimizer: SOLVER.STEPS / LRS / MAX_EPOCH
        multigrid = MultigridSchedule()
        cfg = multigrid.init_multigrid(cfg)
    trainer = build_trainer(cfg, device)
    module, optimizer = trainer.module, trainer.optimizer
    multi_head, mesh = trainer.multi_head, trainer.mesh
    if mesh.rank == 0:
        setup_logging(cfg.OUTPUT_DIR)
    np.random.seed(cfg.RNG_SEED)
    logger.info("Train with config:\n%s", json.dumps(cfg.to_dict(), indent=1, sort_keys=True))

    start_epoch = 0
    if cfg.TRAIN.AUTO_RESUME and cu.get_last_checkpoint(cfg.OUTPUT_DIR):
        last = cu.get_last_checkpoint(cfg.OUTPUT_DIR)
        if multigrid is not None and cfg.MULTIGRID.LONG_CYCLE:
            # the module in the saved epoch's shape (its BatchNorm splits)
            # before the saved state loads into it
            _follow_long_cycle(cfg, multigrid, cu.checkpoint_epoch(last), module)
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

    train_loader = construct_loader(cfg, "train", mesh.data_rank, mesh.data)
    val_loader = construct_loader(cfg, "val", mesh.data_rank, mesh.data)
    if cfg.DETECTION.ENABLE:
        train_meter = AVAMeter(len(train_loader), cfg, "train")
        val_meter = AVAMeter(len(val_loader), cfg, "val")
        val_meter.video_idx_to_name = val_loader.dataset._video_idx_to_name
    elif multi_head:
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

    tb_writer = None
    if mesh.rank == 0:
        if cfg.TENSORBOARD.ENABLE:
            from vtm_torch.vis.tensorboard_vis import TensorboardWriter

            tb_writer = TensorboardWriter(cfg)
        wandb_utils.init(cfg)
    try:
        _train_epochs(cfg, trainer, multigrid, start_epoch, train_loader, val_loader, train_meter, val_meter,
                      mixup_fn, tb_writer)
    finally:
        if tb_writer is not None:
            tb_writer.close()
        if mesh.rank == 0:
            wandb_utils.finish()
    return module


def _train_epochs(cfg, trainer: Trainer, multigrid, start_epoch: int, train_loader, val_loader, train_meter,
                  val_meter, mixup_fn, tb_writer) -> None:
    """``train``'s epoch loop."""
    module, optimizer, lr_at = trainer.module, trainer.optimizer, trainer.lr_at
    train_step, eval_step = trainer.train_step, trainer.eval_step
    multi_head, device, mesh = trainer.multi_head, trainer.device, trainer.mesh
    for cur_epoch in range(start_epoch, cfg.SOLVER.MAX_EPOCH):
        rotated = rotate_chunked_csv(cfg, cur_epoch, mesh.data_rank, mesh.data)
        if rotated is not None:  # the meters keep their epoch-0 construction, as in vtm
            train_loader = rotated
        if multigrid is not None and cfg.MULTIGRID.LONG_CYCLE and _follow_long_cycle(cfg, multigrid, cur_epoch,
                                                                                     module):
            # the train loader and its meter for the new batch
            train_loader = construct_loader(cfg, "train", mesh.data_rank, mesh.data)
            train_meter = type(train_meter)(len(train_loader), cfg)
        shuffle_dataset(train_loader, cur_epoch)
        train_epoch(train_loader, train_step, optimizer, lr_at, cur_epoch, train_meter, cfg,
                    device, multi_head, mixup_fn=mixup_fn, mesh=mesh, tb_writer=tb_writer)
        is_ckpt = (cur_epoch + 1) % cfg.TRAIN.CHECKPOINT_PERIOD == 0
        is_eval = (cur_epoch + 1) % cfg.TRAIN.EVAL_PERIOD == 0
        refresh_bn_stats(cfg, module, train_loader, device, cur_epoch, mesh, is_ckpt or is_eval)
        if is_ckpt:
            cu.save_checkpoint(cfg.OUTPUT_DIR, module, optimizer, cur_epoch, cfg)
        if is_eval and cfg.DETECTION.ENABLE:
            from vtm_torch.tools.test_net import perform_detection_test

            perform_detection_test(val_loader, eval_step, val_meter, device)
            val_meter.reset()
        elif is_eval and not cfg.MASK.ENABLE:  # pretraining has no classification eval
            eval_epoch(val_loader, eval_step, val_meter, cur_epoch, device, multi_head, mesh, cfg.DATA.MULTI_LABEL)


def _follow_long_cycle(cfg, multigrid: MultigridSchedule, epoch: int, module) -> bool:
    """``update_long_cycle`` of ``cfg`` (in place) for ``epoch``; on a change
    of shape ``module`` is re-shaped in place for the new cfg (BatchNorm
    splits, head pool), its parameters and the optimizer's state as they
    are. Returns whether the shape changed."""
    changed = multigrid.update_long_cycle(cfg, epoch)[1]
    if changed:
        adapt_batch_stats(module, build_model(cfg, "cpu", fp32_params=True).module)
    return changed


def refresh_bn_stats(cfg, module, loader, device, cur_epoch: int, mesh: Mesh = Mesh(), due: bool = True) -> None:
    """Before a checkpoint or an eval epoch (``due``), ``vtm``'s order
    (tools/train_net.py:626-645): precise BatchNorm statistics over
    ``min(BN.NUM_BATCHES_PRECISE, len(loader))`` batches, then the
    SubBatchNorm fold. A no-op for a module without BatchNorms."""
    if not due or not batchnorms(module):
        return
    if cfg.BN.USE_PRECISE_STATS:
        # the masks of the iteration after the epoch's last
        generator = _step_generator(device, cfg.RNG_SEED, cur_epoch, len(loader), *mesh.rank_path)
        compute_precise_bn_stats(module, loader, min(cfg.BN.NUM_BATCHES_PRECISE, len(loader)), device, generator)
    if cfg.BN.NORM_TYPE == "sub_batchnorm":
        aggregate_subbn_stats(module)


def _train(cfg, device) -> None:
    """``train`` for ``launch.run``: a spawned rank's module stays in it."""
    train(cfg, device)


def main():
    args = parse_args()
    for path in args.cfg_files or [None]:
        cfg = load_config(args, path)
        assert_and_infer_cfg(cfg)
        launch.run(cfg, _train, _process_batch(cfg))


if __name__ == "__main__":
    main()
