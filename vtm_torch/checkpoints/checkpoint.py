"""Training checkpoints: save, find the last, restore (port of
``vtm/checkpoints/checkpoint.py:26-115``), and the two rules by which a
foreign checkpoint is taken in (``clear_name_pattern_keys``,
``merge_into_template``: copies of ``vtm/checkpoints/checkpoint.py:116-130,
230-262`` over state dicts), and for the conv families the BatchNorm
statistics' rule (``merge_bn_stats``) and the 2-D -> 3-D weight adaptations
of ``TRAIN.CHECKPOINT_INFLATE`` and ``CHECKPOINT_IN_INIT``
(``inflate_weights``, ``image_init_adapt``; the latter's rules are
``vtm``'s for image-initialised MViT). The module's state dict holds
the BatchNorm running statistics (buffers), so the port's own checkpoints
carry and restore them.

One file per epoch, ``<OUTPUT_DIR>/checkpoints/epoch_<N>.pyth``, written
with ``torch.save``: the module's state dict, the optimizer's state dict
(with its per-group learning rates and layer-decay scales), the epoch and
the config as JSON. The JAX package's orbax directory format is not
carried over. ``get_last_checkpoint`` picks the highest epoch, which is
what ``TRAIN.AUTO_RESUME`` resumes from.

``load_test_checkpoint`` (``vtm/checkpoints/checkpoint.py:301-386``) gives
the eval and benchmark entry points their weights: ``TEST.CHECKPOINT_FILE_PATH``,
or, when that is empty, the last checkpoint of ``OUTPUT_DIR``, then
``TRAIN.CHECKPOINT_FILE_PATH``, else the seeded init.

Under a process group every rank calls these functions. A file holds the
whole model whatever the mesh: ``save_checkpoint`` takes the unwrapped
module (no DDP ``module.`` prefix), gathers the tensor-parallel cuts of the
parameters and of the optimizer's state (``parallel/sharding.py``), and
global rank 0 writes; the loaders read the file on every rank and each
cut parameter takes its rank's piece. So a file written under DDP or
tensor parallelism loads into a one-process run, and one process's file
into any mesh.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from vtm_torch.checkpoints.convert import (
    load_maskmvit_state_dict,
    load_motionformer_state_dict,
    load_mvit_state_dict,
    load_pyslowfast_state_dict,
    load_timesformer_state_dict,
    load_torch_state_dict,
    load_videomae_state_dict,
    load_vivit_state_dict,
)
from vtm_torch.parallel.sharding import (
    full_optimizer_state,
    full_state_dict,
    load_full_state_dict,
    load_optimizer_state,
)
from vtm_torch.utils.logging import get_logger

logger = get_logger(__name__)

_NAME = re.compile(r"epoch_\d+\.pyth$")


def checkpoint_dir(output_dir: str) -> str:
    return os.path.join(output_dir, "checkpoints")


def _epoch_path(output_dir: str, epoch: int) -> str:
    return os.path.join(checkpoint_dir(output_dir), f"epoch_{epoch:05d}.pyth")


def save_checkpoint(
    output_dir: str,
    module: nn.Module,
    optimizer: Optional[torch.optim.Optimizer],
    epoch: int,
    cfg=None,
) -> str:
    """Model + optimizer + epoch (+ the config as JSON): the whole model,
    written by global rank 0 (every rank calls; see the module's docstring)."""
    path = os.path.abspath(_epoch_path(output_dir, epoch))
    payload = {"model_state": full_state_dict(_unwrap(module)), "epoch": int(epoch)}
    if optimizer is not None:
        payload["optimizer_state"] = full_optimizer_state(optimizer)
    if cfg is not None:
        payload["cfg"] = json.dumps(cfg.to_dict(), sort_keys=True)
    if not dist.is_initialized() or dist.get_rank() == 0:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # write beside the target and rename: a reader never sees half a file
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        logger.info("Saved checkpoint %s", path)
    if dist.is_initialized():
        dist.barrier()  # no rank reads the directory before the file is in it
    return path


def _unwrap(module: nn.Module) -> nn.Module:
    return module.module if isinstance(module, DistributedDataParallel) else module


def get_last_checkpoint(output_dir: str) -> Optional[str]:
    d = checkpoint_dir(output_dir)
    if not os.path.isdir(d):
        return None
    names = [n for n in os.listdir(d) if _NAME.match(n)]
    if not names:
        return None
    return os.path.join(d, max(names))


def checkpoint_epoch(path: str) -> int:
    """The epoch of a checkpoint of this package, from its file name."""
    return int(re.search(r"epoch_(\d+)\.pyth$", path).group(1))


def load_checkpoint(
    path: str, module: nn.Module, optimizer: Optional[torch.optim.Optimizer] = None
) -> Tuple[int, bool]:
    """Restore a checkpoint into ``module`` (and ``optimizer``, when given
    and saved) in place. Returns (epoch, whether the optimizer state was
    restored)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    load_full_state_dict(_unwrap(module), blob["model_state"])
    restored_opt = False
    if optimizer is not None:
        if "optimizer_state" in blob:
            load_optimizer_state(optimizer, blob["optimizer_state"])
            restored_opt = True
        else:
            # a silent optimizer reset is a training regression: say why
            # the moments start fresh
            logger.warning(
                "checkpoint %s holds no optimizer state: resuming with a FRESH optimizer state", path
            )
    return int(blob["epoch"]), restored_opt


def clear_name_pattern_keys(sd: Mapping[str, object], patterns) -> Dict[str, object]:
    """Strip each pattern's first occurrence from the state dict's keys,
    one pattern after another (``TRAIN.CHECKPOINT_CLEAR_NAME_PATTERN``;
    copy of ``vtm/checkpoints/checkpoint.py::clear_name_pattern_keys``)."""
    sd = dict(sd)
    for item in patterns or ():
        renamed = {}
        for k, v in sd.items():
            if item in k:
                k_re = k.replace(item, "", 1)
                logger.info("checkpoint: renaming %s -> %s", k, k_re)
                renamed[k_re] = v
            else:
                renamed[k] = v
        sd = renamed
    return sd


def merge_into_template(template: Mapping[str, torch.Tensor], converted: Mapping[str, torch.Tensor]):
    """Overlay converted tensors on a module's own state dict, as
    ``vtm/checkpoints/checkpoint.py::merge_into_template`` overlays them on
    its parameter tree: a key present in both with the same shape takes the
    checkpoint's tensor; a missing key or another shape (a classifier head
    of another class count) keeps the template's, with a warning naming it.
    Keys of ``converted`` that the template lacks are dropped. Returns
    (state dict, tensors loaded, tensors kept)."""
    out, loaded, kept = {}, 0, 0
    for name, init in template.items():
        cand = converted.get(name)
        if cand is not None and tuple(cand.shape) == tuple(init.shape):
            out[name] = cand
            loaded += 1
        else:
            logger.warning("checkpoint: keeping random init for %s (%s)", name,
                           "shape mismatch" if cand is not None else "missing")
            out[name] = init
            kept += 1
    return out, loaded, kept


def _load_timesformer(sd, config):
    return load_timesformer_state_dict(
        sd, num_frames=config.num_frames, spatial_tokens=config.spatial_tokens,
        divided=config.attention_type == "divided_space_time",
    )


# model name -> f(state dict as loaded, the module's config) -> the port's state dict
CHECKPOINT_LOADERS = {
    "VideoMAE": lambda sd, config: load_videomae_state_dict(sd),
    "Motionformer": lambda sd, config: load_motionformer_state_dict(sd),
    "TimeSformer": _load_timesformer,
    "ViViT": lambda sd, config: load_vivit_state_dict(sd),
    "SlowFast": lambda sd, config: load_pyslowfast_state_dict(sd),
    "ResNet": lambda sd, config: load_pyslowfast_state_dict(sd),
    "X3D": lambda sd, config: load_pyslowfast_state_dict(sd),
    "MViT": lambda sd, config: load_mvit_state_dict(sd),
    "MaskMViT": lambda sd, config: load_maskmvit_state_dict(sd),
}
_STATS = ("running_mean", "running_var")


def merge_bn_stats(template: Mapping[str, torch.Tensor], converted: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``converted`` with the BatchNorm statistics the template asks for
    under another name filled in (``vtm/checkpoints/checkpoint.py:263-293``
    over state dicts): a SubBatchNorm's ``X.split_bn.running_*`` [k * C]
    that the file lacks is its plain ``X.running_*`` [C] tiled per split,
    and its ``X.bn.running_*`` the plain ones; a plain ``X.running_*`` that
    the file lacks is a SubBatchNorm's eval ``X.bn.running_*``. What stays
    missing keeps the template's (``merge_into_template``)."""
    out = dict(converted)
    for name, init in template.items():
        if name in out or not name.endswith(_STATS):
            continue
        pre, leaf = name.rsplit(".", 1)
        if pre.endswith(".split_bn"):
            plain = converted.get(f"{pre[:-len('.split_bn')]}.{leaf}")
            if plain is not None and plain.numel() and init.numel() % plain.numel() == 0:
                out[name] = plain.repeat(init.numel() // plain.numel())
        elif pre.endswith(".bn") and f"{pre[:-len('.bn')]}.{leaf}" in converted:
            out[name] = converted[f"{pre[:-len('.bn')]}.{leaf}"]
        elif f"{pre}.bn.{leaf}" in converted:
            out[name] = converted[f"{pre}.bn.{leaf}"]
    return out


def inflate_weights(converted: Mapping[str, torch.Tensor], template: Mapping[str, torch.Tensor]):
    """``TRAIN.CHECKPOINT_INFLATE`` (``vtm/checkpoints/checkpoint.py:145-168``):
    a 4-D [O, I, H, W] kernel whose template is 5-D [O, I, T, H, W] is
    repeated over T and divided by T; everything else passes as it is.
    Returns the converted tensors only, so ``merge_into_template`` still
    counts what it loads and keeps."""
    out = {}
    for name, cand in converted.items():
        tgt = template.get(name)
        if tgt is not None and cand.dim() == 4 and tgt.dim() == 5 and \
                tuple(cand.shape) == tuple(tgt.shape[:2] + tgt.shape[3:]):
            logger.info("Inflate %s: %s -> %s", name, tuple(cand.shape), tuple(tgt.shape))
            cand = cand.unsqueeze(2).repeat(1, 1, tgt.shape[2], 1, 1) / tgt.shape[2]
        elif tgt is not None and tuple(cand.shape) != tuple(tgt.shape):
            logger.info("Unexpected %s: %s -|> %s", name, tuple(cand.shape), tuple(tgt.shape))
        out[name] = cand
    return out


def _interp_linear(arr: torch.Tensor, new_len: int) -> torch.Tensor:
    """F.interpolate(mode='linear', align_corners=False) along axis 0 of [L, C]."""
    return torch.nn.functional.interpolate(arr.T[None].double(), size=new_len, mode="linear",
                                           align_corners=False)[0].T.to(arr.dtype)


def image_init_adapt(converted: Mapping[str, torch.Tensor], template: Mapping[str, torch.Tensor]):
    """``TRAIN.CHECKPOINT_IN_INIT`` (``vtm/checkpoints/checkpoint.py:184-228``):
    a 4-D kernel repeated over the template's T without the division, a
    T = 1 kernel repeated to T, a ``rel_pos`` table of another length
    interpolated linearly; only the template's names are returned."""
    out = {}
    for name, tgt in template.items():
        cand = converted.get(name)
        if cand is None:
            continue
        if tuple(cand.shape) == tuple(tgt.shape):
            out[name] = cand
        elif cand.dim() == 4 and tgt.dim() == 5 and tuple(cand.shape) == tuple(tgt.shape[:2] + tgt.shape[3:]):
            logger.info("image_init: inflate %s to t=%d", name, tgt.shape[2])
            out[name] = cand.unsqueeze(2).repeat(1, 1, tgt.shape[2], 1, 1)
        elif cand.dim() == 5 and tgt.dim() == 5 and cand.shape[2] == 1 and \
                tuple(cand.shape[:2] + cand.shape[3:]) == tuple(tgt.shape[:2] + tgt.shape[3:]):
            logger.info("image_init: repeat %s to t=%d", name, tgt.shape[2])
            out[name] = cand.repeat(1, 1, tgt.shape[2], 1, 1)
        elif "rel_pos" in name and cand.dim() == 2 and tgt.dim() == 2 and cand.shape[1] == tgt.shape[1]:
            logger.info("image_init: interpolating %s %s -> %s", name, tuple(cand.shape), tuple(tgt.shape))
            out[name] = _interp_linear(cand, tgt.shape[0])
        else:
            out[name] = cand  # merge_into_template keeps the init
    return out


def load_test_checkpoint(cfg, bundle):
    """Load the weights to test into the bundle's module, in place (an
    optimizer already built on the parameters stays valid).

    With ``TEST.CHECKPOINT_FILE_PATH`` empty, the order of
    ``vtm/checkpoints/checkpoint.py::load_test_checkpoint``: the last
    checkpoint of ``OUTPUT_DIR`` (this package's ``.pyth`` files, the
    module's state only), then ``TRAIN.CHECKPOINT_FILE_PATH``, else the
    random weights drawn from ``RNG_SEED``, which is logged.

    A torch file is taken in as the JAX package takes it: the keys renamed
    by ``TRAIN.CHECKPOINT_CLEAR_NAME_PATTERN``, converted by the model's
    converter (the conv families' BatchNorm statistics by ``merge_bn_stats``),
    adapted by ``TRAIN.CHECKPOINT_INFLATE`` or ``CHECKPOINT_IN_INIT``, then overlaid on the module's own state dict by
    ``merge_into_template``, so that a tensor the file lacks or holds in
    another shape (a head of another class count) keeps its init. A file of
    which no tensor matches raises."""
    path = cfg.TEST.CHECKPOINT_FILE_PATH
    if not path:
        last = get_last_checkpoint(cfg.OUTPUT_DIR)
        if last is not None:
            load_checkpoint(last, bundle.module)
            logger.info("Testing with last train checkpoint %s", last)
            return bundle
        if not cfg.TRAIN.CHECKPOINT_FILE_PATH:
            logger.info("No checkpoint found: testing the random init of RNG_SEED %d", cfg.RNG_SEED)
            return bundle
        path = cfg.TRAIN.CHECKPOINT_FILE_PATH
    if not os.path.isfile(path):
        raise FileNotFoundError(f"checkpoint {path!r} does not exist")
    if bundle.name not in CHECKPOINT_LOADERS:
        raise NotImplementedError(f"no checkpoint converter for {bundle.name}")
    sd = clear_name_pattern_keys(load_torch_state_dict(path), tuple(cfg.TRAIN.CHECKPOINT_CLEAR_NAME_PATTERN))
    converted = CHECKPOINT_LOADERS[bundle.name](sd, bundle.module.config)
    template = full_state_dict(bundle.module)
    converted = merge_bn_stats(template, converted)
    if cfg.TRAIN.CHECKPOINT_INFLATE:
        converted = inflate_weights(converted, template)
    elif cfg.TRAIN.CHECKPOINT_IN_INIT:
        converted = image_init_adapt(converted, template)
    merged, loaded, kept = merge_into_template(template, converted)
    if not loaded:  # the JAX package's converters raise on a file without the backbone's keys
        raise KeyError(f"no tensor of {path!r} matches {bundle.name}'s; "
                       f"TRAIN.CHECKPOINT_CLEAR_NAME_PATTERN may have to strip a prefix")
    load_full_state_dict(bundle.module, merged)
    logger.info("Loaded torch checkpoint %s (%d tensors, %d kept init)", path, loaded, kept)
    return bundle
