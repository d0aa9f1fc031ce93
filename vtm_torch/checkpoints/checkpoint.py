"""Training checkpoints: save, find the last, restore (port of
``vtm/checkpoints/checkpoint.py:26-115``), and the two rules by which a
foreign checkpoint is taken in (``clear_name_pattern_keys``,
``merge_into_template``: copies of ``vtm/checkpoints/checkpoint.py:116-130,
230-262`` over state dicts).

One file per epoch, ``<OUTPUT_DIR>/checkpoints/epoch_<N>.pyth``, written
with ``torch.save``: the module's state dict, the optimizer's state dict
(with its per-group learning rates and layer-decay scales), the epoch and
the config as JSON. The JAX package's orbax directory format is not
carried over. ``get_last_checkpoint`` picks the highest epoch, which is
what ``TRAIN.AUTO_RESUME`` resumes from.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

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
    """Model + optimizer + epoch (+ the config as JSON)."""
    path = os.path.abspath(_epoch_path(output_dir, epoch))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {"model_state": module.state_dict(), "epoch": int(epoch)}
    if optimizer is not None:
        payload["optimizer_state"] = optimizer.state_dict()
    if cfg is not None:
        payload["cfg"] = json.dumps(cfg.to_dict(), sort_keys=True)
    # write beside the target and rename: a reader never sees half a file
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    logger.info("Saved checkpoint %s", path)
    return path


def get_last_checkpoint(output_dir: str) -> Optional[str]:
    d = checkpoint_dir(output_dir)
    if not os.path.isdir(d):
        return None
    names = [n for n in os.listdir(d) if _NAME.match(n)]
    if not names:
        return None
    return os.path.join(d, max(names))


def load_checkpoint(
    path: str, module: nn.Module, optimizer: Optional[torch.optim.Optimizer] = None
) -> Tuple[int, bool]:
    """Restore a checkpoint into ``module`` (and ``optimizer``, when given
    and saved) in place. Returns (epoch, whether the optimizer state was
    restored)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    module.load_state_dict(blob["model_state"])
    restored_opt = False
    if optimizer is not None:
        if "optimizer_state" in blob:
            optimizer.load_state_dict(blob["optimizer_state"])
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
