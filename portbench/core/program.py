"""The system under test, ``vtm_torch``, built through its own entry
points: ``build_model`` as ``tools/model_benchmark.py`` and ``test_net``
build it for serving, ``build_trainer`` of ``tools/train_net.py`` for
training. The benchmark's seeded weights replace the built ones by
``load_state_dict``; nothing else of the program is changed."""

from __future__ import annotations

import torch


def port_cfg(cell, batch: int):
    from vtm_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_other(cell.config["port"])
    cfg.TOME.ENABLE = cell.r > 0
    cfg.TOME.R_VALUE = cell.r
    cfg.TEST.BATCH_SIZE = batch
    cfg.TRAIN.BATCH_SIZE = batch
    return cfg


def build_kernels() -> float:
    """Build (first run in a checkout) or load the kernel library; returns
    the seconds nvcc took, 0 when the checkout's cache held it."""
    from vtm_torch.ops import build

    seconds = build.build()
    build.load_library()
    return seconds


def serving_forward(cell, params: dict, batch: int, device, recorder=None):
    """The forward ``perform_benchmark`` and ``test_net`` run: the built
    module in eval mode, under ``inference_mode``; returns ``forward(video)
    -> logits`` and the module. (Its merges reach ``recorder`` through the
    matcher's wrapper.)"""
    from vtm_torch.models import build_model

    module = build_model(port_cfg(cell, batch), device).module
    module.load_state_dict(params, strict=True)

    def forward(video):
        with torch.inference_mode():
            return module(video)[0]

    return forward, module


def trainer(cell, params: dict, batch: int, device):
    """``build_trainer``'s Trainer (fp32 parameters, AdamW, the step) with
    the seeded weights."""
    from vtm_torch.tools.train_net import build_trainer

    tr = build_trainer(port_cfg(cell, batch), device)
    tr.module.load_state_dict(params, strict=True)
    return tr
