"""Weights & Biases opt-in (copy of ``vtm/utils/wandb_utils.py``; reference:
WANDB.ENABLE/PROJECT keys, custom_config.py:134-140; init/log/finish calls
in test_net.py:332-335, meters.py:430-432, model_benchmark.py:52-56).

A no-op without the ``wandb`` package, as in ``vtm``. With it,
``WANDB.ENABLE`` starts a run, which reaches the wandb service unless the
environment sets ``WANDB_MODE=offline`` (or ``disabled``). The package is
imported at the first ``init``, not when this module is imported.
"""

from __future__ import annotations

import importlib

from vtm_torch.utils.logging import get_logger

logger = get_logger(__name__)

_run = None  # the wandb module while a run is open


def init(cfg) -> bool:
    """Start a run if WANDB.ENABLE and the package exists."""
    global _run
    if not cfg.WANDB.ENABLE:
        return False
    try:
        wandb = importlib.import_module("wandb")
    except ImportError:
        logger.warning("WANDB.ENABLE=True but wandb is not installed — skipping")
        return False
    wandb.init(project=cfg.WANDB.PROJECT, config=cfg.dump())
    _run = wandb
    return True


def log(stats: dict) -> None:
    if _run is not None:
        _run.log(stats)


def finish() -> None:
    global _run
    if _run is not None:
        _run.finish()
    _run = None
