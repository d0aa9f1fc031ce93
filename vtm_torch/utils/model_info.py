"""Model statistics (port of ``vtm/utils/model_info.py``): the parameter
count and bytes, the FLOPs of one clip's forward and the device's memory,
logged by ``test_net`` under ``LOG_MODEL_INFO`` with ``vtm``'s JSON keys.

``vtm`` counts FLOPs with XLA's cost analysis of the compiled forward,
which counts elementwise work too. Here ``torch.utils.flop_counter.
FlopCounterMode`` counts the products (matrix products and convolutions,
two FLOPs a multiply-add) over a forward of a batch of one; the attention
kernels are ctypes launches it does not see, so each forward wrapper (K1,
K3, K5a) adds its own products to the open count
(``ops/flash_attention.py::PRODUCT_COUNTS``), and the card's count equals
the plain path's on the CPU. The count is a little below ``vtm``'s.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from vtm_torch.ops import flash_attention
from vtm_torch.utils.logging import get_logger, log_json_stats

logger = get_logger(__name__)


def params_count(module: nn.Module) -> int:
    """The model's parameters (not its buffers: the BatchNorm statistics
    are ``vtm``'s ``batch_stats``, which it does not count)."""
    return sum(p.numel() for p in module.parameters())


def params_bytes(module: nn.Module) -> int:
    """The model's parameter bytes, each in the dtype it is held in."""
    return sum(p.numel() * p.element_size() for p in module.parameters())


def flop_count(module: nn.Module, sample: torch.Tensor) -> float:
    """The FLOPs of one eval forward of ``sample``: the products
    ``FlopCounterMode`` sees plus those of the attention kernels launched."""
    launched: list = []
    flash_attention.PRODUCT_COUNTS.append(launched)
    was_training = module.training
    module.eval()
    try:
        with torch.inference_mode(), FlopCounterMode(display=False) as counter:
            module(sample)
    finally:
        flash_attention.PRODUCT_COUNTS.remove(launched)
        module.train(was_training)
    return float(counter.get_total_flops() + sum(launched))


def device_memory_stats(device) -> dict:
    """Memory in use and the total of a CUDA ``device``; empty on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    return {
        "hbm_bytes_in_use": int(torch.cuda.memory_stats(device).get("allocated_bytes.all.current", 0)),
        "hbm_bytes_limit": int(torch.cuda.get_device_properties(device).total_memory),
    }


def log_model_info(bundle, cfg, use_train_input: bool = False) -> dict:
    """``vtm``'s statistics of ``bundle``'s model on one clip of the test (or
    train) crop, logged as a ``json_stats:`` line of split ``model_info``.
    The model is the uncut one (``test_net`` calls this before a
    tensor-parallel cut), so the counts are the whole model's."""
    module = bundle.module
    device = next(module.parameters()).device
    t = cfg.DATA.NUM_FRAMES
    s = cfg.DATA.TRAIN_CROP_SIZE if use_train_input else cfg.DATA.TEST_CROP_SIZE
    sample = torch.zeros((1, t, s, s, 3), dtype=torch.float32, device=device)
    flops = flop_count(module, sample)
    stats = {
        "model": bundle.name,
        "params": params_count(module),
        "param_bytes": params_bytes(module),
        "gflops_per_clip": round(flops / 1e9, 3),
        **device_memory_stats(device),
    }
    log_json_stats({"split": "model_info", **stats}, logger)
    return stats
