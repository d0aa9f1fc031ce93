"""The conv stems' max pool on the card: the deterministic backward of
``convnet.max_pool3d`` against ``F.max_pool3d``'s, whose CUDA backward adds
overlapping windows' gradients with atomics in no fixed order.

    python3 -m vtm_torch.tools.pool_times --exp pool
    python3 -m vtm_torch.tools.pool_times --exp steps --cfg configs/slowfast/kinetics/SLOWFAST_8x8_R50.yaml

``--exp pool``: forward and backward of the stems' 1x3x3 / 1x2x2 pool at
the shapes of a B8 step at 224 (``STEM_SHAPES``, channels-last as the
models hold them), each way, timed by CUDA events in turns (atomics,
sorted, sorted, atomics), and whether two backwards give the same bits.
``--exp steps``: train steps of the config's model (a conv family, or a
``ContrastiveModel`` on one) at ``TRAIN.BATCH_SIZE`` on one fixed random
batch, with the pools of ``convnet`` and ``slowfast`` swapped to
``F.max_pool3d`` (the earlier code) and back, in the same turns: ms a step
(CUDA events, the first step of each turn not counted). Prints one JSON
line per row, with the card's name. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import numpy as np
import torch
import torch.nn.functional as F

from vtm_torch.config import assert_and_infer_cfg, load_config
from vtm_torch.models import convnet, slowfast

# [B, C, T, H, W] after the stem's conv at B8, 224: SlowFast 8x8's slow and
# fast pathways (8 frames x 64 channels, 32 x 8); Slow R50 8x8's one pathway
# is the slow one's shape
STEM_SHAPES = {"slowfast_slow": (8, 64, 8, 112, 112), "slowfast_fast": (8, 8, 32, 112, 112)}
KERNEL, STRIDE, PADDING = (1, 3, 3), (1, 2, 2), (0, 1, 1)
ORDER = ("atomics", "sorted", "sorted", "atomics")


def _atomics_pool(x, kernel, stride, padding=(0, 0, 0)):
    return F.max_pool3d(x, tuple(kernel), tuple(stride), tuple(padding))


@contextlib.contextmanager
def pools(way: str):
    """The conv modules' ``max_pool3d`` as ``way`` says while open."""
    saved = convnet.max_pool3d, slowfast.max_pool3d
    if way == "atomics":
        convnet.max_pool3d = slowfast.max_pool3d = _atomics_pool
    try:
        yield
    finally:
        convnet.max_pool3d, slowfast.max_pool3d = saved


def _events_ms(fn, iters: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_pool(shape, iters: int = 20) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(shape, generator=gen, device="cuda").to(memory_format=torch.channels_last_3d)
    x = x.round(decimals=1).requires_grad_(True)  # ties, as ReLU's zeros give them
    grad = torch.randn(convnet.max_pool3d(x.detach(), KERNEL, STRIDE, PADDING).shape, generator=gen, device="cuda")
    rows = {}
    for way in ORDER:
        with pools(way):
            def step():
                x.grad = None
                convnet.max_pool3d(x, KERNEL, STRIDE, PADDING).backward(grad)
            step()
            first = x.grad.clone()
            step()
            same = torch.equal(first, x.grad)
            ms = _events_ms(step, iters)
        rows.setdefault(way, []).append(dict(ms=ms, same_bits=same))
    with pools("atomics"):
        x.grad = None
        convnet.max_pool3d(x, KERNEL, STRIDE, PADDING).backward(grad)
        atomics = x.grad.clone()
    x.grad = None
    convnet.max_pool3d(x, KERNEL, STRIDE, PADDING).backward(grad)
    err = float((x.grad - atomics).abs().max())
    return dict(shape=list(shape), rows=rows, max_abs_diff=err)


def _step_fn(cfg):
    """A train step of ``cfg``'s model on one fixed batch, and the model."""
    from vtm_torch.models.contrastive import build_contrastive_model
    from vtm_torch.tools.train_net import build_trainer
    from vtm_torch.train.optimizer import construct_optimizer
    from vtm_torch.train.train_step import make_contrastive_train_step

    b, t, s = cfg.TRAIN.BATCH_SIZE, cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_CROP_SIZE
    gen = torch.Generator(device="cuda").manual_seed(0)
    if cfg.MODEL.MODEL_NAME == "ContrastiveModel":
        model, _ = build_contrastive_model(cfg, "cuda")
        optimizer, _ = construct_optimizer(cfg, model)
        step = make_contrastive_train_step(model, optimizer)
        offset = 2 * torch.randn(b, 1, 1, 1, 3, generator=gen, device="cuda")
        clips = [[torch.randn(b, t, s, s, 3, generator=gen, device="cuda") + offset] for _ in range(2)]
        index = torch.arange(b, device="cuda")
        return lambda: step(clips, index, 0.0), model
    trainer = build_trainer(cfg, "cuda")
    frames = torch.randn(b, t, s, s, 3, generator=gen, device="cuda")
    labels = torch.randint(0, cfg.MODEL.NUM_CLASSES, (b,), generator=gen, device="cuda")
    return lambda: trainer.train_step(frames, labels, None), trainer.module


def time_steps(cfg, steps: int = 4) -> dict:
    step, model = _step_fn(cfg)
    rows = {}
    for way in ORDER:
        with pools(way):
            step()  # not counted
            ms = _events_ms(step, steps)
        rows.setdefault(way, []).append(ms)
    del model
    return dict(model=cfg.MODEL.MODEL_NAME, arch=cfg.MODEL.ARCH, batch=cfg.TRAIN.BATCH_SIZE,
                frames=cfg.DATA.NUM_FRAMES, crop=cfg.DATA.TRAIN_CROP_SIZE, steps=steps, ms_per_step=rows,
                sorted_over_atomics=float(np.mean(rows["sorted"]) / np.mean(rows["atomics"])))


def _card() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("pool_times needs a CUDA device and found none")
    return torch.cuda.get_device_name(0)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--exp", choices=("pool", "steps"), required=True)
    parser.add_argument("--cfg", dest="cfg_file", default=None)
    parser.add_argument("--steps", type=int, default=4)
    parser.add_argument("--opts", nargs=argparse.REMAINDER, default=[])
    args = parser.parse_args(argv)
    card = _card()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    if args.exp == "pool":
        for name, shape in STEM_SHAPES.items():
            print(json.dumps({"exp": "pool", "name": name, **time_pool(shape), "device": card}), flush=True)
    else:
        cfg = load_config(args, args.cfg_file)
        assert_and_infer_cfg(cfg)
        print(json.dumps({"exp": "steps", **time_steps(cfg, args.steps), "device": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
