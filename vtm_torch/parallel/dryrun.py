"""The multi-device dry run (port of ``__graft_entry__.py::dryrun_multichip``).

``dryrun_multichip(n)`` launches ``n`` ranks over a ('data', 'model') mesh,
model width 2 when ``n`` is even and at least 4, and runs ``train_net``'s
trainer for one full AdamW step (layer decay 0.75, clipping at global L2
norm 1.0) of a tiny merged VideoMAE on a batch of 2 clips a device. Each
rank checks that ``qkv`` is really cut, that the loss is finite and that
the parameters moved, and returns its loss and the whole model after the
step (tests hold them against ``vtm``'s one-device step). Then the
BatchNorm half: one SGD step of ``__graft_entry__.py``'s tiny SlowFast
(ResNet-18 pathways, width 8, 8 frames at 32 pixels) through the same
trainer, its BatchNorm statistics over the data group's global batch; each
rank checks that the loss is finite and that the statistics moved, and
returns its loss, parameters and statistics.

    python -m vtm_torch.parallel.dryrun 4              # 4 CUDA devices, NCCL
    python -m vtm_torch.parallel.dryrun 4 --cpu        # 4 CPU ranks, gloo
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from vtm_torch.config import get_cfg
from vtm_torch.parallel.launch import launch_job

# __graft_entry__.py's tiny model: 32-pixel crop, 4 frames, 8 tokens
ARCH = dict(img_size=32, patch_size=16, num_frames=4, tubelet_size=2, embed_dim=32, depth=2,
            num_heads=2, mlp_ratio=2.0, num_classes=11)
POLICY = dict(rs=(1, 1), mode="merge", prop_attn=True)


# __graft_entry__.py:200-213's tiny SlowFast
SLOWFAST_OPTS = [
    "MODEL.MODEL_NAME", "SlowFast", "MODEL.ARCH", "slowfast", "MODEL.NUM_CLASSES", "11", "MODEL.DROPOUT_RATE", "0.0",
    "RESNET.DEPTH", "18", "RESNET.WIDTH_PER_GROUP", "8", "DATA.NUM_FRAMES", "8", "DATA.TRAIN_CROP_SIZE", "32",
    "DATA.TEST_CROP_SIZE", "32", "DATA.INPUT_CHANNEL_NUM", "[3, 3]", "SLOWFAST.ALPHA", "4", "SLOWFAST.BETA_INV", "8",
    "SLOWFAST.FUSION_CONV_CHANNEL_RATIO", "2", "SLOWFAST.FUSION_KERNEL_SZ", "7",
    "RESNET.NUM_BLOCK_TEMP_KERNEL", "[[2, 2], [2, 2], [2, 2], [2, 2]]",
    "RESNET.SPATIAL_STRIDES", "[[1, 1], [2, 2], [2, 2], [2, 2]]",
    "RESNET.SPATIAL_DILATIONS", "[[1, 1], [1, 1], [1, 1], [1, 1]]",
    "NONLOCAL.LOCATION", "[[[], []], [[], []], [[], []], [[], []]]",
    "NONLOCAL.GROUP", "[[1, 1], [1, 1], [1, 1], [1, 1]]",
]
SLOWFAST_SHAPE = (8, 32, 32, 3)


def model_parallel_of(n_devices: int) -> int:
    return 2 if n_devices % 2 == 0 and n_devices >= 4 else 1


def dryrun_cfg(n_devices: int):
    cfg = get_cfg()
    cfg.merge_from_list([
        "SOLVER.OPTIMIZING_METHOD", "adamw", "SOLVER.LAYER_DECAY", "0.75", "SOLVER.CLIP_GRAD_L2NORM", "1.0",
        "TRAIN.BATCH_SIZE", str(2 * n_devices // model_parallel_of(n_devices) * model_parallel_of(n_devices)),
        "TPU.MODEL_PARALLEL", str(model_parallel_of(n_devices)), "TPU.COMPUTE_DTYPE", "float32",
    ])
    return cfg


def slowfast_cfg(n_devices: int):
    cfg = dryrun_cfg(n_devices)
    cfg.merge_from_list(SLOWFAST_OPTS + ["SOLVER.OPTIMIZING_METHOD", "sgd", "SOLVER.LAYER_DECAY", "1.0",
                                         "SOLVER.CLIP_GRAD_L2NORM", "None"])
    return cfg


def batch(n_devices: int):
    """The global batch: 2 clips a device, from numpy's seed 0."""
    rng = np.random.default_rng(0)
    b = 2 * n_devices
    frames = rng.standard_normal((b, ARCH["num_frames"], ARCH["img_size"], ARCH["img_size"], 3))
    return frames.astype(np.float32), rng.integers(0, ARCH["num_classes"], size=(b,))


def slowfast_batch(n_devices: int):
    """The SlowFast half's global batch: 2 clips a device, from numpy's seed 1."""
    rng = np.random.default_rng(1)
    b = 2 * n_devices
    return rng.standard_normal((b,) + SLOWFAST_SHAPE).astype(np.float32), rng.integers(0, 11, size=(b,))


def _slowfast_rank(cfg, device, frames, labels) -> dict:
    from vtm_torch.models import build_model
    from vtm_torch.parallel.mesh import shard_batch
    from vtm_torch.parallel.sharding import full_state_dict
    from vtm_torch.tools.train_net import build_trainer
    from vtm_torch.train.optimizer import set_lr

    trainer = build_trainer(cfg, device, bundle=build_model(cfg, device, fp32_params=True))
    mesh, module = trainer.mesh, trainer.module
    stats_before = {k: v.clone() for k, v in module.named_buffers()}
    set_lr(trainer.optimizer, trainer.lr_at(0.0))
    loss, _, _ = trainer.train_step(torch.as_tensor(shard_batch(mesh, frames), device=device),
                                    torch.as_tensor(shard_batch(mesh, labels), device=device))
    if not np.isfinite(float(loss)):
        raise AssertionError(f"SlowFast: non-finite loss {float(loss)}")
    if all(torch.equal(v, stats_before[k]) for k, v in module.named_buffers()):
        raise AssertionError("SlowFast: the BatchNorm statistics did not move")
    params = dict(module.named_parameters())
    return dict(loss=float(loss),
                state={k: v.float().cpu().numpy() for k, v in full_state_dict(module).items() if k in params},
                buffers={k: v.float().cpu().numpy() for k, v in module.named_buffers()})


def _dryrun_rank(cfg, device, frames, labels, sf_cfg, sf_frames, sf_labels) -> dict:
    out = _videomae_rank(cfg, device, frames, labels)
    out["slowfast"] = _slowfast_rank(sf_cfg, device, sf_frames, sf_labels)
    return out


def _videomae_rank(cfg, device, frames, labels) -> dict:
    from vtm_torch.models import ModelBundle
    from vtm_torch.merge.policy import MergePolicy
    from vtm_torch.models.videomae import VideoMAE, VideoMAEConfig
    from vtm_torch.parallel.mesh import shard_batch
    from vtm_torch.parallel.sharding import full_state_dict
    from vtm_torch.tools.train_net import build_trainer
    from vtm_torch.train.optimizer import set_lr

    policy = MergePolicy(**POLICY)
    module = VideoMAE(VideoMAEConfig(**ARCH), policy=policy, fp32_params=True).to(device)
    trainer = build_trainer(cfg, device, bundle=ModelBundle(module=module, policy=policy, name="VideoMAE"))
    mesh = trainer.mesh
    qkv = module.blocks[0].attn.qkv.weight
    if tuple(qkv.shape) != (3 * ARCH["embed_dim"] // mesh.model, ARCH["embed_dim"]):
        raise AssertionError(f"qkv not cut {mesh.model} ways: {tuple(qkv.shape)}")
    start = {k: v.clone() for k, v in full_state_dict(module).items()}
    set_lr(trainer.optimizer, trainer.lr_at(0.0))
    x = torch.as_tensor(shard_batch(mesh, frames), device=device)
    y = torch.as_tensor(shard_batch(mesh, labels), device=device)
    loss, logits, _ = trainer.train_step(x, y)
    if not np.isfinite(float(loss)):
        raise AssertionError(f"non-finite loss {float(loss)}")
    if tuple(logits.shape) != (frames.shape[0] // mesh.data, ARCH["num_classes"]):
        raise AssertionError(f"logits {tuple(logits.shape)}")
    after = {k: v.float().cpu().numpy() for k, v in full_state_dict(module).items()}
    if all(np.array_equal(after[k], start[k].float().cpu().numpy()) for k in after):
        raise AssertionError("no parameter moved")
    return dict(rank=mesh.rank, mesh=mesh.shape, loss=float(loss), qkv_shape=tuple(qkv.shape), state=after)


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None, backend: Optional[str] = None,
                     join_timeout: Optional[float] = None, num_threads: Optional[int] = None) -> list:
    """One step of each half on ``n_devices`` ranks (``devices``: default
    the first ``n_devices`` CUDA devices); returns every rank's result, the
    SlowFast half's under ``"slowfast"``."""
    devices = list(devices) if devices is not None else [f"cuda:{i}" for i in range(n_devices)]
    if len(devices) != n_devices:
        raise ValueError(f"need {n_devices} devices, given {len(devices)}")
    cfg = dryrun_cfg(n_devices)
    args = batch(n_devices) + (slowfast_cfg(n_devices),) + slowfast_batch(n_devices)
    out = launch_job(cfg, _dryrun_rank, devices, backend=backend, args=args,
                     join_timeout=join_timeout, num_threads=num_threads)
    print(f"dryrun_multichip({n_devices}): mesh {out[0]['mesh']}, loss {out[0]['loss']:.4f}, "
          f"qkv {out[0]['qkv_shape']} a rank ok; SlowFast step loss {out[0]['slowfast']['loss']:.4f}",
          flush=True)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n_devices", type=int)
    parser.add_argument("--cpu", action="store_true", help="CPU ranks over gloo")
    args = parser.parse_args(argv)
    if args.cpu:
        dryrun_multichip(args.n_devices, devices=["cpu"] * args.n_devices, backend="gloo", num_threads=1)
    else:
        dryrun_multichip(args.n_devices)


if __name__ == "__main__":
    main()
