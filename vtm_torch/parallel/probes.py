"""Rank bodies that check the parallel paths: what each rank of a
``launch_job`` runs for the port's parallel tests (on the CPU over gloo)
and for ``chip_smoke.py``'s ``dist`` phase (on the card).

They live in the package so that a spawned rank imports torch and
``vtm_torch`` only. Each is ``fn(cfg, device, ...)`` and returns host
data for the launching process to hold against a one-process run:

  * ``train_probe``: ``train_net``'s trainer (mesh, cuts, DDP) takes a step
    on this rank's rows of a global batch; the global loss, the
    gradients the optimizer saw and the parameters after, each gathered
    whole (or their sha256), the Matchings of the first forward, the cut
    shapes and the kernels' launches.
  * ``bn_probe``: a conv and a BatchNorm with its statistics over the
    group's global batch (``convnet.set_sync_group``), plain or with
    sub-batch splits: output rows, the gradients of the global loss and
    the running statistics after one train-mode forward;
  * ``eval_probe``: one eval forward of this rank's rows: the logits of
    the whole batch, the Matchings, the tokens entering each block, the
    head counts the dense kernel saw and its launches;
  * ``run_probes``: several of these (and ``test_net.test``,
    ``model_benchmark``) in one launch, each timed.

A model is built from ``cfg`` (``build_model``), or from a spec
``(family, config kwargs, policy kwargs, state dict or None)`` for the
tiny models the tests hold against ``vtm``.
"""

from __future__ import annotations

import contextlib
import hashlib
import time
from typing import Optional

import numpy as np
import torch

from vtm_torch.merge import bipartite
from vtm_torch.merge.policy import MergePolicy
from vtm_torch.models import ModelBundle, build_model
from vtm_torch.models import common
from vtm_torch.models.videomae import VideoMAE, VideoMAEConfig
from vtm_torch.models.vivit import ViViT, ViViTConfig
from vtm_torch.ops import flash_attention
from vtm_torch.parallel.mesh import make_mesh, process_allgather, replicate, shard_batch
from vtm_torch.parallel.sharding import full_state_dict, gather, is_cut, shard_module

COUNTERS = ("LAUNCHES", "BWD_LAUNCHES", "FRAME_LAUNCHES", "FRAME_BWD_LAUNCHES",
            "BLOCKDIAG_LAUNCHES", "BLOCKDIAG_BWD_LAUNCHES")
FAMILIES = {"VideoMAE": (VideoMAE, VideoMAEConfig), "ViViT": (ViViT, ViViTConfig)}


def launch_counts() -> dict:
    return {c: getattr(flash_attention, c) for c in COUNTERS}


def bundle_of(spec, cfg, device: torch.device, fp32_params: bool) -> ModelBundle:
    """The model a probe runs: from ``cfg``, or from a tiny-model spec."""
    if spec is None:
        return build_model(cfg, device, fp32_params=fp32_params)
    family, config_kw, policy_kw, state = spec
    cls, config_cls = FAMILIES[family]
    policy = MergePolicy(**policy_kw)
    module = cls(config_cls(**config_kw), policy=policy, fp32_params=fp32_params)
    if state is not None:
        module.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in state.items()})
    return ModelBundle(module=module.to(device).eval(), policy=policy, name=family)


def _matching_arrays(m):
    if m is None:
        return None
    return dict(n=m.n, r=m.r, **{k: getattr(m, k).cpu().numpy() for k in ("unm_idx", "src_idx", "dst_idx")})


@contextlib.contextmanager
def recording(seen: dict):
    """Record every Matching made (``seen["matchings"]``) and the head
    count of every dense-kernel call (``seen["k1_heads"]``) inside."""
    match, kernel = bipartite._match, common.tome_flash_attention

    def recording_match(*args, **kwargs):
        m = match(*args, **kwargs)
        seen.setdefault("matchings", []).append(_matching_arrays(m))
        return m

    def recording_kernel(q, *args, **kwargs):
        seen.setdefault("k1_heads", []).append(int(q.shape[1]))
        return kernel(q, *args, **kwargs)

    bipartite._match, common.tome_flash_attention = recording_match, recording_kernel
    try:
        yield seen
    finally:
        bipartite._match, common.tome_flash_attention = match, kernel


def _blocks(module):
    return module.blocks if hasattr(module, "blocks") else module.layer


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().float().cpu().contiguous().numpy().tobytes()).hexdigest()


def _whole_state(module, want_state: bool) -> dict:
    sd = {k: v for k, v in full_state_dict(module).items() if k in dict(module.named_parameters())}
    if want_state:
        return {k: v.detach().float().cpu().numpy() for k, v in sd.items()}
    return {k: digest(v) for k, v in sd.items()}


def _buffers(module, want_state: bool) -> dict:
    """The module's buffers (the conv families' BatchNorm statistics)."""
    return {k: (v.float().cpu().numpy() if want_state else digest(v)) for k, v in module.named_buffers()}


def _cut_shapes(module) -> dict:
    return {n: tuple(p.shape) for n, p in module.named_parameters() if is_cut(p)}


def train_probe(cfg, device, spec, frames, labels, want_state: bool = True,
                checkpoint_dir: Optional[str] = None, generators: bool = False, epoch: float = 0.0) -> dict:
    """One step of ``train_net.build_trainer``'s trainer on this rank's rows
    of the global batch ``frames`` / ``labels`` (numpy), at the schedule's
    learning rate of ``epoch``. ``generators``: the step draws from
    ``train_epoch``'s generator of (epoch, iter 0). Gradients are read as
    the optimizer's step sees them (after DDP's all-reduce and the clip);
    ``want_state`` False returns sha256 digests in place of arrays.
    ``checkpoint_dir``: ``save_checkpoint`` there after the step."""
    from vtm_torch.checkpoints import checkpoint as cu
    from vtm_torch.tools.train_net import _step_generator, build_trainer
    from vtm_torch.train.optimizer import set_lr

    bundle = None if spec is None else bundle_of(spec, cfg, device, fp32_params=True)
    trainer = build_trainer(cfg, device, bundle=bundle)
    mesh, module = trainer.mesh, trainer.module
    names = {id(p): n for n, p in module.named_parameters()}
    grads = {}

    def read_grads(opt, args, kwargs):
        for p in (p for g in opt.param_groups for p in g["params"]):
            whole = gather(p.grad, p.tp_cut) if is_cut(p) else p.grad
            grads[names[id(p)]] = (whole.float().cpu().numpy() if want_state else digest(whole))

    trainer.optimizer.register_step_pre_hook(read_grads)
    set_lr(trainer.optimizer, trainer.lr_at(epoch))
    local_x = torch.as_tensor(shard_batch(mesh, frames), device=device)
    local_y = shard_batch(mesh, labels)
    local_y = ({k: torch.as_tensor(v, device=device) for k, v in local_y.items()}
               if isinstance(local_y, dict) else torch.as_tensor(local_y, device=device))
    gen = _step_generator(device, cfg.RNG_SEED, int(epoch), 0, *mesh.rank_path) if generators else None
    seen = {}
    before = launch_counts()
    with recording(seen):
        loss, logits, aux = trainer.train_step(local_x, local_y, gen)
    launches = {c: n - before[c] for c, n in launch_counts().items()}
    logits = process_allgather(logits, mesh.data_group)
    out = dict(rank=mesh.rank, mesh=mesh.shape, loss=float(loss), aux=[float(a) for a in aux], grads=grads,
               state=_whole_state(module, want_state), buffers=_buffers(module, want_state),
               cut_shapes=_cut_shapes(module),
               matchings=seen.get("matchings", []), launches=launches,
               logits=tuple(l.float().cpu() for l in logits) if isinstance(logits, tuple) else logits.float().cpu())
    if checkpoint_dir is not None:
        out["checkpoint"] = cu.save_checkpoint(checkpoint_dir, module, trainer.optimizer, 0, cfg)
    return out


def bn_probe(cfg, device, state: dict, x, weights, num_splits: int) -> dict:
    """``conv3d`` (4 -> 6 channels, 1x3x3) then ``BatchNorm(num_splits)`` in
    training mode on this rank's rows of ``x`` [B, 4, T, H, W] (numpy, the
    global batch), the statistics over the default group; the loss is the
    global mean of (output * ``weights``) per row. Returns this rank's output
    rows, its rows' input gradient and the parameters' gradients, both of
    the global loss, and the running statistics."""
    from vtm_torch.models.convnet import BatchNorm, NormSpec, conv3d, set_sync_group

    mesh = make_mesh(1, batch_cap=x.shape[0], device_type=device.type)
    net = torch.nn.Sequential(conv3d(4, 6, (1, 3, 3), bias=True), BatchNorm(6, NormSpec(), num_splits=num_splits))
    net.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in state.items()})
    net = net.to(device).train()
    set_sync_group(net, mesh.data_group)
    xs = torch.as_tensor(shard_batch(mesh, x), device=device).requires_grad_(True)
    y = net(xs)
    w = torch.as_tensor(shard_batch(mesh, weights), device=device)
    # this rank's share of the global mean: the backward's all-reduce of the
    # statistics then gives every row its gradient of the global loss
    ((y * w).sum() / x.shape[0]).backward()
    grads = {n: p.grad.clone() for n, p in net.named_parameters()}
    if mesh.data > 1:
        for g in grads.values():
            torch.distributed.all_reduce(g, group=mesh.data_group)
    return dict(out=y.detach().cpu().numpy(), x_grad=xs.grad.cpu().numpy(),
                grads={n: g.cpu().numpy() for n, g in grads.items()},
                buffers={k: v.cpu().numpy() for k, v in net.named_buffers()})


def eval_probe(cfg, device, spec, video) -> dict:
    """One eval forward of this rank's rows of ``video`` (numpy, the
    global batch) on the model cut for ``cfg``'s mesh (weights from
    ``cfg``'s seed or the spec's state, replicated from rank 0)."""
    mesh = make_mesh(cfg.TPU.MODEL_PARALLEL, batch_cap=video.shape[0], device_type=device.type)
    bundle = bundle_of(spec, cfg, device, fp32_params=False)
    module = shard_module(replicate(mesh, bundle.module), mesh)
    tokens = []
    blocks = _blocks(module)
    hooks = [blk.register_forward_pre_hook(lambda m, a: tokens.append(int(a[0].shape[1]))) for blk in blocks]
    hooks.append(blocks[-1].register_forward_hook(lambda m, a, o: tokens.append(int(o[0].shape[1]))))
    seen = {}
    before = launch_counts()
    with torch.inference_mode(), recording(seen):
        logits, _ = module(torch.as_tensor(shard_batch(mesh, video), device=device))
    for h in hooks:
        h.remove()
    launches = {c: n - before[c] for c, n in launch_counts().items()}
    logits = process_allgather(logits, mesh.data_group)
    return dict(rank=mesh.rank, mesh=mesh.shape, logits=logits.float().cpu(), tokens=tokens,
                matchings=seen.get("matchings", []), k1_heads=seen.get("k1_heads", []),
                launches=launches, cut_shapes=_cut_shapes(module))



def _test_net(cfg, device):
    from vtm_torch.tools.test_net import test

    return test(cfg, device)


def _model_benchmark(cfg, device):
    from vtm_torch.tools.model_benchmark import model_benchmark

    return model_benchmark(cfg, device)


PROBES = {"train": train_probe, "eval": eval_probe, "bn": bn_probe, "test_net": _test_net, "model_benchmark": _model_benchmark}


def run_probes(cfg, device, plan) -> list:
    """Several probes in one launch, in order: ``plan`` is a list of
    (name in ``PROBES``, the probe's cfg, its further arguments, its
    keyword arguments); each result gains ``seconds``, this rank's wall
    time for the probe (the first includes building its groups)."""
    out = []
    for name, probe_cfg, args, kwargs in plan:
        t0 = time.perf_counter()
        result = PROBES[name](probe_cfg, device, *args, **kwargs)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        out.append(dict(name=name, result=result, seconds=time.perf_counter() - t0))
    return out
