"""Contrastive video pretraining in PyTorch: port of ``vtm/models/contrastive.py``.

``ContrastiveModel`` wraps a backbone built with the SSL head (projection
width ``MODEL.NUM_CLASSES``, ``CONTRASTIVE.NUM_MLP_LAYERS`` /
``PREDICTOR_DEPTHS``; ``convnet.MLPHead``) and runs one of ``vtm``'s five
branches (``CONTRASTIVE.TYPE``): ``moco`` (a momentum encoder and a queue of
keys), ``byol`` (a momentum encoder and a predictor), ``simclr``, ``swav``
(1000 prototypes, Sinkhorn-Knopp, an optional queue) and ``mem`` (a memory
bank of every sample's embedding). ``vtm`` threads its mutable state through
the step as a pytree; here it lives on the module, so ``state_dict()``
carries it: the momentum encoder ``backbone_hist`` (parameters that take no
gradient, and its own BatchNorm statistics) and the buffers ``iter``,
``ptr``, ``queue_x``, ``queue_swav``, ``swav_use_the_queue``, ``memory`` and
``knn_mem``, each where the branch has it. ``forward`` updates them in place,
as ``vtm``'s returned state would replace them; the queue is replaced by a
new tensor, because the logits' backward still reads the old one.

What ``vtm`` computes and this keeps: the momentum encoder copies the online
parameters at ``iter`` 0 and blends ``p (1 - m) + h m`` after, from the
parameters before the optimizer's step; key clips of one shape go through one
concatenated forward, so train-mode BatchNorm normalises over the combined
batch; ``iter`` counts momentum updates (keys given from outside leave it and
the queue alone); BYOL's loss is symmetric over two clips with the BatchNorm
state chained from the first query forward into the second, and its, SimCLR's
and SwAV's "logits" are dummy ``[9999, 0 x QUEUE_LEN]`` rows; SimCLR
subtracts the diagonal from the row sum of ``exp(sim / T)``; SwAV's queue
takes part once ``epoch_exact >= 15`` and the use flag or a non-zero last row
is set, and rolls whenever ``epoch_exact >= 15``; ``mem``'s negatives have
the sample's own index in column 0, and its bank is one [LENGTH, DIM] buffer
for both ``MEM_TYPE`` values; the banks update by a momentum blend
re-normalised at the batch's indices.

Randomness is torch's: dropout and ``mem``'s negatives draw from the
forward's ``generator`` (``vtm`` draws from JAX keys); ``_mem`` takes the
negatives as ``neg_index`` where a test puts in ``vtm``'s draw. One process:
no shuffled BatchNorm, as in ``vtm``.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from vtm_torch.merge.policy import MergePolicy
from vtm_torch.models.build import MODEL_REGISTRY, ModelBundle, register_model


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x / ||x||_2 (upstream's ``Normalize``)."""
    return x / x.square().sum(dim=dim, keepdim=True).sqrt()


@dataclasses.dataclass(frozen=True)
class ContrastiveConfig:
    """The static knobs (``cfg.CONTRASTIVE.*`` and the epoch count): copy of
    ``vtm``'s."""

    type: str
    t: float
    dim: int
    length: int
    queue_len: int
    mmt: float
    momentum_annealing: bool
    max_epoch: float
    knn_on: bool
    mem_type: str
    interp_memory: bool
    moco_multi_view_queue: bool
    swav_qeue_len: int
    sequential: bool
    simclr_dist_on: bool
    num_classes_downstream: int
    swav_prototypes: int = 1000  # hardcoded upstream
    swav_eps_sinkhorn: float = 0.05
    knn_k: int = 200


def contrastive_config_from_cfg(cfg) -> ContrastiveConfig:
    return ContrastiveConfig(
        type=cfg.CONTRASTIVE.TYPE,
        t=cfg.CONTRASTIVE.T,
        dim=cfg.CONTRASTIVE.DIM,
        length=cfg.CONTRASTIVE.LENGTH,
        queue_len=cfg.CONTRASTIVE.QUEUE_LEN,
        mmt=cfg.CONTRASTIVE.MOMENTUM,
        momentum_annealing=cfg.CONTRASTIVE.MOMENTUM_ANNEALING,
        max_epoch=float(cfg.SOLVER.MAX_EPOCH),
        knn_on=cfg.CONTRASTIVE.KNN_ON,
        mem_type=cfg.CONTRASTIVE.MEM_TYPE,
        interp_memory=cfg.CONTRASTIVE.INTERP_MEMORY,
        moco_multi_view_queue=cfg.CONTRASTIVE.MOCO_MULTI_VIEW_QUEUE,
        swav_qeue_len=cfg.CONTRASTIVE.SWAV_QEUE_LEN,
        sequential=cfg.CONTRASTIVE.SEQUENTIAL,
        simclr_dist_on=cfg.CONTRASTIVE.SIMCLR_DIST_ON,
        num_classes_downstream=cfg.CONTRASTIVE.NUM_CLASSES_DOWNSTREAM,
    )


def contrastive_loss(logits: torch.Tensor) -> torch.Tensor:
    """Cross-entropy against the positive in column 0."""
    return -torch.log_softmax(logits, dim=1)[:, 0].mean()


def momentum_anneal_cosine(cc: ContrastiveConfig, epoch_exact: float) -> float:
    """The momentum at ``epoch_exact`` under ``MOMENTUM_ANNEALING``: from
    ``MOMENTUM`` up to 1 on a half cosine over ``SOLVER.MAX_EPOCH``."""
    return 1.0 - (1.0 - cc.mmt) * (math.cos(math.pi * epoch_exact / cc.max_epoch) + 1.0) * 0.5


def sinkhorn(Q: torch.Tensor, iters: int) -> torch.Tensor:
    """Single-process Sinkhorn-Knopp: [B, K] positive scores -> the balanced
    assignment [B, K], each row summing to 1 after the last normalisation."""
    Q = Q.T
    Q = Q / Q.sum()
    r, c = 1.0 / Q.shape[0], 1.0 / Q.shape[1]
    for _ in range(iters):
        Q = Q * (r / Q.sum(dim=1))[:, None]
        Q = Q * (c / Q.sum(dim=0))[None, :]
    Q = Q / Q.sum(dim=0, keepdim=True)
    return Q.T


@torch.no_grad()
def memory_update(memory: torch.Tensor, mem: torch.Tensor, momentum: float, ind: torch.Tensor) -> torch.Tensor:
    """Blend ``mem`` into the bank's rows ``ind`` with ``momentum`` and
    re-normalise them, in place (``vtm``'s ``memory_update``). Returns the bank."""
    upd = l2_normalize(memory[ind] * (1.0 - momentum) + mem * momentum)
    memory[ind] = upd.to(memory.dtype)
    return memory


def moco_iters_noupdate(cc: ContrastiveConfig, global_batch: int) -> int:
    """The first iterations of MoCo's first epoch fill the queue without an
    optimizer step: QUEUE_LEN / batch of them."""
    if cc.queue_len % global_batch:
        raise ValueError(f"CONTRASTIVE.QUEUE_LEN {cc.queue_len} is not a multiple of the batch {global_batch}")
    return cc.queue_len // global_batch


def _first(out):
    """The projection of a head that returns [projection, *predictions]."""
    return out[0] if isinstance(out, (list, tuple)) else out


def _dummy_logits(cc: ContrastiveConfig, b: int, like: torch.Tensor) -> torch.Tensor:
    """The [9999, 0 x QUEUE_LEN] rows BYOL, SimCLR and SwAV return as logits."""
    out = like.new_zeros(b, 1 + cc.queue_len)
    out[:, 0] = 9999.0
    return out


class ContrastiveModel(nn.Module):
    """The contrastive family around ``backbone`` (module docstring).
    ``forward(clips, index, epoch_exact, generator, keys, neg_index)`` ->
    (logits, loss) in training mode; ``clips`` is a list of clips, each a
    list of pathway tensors [B, T, H, W, C] (a bare tensor is one
    single-pathway clip, a flat list of tensors one clip's pathways), and
    ``index`` the samples' rows of the banks. The initial queues and banks
    are drawn uniformly in +-1 / sqrt(DIM / 3) from ``seed``."""

    one_process_reason = "contrastive pretraining runs in one process, as vtm's step does"

    def __init__(self, backbone: nn.Module, cc: ContrastiveConfig, seed: int = 0):
        super().__init__()
        if cc.type not in ("moco", "byol", "simclr", "swav", "mem"):
            raise NotImplementedError(
                f"CONTRASTIVE.TYPE {cc.type} (upstream's 'self' type builds nothing and its forward raises)")
        self.cc = cc
        self.backbone = backbone
        gen = torch.Generator().manual_seed(seed)
        stdv = 1.0 / math.sqrt(cc.dim / 3)

        def uniform(*shape, bound=stdv):
            return torch.rand(shape, generator=gen) * (2 * bound) - bound

        self.register_buffer("iter", torch.zeros((), dtype=torch.long))
        if cc.type in ("moco", "byol"):
            self.backbone_hist = copy.deepcopy(backbone).requires_grad_(False)
            self.register_buffer("ptr", torch.zeros((), dtype=torch.long))
            self.register_buffer("queue_x", uniform(cc.queue_len, cc.dim))
        if cc.type == "swav":
            self.swav_prototypes = nn.Linear(cc.dim, cc.swav_prototypes, bias=False)
            with torch.no_grad():
                self.swav_prototypes.weight.copy_(uniform(cc.swav_prototypes, cc.dim, bound=1.0 / math.sqrt(cc.dim)))
            if cc.swav_qeue_len > 0:
                self.register_buffer("queue_swav", torch.zeros(2, cc.swav_qeue_len, cc.dim))
                self.register_buffer("swav_use_the_queue", torch.zeros((), dtype=torch.bool))
        if cc.type == "mem":
            self.register_buffer("memory", uniform(cc.length, cc.dim))
        if cc.knn_on:
            self.register_buffer("knn_mem", uniform(cc.length, cc.dim))

    # -- the encoders ------------------------------------------------------
    def _encode(self, module: nn.Module, clip, generator):
        return module(clip, generator=generator)[0]

    @torch.no_grad()
    def _update_history(self, mmt: float) -> None:
        """The momentum encoder's parameters: the online ones at ``iter``
        0, ``p (1 - mmt) + h mmt`` after."""
        first = self.iter == 0
        for p, h in zip(self.backbone.parameters(), self.backbone_hist.parameters()):
            h.copy_(torch.where(first, p, p * (1.0 - mmt) + h * mmt))

    @torch.no_grad()
    def compute_key_feat(self, clips_k, mmt: float, generator=None) -> list:
        """The normalised keys of ``clips_k`` from the momentum encoder,
        after its update; clips of one shape in one forward."""
        self._update_history(mmt)
        same_shapes = all(p.shape == p0.shape for clip in clips_k for p, p0 in zip(clip, clips_k[0]))
        if len(clips_k) > 1 and same_shapes:
            bsz = clips_k[0][0].shape[0]
            batched = [torch.cat([c[j] for c in clips_k]) for j in range(len(clips_k[0]))]
            key = l2_normalize(_first(self._encode(self.backbone_hist, batched, generator)))
            return [key[i * bsz:(i + 1) * bsz] for i in range(len(clips_k))]
        return [l2_normalize(_first(self._encode(self.backbone_hist, clip, generator))) for clip in clips_k]

    def _knn_mem_update(self, q: torch.Tensor, index: torch.Tensor) -> None:
        if self.cc.knn_on:
            memory_update(self.knn_mem, q.detach(), 1.0, index)

    @torch.no_grad()
    def eval_knn(self, q_knn: torch.Tensor):
        """(scores, rows) of the min(200, LENGTH) bank rows nearest ``q_knn``
        by cosine."""
        return torch.topk(q_knn @ self.knn_mem.T, min(self.cc.knn_k, self.cc.length), dim=1)

    def sim_loss(self, q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        return -((q * k).sum(dim=-1) / self.cc.t).mean()

    @torch.no_grad()
    def dequeue_and_enqueue(self, keys) -> None:
        """Write the keys (the first only, unless ``MOCO_MULTI_VIEW_QUEUE``)
        at ``ptr``; a new queue tensor."""
        cc = self.cc
        queue, ptr = self.queue_x, self.ptr
        for key in keys if cc.moco_multi_view_queue else keys[:1]:
            bsz = key.shape[0]
            if cc.queue_len % bsz:
                raise ValueError(f"CONTRASTIVE.QUEUE_LEN {cc.queue_len} is not a multiple of the batch {bsz}")
            # vtm's dynamic_update_slice clamps the start into the queue
            rows = ptr.clamp(max=cc.queue_len - bsz) + torch.arange(bsz, device=queue.device)
            queue = queue.index_copy(0, rows, key.to(queue.dtype))
            ptr = (ptr + bsz) % cc.queue_len
        self.queue_x = queue
        self.ptr.copy_(ptr)

    # -- the branches ------------------------------------------------------
    def forward(self, clips, index: torch.Tensor, epoch_exact: float = 0.0,
                generator: Optional[torch.Generator] = None, keys=None, neg_index: Optional[torch.Tensor] = None):
        cc = self.cc
        mmt = momentum_anneal_cosine(cc, epoch_exact) if cc.momentum_annealing else cc.mmt
        if not isinstance(clips, (list, tuple)):
            clips = [[clips]]
        elif not isinstance(clips[0], (list, tuple)):
            clips = [clips]
        if cc.type == "moco":
            return self._moco(clips, index, mmt, generator, keys)
        if cc.type == "byol":
            return self._byol(clips, index, mmt, generator, keys)
        if cc.type == "simclr":
            return self._simclr(clips, index, generator)
        if cc.type == "swav":
            return self._swav(clips, index, epoch_exact, generator)
        return self._mem(clips, index, mmt, generator, neg_index)

    def _moco(self, clips, index, mmt, generator, keys):
        cc = self.cc
        auto_enqueue = keys is None
        if auto_enqueue:
            keys = self.compute_key_feat(clips[1:], mmt, generator)
        q = l2_normalize(_first(self._encode(self.backbone, clips[0], generator)))
        queue_neg = q @ self.queue_x.T
        logits = torch.cat([torch.cat([(q * key).sum(dim=1, keepdim=True), queue_neg], dim=1) for key in keys])
        logits = logits / cc.t
        loss = contrastive_loss(logits)
        if auto_enqueue:
            self.iter += 1
            self.dequeue_and_enqueue(keys)
        self._knn_mem_update(q, index)
        return logits, loss

    def _byol(self, clips, index, mmt, generator, keys):
        auto_keys = keys is None
        if auto_keys:
            keys = self.compute_key_feat(clips, mmt, generator)
        out_q = self._encode(self.backbone, clips[0], generator)
        if not isinstance(out_q, (list, tuple)) or len(out_q) != 2:
            raise ValueError("BYOL needs a predictor head (CONTRASTIVE.PREDICTOR_DEPTHS)")
        q = l2_normalize(out_q[0])
        predictor1 = l2_normalize(out_q[1])
        if len(clips) == 1:
            loss = self.sim_loss(predictor1, keys[0])
        else:
            if len(clips) != 2:
                raise ValueError(f"BYOL takes one or two clips, not {len(clips)}")
            predictor2 = l2_normalize(self._encode(self.backbone, clips[1], generator)[1])
            loss = self.sim_loss(predictor1, keys[1]) + self.sim_loss(predictor2, keys[0])
        if auto_keys:
            self.iter += 1
        self._knn_mem_update(q, index)
        return _dummy_logits(self.cc, q.shape[0], q), loss

    def _simclr(self, clips, index, generator):
        t = self.cc.t
        q = l2_normalize(_first(self._encode(self.backbone, clips[0], generator)))
        q2 = l2_normalize(_first(self._encode(self.backbone, clips[1], generator)))
        out = torch.cat([q, q2])
        sim = torch.exp(out @ out.T / t)
        denom = sim.sum(dim=1) - torch.diagonal(sim)
        pos = torch.exp((q * q2).sum(dim=-1) / t)
        pos = torch.cat([pos, pos])
        loss = (-torch.log(pos / denom)).mean()
        self.iter += 1
        self._knn_mem_update(q, index)
        return _dummy_logits(self.cc, q.shape[0], q), loss

    def _swav(self, clips, index, epoch_exact: float, generator):
        """``swav_prototypes`` must already be row-normalised (the train
        step does it before the forward, outside the graph)."""
        cc = self.cc
        n_clips, bs = len(clips), clips[0][0].shape[0]
        embedding, output = [], []
        for clip in clips:
            proj = l2_normalize(_first(self._encode(self.backbone, clip, generator)))
            embedding.append(proj)
            output.append(self.swav_prototypes(proj))
        q_knn = embedding[0]
        embedding, output = torch.cat(embedding), torch.cat(output)
        queue = getattr(self, "queue_swav", None)
        warm = epoch_exact >= 15.0
        loss = 0.0
        for i in range(2):
            with torch.no_grad():
                out = output[bs * i:bs * (i + 1)]
                q_assign = sinkhorn(torch.exp(out / cc.swav_eps_sinkhorn), 3)[-bs:]
                if queue is not None and warm:
                    # the queue takes part once the flag or its last row is set
                    active = self.swav_use_the_queue | (queue[i, -1] != 0).any()
                    self.swav_use_the_queue.copy_(active)
                    full = torch.cat([self.swav_prototypes(queue[i]), out])
                    with_queue = sinkhorn(torch.exp(full / cc.swav_eps_sinkhorn), 3)[-bs:]
                    q_assign = torch.where(active, with_queue, q_assign)
                    queue[i] = torch.cat([embedding[i * bs:(i + 1) * bs], queue[i, :-bs]])
            subloss = 0.0
            for v in range(n_clips):
                if v == i:
                    continue
                p = torch.softmax(output[bs * v:bs * (v + 1)] / cc.t, dim=1)
                subloss = subloss - (q_assign * torch.log(p)).sum(dim=1).mean()
            loss = loss + subloss / (n_clips - 1)
        loss = loss / 2
        self.iter += 1
        self._knn_mem_update(q_knn, index)
        return _dummy_logits(cc, bs, q_knn), loss

    def _mem(self, clips, index, mmt, generator, neg_index):
        """``neg_index``: [B, QUEUE_LEN + 1] rows of the bank (column 0 is
        overwritten with ``index``); drawn from ``generator`` when None."""
        cc = self.cc
        q = l2_normalize(_first(self._encode(self.backbone, clips[0], generator)))
        bsz = q.shape[0]
        if neg_index is None:
            neg_index = torch.randint(0, cc.length, (bsz, cc.queue_len + 1), generator=generator, device=q.device)
        clip_ind = neg_index.clone()
        clip_ind[:, 0] = index
        k = self.memory[clip_ind]  # [B, K + 1, dim]
        prod = torch.einsum("nc,nkc->nk", q, k) / cc.t
        loss = contrastive_loss(prod)
        memory_update(self.memory, q.detach(), mmt, index)
        self.iter += 1
        self._knn_mem_update(q, index)
        return prod, loss

    @torch.no_grad()
    def features(self, clip) -> torch.Tensor:
        """The backbone's normalised projection of ``clip`` in eval mode
        (running BatchNorm statistics, no dropout), for the kNN eval."""
        training = self.training
        self.eval()
        try:
            return l2_normalize(_first(self._encode(self.backbone, clip, None)))
        finally:
            self.train(training)


@torch.no_grad()
def knn_predict(model: ContrastiveModel, q_knn: torch.Tensor, train_labels, num_classes: int) -> torch.Tensor:
    """kNN class scores from the bank: the neighbours' labels as one-hots
    weighted by exp(score / T), summed. As in ``vtm``, a row past the end of
    ``train_labels`` reads its last label and a label past ``num_classes``
    votes for no class (JAX's clamped gather and ``one_hot``)."""
    yd, yi = model.eval_knn(q_knn)
    weights = torch.exp(yd / model.cc.t)
    labels = torch.as_tensor(np.asarray(train_labels), device=q_knn.device)
    retrieval = labels[yi.clamp(max=labels.numel() - 1)]
    onehot = (retrieval[..., None] == torch.arange(num_classes, device=q_knn.device)).to(weights.dtype)
    return (onehot * weights[..., None]).sum(dim=1)


# the backbone family of each MODEL.ARCH (upstream's _MODEL_TYPES)
_ARCH_TO_MODEL = {
    "slowfast": "SlowFast",
    "slow": "ResNet",
    "c2d": "ResNet",
    "i3d": "ResNet",
    "slow_c2d": "ResNet",
    "x3d": "X3D",
    "mvit": "MViT",
}


def _backbone_bundle(cfg, fp32_params: bool) -> ModelBundle:
    backbone_cfg = cfg.clone()
    backbone_cfg.MODEL.MODEL_NAME = _ARCH_TO_MODEL[cfg.MODEL.ARCH]
    return MODEL_REGISTRY[backbone_cfg.MODEL.MODEL_NAME](backbone_cfg, fp32_params)


def build_contrastive_model(cfg, device: torch.device | str, fp32_params: bool = True):
    """-> (ContrastiveModel on ``device`` in eval mode, the backbone's
    bundle). The backbone is the ``MODEL.ARCH`` family with the SSL head."""
    bundle = _backbone_bundle(cfg, fp32_params)
    model = ContrastiveModel(bundle.module, contrastive_config_from_cfg(cfg), seed=cfg.RNG_SEED)
    model.to(device).eval()
    return model, bundle


@register_model("ContrastiveModel", ContrastiveModel)
def _build_contrastive_bundle(cfg, fp32_params: bool = False) -> ModelBundle:
    """As in ``vtm``, ``build_model`` of a ``ContrastiveModel`` config gives
    the backbone's bundle (``build_contrastive_model`` wraps it)."""
    bundle = _backbone_bundle(cfg, fp32_params)
    return ModelBundle(module=bundle.module, policy=MergePolicy(), name=bundle.name)
