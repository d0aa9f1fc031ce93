"""What the port's contrastive tests share (imported by
``tests/test_torch_contrastive.py``, ``test_torch_contrastive_heads.py`` and
``test_torch_contrastive_train.py``; collects no test itself).

Tiny contrastive configs on the conv families' tiny backbones
(``torch_conv_cases.tiny_opts``: width 8, ResNet-18 stages, 8 frames at a
32-pixel crop) and on the tiny MViT (``torch_mvit_cases.BASE``), the same
options in both packages' configs. A ``Case`` builds ``vtm``'s params from
the port's seeded backbone (its running statistics moved off their init),
checks them against ``jax.eval_shape`` of ``vtm``'s ``init``, draws ``vtm``'s
state (``init_state``, ``init_swav_prototypes``) and loads the whole of it
into the port's ``ContrastiveModel`` through the weight bridge
(``contrastive_state_dict_from_vtm``, strictly), so both packages start
from the same weights, queues and banks.

``vtm``'s ``BatchNorm`` reduces over axes (0, 1, 2, 3), so in training it
fails on the 2-D input of an MLP head's BatchNorm (``CONTRASTIVE.BN_MLP``;
ROADMAP.md Queue 3). ``vtm_bn_over_all_but_channels`` swaps in a copy of it
that reduces over every axis but the channel's, the same on 5-D inputs;
the tests run ``vtm`` under it where ``BN_MLP`` is on.
"""

from __future__ import annotations

import contextlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch

import vtm.models.convnet as jconvnet
from vtm.checkpoints.convert import convert_mvit, convert_pyslowfast
from vtm.models.contrastive import ContrastiveModel as JaxContrastiveModel
from vtm.models.contrastive import build_contrastive_model as jax_build_contrastive_model

from vtm_torch.checkpoints.convert import contrastive_state_dict_from_vtm
from vtm_torch.models.contrastive import build_contrastive_model

from torch_conv_cases import cfgs, moved_state, tiny_opts, tree_paths
from torch_mvit_cases import BASE as MVIT_BASE

# fp32 parity, of the largest entry: logits, losses, every state entry
TOL = 1e-5

SSL = ["MODEL.NUM_CLASSES", "8", "CONTRASTIVE.DIM", "8", "CONTRASTIVE.QUEUE_LEN", "16", "CONTRASTIVE.LENGTH", "12",
       "CONTRASTIVE.T", "0.1", "CONTRASTIVE.MOMENTUM", "0.5", "CONTRASTIVE.KNN_ON", "True",
       "CONTRASTIVE.NUM_MLP_LAYERS", "2", "CONTRASTIVE.MLP_DIM", "16", "RESNET.ZERO_INIT_FINAL_BN", "True",
       "MODEL.DROPOUT_RATE", "0.0"]
MVIT = [o for o in MVIT_BASE]
MVIT[MVIT.index("MODEL.MODEL_NAME") + 1] = "ContrastiveModel"


def ssl_opts(ctype: str, *extra, arch: str = "slow") -> list:
    base = MVIT if arch == "mvit" else tiny_opts("ContrastiveModel", arch)
    return base + SSL + ["CONTRASTIVE.TYPE", ctype] + list(extra)


class _BatchNormAllButChannels(fnn.Module):
    """``vtm.models.convnet.BatchNorm`` with its statistics over every axis
    but the last: the same parameters, statistics and arithmetic, for any
    rank (in the dtype that module's ``jnp.float32`` names, so an fp64
    reference stays fp64)."""

    spec: jconvnet.NormSpec
    zero_init: bool = False
    num_splits: int = 1

    @fnn.compact
    def __call__(self, x, train: bool = False):
        assert self.num_splits == 1
        if self.spec.frozen:
            train = False
        c = x.shape[-1]
        scale = self.param("scale", fnn.initializers.zeros if self.zero_init else fnn.initializers.ones, (c,))
        bias = self.param("bias", fnn.initializers.zeros, (c,))
        f32 = jconvnet.jnp.float32
        ra_mean = self.variable("batch_stats", "mean", lambda: jnp.zeros((c,), f32))
        ra_var = self.variable("batch_stats", "var", lambda: jnp.ones((c,), f32))
        if train:
            xf = x.astype(f32)
            axes = tuple(range(x.ndim - 1))
            mean, var = xf.mean(axis=axes), xf.var(axis=axes)
            if not self.is_initializing():
                m = self.spec.momentum
                ra_mean.value = (1 - m) * ra_mean.value + m * mean
                ra_var.value = (1 - m) * ra_var.value + m * var
            y = (xf - mean) / jnp.sqrt(var + self.spec.eps)
        else:
            y = (x.astype(f32) - ra_mean.value) / jnp.sqrt(ra_var.value + self.spec.eps)
        return (y * scale + bias).astype(x.dtype)


@contextlib.contextmanager
def vtm_bn_over_all_but_channels():
    saved = jconvnet.BatchNorm
    jconvnet.BatchNorm = _BatchNormAllButChannels
    try:
        yield
    finally:
        jconvnet.BatchNorm = saved


def mvit_vtm_tree(sd: dict, depth: int):
    """``vtm``'s MViT params and statistics from the port's state dict: the
    trunk by ``convert_mvit``, the MLP head (``head.projection.{fc,bn}{k}``)
    by hand, since ``convert_mvit`` reads a linear head only."""
    params = convert_mvit({k: v for k, v in sd.items() if not k.startswith("head.")}, depth=depth)
    head, stats = {}, {}
    for k, v in sd.items():
        if not k.startswith("head.projection."):
            continue
        layer, leaf = k[len("head.projection."):].split(".")
        if leaf.startswith("running_"):
            stats.setdefault(layer, {})[leaf[len("running_"):]] = v
        elif layer.startswith("fc"):
            head.setdefault(layer, {})["kernel" if leaf == "weight" else "bias"] = v.T if leaf == "weight" else v
        else:
            head.setdefault(layer, {})["scale" if leaf == "weight" else "bias"] = v
    params["head"] = head
    return params, ({"head": stats} if stats else None)


class Case:
    """One tiny contrastive model in both packages from the same weights and
    state (module docstring). ``jmodel`` is ``vtm``'s ``ContrastiveModel``,
    ``model`` the port's (train mode)."""

    def __init__(self, ctype: str, *extra, arch: str = "slow", seed: int = 0):
        self.cfg, self.jcfg = cfgs(ssl_opts(ctype, *extra, arch=arch))
        self.arch = arch
        self.model, _ = build_contrastive_model(self.cfg, "cpu")
        self.jmodel, self.jbundle = jax_build_contrastive_model(self.jcfg, init=False)
        t, s = self.cfg.DATA.NUM_FRAMES, self.cfg.DATA.TRAIN_CROP_SIZE
        x = jnp.zeros((1, t, s, s, 3))
        if arch == "slowfast":
            x = [x[:, ::self.cfg.SLOWFAST.ALPHA], x]
        shapes = jax.eval_shape(self.jbundle.module.init, jax.random.key(0), x)
        if arch == "mvit":
            sd = {k: v.numpy() for k, v in self.model.backbone.state_dict().items()}
            sd.update({k: v for k, v in moved_state(self.model.backbone, seed, weights=False).items()
                       if "running" in k})
            self.params, self.stats = mvit_vtm_tree(sd, self.cfg.MVIT.DEPTH)
            # vtm predicts BatchNorm state from the family, which MViT's MLP
            # head's BatchNorms escape
            self.jmodel = JaxContrastiveModel(self.jbundle.module, self.jmodel.cc,
                                              has_batch_stats=self.stats is not None)
        else:
            sd = moved_state(self.model.backbone, seed, weights=False)
            self.params, self.stats = convert_pyslowfast(
                {k.replace("predictors.", "predictors_"): v for k, v in sd.items()})
        assert tree_paths(shapes["params"]) == tree_paths(self.params), (
            sorted(tree_paths(shapes["params"]) ^ tree_paths(self.params))[:6])
        assert tree_paths(shapes.get("batch_stats", {})) == tree_paths(self.stats or {})
        self.state = jax.tree_util.tree_map(np.asarray, self.jmodel.init_state(
            self.params, self.stats, jax.random.key(seed)))
        self.protos = (jax.tree_util.tree_map(np.asarray, self.jmodel.init_swav_prototypes(jax.random.key(seed + 1)))
                       if ctype == "swav" else None)
        self.load()

    def load(self) -> None:
        """The port's model from ``vtm``'s params, statistics and state, strictly."""
        self.model.load_state_dict(
            contrastive_state_dict_from_vtm(self.params, self.stats, self.state, self.protos), strict=True)
        self.model.train()

    def clips(self, n: int, batch: int, seed: int) -> list:
        """``n`` clips of ``batch`` random videos as numpy pathway lists."""
        rng = np.random.default_rng(seed)
        t, s = self.cfg.DATA.NUM_FRAMES, self.cfg.DATA.TRAIN_CROP_SIZE
        out = []
        for _ in range(n):
            # a colour offset a video: pooled features that differ across the
            # batch (a BatchNorm over near-equal rows cancels its digits away)
            x = (rng.standard_normal((batch, t, s, s, 3)) + 2 * rng.standard_normal((batch, 1, 1, 1, 3)))
            x = x.astype(np.float32)
            out.append([x[:, ::self.cfg.SLOWFAST.ALPHA].copy(), x] if self.arch == "slowfast" else [x])
        return out

    def jax_forward(self, clips, index, **kw):
        """``vtm``'s ``forward_train`` jitted: (logits, loss, the port's state
        dict of its new params, statistics and state)."""
        if self.protos is not None:
            kw = dict(kw, proto_params=self.protos)
        fwd = jax.jit(lambda p, bn, st, c, i: self.jmodel.forward_train(p, bn, st, c, i, **kw))
        with vtm_bn_over_all_but_channels():
            logits, loss, aux = fwd(self.params, self.stats, self.state, [[jnp.asarray(p) for p in c] for c in clips],
                                    jnp.asarray(index))
        state = jax.tree_util.tree_map(np.asarray, aux["new_state"])
        bn = jax.tree_util.tree_map(np.asarray, aux["new_bn"]) if aux["new_bn"] is not None else None
        return np.asarray(logits), float(loss), contrastive_state_dict_from_vtm(self.params, bn, state, self.protos)

    def port_forward(self, clips, index, **kw):
        logits, loss = self.model([[torch.from_numpy(p) for p in c] for c in clips], torch.as_tensor(index), **kw)
        return logits.detach().numpy(), float(loss.detach())


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def assert_state_matches(model: torch.nn.Module, want: dict, tol: float = TOL, names=None) -> dict:
    """Every entry of ``want`` (the port's names) against ``model``'s state
    dict, each within ``tol`` of its largest entry (integers and flags
    exactly). Returns the errors."""
    own = model.state_dict()
    errs = {}
    for k in names if names is not None else want:
        got, w = own[k], want[k]
        if w.dtype in (torch.bool, torch.int64, torch.int32):
            assert torch.equal(got, w.to(got.dtype)), (k, got, w)
            continue
        errs[k] = rel_err(got.numpy(), w.numpy())
        assert errs[k] <= tol, f"{k}: {errs[k]:.3g} of the largest entry > {tol}"
    return errs
