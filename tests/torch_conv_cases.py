"""What the port's conv-family tests share (imported by
``tests/test_torch_convnet.py``, ``test_torch_slowfast.py``,
``test_torch_slowfast_train.py`` and the PTV, multigrid and Charades
files; collects no test itself).

Tiny SlowFast, ResNet and X3D configs at the sizes of
``tests/test_convnet.py`` and ``__graft_entry__.py:200-213`` (width 8 a
group, ResNet-18 stages, 8 frames at a 32-pixel crop), the same options in
both packages' configs. A ``Case`` builds the port's model from its seed,
moves its BatchNorm weights and statistics away from 1 and 0 with numpy,
and gives ``vtm`` the same weights through ``vtm``'s own
``convert_pyslowfast``; ``vtm``'s forwards are jitted, and its param tree is
checked against ``jax.eval_shape`` of its ``init`` (no eager init: that
takes half a minute a model on the CPU). ``PTVCase`` does the same for the
PTV families (CSN, R(2+1)D) at width 4 on the depth-18 table.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vtm.checkpoints.convert import convert_pyslowfast
from vtm.config import get_cfg as jax_get_cfg
from vtm.models.build import build_model as jax_build_model

from vtm_torch.config import get_cfg
from vtm_torch.models import build_model

OUT_TOL = 1e-4  # outputs, of the largest entry, fp32
# running statistics after a train-mode forward of a whole model, relative to
# each tensor's largest entry: the two packages' fp32 convolutions (XLA,
# oneDNN) round apart by about 1e-7 at the stem, and the batch-statistic
# normalisation of each stage amplifies that, to at most 7.1e-6 before the
# last stage and 1.03e-5 in it (B4 at 1 x 1 pixels a frame there; i3d's
# s5.pathway0_res1.branch2.a_bn.running_var 1.02e-5, the dry run's
# ...a_bn.running_mean 1.03e-5, the rest of s5 at most 9.3e-6). One
# BatchNorm on the same input is held to 1e-6 (tests/test_torch_convnet.py),
# and the statistics in fp64 to FP64_TOL (tests/test_torch_slowfast_train.py).
STATS_TOL = 1e-5
LAST_STAGE_STATS_TOL = 3e-5


def tiny_opts(name: str, arch: str, *extra) -> list:
    two = arch == "slowfast"
    k = 2 if two else 1
    return [
        "MODEL.MODEL_NAME", name, "MODEL.ARCH", arch, "MODEL.NUM_CLASSES", "7", "MODEL.DROPOUT_RATE", "0.0",
        "RESNET.DEPTH", "18", "RESNET.WIDTH_PER_GROUP", "8", "RESNET.ZERO_INIT_FINAL_BN", "False",
        "DATA.NUM_FRAMES", "8", "DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "32",
        "DATA.INPUT_CHANNEL_NUM", str([3] * k), "SLOWFAST.ALPHA", "4", "SLOWFAST.BETA_INV", "8",
        "SLOWFAST.FUSION_CONV_CHANNEL_RATIO", "2", "SLOWFAST.FUSION_KERNEL_SZ", "7",
        "RESNET.NUM_BLOCK_TEMP_KERNEL", str([[2] * k] * 4),
        "RESNET.SPATIAL_STRIDES", str([[1] * k, [2] * k, [2] * k, [2] * k]),
        "RESNET.SPATIAL_DILATIONS", str([[1] * k] * 4), "NONLOCAL.LOCATION", str([[[]] * k] * 4),
        "NONLOCAL.GROUP", str([[1] * k] * 4), "X3D.DIM_C1", "12", "X3D.DIM_C5", "64",
        "TPU.COMPUTE_DTYPE", "float32", *extra,
    ]


X3D = ("RESNET.TRANS_FUNC", "x3d_transform", "RESNET.DEPTH", "50", "X3D.DEPTH_FACTOR", "1.0")
# (family, arch, further options): non-local in both instantiations, with a
# temporal group, FROZEN_BN, and X3D's SE / Swish / depthwise convs
CASES = {
    "slowfast": ("SlowFast", "slowfast", ("NONLOCAL.LOCATION", "[[[], []], [[0], []], [[], []], [[], []]]")),
    "c2d": ("ResNet", "c2d", ()),
    "i3d": ("ResNet", "i3d", ("NONLOCAL.LOCATION", "[[[]], [[0]], [[]], [[]]]", "NONLOCAL.INSTANTIATION", "softmax",
                              "NONLOCAL.GROUP", "[[1], [2], [1], [1]]")),
    "slow": ("ResNet", "slow", ("MODEL.FROZEN_BN", "True")),
    "x3d": ("X3D", "x3d", X3D),
}


def cfgs(opts):
    t, j = get_cfg(), jax_get_cfg()
    t.merge_from_list(list(opts))
    j.merge_from_list(list(opts))
    return t, j


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def tree_paths(tree) -> set:
    return {jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_flatten_with_path(tree)[0]}


def moved_state(module: torch.nn.Module, seed: int, weights: bool = True) -> dict:
    """The module's state dict as numpy, with every running statistic and
    (``weights``) every BatchNorm weight and bias moved off its init
    (weights about 1, variances about 1 and positive)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in module.state_dict().items():
        a = v.float().numpy().copy()
        if not weights and "running" not in k:
            pass
        elif k.endswith(("running_mean", "bias")) and a.ndim == 1:
            a = a + 0.1 * rng.standard_normal(a.shape)
        elif k.endswith("running_var"):
            a = a * np.exp(0.2 * rng.standard_normal(a.shape))
        elif k.endswith("weight") and a.ndim == 1:
            a = 1.0 + 0.1 * rng.standard_normal(a.shape)
        out[k] = a.astype(np.float32)
    return out


class Case:
    """One tiny model in both packages from the same weights."""

    def __init__(self, name: str, *extra, seed: int = 0, move_weights: bool = True):
        family, arch, opts = CASES[name]
        self.opts = tiny_opts(family, arch, *opts, *extra)
        self.cfg, self.jcfg = cfgs(self.opts)
        self.bundle = build_model(self.cfg, "cpu")
        self.state = moved_state(self.bundle.module, seed, move_weights)
        self.bundle.module.load_state_dict({k: torch.from_numpy(v) for k, v in self.state.items()})
        self.jbundle = jax_build_model(self.jcfg, init=False)
        self.params, self.stats = convert_pyslowfast(self.state)
        t, s = self.cfg.DATA.NUM_FRAMES, self.cfg.DATA.TEST_CROP_SIZE
        shapes = jax.eval_shape(self.jbundle.module.init, jax.random.key(0), jnp.zeros((1, t, s, s, 3)))
        assert tree_paths(shapes["params"]) == tree_paths(self.params)
        assert tree_paths(shapes["batch_stats"]) == tree_paths(self.stats)
        module = self.jbundle.module
        self._eval = jax.jit(lambda p, s, x: module.apply({"params": p, "batch_stats": s}, x)[0])
        self._train = jax.jit(lambda p, s, x: module.apply(
            {"params": p, "batch_stats": s}, x, train=True, mutable=["batch_stats"]))

    def video(self, batch: int, seed: int, crop: int = 32) -> np.ndarray:
        t = self.cfg.DATA.NUM_FRAMES
        return np.random.default_rng(seed).standard_normal((batch, t, crop, crop, 3)).astype(np.float32)

    def jax_eval(self, x) -> np.ndarray:
        return np.asarray(self._eval(self.params, self.stats, jnp.asarray(x)))

    def jax_train(self, x):
        """(logits, the statistics after the forward) in ``vtm``."""
        (logits, _), mutated = self._train(self.params, self.stats, jnp.asarray(x))
        return np.asarray(logits), np_tree(mutated["batch_stats"])


def assert_close_to_largest(got, want, tol: float, what: str = "") -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: {err:.3g} of the largest entry > {tol}"


def stats_tol(name: str) -> float:
    """STATS_TOL for a running statistic, LAST_STAGE_STATS_TOL in the last stage (s5)."""
    return LAST_STAGE_STATS_TOL if name.startswith("s5.") else STATS_TOL


def assert_stats_match(module: torch.nn.Module, want_sd: dict) -> None:
    """Every running statistic of ``module`` against ``want_sd`` (the port's
    names), each within ``stats_tol`` of its largest entry."""
    own = dict(module.named_buffers())
    names = [k for k in want_sd if "running" in k]
    assert names and set(names) == set(own), sorted(set(names) ^ set(own))[:6]
    for k in names:
        assert_close_to_largest(own[k].numpy(), np.asarray(want_sd[k]), stats_tol(k), k)


# the PTV families (vtm_torch/models/ptv.py), tiny: width 4, the depth-18
# table of bottlenecks, 8 frames at a 32-pixel crop
NAMES = {"csn": "PTVCSN", "r2plus1d": "PTVR2plus1D"}


def ptv_opts(name: str, *extra) -> list:
    return ["MODEL.MODEL_NAME", NAMES.get(name, name), "MODEL.NUM_CLASSES", "7", "MODEL.DROPOUT_RATE", "0.0",
            "RESNET.DEPTH", "18", "RESNET.WIDTH_PER_GROUP", "4", "RESNET.ZERO_INIT_FINAL_BN", "False",
            "DATA.NUM_FRAMES", "8", "DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "32",
            "TPU.COMPUTE_DTYPE", "float32", *extra]


class PTVCase:
    """One tiny PTV model in both packages: the port's seeded init with every
    BatchNorm weight and statistic moved (``moved_state``), given to ``vtm``
    through its own ``convert_pyslowfast``; ``vtm``'s tree checked against
    ``jax.eval_shape`` of its init."""

    def __init__(self, name: str, *extra, seed: int = 0, move_weights: bool = True):
        self.cfg, self.jcfg = cfgs(ptv_opts(name, *extra))
        self.splits = self.cfg.BN.NUM_SPLITS if self.cfg.BN.NORM_TYPE == "sub_batchnorm" else 1
        self.bundle = build_model(self.cfg, "cpu")
        self.state = moved_state(self.bundle.module, seed, move_weights)
        self.bundle.module.load_state_dict({k: torch.from_numpy(v) for k, v in self.state.items()})
        self.jbundle = jax_build_model(self.jcfg, init=False)
        self.params, self.stats = convert_pyslowfast(self.state, num_splits=self.splits)
        shapes = jax.eval_shape(self.jbundle.module.init, jax.random.key(0), jnp.zeros((1, 8, 32, 32, 3)))
        assert tree_paths(shapes["params"]) == tree_paths(self.params)
        assert tree_paths(shapes["batch_stats"]) == tree_paths(self.stats)

    @staticmethod
    def video(batch: int, seed: int, crop: int = 32) -> np.ndarray:
        return np.random.default_rng(seed).standard_normal((batch, 8, crop, crop, 3)).astype(np.float32)

    def jax_apply(self, x, train: bool):
        variables = {"params": self.params, "batch_stats": self.stats}
        if not train:
            return np.asarray(self.jbundle.module.apply(variables, jnp.asarray(x))[0])
        (logits, _), mutated = self.jbundle.module.apply(variables, jnp.asarray(x), train=True,
                                                         mutable=["batch_stats"])
        return np.asarray(logits), np_tree(mutated["batch_stats"])
