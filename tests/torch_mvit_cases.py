"""What the port's MViT tests share (imported by ``tests/test_torch_mvit.py``,
``test_torch_mvit_rev.py`` and ``test_torch_mvit_train.py``; collects no
test itself).

Tiny MViT configs at the sizes of ``tests/test_mvit.py`` and
``tests/test_mvit_rev.py`` (embed 16, 2 heads, depth 4 or 5, 4 or 8 frames at
a 32-pixel crop), the same options in both packages' configs. A ``Case``
builds the port's model from its seed and gives ``vtm`` the same weights
through ``vtm``'s own ``convert_mvit``; ``vtm``'s param tree is checked
against ``jax.eval_shape`` of its ``init`` (no eager init) and its forwards
are jitted.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vtm.checkpoints.convert import convert_mvit
from vtm.models.build import build_model as jax_build_model

from vtm_torch.models import build_model

from torch_conv_cases import cfgs, tree_paths

BASE = [
    "MODEL.MODEL_NAME", "MViT", "MODEL.ARCH", "mvit", "MODEL.NUM_CLASSES", "7", "MODEL.DROPOUT_RATE", "0.0",
    "DATA.NUM_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "32",
    "MVIT.EMBED_DIM", "16", "MVIT.NUM_HEADS", "2", "MVIT.DEPTH", "4",
    "MVIT.PATCH_KERNEL", "[3, 7, 7]", "MVIT.PATCH_STRIDE", "[2, 4, 4]", "MVIT.PATCH_PADDING", "[1, 3, 3]",
    "MVIT.DROPPATH_RATE", "0.0", "MVIT.DIM_MUL", "[[1, 2.0], [3, 2.0]]", "MVIT.HEAD_MUL", "[[1, 2.0], [3, 2.0]]",
    "MVIT.POOL_Q_STRIDE", "[[1, 1, 2, 2], [3, 1, 2, 2]]", "MVIT.POOL_KVQ_KERNEL", "[3, 3, 3]",
    "MVIT.POOL_KV_STRIDE_ADAPTIVE", "[1, 4, 4]", "TPU.COMPUTE_DTYPE", "float32",
]
V2 = ("MVIT.USE_ABS_POS", "False", "MVIT.REL_POS_SPATIAL", "True", "MVIT.REL_POS_TEMPORAL", "True",
      "MVIT.RESIDUAL_POOLING", "True", "MVIT.DIM_MUL_IN_ATT", "True", "MVIT.USE_MEAN_POOLING", "True",
      "MVIT.REL_POS_ZERO_INIT", "False")
# the four styles of tests/test_mvit.py:71-107
STYLES = {
    "v1": (),
    "v2": V2,
    "sep_qkv_avg": ("DATA.NUM_FRAMES", "8", "MVIT.SEP_POS_EMBED", "True", "MVIT.SEPARATE_QKV", "True",
                    "MVIT.MODE", "avg"),
    "pool_first_sincos": ("MVIT.POOL_FIRST", "True", "MVIT.CLS_EMBED_ON", "False", "MVIT.USE_FIXED_SINCOS_POS",
                          "True", "MVIT.USE_ABS_POS", "True", "MVIT.USE_MEAN_POOLING", "True"),
}
# tests/test_mvit_rev.py:14-44 and its four configs (:89-131)
REV = ("MVIT.DEPTH", "5", "MVIT.CLS_EMBED_ON", "False", "MVIT.REV.ENABLE", "True", "MVIT.REV.BUFFER_LAYERS",
       "[1, 3]")
REV_STYLES = {
    "conv_respath": REV,
    "concat_preq": REV + ("MVIT.REV.PRE_Q_FUSION", "concat", "MVIT.USE_MEAN_POOLING", "True"),
    "max_respath": REV + ("MVIT.REV.RES_PATH", "max"),
    "v2": REV + ("MVIT.USE_ABS_POS", "False", "MVIT.REL_POS_SPATIAL", "True", "MVIT.REL_POS_TEMPORAL", "True",
                 "MVIT.RESIDUAL_POOLING", "True", "MVIT.REL_POS_ZERO_INIT", "False"),
}
# fp32, of the largest entry: logits and probabilities
LOGIT_TOL = 1e-5
# gradients that are zero analytically: a LayerNorm bias after the k pool
# shifts every key's logit of a query alike, which the softmax does not see.
# Both packages give fp32 noise there (1e-12 against gradients of 1e-2).
ZERO_GRADIENTS = ("attn.norm_k.bias",)


def mvit_opts(*extra) -> list:
    return BASE + list(extra)


class Case:
    """One tiny MViT in both packages from the port's seeded weights."""

    def __init__(self, *extra, fp32_params: bool = False):
        self.cfg, self.jcfg = cfgs(mvit_opts(*extra))
        self.bundle = build_model(self.cfg, "cpu", fp32_params=fp32_params)
        self.module = self.bundle.module
        self.state = {k: v.detach().float().numpy() for k, v in self.module.state_dict().items()}
        self.params = convert_mvit(self.state, depth=self.cfg.MVIT.DEPTH)
        self.jbundle = jax_build_model(self.jcfg, init=False)
        t, s = self.cfg.DATA.NUM_FRAMES, self.cfg.DATA.TEST_CROP_SIZE
        shapes = jax.eval_shape(self.jbundle.module.init, jax.random.key(0), jnp.zeros((1, t, s, s, 3)))["params"]
        assert tree_paths(shapes) == tree_paths(self.params), (
            sorted(tree_paths(shapes) - tree_paths(self.params))[:6],
            sorted(tree_paths(self.params) - tree_paths(shapes))[:6])
        self.shapes = shapes
        module = self.jbundle.module
        self._apply = {train: jax.jit(lambda p, x, train=train: module.apply({"params": p}, x, train=train)[0])
                       for train in (False, True)}

    def video(self, batch: int, seed: int, hw=None) -> np.ndarray:
        t, s = self.cfg.DATA.NUM_FRAMES, self.cfg.DATA.TEST_CROP_SIZE
        h, w = hw or (s, s)
        return np.random.default_rng(seed).standard_normal((batch, t, h, w, 3)).astype(np.float32)

    def jax_apply(self, x, train: bool, params=None) -> np.ndarray:
        """``vtm``'s forward: logits (train, every rate 0) or the head's activation."""
        return np.asarray(self._apply[train](self.params if params is None else params, jnp.asarray(x)))

    def port_apply(self, x, train: bool) -> np.ndarray:
        module = self.module.train(train)
        try:
            with torch.no_grad():
                return module(torch.from_numpy(x))[0].float().numpy()
        finally:
            module.eval()


def template_of(shapes):
    """A param tree of zeros in ``jax.eval_shape``'s shapes (a template for
    ``vtm``'s loaders without its eager init)."""
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)


def grad_errors(got: dict, want: dict, zero=ZERO_GRADIENTS) -> dict:
    """Each gradient's largest error relative to its tensor's largest
    entry; for the names in ``zero`` (noise in both packages) the larger of
    the two tensors' largest entries relative to the model's largest
    gradient instead, which a test holds below its tolerance too."""
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:6]
    largest = max(float(np.abs(w).max()) for w in want.values())
    errs = {}
    for k, w in want.items():
        g, w = np.asarray(got[k], np.float64), np.asarray(w, np.float64)
        if any(z in k for z in zero):
            errs[k] = max(float(np.abs(g).max()), float(np.abs(w).max())) / largest
        else:
            errs[k] = float(np.abs(g - w).max()) / max(float(np.abs(w).max()), 1e-30)
    return errs
