"""What the port's masked-pretraining tests share (imported by
``tests/test_torch_masked.py`` and ``test_torch_masked_train.py``; collects
no test itself).

Tiny MaskFeat and MAE configs on the MViT of ``torch_mvit_cases`` (embed 16,
2 heads, 4 frames at a 32-pixel crop). A ``Case`` draws the port's seeded
weights, gives them to ``vtm`` through ``vtm``'s own ``convert_maskmvit``
(its tree checked against ``jax.eval_shape`` of ``init``), and loads ``vtm``'s
params back into the port through ``maskmvit_state_dict_from_vtm_params``
with every name required. ``vtm``'s forwards are jitted.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vtm.checkpoints.convert import convert_maskmvit
from vtm.models.build import build_model as jax_build_model

from vtm_torch.checkpoints.convert import maskmvit_state_dict_from_vtm_params
from vtm_torch.models import build_model

from torch_conv_cases import cfgs, tree_paths
from torch_mvit_cases import mvit_opts

MASK = ("MODEL.MODEL_NAME", "MaskMViT", "MASK.ENABLE", "True", "MODEL.LOSS_FUNC", "multi_mse")
# MaskFeat: q pooled at blocks 1 and 3, so depth 1 is an 4 x 4 grid of
# stride 8 (HOG 27 wide) and depth 3 a 2 x 2 grid of stride 16 (108 wide,
# four HOG cells a position)
MASKFEAT = MASK + ("MASK.PRED_HOG", "True", "MASK.PRETRAIN_DEPTH", "[3]")
# MAE: no pooling; an 2 x 8 x 8 grid of 128 tokens, blocks 0 and 1 (16 and 32 wide)
MAE = MASK + ("MASK.MAE_ON", "True", "MASK.PRED_HOG", "False", "MASK.PRETRAIN_DEPTH", "[1]",
              "MVIT.POOL_Q_STRIDE", "[]", "MVIT.POOL_KV_STRIDE_ADAPTIVE", "None", "MASK.DECODER_EMBED_DIM", "16",
              "AUG.MASK_RATIO", "0.75")
# the decoder of one block (DECODER_EMBED_DIM // 64 heads)
DECODER = ("MASK.DECODER_DEPTH", "1", "MASK.DECODER_EMBED_DIM", "64")
# fp32, of the largest entry (torch_mvit_cases.LOGIT_TOL)
LOGIT_TOL = 1e-5


def rel_err(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / max(np.abs(want).max(), 1e-30))


class Case:
    """One tiny MaskMViT in both packages, on the same weights."""

    def __init__(self, *extra, fp32_params: bool = True):
        self.cfg, self.jcfg = cfgs(mvit_opts(*extra))
        self.bundle = build_model(self.cfg, "cpu", fp32_params=fp32_params)
        self.module = self.bundle.module
        self.mae = bool(self.cfg.MASK.MAE_ON)
        self.depth = max(self.cfg.MASK.PRETRAIN_DEPTH) + 1
        state = {k: v.detach().float().numpy() for k, v in self.module.state_dict().items()}
        self.params = convert_maskmvit(state, depth=self.depth)
        self.jbundle = jax_build_model(self.jcfg, init=False)
        module = self.jbundle.module
        t, s = self.cfg.DATA.NUM_FRAMES, self.cfg.DATA.TRAIN_CROP_SIZE
        rngs = {"params": jax.random.key(0), "mask": jax.random.key(1)}
        shapes = jax.eval_shape(module.init, rngs, jnp.zeros((1, t, s, s, 3)),
                                jnp.zeros((1,) + self.token_grid()))["params"]
        assert tree_paths(shapes) == tree_paths(self.params), (
            sorted(tree_paths(shapes) - tree_paths(self.params))[:6],
            sorted(tree_paths(self.params) - tree_paths(shapes))[:6])
        self.shapes = shapes
        self.module.load_state_dict(maskmvit_state_dict_from_vtm_params(self.params), strict=True)
        self._apply = jax.jit(lambda p, x, m: module.apply({"params": p}, x, m, train=True))

    def token_grid(self):
        t, s = self.cfg.DATA.NUM_FRAMES, self.cfg.DATA.TRAIN_CROP_SIZE
        st = self.cfg.MVIT.PATCH_STRIDE
        return (t // st[0], s // st[1], s // st[2])

    def video(self, batch: int, seed: int) -> np.ndarray:
        t, s = self.cfg.DATA.NUM_FRAMES, self.cfg.DATA.TRAIN_CROP_SIZE
        return np.random.default_rng(seed).standard_normal((batch, t, s, s, 3)).astype(np.float32)

    def jax_apply(self, x, mask, params=None):
        """``vtm``'s forward: (preds, masks) or (preds, labels, masks), as numpy."""
        out = self._apply(self.params if params is None else params, jnp.asarray(x), jnp.asarray(mask))
        return jax.tree_util.tree_map(np.asarray, out)

    def port_apply(self, x, mask=None, noise=None):
        kw = {} if noise is None else {"noise": torch.from_numpy(noise)}
        module = self.module.train()
        with torch.no_grad():
            out = module(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask), **kw)
        return jax.tree_util.tree_map(lambda v: v.float().numpy() if v.is_floating_point() else v.numpy(), out)
