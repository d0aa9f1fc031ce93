"""The port's masked-pretraining models (``vtm_torch/models/masked.py``)
against ``vtm``'s on the CPU, tiny (``torch_masked_cases``), the port built
from ``vtm``'s params through ``maskmvit_state_dict_from_vtm_params``:
``hog_features`` (and how many orientation bins differ from ``vtm``'s numpy
ones), ``_interp_mask``, the MaskFeat forward with HOG and pixel targets
(with and without a decoder), the MAE forward on the loader-mask path and
with injected noise, ``multiple_mse``, the state-dict layouts, ``vtm``'s
refusals and ``mae_visualize``. About 30 s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtm.checkpoints.convert import convert_maskmvit
from vtm.models import masked as jmasked
from vtm.models.build import build_model as jax_build_model
from vtm.train import losses as jlosses
from vtm.vis import mae_vis as jmae_vis

from vtm_torch.checkpoints.checkpoint import CHECKPOINT_LOADERS
from vtm_torch.checkpoints.convert import load_maskmvit_state_dict, maskmvit_state_dict_from_vtm_params
from vtm_torch.models import build_model, masked
from vtm_torch.train import losses
from vtm_torch.vis import mae_vis

from torch_conv_cases import cfgs
from torch_masked_cases import DECODER, LOGIT_TOL, MAE, MASKFEAT, Case, rel_err
from torch_mvit_cases import V2, mvit_opts

torch.set_num_threads(2)

# hog_features: fp32 cell sums, then normalised (values at most 1)
HOG_ATOL = 1e-5
LABEL_TOL = 1e-5  # pixel targets, of the largest

MASKFEAT_CASES = {
    "hog": MASKFEAT,
    "hog_two_depths_v2": MASKFEAT + V2 + ("MASK.PRETRAIN_DEPTH", "[1, 3]"),
    "pixel": MASKFEAT + ("MASK.PRED_HOG", "False", "MASK.PRETRAIN_DEPTH", "[1, 3]",
                         "MASK.TIME_STRIDE_LOSS", "False"),
    "pixel_decoder_kv": MASKFEAT + DECODER + ("MASK.PRED_HOG", "False", "MASK.DEC_KV_KERNEL", "[3, 3, 3]",
                                              "MASK.DEC_KV_STRIDE", "[1, 2, 2]", "MASK.NORM_PRED_PIXEL", "False"),
    "hog_decoder_sep_pos_norm_stem_nocls": MASKFEAT + DECODER + ("MVIT.CLS_EMBED_ON", "False", "MVIT.SEP_POS_EMBED",
                                                                 "True", "MVIT.NORM_STEM", "True"),
}
MAE_CASES = {
    "joint_cls": MAE,
    "sep_nocls_decsep": MAE + ("MVIT.SEP_POS_EMBED", "True", "MVIT.CLS_EMBED_ON", "False",
                               "MASK.DECODER_SEP_POS_EMBED", "True"),
    "sep_cls_decsep": MAE + ("MVIT.SEP_POS_EMBED", "True", "MASK.DECODER_SEP_POS_EMBED", "True"),
    "sincos_nocls_per_frame": MAE + ("MVIT.USE_FIXED_SINCOS_POS", "True", "MVIT.CLS_EMBED_ON", "False",
                                     "MASK.PER_FRAME_MASKING", "True", "AUG.MASK_RATIO", "0.5"),
    "sincos_cls_tube": MAE + ("MVIT.USE_FIXED_SINCOS_POS", "True", "AUG.MASK_TUBE", "True"),
    "decoder_kv_pixels_raw": MAE + DECODER + ("MASK.DEC_KV_KERNEL", "[3, 3, 3]", "MASK.DEC_KV_STRIDE", "[1, 2, 2]",
                                              "MASK.TIME_STRIDE_LOSS", "False", "MASK.NORM_PRED_PIXEL", "False"),
}
_CASES = {}


def case(name: str) -> Case:
    """One Case a name, built once for the file (each compiles ``vtm``'s forward)."""
    if name not in _CASES:
        _CASES[name] = Case(*{**MASKFEAT_CASES, **MAE_CASES}[name])
    return _CASES[name]


def vtm_bins(images: np.ndarray, nbins: int):
    """The magnitude and bin of ``vtm``'s ``hog_features`` (its lines up to
    the binning), [B, H, W, C] numpy."""
    b, h, w, c = images.shape
    x = np.pad(images, [(0, 0), (1, 1), (1, 1), (0, 0)], mode="reflect").astype(np.float32)
    kx = np.array([[1, 0, -1], [2, 0, -2], [1, 0, -1]], np.float32)
    ky = kx.T
    gx = np.zeros((b, h, w, c), np.float32)
    gy = np.zeros((b, h, w, c), np.float32)
    for i in range(3):
        for j in range(3):
            patch = x[:, i:i + h, j:j + w, :]
            gx += kx[i, j] * patch
            gy += ky[i, j] * patch
    return np.sqrt(gx ** 2 + gy ** 2), np.floor(np.arctan2(gx, gy) / np.pi * nbins).astype(np.int64) % nbins


def _images(shape, kind: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        x = rng.random(shape)
    elif kind == "normal":
        x = rng.standard_normal(shape)
    else:  # bytes, normalised as the loaders do
        x = (rng.integers(0, 256, shape) / 255.0 - 0.45) / 0.225
    return x.astype(np.float32)


@pytest.mark.parametrize("shape, pool, nbins, kind", [
    ((3, 32, 32, 3), 8, 9, "uniform"),
    ((2, 24, 40, 3), 4, 9, "normal"),
    ((2, 20, 20, 3), 8, 9, "uniform"),
    ((4, 16, 16, 3), 8, 9, "normal"),
    ((1, 64, 48, 3), 16, 9, "uniform"),
    ((2, 24, 24, 3), 8, 7, "normal"),
])
def test_hog_features_match_vtm(shape, pool, nbins, kind):
    """The magnitudes bit for bit, not one orientation bin of another, and
    the features within HOG_ATOL."""
    images = _images(shape, kind, sum(shape) + pool + nbins)
    want_norm, want_bins = vtm_bins(images, nbins)
    norm, bins = masked.hog_bins(torch.from_numpy(images), nbins)
    differ = int((bins.permute(0, 2, 3, 1).numpy() != want_bins).sum())
    assert differ == 0, f"{differ} of {want_bins.size} bins differ"
    np.testing.assert_array_equal(norm.permute(0, 2, 3, 1).numpy(), want_norm)
    got = masked.hog_features(torch.from_numpy(images), nbins=nbins, pool=pool).numpy()
    want = jmasked.hog_features(images, nbins=nbins, pool=pool)
    assert got.shape == want.shape == (shape[0], 3, nbins, shape[1] // pool, shape[2] // pool)
    np.testing.assert_allclose(got, want, atol=HOG_ATOL, rtol=0)


@pytest.mark.parametrize("nbins, kind", [(9, "bytes"), (12, "normal"), (6, "bytes")])
def test_hog_bins_differ_only_on_edges(nbins, kind):
    """Where ``vtm``'s fp32 numpy atan2 is an ulp off a bin's edge (an even
    bin count puts one at 90 degrees, where a near-zero gy is common;
    byte-valued frames put some at 180), the bins differ: every such pixel's
    phase is within 4e-6 of an integer, and the count is printed."""
    images = _images((4, 64, 64, 3), kind, nbins)
    _, want_bins = vtm_bins(images, nbins)
    _, bins = masked.hog_bins(torch.from_numpy(images), nbins)
    x = np.pad(images, [(0, 0), (1, 1), (1, 1), (0, 0)], mode="reflect")
    kx = np.array([[1, 0, -1], [2, 0, -2], [1, 0, -1]], np.float32)
    gx = sum(kx[i, j] * x[:, i:i + 64, j:j + 64] for i in range(3) for j in range(3))
    gy = sum(kx[j, i] * x[:, i:i + 64, j:j + 64] for i in range(3) for j in range(3))
    phase = np.arctan2(gx, gy) / np.pi * nbins
    flipped = bins.permute(0, 2, 3, 1).numpy() != want_bins
    print(f"{int(flipped.sum())} of {flipped.size} bins differ from vtm's at {nbins} bins ({kind})")
    assert (np.abs(phase - np.round(phase))[flipped] <= 4e-6).all()


@pytest.mark.parametrize("src, size", [((7, 7), (56, 56)), ((3, 5), (8, 8)), ((8, 8), (3, 3)), ((6, 4), (6, 4)),
                                       ((4, 4), (7, 9))])
def test_interp_mask_matches_vtm(src, size):
    """The integer rows ``arange(th) * h // th`` on grids that do not divide:
    the same picks as ``vtm``'s, bit for bit."""
    mask = np.random.default_rng(2).integers(0, 2, (2, 3) + src).astype(np.float32)
    got = masked._interp_mask(torch.from_numpy(mask), size).numpy()
    np.testing.assert_array_equal(got, np.asarray(jmasked._interp_mask(jnp.asarray(mask), size)))
    assert got.shape == (2, 3) + size


@pytest.mark.parametrize("name", sorted(MASKFEAT_CASES))
def test_maskfeat_forward_matches_vtm(name):
    """Predictions at every position within LOGIT_TOL of the largest, the
    boolean masks equal, for a loader mask on the token grid's time and a
    coarser window (3-D), and a 2-D 3 x 3 one (a grid it does not divide,
    broadcast over time; two of the cases); the HOG or pixel targets of the
    same clips."""
    c = case(name)
    x = c.video(2, seed=4)
    t, h, w = c.token_grid()
    rng = np.random.default_rng(5)
    two_d = name in ("hog", "pixel")  # each mask shape compiles vtm's forward anew
    for mask in (rng.integers(0, 2, (2, t, 4, 4)),) + ((rng.integers(0, 2, (2, 3, 3)),) if two_d else ()):
        mask = mask.astype(np.float32)
        want_preds, want_masks = c.jax_apply(x, mask)
        preds, masks = c.port_apply(x, mask)
        assert len(preds) == len(want_preds) == len(c.cfg.MASK.PRETRAIN_DEPTH)
        for p, wp, m, wm in zip(preds, want_preds, masks, want_masks):
            assert p.shape == wp.shape
            assert rel_err(p, wp) <= LOGIT_TOL, (name, rel_err(p, wp))
            np.testing.assert_array_equal(m, wm)
    spec, jspec = c.module.spec, c.jbundle.module.spec
    got = masked.maskfeat_labels(c.cfg, spec, torch.from_numpy(x))
    if c.cfg.MASK.PRED_HOG:
        want = jmasked.maskfeat_hog_labels(jspec, c.cfg.MASK.PRETRAIN_DEPTH, x)
    else:
        want = jmasked.maskfeat_pixel_labels(jspec, c.cfg.MASK.PRETRAIN_DEPTH, x, c.cfg.MASK.TIME_STRIDE_LOSS,
                                             c.cfg.MASK.NORM_PRED_PIXEL)
    for g, wl, p in zip(got, want, preds):
        assert g.shape == wl.shape == p.shape
        np.testing.assert_allclose(g.numpy(), wl, atol=HOG_ATOL if c.cfg.MASK.PRED_HOG else
                                   LABEL_TOL * float(np.abs(wl).max()), rtol=0)


def _check_mae(c, got, want, name):
    (preds, labels, masks), (want_preds, want_labels, want_masks) = got, want
    for p, wp in zip(preds, want_preds):
        assert p.shape == wp.shape and rel_err(p, wp) <= LOGIT_TOL, (name, rel_err(p, wp))
    for lab, wl in zip(labels, want_labels):
        assert lab.shape == wl.shape and rel_err(lab, wl) <= LABEL_TOL, (name, rel_err(lab, wl))
    for m, wm in zip(masks, want_masks):
        np.testing.assert_array_equal(m, wm)


@pytest.mark.parametrize("name", sorted(MAE_CASES))
def test_mae_forward_matches_vtm(name):
    """The loader-mask path (a 2 x 4 x 4 window on the 2 x 8 x 8 grid, so
    nearly every key ties and the stable sort decides; its count is not the
    ratio's, and the split follows the ratio) and the random path with the
    noise injected: the port's ``noise`` is the float array ``vtm`` takes as
    a token-grid mask (tiled over time under the tube). Predictions, labels
    and masks."""
    c = case(name)
    x = c.video(2, seed=8)
    t, h, w = c.token_grid()
    rng = np.random.default_rng(9)
    mask = rng.integers(0, 2, (2, t, 4, 4)).astype(np.float32)
    _check_mae(c, c.port_apply(x, mask), c.jax_apply(x, mask), name)
    module = c.module
    tube = module.mask_tube and not module.per_frame_masking
    noise = rng.random((2, 1, h * w) if tube else ((2 * t, h * w) if module.per_frame_masking else (2, t * h * w)),
                       dtype=np.float32)
    as_mask = (np.tile(noise, (1, t, 1)) if tube else noise).reshape(2, t, h, w)
    module.rnd_mask = True
    try:
        got = c.port_apply(x, noise=noise)
    finally:
        module.rnd_mask = False
    _check_mae(c, got, c.jax_apply(x, as_mask), name)
    L = h * w if module.per_frame_masking else t * h * w
    len_keep = int(L * (1 - c.cfg.AUG.MASK_RATIO))
    assert ((~got[2][0]).sum(axis=1) == len_keep * (t if module.per_frame_masking else 1)).all()


def test_mae_draws_from_the_generator():
    """Without ``noise``, the random path draws from the forward's
    generator: the same seed the same masks and predictions, another seed
    other masks; every row keeps ``len_keep`` tokens."""
    c = case("joint_cls")
    x = torch.from_numpy(c.video(2, seed=1))
    module = c.module.train()
    module.rnd_mask = True
    try:
        with torch.no_grad():
            runs = [module(x, None, generator=torch.Generator().manual_seed(s)) for s in (3, 3, 4)]
    finally:
        module.rnd_mask = False
    (p0, _, m0), (p1, _, m1), (_, _, m2) = runs
    assert torch.equal(p0[0], p1[0]) and torch.equal(m0[0], m1[0]) and not torch.equal(m0[0], m2[0])
    assert (m0[0].sum(dim=1) == 128 - int(128 * 0.25)).all()


def test_multiple_mse_matches_vtm():
    """Two depths with weights, masked and unmasked, and an all-False mask
    (the denominator's floor of 1)."""
    rng = np.random.default_rng(3)
    preds = [rng.standard_normal((2, 6, 5)).astype(np.float32), rng.standard_normal((2, 3, 4)).astype(np.float32)]
    labels = [rng.standard_normal(p.shape).astype(np.float32) for p in preds]
    for masks in ([rng.random((2, 6)) < 0.4, rng.random((2, 3)) < 0.6], [np.zeros((2, 6), bool),
                                                                         np.ones((2, 3), bool)], None):
        tp = [torch.from_numpy(p) for p in preds]
        lw = [(torch.from_numpy(labels[0]), 0.5), torch.from_numpy(labels[1])]
        jlw = [(jnp.asarray(labels[0]), 0.5), jnp.asarray(labels[1])]
        got, got_multi = losses.multiple_mse(tp, lw, None if masks is None else [torch.from_numpy(m) for m in masks])
        want, want_multi = jlosses.multiple_mse([jnp.asarray(p) for p in preds], jlw,
                                                None if masks is None else [jnp.asarray(m) for m in masks])
        assert abs(float(got) - float(want)) <= 1e-6 * max(1.0, abs(float(want)))
        for g, w in zip(got_multi, want_multi):
            assert abs(float(g) - float(w)) <= 1e-6 * max(1.0, abs(float(w)))
    assert losses.get_loss_func("multi_mse") is losses.multiple_mse


@pytest.mark.parametrize("name", ["hog_two_depths_v2", "pixel_decoder_kv", "sep_cls_decsep", "sincos_cls_tube"])
def test_state_dict_layouts_round_trip(name):
    """The port's state dict (upstream PySlowFast's layout) through ``vtm``'s
    ``convert_maskmvit`` and back through ``maskmvit_state_dict_from_vtm_params``
    bit for bit; ``load_maskmvit_state_dict`` strips a DDP prefix, and is
    ``CHECKPOINT_LOADERS["MaskMViT"]``."""
    c = case(name)
    sd = c.module.state_dict()
    params = convert_maskmvit({k: v.numpy() for k, v in sd.items()}, depth=c.depth)
    back = maskmvit_state_dict_from_vtm_params(params)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    loaded = load_maskmvit_state_dict({f"module.{k}": v.numpy() for k, v in sd.items()})
    assert sorted(loaded) == sorted(sd) and all(torch.equal(loaded[k], sd[k]) for k in sd)
    loaded = CHECKPOINT_LOADERS["MaskMViT"]({k: v for k, v in sd.items()}, c.module.config)
    assert all(torch.equal(loaded[k], sd[k]) for k in sd)
    heads = [k for k in sd if k.startswith("pred_head.transforms.")]
    depth = c.cfg.MASK.DECODER_DEPTH
    assert f"pred_head.transforms.0.{depth}.weight" in heads and "pred_head.projections.0.weight" in sd


@pytest.mark.parametrize("opts, error", [
    (MAE + ("MVIT.POOL_Q_STRIDE", "[[1, 1, 2, 2]]"), AssertionError),
    (MAE + ("MVIT.REL_POS_SPATIAL", "True"), AssertionError),
    (MAE + ("MASK.PRED_HOG", "True"), AssertionError),
    (MASKFEAT + ("MASK.MAE_RND_MASK", "True"), NotImplementedError),
], ids=["mae_pooling", "mae_rel_pos", "mae_hog", "maskfeat_rnd_mask"])
def test_refusals_match_vtm(opts, error):
    """``vtm``'s refusals: the MAE encoder pools nothing and has no relative
    positions; MAE has no HOG targets; MaskFeat has no random mask."""
    cfg, jcfg = cfgs(mvit_opts(*opts))
    with pytest.raises(error):
        build_model(cfg, "cpu")
    with pytest.raises(error):
        bundle = jax_build_model(jcfg, init=False)
        t, s = jcfg.DATA.NUM_FRAMES, jcfg.DATA.TRAIN_CROP_SIZE
        jax.eval_shape(bundle.module.init, {"params": jax.random.key(0), "mask": jax.random.key(1)},
                       jnp.zeros((1, t, s, s, 3)), jnp.zeros((1, 2, 8, 8)))


@pytest.mark.parametrize("time_stride_loss", [True, False])
def test_mae_visualize_matches_vtm(time_stride_loss):
    """The (original, masked, reconstruction) triple equal to ``vtm``'s bit
    for bit, on the MAE's own predictions and mask; the reconstruction keeps
    every visible patch of the input and the masked clip zeros every dropped one."""
    c = case("joint_cls")
    x = c.video(2, seed=12)
    mask = np.random.default_rng(13).integers(0, 2, (2, 2, 4, 4)).astype(np.float32)
    preds, _, masks = c.port_apply(x, mask)
    u = c.cfg.MVIT.PATCH_STRIDE[0]
    p = c.cfg.MVIT.PATCH_STRIDE[1]
    pred = preds[0] if time_stride_loss else np.repeat(preds[0], u, axis=-1)
    got = mae_vis.mae_visualize(x, pred, masks[0], u, p, time_stride_loss)
    want = jmae_vis.mae_visualize(x, pred, masks[0], u, p, time_stride_loss)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    orig, masked_clip, recon = got
    visible = ~masks[0]
    tokens = masked._patchify_pixels(orig, p, 1 if time_stride_loss else u)
    np.testing.assert_array_equal(masked._patchify_pixels(recon, p, 1 if time_stride_loss else u)[visible],
                                  tokens[visible])
    assert not masked._patchify_pixels(masked_clip, p, 1 if time_stride_loss else u)[~visible].any()
