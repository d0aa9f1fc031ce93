"""The port's approximate attentions for Motionformer (Nyström, Orthoformer,
Performer) against the JAX package's, on the CPU in fp32: each function of
``motionformer_approx`` at tiny sizes, then a tiny Motionformer with each
type, merged and unmerged, forward and gradients.

Inputs come from numpy seeds; weights from a random upstream-layout state
dict through ``convert_motionformer`` and back through
``motionformer_state_dict_from_vtm_params``. Torch cannot draw JAX's
threefry numbers, so Performer is given the JAX package's
``create_projection_matrix(m, d, key)`` and Orthoformer a chosen first
landmark where the JAX package would draw one.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vtm.checkpoints.convert import convert_motionformer
from vtm.merge.policy import MergePolicy as JPolicy
from vtm.models import motionformer_approx as japprox
from vtm.models.motionformer import Motionformer as JMotionformer
from vtm.models.motionformer import MotionformerConfig as JConfig
from vtm_torch.checkpoints.convert import motionformer_state_dict_from_vtm_params
from vtm_torch.merge.policy import MergePolicy
from vtm_torch.models import motionformer_approx as approx
from vtm_torch.models.motionformer import Motionformer, MotionformerConfig

from test_torch_motionformer import _upstream_sd
from torch_variants import assert_same_matchings, record_matchings

torch.set_num_threads(2)

TOL = 1e-5  # fp32, the same products summed in another order
# 3 layers, 4 frames after the tubelet, 16 tokens each (8 raw frames of 64x64)
ARCH = dict(
    img_size=64, patch_size=16, patch_size_temp=2, num_classes=7, embed_dim=32, depth=3,
    num_heads=2, mlp_ratio=2.0, temporal_resolution=4, use_mlp=True,
)
R = 3  # per pseudo-frame: 64 body tokens, then 52, 40, 28
LANDMARKS = 8  # divides 64 and 40, not 52: both segment splits run
APPROX_TYPES = ("nystrom", "orthoformer", "performer")
LOGIT_TOL = 1e-4
GRAD_TOL = 1e-4  # of the largest entry of each gradient tensor
# Zero analytically, rounding noise in both packages: the k half of
# proj_kv's bias (the temporal softmax does not see a shift of its
# logits), the last block's trajectory projections (only its CLS row
# reaches the head) and, where the spatial step is a softmax over keys
# (Nyström, Orthoformer), the k third of qkv's bias. FAVOR+'s features
# are not shift invariant: Performer's k bias has a gradient. Noise is
# below GRAD_NOISE of the largest entry of any gradient.
GRAD_NOISE = 1e-6


def _qkv(b=2, f=4, p=10, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, f * p, d)).astype(np.float32) for _ in range(3)]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_iterative_inv_matches_vtm():
    rng = np.random.default_rng(0)
    mat = torch.softmax(torch.from_numpy(rng.standard_normal((3, 8, 8)).astype(np.float32)), dim=-1).numpy()
    with jax.default_matmul_precision("highest"):
        want = np.asarray(japprox.iterative_inv(jnp.asarray(mat)))
    got = approx.iterative_inv(torch.from_numpy(mat)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # the iteration moves toward the inverse: K V is closer to I than K K^T/...
    start = approx.iterative_inv(torch.from_numpy(mat), n_iter=0).numpy()
    eye = np.broadcast_to(np.eye(8), mat.shape)
    assert np.abs(mat @ got - eye).max() < np.abs(mat @ start - eye).max()


@pytest.mark.parametrize("n,landmarks", [(40, 8), (42, 8), (12, 5)], ids=["divides", "uneven", "uneven_small"])
def test_segment_means_match_vtm(n, landmarks):
    x = np.random.default_rng(1).standard_normal((2, n, 3)).astype(np.float32)
    want = np.asarray(japprox._segment_means(jnp.asarray(x), landmarks))
    got = approx._segment_means(torch.from_numpy(x), landmarks).numpy()
    assert got.shape == (2, landmarks, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("p,landmarks", [(10, 8), (12, 8), (12, 5)], ids=["divides", "uneven", "uneven_5"])
@pytest.mark.parametrize("spatial", [True, False], ids=["spatial_landmarks", "sequence_landmarks"])
def test_nystrom_matches_vtm(p, landmarks, spatial):
    q, k, v = _qkv(p=p)
    kw = dict(landmarks=landmarks, num_frames=4, inv_iters=6, use_spatial_landmarks=spatial)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(japprox.nystrom_spatial_attn(*_j(q, k, v), **kw))
    got = approx.nystrom_spatial_attn(*_t(q, k, v), **kw).numpy()
    assert got.shape == (2, 4 * p, 4, 16)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("init", [None, (3, 17)], ids=["row_0", "given_rows"])
def test_orthogonal_landmarks_match_vtm(init):
    """The same rows in index order, bit for bit (gathered from the same q)."""
    q, k, _ = _qkv(seed=1)
    init_j = None if init is None else jnp.asarray(init)
    init_t = None if init is None else torch.tensor(init)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(japprox.orthogonal_landmarks(*_j(q, k), 12, init_idx=init_j))
    idx = approx.orthogonal_landmark_indices(torch.from_numpy(q), 12, init_idx=init_t)
    got = approx.orthogonal_landmarks(*_t(q, k), 12, init_idx=init_t).numpy()
    np.testing.assert_array_equal(got, want)
    assert idx.shape == (2, 12) and bool((idx[:, 1:] > idx[:, :-1]).all())  # distinct, sorted
    np.testing.assert_array_equal(got, np.take_along_axis(q, idx.numpy()[:, :, None], axis=1))
    first = np.zeros(2, np.int64) if init is None else np.array(init)
    assert all(first[i] in idx[i].tolist() for i in range(2))


def test_more_landmarks_than_rows_repeat_row_0_as_vtm():
    """Once every row is picked, every score is 10 and the first index wins:
    the rest of the landmarks are row 0, in both packages."""
    q, k, v = _qkv(b=2, f=2, p=5, seed=9)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(japprox.orthogonal_landmarks(*_j(q, k), 14))
        want_out = np.asarray(japprox.orthoformer(*_j(q, k, v), num_landmarks=14, num_frames=2))
    idx = approx.orthogonal_landmark_indices(torch.from_numpy(q), 14)
    assert idx[:, :5].eq(0).all() and sorted(set(idx[0].tolist())) == list(range(10))
    np.testing.assert_array_equal(approx.orthogonal_landmarks(*_t(q, k), 14).numpy(), want)
    got_out = approx.orthoformer(*_t(q, k, v), num_landmarks=14, num_frames=2).numpy()
    np.testing.assert_allclose(got_out, want_out, rtol=TOL, atol=TOL)


def test_orthogonal_landmarks_first_draw_comes_from_the_generator():
    q = torch.from_numpy(_qkv(seed=2)[0])
    a = approx.orthogonal_landmark_indices(q, 6, generator=torch.Generator().manual_seed(5))
    b = approx.orthogonal_landmark_indices(q, 6, generator=torch.Generator().manual_seed(5))
    first = torch.randint(0, q.shape[1], (2,), generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    assert torch.equal(a, approx.orthogonal_landmark_indices(q, 6, init_idx=first))


@pytest.mark.parametrize("init", [None, (3, 17)], ids=["row_0", "given_rows"])
def test_orthoformer_matches_vtm(init):
    q, k, v = _qkv(seed=1)
    init_j = None if init is None else jnp.asarray(init)
    init_t = None if init is None else torch.tensor(init)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(japprox.orthoformer(*_j(q, k, v), num_landmarks=6, num_frames=4, init_idx=init_j))
    got = approx.orthoformer(*_t(q, k, v), num_landmarks=6, num_frames=4, init_idx=init_t).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_orthoformer_landmarks_carry_no_gradient():
    """As under the JAX package's stop_gradient: q's gradient equals the one
    with the landmarks given as constants, and matches ``jax.grad``."""
    q, k, v = _qkv(seed=4)
    kw = dict(num_landmarks=5, num_frames=4, init_idx=None)
    with jax.default_matmul_precision("highest"):
        want = jax.grad(lambda a, b, c: japprox.orthoformer(a, b, c, **kw).sum(), argnums=(0, 1, 2))(*_j(q, k, v))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    approx.orthoformer(tq, tk, tv, **kw).sum().backward()
    for got, w in zip((tq, tk, tv), want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("m,d", [(32, 16), (40, 16), (256, 64)], ids=["two_blocks", "remainder", "vitb"])
def test_projection_blocks_are_orthogonal(m, d):
    proj = approx.create_projection_matrix(m, d, torch.Generator().manual_seed(0)).numpy()
    assert proj.shape == (m, d) and proj.dtype == np.float32
    for start in range(0, m, d):
        blk = proj[start:start + d]
        dirs = blk / np.linalg.norm(blk, axis=1, keepdims=True)
        np.testing.assert_allclose(dirs @ dirs.T, np.eye(len(blk)), atol=1e-5)
    # row norms are chi(d) draws: near sqrt(d), not 1
    assert abs(np.linalg.norm(proj, axis=1).mean() / np.sqrt(d) - 1) < 0.3
    again = approx.create_projection_matrix(m, d, torch.Generator().manual_seed(0)).numpy()
    np.testing.assert_array_equal(proj, again)


@pytest.mark.parametrize("is_query", [True, False], ids=["query", "key"])
def test_softmax_kernel_transformation_matches_vtm(is_query):
    rng = np.random.default_rng(2)
    data = rng.standard_normal((2, 12, 3, 16)).astype(np.float32)
    proj = rng.standard_normal((32, 16)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(japprox.softmax_kernel_transformation(*_j(data), is_query, jnp.asarray(proj)))
    got = approx.softmax_kernel_transformation(*_t(data), is_query, torch.from_numpy(proj)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("m", [32, 256])
def test_performer_matches_vtm_given_its_projection(m):
    q, k, v = _qkv(b=2, f=2, p=8, d=16, seed=3)
    key = jax.random.key(7)
    proj = np.array(japprox.create_projection_matrix(m, 16, key))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(japprox.performer_attention(*_j(q, k, v), 2, m=m, rng=key))
    got = approx.performer_attention(*_t(q, k, v), 2, m=m, projection=torch.from_numpy(proj))
    assert got.dtype == torch.float32 and got.shape == (2, 16, 2, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("scale", [2.0**-36, 2.0**-20, 2.0**-3, 2.0**6])
def test_projection_seed_is_vtms_seed(scale):
    """ceil(|sum q| * 1e8) cast to uint32 as XLA casts it: saturated at
    2^32 - 1 above, 0 for NaN. The entries are multiples of 1/8 times a
    power of two, so the sum is exact in either summation order."""
    q = (np.random.default_rng(5).integers(-8, 9, (2, 8, 4)) / 8 * scale).astype(np.float32)
    want = int(jnp.ceil(jnp.abs(jnp.sum(jnp.asarray(q)) * japprox.BIG_CONSTANT)).astype(jnp.uint32))
    assert approx.projection_seed(torch.from_numpy(q)) == want
    assert approx.projection_seed(torch.full((2, 2), float("nan"))) == 0
    assert approx.projection_seed(torch.full((2, 2), 1e3)) == approx.UINT32_MAX


def test_performer_without_projection_draws_from_qs_seed_on_the_cpu():
    q, k, v = _t(*_qkv(b=2, f=2, p=8, d=16, seed=6))
    a = approx.performer_attention(q, k, v, 2, m=32)
    proj = approx.create_projection_matrix(32, 16, torch.Generator().manual_seed(approx.projection_seed(q)))
    assert torch.equal(a, approx.performer_attention(q, k, v, 2, m=32, projection=proj))
    assert torch.equal(a, approx.performer_attention(q, k, v, 2, m=32))


def test_bf16_inputs_keep_their_dtype():
    q, k, v = (t.to(torch.bfloat16) for t in _t(*_qkv(b=2, f=2, p=8, d=16, seed=8)))
    assert approx.nystrom_spatial_attn(q, k, v, landmarks=4, num_frames=2).dtype == torch.bfloat16
    assert approx.orthoformer(q, k, v, num_landmarks=4, num_frames=2).dtype == torch.bfloat16
    out = approx.performer_attention(q, k, v, 2, m=32)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()


# ------------------------------------------------------------------- the model


def _video(arch, batch, seed):
    frames = arch["temporal_resolution"] * arch["patch_size_temp"]
    shape = (batch, frames, arch["img_size"], arch["img_size"], 3)
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _pair(approx_type, r, train_mode=False, seed=0):
    """The same Motionformer in both packages, fp32 parameters; Performer
    in both draws the JAX package's projection for key 0."""
    arch = dict(ARCH, approx_attn_type=approx_type, approx_attn_dim=LANDMARKS)
    kw = dict(rs=(r,) * arch["depth"], mode="merge" if r else "none", prop_attn=True)
    params = jax.tree_util.tree_map(np.asarray, convert_motionformer(_upstream_sd(arch, seed), depth=arch["depth"]))
    jmodel = JMotionformer(config=JConfig(**arch), policy=JPolicy(**kw), train_mode=train_mode)
    tmodel = Motionformer(MotionformerConfig(**arch), policy=MergePolicy(**kw), train_mode=train_mode,
                          fp32_params=True)
    tmodel.load_state_dict(motionformer_state_dict_from_vtm_params(params))
    return arch, params, jmodel, tmodel


@pytest.fixture
def jax_projection(monkeypatch):
    """Both packages' Performer use ``vtm``'s draw for key 0 at every layer."""
    hd = ARCH["embed_dim"] // ARCH["num_heads"]
    proj = np.array(japprox.create_projection_matrix(256, hd, jax.random.key(0)))
    monkeypatch.setattr(japprox, "create_projection_matrix", lambda m, d, rng: jnp.asarray(proj))
    monkeypatch.setattr(approx, "create_projection_matrix", lambda m, d, generator: torch.from_numpy(proj))
    return proj


@pytest.mark.parametrize("r", [R, 0], ids=["merged", "unmerged"])
@pytest.mark.parametrize("approx_type", APPROX_TYPES)
def test_model_matches_vtm(approx_type, r, monkeypatch, jax_projection):
    """Probabilities within 1e-4, identical Matching indices layer by layer
    and identical sizes; the spatial step is the approximation (K3's plain
    branch is not reached)."""
    arch, params, jmodel, tmodel = _pair(approx_type, r)
    tmodel.eval()
    video = _video(arch, 2, 1)
    seen = record_matchings(monkeypatch)
    with jax.default_matmul_precision("highest"):
        want, jstate = jmodel.apply({"params": params}, jnp.asarray(video))
    with torch.no_grad():
        got, tstate = tmodel(torch.from_numpy(video))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    if r:
        assert len(seen["torch"]) == arch["depth"]
        assert_same_matchings(seen)
        np.testing.assert_array_equal(tstate.size.numpy(), np.asarray(jstate.size))
        assert tuple(tstate.size.shape) == (2 * 4, 16 - 3 * R, 1)
    else:
        assert seen["torch"] == seen["jax"] == [] and tstate.size is None


@pytest.mark.parametrize("approx_type", APPROX_TYPES)
def test_sizes_do_not_reach_the_approximation(approx_type, jax_projection):
    """Proportional attention on or off gives the same first block: the
    token sizes bias only the full spatial softmax, as in vtm."""
    arch, _, _, tmodel = _pair(approx_type, R)
    x = tmodel.embed(torch.from_numpy(_video(arch, 1, 2)))
    size = torch.from_numpy(np.random.default_rng(3).integers(1, 4, (4, 16, 1)).astype(np.float32))
    with torch.no_grad():
        a, _ = tmodel.blocks[0].attn(tmodel.blocks[0].norm1(x), 4, size)
        b, _ = tmodel.blocks[0].attn(tmodel.blocks[0].norm1(x), 4, None)
    assert torch.equal(a, b)


@pytest.mark.parametrize("approx_type", APPROX_TYPES)
def test_gradients_match_vtm(approx_type, jax_projection):
    """Loss and every parameter's gradient of one merged train step (logits,
    cross-entropy) against ``jax.grad``, within GRAD_TOL of each tensor's
    largest entry; the analytically zero ones are named and must be noise."""
    import vtm.train.losses as jlosses
    import vtm_torch.train.losses as tlosses

    arch, params, jmodel, tmodel = _pair(approx_type, R, train_mode=True)
    video = _video(arch, 2, 3)
    labels = np.random.default_rng(4).integers(0, arch["num_classes"], 2)

    def loss_fn(p):
        out, _ = jmodel.apply({"params": p}, jnp.asarray(video))
        return jlosses.cross_entropy(out, jnp.asarray(labels))

    with jax.default_matmul_precision("highest"):
        want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    tmodel.train()
    out, _ = tmodel(torch.from_numpy(video))
    loss = tlosses.cross_entropy(out, torch.from_numpy(labels))
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= 1e-5
    want = {k: v.numpy() for k, v in motionformer_state_dict_from_vtm_params(
        jax.tree_util.tree_map(np.asarray, want_grads)).items()}
    d, last = arch["embed_dim"], arch["depth"] - 1
    noise = GRAD_NOISE * max(np.abs(w).max() for w in want.values())
    zero = {f"blocks.{last}.attn.{n}.{leaf}" for n in ("proj_q", "proj_kv") for leaf in ("weight", "bias")}
    for name, p in tmodel.named_parameters():
        g = p.grad.numpy()
        parts = [(slice(None), g, want[name])]
        if name in zero:
            parts = []
            assert np.abs(g).max() <= noise and np.abs(want[name]).max() <= noise, name
        elif name.endswith("attn.proj_kv.bias"):
            # the k half is zero analytically, the v half is never used
            assert np.abs(g).max() <= noise and np.abs(want[name]).max() <= noise, name
            parts = []
        elif name.endswith("attn.qkv.bias") and approx_type != "performer":
            assert np.abs(g[d:2 * d]).max() <= noise, name
            assert np.abs(want[name][d:2 * d]).max() <= noise, name
            keep = np.r_[0:d, 2 * d:3 * d]
            parts = [(keep, g, want[name])]
        for idx, got_part, want_part in parts:
            got_part, want_part = got_part[idx], want_part[idx]
            tol = GRAD_TOL * np.abs(want_part).max()
            assert tol > 0, name
            np.testing.assert_allclose(got_part, want_part, rtol=0, atol=tol, err_msg=name)
    # the approximation's own inputs got gradients
    assert torch.count_nonzero(tmodel.blocks[0].attn.qkv.weight.grad) > 0


def test_orthoformer_model_draws_its_first_landmarks_from_the_generator():
    """A forward's generator sets orthoformer's first landmark in every
    layer: one seed gives one output, and without a generator it is row 0
    (the JAX package's default without an rng)."""
    arch, _, _, tmodel = _pair("orthoformer", R)
    tmodel.eval()
    video = torch.from_numpy(_video(arch, 2, 5))
    drawn = []
    real = approx.orthogonal_landmark_indices

    def recording(q, m, init_idx=None, generator=None):
        idx = real(q, m, init_idx, generator)
        drawn.append(generator is not None)
        return idx

    approx.orthogonal_landmark_indices = recording
    try:
        with torch.no_grad():
            a, _ = tmodel(video, generator=torch.Generator().manual_seed(1))
            b, _ = tmodel(video, generator=torch.Generator().manual_seed(1))
            c, _ = tmodel(video)
    finally:
        approx.orthogonal_landmark_indices = real
    assert torch.equal(a, b) and drawn == [True] * 3 + [True] * 3 + [False] * 3
    assert torch.isfinite(c).all()


@pytest.mark.parametrize("approx_type", APPROX_TYPES)
def test_fp32_params_forward_is_bit_identical_to_precast_bf16(approx_type):
    """Training keeps fp32 parameters and casts them at use; serving casts
    them once: the bf16 forwards agree bit for bit."""
    arch = dict(ARCH, approx_attn_type=approx_type, approx_attn_dim=LANDMARKS)
    policy = MergePolicy(rs=(R,) * arch["depth"], mode="merge", prop_attn=True)
    kw = dict(policy=policy, dtype=torch.bfloat16, seed=5)
    serve = Motionformer(MotionformerConfig(**arch), **kw).eval()
    fit = Motionformer(MotionformerConfig(**arch), fp32_params=True, **kw).eval()
    video = torch.from_numpy(_video(arch, 2, 6))
    with torch.no_grad():
        a, sa = serve(video)
        b, sb = fit(video)
    assert a.dtype == torch.float32 and torch.equal(a, b) and torch.equal(sa.size, sb.size)


def test_build_model_reads_the_approximation_from_the_config():
    from vtm_torch.config import get_cfg
    from vtm_torch.models import build_model

    cfg = get_cfg()
    cfg.merge_from_list([
        "MODEL.MODEL_NAME", "Motionformer", "MOTIONFORMER.EMBED_DIM", "32", "MOTIONFORMER.DEPTH", "2",
        "MOTIONFORMER.NUM_HEADS", "2", "MOTIONFORMER.TEMPORAL_RESOLUTION", "2", "DATA.TRAIN_CROP_SIZE", "32",
        "MOTIONFORMER.APPROX_ATTN_TYPE", "nystrom", "MOTIONFORMER.APPROX_ATTN_DIM", "4",
    ])
    module = build_model(cfg, "cpu").module
    assert (module.config.approx_attn_type, module.config.approx_attn_dim) == ("nystrom", 4)
    assert module.blocks[1].attn.approx_attn_dim == 4
    cfg.MOTIONFORMER.APPROX_ATTN_TYPE = "linformer"
    with pytest.raises(ValueError, match="approx_attn_type"):
        build_model(cfg, "cpu")
