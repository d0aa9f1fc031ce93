"""The port's conv-family building blocks and converters against ``vtm``'s
on the CPU: one BatchNorm (plain, sub-batch with 2 splits, frozen) in
training and eval mode, the sub-batch fold, the statistics of the global
batch over two gloo ranks (plain and sub-batch) against ``vtm``'s on the
whole batch, ``pack_pathway_output``'s frames for every shipped (T, alpha),
``round_width``, the checkpoint rules for BatchNorm statistics and 2-D
weights, and the Caffe2 names."""

import datetime
import itertools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vtm.checkpoints.checkpoint as jax_checkpoint
import vtm.models.convnet as jconv
from vtm.checkpoints.convert import caffe2_name_to_pytorch as jax_caffe2_name
from vtm.checkpoints.convert import convert_caffe2 as jax_convert_caffe2

from vtm_torch.checkpoints import checkpoint as cu
from vtm_torch.checkpoints.convert import caffe2_name_to_pytorch, convert_caffe2, pyslowfast_state_dict_from_vtm
from vtm_torch.config import get_cfg
from vtm_torch.models import convnet
from vtm_torch.models.slowfast import pack_pathway_output, slow_indices
from vtm_torch.parallel.launch import launch_job
from vtm_torch.parallel.probes import bn_probe

from torch_conv_cases import assert_close_to_largest

torch.set_num_threads(2)

BN_TOL = 1e-6  # one BatchNorm on the same input, of each tensor's largest entry
GRAD_TOL = 1e-5
_LAUNCHES = itertools.count()


def _bn_inputs(seed: int, b: int = 4):
    rng = np.random.default_rng(seed)
    x = (1.5 * rng.standard_normal((b, 3, 5, 4, 6)) + 0.3).astype(np.float32)  # [B, T, H, W, C]
    scale = (1.0 + 0.1 * rng.standard_normal(6)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(6)).astype(np.float32)
    return x, scale, bias


def _jax_bn(k: int, frozen: bool):
    return jconv.BatchNorm(jconv.NormSpec(frozen=frozen), num_splits=k)


def _port_bn(k: int, frozen: bool, scale, bias, stats):
    bn = convnet.BatchNorm(6, convnet.NormSpec(frozen=frozen), num_splits=k)
    sd = {"weight": scale, "bias": bias}
    sd.update({k_: v.numpy() for k_, v in pyslowfast_state_dict_from_vtm({}, stats).items()})
    bn.load_state_dict({k_: torch.as_tensor(np.asarray(v)) for k_, v in sd.items()})
    return bn


def _stats(k: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    stats = {"mean": 0.1 * rng.standard_normal(6), "var": np.exp(0.2 * rng.standard_normal(6))}
    if k > 1:
        stats["split_mean"] = 0.1 * rng.standard_normal((k, 6))
        stats["split_var"] = np.exp(0.2 * rng.standard_normal((k, 6)))
    return {n: v.astype(np.float32) for n, v in stats.items()}


@pytest.mark.parametrize("k,frozen", [(1, False), (2, False), (1, True)])
def test_batchnorm_matches_vtm(k, frozen):
    """Training mode: the output (normalised with the batch's statistics,
    or with the running ones under FROZEN_BN) and the running statistics
    after it (biased variance; per split of 2 contiguous chunks), then eval
    mode: each within BN_TOL of the tensor's largest entry."""
    x, scale, bias = _bn_inputs(k)
    stats = _stats(k, seed=10 + k)
    variables = {"params": {"scale": scale, "bias": bias}, "batch_stats": stats}
    jbn = _jax_bn(k, frozen)
    want, mutated = jbn.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    bn = _port_bn(k, frozen, scale, bias, stats).train()
    got = bn(torch.from_numpy(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    assert_close_to_largest(got.detach().numpy(), want, BN_TOL, "train output")
    want_sd = pyslowfast_state_dict_from_vtm({}, jax.tree_util.tree_map(np.asarray, mutated["batch_stats"]))
    for name, buf in bn.named_buffers():
        assert_close_to_largest(buf.numpy(), want_sd[name].numpy(), BN_TOL, name)
        if frozen:
            np.testing.assert_array_equal(buf.numpy(), want_sd[name].numpy())
    bn.eval()
    with torch.no_grad():
        got = bn(torch.from_numpy(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    want = jbn.apply({"params": variables["params"], "batch_stats": mutated["batch_stats"]}, jnp.asarray(x))
    assert_close_to_largest(got.numpy(), want, BN_TOL, "eval output")


def test_biased_variance_is_what_is_stored():
    """The running variance moves toward the biased batch variance, as in
    ``vtm``, not the unbiased one ``F.batch_norm`` would store."""
    x = torch.arange(16, dtype=torch.float32).view(2, 1, 2, 2, 2)
    bn = convnet.BatchNorm(1, convnet.NormSpec(momentum=1.0)).train()
    bn(x)
    assert float(bn.running_var) == pytest.approx(float(x.var(unbiased=False)), rel=1e-6)
    assert float(bn.running_var) != pytest.approx(float(x.var(unbiased=True)), rel=1e-3)


def test_aggregate_subbn_stats_matches_vtm():
    stats = {"s1": {"bn": _stats(3, seed=5)}, "head": {"x_bn": _stats(1, seed=6)}}
    want = jax.tree_util.tree_map(np.asarray, jconv.aggregate_subbn_stats(stats))
    net = torch.nn.Module()
    net.add_module("a", _port_bn(3, False, np.ones(6, np.float32), np.zeros(6, np.float32), stats["s1"]["bn"]))
    net.add_module("b", _port_bn(1, False, np.ones(6, np.float32), np.zeros(6, np.float32), stats["head"]["x_bn"]))
    convnet.aggregate_subbn_stats(net)
    np.testing.assert_allclose(net.a.bn.running_mean.numpy(), want["s1"]["bn"]["mean"], rtol=1e-6)
    np.testing.assert_allclose(net.a.bn.running_var.numpy(), want["s1"]["bn"]["var"], rtol=1e-6)
    np.testing.assert_array_equal(net.b.running_mean.numpy(), stats["head"]["x_bn"]["mean"])


class _JaxConvBN(fnn.Module):
    """conv (4 -> 6, 1x3x3, bias) then BatchNorm: ``probes.bn_probe``'s net."""

    k: int

    @fnn.compact
    def __call__(self, x):
        x = jconv.conv3d(6, (1, 3, 3), bias=True, name="conv")(x)
        return jconv.BatchNorm(jconv.NormSpec(), num_splits=self.k, name="bn")(x, train=True)


@pytest.mark.parametrize("k", [1, 2])
def test_global_batch_statistics_over_two_ranks_match_vtm(k, tmp_path):
    """Two gloo ranks, 3 rows each, the statistics summed over the group:
    the output rows, the input's and the parameters' gradients of the
    global loss (the all-reduce in the backward; the conv bias's, zero
    analytically, only near zero in both) and the running statistics
    against ``vtm``'s BatchNorm on the whole batch of 6 (``jax.grad``);
    with 2 splits each split is 3 contiguous rows of the global batch, so
    split 0 is rank 0's rows and split 1 rank 1's."""
    rng = np.random.default_rng(20 + k)
    b = 6
    x = rng.standard_normal((b, 4, 3, 5, 5)).astype(np.float32)  # [B, C, T, H, W]
    w = rng.standard_normal((b, 6, 3, 5, 5)).astype(np.float32)
    kernel = (0.3 * rng.standard_normal((1, 3, 3, 4, 6))).astype(np.float32)
    params = {"conv": {"kernel": kernel, "bias": (0.1 * rng.standard_normal(6)).astype(np.float32)},
              "bn": {"scale": (1 + 0.1 * rng.standard_normal(6)).astype(np.float32),
                     "bias": (0.1 * rng.standard_normal(6)).astype(np.float32)}}
    stats = {"bn": _stats(k, seed=30 + k)}
    sd = pyslowfast_state_dict_from_vtm(params, stats)
    state = {n.replace("conv.", "0.").replace("bn.", "1.", 1): v.numpy() for n, v in sd.items()}

    jnet = _JaxConvBN(k)
    xj, wj = jnp.asarray(x.transpose(0, 2, 3, 4, 1)), jnp.asarray(w.transpose(0, 2, 3, 4, 1))

    def loss(p, xj):
        y, mutated = jnet.apply({"params": p, "batch_stats": stats}, xj, mutable=["batch_stats"])
        return (y * wj).sum() / b, (y, mutated["batch_stats"])

    (_, (y, new_stats)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(params, xj)
    cfg = get_cfg()
    cfg.merge_from_list(["TRAIN.BATCH_SIZE", str(b)])
    out = launch_job(cfg, bn_probe, ["cpu", "cpu"], backend="gloo", args=(state, x, w, k),
                     init_method=f"file://{tmp_path}/rendezvous_{next(_LAUNCHES)}",
                     timeout=datetime.timedelta(seconds=120), join_timeout=300.0, num_threads=1)
    y_t = np.concatenate([r["out"] for r in out]).transpose(0, 2, 3, 4, 1)
    gx_t = np.concatenate([r["x_grad"] for r in out]).transpose(0, 2, 3, 4, 1)
    assert_close_to_largest(y_t, y, BN_TOL, "output")
    assert_close_to_largest(gx_t, gx, GRAD_TOL, "input gradient")
    want_grads = {n.replace("conv.", "0.").replace("bn.", "1.", 1): v.numpy()
                  for n, v in pyslowfast_state_dict_from_vtm(jax.tree_util.tree_map(np.asarray, gp)).items()}
    want_stats = {n.replace("bn.", "1.", 1): v.numpy() for n, v in
                  pyslowfast_state_dict_from_vtm({}, {"bn": jax.tree_util.tree_map(np.asarray, new_stats["bn"])}).items()}
    for r in out:
        assert r["grads"].keys() == want_grads.keys()
        for n, g in r["grads"].items():
            if n == "0.bias":  # zero analytically: the mean subtraction removes it; noise in both
                scale = np.abs(want_grads["0.weight"]).max()
                assert np.abs(g).max() < GRAD_TOL * scale and np.abs(want_grads[n]).max() < GRAD_TOL * scale
                continue
            assert_close_to_largest(g, want_grads[n], GRAD_TOL, n)
        assert r["buffers"].keys() == want_stats.keys()
        for n, s in r["buffers"].items():
            assert_close_to_largest(s, want_stats[n], BN_TOL, n)


# (T, alpha) of configs/slowfast/*.yaml and of tests/test_convnet.py
SHIPPED_T_ALPHA = [(32, 8), (32, 4), (64, 4), (8, 4)]


@pytest.mark.parametrize("t,alpha", SHIPPED_T_ALPHA + [(t, a) for t in range(1, 70) for a in (2, 3, 4, 8)
                                                       if (t, a) not in SHIPPED_T_ALPHA][::7])
def test_slow_pathway_frames_are_vtms(t, alpha):
    """``vtm``'s float32 ``jnp.linspace(0, t - 1, t // alpha)`` truncated:
    the same frame indices, and ``pack_pathway_output`` takes those frames."""
    want = np.asarray(jnp.linspace(0, t - 1, t // alpha).astype(jnp.int32))
    np.testing.assert_array_equal(slow_indices(t, alpha), want)
    frames = torch.arange(t, dtype=torch.float32).view(1, t, 1, 1, 1).expand(2, t, 2, 2, 3)
    slow, fast = pack_pathway_output(frames, alpha)
    np.testing.assert_array_equal(slow[0, :, 0, 0, 0].numpy(), want.astype(np.float32))
    assert fast is frames


def test_round_width_is_vtms():
    for width in (1, 3, 8, 12, 24, 54, 64, 192, 432):
        for mult in (0, 0.0625, 0.5, 1.0, 2.0, 2.2):
            for divisor in (1, 8):
                assert convnet.round_width(width, mult, divisor=divisor) == jconv.round_width(
                    width, mult, divisor=divisor), (width, mult, divisor)


def test_merge_bn_stats_normal_to_sub():
    """A plain-BN file into a sub-BN module (``vtm``'s
    ``test_merge_bn_stats_normal_to_sub``): ``split_bn`` tiles the plain
    statistics per split, ``bn`` takes them, a missing BatchNorm keeps its
    init, and the result is ``vtm``'s ``merge_bn_stats`` on its trees."""
    net = torch.nn.Module()
    net.add_module("s1", convnet.BatchNorm(4, convnet.NormSpec(), num_splits=2))
    net.add_module("s2", convnet.BatchNorm(4, convnet.NormSpec(), num_splits=2))
    template = net.state_dict()
    converted = {"s1.running_mean": torch.arange(4.0), "s1.running_var": torch.arange(4.0) + 1}
    merged, loaded, kept = cu.merge_into_template(template, cu.merge_bn_stats(template, converted))
    want = jax_checkpoint.merge_bn_stats(
        {"s1": {"mean": np.zeros(4), "var": np.ones(4), "split_mean": np.zeros((2, 4)), "split_var": np.ones((2, 4))},
         "s2": {"mean": np.zeros(4), "var": np.ones(4), "split_mean": np.zeros((2, 4)), "split_var": np.ones((2, 4))}},
        {"s1": {"mean": np.arange(4.0), "var": np.arange(4.0) + 1}}, num_splits=2)
    for name in ("s1", "s2"):
        np.testing.assert_array_equal(merged[f"{name}.split_bn.running_mean"].numpy(),
                                      np.asarray(want[name]["split_mean"]).reshape(-1))
        np.testing.assert_array_equal(merged[f"{name}.split_bn.running_var"].numpy(),
                                      np.asarray(want[name]["split_var"]).reshape(-1))
    np.testing.assert_array_equal(merged["s1.bn.running_mean"].numpy(), np.arange(4.0))
    np.testing.assert_array_equal(merged["s2.bn.running_var"].numpy(), np.ones(4))


def test_inflate_and_image_init_are_vtms():
    """A 2-D [O, I, H, W] kernel against a 3-D template: inflated (repeated
    over T, divided by T), image-initialised (repeated, not divided), a
    T = 1 kernel repeated, a rel_pos table interpolated, a mismatch passed
    on; each equal to ``vtm``'s on the DHWIO trees."""
    rng = np.random.default_rng(3)
    two_d = rng.standard_normal((6, 4, 3, 3)).astype(np.float32)
    one_t = rng.standard_normal((6, 4, 1, 3, 3)).astype(np.float32)
    rel = rng.standard_normal((5, 8)).astype(np.float32)
    template = {"a.weight": torch.zeros(6, 4, 5, 3, 3), "b.weight": torch.zeros(6, 4, 5, 3, 3),
                "rel_pos_h": torch.zeros(9, 8), "c.weight": torch.zeros(7, 7)}
    converted = {"a.weight": torch.from_numpy(two_d), "b.weight": torch.from_numpy(one_t),
                 "rel_pos_h": torch.from_numpy(rel), "c.weight": torch.zeros(3, 3)}
    jt = {"a": {"kernel": np.zeros((5, 3, 3, 4, 6))}, "b": {"kernel": np.zeros((5, 3, 3, 4, 6))},
          "rel_pos_h": np.zeros((9, 8))}
    jc = {"a": {"kernel": two_d.transpose(2, 3, 1, 0)}, "b": {"kernel": one_t.transpose(2, 3, 4, 1, 0)},
          "rel_pos_h": rel}
    inflated = cu.inflate_weights(converted, template)
    jinfl = jax_checkpoint.inflate_weights(jc, jt)
    np.testing.assert_allclose(inflated["a.weight"].numpy(), jinfl["a"]["kernel"].transpose(4, 3, 0, 1, 2), rtol=1e-6)
    assert inflated["c.weight"].shape == (3, 3)
    adapted = cu.image_init_adapt(converted, template)
    jad = jax_checkpoint.image_init_adapt(jc, jt)
    np.testing.assert_array_equal(adapted["a.weight"].numpy(), jad["a"]["kernel"].transpose(4, 3, 0, 1, 2))
    np.testing.assert_array_equal(adapted["b.weight"].numpy(), jad["b"]["kernel"].transpose(4, 3, 0, 1, 2))
    np.testing.assert_allclose(adapted["rel_pos_h"].numpy(), jad["rel_pos_h"], rtol=1e-5, atol=1e-6)


CAFFE2_NAMES = [
    "conv1_w", "res_conv1_bn_s", "res_conv1_bn_b", "res_conv1_bn_rm", "res_conv1_bn_riv",
    "res2_0_branch2a_w", "res2_0_branch2a_bn_s", "res2_0_branch2a_bn_rm", "res2_0_branch2a_bn_riv",
    "res3_1_branch1_w", "res3_1_branch1_bn_s", "res5_2_branch2c_bn_b", "t_conv1_w", "t_res_conv1_bn_s",
    "t_res2_0_branch2b_w", "t_res3_0_branch1_w", "t_pool1_subsample_w", "t_pool1_subsample_bn_s",
    "t_res2_0_branch2c_bn_subsample_w", "t_res2_0_branch2c_bn_subsample_bn_rm", "nonlocal_conv3_1_theta_w",
    "nonlocal_conv3_1_theta_b", "nonlocal_conv3_1_g_w", "nonlocal_conv3_1_phi_b", "nonlocal_conv3_1_out_w",
    "nonlocal_conv3_1_bn_s", "nonlocal_conv3_1_bn_riv", "pred_w", "pred_b", "conv1_xy_w", "conv_5_w",
    "conv_5_bn_s", "lin_5_w", "res2_0_branch2b_bn_fc1_w", "res2_0_branch2b_bn_fc2_b",
]


def test_caffe2_names_and_blobs_are_vtms():
    """Every name of the blobs of ``tests/test_caffe2_convert.py`` and of the
    upstream table's branches maps as ``vtm``'s; ``convert_caffe2`` skips the
    momentum, ``model_iter`` and ``lr`` blobs and gives ``vtm``'s arrays
    under the port's names."""
    for name in CAFFE2_NAMES:
        assert caffe2_name_to_pytorch(name) == jax_caffe2_name(name), name
    rng = np.random.default_rng(0)
    blobs = {"conv1_w": rng.standard_normal((8, 3, 1, 7, 7)).astype(np.float32),
             "res_conv1_bn_s": np.ones(8, np.float32), "res_conv1_bn_b": np.zeros(8, np.float32),
             "res_conv1_bn_rm": rng.standard_normal(8).astype(np.float32), "res_conv1_bn_riv": np.ones(8, np.float32),
             "pred_w": rng.standard_normal((10, 64)).astype(np.float32), "pred_b": np.zeros(10, np.float32),
             "conv1_w_momentum": np.zeros(1, np.float32), "model_iter": np.zeros(1, np.float32)}
    got = convert_caffe2(blobs)
    params, stats = jax_convert_caffe2(blobs)
    want = pyslowfast_state_dict_from_vtm(params, stats)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)


@pytest.mark.parametrize("shape, kernel, stride, padding", [
    ((2, 4, 3, 9, 11), (1, 3, 3), (1, 2, 2), (0, 1, 1)),  # the stems' overlapping windows
    ((1, 3, 4, 8, 8), (2, 2, 2), (2, 2, 2), (0, 0, 0)),  # a pathway pool: kernel = stride
    ((2, 2, 5, 7, 7), (3, 3, 3), (1, 2, 2), (1, 1, 1)),  # MViT's pooling
])
def test_max_pool3d_backward_is_torchs_ties_included(shape, kernel, stride, padding):
    """The one deterministic ``convnet.max_pool3d`` that the stems, the
    pathway pools and MViT pool with: its output and input gradient equal
    ``F.max_pool3d``'s autograd ones, on inputs of many ties (rounded, and a
    block of zeros as ReLU leaves them), channels-last too; its backward
    goes through ``_MaxPool3d``, and the same bits twice."""
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(shape, generator=gen).round()
    x[:, :, :, : shape[3] // 2] = 0.0
    for memory_format in (torch.contiguous_format, torch.channels_last_3d):
        x = x.to(memory_format=memory_format)
        grad = torch.randn(F.max_pool3d(x, kernel, stride, padding).shape, generator=gen)
        want_x = x.clone().requires_grad_(True)
        want = F.max_pool3d(want_x, kernel, stride, padding)
        want.backward(grad)
        got_x = x.clone().requires_grad_(True)
        got = convnet.max_pool3d(got_x, kernel, stride, padding)
        assert got.grad_fn.name() == "_MaxPool3dBackward"
        got.backward(grad)
        first = got_x.grad.clone()
        got_x.grad = None
        convnet.max_pool3d(got_x, kernel, stride, padding).backward(grad)
        assert torch.equal(got, want) and torch.equal(first, got_x.grad)
        torch.testing.assert_close(first, want_x.grad, rtol=0, atol=1e-6)
    with torch.no_grad():
        assert convnet.max_pool3d(x, kernel, stride, padding).grad_fn is None


def test_one_max_pool_serves_the_stems_and_mvit():
    from vtm_torch.models import mvit, ptv, slowfast

    assert mvit.max_pool3d is ptv.max_pool3d is slowfast.max_pool3d is convnet.max_pool3d
    assert not hasattr(mvit, "_MaxPool3d")
