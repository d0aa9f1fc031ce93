"""The port's PTV families with every BatchNorm live, against ``vtm`` on
the CPU in fp64 (fp32 is itself ill-conditioned there: train-mode logits of
either package sit up to 8.6e-5 from fp64 at this size): plain and
sub-batch BatchNorm (``BN.NORM_TYPE sub_batchnorm``, 2 contiguous splits)
through a train-mode forward and backward of a tiny CSN and R(2+1)D
(``torch_conv_cases.PTVCase``), the fold of the split statistics, and a
batch the splits do not divide, and ``train_net.refresh_bn_stats``
(precise statistics, then the fold) on a model with splits. About 35 s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import vtm.models.convnet as jax_convnet
from vtm.checkpoints.convert import convert_pyslowfast
from vtm.train.precise_bn import compute_precise_bn_stats as jax_precise_bn

from vtm_torch.checkpoints.convert import ptv_state_dict_from_vtm_params
from vtm_torch.models.convnet import aggregate_subbn_stats, batchnorms
from vtm_torch.tools import train_net

from torch_conv_cases import PTVCase, assert_close_to_largest, np_tree

torch.set_num_threads(2)

# fp64 in both packages: every gradient within FP64_TOL of its tensor's
# largest entry, or of FP64_FLOOR times the model's largest gradient where
# its own is below that; the loss, the logits and each statistic within
# FP64_TOL of their largest. No gradient here is zero analytically (the
# convs have no bias), so none may fall below the floor.
FP64_TOL = 1e-9
FP64_FLOOR = 1e-6


@pytest.fixture(scope="module")
def cases():
    return {}


def _case(cases, name, *extra):
    key = (name,) + extra
    if key not in cases:
        cases[key] = PTVCase(name, *extra)
    return cases[key]


class _NumpyFloat32As64:
    """``jax.numpy`` with ``float32`` read as ``float64`` (see
    ``tests/test_torch_slowfast_train.py``): ``vtm``'s BatchNorm and head
    arithmetic in fp64."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.mark.parametrize("splits", [1, 2])
@pytest.mark.parametrize("name", ["csn", "r2plus1d"])
def test_train_mode_matches_vtm_in_fp64(name, splits, cases, monkeypatch):
    """Every BatchNorm live (weights about 1, each block's final one
    included), plain (``batchnorm``) or sub-batch (``sub_batchnorm``, 2
    splits of B4: rows 0-1 and 2-3): the loss, the logits, every parameter's
    gradient and every statistic after the forward (under splits the eval
    ``bn.running_*`` untouched and every ``split_bn.running_*`` moved)
    against ``jax.grad`` of ``vtm``'s train-mode forward, both in fp64; then
    the fold of the split statistics against ``vtm``'s
    ``aggregate_subbn_stats``."""
    extra = ("BN.NORM_TYPE", "sub_batchnorm", "BN.NUM_SPLITS", "2") if splits > 1 else ()
    case = _case(cases, name, *extra)
    module = case.bundle.module
    assert {bn.num_splits for bn in batchnorms(module)} == {splits}
    frames = case.video(4, seed=3).astype(np.float64)
    labels = np.array([1, 5, 0, 6])
    monkeypatch.setattr(jax_convnet, "jnp", _NumpyFloat32As64())
    with jax.enable_x64(True):
        params, stats = convert_pyslowfast({k: v.astype(np.float64) for k, v in case.state.items()},
                                           num_splits=splits)
        jmod = case.jbundle.module
        x, y = jnp.asarray(frames), jnp.asarray(labels)

        def loss_fn(p):
            (logits, _), mutated = jmod.apply({"params": p, "batch_stats": stats}, x, train=True,
                                              mutable=["batch_stats"])
            loss = -jnp.take_along_axis(jax.nn.log_softmax(logits), y[:, None], axis=1).mean()
            return loss, (logits, mutated["batch_stats"])

        (loss, (logits, new_stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
        assert {str(a.dtype) for a in jax.tree_util.tree_leaves((logits, grads, new_stats))} == {"float64"}
        folded = np_tree(jax_convnet.aggregate_subbn_stats(new_stats))
        want = {k: v.numpy() for k, v in ptv_state_dict_from_vtm_params(np_tree(grads), np_tree(new_stats)).items()}
        want_folded = {k: v.numpy() for k, v in ptv_state_dict_from_vtm_params({}, folded).items()}
        want_loss, want_logits = float(loss), np.asarray(logits)
    port = module.double().train()
    try:
        got_logits, _ = port(torch.from_numpy(frames))
        got_loss = F.cross_entropy(got_logits, torch.from_numpy(labels))
        got_loss.backward()
        assert abs(float(got_loss.detach()) - want_loss) <= FP64_TOL * abs(want_loss)
        assert_close_to_largest(got_logits.detach().numpy(), want_logits, FP64_TOL, "logits")
        grads_got = {k: p.grad.numpy() for k, p in port.named_parameters()}
        assert set(grads_got) | {k for k, _ in port.named_buffers()} == set(want)
        largest = max(float(np.abs(want[k]).max()) for k in grads_got)
        dead = sorted(k for k in grads_got if np.abs(want[k]).max() < FP64_FLOOR * largest)
        assert not dead, dead
        for k, g in grads_got.items():
            scale = max(float(np.abs(want[k]).max()), FP64_FLOOR * largest)
            assert float(np.abs(g - want[k]).max()) <= FP64_TOL * scale, k
        for k, b in port.named_buffers():
            if ".bn.running_" in k:  # a SubBatchNorm's eval statistics
                np.testing.assert_array_equal(b.numpy(), case.state[k].astype(np.float64), err_msg=k)
            else:
                assert not np.array_equal(b.numpy(), case.state[k]), f"{k} did not move"
            assert_close_to_largest(b.numpy(), want[k], FP64_TOL, k)
        aggregate_subbn_stats(port)
        for k, b in port.named_buffers():
            assert_close_to_largest(b.numpy(), want_folded[k], FP64_TOL, f"folded {k}")
    finally:
        port.float().eval().zero_grad(set_to_none=True)
        port.load_state_dict({k: torch.from_numpy(v) for k, v in case.state.items()})


def test_sub_batchnorm_needs_a_batch_the_splits_divide(cases):
    """B3 into 2 splits: ``vtm``'s reshape fails, the port raises; nothing is
    padded."""
    case = _case(cases, "r2plus1d", "BN.NORM_TYPE", "sub_batchnorm", "BN.NUM_SPLITS", "2")
    x = case.video(3, seed=4)
    with pytest.raises(TypeError):
        case.jax_apply(x, True)
    module = case.bundle.module.train()
    try:
        with pytest.raises(ValueError, match="does not split into 2"):
            module(torch.from_numpy(x))
    finally:
        module.eval()


@pytest.mark.parametrize("name", ["csn", "r2plus1d"])
def test_precise_bn_then_fold_matches_vtm(name, cases, monkeypatch):
    """``train_net.refresh_bn_stats`` on a model with 2 splits a BatchNorm,
    every BatchNorm live: precise statistics over 2 of 3 B4 batches (every
    split statistic the average of the batches'), then the fold into the
    eval statistics, against ``vtm``'s ``compute_precise_bn_stats`` and
    ``aggregate_subbn_stats`` in the same order, both in fp64, each
    statistic within FP64_TOL of its largest."""
    case = _case(cases, name, "BN.NORM_TYPE", "sub_batchnorm", "BN.NUM_SPLITS", "2")
    cfg = case.cfg.clone()
    cfg.merge_from_list(["BN.USE_PRECISE_STATS", "True", "BN.NUM_BATCHES_PRECISE", "2"])
    loader = [{"frames": case.video(4, seed=s).astype(np.float64)} for s in (4, 5, 6)]
    monkeypatch.setattr(jax_convnet, "jnp", _NumpyFloat32As64())
    with jax.enable_x64(True):
        params, stats = convert_pyslowfast({k: v.astype(np.float64) for k, v in case.state.items()}, num_splits=2)
        want = jax_convnet.aggregate_subbn_stats(jax_precise_bn(case.jbundle.module, params, stats, loader, 2))
        want = {k: v.numpy() for k, v in ptv_state_dict_from_vtm_params({}, np_tree(want)).items()}
    module = case.bundle.module.double()
    try:
        train_net.refresh_bn_stats(cfg, module, loader, torch.device("cpu"), 0)
        assert not module.training
        buffers = dict(module.named_buffers())
        assert set(buffers) == set(want)
        for k, v in buffers.items():
            assert not np.array_equal(v.numpy(), case.state[k]), f"{k} did not move"
            assert_close_to_largest(v.numpy(), want[k], FP64_TOL, k)
    finally:
        module.float().eval()
        module.load_state_dict({k: torch.from_numpy(v) for k, v in case.state.items()})
