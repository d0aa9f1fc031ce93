"""The port's PTV families (``vtm_torch/models/ptv.py``: CSN and R(2+1)D)
against ``vtm/models/ptv.py`` on the CPU, tiny (``torch_conv_cases.PTVCase``:
the depth-18 table of bottlenecks, width 4, 8 frames at a 32-pixel crop),
from the same weights: eval outputs and, with the shipped init, train-mode
logits and statistics in fp32; the weight bridge both ways; the
architecture (depthwise ``conv_b``, stage depths, temporal strides); the
aliases (``PTVMViT`` builds MViT, held against ``vtm``'s), detection's raises; and the head under a
short-cycle crop smaller than its pool, where ``vtm`` gives empty logits and
the port raises. Live (sub-batch) BatchNorm in fp64:
``test_torch_ptv_train.py``. About 35 s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtm.models.build import build_model as jax_build_model

from vtm_torch.checkpoints.convert import ptv_state_dict_from_vtm_params
from vtm_torch.models import build_model
from vtm_torch.models.mvit import MViTModel
from vtm_torch.models.slowfast import ResNetModel, SlowFastModel, X3DModel

from torch_conv_cases import NAMES, X3D, PTVCase, assert_close_to_largest, cfgs, ptv_opts, stats_tol, tiny_opts

torch.set_num_threads(2)

# fp32, of the largest entry: eval outputs (on the moved running statistics)
# and train-mode logits (batch statistics at every BatchNorm, the shipped init)
LOGIT_TOL = 1e-5


@pytest.fixture(scope="module")
def cases():
    return {}


def _case(cases, name, *extra, move_weights: bool = True):
    key = (name, move_weights) + extra
    if key not in cases:
        cases[key] = PTVCase(name, *extra, move_weights=move_weights)
    return cases[key]


@pytest.mark.parametrize("name", ["csn", "r2plus1d"])
def test_forward_matches_vtm(name, cases):
    """fp32. Eval mode on moved running statistics and BatchNorm weights:
    the softmax within LOGIT_TOL. Train mode (batch statistics at every
    BatchNorm) with the shipped init (``RESNET.ZERO_INIT_FINAL_BN``, each
    block's final BatchNorm at 0): the logits within LOGIT_TOL (measured
    3.3e-6 at most), every running statistic within ``stats_tol``. With every
    BatchNorm live, fp32 train-mode logits of either package sit up to 8.6e-5
    from fp64 at this size, so that case is held in fp64
    (``test_torch_ptv_train.py``)."""
    case = _case(cases, name)
    x = case.video(2, seed=1)
    with torch.no_grad():
        got, state = case.bundle.module(torch.from_numpy(x))
    assert state is None and got.shape == (2, 7)
    assert_close_to_largest(got.numpy(), case.jax_apply(x, False), LOGIT_TOL, f"{name} eval")
    np.testing.assert_allclose(got.sum(dim=1).numpy(), 1.0, rtol=0, atol=1e-5)
    case = _case(cases, name, "RESNET.ZERO_INIT_FINAL_BN", "True", move_weights=False)
    module = case.bundle.module.train()
    try:
        with torch.no_grad():
            logits, _ = module(torch.from_numpy(x))
        want_logits, want_stats = case.jax_apply(x, True)
        assert_close_to_largest(logits.numpy(), want_logits, LOGIT_TOL, f"{name} train logits")
        want = {k: v.numpy() for k, v in ptv_state_dict_from_vtm_params({}, want_stats).items()}
        assert set(want) == {k for k, _ in module.named_buffers()}
        for k, v in module.named_buffers():
            assert_close_to_largest(v.numpy(), want[k], stats_tol(k), k)
    finally:
        module.load_state_dict({k: torch.from_numpy(v) for k, v in case.state.items()})
        module.eval()


@pytest.mark.parametrize("name", ["csn", "r2plus1d"])
def test_bridge_round_trip(name, cases):
    """``ptv_state_dict_from_vtm_params`` of ``vtm``'s trees is the port's
    state dict, bit for bit, with and without splits."""
    for case in (_case(cases, name), _case(cases, name, "BN.NORM_TYPE", "sub_batchnorm", "BN.NUM_SPLITS", "2")):
        sd = ptv_state_dict_from_vtm_params(case.params, case.stats)
        assert set(sd) == set(case.state)
        for k, v in sd.items():
            np.testing.assert_array_equal(v.numpy(), case.state[k], err_msg=k)


def test_csn_depthwise_and_stage_depths(cases):
    """CSN's ``conv_b`` is channel-separated ([C, 1, 3, 3, 3], groups C) and
    the stage depths follow the table; depth 152 is CSN's own entry."""
    module = _case(cases, "csn").bundle.module
    for i, stage in enumerate(("s2", "s3", "s4", "s5")):
        conv = getattr(module, stage).res_0.branch2.conv_b
        assert conv.groups == conv.out_channels == 4 * 2**i and tuple(conv.weight.shape[1:]) == (1, 3, 3, 3)
        assert getattr(module, stage).num_blocks == 2
    cfg, jcfg = cfgs(ptv_opts("csn", "RESNET.DEPTH", "152"))
    jmod = jax_build_model(jcfg, init=False).module
    want = jax.eval_shape(jmod.init, jax.random.key(0), jnp.zeros((1, 8, 32, 32, 3)))["params"]
    deep = build_model(cfg, "cpu").module
    assert [getattr(deep, s).num_blocks for s in ("s2", "s3", "s4", "s5")] == [3, 8, 36, 3]
    assert [len([k for k in want[s] if k.startswith("res_")]) for s in ("s2", "s3", "s4", "s5")] == [3, 8, 36, 3]


def test_r2plus1d_factorisation_and_temporal_strides(cases):
    """``conv_b`` factorised 1x3x3 then 3x1x1 with a BatchNorm between; T 8
    stays through s3 and halves twice after (head pool T // 4)."""
    module = _case(cases, "r2plus1d").bundle.module
    blk = module.s2.res_0.branch2
    assert tuple(blk.conv_b_xy.weight.shape[2:]) == (1, 3, 3) and tuple(blk.conv_b_t.weight.shape[2:]) == (3, 1, 1)
    seen = {}
    hooks = [getattr(module, s).register_forward_hook(lambda m, a, out, s=s: seen.__setitem__(s, out.shape[2]))
             for s in ("s2", "s3", "s4", "s5")]
    try:
        with torch.no_grad():
            module(torch.zeros(1, 8, 32, 32, 3))
    finally:
        for h in hooks:
            h.remove()
    assert seen == {"s2": 8, "s3": 8, "s4": 4, "s5": 2}
    assert module.head.pool_size == ((2, 1, 1),)


@pytest.mark.parametrize("name, arch, native", [("PTVX3D", "x3d", X3DModel), ("PTVSlowFast", "slowfast", SlowFastModel),
                                                ("PTVResNet", "i3d", ResNetModel)])
def test_aliases_build_native_models(name, arch, native):
    """The PTV names of the native families build the port's native models
    under the PTV name, as ``vtm``'s build its own."""
    cfg, jcfg = cfgs(tiny_opts(name, arch, *(X3D if arch == "x3d" else ())))
    bundle = build_model(cfg, "cpu")
    assert type(bundle.module) is native and bundle.name == name
    jbundle = jax_build_model(jcfg, init=False)
    assert jbundle.name == name and type(jbundle.module).__name__ == native.__name__


def test_ptv_mvit_raises_naming_item_17():
    """``PTVMViT`` builds the port's MViT under the PTV name, as ``vtm``
    builds its own, and both give the same fp32 logits from the same weights
    (tiny v2, ``torch_mvit_cases``). The name is the earlier check's:
    ``PTVMViT`` raised naming item 17 until MViT was ported."""
    from torch_mvit_cases import V2, Case

    case = Case(*V2, "MODEL.MODEL_NAME", "PTVMViT")
    assert type(case.module) is MViTModel and case.bundle.name == "PTVMViT" and case.jbundle.name == "PTVMViT"
    x = case.video(2, seed=9)
    assert_close_to_largest(case.port_apply(x, True), case.jax_apply(x, True), LOGIT_TOL, "PTVMViT logits")


@pytest.mark.parametrize("name", ["csn", "r2plus1d"])
def test_detection_raises_like_vtm(name):
    cfg, jcfg = cfgs(ptv_opts(name, "DETECTION.ENABLE", "True"))
    with pytest.raises(NotImplementedError, match=f"not supported for {NAMES[name]}"):
        jax_build_model(jcfg, init=False)
    with pytest.raises(NotImplementedError, match=f"not supported for {NAMES[name]}"):
        build_model(cfg, "cpu")


def test_short_cycle_crop_below_the_head_pool(cases):
    """R(2+1)D's head pools (T // 4, crop // 32, crop // 32) of
    ``DATA.TRAIN_CROP_SIZE``. A short-cycle crop of half of it leaves a map
    smaller than that: ``vtm`` returns logits with no entries (its training
    loss is then NaN), the port raises a ValueError that says why. A crop
    the pool fits (48: a 2 x 2 map, pool 1) gives the four positions' logits
    in both (train mode, the shipped init, as ``test_forward_matches_vtm``)."""
    case = _case(cases, "r2plus1d", "MULTIGRID.SHORT_CYCLE", "True", "DATA.TRAIN_CROP_SIZE", "64")
    x = case.video(2, seed=5, crop=32)
    logits, _ = case.jax_apply(x, True)
    assert logits.shape == (2, 0)
    module = case.bundle.module.train()
    try:
        with pytest.raises(ValueError, match="smaller than the one the head was built for"):
            module(torch.from_numpy(x))
    finally:
        module.eval()
    fit = _case(cases, "r2plus1d", "DATA.TRAIN_CROP_SIZE", "48", "RESNET.ZERO_INIT_FINAL_BN", "True",
                move_weights=False)
    x = case.video(2, seed=6, crop=48)
    want, _ = fit.jax_apply(x, True)
    module = fit.bundle.module.train()
    try:
        with torch.no_grad():
            got, _ = module(torch.from_numpy(x))
    finally:
        module.load_state_dict({k: torch.from_numpy(v) for k, v in fit.state.items()})
        module.eval()
    assert got.shape == want.shape == (2, 4 * 7)
    assert_close_to_largest(got.numpy(), want, LOGIT_TOL, "crop 48")
