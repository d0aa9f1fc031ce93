"""The contrastive family's SSL MLP head (``convnet.MLPHead``) in the port
against ``vtm``'s on the CPU: with its BatchNorms and predictors on a
ResNet and on MViT, in eval and in train mode (outputs and statistics, fp32
within ``TOL`` of the largest entry; ``tests/torch_contrastive_cases.py``),
its initialisers, and upstream's SSL head names."""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vtm_torch.models.contrastive as tc
from vtm.checkpoints.convert import convert_pyslowfast
from vtm_torch.checkpoints.convert import load_mvit_state_dict, load_pyslowfast_state_dict
from vtm_torch.models.convnet import MLPHead

from torch_contrastive_cases import (
    TOL,
    Case,
    assert_state_matches,
    contrastive_state_dict_from_vtm,
    rel_err,
    vtm_bn_over_all_but_channels,
)

torch.set_num_threads(2)

INDEX = np.array([0, 3, 5, 7])
HEAD = ("CONTRASTIVE.NUM_MLP_LAYERS", "3", "CONTRASTIVE.BN_MLP", "True", "CONTRASTIVE.PREDICTOR_DEPTHS", "[2, 3]")


def _backbone_outputs(case: Case, x: np.ndarray, train: bool):
    """The backbone's [projection, *predictions] in both packages, and in
    train mode ``vtm``'s statistics after it as the port's state dict."""
    module = case.jbundle.module
    variables = {"params": case.params, **({"batch_stats": case.stats} if case.stats else {})}
    with vtm_bn_over_all_but_channels():
        if train:
            (want, _), mutated = jax.jit(lambda v, x: module.apply(v, x, train=True, mutable=["batch_stats"]))(
                variables, jnp.asarray(x))
            stats = mutated.get("batch_stats")
            sd = contrastive_state_dict_from_vtm(case.params, stats and jax.tree_util.tree_map(np.asarray, stats), {})
        else:
            want, sd = jax.jit(lambda v, x: module.apply(v, x)[0])(variables, jnp.asarray(x)), None
    backbone = case.model.backbone.train(train)
    with torch.no_grad():
        got = backbone(torch.from_numpy(x))[0]
    listed = isinstance(got, (list, tuple))
    assert listed == isinstance(want, (list, tuple))
    return ([g.numpy() for g in got] if listed else [got.numpy()]), [np.asarray(w) for w in
                                                                      (want if listed else [want])], sd


@pytest.mark.parametrize("crop", [32, 64])
@pytest.mark.parametrize("train", [False, True])
def test_resnet_mlp_head_with_predictors_matches_vtm(train, crop):
    """Three layers with BatchNorms and two predictors (depths 2, 3) over a
    Slow ResNet: the projection (eval: its softmax) and the predictions;
    at crop 64 the pooled map is 1 x 2 x 2, which the MLP takes as it is;
    in train mode every BatchNorm statistic after the forward."""
    case = Case("byol", *HEAD)
    x = case.clips(1, 4, 3)[0][0]
    if crop == 64:
        x = np.repeat(np.repeat(x, 2, axis=2), 2, axis=3)
    got, want, sd = _backbone_outputs(case, x, train)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert rel_err(g, w) <= TOL
    if train:
        assert_state_matches(case.model, sd, names=[k for k in sd if "running" in k])
        assert any("head.predictors.1.bn2" in k for k in sd)
    if not train:
        assert np.allclose(got[0].sum(axis=1), 1.0, atol=1e-5)  # the eval head's softmax


@pytest.mark.parametrize("bn", [False, True])
def test_mvit_mlp_head_matches_vtm(bn):
    """MViT's ``head.projection`` as an MLP (vtm's ``_mvit_head``): logits in
    train mode, probabilities in eval mode; its BatchNorms' statistics."""
    case = Case("simclr", "CONTRASTIVE.BN_MLP", str(bn), arch="mvit")
    assert isinstance(case.model.backbone.head.projection, MLPHead)
    x = case.clips(1, 4, 4)[0][0]
    for train in (False, True):  # eval first: the train forward moves the port's statistics
        (got,), (want,), sd = _backbone_outputs(case, x, train)
        assert rel_err(got, want) <= TOL
        if train and bn:
            assert_state_matches(case.model, sd, names=[k for k in sd if "running" in k])


def test_mlp_heads_take_flax_dense_init():
    """The MLP layers keep flax's Dense default, lecun-normal (a deviation
    of 1 / sqrt(fan-in) after the cut at two) with zero biases; a linear
    projection keeps normal(FC_INIT_STD); the BatchNorms start at 1 and 0."""
    cfg = Case("byol", *HEAD, "CONTRASTIVE.MLP_DIM", "256").cfg
    model, _ = tc.build_contrastive_model(cfg, "cpu")
    head = model.backbone.head
    for name, layer in [("fc0", head.projection.fc0), ("fc1", head.projection.fc1), ("p.fc0", head.predictors[0].fc0)]:
        w = layer.weight.detach()
        std = float(w.std())
        assert abs(std - 1 / math.sqrt(w.shape[1])) < 0.1 / math.sqrt(w.shape[1]), (name, std)
        assert float(w.abs().max()) <= 2 / 0.87962566103423978 / math.sqrt(w.shape[1]) + 1e-6, name
    assert head.projection.fc0.bias is None and not head.projection.fc2.bias.any()
    assert bool((head.projection.bn1.weight == 1).all()) and not head.projection.bn1.bias.any()
    plain = tc.build_contrastive_model(Case("moco", "CONTRASTIVE.NUM_MLP_LAYERS", "1").cfg, "cpu")[0]
    assert abs(float(plain.backbone.head.projection.weight.detach().std()) - cfg.MODEL.FC_INIT_STD) < 3e-3


def test_upstream_ssl_head_names_load():
    """Upstream's Sequential names (``head.projection.projection.{i}``,
    ``head.predictors.{j}.projection.{i}``, ReLUs holding nothing) load
    under the port's, as ``vtm``'s ``convert_pyslowfast`` renames them: the
    same weights land on the same layers in both."""
    case = Case("byol", *HEAD)
    ours = {k: v.numpy() for k, v in case.model.backbone.state_dict().items()}
    upstream = {}
    for k, v in ours.items():
        for base in ("head.projection.", "head.predictors.0.", "head.predictors.1."):
            if k.startswith(base) and k[len(base):].startswith(("fc", "bn")):
                layer, leaf = k[len(base):].split(".", 1)
                idx = 3 * int(layer[2:]) if layer.startswith("fc") else 3 * int(layer[2:]) - 2
                k = f"{base}projection.{idx}.{leaf}"
                break
        upstream[k] = v
    loaded = load_pyslowfast_state_dict({"module." + k: v for k, v in upstream.items()})
    assert set(loaded) == set(ours)
    for k, v in ours.items():
        assert np.array_equal(loaded[k].numpy(), v), k
    params, stats = convert_pyslowfast(upstream)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, (params, stats), (case.params, case.stats)))
    mvit = Case("simclr", "CONTRASTIVE.BN_MLP", "True", arch="mvit").model.backbone.state_dict()
    renamed = {k.replace("head.projection.fc1", "head.projection.projection.3").replace(
        "head.projection.bn1", "head.projection.projection.1").replace(
        "head.projection.fc0", "head.projection.projection.0"): v for k, v in mvit.items()}
    assert set(load_mvit_state_dict(renamed)) == set(mvit)
