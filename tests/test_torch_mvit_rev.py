"""The port's reversible MViT (``vtm_torch/models/mvit_rev.py``) against
``vtm/models/mvit_rev.py`` on the CPU, tiny (``torch_mvit_cases``: embed 16,
2 heads, depth 5, transitions at layers 1 and 3): the four configs of
``tests/test_mvit_rev.py`` and a ``concat_linear`` pre-q fusion in fp32,
every ``TwoStreamFusion`` mode, the reversible backward's gradients against
``vtm``'s custom VJP at rate 0, and, the contract of
``tests/test_mvit_rev.py:134-226``, against the port's own plain autograd
on the same masks at drop path 0.2. About 30 s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtm.models.mvit_rev import TwoStreamFusion as JaxTwoStreamFusion

from vtm_torch.checkpoints.convert import mvit_state_dict_from_vtm_params
from vtm_torch.models import mvit_rev
from vtm_torch.models.mvit_rev import TwoStreamFusion

from torch_conv_cases import assert_close_to_largest
from torch_mvit_cases import LOGIT_TOL, REV_STYLES, Case, grad_errors

torch.set_num_threads(2)

# fp32 gradients of the reversible backward, of each tensor's largest entry:
# against vtm's custom VJP (both reconstruct the activations; measured
# 2.7e-6 at most) and against the port's plain autograd, which keeps them
# (X = Y - F(.) over a segment of one or two layers here loses low bits of
# the activations; measured 1.5e-6 at most over the four configs).
REV_GRAD_TOL = 2e-5
CONFIGS = dict(REV_STYLES, preq_concat_linear=REV_STYLES["conv_respath"] + (
    "MVIT.REV.PRE_Q_FUSION", "concat_linear_2.0", "MVIT.REV.RESPATH_FUSE", "ln+concat_linear"))


@pytest.fixture(scope="module")
def cases():
    return {}


def _case(cases, name, *extra):
    key = (name,) + extra
    if key not in cases:
        cases[key] = Case(*CONFIGS[name], *extra, fp32_params=True)
    return cases[key]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_vtm(name, cases):
    """fp32, every rate 0: train-mode logits within LOGIT_TOL of ``vtm``'s,
    and the eval probabilities of their softmax (the max residual path,
    which the upstream fork cannot run, against ``vtm``'s reading of it)."""
    case = _case(cases, name)
    x = case.video(2, seed=1)
    want = case.jax_apply(x, True)
    assert_close_to_largest(case.port_apply(x, True), want, LOGIT_TOL, f"{name} logits")
    probs = np.exp(want - want.max(axis=1, keepdims=True))
    assert_close_to_largest(case.port_apply(x, False), probs / probs.sum(axis=1, keepdims=True), LOGIT_TOL, name)


MODES = ["add", "max", "min", "avg", "concat", "concat_linear", "concat_linear_2.0", "concat_linear_0.5_0.3",
         "ln+concat_linear", "ln+concat_linear_2.0"]


@pytest.mark.parametrize("mode", MODES)
def test_two_stream_fusion_matches_vtm(mode):
    """Each mode on a bf16 two-stream tensor [2, 5, 2 x 8] (the MLP of the
    ``concat_linear`` modes in fp32, as in ``vtm``), eval mode, the port's
    seeded weights given to ``vtm``; and a ``concat_linear`` dropout rate
    raises inside the reversible stack's pre-q fusion, as in ``vtm``."""
    torch.manual_seed(0)
    port = TwoStreamFusion(mode, dim=16).eval()
    for p in port.parameters():
        torch.nn.init.normal_(p, std=0.3)
    x = torch.randn(2, 5, 16).to(torch.bfloat16)
    with torch.no_grad():
        got = port(x)
    params = {}
    sd = {k: v.detach().numpy() for k, v in port.state_dict().items()}
    if sd:
        pre = "fuse_fn.1" if mode.startswith("ln+") else "fuse_fn"
        params["mlp"] = {f: {"kernel": sd[f"{pre}.{f}.weight"].T, "bias": sd[f"{pre}.{f}.bias"]} for f in ("fc1", "fc2")}
        if mode.startswith("ln+"):
            params["ln"] = {"scale": sd["fuse_fn.0.weight"], "bias": sd["fuse_fn.0.bias"]}
    want = JaxTwoStreamFusion(mode, dim=16).apply({"params": params}, jnp.asarray(x.float().numpy(), jnp.bfloat16))
    assert str(want.dtype) == {torch.bfloat16: "bfloat16", torch.float32: "float32"}[got.dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=0, atol=1e-6)
    assert got.shape[-1] == port.out_dim(16)
    if mode == "concat_linear_0.5_0.3":
        with pytest.raises(NotImplementedError, match="PRE_Q_FUSION dropout"):
            Case(*CONFIGS["conv_respath"], "MVIT.REV.PRE_Q_FUSION", mode)


def _port_step(module, x, generator=None):
    """Loss (mean of the squared train-mode logits) and every gradient."""
    module.train().zero_grad(set_to_none=True)
    logits, _ = module(x, generator=generator)
    loss = logits.square().mean()
    loss.backward()
    out = loss.detach(), {k: p.grad.numpy().copy() for k, p in module.named_parameters()}
    module.eval().zero_grad(set_to_none=True)
    return out


def test_rev_backward_matches_vtm_custom_vjp(cases, monkeypatch):
    """Rate 0, fp32: the loss and every parameter's gradient through the
    port's reversible backward (``_RevSegment``, which must run) against
    ``jax.value_and_grad`` through ``vtm``'s custom VJP, within
    REV_GRAD_TOL (the k pool's LayerNorm bias, zero analytically, as
    noise)."""
    case = _case(cases, "conv_respath")
    x = case.video(2, seed=2)
    runs = []
    real = mvit_rev._RevSegment.apply
    monkeypatch.setattr(mvit_rev._RevSegment, "apply", lambda *a: runs.append(1) or real(*a))
    loss, grads = _port_step(case.module, torch.from_numpy(x))
    assert len(runs) == 3  # three reversible segments: layers 0, 2 and 4
    module = case.jbundle.module

    def jax_loss(p):
        logits, _ = module.apply({"params": p}, jnp.asarray(x), train=True)
        return jnp.mean(logits ** 2)

    want_loss, want = jax.jit(jax.value_and_grad(jax_loss))(case.params)
    want = {k: v.numpy() for k, v in mvit_state_dict_from_vtm_params(jax.tree_util.tree_map(np.asarray, want)).items()}
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    errs = grad_errors(grads, want)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= REV_GRAD_TOL, (worst, errs[worst])


@pytest.mark.parametrize("name", sorted(REV_STYLES))
def test_rev_backward_matches_plain_autograd_with_drop_path(name, cases):
    """Drop path 0.2 (the masks drawn once from one generator, shared by F,
    G and the recomputation): the loss bit for bit and every gradient within
    REV_GRAD_TOL of the same step under plain autograd
    (``use_rev_backward = False``); the masks drop something (the loss is
    not the rate-0 loss)."""
    case = _case(cases, name, "MVIT.DROPPATH_RATE", "0.2")
    module, x = case.module, torch.from_numpy(case.video(4, seed=3))
    got_loss, got = _port_step(module, x, torch.Generator().manual_seed(11))
    module.rev_backbone.use_rev_backward = False
    try:
        want_loss, want = _port_step(module, x, torch.Generator().manual_seed(11))
    finally:
        module.rev_backbone.use_rev_backward = True
    assert torch.equal(got_loss, want_loss)
    errs = grad_errors(got, want)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= REV_GRAD_TOL, (worst, errs[worst])
    no_drop = _case(cases, name)
    assert float(_port_step(no_drop.module, x)[0]) != float(got_loss)
