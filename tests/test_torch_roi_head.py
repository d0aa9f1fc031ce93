"""The port's AVA ROI head (``vtm_torch/models/roi_head.py``) against
``vtm``'s on the CPU: ``roi_align`` (aligned and not, maps that are not
square, boxes past every edge and inside one cell, mixed batch indices,
resolutions 7 and 2) within ROI_TOL, its gradients against ``jax.grad``
within GRAD_TOL, and ``ResNetRoIHead`` with ``vtm``'s weights carried
across (eval with the sigmoid and the softmax, train at dropout 0, two
pathways) within HEAD_TOL. Inputs are drawn from numpy seeds. A few
seconds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtm.models.roi_head import ResNetRoIHead as JaxRoIHead
from vtm.models.roi_head import roi_align as jax_roi_align

from vtm_torch.models.roi_head import ResNetRoIHead, roi_align

from torch_ava_cases import boxes_for

torch.set_num_threads(2)

ROI_TOL = 1e-6  # fp32, of values about 1
GRAD_TOL = 1e-5
HEAD_TOL = 1e-5


def _edge_boxes(b: int, h: int, w: int, scale: float) -> np.ndarray:
    """Boxes in input pixels (a feature pixel is 1 / scale of them): past
    each of the four edges and past all of them, inside one feature cell,
    a point, and one that is inverted (x2 < x1)."""
    s = 1.0 / scale
    rows = [
        (0, -5 * s, 1 * s, 2 * s, 3 * s),  # past the left edge
        (1, (w - 2) * s, 1 * s, (w + 4) * s, 2 * s),  # past the right edge
        (0, 1 * s, -6 * s, 3 * s, 1 * s),  # past the top
        (b - 1, 2 * s, (h - 1) * s, 4 * s, (h + 3) * s),  # past the bottom
        (1, -9 * s, -9 * s, (w + 9) * s, (h + 9) * s),  # past every edge
        (0, 2.2 * s, 1.3 * s, 2.7 * s, 1.8 * s),  # inside one cell
        (b - 1, 3.5 * s, 2.5 * s, 3.5 * s, 2.5 * s),  # a point
        (1, 4.0 * s, 3.0 * s, 1.0 * s, 1.0 * s),  # inverted
        (1.7, 1 * s, 1 * s, 3 * s, 3 * s),  # a batch index truncated to 1
    ]
    return np.asarray(rows, np.float32)


def _case(seed: int, b: int = 3, h: int = 5, w: int = 9, c: int = 4, scale: float = 1 / 16):
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((b, h, w, c)).astype(np.float32)
    boxes = np.concatenate([_edge_boxes(b, h, w, scale), boxes_for(b, 10, h / scale, w / scale, seed)])
    return feat, boxes


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("resolution", [7, 2])
@pytest.mark.parametrize("hw", [(5, 9), (9, 5), (6, 6)])
def test_roi_align_matches_vtm(aligned, resolution, hw):
    feat, boxes = _case(resolution + hw[0], h=hw[0], w=hw[1])
    want = np.asarray(jax_roi_align(jnp.asarray(feat), jnp.asarray(boxes), resolution, 1 / 16, aligned=aligned))
    got = roi_align(torch.from_numpy(feat), torch.from_numpy(boxes), resolution, 1 / 16, aligned=aligned)
    assert got.shape == want.shape == (len(boxes), resolution, resolution, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ROI_TOL)


def test_roi_align_reads_the_edge_past_the_map():
    """A box wholly past the right edge reads the last column (clamped, not
    zeroed): both bins of a row hold the same value, within that column's
    range; a box inside one cell of a constant map gives the constant."""
    feat = torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(2, 3, 4, 1) + 1.0
    out = roi_align(feat, torch.tensor([[1.0, 10.0, 0.0, 12.0, 2.0]]), 2, 1.0)[0, :, :, 0]
    column = feat[1, :, 3, 0]
    assert torch.equal(out[:, 0], out[:, 1]) and bool(((out >= column.min()) & (out <= column.max())).all())
    const = torch.full((1, 4, 4, 3), 5.0)
    out = roi_align(const, torch.tensor([[0.0, 1.2, 1.3, 1.4, 1.5]]), 3, 1.0)
    np.testing.assert_allclose(out.numpy(), 5.0, rtol=1e-6)


@pytest.mark.parametrize("aligned", [True, False])
def test_roi_align_gradients_match_jax_grad(aligned):
    """The gradients of a weighted sum of the ROI features with respect to
    the map and to the box coordinates, against ``jax.grad`` of ``vtm``'s.
    The coordinates' of the drawn boxes only: the edge cases put sample
    points on integers, where a weight sits on its clip bound, and there
    ``jnp.clip`` passes half the gradient and ``torch.clamp`` all of it."""
    feat, boxes = _case(11, h=5, w=7)
    weights = np.random.default_rng(12).standard_normal((len(boxes), 7, 7, 4)).astype(np.float32)

    def jloss(f, coords):
        b = jnp.concatenate([jnp.asarray(boxes[:, :1]), coords], axis=1)
        return (jax_roi_align(f, b, 7, 1 / 16, aligned=aligned) * weights).sum()

    want_f, want_c = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(feat), jnp.asarray(boxes[:, 1:]))
    f = torch.from_numpy(feat).requires_grad_()
    coords = torch.from_numpy(boxes[:, 1:]).requires_grad_()
    b = torch.cat([torch.from_numpy(boxes[:, :1]), coords], dim=1)
    (roi_align(f, b, 7, 1 / 16, aligned=aligned) * torch.from_numpy(weights)).sum().backward()
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(want_f), rtol=0, atol=GRAD_TOL)
    drawn = slice(len(_edge_boxes(3, 5, 7, 1 / 16)), None)
    want_c = np.asarray(want_c)[drawn]
    scale = max(float(np.abs(want_c).max()), 1.0)
    np.testing.assert_allclose(coords.grad.numpy()[drawn], want_c, rtol=0, atol=GRAD_TOL * scale)


def _head_inputs(seed: int, dims=(12, 3), t=(2, 8), h: int = 4, w: int = 6):
    rng = np.random.default_rng(seed)
    paths = [rng.standard_normal((3, tt, h, w, c)).astype(np.float32) for tt, c in zip(t, dims)]
    boxes = boxes_for(3, 7, h * 16, w * 16, seed)
    return paths, boxes


@pytest.mark.parametrize("act, train", [("sigmoid", False), ("softmax", False), ("sigmoid", True)])
def test_head_matches_vtm(act, train):
    """Two pathways (SlowFast's), resolution 7 and 2 per pathway's scale 16
    and 8: ``vtm``'s head initialised, its projection carried into the
    port's; the port's maps in [B, C, T, H, W] channels_last_3d memory.
    Eval: the activation of each box's row; train at dropout 0: the logits."""
    paths, boxes = _head_inputs(3)
    jhead = JaxRoIHead(num_classes=5, resolution=(7, 2), scale_factor=(16, 8), dropout_rate=0.0, act_func=act,
                       aligned=True)
    variables = jhead.init(jax.random.key(0), [jnp.asarray(p) for p in paths], jnp.asarray(boxes))
    want = np.asarray(jhead.apply(variables, [jnp.asarray(p) for p in paths], jnp.asarray(boxes), train=train))
    head = ResNetRoIHead((12, 3), 5, (7, 2), (16, 8), dropout_rate=0.0, act_func=act, aligned=True)
    proj = variables["params"]["projection"]
    with torch.no_grad():
        head.projection.weight.copy_(torch.from_numpy(np.asarray(proj["kernel"]).T.copy()))
        head.projection.bias.copy_(torch.from_numpy(np.array(proj["bias"])))
    head.train(train)
    xs = [torch.from_numpy(p).permute(0, 4, 1, 2, 3).contiguous(memory_format=torch.channels_last_3d) for p in paths]
    got = head(xs, torch.from_numpy(boxes))
    assert got.shape == (7, 5) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=HEAD_TOL)
    if act == "softmax":
        np.testing.assert_allclose(got.detach().sum(dim=1).numpy(), 1.0, rtol=1e-6)


def test_head_dropout_draws_from_the_generator_and_detach_stops_the_gradient():
    """Train mode at dropout 0.5: the same generator seed the same rows,
    another seed others; ``detach_final_fc`` leaves the maps no gradient."""
    paths, boxes = _head_inputs(5)
    xs = [torch.from_numpy(p).permute(0, 4, 1, 2, 3) for p in paths]
    head = ResNetRoIHead((12, 3), 5, (7, 7), (16, 16), dropout_rate=0.5).train()
    run = [head(xs, torch.from_numpy(boxes), torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    assert torch.equal(run[0], run[1]) and not torch.equal(run[0], run[2])
    leaf = xs[0].clone().requires_grad_()
    ResNetRoIHead((12, 3), 5, (7, 7), (16, 16), detach_final_fc=True).train()([leaf, xs[1]],
                                                                              torch.from_numpy(boxes)).sum().backward()
    assert leaf.grad is None


def test_no_boxes_gives_no_rows():
    paths, _ = _head_inputs(6)
    head = ResNetRoIHead((12, 3), 5, (7, 7), (16, 16)).eval()
    out = head([torch.from_numpy(p).permute(0, 4, 1, 2, 3) for p in paths], torch.zeros(0, 5))
    assert out.shape == (0, 5)
