"""The analytic operation counts: equal to FlopCounterMode on the plain
references at tiny widths, and to the port's own count at full width."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.core import spec
from portbench.core.inputs import make_params, make_videos
from portbench.counts import attention, motionformer as cm, videomae as cv
from portbench.reference import motionformer as rm
from portbench.reference import videomae as rv
from portbench.tests import tiny

CPU = torch.device("cpu")


def counted(fn) -> int:
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("r", [0, 4])
def test_videomae_formula_equals_the_counter_on_the_reference(r):
    m = dict(tiny.VIDEOMAE, depth=3)
    p = make_params(rv.param_specs(m), 1, CPU)
    video = make_videos(1, 2, m["num_frames"], m["img_size"], tiny.VIDEO, 1, CPU)[0]
    assert counted(lambda: rv.forward(p, video, m, r)) == 2 * cv.forward_flops(m, r)


@pytest.mark.parametrize("r", [0, 3])
def test_motionformer_formula_equals_the_counter_on_the_reference(r):
    m = dict(tiny.MOTIONFORMER, depth=3)
    p = make_params(rm.param_specs(m), 1, CPU)
    video = make_videos(1, 2, m["num_frames"], m["img_size"], tiny.VIDEO, 1, CPU)[0]
    assert counted(lambda: rm.forward(p, video, m, r)) == 2 * cm.forward_flops(m, r)


def test_videomae_full_width_counts_are_the_ports():
    m = json.loads((spec.ROOT / "configs" / "videomae_b16_k400.json").read_text())["model"]
    assert round(cv.forward_flops(m, 0) / 1e9, 2) == 360.69
    assert round(cv.forward_flops(m, 150) / 1e9, 3) == 149.489


def test_attention_bytes_count_each_tensor_once():
    flops, nbytes = attention.k1(2, 3, 256, 64, bias=True, lse=False)
    assert flops == 4 * 2 * 3 * 256 * 256 * 64
    assert nbytes == 4 * 2 * 3 * 256 * 64 * 2 + 2 * 256 * 4
    f3, b3 = attention.k3(2, 3, 256, 64, 8, bias=False, lse=True)
    assert f3 == flops and b3 == 3 * 2 * 3 * 256 * 64 * 2 + 2 * 256 * 8 * 3 * 64 * 2 + 2 * 3 * 8 * 256 * 4
    f4, _ = attention.k4(2, 3, 256, 64, 8, bias=True, dbias=True)
    assert f4 == 10 * 2 * 3 * 256 * 256 * 64
