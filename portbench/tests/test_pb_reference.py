"""The plain float32 references against vtm_torch on the CPU (the port's
plain paths) at tiny widths, from the same weights."""

import math

import pytest
import torch

from portbench.core.check import worst_leaf_gap
from portbench.core.inputs import make_params, make_videos
from portbench.reference import motionformer as rm
from portbench.reference import videomae as rv
from portbench.tests import tiny
from vtm_torch.merge.policy import MergePolicy
from vtm_torch.models.motionformer import Motionformer, MotionformerConfig
from vtm_torch.models.videomae import VideoMAE, VideoMAEConfig

CPU = torch.device("cpu")
VM = dict(tiny.VIDEOMAE, depth=3, embed_dim=64, num_heads=2)
MF = dict(tiny.MOTIONFORMER, depth=3)


def policy(r, prop_attn):
    return MergePolicy(rs=(r,) * 3, mode="merge" if r else "none", prop_attn=prop_attn)


def clips(m, batch, seed=7):
    return make_videos(1, batch, m["num_frames"], m["img_size"], tiny.VIDEO, seed, CPU)[0]


def motionformer_port(p, r):
    config = MotionformerConfig(img_size=64, patch_size=16, patch_size_temp=2, num_classes=10, embed_dim=64,
                                depth=3, num_heads=2, temporal_resolution=2, use_mlp=True)
    port = Motionformer(config, policy=policy(r, True), fp32_params=True)
    port.load_state_dict(p, strict=True)
    return port


@pytest.mark.parametrize("r", [0, 4])
def test_videomae_logits_match_the_port(r):
    p = make_params(rv.param_specs(VM), 1, CPU)
    port = VideoMAE(VideoMAEConfig(**{k: VM[k] for k in VideoMAEConfig.__dataclass_fields__ if k in VM}),
                    policy=policy(r, False)).eval()
    port.load_state_dict(p, strict=True)
    video = clips(VM, 3)
    with torch.no_grad():
        got, _ = port(video)
    want, gap = rv.logits(p, video, VM, r, rows=2)
    assert gap == 0.0
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-5 * want.abs().max())


@pytest.mark.parametrize("r", [0, 3])
def test_motionformer_step_matches_the_port(r):
    p = make_params(rm.param_specs(MF), 2, CPU)
    port = motionformer_port(p, r).train()
    video, labels = clips(MF, 3), torch.tensor([1, 5, 9])
    loss = torch.nn.functional.cross_entropy(port(video)[0], labels)
    loss.backward()
    ref_loss, grads, _ = rm.loss_and_grads(p, video, labels, MF, r, rows=2)
    assert abs(loss.item() - ref_loss) < 1e-6 * ref_loss
    norms = rm.leaf_norms({k: q.grad for k, q in port.named_parameters()})
    assert worst_leaf_gap(norms, rm.leaf_norms(grads))[0] < 1e-4


def test_adamw_matches_torch_optim():
    p = make_params(rm.param_specs(MF), 3, CPU)
    ours = {k: t.clone() for k, t in p.items()}
    theirs = {k: t.clone().requires_grad_(True) for k, t in p.items()}
    decay = [t for k, t in theirs.items() if not any(n in k for n in rm.NO_DECAY)]
    keep = [t for k, t in theirs.items() if any(n in k for n in rm.NO_DECAY)]
    opt = torch.optim.AdamW([{"params": decay, "weight_decay": 0.05}, {"params": keep, "weight_decay": 0.0}],
                            lr=1e-4, eps=1e-8)
    mine = rm.AdamW(ours, lr=1e-4, wd=0.05)
    g = torch.Generator().manual_seed(0)
    for _ in range(3):
        grads = {k: torch.randn(t.shape, generator=g) * 1e-3 for k, t in p.items()}
        for k, t in theirs.items():
            t.grad = grads[k].clone()
        opt.step()
        mine.step(ours, grads)
    # the same arithmetic up to the order of its fp32 operations
    assert all(torch.allclose(ours[k], theirs[k].detach(), rtol=1e-6, atol=1e-8) for k in p)


def test_following_recorded_decisions_gives_the_same_logits_and_no_gap():
    p = make_params(rv.param_specs(VM), 4, CPU)
    video = clips(VM, 4)
    record = []
    own, _ = rv.logits(p, video, VM, 4, rows=4, record=record)
    assert len(record) == VM["depth"] and record[0][0].shape[0] == 4
    followed, gap = rv.logits(p, video, VM, 4, rows=2, calls=record)
    assert gap == 0.0 and torch.allclose(own, followed, rtol=1e-5, atol=1e-6)  # blocks of 2 against 4


def test_the_decision_gap_sees_a_wrong_merge():
    p = make_params(rv.param_specs(VM), 4, CPU)
    video = clips(VM, 2)
    record = []
    rv.logits(p, video, VM, 4, record=record)
    kept, src, dst = record[1]
    record[1] = (kept, src, (dst + 1) % (int(dst.max()) + 1))
    _, gap = rv.logits(p, video, VM, 4, calls=record)
    assert gap > 0.01


@pytest.mark.parametrize("fault", ["one_more_merged", "merge_left_out", "call_left_over", "not_a_partition",
                                   "too_few_rows", "no_calls"])
def test_decisions_outside_the_reference_schedule_read_an_infinite_gap(fault):
    p = make_params(rv.param_specs(VM), 4, CPU)
    video = clips(VM, 2)
    record = []
    rv.logits(p, video, VM, 4, record=record)
    kept, src, dst = record[1]
    if fault == "one_more_merged":
        record[1] = (kept[:, 1:], torch.cat([src, kept[:, :1]], 1), torch.cat([dst, dst[:, :1]], 1))
    elif fault == "merge_left_out":
        del record[1]
    elif fault == "call_left_over":
        record.append(record[-1])
    elif fault == "not_a_partition":
        record[1] = (kept, torch.cat([src[:, :-1], kept[:, :1]], 1), dst)
    elif fault == "too_few_rows":
        record[1] = (kept[:1], src[:1], dst[:1])
    else:
        record.clear()
    _, gap = rv.logits(p, video, VM, 4, calls=record)
    assert gap == math.inf


def test_the_program_decisions_are_kept_as_the_reference_takes_them():
    from portbench.core import decisions

    p = make_params(rv.param_specs(VM), 5, CPU)
    port = VideoMAE(VideoMAEConfig(**{k: VM[k] for k in VideoMAEConfig.__dataclass_fields__ if k in VM}),
                    policy=policy(4, False)).eval()
    port.load_state_dict(p, strict=True)
    video = clips(VM, 3)
    recorder = decisions.Recorder()
    undo = recorder.install()
    try:
        recorder.sink = calls = []
        with torch.no_grad():
            got, _ = port(video)
    finally:
        undo()
    want, gap = rv.logits(p, video, VM, 4, rows=2, calls=calls)
    assert len(calls) == VM["depth"] and gap < 1e-5
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-5 * want.abs().max())
