"""Motionformer cut 2 ways for tensor parallelism (``vtm_torch/parallel/sharding.py``)
against ``vtm``'s one-device results, on the CPU over gloo: trajectory
attention with and without proportional attention, with the reference's
``v=x`` temporal values and without them, divided and joint attention, and
the spatial step's approximations in ``test_torch_parallel_tp_motionformer_approx.py``.
Every configuration runs in one launch of two spawned ranks that import no
JAX (``vtm_torch/parallel/probes.py``); this process computes ``vtm``'s
side while they run."""

import pytest
import torch

from torch_parallel_checks import (
    MERGE_POLICY,
    MOTIONFORMER,
    SOLVER,
    TPCase,
    assert_tp_checkpoint,
    assert_tp_eval,
    assert_tp_step,
    cfgs,
    launch_during,
    tp_plan,
)
from vtm_torch.parallel.probes import run_probes

torch.set_num_threads(2)

CONFIGS = {
    "trajectory": ({}, MERGE_POLICY),
    "trajectory_no_prop_attn": ({}, dict(MERGE_POLICY, prop_attn=False)),
    "trajectory_new_code": (dict(use_original_code=False), MERGE_POLICY),
    "divided": (dict(attn_layer="divided"), MERGE_POLICY),
    "joint": (dict(attn_layer="joint"), MERGE_POLICY),
}
# zero analytically, rounding noise in both packages: proj_kv's bias under
# the reference's v=x (its k half shifts a softmax's logits alike, its v half
# is unused) and the last block's trajectory projections (only its CLS row
# reaches the head)
NOISE = {"trajectory": ("attn.proj_kv.bias", "blocks.1.attn.proj_q", "blocks.1.attn.proj_kv")}
NOISE["trajectory_no_prop_attn"] = NOISE["trajectory"]
NOISE["trajectory_new_code"] = ("blocks.1.attn.proj_q", "blocks.1.attn.proj_kv")
# qkv cut by heads in q, k and v, proj_q by heads, proj_kv by heads in k and v
CUTS = {"blocks.0.attn.qkv.weight": (48, 32), "blocks.0.attn.proj_q.weight": (16, 32),
        "blocks.0.attn.proj_q.bias": (16,), "blocks.0.attn.proj_kv.weight": (32, 32),
        "blocks.0.attn.proj.weight": (32, 16), "blocks.0.mlp.fc1.weight": (32, 32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_motionformer")
    cases, plan = {}, []
    for name, (extra, policy) in CONFIGS.items():
        case = TPCase("Motionformer", dict(MOTIONFORMER, **extra), policy)
        cfg, jc = cfgs(*SOLVER, "MODEL.MODEL_NAME", "Motionformer", "TPU.MODEL_PARALLEL", "2",
                       "TRAIN.BATCH_SIZE", "2")
        cases[name] = (case, cfg, jc)
        plan += tp_plan(case, cfg, str(tmp / name))
    ranks, _ = launch_during(cfg, run_probes, tmp, 2, (plan,),
                             lambda: [case.expect(jc) for case, _, jc in cases.values()])
    results = {name: [[r["result"] for r in rank[3 * i:3 * i + 3]] for rank in ranks] for i, name in enumerate(cases)}
    return cases, results


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tp2_eval_matches_vtm(name, runs):
    """Two ranks of one model group: the eval probabilities within
    LOGITS_TOL of ``vtm``'s, the per-pseudo-frame Matchings equal on both
    ranks and to ``vtm``'s (none in divided blocks), the cuts really made,
    and for Performer one projection seed on every rank."""
    cases, results = runs
    assert_tp_eval(results[name], cases[name][0])
    ev = results[name][0][0]
    assert ev["mesh"] == {"data": 1, "model": 2}
    assert len(ev["matchings"]) == (0 if name == "divided" else 2)
    if name.startswith("trajectory"):
        for param, shape in CUTS.items():
            assert ev["cut_shapes"][param] == shape, param


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tp2_step_matches_vtm(name, runs):
    """One AdamW step (layer decay 0.75) as ``vtm``'s: loss, gradients and
    parameters on both ranks (the gradients that are zero analytically
    named, not compared)."""
    cases, results = runs
    assert_tp_step(results[name], cases[name][0], NOISE.get(name, ()),
                   unused=() if name in ("trajectory_new_code", "divided", "joint") else ("attn.proj_kv.weight",))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tp2_checkpoint_reloads_whole(name, runs):
    """The ranks' checkpoint loads back into the cut ranks and whole into
    one process, with the same output."""
    cases, results = runs
    case, cfg, _ = cases[name]
    assert_tp_checkpoint(results[name], case, cfg, NOISE.get(name, ()))
