"""TimeSformer cut 2 ways for tensor parallelism (``vtm_torch/parallel/sharding.py``)
against ``vtm``'s one-device results, on the CPU over gloo: the divided
space-time blocks (merged, proportional attention) and the space-only
ones. Every configuration runs in one launch of two spawned ranks that
import no JAX (``vtm_torch/parallel/probes.py``); this process computes
``vtm``'s side."""

import numpy as np
import pytest
import torch

from torch_parallel_checks import (
    MERGE_POLICY,
    SOLVER,
    TIMESFORMER,
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

CONFIGS = {"divided_space_time": MERGE_POLICY, "space_only": dict(rs=(0, 0), mode="none")}
# qkv cut by heads in q, k and v, proj and fc2 by input columns; temporal_fc whole
CUTS = {"blocks.0.attn.qkv.weight": (48, 32), "blocks.0.attn.qkv.bias": (48,),
        "blocks.0.temporal_attn.qkv.weight": (48, 32), "blocks.0.temporal_attn.proj.weight": (32, 16),
        "blocks.0.attn.proj.weight": (32, 16), "blocks.0.mlp.fc1.weight": (32, 32),
        "blocks.0.mlp.fc2.weight": (32, 32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_timesformer")
    cases, plan = {}, []
    for name, policy in CONFIGS.items():
        case = TPCase("TimeSformer", dict(TIMESFORMER, attention_type=name), policy)
        cfg, jc = cfgs(*SOLVER, "MODEL.MODEL_NAME", "TimeSformer", "TPU.MODEL_PARALLEL", "2", "TRAIN.BATCH_SIZE", "2")
        cases[name] = (case, cfg, jc)
        plan += tp_plan(case, cfg, str(tmp / name))
    ranks, _ = launch_during(cfg, run_probes, tmp, 2, (plan,),
                             lambda: [case.expect(jc) for case, _, jc in cases.values()])
    results = {name: [[r["result"] for r in rank[3 * i:3 * i + 3]] for rank in ranks] for i, name in enumerate(cases)}
    return cases, results


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tp2_eval_matches_vtm(name, runs):
    """Two ranks of one model group: the eval logits within LOGITS_TOL of
    ``vtm``'s, the per-frame Matchings equal on both ranks and to ``vtm``'s,
    the cuts really made (``temporal_fc`` whole, as in ``vtm``)."""
    cases, results = runs
    assert_tp_eval(results[name], cases[name][0])
    ev = results[name][0][0]
    assert ev["mesh"] == {"data": 1, "model": 2}
    if name == "divided_space_time":
        assert len(ev["matchings"]) == 2
        for param, shape in CUTS.items():
            assert ev["cut_shapes"][param] == shape, param
        assert "blocks.0.temporal_fc.weight" not in ev["cut_shapes"]
    else:
        assert ev["matchings"] == [] and "blocks.0.temporal_attn.qkv.weight" not in ev["cut_shapes"]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tp2_step_matches_vtm(name, runs):
    """One AdamW step (layer decay 0.75) as ``vtm``'s: loss, gradients and
    parameters on both ranks."""
    cases, results = runs
    assert_tp_step(results[name], cases[name][0])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tp2_checkpoint_reloads_whole(name, runs):
    """The ranks' checkpoint loads back into the cut ranks and whole into
    one process, with the same output."""
    cases, results = runs
    case, cfg, _ = cases[name]
    assert_tp_checkpoint(results[name], case, cfg)
