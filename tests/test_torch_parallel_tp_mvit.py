"""MViT cut 2 ways for tensor parallelism (``vtm_torch/parallel/sharding.py``)
against ``vtm``'s one-device results, on the CPU over gloo: MViTv2 with a
one-head first block (left whole at width 2), relative positions and
residual pooling; ``POOL_FIRST``; ``SEPARATE_QKV``. The reversible MViT,
``MODEL.ACT_CHECKPOINT`` and four ranks: ``test_torch_parallel_tp_mvit_rev.py``.
The configurations run in one launch of two spawned ranks that import no
JAX (``vtm_torch/parallel/probes.py``); this process computes ``vtm``'s
side while they run."""

import pytest
import torch

from torch_mvit_cases import BASE, V2, ZERO_GRADIENTS
from torch_parallel_checks import (
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

# heads 1, 2, 2, 4 by block (MViTv2-S's schedule at depth 4)
ONE_HEAD = ("MVIT.NUM_HEADS", "1")
CONFIGS = {
    "v2": (*ONE_HEAD, *V2),
    "pool_first": ("MVIT.POOL_FIRST", "True"),
    "separate_qkv": ("MVIT.SEPARATE_QKV", "True", *V2),
}
# zero analytically: under POOL_FIRST the k projection's bias (a shift of
# every key's logit of a query alike) and the last block's q pool (the head
# reads the class token, whose query bypasses the pool); the k pool's norm
# bias everywhere (ZERO_GRADIENTS)
NOISE = {"pool_first": ("attn.k.bias", "blocks.3.attn.pool_q")}


def mvit_case(configs: dict, name: str, model_parallel: int, case=None):
    """(TPCase, cfg, vtm's cfg) of ``configs[name]`` at a model width; ``case``:
    a TPCase of the same weights and ``vtm`` model to share."""
    opts = [*SOLVER, *BASE, *configs[name], "TPU.MODEL_PARALLEL", str(model_parallel), "TRAIN.BATCH_SIZE", "2"]
    cfg, jc = cfgs(*opts)
    if case is None:
        # vtm's remat does not trace its shapes: its plain stack, the same values
        plain = [o for i, o in enumerate(opts) if "MODEL.ACT_CHECKPOINT" not in opts[i - 1:i + 1]]
        case = TPCase("MViT", opts=opts, vtm_opts=plain)
    return case, cfg, jc


def mvit_runs(tmp, groups: list) -> list:
    """``tp_plan`` of every case of each group (cases, ranks) in one
    launch of that many ranks, the launches at once, ``vtm``'s side computed
    meanwhile (once a TPCase): for each group {key: each rank's results}."""
    launches, unique = [], {}
    for g, (cases, ranks) in enumerate(groups):
        plan = []
        for key, (case, cfg, jc) in cases.items():
            plan += tp_plan(case, cfg, str(tmp / f"{g}_{key}"))
            unique[id(case)] = (case, jc)
        (tmp / str(g)).mkdir(exist_ok=True)
        launches.append((cfg, run_probes, tmp / str(g), ranks, (plan,)))
    outs, _ = launch_during(*launches[0], lambda: [case.expect(jc) for case, jc in unique.values()],
                            more=launches[1:])
    outs = outs if len(groups) > 1 else [outs]
    return [{key: [[r["result"] for r in rank[3 * i:3 * i + 3]] for rank in out] for i, key in enumerate(cases)}
            for (cases, _), out in zip(groups, outs)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases = {name: mvit_case(CONFIGS, name, 2) for name in CONFIGS}
    return cases, mvit_runs(tmp_path_factory.mktemp("tp_mvit"), [(cases, 2)])[0]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tp2_eval_matches_vtm(name, runs):
    """Two ranks of one model group: the eval probabilities within
    LOGITS_TOL of ``vtm``'s and the cuts really made: block 0's one head
    left whole (the one-head configurations), the block-level ``proj``, the
    pooling convs, their norms
    and the relative positions whole, the MLPs cut."""
    cases, results = runs
    assert_tp_eval(results[name], cases[name][0])
    cut = results[name][0][0]["cut_shapes"]
    assert all(not n.startswith("blocks.0.attn") for n in cut) == ("MVIT.NUM_HEADS" in CONFIGS[name])
    assert "blocks.0.mlp.fc1.weight" in cut
    assert not any(".pool_" in n or ".norm_" in n or ".rel_pos" in n for n in cut)
    assert not any(n.startswith("blocks.") and n.split(".")[2] == "proj" for n in cut)  # the block-level proj
    qkv = [n for n in cut if n.endswith((".q.weight", ".k.weight", ".v.weight", ".qkv.weight"))]
    assert qkv and all((".qkv." in n) == (name == "v2") for n in qkv)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tp2_step_matches_vtm(name, runs):
    """One AdamW step (layer decay 0.75) as ``vtm``'s: loss, gradients (the
    shared pooling and position weights' summed over the model group) and
    parameters on both ranks."""
    cases, results = runs
    assert_tp_step(results[name], cases[name][0], ZERO_GRADIENTS + NOISE.get(name, ()))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tp2_checkpoint_reloads_whole(name, runs):
    """The ranks' checkpoint loads back into the cut ranks and whole into
    one process, with the same output."""
    cases, results = runs
    case, cfg, _ = cases[name]
    assert_tp_checkpoint(results[name], case, cfg, ZERO_GRADIENTS + NOISE.get(name, ()))
