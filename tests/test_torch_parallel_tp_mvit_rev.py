"""The reversible MViT and ``MODEL.ACT_CHECKPOINT`` cut 2 ways for tensor
parallelism (``vtm_torch/parallel/sharding.py``), and MViTv2 on four ranks,
as 2 x 2 (block 0's one head whole) and as one model group of 4 (blocks 0-2
whole), against ``vtm``'s one-device results on the CPU over gloo: the
reversible backward and the checkpointed stack re-run the forward's
collectives in the forward's order on every rank. The checkpointed and
four-rank runs share one ``vtm`` model (``vtm``'s plain stack: its
``remat`` does not trace these shapes, and changes no value). Spawned ranks
import no JAX (``vtm_torch/parallel/probes.py``); this process computes
``vtm``'s side while they run."""

import pytest
import torch

from test_torch_parallel_tp_mvit import ONE_HEAD, mvit_case, mvit_runs
from torch_mvit_cases import REV, V2, ZERO_GRADIENTS
from torch_parallel_checks import assert_tp_checkpoint, assert_tp_eval, assert_tp_step

torch.set_num_threads(2)

CONFIGS = {
    "rev": (*REV, *ONE_HEAD),
    "act_checkpoint": (*ONE_HEAD, *V2, "MODEL.ACT_CHECKPOINT", "True"),
    "v2": (*ONE_HEAD, *V2),
}
WIDTHS = {"2x2": 2, "1x4": 4}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases = {name: mvit_case(CONFIGS, name, 2) for name in ("rev", "act_checkpoint")}
    shared = cases["act_checkpoint"][0]
    four = {key: mvit_case(CONFIGS, "v2", w, case=shared) for key, w in WIDTHS.items()}
    two_ranks, four_ranks = mvit_runs(tmp_path_factory.mktemp("tp_mvit_rev"), [(cases, 2), (four, 4)])
    return cases, two_ranks, four, four_ranks


@pytest.mark.parametrize("name", ["rev", "act_checkpoint"])
def test_tp2_matches_vtm(name, runs):
    """Two ranks of one model group: the eval probabilities within
    LOGITS_TOL of ``vtm``'s, the first layer's one head whole and the rest
    cut, one AdamW step as ``vtm``'s, the checkpoint reloaded whole and
    into the cut ranks."""
    cases, results, _, _ = runs
    case, cfg, _ = cases[name]
    assert_tp_eval(results[name], case)
    assert_tp_step(results[name], case, ZERO_GRADIENTS)
    assert_tp_checkpoint(results[name], case, cfg, ZERO_GRADIENTS)
    cut = results[name][0][0]["cut_shapes"]
    stack = "rev_backbone.layers" if name == "rev" else "blocks"
    assert not any(n.startswith((f"{stack}.0.attn", f"{stack}.0.F.")) for n in cut)
    assert any(n.startswith((f"{stack}.1.attn", f"{stack}.1.F.")) for n in cut)
    assert not any("res_proj" in n for n in cut)


@pytest.mark.parametrize("key", list(WIDTHS))
def test_four_ranks_match_vtm(key, runs):
    """Four ranks: 2 x 2 (block 0 whole) and one model group of 4 (blocks
    0-2 whole, block 3's four heads one a rank): eval, step and checkpoint
    as ``vtm``'s."""
    _, _, cases, results = runs
    case, cfg, _ = cases[key]
    mesh = {"2x2": {"data": 2, "model": 2}, "1x4": {"data": 1, "model": 4}}[key]
    assert all(rank[0]["mesh"] == mesh for rank in results[key])
    assert_tp_eval(results[key], case, WIDTHS[key])
    assert_tp_step(results[key], case, ZERO_GRADIENTS)
    assert_tp_checkpoint(results[key], case, cfg, ZERO_GRADIENTS)
    whole = 3 if key == "1x4" else 1
    cut = results[key][0][0]["cut_shapes"]
    assert [any(n.startswith(f"blocks.{i}.attn.") for n in cut) for i in range(4)] == \
        [False] * whole + [True] * (4 - whole)
