"""Motionformer's approximate trajectory attention cut 2 ways for tensor
parallelism (``vtm_torch/parallel/sharding.py``) against ``vtm``'s
one-device results, on the CPU over gloo: Nyström, Orthoformer and
Performer in the spatial step. Performer runs on ``vtm``'s
projection for key 0 in both packages (torch's generators cannot draw
``vtm``'s); Orthoformer's first landmark is row 0 in both, and a forward
with a generator draws the same landmarks on the cut ranks as in one
process. Every configuration runs in one launch of two spawned ranks that
import no JAX (``vtm_torch/parallel/probes.py``); this process computes
``vtm``'s side while they run."""

import jax
import numpy as np
import pytest
import torch

from vtm.models import motionformer_approx as japprox

from torch_parallel_checks import (
    LOGITS_TOL,
    MERGE_POLICY,
    MOTIONFORMER,
    SOLVER,
    TPCase,
    assert_tp_checkpoint,
    assert_tp_eval,
    assert_tp_step,
    assert_matchings_equal,
    cfgs,
    launch_during,
    tp_plan,
)
from vtm_torch.models import motionformer_approx
from vtm_torch.parallel.probes import bundle_of, projection_put_in, run_probes

torch.set_num_threads(2)

ORTHOFORMER_SEED = 7
HEAD_DIM = MOTIONFORMER["embed_dim"] // MOTIONFORMER["num_heads"]
CONFIGS = {
    "nystrom": (dict(approx_attn_type="nystrom", approx_attn_dim=2), MERGE_POLICY),
    "orthoformer": (dict(approx_attn_type="orthoformer", approx_attn_dim=2), MERGE_POLICY),
    "performer": (dict(approx_attn_type="performer"), MERGE_POLICY),
}
# zero analytically, rounding noise in both packages: proj_kv's bias under
# the reference's v=x (its k half shifts a softmax's logits alike, its v half
# is unused) and the last block's trajectory projections (only its CLS row
# reaches the head)
NOISE = ("attn.proj_kv.bias", "blocks.1.attn.proj_q", "blocks.1.attn.proj_kv")
# qkv cut by heads in q, k and v, proj_q by heads, proj_kv by heads in k and v
CUTS = {"blocks.0.attn.qkv.weight": (48, 32), "blocks.0.attn.proj_q.weight": (16, 32),
        "blocks.0.attn.proj_q.bias": (16,), "blocks.0.attn.proj_kv.weight": (32, 32),
        "blocks.0.attn.proj.weight": (32, 16), "blocks.0.mlp.fc1.weight": (32, 32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_motionformer_approx")
    projection = np.array(japprox.create_projection_matrix(256, HEAD_DIM, jax.random.key(0)))
    cases, plan = {}, []
    for name, (extra, policy) in CONFIGS.items():
        case = TPCase("Motionformer", dict(MOTIONFORMER, **extra), policy,
                      projection=projection if name == "performer" else None)
        cfg, jc = cfgs(*SOLVER, "MODEL.MODEL_NAME", "Motionformer", "TPU.MODEL_PARALLEL", "2",
                       "TRAIN.BATCH_SIZE", "2")
        cases[name] = (case, cfg, jc)
        plan += tp_plan(case, cfg, str(tmp / name))
    case, cfg, _ = cases["orthoformer"]
    plan.append(("eval", cfg, (case.spec, case.video(2, 1)), dict(seed=ORTHOFORMER_SEED)))
    ranks, _ = launch_during(cfg, run_probes, tmp, 2, (plan,),
                             lambda: [case.expect(jc) for case, _, jc in cases.values()])
    results = {name: [[r["result"] for r in rank[3 * i:3 * i + 3]] for rank in ranks] for i, name in enumerate(cases)}
    drawn = [rank[-1]["result"] for rank in ranks]
    return cases, results, drawn


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tp2_eval_matches_vtm(name, runs):
    """Two ranks of one model group: the eval probabilities within
    LOGITS_TOL of ``vtm``'s, the per-pseudo-frame Matchings equal on both
    ranks and to ``vtm``'s, the cuts really made,
    and for Performer one projection seed on every rank."""
    cases, results, _ = runs
    assert_tp_eval(results[name], cases[name][0])
    ev = results[name][0][0]
    assert ev["mesh"] == {"data": 1, "model": 2}
    assert len(ev["matchings"]) == 2
    for param, shape in CUTS.items():
        assert ev["cut_shapes"][param] == shape, param
    if name == "performer":
        seeds = [rank[0]["seen"]["seeds"] for rank in results[name]]
        assert len(seeds[0]) == MOTIONFORMER["depth"] and seeds[0] == seeds[1]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tp2_step_matches_vtm(name, runs):
    """One AdamW step (layer decay 0.75) as ``vtm``'s: loss, gradients and
    parameters on both ranks (the gradients that are zero analytically
    named, not compared)."""
    cases, results, _ = runs
    assert_tp_step(results[name], cases[name][0], NOISE, unused=("attn.proj_kv.weight",))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tp2_checkpoint_reloads_whole(name, runs):
    """The ranks' checkpoint loads back into the cut ranks and whole into
    one process, with the same output."""
    cases, results, _ = runs
    case, cfg, _ = cases[name]
    assert_tp_checkpoint(results[name], case, cfg, NOISE)


def test_tp2_orthoformer_draws_every_heads_first_landmark(runs):
    """A forward with a generator: each rank draws the first landmark of
    every head and keeps its own, so the cut ranks give one process's
    output and Matchings for the same generator."""
    cases, _, drawn = runs
    case, cfg, _ = cases["orthoformer"]
    one_cfg = cfg.clone()
    one_cfg.TPU.MODEL_PARALLEL = 1
    module = bundle_of(case.spec, one_cfg, torch.device("cpu"), fp32_params=False).module
    with torch.inference_mode():
        want, _ = module(torch.from_numpy(case.video(2, 1)), generator=torch.Generator().manual_seed(ORTHOFORMER_SEED))
    for rank in drawn:
        np.testing.assert_allclose(rank["logits"].numpy(), want.numpy(), rtol=0, atol=LOGITS_TOL)
        assert_matchings_equal(rank["matchings"], drawn[0]["matchings"], "orthoformer rank vs rank 0")


def test_performer_projection_is_put_in_for_the_probe_only(runs):
    """The spec's projection replaces Performer's draw inside
    ``projection_put_in`` only: after the checkpoint's forward (which puts
    it in) the draw is the module's own again, for any later caller."""
    cases, _, _ = runs
    case, _, _ = cases["performer"]
    draw = motionformer_approx.create_projection_matrix
    with projection_put_in(case.spec):
        np.testing.assert_array_equal(
            motionformer_approx.create_projection_matrix(3, 5, torch.Generator()).numpy(), case.projection)
    assert motionformer_approx.create_projection_matrix is draw
    got = draw(8, 4, torch.Generator().manual_seed(0))
    assert got.shape == (8, 4)
    assert torch.equal(got, draw(8, 4, torch.Generator().manual_seed(0)))
