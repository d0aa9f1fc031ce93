"""Tensor parallelism (``vtm_torch/parallel/sharding.py``) against ``vtm``'s
one-device results, on the CPU over gloo: VideoMAE and ViViT cut 2 ways
(as ``tests/test_parallel.py:72-133`` holds ``vtm``'s cuts), and the 2 x 2
dry run. The ranks are spawned processes that import no JAX
(``vtm_torch/parallel/probes.py``, ``dryrun.py``); this process computes
``vtm``'s side."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vtm.train.optimizer as jopt
from vtm.checkpoints.convert import convert_videomae
from vtm.checkpoints.convert import load_torch_state_dict as jax_load_torch_state_dict
from vtm.merge.policy import MergePolicy as JPolicy
from vtm.models.videomae import VideoMAE as JVideoMAE
from vtm.models.videomae import VideoMAEConfig as JVideoMAEConfig
from vtm.train.train_step import make_train_step as jax_make_train_step

from vtm_torch.checkpoints import checkpoint as cu
from vtm_torch.checkpoints.convert import named_arrays_from_vtm_tree
from vtm_torch.merge.policy import MergePolicy
from vtm_torch.models.videomae import VideoMAE, VideoMAEConfig
from vtm_torch.parallel import dryrun
from vtm_torch.parallel.probes import bundle_of, run_probes
from vtm_torch.train.optimizer import construct_optimizer

from torch_parallel_checks import (
    LOGITS_TOL,
    LOSS_TOL,
    NEAR_ZERO_SHARE,
    PARAM_TOL,
    SOLVER,
    Case,
    assert_matchings_equal,
    assert_step_matches,
    cfgs,
    launch,
)

torch.set_num_threads(2)

# the fused qkv cut by heads in q, k and v; the separate projections and the
# MLP's first layer by output rows; the row-parallel weights by input columns
CUTS = {
    "VideoMAE": {"blocks.0.attn.qkv.weight": (48, 32), "blocks.0.attn.q_bias": (16,), "blocks.0.attn.v_bias": (16,),
                 "blocks.0.attn.proj.weight": (32, 16), "blocks.0.mlp.fc1.weight": (32, 32),
                 "blocks.0.mlp.fc1.bias": (32,), "blocks.0.mlp.fc2.weight": (32, 32)},
    "ViViT": {"layer.0.attention.query.weight": (16, 32), "layer.0.attention.key.bias": (16,),
              "layer.0.attention.value.weight": (16, 32), "layer.0.attention_output.weight": (32, 16),
              "layer.0.intermediate.weight": (32, 32), "layer.0.output.weight": (32, 32)},
}
NOISE = {"VideoMAE": (), "ViViT": ("attention.key.bias",)}  # zero analytically under a softmax


@pytest.mark.parametrize("family", ["VideoMAE", "ViViT"])
def test_tp2_matches_vtm(family, tmp_path):
    """Two ranks of one model group: the eval logits of a batch of 2
    within LOGITS_TOL of ``vtm``'s, the same Matchings on both ranks and as
    ``vtm``'s, the cuts really made; one AdamW step (layer decay 0.75) as
    ``vtm``'s step (loss, gradients, parameters); and the checkpoint the
    ranks save loads into a one-process model whole, and (VideoMAE, whose
    names are the upstream layout) into ``vtm`` through its converter."""
    case = Case(family)
    video, frames, labels = case.video(2, 1), case.video(2, 2), case.labels(2, 3)
    cfg, jc = cfgs(*SOLVER, "MODEL.MODEL_NAME", family, "TPU.MODEL_PARALLEL", "2", "TRAIN.BATCH_SIZE", "2")
    want_logits, want_matchings = case.forward(video)
    want_step = case.step(jc, frames, labels)
    plan = [("eval", cfg, (case.spec, video), {}),
            ("train", cfg, (case.spec, frames, labels), dict(checkpoint_dir=str(tmp_path / "out")))]
    ranks = launch(cfg, run_probes, tmp_path, 2, plan)

    for r, (ev, tr) in enumerate(ranks):
        ev, tr = ev["result"], tr["result"]
        assert ev["mesh"] == tr["mesh"] == {"data": 1, "model": 2}
        np.testing.assert_allclose(ev["logits"].numpy(), want_logits, rtol=0, atol=LOGITS_TOL)
        assert_matchings_equal(ev["matchings"], want_matchings, f"rank {r} eval vs vtm")
        assert_matchings_equal(ev["matchings"], ranks[0][0]["result"]["matchings"], f"rank {r} vs rank 0")
        assert_matchings_equal(tr["matchings"], ranks[0][1]["result"]["matchings"], f"rank {r} step")
        for name, shape in CUTS[family].items():
            assert ev["cut_shapes"][name] == tr["cut_shapes"][name] == shape, name
        assert_step_matches(tr, want_step, NOISE[family])
    assert_matchings_equal(ranks[0][1]["result"]["matchings"], case.forward(frames)[1], "step vs vtm")

    # the file holds the whole model (no cut, no DDP prefix) and its moments
    path = ranks[0][1]["result"]["checkpoint"]
    one = bundle_of((family, *case.spec[1:3], None), cfg, torch.device("cpu"), fp32_params=True).module
    optimizer, _ = construct_optimizer(cfg, one, num_layers=case.depth)
    assert cu.load_checkpoint(path, one, optimizer) == (0, True)
    state = ranks[0][1]["result"]["state"]
    twin = bundle_of((family, *case.spec[1:3], state), cfg, torch.device("cpu"), fp32_params=True).module
    with torch.inference_mode():
        x = torch.from_numpy(video)
        np.testing.assert_array_equal(one.eval()(x)[0].numpy(), twin.eval()(x)[0].numpy())
    moments = [s["exp_avg"] for s in optimizer.state_dict()["state"].values()]
    assert len(moments) == len(list(one.parameters())) and all(m.abs().sum() > 0 for m in moments)
    if family != "VideoMAE":
        return  # the port's ViViT names are vtm's, not the HuggingFace layout vtm's converter reads
    # and into vtm through its converter: the same logits within LOGITS_TOL
    params = convert_videomae(jax_load_torch_state_dict(path), depth=case.depth)
    with jax.default_matmul_precision("highest"):
        jlogits, _ = jax.jit(case.jmodel.apply)({"params": params}, jnp.asarray(video))
    np.testing.assert_allclose(np.asarray(jlogits), twin(torch.from_numpy(video))[0].detach().numpy(),
                               rtol=0, atol=LOGITS_TOL)


def test_dryrun_multichip_4_on_a_2x2_mesh():
    """``dryrun_multichip(4)``: a (2, 2) mesh, qkv cut in two, and the step
    (AdamW, layer decay 0.75, clipped at global norm 1.0: the norm of the
    whole model's gradient, summed across the model group) as ``vtm``'s
    one-device step on the same weights: the loss within LOSS_TOL, every
    rank's parameters the same, and within PARAM_TOL but for at most
    NEAR_ZERO_SHARE of the elements, which stay within 2 * lr."""
    out = dryrun.dryrun_multichip(4, devices=["cpu"] * 4, backend="gloo", join_timeout=300, num_threads=1)
    assert [r["mesh"] for r in out] == [{"data": 2, "model": 2}] * 4
    assert all(r["qkv_shape"] == (48, 32) for r in out)

    start = VideoMAE(VideoMAEConfig(**dryrun.ARCH), policy=MergePolicy(**dryrun.POLICY), fp32_params=True)
    params = convert_videomae({k: v.numpy() for k, v in start.state_dict().items()}, depth=dryrun.ARCH["depth"])
    jmodel = JVideoMAE(config=JVideoMAEConfig(**dryrun.ARCH), policy=JPolicy(**dryrun.POLICY))
    _, jc = cfgs("SOLVER.OPTIMIZING_METHOD", "adamw", "SOLVER.LAYER_DECAY", "0.75", "SOLVER.CLIP_GRAD_L2NORM", "1.0")
    tx, lr_at = jopt.construct_optimizer(jc, params, num_layers=dryrun.ARCH["depth"])
    opt_state = tx.init(params)
    jopt.set_lr(opt_state, lr_at(0.0))
    frames, labels = dryrun.batch(4)
    with jax.default_matmul_precision("highest"):
        after, _, loss, _, _ = jax_make_train_step(jmodel, tx, "cross_entropy", False)(
            params, opt_state, jnp.asarray(frames), jnp.asarray(labels), jax.random.key(0))
    want = named_arrays_from_vtm_tree(jax.tree_util.tree_map(np.asarray, after))
    off = total = 0
    for r in out:
        assert abs(r["loss"] - float(loss)) <= LOSS_TOL
        for name, w in want.items():
            err = np.abs(r["state"][name] - w)
            assert (err <= max(PARAM_TOL, 2 * lr_at(0.0))).all(), name
            off += int((err > PARAM_TOL).sum())
            total += w.size
        for name in want:
            np.testing.assert_array_equal(r["state"][name], out[0]["state"][name])
    assert off <= NEAR_ZERO_SHARE * total, (off, total)
