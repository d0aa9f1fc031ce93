"""Data parallelism and the mesh (``vtm_torch/parallel``) against ``vtm`` on
the CPU: the data-width rule and ``init_distributed``'s mapping (no process
group needed), the cut rules against ``vtm``'s specs, the loader's rank
rows, the launcher's device choice, what still raises; then two spawned
ranks over gloo: a DDP train step against ``vtm``'s one-device step on the
global batch, its checkpoint loaded into one process, and ``test_net.test``
against ``vtm``'s ``tools/test_net.test`` from one checkpoint file."""

import json
import logging
import pickle

import jax
import numpy as np
import pytest
import torch

import tools.test_net as jax_test_net
import vtm.parallel.mesh as jmesh
from vtm.config import get_cfg as jax_get_cfg
from vtm.data import construct_loader as jax_construct_loader
from vtm.parallel.mesh import init_distributed as jax_init_distributed
from vtm.parallel.sharding import tp_param_specs

from vtm_torch.checkpoints import checkpoint as cu
from vtm_torch.config import get_cfg
from vtm_torch.data import construct_loader
from vtm_torch.models import build_model
from vtm_torch.parallel import launch as launch_mod
from vtm_torch.parallel import mesh
from vtm_torch.parallel.probes import bundle_of, run_probes
from vtm_torch.parallel.sharding import Cut, check_tensor_parallel, cut_rule, join, plan_cuts, take
from vtm_torch.tools import model_benchmark as mb
from vtm_torch.tools import test_net as tn
from vtm_torch.tools import train_net
from vtm_torch.train.optimizer import construct_optimizer

from torch_parallel_checks import (
    MERGE_POLICY,
    MOTIONFORMER,
    SOLVER,
    TIMESFORMER,
    Case,
    TPCase,
    assert_matchings_equal,
    assert_step_matches,
    cfgs,
    launch,
)

torch.set_num_threads(2)


@pytest.mark.parametrize("devices", range(1, 9))
def test_data_width_is_vtms_rule(devices, monkeypatch, caplog):
    """For batches 1-16 and model widths 1 and 2: the data axis ``vtm``'s
    ``make_mesh(batch_cap=)`` builds over that many devices (its Mesh
    replaced by the shape it is given), and the same idle-device warning."""
    monkeypatch.setattr(jmesh, "Mesh", lambda arr, axis_names: dict(zip(axis_names, np.shape(arr))))
    for mp in (1, 2):
        if devices < mp:
            continue
        for batch in range(1, 17):
            caplog.clear()
            with caplog.at_level(logging.WARNING):
                want = jmesh.make_mesh(list(range(devices)), model_parallel=mp, batch_cap=batch)
                used = mesh.mesh_devices(list(range(devices)), batch, mp)
            assert mesh.data_width(devices, batch, mp) == want["data"], (batch, mp)
            assert len(used) == want["data"] * mp
            warnings = {r.name: r.getMessage() for r in caplog.records}
            assert warnings.get("vtm_torch.parallel.mesh") == warnings.get("vtm.parallel.mesh"), (batch, mp)


TOPOLOGIES = {
    # (NUM_SHARDS, SHARD_ID, INIT_METHOD, local rank, local size, environment)
    "one_process": (1, 0, "", 0, 1, {}),
    "tcp": (4, 2, "tcp://host0:1234", 0, 1, {}),
    "bare_address": (4, 3, "host0:1234", 0, 1, {}),
    "env": (2, 1, "env://", 0, 1, {}),
    "two_devices_a_machine": (4, 2, "tcp://host0:1234", 1, 2, {}),
    "torchrun": (1, 0, "", 0, 1, {"RANK": "5", "WORLD_SIZE": "8", "LOCAL_RANK": "1"}),
}


@pytest.mark.parametrize("name", list(TOPOLOGIES))
def test_init_distributed_maps_the_topology_as_vtm(name, monkeypatch):
    """``init_distributed`` against ``vtm``'s (``tests/test_parallel.py:162-187``):
    a one-process run is a no-op; otherwise one process group whose world
    size and rank are ``vtm``'s process count and id with one device a
    machine (a machine's processes more with more), rendezvous at the
    coordinator's address; torchrun's variables taken as they are."""
    shards, shard_id, method, local_rank, local_size, env = TOPOLOGIES[name]
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg, jcfg = cfgs("NUM_SHARDS", str(shards), "SHARD_ID", str(shard_id), "INIT_METHOD", method)
    calls, jcalls = [], []
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.distributed, "init_process_group", lambda **kw: calls.append(kw))
    monkeypatch.setattr(jax.distributed, "initialize", lambda **kw: jcalls.append(kw))
    made = mesh.init_distributed(cfg, local_rank=local_rank, local_size=local_size)
    jax_init_distributed(jcfg)
    if name == "one_process":
        assert not made and calls == [] and jcalls == []
        return
    assert made and len(calls) == 1
    got = calls[0]
    assert got["backend"] == "nccl" and got["timeout"] == mesh.DEFAULT_TIMEOUT
    if name == "torchrun":
        assert (got["world_size"], got["rank"], got["init_method"]) == (8, 5, "env://")
        return
    want = jcalls[0]
    assert got["world_size"] == want["num_processes"] * local_size
    assert got["rank"] == want["process_id"] * local_size + local_rank
    if want["coordinator_address"] is None:
        assert got["init_method"] == "env://"
    else:
        assert got["init_method"] == "tcp://" + want["coordinator_address"]


@pytest.mark.parametrize("backend,want", [("ici", "nccl"), ("nccl", "nccl"), ("gloo", "gloo"), ("mpi", None)])
def test_backend_rule(backend, want):
    if want is None:
        with pytest.raises(ValueError, match="DIST_BACKEND"):
            mesh.backend_for(backend)
    else:
        assert mesh.backend_for(backend) == want


def _tp_case(family: str):
    """A tiny model of ``family`` in both packages and the port's module."""
    if family in ("VideoMAE", "ViViT"):
        case = Case(family)
        return case, bundle_of(case.spec, None, torch.device("cpu"), fp32_params=True).module
    if family.startswith("MViT"):
        from torch_mvit_cases import BASE, V2

        extra = ("MVIT.SEPARATE_QKV", "True") if family.endswith("separate_qkv") else ("MVIT.NUM_HEADS", "1", *V2)
        case = TPCase("MViT", opts=[*BASE, *extra])
    else:
        arch = TIMESFORMER if family == "TimeSformer" else MOTIONFORMER
        case = TPCase(family, arch, MERGE_POLICY)
    return case, bundle_of(case.spec, case.cfg, torch.device("cpu"), fp32_params=True).module


@pytest.mark.parametrize("family", ["VideoMAE", "ViViT", "TimeSformer", "Motionformer", "MViT", "MViT-separate_qkv"])
def test_cut_rules_are_vtms_specs(family):
    """Every parameter is cut at width 2 (``plan_cuts``) as ``vtm``'s
    ``tp_param_specs`` cuts it: columns where it says (None, model) or
    (model,) on a column module, rows where (model, None), whole where
    replicated; but the departures the port's in-place cuts force
    (``parallel/sharding.py``): VideoMAE's q_bias and v_bias, cut with q and
    v; MViT's separate q, k and v, cut by heads; MViT's block-level proj and
    every parameter of an attention whose one head does not split (block
    0's), whole."""
    case, module = _tp_case(family)
    code = {(None, "model"): 1, ("model",): 1, ("model", None): 2, (): 0}
    specs = tp_param_specs(case.params)
    tree = jax.tree_util.tree_map(lambda x, s: np.full(np.shape(x), code[tuple(s)], np.float32), case.params, specs,
                                  is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    want = {k: int(v.flat[0]) for k, v in case.named(tree).items()}
    rules, _ = plan_cuts(module, 2)
    got = {name: 0 if rule is None else 1 if rule[0] == 0 else 2 for name, rule in rules.items()}
    assert sorted(got) == sorted(want)
    differ = {k for k in want if got[k] != want[k]}
    expected = set()
    cut_here = set()  # cut in the port, whole in vtm; the rest of ``expected`` the other way
    if family == "VideoMAE":
        cut_here = {n for n in want if n.endswith(("q_bias", "v_bias"))}
    elif family.startswith("MViT"):
        parts = {n: n.split(".") + ["", "", ""] for n in want}
        whole_here = {n for n, p in parts.items() if p[0] == "blocks" and p[2] == "proj" and want[n]}  # blocks.{i}.proj
        if family == "MViT":
            whole_here |= {n for n in want if n.startswith("blocks.0.attn.") and want[n]}
        cut_here = {n for n, p in parts.items() if p[2] == "attn" and p[3] in ("q", "k", "v")}
        expected = whole_here
    expected = expected | cut_here
    assert differ == expected
    assert all(got[k] == (1 if k in cut_here else 0) for k in differ)
    assert cut_rule("blocks.0.attn.qkv.weight", 2) == (0, 3) and cut_rule("blocks.0.attn.proj_kv.weight", 2) == (0, 2)


@pytest.mark.parametrize("dim,parts,ways", [(0, 1, 2), (0, 3, 2), (0, 3, 4), (1, 1, 2), (1, 1, 3)])
def test_take_and_join_invert_each_other(dim, parts, ways):
    full = torch.arange(24 * 12, dtype=torch.float32).reshape(24, 12)
    pieces = [take(full, Cut(dim, parts, ways, r)) for r in range(ways)]
    assert all(p.shape[dim] == full.shape[dim] // ways for p in pieces)
    assert torch.equal(join(pieces, Cut(dim, parts, ways, 0)), full)
    if parts == 3:  # rank r holds heads r of q, of k and of v
        assert torch.equal(pieces[1][: 24 // (3 * ways)], full[24 // (3 * ways): 2 * 24 // (3 * ways)])


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("split", ["train", "test"])
def test_loader_ranks_make_vtms_batches(world, split, monkeypatch):
    """The rank loaders' valid rows, in rank order, are ``vtm``'s batches
    (train shuffled, test with an uneven last batch of 2), and a rank reads
    only the items of its rows (padding: copies of the batch's first)."""
    opts = ["TRAIN.DATASET", "synthetic", "TEST.DATASET", "synthetic", "TRAIN.BATCH_SIZE", "6",
            "TEST.BATCH_SIZE", "3", "TEST.NUM_ENSEMBLE_VIEWS", "1", "TEST.NUM_SPATIAL_CROPS", "2",
            "DATA.NUM_FRAMES", "2", "DATA.TRAIN_CROP_SIZE", "8", "DATA.TEST_CROP_SIZE", "8",
            "DATA_LOADER.NUM_WORKERS", "2"]
    cfg, jcfg = cfgs(*opts)
    want = [b["index"].tolist() for b in jax_construct_loader(jcfg, split)]
    from vtm_torch.data import synthetic

    reads = []
    getitem = synthetic.Synthetic.__getitem__
    monkeypatch.setattr(synthetic.Synthetic, "__getitem__", lambda self, i: reads.append(i) or getitem(self, i))
    ranks = []
    for rank in range(world):
        reads.clear()
        batches = list(construct_loader(cfg, split, rank, world))
        assert sorted(reads) == sorted(i for b in batches for i in b["index"].tolist())
        ranks.append(batches)
    assert all(len(r) == len(want) for r in ranks)
    for i, batch in enumerate(want):
        got = [x for r in ranks for x in r[i]["index"][:r[i]["valid"]].tolist()]
        assert got == batch
        assert len({len(r[i]["index"]) for r in ranks}) == 1  # equal rows a rank: the gather's shapes
    if split == "test":
        assert len(want[-1]) == 2


_MF = ["MODEL.MODEL_NAME", "Motionformer", "MOTIONFORMER.EMBED_DIM", "32", "MOTIONFORMER.DEPTH", "2",
       "MOTIONFORMER.NUM_HEADS", "2", "MOTIONFORMER.TEMPORAL_RESOLUTION", "2"]
GRADIENT_FAMILIES = {
    "VideoMAE": ["MODEL.MODEL_NAME", "VideoMAE", "VIDEOMAE.MODEL", "vit_small_patch16_224"],
    "VideoMAE-cls-pooling-twin-heads": ["MODEL.MODEL_NAME", "VideoMAE", "VIDEOMAE.MODEL", "vit_small_patch16_224",
                                        "EPICKITCHENS.NUM_CLASSES", "[5, 7]", "VIDEOMAE.USE_MEAN_POOLING", "False"],
    "ViViT": ["MODEL.MODEL_NAME", "ViViT", "MODEL.ARCH", "vivit"],
    "TimeSformer": ["MODEL.MODEL_NAME", "TimeSformer", "MODEL.ARCH", "timesformer", "DATA.NUM_FRAMES", "2"],
    "Motionformer-trajectory": _MF,
    "Motionformer-joint": _MF + ["MOTIONFORMER.ATTN_LAYER", "joint"],
    "Motionformer-divided": _MF + ["MOTIONFORMER.ATTN_LAYER", "divided"],
    "Motionformer-nystrom": _MF + ["MOTIONFORMER.APPROX_ATTN_TYPE", "nystrom", "MOTIONFORMER.APPROX_ATTN_DIM", "2"],
}


@pytest.mark.parametrize("family", list(GRADIENT_FAMILIES))
def test_every_parameter_gets_a_gradient(family, tmp_path):
    """DDP runs with ``find_unused_parameters=False``: in every family and
    attention option a step gives every parameter a gradient."""
    vivit = tmp_path / "vivit.json"
    vivit.write_text(json.dumps(dict(
        video_size=[4, 32, 32], tubelet_size=[2, 16, 16], num_channels=3, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64, hidden_act="gelu_fast", layer_norm_eps=1e-6, qkv_bias=True)))
    cfg = get_cfg()
    cfg.merge_from_list(["DATA.NUM_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "32", "TPU.COMPUTE_DTYPE", "float32",
                         "TOME.ENABLE", "True", "TOME.R_VALUE", "1", "VIVIT.CONFIG_PATH", str(vivit),
                         *GRADIENT_FAMILIES[family]])
    module = build_model(cfg, "cpu", fp32_params=True).module.train()
    out, _ = module(torch.randn(2, cfg.DATA.NUM_FRAMES, 32, 32, 3), generator=torch.Generator().manual_seed(0))
    sum(o.sum() for o in (out if isinstance(out, tuple) else (out,))).backward()
    assert [n for n, p in module.named_parameters() if p.grad is None] == []


@pytest.mark.parametrize("family", ["TimeSformer", "Motionformer", "MViT"])
@pytest.mark.parametrize("entry", ["train_net", "test_net", "model_benchmark"])
def test_tensor_parallel_families_not_cut_raise_by_item(family, entry):
    """The families cut since VideoMAE and ViViT pass every entry point's
    check and, called in one process, need their model group's processes
    as VideoMAE does (the cut runs: tests/test_torch_parallel_tp_*.py)."""
    cfg = get_cfg()
    cfg.merge_from_list(["MODEL.MODEL_NAME", family, "TPU.MODEL_PARALLEL", "2"])
    check_tensor_parallel(cfg)
    run = {"train_net": train_net.build_trainer, "test_net": tn.test, "model_benchmark": mb.model_benchmark}[entry]
    with pytest.raises(ValueError, match="needs 2 processes"):
        run(cfg, device="cpu")


def test_model_parallel_without_processes_raises():
    cfg = get_cfg()
    cfg.merge_from_list(["MODEL.MODEL_NAME", "VideoMAE", "TPU.MODEL_PARALLEL", "2"])
    with pytest.raises(ValueError, match="needs 2 processes"):
        train_net.build_trainer(cfg, device="cpu")


def test_a_second_gpu_is_used_or_refused(monkeypatch, caplog):
    """With 4 visible CUDA devices the entry points' main launches one
    process per device the batch can use (a batch of 2: 2 of them, with
    vtm's warning; tp 2 and a batch of 3: 1 x 2); one device runs here; an
    entry point called in-process without a device refuses to leave the
    others idle."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    launched = []
    monkeypatch.setattr(launch_mod, "launch_job", lambda cfg, fn, devices, args=(): launched.append(devices) or [1])
    cfg = get_cfg()
    with caplog.at_level(logging.WARNING):
        launch_mod.run(cfg, lambda c, d: 0, batch=2)
    assert launched[-1] == ["cuda:0", "cuda:1"] and "left idle" in caplog.text
    cfg.TPU.MODEL_PARALLEL = 2
    launch_mod.run(cfg, lambda c, d: 0, batch=3)
    assert launched[-1] == ["cuda:0", "cuda:1"]
    cfg.TPU.MODEL_PARALLEL = 1
    assert launch_mod.run(cfg, lambda c, d: str(d), batch=1) == ["cuda:0"] and len(launched) == 2
    with pytest.raises(RuntimeError, match="4 CUDA devices are visible"):
        train_net.build_trainer(cfg)


def test_ddp_step_and_checkpoint_match_vtm(tmp_path):
    """Two DDP ranks of 2 clips each of merged tiny VideoMAE, AdamW with
    layer decay: the global loss, the gradients DDP averages and the
    parameters after the step as ``vtm``'s one-device step on the batch of
    4; each rank's Matchings those of ``vtm``'s rows; and the checkpoint the
    ranks save loads into one process with its moments."""
    case = Case("VideoMAE", seed=1)
    frames, labels = case.video(4, 5), case.labels(4, 6)
    cfg, jc = cfgs(*SOLVER, "MODEL.MODEL_NAME", "VideoMAE", "TRAIN.BATCH_SIZE", "4")
    want = case.step(jc, frames, labels)
    _, want_matchings = case.forward(frames)
    plan = [("train", cfg, (case.spec, frames, labels), dict(checkpoint_dir=str(tmp_path / "out")))]
    ranks = [r[0]["result"] for r in launch(cfg, run_probes, tmp_path, 2, plan)]
    for r, got in enumerate(ranks):
        assert got["mesh"] == {"data": 2, "model": 1} and got["cut_shapes"] == {}
        assert_step_matches(got, want)
        rows = [{**m, **{k: m[k][2 * r:2 * r + 2] for k in ("unm_idx", "src_idx", "dst_idx")}}
                for m in want_matchings]
        assert_matchings_equal(got["matchings"], rows, f"rank {r}")
        np.testing.assert_array_equal(got["logits"].numpy(), ranks[0]["logits"].numpy())  # gathered whole
    one = bundle_of(case.spec[:3] + (None,), cfg, torch.device("cpu"), fp32_params=True).module
    optimizer, _ = construct_optimizer(cfg, one, num_layers=case.depth)
    blob = torch.load(ranks[0]["checkpoint"], map_location="cpu", weights_only=True)
    assert not any(k.startswith("module.") for k in blob["model_state"])
    assert cu.load_checkpoint(ranks[0]["checkpoint"], one, optimizer) == (0, True)
    for name, p in one.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), ranks[1]["state"][name], err_msg=name)


def _test_opts(tmp_path, *opts):
    """A tiny VideoMAE (ViT-S widths, 4 frames at a 32-pixel crop, r 2);
    4 synthetic videos of 1 view x 2 crops in batches of 3: 3, 3, 2."""
    return [
        "MODEL.MODEL_NAME", "VideoMAE", "VIDEOMAE.MODEL", "vit_small_patch16_224",
        "DATA.TEST_CROP_SIZE", "32", "DATA.TRAIN_CROP_SIZE", "32", "DATA.NUM_FRAMES", "4",
        "MODEL.NUM_CLASSES", "7", "TEST.DATASET", "synthetic", "TEST.BATCH_SIZE", "3",
        "TEST.NUM_ENSEMBLE_VIEWS", "1", "TEST.NUM_SPATIAL_CROPS", "2",
        "TOME.ENABLE", "True", "TOME.R_VALUE", "2", "TOME.PROP_ATTN", "False",
        "TPU.COMPUTE_DTYPE", "float32", "DATA_LOADER.NUM_WORKERS", "2", *opts,
    ]


def test_test_net_on_two_ranks_matches_vtm(tmp_path):
    """``test_net.test`` (and ``model_benchmark``) on two data ranks (batches of 3 padded to 4, the
    last of 2) against ``vtm``'s ``test`` on one device from one checkpoint
    file: the same stats on both ranks and as vtm's, and the per-video
    predictions rank 0 pickles within 1e-4 of vtm's (fp64 sums of fp32
    logits, as ``tests/test_torch_test_net.py`` holds them)."""
    opts = _test_opts(tmp_path)
    cfg = get_cfg()
    cfg.merge_from_list(opts)
    rng = np.random.default_rng(7)
    sd = {}
    for k, v in build_model(cfg, "cpu").module.state_dict().items():
        x = rng.standard_normal(tuple(v.shape)) * 0.05 + (1.0 if "norm" in k and k.endswith("weight") else 0.0)
        sd[k] = torch.from_numpy(x.astype(np.float32))
    torch.save({"model_state": sd}, tmp_path / "model.pyth")
    results = {}
    for pkg in ("torch", "jax"):
        out = tmp_path / pkg
        out.mkdir()
        run_opts = [*opts, "TEST.CHECKPOINT_FILE_PATH", str(tmp_path / "model.pyth"), "OUTPUT_DIR", str(out),
                    "TEST.SAVE_RESULTS_PATH", str(out / "results.pkl")]
        tcfg, jcfg = get_cfg(), jax_get_cfg()
        tcfg.merge_from_list(run_opts)
        jcfg.merge_from_list(run_opts)
        if pkg == "torch":
            bench = get_cfg()
            bench.merge_from_list([*opts, "TEST.BATCH_SIZE", "2", "MODEL_BENCHMARK.ITERATIONS", "2",
                                   "MODEL_BENCHMARK.WARMUP_ITERATIONS", "1"])
            ranks = launch(tcfg, run_probes, tmp_path, 2, [("test_net", tcfg, (), {}),
                                                           ("model_benchmark", bench, (), {})])
            stats = [r[0]["result"] for r in ranks]
            timed = [r[1]["result"] for r in ranks]
        else:
            stats = [jax_test_net.test(jcfg)]
        with open(out / "results.pkl", "rb") as f:
            results[pkg] = (stats, pickle.load(f))
    (stats, saved), (jstats, jsaved) = results["torch"], results["jax"]
    assert stats[0] == stats[1] == jstats[0]
    # model_benchmark on the same two ranks: a row each, the batch of 2 over
    # the slower rank's time, the same figure on both
    assert timed[0]["clips_per_sec"] == timed[1]["clips_per_sec"] > 0
    assert {k: timed[0][k] for k in ("ranks", "data_parallel", "model_parallel", "batch_size")} == dict(
        ranks=2, data_parallel=2, model_parallel=1, batch_size=2)
    np.testing.assert_array_equal(saved["labels"], jsaved["labels"])
    np.testing.assert_allclose(saved["preds"], jsaved["preds"], rtol=0, atol=1e-4)
