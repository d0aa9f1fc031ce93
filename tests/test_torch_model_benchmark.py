"""The port's benchmark entry point at a tiny size on the CPU."""

import jax
import numpy as np
import pytest
import torch

from vtm.checkpoints.checkpoint import load_test_checkpoint as jax_load_test_checkpoint
from vtm.config import get_cfg as jax_get_cfg
from vtm.models import build_model as jax_build_model
from vtm_torch.checkpoints.checkpoint import load_test_checkpoint
from vtm_torch.checkpoints.convert import state_dict_from_vtm_params
from vtm_torch.config import get_cfg
from vtm_torch.models import build_model
from vtm_torch.tools import model_benchmark as mb

torch.set_num_threads(2)

KEYS = {
    "split", "avg_frame_time_ms", "fps", "clips_per_sec", "batch_size", "iterations",
    "attention_kernel_launches", "frame_attention_kernel_launches",
    "blockdiag_attention_kernel_launches", "device",
}


def _tiny_opts(*opts):
    return [
        "MODEL.MODEL_NAME", "VideoMAE",
        "VIDEOMAE.MODEL", "vit_small_patch16_224",
        "DATA.TEST_CROP_SIZE", "32", "DATA.TRAIN_CROP_SIZE", "32", "DATA.NUM_FRAMES", "4",
        "MODEL.NUM_CLASSES", "7", "TEST.BATCH_SIZE", "2", "MODEL_BENCHMARK.ITERATIONS", "2",
        "TOME.ENABLE", "True", "TOME.R_VALUE", "2", "TOME.PROP_ATTN", "False",
        "TPU.COMPUTE_DTYPE", "float32", *opts,
    ]


def _tiny_cfg(*opts):
    cfg = get_cfg()
    cfg.merge_from_list(_tiny_opts(*opts))
    return cfg


def test_entry_point_returns_stats_keys(capsys):
    stats = mb.model_benchmark(_tiny_cfg(), device="cpu")
    assert set(stats) == KEYS
    assert stats["device"] == "cpu" and stats["batch_size"] == 2 and stats["iterations"] == 2
    assert stats["attention_kernel_launches"] == 0  # CPU: plain version only
    assert stats["frame_attention_kernel_launches"] == 0
    assert stats["clips_per_sec"] > 0
    assert "json_stats: " in capsys.readouterr().out


def _tiny_mf_cfg(*opts):
    """A tiny Motionformer: 2 frames of 4 tokens, 2 layers."""
    cfg = get_cfg()
    cfg.merge_from_list([
        "MODEL.MODEL_NAME", "Motionformer",
        "MOTIONFORMER.EMBED_DIM", "32", "MOTIONFORMER.DEPTH", "2", "MOTIONFORMER.NUM_HEADS", "2",
        "MOTIONFORMER.MLP_RATIO", "2", "MOTIONFORMER.TEMPORAL_RESOLUTION", "2",
        "MOTIONFORMER.USE_MLP", "True",
        "DATA.TEST_CROP_SIZE", "32", "DATA.TRAIN_CROP_SIZE", "32", "DATA.NUM_FRAMES", "4",
        "MODEL.NUM_CLASSES", "7", "TEST.BATCH_SIZE", "2", "MODEL_BENCHMARK.ITERATIONS", "2",
        "TOME.ENABLE", "True", "TOME.R_VALUE", "1", "TOME.PROP_ATTN", "True",
        "TPU.COMPUTE_DTYPE", "float32", *opts,
    ])
    return cfg


def test_motionformer_entry_point_returns_stats_keys(capsys):
    stats = mb.model_benchmark(_tiny_mf_cfg(), device="cpu")
    assert set(stats) == KEYS
    assert stats["device"] == "cpu" and stats["batch_size"] == 2
    assert stats["attention_kernel_launches"] == stats["frame_attention_kernel_launches"] == 0
    assert stats["clips_per_sec"] > 0
    assert "json_stats: " in capsys.readouterr().out


@pytest.mark.parametrize("cfg_fn", [_tiny_cfg, _tiny_mf_cfg], ids=["VideoMAE", "Motionformer"])
def test_saved_checkpoint_round_trips(cfg_fn, tmp_path):
    """A saved state dict (DDP-style ``module.`` keys inside the
    reference's ``model_state`` container) loads back bit for bit."""
    source = build_model(cfg_fn("RNG_SEED", "5"), "cpu").module
    path = tmp_path / "tiny.pyth"
    torch.save({"model_state": {f"module.{k}": v for k, v in source.state_dict().items()}}, path)
    cfg = cfg_fn("TEST.CHECKPOINT_FILE_PATH", str(path))
    bundle = load_test_checkpoint(cfg, build_model(cfg, "cpu"))
    for k, v in source.state_dict().items():
        assert torch.equal(bundle.module.state_dict()[k], v), k


def test_saved_checkpoint_loads(tmp_path):
    source = build_model(_tiny_cfg("RNG_SEED", "5"), "cpu").module
    path = tmp_path / "tiny.pyth"
    torch.save({"model_state": source.state_dict()}, path)
    cfg = _tiny_cfg("TEST.CHECKPOINT_FILE_PATH", str(path))
    bundle = load_test_checkpoint(cfg, build_model(cfg, "cpu"))
    for k, v in source.state_dict().items():
        assert torch.equal(bundle.module.state_dict()[k], v), k
    assert mb.model_benchmark(cfg, device="cpu")["batch_size"] == 2


def foreign_checkpoint(path, cfg):
    """A tiny VideoMAE saved as another run would leave it: a head of 5
    classes (the model has 7), its keys under ``student.``, a prefix that
    ``strip_prefixes`` keeps, in the reference's ``model_state``
    container, every tensor drawn anew (so that none equals an init, zero
    biases included). Returns its state dict."""
    gen = torch.Generator().manual_seed(cfg.RNG_SEED)
    source = {k: torch.randn(v.shape, generator=gen) for k, v in build_model(cfg, "cpu").module.state_dict().items()}
    torch.save({"model_state": {f"student.{k}": v for k, v in source.items()}}, path)
    return source


CLEARED = ("TRAIN.CHECKPOINT_CLEAR_NAME_PATTERN", "['student.']")


def test_foreign_checkpoint_loads_as_vtm_loads_it(tmp_path):
    """The file in both packages, the prefix cleared by
    TRAIN.CHECKPOINT_CLEAR_NAME_PATTERN: every backbone tensor the port
    loads equals the file's and the JAX package's (through
    ``state_dict_from_vtm_params``), and the head, whose shape differs,
    keeps the port's own seeded init; without the pattern nothing matches
    and the load raises, as the JAX converter does."""
    path = tmp_path / "foreign.pyth"
    source = foreign_checkpoint(path, _tiny_cfg("RNG_SEED", "5", "MODEL.NUM_CLASSES", "5"))
    extra = ("RNG_SEED", "3", "TEST.CHECKPOINT_FILE_PATH", str(path), *CLEARED)
    cfg = _tiny_cfg(*extra)
    init = build_model(cfg, "cpu").module.state_dict()
    got = load_test_checkpoint(cfg, build_model(cfg, "cpu")).module.state_dict()

    jcfg = jax_get_cfg()
    jcfg.merge_from_list(_tiny_opts(*extra))
    jbundle = jax_load_test_checkpoint(jcfg, jax_build_model(jcfg, rng=jax.random.key(0)))
    want = state_dict_from_vtm_params(jax.tree_util.tree_map(np.asarray, jbundle.params))

    heads = {k for k in got if k.startswith("head.")}
    assert heads and sorted(got) == sorted(source) == sorted(want)
    for k in got:
        if k in heads:
            assert got[k].shape != source[k].shape and torch.equal(got[k], init[k]), k
        else:
            assert torch.equal(got[k], source[k]) and not torch.equal(got[k], init[k]), k
            np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    with pytest.raises(KeyError, match="CLEAR_NAME_PATTERN"):
        load_test_checkpoint(_tiny_cfg("TEST.CHECKPOINT_FILE_PATH", str(path)), build_model(cfg, "cpu"))


@pytest.mark.parametrize("key", ["CHECKPOINT_INFLATE", "CHECKPOINT_IN_INIT"])
def test_conv_weight_adaptation_raises_by_name(tmp_path, key):
    path = tmp_path / "foreign.pyth"
    foreign_checkpoint(path, _tiny_cfg())
    cfg = _tiny_cfg("TEST.CHECKPOINT_FILE_PATH", str(path), f"TRAIN.{key}", "True")
    with pytest.raises(NotImplementedError, match=key):
        load_test_checkpoint(cfg, build_model(cfg, "cpu"))


def test_missing_checkpoint_raises(tmp_path):
    cfg = _tiny_cfg("TEST.CHECKPOINT_FILE_PATH", str(tmp_path / "missing.pyth"))
    with pytest.raises(FileNotFoundError):
        mb.model_benchmark(cfg, device="cpu")


def test_no_cuda_raises_instead_of_running_on_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mb.model_benchmark(_tiny_cfg())


def test_seed_sets_weights():
    a = build_model(_tiny_cfg("RNG_SEED", "1"), "cpu").module.state_dict()
    b = build_model(_tiny_cfg("RNG_SEED", "1"), "cpu").module.state_dict()
    c = build_model(_tiny_cfg("RNG_SEED", "2"), "cpu").module.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["blocks.0.attn.qkv.weight"], c["blocks.0.attn.qkv.weight"])


def test_layer_duplication_runs_the_grown_stack():
    """Block 0 three times at r 2: the benchmark runs 14 steps, and the
    tokens entering each are ``token_counts`` of the grown schedule."""
    cfg = _tiny_cfg("TOME.LAYER_QUANTITY", "3")
    bundle = build_model(cfg, "cpu")
    assert len(bundle.module.layer_schedule) == 14 and bundle.policy.rs == (2, 2, 2) + (0,) * 11
    seen = []
    hooks = [b.register_forward_pre_hook(lambda m, a: seen.append(a[0].shape[1])) for b in bundle.module.blocks]
    mb.perform_benchmark(bundle.module, cfg, torch.device("cpu"))
    for h in hooks:
        h.remove()
    assert tuple(seen[:14]) == bundle.policy.token_counts(8)[:-1] == (8, 6, 4, 2) + (2,) * 10


@pytest.mark.parametrize("mode", ["random_merge", "random_drop"])
def test_random_mode_raises_value_error_as_vtm_does(mode):
    """``model_benchmark`` passes no generator, as vtm's passes no rng: a
    random mode raises ValueError there."""
    with pytest.raises(ValueError, match="torch.Generator"):
        mb.model_benchmark(_tiny_cfg("TOME.MODE", mode), device="cpu")
