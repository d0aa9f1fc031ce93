"""The port's benchmark entry point at a tiny size on the CPU."""

import pytest
import torch

from vtm_torch.config import get_cfg
from vtm_torch.models import build_model
from vtm_torch.tools import model_benchmark as mb

torch.set_num_threads(2)

KEYS = {
    "split", "avg_frame_time_ms", "fps", "clips_per_sec", "batch_size", "iterations",
    "attention_kernel_launches", "frame_attention_kernel_launches",
    "blockdiag_attention_kernel_launches", "device",
}


def _tiny_cfg(*opts):
    cfg = get_cfg()
    cfg.merge_from_list([
        "MODEL.MODEL_NAME", "VideoMAE",
        "VIDEOMAE.MODEL", "vit_small_patch16_224",
        "DATA.TEST_CROP_SIZE", "32", "DATA.TRAIN_CROP_SIZE", "32", "DATA.NUM_FRAMES", "4",
        "MODEL.NUM_CLASSES", "7", "TEST.BATCH_SIZE", "2", "MODEL_BENCHMARK.ITERATIONS", "2",
        "TOME.ENABLE", "True", "TOME.R_VALUE", "2", "TOME.PROP_ATTN", "False",
        "TPU.COMPUTE_DTYPE", "float32", *opts,
    ])
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
    bundle = mb.load_test_checkpoint(cfg, build_model(cfg, "cpu"))
    for k, v in source.state_dict().items():
        assert torch.equal(bundle.module.state_dict()[k], v), k


def test_saved_checkpoint_loads(tmp_path):
    source = build_model(_tiny_cfg("RNG_SEED", "5"), "cpu").module
    path = tmp_path / "tiny.pyth"
    torch.save({"model_state": source.state_dict()}, path)
    cfg = _tiny_cfg("TEST.CHECKPOINT_FILE_PATH", str(path))
    bundle = mb.load_test_checkpoint(cfg, build_model(cfg, "cpu"))
    for k, v in source.state_dict().items():
        assert torch.equal(bundle.module.state_dict()[k], v), k
    assert mb.model_benchmark(cfg, device="cpu")["batch_size"] == 2


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


def test_layer_duplication_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(_tiny_cfg("TOME.LAYER_QUANTITY", "2"), "cpu")
