"""The port's config copy against the JAX package's: same defaults, same
yaml loading, and chip_smoke's --opts lists equal to their yamls."""

import pathlib
import types

import pytest

import vtm.config as jcfg
import vtm_torch.config as tcfg

REPO = pathlib.Path(__file__).resolve().parents[1]
YAMLS = sorted(str(p.relative_to(REPO)) for p in (REPO / "configs").rglob("*.yaml"))
MAIN_YAML = "configs/videomae/kinetics/tome_VideoMAE_B_16_224_K400.yaml"
MOTIONFORMER_YAML = "configs/motionformer/kinetics/tome_motionformer_224_16x4.yaml"


def test_defaults_equal():
    assert tcfg.get_cfg().to_dict() == jcfg.get_cfg().to_dict()


@pytest.mark.parametrize("path", YAMLS)
def test_yaml_loads_equal(path):
    args = types.SimpleNamespace(opts=["TEST.CHECKPOINT_FILE_PATH", ""])
    want = jcfg.load_config(args, str(REPO / path)).to_dict()
    assert tcfg.load_config(args, str(REPO / path)).to_dict() == want


def test_chip_smoke_opts_equal_main_yaml():
    import chip_smoke

    args = types.SimpleNamespace(opts=["TEST.CHECKPOINT_FILE_PATH", ""])
    want = jcfg.load_config(args, str(REPO / MAIN_YAML)).to_dict()
    assert chip_smoke.main_cfg().to_dict() == want


def test_chip_smoke_motionformer_opts_equal_yaml():
    import chip_smoke

    args = types.SimpleNamespace(opts=["TEST.CHECKPOINT_FILE_PATH", ""])
    want = jcfg.load_config(args, str(REPO / MOTIONFORMER_YAML)).to_dict()
    assert chip_smoke.mf_cfg().to_dict() == want


def test_defaults_and_opts_need_no_yaml(monkeypatch):
    """Building a config from defaults and --opts never imports yaml."""
    import builtins

    real_import = builtins.__import__

    def no_yaml(name, *a, **kw):
        if name == "yaml":
            raise ImportError("yaml unavailable")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_yaml)
    cfg = tcfg.get_cfg()
    cfg.merge_from_list(["TOME.R_VALUE", "150", "TEST.CHECKPOINT_FILE_PATH", ""])
    assert cfg.TOME.R_VALUE == 150 and cfg.TEST.CHECKPOINT_FILE_PATH == ""
    with pytest.raises(ImportError):
        cfg.dump()
