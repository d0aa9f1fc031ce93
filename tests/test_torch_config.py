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
TRAIN_YAML = "configs/videomae/epickitchens/tome_train_VideoMAE_B_16_224_EPICKITCHENS.yaml"
MF_TRAIN_YAML = "configs/motionformer/epickitchens/tome_motionformer_224_16x4.yaml"
# chip_smoke's config helpers for TimeSformer and ViViT, and their yamls
TS_VIVIT_YAMLS = {
    "ts_cfg": "configs/timesformer/kinetics/tome_TimeSformer_divST_8x32_224.yaml",
    "ts_train_cfg": "configs/timesformer/epickitchens/tome_train_TimeSformer_divST_8_224.yaml",
    "vivit_cfg": "configs/vivit/kinetics/tome_vivit_8x32_224.yaml",
    "vivit_train_cfg": "configs/vivit/epickitchens/tome_train_vivit_8x32_224.yaml",
}


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


def test_chip_smoke_train_opts_equal_yaml():
    import chip_smoke

    args = types.SimpleNamespace(opts=["TEST.CHECKPOINT_FILE_PATH", ""])
    want = jcfg.load_config(args, str(REPO / TRAIN_YAML)).to_dict()
    assert chip_smoke.train_cfg().to_dict() == want


def test_chip_smoke_motionformer_train_opts_equal_yaml():
    import chip_smoke

    args = types.SimpleNamespace(opts=["TEST.CHECKPOINT_FILE_PATH", ""])
    want = jcfg.load_config(args, str(REPO / MF_TRAIN_YAML)).to_dict()
    assert chip_smoke.mf_train_cfg().to_dict() == want


@pytest.mark.parametrize("helper", sorted(TS_VIVIT_YAMLS))
def test_chip_smoke_timesformer_and_vivit_opts_equal_yaml(helper):
    import chip_smoke

    args = types.SimpleNamespace(opts=["TEST.CHECKPOINT_FILE_PATH", ""])
    want = jcfg.load_config(args, str(REPO / TS_VIVIT_YAMLS[helper])).to_dict()
    assert getattr(chip_smoke, helper)().to_dict() == want


def _changed(base, cfg):
    out = set()
    for sec, node in cfg.to_dict().items():
        if isinstance(node, dict):
            out |= {f"{sec}.{k}" for k, v in node.items() if base[sec][k] != v}
    return out


def test_chip_smoke_timesformer_train_runs_change_only_what_they_say():
    """The timed step is the shipped config (SGD, momentum 0.9, weight decay
    1e-4) with one 400-class head and a constant learning rate on the
    synthetic dataset at batch 8; the entry-point run keeps the twin heads
    and is cut to two epochs."""
    import chip_smoke
    from vtm_torch.train.lr_policy import get_lr_at_epoch

    base = chip_smoke.ts_train_cfg().to_dict()
    step = chip_smoke.ts_train_cfg(*chip_smoke.TS_TRAIN_STEP_OPTS)
    entry = chip_smoke.ts_train_cfg(*chip_smoke.TS_TRAIN_ENTRY_OPTS)
    common = {"TRAIN.CHECKPOINT_FILE_PATH", "TRAIN.DATASET", "TRAIN.BATCH_SIZE", "DATA_LOADER.NUM_WORKERS"}
    assert _changed(base, step) == common | {"EPICKITCHENS.NUM_CLASSES", "SOLVER.LRS", "SOLVER.STEPS"}
    assert _changed(base, entry) == common | {"SOLVER.MAX_EPOCH", "TRAIN.CHECKPOINT_PERIOD", "TRAIN.EVAL_PERIOD"}
    assert [get_lr_at_epoch(step, e) for e in (0.0, 0.5, 3.0)] == [0.005] * 3
    assert [get_lr_at_epoch(entry, e) for e in (0.0, 1.5)] == [0.005] * 2
    assert (step.SOLVER.OPTIMIZING_METHOD, step.SOLVER.MOMENTUM, step.SOLVER.WEIGHT_DECAY) == ("sgd", 0.9, 0.0001)
    assert step.TOME.R_VALUE == 18 and step.TOME.PROP_ATTN is True and step.DATA.NUM_FRAMES == 8
    assert entry.EPICKITCHENS.NUM_CLASSES == [97, 300] and entry.MODEL.MODEL_NAME == "TimeSformer"


def test_chip_smoke_vivit_train_runs_change_only_what_they_say():
    """ViViT's timed step swaps the cosine schedule and its warm-up for the
    constant base learning rate; the entry-point run keeps the cosine
    schedule with one warm-up epoch of its two."""
    import chip_smoke
    from vtm_torch.train.lr_policy import get_lr_at_epoch

    base = chip_smoke.vivit_train_cfg().to_dict()
    step = chip_smoke.vivit_train_cfg(*chip_smoke.VIVIT_TRAIN_STEP_OPTS)
    entry = chip_smoke.vivit_train_cfg(*chip_smoke.VIVIT_TRAIN_ENTRY_OPTS)
    common = {"TRAIN.CHECKPOINT_FILE_PATH", "TRAIN.DATASET", "TRAIN.BATCH_SIZE", "DATA_LOADER.NUM_WORKERS"}
    assert _changed(base, step) == common | {
        "EPICKITCHENS.NUM_CLASSES", "SOLVER.LR_POLICY", "SOLVER.LRS", "SOLVER.STEPS", "SOLVER.WARMUP_EPOCHS"}
    assert _changed(base, entry) == common | {
        "SOLVER.MAX_EPOCH", "SOLVER.WARMUP_EPOCHS", "TRAIN.CHECKPOINT_PERIOD", "TRAIN.EVAL_PERIOD"}
    assert [get_lr_at_epoch(step, e) for e in (0.0, 0.5, 3.0)] == [0.003125] * 3
    assert get_lr_at_epoch(entry, 0.0) == 0.0 and 0 < get_lr_at_epoch(entry, 0.5) < 0.003125
    assert step.TOME.R_VALUE == 300 and step.DATA.NUM_FRAMES == 32
    assert entry.VIVIT.CONFIG_PATH == "configs/vivit/epickitchens/tome_vivit_8x32_224.json"
    assert (REPO / entry.VIVIT.CONFIG_PATH).exists()


def test_chip_smoke_schedules_match_the_policies():
    """The per-layer token counts chip_smoke.py expects are the policies'."""
    import chip_smoke
    from vtm_torch.merge.policy import MergePolicy

    assert MergePolicy(rs=(18,) * 12, mode="merge").token_counts(196) == chip_smoke.TS_PATCH_COUNTS
    assert MergePolicy(rs=(300,) * 12, mode="merge", class_token=True).token_counts(3137) == chip_smoke.VIVIT_COUNTS
    assert sum(256 <= n <= 4096 for n in chip_smoke.VIVIT_COUNTS[:12]) == chip_smoke.VIVIT_K1_PER_FORWARD["merged"]
    assert 1 + chip_smoke.TS_FRAMES * chip_smoke.TS_PATCH_COUNTS[-1] == 41


def test_chip_smoke_duplication_path_is_the_configs():
    """The dup phase's schedule is what build_model makes of its options,
    and the kernel phase holds K1 at every length that path gives it."""
    import chip_smoke
    from vtm_torch.models.build import duplication_plan, make_policy

    cfg = chip_smoke.main_cfg(*chip_smoke.DUP_OPTS)
    policy = make_policy(cfg, 12, n_protected_class_token=False)
    assert len(duplication_plan(cfg, 12)) == len(policy.rs) == 23
    assert policy.token_counts(1568) == chip_smoke.DUP_COUNTS
    k1_lengths = {n for n in chip_smoke.DUP_COUNTS[:-1] if 256 <= n <= 4096}
    assert len(k1_lengths) == chip_smoke.DUP_K1_PER_FORWARD == 11
    assert k1_lengths <= {n for b, h, n, d in chip_smoke.KERNEL_SHAPES if b == 8}


def test_chip_smoke_motionformer_train_runs_change_only_what_they_say():
    """The timed step is the shipped config with one 400-class head and a
    constant learning rate on the synthetic dataset at batch 8; the
    entry-point run keeps the twin heads and is cut to two epochs."""
    import chip_smoke

    base = chip_smoke.mf_train_cfg().to_dict()

    def changed(cfg):
        out = set()
        for sec, node in cfg.to_dict().items():
            if isinstance(node, dict):
                out |= {f"{sec}.{k}" for k, v in node.items() if base[sec][k] != v}
        return out

    step = chip_smoke.mf_train_cfg(*chip_smoke.MF_TRAIN_STEP_OPTS)
    entry = chip_smoke.mf_train_cfg(*chip_smoke.MF_TRAIN_ENTRY_OPTS)
    common = {"TRAIN.DATASET", "TRAIN.BATCH_SIZE"}
    assert changed(step) == common | {"EPICKITCHENS.NUM_CLASSES", "SOLVER.LRS", "SOLVER.STEPS"}
    assert changed(entry) == common | {"SOLVER.MAX_EPOCH", "TRAIN.CHECKPOINT_PERIOD", "TRAIN.EVAL_PERIOD"}
    from vtm_torch.train.lr_policy import get_lr_at_epoch

    assert [get_lr_at_epoch(step, e) for e in (0.0, 0.5, 3.0)] == [1e-4] * 3
    assert [get_lr_at_epoch(entry, e) for e in (0.0, 1.5)] == [1e-4] * 2
    assert step.SOLVER.WEIGHT_DECAY == 0.05 and step.SOLVER.OPTIMIZING_METHOD == "adamw"
    assert step.TOME.R_VALUE == 18 and step.TOME.PROP_ATTN is True
    assert entry.EPICKITCHENS.NUM_CLASSES == [97, 300] and entry.MODEL.MODEL_NAME == "Motionformer"


def test_chip_smoke_train_runs_change_only_what_they_say():
    """The timed step is the shipped config with one 400-class head, a
    constant 1e-4 AdamW, no layer decay and no stochastic depth, on the
    synthetic dataset at batch 8; the entry-point run keeps the shipped
    heads, layer decay and stochastic depth."""
    import chip_smoke

    base = chip_smoke.train_cfg().to_dict()
    step = chip_smoke.train_cfg(*chip_smoke.TRAIN_STEP_OPTS)
    entry = chip_smoke.train_cfg(*chip_smoke.TRAIN_ENTRY_OPTS)

    def changed(cfg):
        out = set()
        for sec, node in cfg.to_dict().items():
            if isinstance(node, dict):
                out |= {f"{sec}.{k}" for k, v in node.items() if base[sec][k] != v}
        return out

    common = {"SOLVER.COSINE_END_LR", "TRAIN.CHECKPOINT_FILE_PATH", "TRAIN.DATASET", "TRAIN.BATCH_SIZE", "DATA_LOADER.NUM_WORKERS"}
    assert changed(step) == common | {
        "EPICKITCHENS.NUM_CLASSES", "SOLVER.BASE_LR", "SOLVER.LR_POLICY", "SOLVER.LRS", "SOLVER.STEPS",
        "SOLVER.WARMUP_EPOCHS", "SOLVER.LAYER_DECAY", "VIDEOMAE.DROP_PATH_RATE"}
    assert changed(entry) == common | {
        "SOLVER.MAX_EPOCH", "SOLVER.WARMUP_EPOCHS", "TRAIN.CHECKPOINT_PERIOD", "TRAIN.EVAL_PERIOD"}
    from vtm_torch.train.lr_policy import get_lr_at_epoch

    assert [get_lr_at_epoch(step, e) for e in (0.0, 0.5, 3.0)] == [1e-4] * 3
    assert step.SOLVER.WEIGHT_DECAY == 0.05 and step.SOLVER.OPTIMIZING_METHOD == "adamw"
    assert entry.EPICKITCHENS.NUM_CLASSES == [97, 300] and entry.SOLVER.LAYER_DECAY == 0.75


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
