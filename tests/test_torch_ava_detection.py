"""AVA detection through the port's models, steps and entry points against
``vtm``'s on the CPU: the detection forwards of tiny SlowFast, Slow, C2D
and MViT (``DETECTION.ENABLE``; clips that are not square) from the same
weights within OUT_TOL; three detection train steps (``bce_logit``, SGD,
one batch without a box) in fp64 in both packages within FP64_TOL,
parameters and BatchNorm statistics; ``test_net.test`` on SlowFast and MViT
(the frame mAP and ``detections_latest.csv``) and one epoch of
``train_net.train`` (the losses, the val mAP) against ``vtm``'s from the
same weights; a PySlowFast-layout AVA state dict and a Kinetics one loaded
as ``vtm``'s converter loads them; what X3D, the PTV families, a model
called without boxes, precise BatchNorm, ``model_benchmark`` and
``TPU.MODEL_PARALLEL`` do under ``DETECTION.ENABLE``. About 60 s."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tools.test_net as jax_test_net
import tools.train_net as jax_train_net
import vtm.eval.meters as jax_meters
import vtm.models.convnet as jax_convnet
import vtm.models.roi_head as jax_roi_head
import vtm.train.optimizer as jopt
from vtm.checkpoints.checkpoint import load_test_checkpoint as jax_load_test_checkpoint
from vtm.checkpoints.convert import convert_mvit, convert_pyslowfast
from vtm.models.build import build_model as jax_build_model
from vtm.train.precise_bn import compute_precise_bn_stats as jax_precise_bn
from vtm.train.train_step import make_detection_train_step as jax_make_detection_train_step

import vtm_torch.eval.meters as meters
from vtm_torch.checkpoints.checkpoint import load_test_checkpoint
from vtm_torch.checkpoints.convert import load_mvit_state_dict, mvit_state_dict_from_vtm_params, \
    pyslowfast_state_dict_from_vtm
from vtm_torch.models import build_model
from vtm_torch.tools import model_benchmark as mb
from vtm_torch.tools import test_net, train_net
from vtm_torch.train.optimizer import construct_optimizer, set_lr
from vtm_torch.train.precise_bn import compute_precise_bn_stats
from vtm_torch.train.train_step import detection_loss, make_detection_eval_step, make_detection_train_step

from torch_ava_cases import CLASSES, MVIT_OPTS, ava_data_opts, boxes_for, conv_opts, write_ava_tree
from torch_conv_cases import assert_close_to_largest, cfgs, moved_state, np_tree, stats_tol, tree_paths

torch.set_num_threads(2)

OUT_TOL = 1e-5  # fp32 eval probabilities, absolute
FP64_TOL = 1e-9  # fp64: the loss; each tensor's change, of its largest
FP64_FLOOR = 1e-6  # a tensor that barely moves is held to this share of its largest value
LOSS_TOL = 1e-5  # fp32 losses of train_net, relative
MAP_TOL = 1e-12
SCORE_TOL = 1.5e-4  # the csv's 4-decimal scores: one unit of the last digit
SGD = ("SOLVER.OPTIMIZING_METHOD", "sgd", "SOLVER.BASE_LR", "0.1", "SOLVER.MOMENTUM", "0.9",
       "SOLVER.WEIGHT_DECAY", "1e-4", "SOLVER.LR_POLICY", "cosine", "SOLVER.MAX_EPOCH", "4")
CONV = {"slowfast": ("SlowFast", "slowfast"), "slow": ("ResNet", "slow"), "c2d": ("ResNet", "c2d")}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("ava")
    write_ava_tree(root)
    return root


class DetCase:
    """A tiny detection SlowFast or ResNet in both packages: the port's
    seeded model with every BatchNorm moved (``moved_state``), ``vtm``'s
    trees of the same weights (``convert_pyslowfast``) checked against
    ``jax.eval_shape`` of its init with boxes."""

    def __init__(self, name: str, *extra, move: bool = True):
        self.cfg, self.jcfg = cfgs(conv_opts(*CONV[name], *extra))
        self.module = build_model(self.cfg, "cpu").module
        self.state = moved_state(self.module, 0, move)
        self.module.load_state_dict({k: torch.from_numpy(v) for k, v in self.state.items()})
        self.jmodule = jax_build_model(self.jcfg, init=False).module
        self.params, self.stats = convert_pyslowfast(self.state)
        shapes = jax.eval_shape(lambda: self.jmodule.init(
            jax.random.key(0), jnp.zeros((1, 8, 32, 32, 3)), bboxes=jnp.asarray([[0.0, 0.0, 0.0, 31.0, 31.0]])))
        assert tree_paths(shapes["params"]) == tree_paths(self.params)
        assert tree_paths(shapes["batch_stats"]) == tree_paths(self.stats)


def _video(batch: int, seed: int, h: int = 32, w: int = 48) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((batch, 8, h, w, 3)).astype(np.float32)


def _labels(n: int, seed: int) -> np.ndarray:
    return (np.random.default_rng(seed).random((n, CLASSES)) < 0.3).astype(np.float32)


@pytest.mark.parametrize("name", sorted(CONV))
def test_conv_detection_forward_matches_vtm(name):
    """Eval: each box's sigmoid row on a 32 x 48 clip, boxes past the edges
    included, within OUT_TOL; the model runs the ROI head (``head``) and
    its state dict names ``head.projection`` as upstream's AVA models do."""
    case = DetCase(name)
    x, boxes = _video(2, 3), boxes_for(2, 7, 32, 48, 4)
    fwd = jax.jit(lambda p, s, x, b: case.jmodule.apply({"params": p, "batch_stats": s}, x, bboxes=b)[0])
    want = np.asarray(fwd(case.params, case.stats, jnp.asarray(x), jnp.asarray(boxes)))
    got, state = case.module(torch.from_numpy(x), bboxes=torch.from_numpy(boxes))
    assert state is None and got.shape == want.shape == (7, CLASSES)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=OUT_TOL)
    assert [k for k in case.state if k.startswith("head.")] == ["head.projection.weight", "head.projection.bias"]


def _mvit_case(*extra):
    cfg, jcfg = cfgs(MVIT_OPTS + list(extra))
    module = build_model(cfg, "cpu").module
    state = {k: v.detach().numpy() for k, v in module.state_dict().items()}
    params = convert_mvit(state, depth=cfg.MVIT.DEPTH)
    params["head"] = {"projection": params["head"]}  # vtm's ROI head's tree (see test_mvit_checkpoints_load)
    jmodule = jax_build_model(jcfg, init=False).module
    shapes = jax.eval_shape(lambda: jmodule.init(jax.random.key(0), jnp.zeros((1, 8, 32, 32, 3)),
                                                 bboxes=jnp.asarray([[0.0, 0.0, 0.0, 31.0, 31.0]])))
    assert tree_paths(shapes["params"]) == tree_paths(params)
    return cfg, module, state, params, jmodule


@pytest.mark.parametrize("w", [32, 48])
def test_mvit_detection_forward_matches_vtm(w):
    """MViT: ``norm``, the class token stripped, the [T, H, W] grid through
    the ROI head at 1/8; a 32 x 48 clip resizes the position table as in
    ``vtm``. Eval rows within OUT_TOL, train-mode logits at rate 0 too."""
    cfg, module, _, params, jmodule = _mvit_case()
    x, boxes = _video(2, 5, 32, w), boxes_for(2, 6, 32, w, 6)
    for train in (False, True):
        want = np.asarray(jax.jit(lambda p, x, b: jmodule.apply({"params": p}, x, bboxes=b, train=train)[0])(
            params, jnp.asarray(x), jnp.asarray(boxes)))
        module.train(train)
        got = module(torch.from_numpy(x), bboxes=torch.from_numpy(boxes))[0].detach().numpy()
        assert got.shape == (6, CLASSES)
        assert_close_to_largest(got, want, OUT_TOL, f"train={train}")


def test_mvit_checkpoints_load(tmp_path):
    """An upstream AVA MViT state dict (``head.projection`` over the ROI
    head) loads into the port whole; ``vtm``'s detection tree
    (``head/projection``) maps back onto the port's names. ``vtm``'s own
    ``convert_mvit`` puts ``head.projection`` at ``head``, which its ROI
    head's tree does not hold: there ``vtm`` keeps the head's init."""
    cfg, module, state, params, _ = _mvit_case()
    sd = {k: torch.from_numpy(v) for k, v in state.items()}
    assert set(load_mvit_state_dict({"module." + k: v for k, v in sd.items()})) == set(sd)
    back = mvit_state_dict_from_vtm_params(np_tree(params))
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    assert "kernel" in convert_mvit(state, depth=cfg.MVIT.DEPTH)["head"]


class _NumpyFloat32As64:
    """``jax.numpy`` with ``float32`` read as ``float64`` (the BatchNorms'
    arithmetic and the ROI head's projection pin fp32): with x64 on, the
    whole reference runs in fp64."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _padded(boxes, labels):
    """``vtm``'s train loop's padding: rows to a multiple of 8 (at least 8), weight 0."""
    n = len(boxes)
    m = max(8, -(-n // 8) * 8)
    weights = np.zeros(m)
    weights[:n] = 1.0
    pad = m - n
    return (np.concatenate([boxes, np.zeros((pad, 5))]), np.concatenate([labels, np.zeros((pad, CLASSES))]),
            weights)


def test_three_train_steps_match_vtm_in_fp64(monkeypatch):
    """Three SGD steps (momentum 0.9, weight decay 1e-4) of the detection
    step on 5, 0 and 7 boxes (one padded shape in ``vtm``, one compile),
    every BatchNorm live, at the learning rate as ``vtm`` holds it (fp32) in
    both: each loss (0 for the batch without a box, as ``vtm``'s weighted
    mean gives) within FP64_TOL, then every parameter's change and every
    running statistic within FP64_TOL of its tensor's largest, in fp64 in
    both packages."""
    case = DetCase("slowfast", *SGD)
    batches = []
    for i, n in enumerate((5, 0, 7)):
        boxes = boxes_for(2, n, 32, 48, 20 + i) if n else np.zeros((0, 5), np.float32)
        batches.append((_video(2, 10 + i).astype(np.float64), boxes.astype(np.float64), _labels(n, 30 + i)))
    monkeypatch.setattr(jax_convnet, "jnp", _NumpyFloat32As64())
    monkeypatch.setattr(jax_roi_head, "jnp", _NumpyFloat32As64())
    with jax.enable_x64(True):
        params, stats = convert_pyslowfast({k: v.astype(np.float64) for k, v in case.state.items()})
        tx, lr_at = jopt.construct_optimizer(case.jcfg, params)
        opt_state = jopt.set_lr(tx.init(params), lr_at(0.0))
        lr = float(opt_state.hyperparams["learning_rate"])
        step = jax_make_detection_train_step(case.jmodule, tx, "bce_logit")
        want_losses = []
        for x, boxes, labels in batches:
            b, l, w = _padded(boxes, labels)
            params, stats, opt_state, loss, _ = step(params, stats, opt_state, jnp.asarray(x), jnp.asarray(b),
                                                     jnp.asarray(l), jnp.asarray(w), jax.random.key(0))
            want_losses.append(float(loss))
        want = {k: v.numpy() for k, v in pyslowfast_state_dict_from_vtm(np_tree(params), np_tree(stats)).items()}
    module = case.module.double()
    optimizer, _ = construct_optimizer(case.cfg, module, num_layers=module.config.depth)
    set_lr(optimizer, lr)
    step = make_detection_train_step(module, optimizer, "bce_logit")
    losses = [float(step(*(torch.from_numpy(a) for a in batch))[0]) for batch in batches]
    assert module.training and losses[1] == 0.0 == want_losses[1]
    np.testing.assert_allclose(losses, want_losses, rtol=FP64_TOL, atol=0)
    got = {k: v.numpy() for k, v in module.state_dict().items()}
    assert set(got) == set(want)
    for k, v in got.items():
        start = case.state[k].astype(np.float64)
        change = np.abs(want[k] - start).max()
        scale = max(change, FP64_FLOOR * np.abs(want[k]).max(), 1e-30)
        assert np.abs(v - want[k]).max() <= FP64_TOL * scale, (k, float(np.abs(v - want[k]).max()), float(change))


def test_detection_loss_matches_vtms_formula():
    """``bce_logit``: each box's mean over the classes, then the boxes'
    mean; any other loss box by box; no box gives 0 with a gradient."""
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((5, CLASSES))).requires_grad_()
    labels = torch.from_numpy(_labels(5, 1)).double()
    x, y = logits.detach().numpy(), labels.numpy()
    per = (np.maximum(x, 0) - x * y + np.log1p(np.exp(-np.abs(x)))).mean(axis=1)
    assert abs(float(detection_loss(logits, labels, "bce_logit").detach()) - per.mean()) <= 1e-12
    mse = detection_loss(logits, labels, "mse").detach()
    assert abs(float(mse) - ((x - y) ** 2).mean()) <= 1e-12
    empty = detection_loss(logits[:0], labels[:0], "bce_logit")
    empty.backward()
    assert float(empty.detach()) == 0.0 and torch.equal(logits.grad, torch.zeros_like(logits))


def _with_weights(params, stats=None):
    """A ``build_model`` for ``vtm``'s entry points that hands out these weights."""

    def build(jcfg, init: bool = True):
        bundle = jax_build_model(jcfg, init=False)
        bundle.params, bundle.batch_stats = params, stats
        return bundle

    return build


def _csv_rows(path):
    return [line.split(",") for line in path.read_text().splitlines()]


@pytest.mark.parametrize("model", ["slowfast", "mvit"])
def test_test_net_matches_vtm(tree, tmp_path, monkeypatch, model):
    """``test_net.test`` over the test split (B3, the predicted boxes above
    the threshold): the port from a PySlowFast-layout checkpoint file of
    the moved weights (SlowFast) or its seeded init (MViT), ``vtm`` from the
    same weights; the mAP within MAP_TOL; ``detections_latest.csv`` the same
    rows (keys, boxes, classes) with scores within SCORE_TOL; one row per
    loaded box and evaluated class."""
    if model == "slowfast":
        case = DetCase("slowfast")
        ckpt = tmp_path / "ava_slowfast.pyth"
        torch.save({"model_state": {k: torch.from_numpy(v) for k, v in case.state.items()}}, ckpt)
        cfg, jcfg = cfgs(conv_opts("SlowFast", "slowfast") + ava_data_opts(tree) + ["TEST.BATCH_SIZE", "3"])
        cfg.TEST.CHECKPOINT_FILE_PATH = str(ckpt)
        build = _with_weights(case.params, case.stats)
    else:
        _, _, _, params, _ = _mvit_case()
        cfg, jcfg = cfgs(MVIT_OPTS + ava_data_opts(tree) + ["TEST.BATCH_SIZE", "3"])
        build = _with_weights(params)
    cfg.OUTPUT_DIR, jcfg.OUTPUT_DIR = str(tmp_path / "port"), str(tmp_path / "vtm")
    monkeypatch.setattr(jax_test_net, "build_model", build)
    seen = {}
    for name, pkg in (("port", meters), ("vtm", jax_meters)):
        update = pkg.AVAMeter.update_stats

        def record(meter, preds, ori_boxes, metadata, loss=None, lr=None, name=name, update=update):
            seen.setdefault(name, []).append(len(preds))
            return update(meter, preds, ori_boxes, metadata, loss, lr)

        monkeypatch.setattr(pkg.AVAMeter, "update_stats", record)
    (views, stats), = test_net.test(cfg, device="cpu")
    (_, jstats), = jax_test_net.test(jcfg)
    assert stats["split"] == "test_final" and 0.0 <= stats["map"] <= 1.0
    assert abs(stats["map"] - jstats["map"]) <= MAP_TOL, (stats, jstats)
    assert seen["port"] == seen["vtm"] and len(seen["port"]) == 3  # 8 keyframes at B3
    got, want = (_csv_rows(tmp_path / p / "detections_latest.csv") for p in ("port", "vtm"))
    assert [r[:-1] for r in got] == [r[:-1] for r in want]
    assert max(abs(float(a[-1]) - float(b[-1])) for a, b in zip(got, want)) <= SCORE_TOL
    assert len(got) == sum(seen["port"]) * len(cfg_whitelist(tree))


def cfg_whitelist(tree) -> set:
    from vtm_torch.eval.ava_eval import read_labelmap

    return read_labelmap(str(tree / "annotations" / "labels.pbtxt"))[1]


def test_train_net_matches_vtm(tree, tmp_path, monkeypatch):
    """One epoch of ``train_net.train`` (B2, SGD, the shipped init with the
    final BatchNorms at zero) over the 8 train keyframes, then its val pass
    (the ``sec % 4 == 0`` keyframes): the 4 losses within LOSS_TOL and the
    val mAP within MAP_TOL of ``vtm``'s from the same init; the checkpoint
    written, and an auto-resume that finds the run done."""
    opts = conv_opts("SlowFast", "slowfast", "RESNET.ZERO_INIT_FINAL_BN", "True") + ava_data_opts(tree) + [
        "TRAIN.BATCH_SIZE", "2", "SOLVER.OPTIMIZING_METHOD", "sgd", "SOLVER.BASE_LR", "0.01",
        "SOLVER.MAX_EPOCH", "1", "TRAIN.EVAL_PERIOD", "1", "TRAIN.CHECKPOINT_PERIOD", "1",
        "TRAIN.AUTO_RESUME", "False"]
    cfg, jcfg = cfgs(opts)
    cfg.OUTPUT_DIR, jcfg.OUTPUT_DIR = str(tmp_path / "port"), str(tmp_path / "vtm")
    jcfg.TRAIN.CHECKPOINT_PERIOD = 10  # vtm's checkpoint is not compared: none written
    sd = {k: v.numpy() for k, v in build_model(cfg, "cpu", fp32_params=True).module.state_dict().items()}
    monkeypatch.setattr(jax_train_net, "build_model", _with_weights(*convert_pyslowfast(sd)))
    losses, maps = {}, {}
    for name, pkg in (("port", meters), ("vtm", jax_meters)):
        update, finalize = pkg.AVAMeter.update_stats, pkg.AVAMeter.finalize_metrics

        def record(meter, preds, ori_boxes, metadata, loss=None, lr=None, name=name, update=update):
            if meter.mode == "train":
                losses.setdefault(name, []).append(float(loss))
            return update(meter, preds, ori_boxes, metadata, loss, lr)

        def record_map(meter, log=True, name=name, finalize=finalize):
            stats = finalize(meter, log)
            maps.setdefault(name, []).append((meter.mode, stats["map"]))
            return stats

        monkeypatch.setattr(pkg.AVAMeter, "update_stats", record)
        monkeypatch.setattr(pkg.AVAMeter, "finalize_metrics", record_map)
    random.seed(0)
    module = train_net.train(cfg, device="cpu")
    random.seed(0)
    jax_train_net.train(jcfg)
    assert len(losses["port"]) == len(losses["vtm"]) == 4 and all(np.isfinite(losses["port"]))
    np.testing.assert_allclose(losses["port"], losses["vtm"], rtol=LOSS_TOL)
    assert [m for m, _ in maps["port"]] == ["val"] and 0.0 <= maps["port"][0][1] <= 1.0
    assert abs(maps["port"][0][1] - maps["vtm"][0][1]) <= MAP_TOL, maps
    assert (tmp_path / "port" / "detections_latest.csv").exists()
    assert len(list((tmp_path / "port" / "checkpoints").iterdir())) == 1
    cfg.TRAIN.AUTO_RESUME = True
    again = train_net.train(cfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(module.state_dict().values(), again.state_dict().values()))


@pytest.mark.parametrize("head_classes", [CLASSES, 400])
def test_pyslowfast_checkpoints_load_as_vtm_loads_them(tmp_path, head_classes):
    """A PySlowFast-layout state dict (``module.`` prefixed, with
    ``num_batches_tracked``) of an AVA SlowFast (the ROI head's
    ``head.projection`` at the model's classes) and of a Kinetics one (400
    classes: the head keeps its init, the backbone loads; how upstream
    starts AVA training), through ``load_test_checkpoint`` in both packages
    from the same template: every tensor equal."""
    case = DetCase("slowfast", move=False)
    rng = np.random.default_rng(head_classes)
    upstream = {}
    for k, v in case.state.items():
        a = rng.standard_normal(v.shape).astype(np.float32) if "running_var" not in k else \
            np.exp(rng.standard_normal(v.shape)).astype(np.float32)
        if k == "head.projection.weight":
            a = rng.standard_normal((head_classes, v.shape[1])).astype(np.float32)
        if k == "head.projection.bias":
            a = rng.standard_normal(head_classes).astype(np.float32)
        upstream["module." + k] = torch.from_numpy(a)
        if k.endswith("running_var"):
            upstream["module." + k.replace("running_var", "num_batches_tracked")] = torch.tensor(7)
    path = tmp_path / "upstream.pyth"
    torch.save({"model_state": upstream, "epoch": 3}, path)
    cfg, jcfg = case.cfg, case.jcfg
    cfg.TEST.CHECKPOINT_FILE_PATH = jcfg.TEST.CHECKPOINT_FILE_PATH = str(path)
    bundle = build_model(cfg, "cpu")
    init = {k: v.clone() for k, v in bundle.module.state_dict().items()}
    load_test_checkpoint(cfg, bundle)
    jbundle = jax_build_model(jcfg, init=False)
    jbundle.params, jbundle.batch_stats = convert_pyslowfast({k: v.numpy() for k, v in init.items()})
    jax_load_test_checkpoint(jcfg, jbundle)
    want = pyslowfast_state_dict_from_vtm(np_tree(jbundle.params), np_tree(jbundle.batch_stats))
    got = bundle.module.state_dict()
    assert set(got) == set(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    head_loaded = torch.equal(got["head.projection.weight"], upstream["module.head.projection.weight"])
    assert head_loaded == (head_classes == CLASSES)
    assert torch.equal(got["s1.pathway0_stem.conv.weight"], upstream["module.s1.pathway0_stem.conv.weight"])


@pytest.mark.parametrize("name", ["X3D", "PTVX3D"])
def test_x3d_has_no_detection_head_in_either_package(name):
    """``vtm``'s build initialises a detection model with boxes, which
    X3D's ``__call__`` does not take: TypeError. The port's build raises the
    same type. The PTV CSN and R(2+1)D build functions raise upstream's
    NotImplementedError first (tests/test_torch_ptv.py); PTVSlowFast and
    PTVMViT build their detection heads."""
    cfg, jcfg = cfgs(conv_opts("X3D", "x3d", "MODEL.MODEL_NAME", name, "RESNET.TRANS_FUNC", "x3d_transform",
                               "RESNET.DEPTH", "50"))
    with pytest.raises(TypeError, match="bboxes"):
        jax_build_model(jcfg)
    with pytest.raises(TypeError, match="no detection head"):
        build_model(cfg, "cpu")
    for alias, opts in (("PTVSlowFast", conv_opts("SlowFast", "slowfast")), ("PTVMViT", MVIT_OPTS)):
        cfg, jcfg = cfgs(opts + ["MODEL.MODEL_NAME", alias])
        assert build_model(cfg, "cpu").module.head.__class__.__name__ == "ResNetRoIHead"
        assert jax_build_model(jcfg, init=False).module.spec.detection


def test_without_boxes(tree, tmp_path):
    """A detection model called without boxes raises ValueError in the port
    (``vtm``'s SlowFast falls through to its basic head on the ROI
    projection's weights, ROADMAP.md Queue 3), and so does
    ``model_benchmark``, which calls the model without boxes. Precise
    BatchNorm runs the backbone alone: the statistics of ``vtm``'s pass
    (which runs the basic head, with no BatchNorm) within ``stats_tol``."""
    case = DetCase("slowfast")
    x = _video(2, 8)
    fallthrough = jax.eval_shape(lambda: case.jmodule.apply({"params": case.params, "batch_stats": case.stats},
                                                             jnp.asarray(x))[0])
    assert fallthrough.shape == (2, CLASSES)
    with pytest.raises(ValueError, match="takes the boxes"):
        case.module(torch.from_numpy(x))
    cfg, module, _, _, _ = _mvit_case()
    with pytest.raises(ValueError, match="takes the boxes"):
        module(torch.from_numpy(x[..., :32, :]))
    cfg = case.cfg.clone()
    cfg.merge_from_list(["MODEL_BENCHMARK.ITERATIONS", "1", "MODEL_BENCHMARK.WARMUP_ITERATIONS", "1",
                         "TEST.BATCH_SIZE", "1", "OUTPUT_DIR", str(tmp_path)])
    with pytest.raises(ValueError, match="takes the boxes"):
        mb.model_benchmark(cfg, device="cpu")
    loader = [{"frames": _video(2, s, 32, 32)} for s in (4, 5, 6)]
    want = jax_precise_bn(case.jmodule, case.params, case.stats, loader, 2)
    compute_precise_bn_stats(case.module, loader, 2, torch.device("cpu"))
    want_sd = {k: v.numpy() for k, v in pyslowfast_state_dict_from_vtm({}, np_tree(want)).items()}
    for k, v in case.module.named_buffers():
        assert_close_to_largest(v.numpy(), want_sd[k], stats_tol(k), k)


def test_detection_runs_in_one_process_and_refuses_model_parallel(tree, tmp_path):
    """``TPU.MODEL_PARALLEL`` 2 raises naming item 15 (no cuts for the conv
    families); the entry points size the process group to one process; the
    eval step gives each box its sigmoid row without autograd."""
    cfg, _ = cfgs(conv_opts("SlowFast", "slowfast") + ava_data_opts(tree) + ["TPU.MODEL_PARALLEL", "2",
                                                                             "OUTPUT_DIR", str(tmp_path)])
    with pytest.raises(NotImplementedError, match="item 15"):
        train_net.train(cfg, device="cpu")
    assert train_net._process_batch(cfg) == 1 and test_net._test_batch(cfg) == 1
    case = DetCase("slow")
    scores = make_detection_eval_step(case.module)(torch.from_numpy(_video(2, 1)),
                                                   torch.from_numpy(boxes_for(2, 3, 32, 48, 2)))
    assert scores.shape == (3, CLASSES) and not scores.requires_grad and not case.module.training
    assert bool(((scores > 0) & (scores < 1)).all())
