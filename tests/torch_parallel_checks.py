"""What the port's parallel tests share (imported by
``tests/test_torch_parallel*.py``; collects no test itself).

Tiny VideoMAE and ViViT models made by ``vtm`` and moved off its init with
numpy, so that every parameter (biases, class token, positions) is away
from zero; the same weights reach the port's ranks as a state dict inside
the probe's model spec (``vtm_torch/parallel/probes.py``). ``vtm`` then
gives the one-device expected values: logits, the Matchings, the loss,
the gradients (``jax.grad``) and the parameters after one step of its own
``make_train_step``. ``TPCase`` does the same for TimeSformer and
Motionformer (``vtm``'s init) and MViT (the port's seeded init, given to
``vtm`` by its own ``convert_mvit``), with ``vtm``'s forward run eagerly so
that its Matchings are recorded as it makes them, and its step as
``make_train_step``'s: the jitted gradient, then the optimizer's update.

The ranks run on the CPU over gloo with a ``file://`` rendezvous under
the test's ``tmp_path`` (six test workers run at once: no fixed port),
one thread each, every collective bounded by ``TIMEOUT`` and every launch
by ``JOIN_TIMEOUT``.
"""

from __future__ import annotations

import datetime
import itertools

import contextlib
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

import vtm.config as jcfg
import vtm.train.losses as jlosses
import vtm.train.optimizer as jopt
from vtm.checkpoints.convert import convert_motionformer, convert_mvit, convert_timesformer
from vtm.merge import bipartite as jb
from vtm.merge.policy import MergePolicy as JPolicy
from vtm.models import motionformer_approx as japprox
from vtm.models.build import build_model as jax_build_model
from vtm.models.motionformer import Motionformer as JMotionformer
from vtm.models.motionformer import MotionformerConfig as JMotionformerConfig
from vtm.models.timesformer import TimeSformer as JTimeSformer
from vtm.models.timesformer import TimeSformerConfig as JTimeSformerConfig
from vtm.models.videomae import VideoMAE as JVideoMAE
from vtm.models.videomae import VideoMAEConfig as JVideoMAEConfig
from vtm.models.vivit import ViViT as JViViT
from vtm.models.vivit import ViViTConfig as JViViTConfig
from vtm.train.train_step import make_train_step as jax_make_train_step

from vtm_torch.checkpoints.convert import (
    motionformer_state_dict_from_vtm_params,
    mvit_state_dict_from_vtm_params,
    state_dict_from_vtm_params,
    timesformer_state_dict_from_vtm_params,
    vivit_state_dict_from_vtm_params,
)
from vtm_torch.checkpoints import checkpoint as cu
from vtm_torch.config import get_cfg
from vtm_torch.models import build_model
from vtm_torch.parallel.probes import bundle_of, projection_put_in
from vtm_torch.train.optimizer import construct_optimizer
from vtm_torch.parallel.launch import launch_job

TIMEOUT = datetime.timedelta(seconds=120)
JOIN_TIMEOUT = 300.0

# 2 x 4 x 4 tubelets = 32 tokens, merged by 4 a layer; 4 heads, so that tp 2
# leaves 2 a rank
VIDEOMAE = dict(img_size=64, patch_size=16, num_frames=4, tubelet_size=2, embed_dim=32, depth=2,
                num_heads=4, mlp_ratio=2.0, num_classes=7)
VIDEOMAE_POLICY = dict(rs=(4, 4), mode="merge", prop_attn=False)
# 2 x 4 x 4 tubelets + CLS = 33 tokens; proportional attention (the biased path)
VIVIT = dict(image_size=64, num_frames=4, tubelet_size=(2, 16, 16), hidden_size=32, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=64, num_classes=7)
VIVIT_POLICY = dict(rs=(4, 4), mode="merge", prop_attn=True, class_token=True)

LOGITS_TOL = 1e-4  # fp32, as tests/test_parallel.py holds vtm's sharded logits
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4  # of the largest entry of each gradient tensor
# After one AdamW step every element moves by about lr * its layer-decay
# scale whatever its gradient, so an element whose gradient is within
# GRAD_TOL of zero (of its tensor's largest) may move either way in fp32:
# it is held to 2 * lr, at most NEAR_ZERO_SHARE of the elements may be such,
# and every other element to PARAM_TOL.
PARAM_TOL = 1e-5
NEAR_ZERO_SHARE = 0.01
SOLVER = ["SOLVER.OPTIMIZING_METHOD", "adamw", "SOLVER.BASE_LR", "0.001", "SOLVER.LR_POLICY", "cosine",
          "SOLVER.MAX_EPOCH", "4", "SOLVER.COSINE_END_LR", "1e-6", "SOLVER.WEIGHT_DECAY", "0.05",
          "SOLVER.LAYER_DECAY", "0.75", "SOLVER.ZERO_WD_1D_PARAM", "True", "TPU.COMPUTE_DTYPE", "float32"]


def cfgs(*opts):
    """The same options in both packages' configs."""
    t, j = get_cfg(), jcfg.get_cfg()
    t.merge_from_list(list(opts))
    j.merge_from_list(list(opts))
    return t, j


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturbed(params, seed: int):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(np.shape(x))).astype(np.float32), params)


class Case:
    """One family's tiny model in both packages: ``jmodel`` and its numpy
    ``params``, the port's ``spec`` and ``names`` (the port's names for a
    tree shaped like ``params``)."""

    def __init__(self, family: str, seed: int = 0):
        self.family = family
        if family == "VideoMAE":
            self.jmodel = JVideoMAE(config=JVideoMAEConfig(**VIDEOMAE), policy=JPolicy(**VIDEOMAE_POLICY))
            self.arch, policy, self.to_torch = VIDEOMAE, VIDEOMAE_POLICY, state_dict_from_vtm_params
            size, self.depth = VIDEOMAE["img_size"], VIDEOMAE["depth"]
        else:
            self.jmodel = JViViT(config=JViViTConfig(**VIVIT), policy=JPolicy(**VIVIT_POLICY))
            self.arch, policy, self.to_torch = VIVIT, VIVIT_POLICY, vivit_state_dict_from_vtm_params
            size, self.depth = VIVIT["image_size"], VIVIT["num_hidden_layers"]
        self.shape = (self.arch["num_frames"], size, size, 3)
        init = jax.jit(self.jmodel.init)(jax.random.key(seed), jnp.zeros((1, *self.shape), jnp.float32))["params"]
        self.params = _perturbed(_np_tree(init), seed)
        state = {k: v.numpy() for k, v in self.to_torch(self.params).items()}
        self.policy = policy
        self.spec = (family, self.arch, policy, state)

    def named(self, tree) -> dict:
        return {k: v.numpy() for k, v in self.to_torch(_np_tree(tree)).items()}

    def video(self, batch: int, seed: int) -> np.ndarray:
        return np.random.default_rng(seed).standard_normal((batch, *self.shape)).astype(np.float32)

    def labels(self, batch: int, seed: int) -> np.ndarray:
        return np.random.default_rng(seed).integers(0, self.arch["num_classes"], batch)

    def forward(self, video):
        """``vtm``'s logits of ``video`` and the Matchings its forward makes,
        in order, as index arrays (each layer's matching made again from
        the metric the jitted forward captured)."""
        @jax.jit
        def apply(p, v):
            return self.jmodel.apply({"params": p}, v, capture_intermediates=True)

        with jax.default_matmul_precision("highest"):
            (logits, _), inter = apply(self.params, jnp.asarray(video))
            matchings = []
            for i, r in enumerate(self.policy["rs"]):
                block = inter["intermediates"][f"blocks_{i}" if self.family == "VideoMAE" else f"layer_{i}"]
                metric = block["attn" if self.family == "VideoMAE" else "attention"]["__call__"][0][1]
                m = jb.bipartite_soft_matching(metric, r, self.policy.get("class_token", False))
                matchings.append(dict(n=m.n, r=m.r, **{k: np.asarray(getattr(m, k))
                                                       for k in ("unm_idx", "src_idx", "dst_idx")}))
        return np.asarray(logits), matchings

    def step(self, jc, frames, labels):
        """``vtm``'s one-device step on the global batch at epoch 0's
        learning rate: (loss, gradients, parameters after), by port name."""
        def loss_fn(p):
            out, _ = self.jmodel.apply({"params": p}, jnp.asarray(frames))
            return jlosses.cross_entropy(out, jnp.asarray(labels))

        tx, lr_at = jopt.construct_optimizer(jc, self.params, num_layers=self.depth)
        opt_state = tx.init(self.params)
        jopt.set_lr(opt_state, lr_at(0.0))
        step = jax_make_train_step(self.jmodel, tx, "cross_entropy", False)
        with jax.default_matmul_precision("highest"):
            loss, grads = jax.jit(jax.value_and_grad(loss_fn))(self.params)
            after, _, step_loss, _, _ = step(jax.tree_util.tree_map(jnp.asarray, self.params), opt_state,
                                             jnp.asarray(frames), jnp.asarray(labels), jax.random.key(0))
        assert abs(float(loss) - float(step_loss)) <= LOSS_TOL
        return float(loss), self.named(grads), self.named(after), lr_at(0.0)


# the tiny ViTs of the tensor-parallel tests: 4 heads, so that tp 2 leaves 2
# a rank; 2 frames of 2 x 2 patches for TimeSformer (r 1 a frame), 2
# pseudo-frames of 4 for Motionformer (r 1 a pseudo-frame)
TIMESFORMER = dict(img_size=32, patch_size=16, num_classes=5, embed_dim=32, depth=2, num_heads=4, mlp_ratio=2.0,
                   num_frames=2)
MOTIONFORMER = dict(img_size=32, patch_size=16, patch_size_temp=2, num_classes=5, embed_dim=32, depth=2,
                    num_heads=4, mlp_ratio=2.0, temporal_resolution=2)
MERGE_POLICY = dict(rs=(1, 1), mode="merge", prop_attn=True)
# family: (vtm's class, its config, vtm tree -> port names, port state -> vtm tree)
_J_MODELS = {
    "TimeSformer": (JTimeSformer, JTimeSformerConfig, timesformer_state_dict_from_vtm_params,
                    lambda sd, m: convert_timesformer(sd, depth=m.config.depth, num_frames=m.config.num_frames,
                                                      spatial_tokens=m.config.spatial_tokens)),
    "Motionformer": (JMotionformer, JMotionformerConfig, motionformer_state_dict_from_vtm_params,
                     lambda sd, m: convert_motionformer(sd, depth=m.config.depth)),
    "MViT": (None, None, mvit_state_dict_from_vtm_params, lambda sd, m: convert_mvit(sd, depth=m.config.depth)),
}


def _pruned(tree, shapes):
    """``tree`` cut to the keys of ``shapes``, which it must hold."""
    if not isinstance(shapes, dict):
        assert np.shape(tree) == shapes.shape
        return tree
    return {k: _pruned(tree[k], v) for k, v in shapes.items()}


class TPCase:
    """One tiny TimeSformer or Motionformer (``arch``, ``policy``: their
    config and merge keywords) or MViT (``opts``: its config options) in
    both packages, as ``Case`` for VideoMAE and ViViT but from the port's
    seeded init moved off with numpy, given to ``vtm`` by its own
    converter. ``projection``: the Performer projection both packages use
    in place of their draws. ``vtm_opts``: MViT's options for ``vtm``'s
    model where they differ (``vtm``'s ``remat`` does not trace under
    ``MODEL.ACT_CHECKPOINT``, which changes no value)."""

    def __init__(self, family: str, arch: dict = None, policy: dict = None, opts=(), seed: int = 0,
                 projection=None, vtm_opts=None):
        self.family, self.projection = family, projection
        rng = np.random.default_rng(seed)
        if family == "MViT":
            cfg, _ = cfgs(*opts)
            self.cfg = cfg
            _, jc = cfgs(*(opts if vtm_opts is None else vtm_opts))
            port = build_model(cfg, "cpu", fp32_params=True).module
            self.depth, self.train_kw = cfg.MVIT.DEPTH, dict(train=True)
            self.jmodel = jax_build_model(jc, init=False).module
            t, size, self.num_classes = cfg.DATA.NUM_FRAMES, cfg.DATA.TEST_CROP_SIZE, cfg.MODEL.NUM_CLASSES
            self.shape = (t, size, size, 3)
        else:
            self.cfg = None
            jcls, jconfig = _J_MODELS[family][:2]
            port = bundle_of((family, arch, policy, None), None, torch.device("cpu"), fp32_params=True).module
            self.jmodel = jcls(config=jconfig(**arch), policy=JPolicy(**policy))
            frames = arch.get("num_frames") or arch["temporal_resolution"] * arch["patch_size_temp"]
            self.shape = (frames, arch["img_size"], arch["img_size"], 3)
            self.depth, self.num_classes, self.train_kw = arch["depth"], arch["num_classes"], {}
        # moved off the init (the ViTs' by about lecun-normal's scale at width
        # 32: their linear weights start at std 0.02), so that few gradients
        # are near zero by the init's weights
        scale = 0.05 if family == "MViT" else 0.2
        state = {k: (v.numpy() + scale * rng.standard_normal(v.shape)).astype(np.float32)
                 for k, v in port.state_dict().items()}
        self.to_torch = _J_MODELS[family][2]
        shapes = jax.eval_shape(self.jmodel.init, jax.random.key(0), jnp.zeros((1, *self.shape)))["params"]
        # the tree vtm's model has (the converter adds the temporal weights a space-only model lacks)
        self.params = _pruned(_np_tree(_J_MODELS[family][3](state, port)), shapes)
        self.spec = ("cfg", state) if family == "MViT" else (family, arch, policy, state, projection)
        assert sorted(self.named(self.params)) == sorted(state)

    def named(self, tree) -> dict:
        return {k: v.numpy() for k, v in self.to_torch(_np_tree(tree)).items()}

    def video(self, batch: int, seed: int) -> np.ndarray:
        return np.random.default_rng(seed).standard_normal((batch, *self.shape)).astype(np.float32)

    def labels(self, batch: int, seed: int) -> np.ndarray:
        return np.random.default_rng(seed).integers(0, self.num_classes, batch)

    @contextlib.contextmanager
    def _draws(self, seen=None):
        """``vtm``'s Performer given ``projection``; every Matching made
        appended to ``seen`` when given."""
        match, draw = jb._match, japprox.create_projection_matrix

        def recording(*args, **kwargs):
            m = match(*args, **kwargs)
            seen.append(m)
            return m

        if seen is not None:
            jb._match = recording
        if self.projection is not None:
            japprox.create_projection_matrix = lambda m, d, rng: jnp.asarray(self.projection)
        try:
            with jax.default_matmul_precision("highest"):
                yield
        finally:
            jb._match, japprox.create_projection_matrix = match, draw

    def expect(self, jc) -> dict:
        """``vtm``'s side of ``tp_plan`` in one jit: the eval output of
        ``video(2, 1)`` and the Matchings its forward makes, in order, as
        index arrays (the jitted function returns the indices of each
        Matching the eval's trace makes); and the one-device step on
        ``video(2, 2)`` / ``labels(2, 3)`` at epoch 0's learning rate, as
        ``make_train_step`` takes it: (loss, gradients, parameters after,
        lr), by port name. Kept as ``expected``."""
        video, frames, labels = (jnp.asarray(a) for a in (self.video(2, 1), self.video(2, 2), self.labels(2, 3)))
        sizes = []

        def loss_fn(p):
            out, _ = self.jmodel.apply({"params": p}, frames, rngs={"dropout": jax.random.key(0)}, **self.train_kw)
            return jlosses.cross_entropy(out, labels)

        @jax.jit
        def both(p):
            seen = []
            with self._draws(seen):
                out, _ = self.jmodel.apply({"params": p}, video)
            sizes[:] = [(m.n, m.r) for m in seen]
            with self._draws():
                step = jax.value_and_grad(loss_fn)(p)
            return out, [(m.unm_idx, m.src_idx, m.dst_idx) for m in seen], step

        params = jax.tree_util.tree_map(jnp.asarray, self.params)
        tx, lr_at = jopt.construct_optimizer(jc, params, num_layers=self.depth)
        opt_state = tx.init(params)
        jopt.set_lr(opt_state, lr_at(0.0))
        out, indices, (loss, grads) = both(params)
        updates, _ = jax.jit(tx.update)(grads, opt_state, params)
        matchings = [dict(n=n, r=r, **{k: np.asarray(a) for k, a in zip(("unm_idx", "src_idx", "dst_idx"), idx)})
                     for (n, r), idx in zip(sizes, indices)]
        self.expected = dict(logits=np.asarray(out), matchings=matchings,
                             step=(float(loss), self.named(grads), self.named(optax.apply_updates(params, updates)),
                                   lr_at(0.0)))
        return self.expected


def launch_during(cfg, fn, tmp_path, ranks: int, args: tuple, work, more=()):
    """``launch(cfg, fn, tmp_path, ranks, *args)`` while this process runs
    ``work()`` (the ranks are processes of their own): (the ranks' results,
    what ``work`` returns). ``more``: further (cfg, fn, tmp_path, ranks,
    args) launches at the same time, whose results follow the first's."""
    out = {}

    def run(i, spec):
        try:
            out[i] = launch(spec[0], spec[1], spec[2], spec[3], *spec[4])
        except BaseException as e:  # raised again in the caller
            out[f"error {i}"] = e

    threads = [threading.Thread(target=run, args=(i, spec))
               for i, spec in enumerate([(cfg, fn, tmp_path, ranks, args), *more])]
    for thread in threads:
        thread.start()
    try:
        done = work()
    finally:
        for thread in threads:
            thread.join()
    errors = [v for k, v in out.items() if str(k).startswith("error")]
    if errors:
        raise errors[0]
    if not more:
        return out[0], done
    return [out[i] for i in range(len(threads))], done


def assert_matchings_equal(got: list, want: list, what: str) -> None:
    """Two lists of recorded Matchings (index arrays), a rank's against
    another rank's or ``vtm``'s."""
    assert len(got) == len(want) > 0, (what, len(got), len(want))
    for i, (a, b) in enumerate(zip(got, want)):
        assert (a is None) == (b is None), (what, i)
        if a is None:
            continue
        assert (a["n"], a["r"]) == (b["n"], b["r"]), (what, i)
        for k in ("unm_idx", "src_idx", "dst_idx"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what}: matching {i} {k}")


def assert_step_matches(result: dict, want, noise=(), unused=()) -> None:
    """A rank's ``train_probe`` result against ``Case.step``'s: the global
    loss, every gradient within GRAD_TOL of its tensor's largest (the
    names in ``noise`` are zero analytically: rounding noise in both, held
    below 1e-6 of the largest gradient), every parameter within PARAM_TOL
    but for near-zero gradients (see PARAM_TOL). ``unused`` names
    parameters with rows the forward never reads (Motionformer's
    ``proj_kv`` v half under the reference's v=x): there an element whose
    gradient is exactly zero in both packages is not a near-zero one."""
    loss, grads, after, lr = want
    assert abs(result["loss"] - loss) <= LOSS_TOL, (result["loss"], loss)
    assert sorted(result["grads"]) == sorted(grads)
    largest = max(np.abs(g).max() for g in grads.values())
    flagged = total = 0
    for name, g in grads.items():
        got = result["grads"][name]
        if any(n in name for n in noise):
            assert max(np.abs(got).max(), np.abs(g).max()) <= 1e-6 * largest, name
            near = np.ones(g.shape, bool)
        else:
            np.testing.assert_allclose(got, g, rtol=0, atol=GRAD_TOL * np.abs(g).max(), err_msg=name)
            near = np.abs(g) <= GRAD_TOL * np.abs(g).max()
            if any(n in name for n in unused):
                near &= (g != 0) | (got != 0)
            flagged += int(near.sum())
        total += g.size
        atol = np.where(near, max(PARAM_TOL, 2 * lr), PARAM_TOL)
        err = np.abs(result["state"][name] - after[name])
        assert (err <= atol).all(), (name, float(err.max()))
    assert flagged <= NEAR_ZERO_SHARE * total, (flagged, total)


_LAUNCHES = itertools.count()


def launch(cfg, fn, tmp_path, ranks: int, *args):
    """``fn(cfg, "cpu", *args)`` on ``ranks`` CPU ranks over gloo (a fresh
    rendezvous file each time)."""
    return launch_job(cfg, fn, ["cpu"] * ranks, backend="gloo", args=args,
                      init_method=f"file://{tmp_path}/rendezvous_{next(_LAUNCHES)}", timeout=TIMEOUT,
                      join_timeout=JOIN_TIMEOUT, num_threads=1)


def tp_plan(case, cfg, out_dir: str, seed=None) -> list:
    """One case's probes for ``run_probes``: an eval forward of a batch of 2
    (drawing from a generator of ``seed`` when given), one train step of
    another batch of 2 saving its checkpoint and its whole gradients under
    ``out_dir``, and an eval forward of the first batch on a cut model
    loaded from that checkpoint."""
    video, frames, labels = case.video(2, 1), case.video(2, 2), case.labels(2, 3)
    path = os.path.abspath(os.path.join(cu.checkpoint_dir(out_dir), "epoch_00000.pyth"))
    os.makedirs(out_dir, exist_ok=True)
    return [("eval", cfg, (case.spec, video), dict(seed=seed)),
            ("train", cfg, (case.spec, frames, labels),
             dict(checkpoint_dir=out_dir, grads_file=os.path.join(out_dir, "grads.pt"))),
            ("eval", cfg, (case.spec, video), dict(checkpoint=path))]


def assert_cuts_halved(result: dict, whole: dict, ways: int = 2) -> None:
    """Every cut parameter a ``ways``-th of the whole one along one axis."""
    assert result["cut_shapes"], "nothing was cut"
    for name, shape in result["cut_shapes"].items():
        full = whole[name].shape
        assert sum(a != b for a, b in zip(shape, full)) == 1, (name, shape, full)
        assert all(a in (b, b // ways) for a, b in zip(shape, full)), (name, shape, full)


def assert_tp_eval(ranks: list, case, ways: int = 2) -> None:
    """Each rank's first eval of ``tp_plan`` against ``vtm`` (``case.expect``):
    the output within LOGITS_TOL, its Matchings equal to ``vtm``'s and to
    rank 0's, every cut a ``ways``-th of its whole parameter, the same cuts
    in every probe."""
    want_logits, want_matchings = case.expected["logits"], case.expected["matchings"]
    whole = case.named(case.params)
    for r, (ev, tr, again) in enumerate(ranks):
        np.testing.assert_allclose(ev["logits"].numpy(), want_logits, rtol=0, atol=LOGITS_TOL)
        assert len(ev["matchings"]) == len(want_matchings)
        if want_matchings:
            assert_matchings_equal(ev["matchings"], want_matchings, f"rank {r} eval vs vtm")
        assert_cuts_halved(ev, whole, ways)
        assert ev["cut_shapes"] == tr["cut_shapes"] == again["cut_shapes"]


def assert_tp_step(ranks: list, case, noise=(), unused=()) -> None:
    """Each rank's step of ``tp_plan`` as ``vtm``'s (``assert_step_matches``:
    ``noise`` names the gradients that are zero analytically, ``unused``
    the parameters with rows never read), its Matchings equal on every
    rank; the gradients rank 0 saved are those it returned."""
    out_dir = os.path.dirname(os.path.dirname(ranks[0][1]["checkpoint"]))
    saved = torch.load(os.path.join(out_dir, "grads.pt"), weights_only=True)
    assert saved.keys() == ranks[0][1]["grads"].keys()
    for name, g in saved.items():
        np.testing.assert_array_equal(g.numpy(), ranks[0][1]["grads"][name], err_msg=name)
    want_step = case.expected["step"]
    for r, (_, tr, _) in enumerate(ranks):
        if tr["matchings"]:
            assert_matchings_equal(tr["matchings"], ranks[0][1]["matchings"], f"rank {r} step vs rank 0")
        assert_step_matches(tr, want_step, noise, unused)


def assert_tp_checkpoint(ranks: list, case, cfg, noise=()) -> None:
    """The checkpoint of ``tp_plan``'s step holds the whole model and its
    moments (zero only where ``noise`` names a gradient zero
    analytically): loaded into the cut ranks it gives each the same output;
    one process loads it whole, gives that output and holds the ranks'
    parameters."""
    first = ranks[0]
    for _, tr, again in ranks:
        np.testing.assert_array_equal(again["logits"].numpy(), first[2]["logits"].numpy())
    cfg = cfg.clone()
    cfg.TPU.MODEL_PARALLEL = 1
    one = bundle_of(case.spec, cfg, torch.device("cpu"), fp32_params=True).module
    optimizer, _ = construct_optimizer(cfg, one, num_layers=case.depth)
    assert cu.load_checkpoint(first[1]["checkpoint"], one, optimizer) == (0, True)
    moments = {id(p): optimizer.state[p]["exp_avg"] for p in one.parameters()}
    for name, p in one.named_parameters():
        assert any(n in name for n in noise) or moments[id(p)].abs().sum() > 0, name
        np.testing.assert_array_equal(p.detach().numpy(), first[1]["state"][name], err_msg=name)
    with torch.inference_mode(), projection_put_in(case.spec):
        got = one.eval()(torch.from_numpy(case.video(2, 1)))[0].numpy()
    np.testing.assert_allclose(got, first[2]["logits"].numpy(), rtol=0, atol=LOGITS_TOL)
