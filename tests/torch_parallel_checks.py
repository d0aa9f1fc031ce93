"""What the port's parallel tests share (imported by
``tests/test_torch_parallel*.py``; collects no test itself).

Tiny VideoMAE and ViViT models made by ``vtm`` and moved off its init with
numpy, so that every parameter (biases, class token, positions) is away
from zero; the same weights reach the port's ranks as a state dict inside
the probe's model spec (``vtm_torch/parallel/probes.py``). ``vtm`` then
gives the one-device expected values: logits, the Matchings, the loss,
the gradients (``jax.grad``) and the parameters after one step of its own
``make_train_step``.

The ranks run on the CPU over gloo with a ``file://`` rendezvous under
the test's ``tmp_path`` (six test workers run at once: no fixed port),
one thread each, every collective bounded by ``TIMEOUT`` and every launch
by ``JOIN_TIMEOUT``.
"""

from __future__ import annotations

import datetime
import itertools

import jax
import jax.numpy as jnp
import numpy as np

import vtm.config as jcfg
import vtm.train.losses as jlosses
import vtm.train.optimizer as jopt
from vtm.merge import bipartite as jb
from vtm.merge.policy import MergePolicy as JPolicy
from vtm.models.videomae import VideoMAE as JVideoMAE
from vtm.models.videomae import VideoMAEConfig as JVideoMAEConfig
from vtm.models.vivit import ViViT as JViViT
from vtm.models.vivit import ViViTConfig as JViViTConfig
from vtm.train.train_step import make_train_step as jax_make_train_step

from vtm_torch.checkpoints.convert import state_dict_from_vtm_params, vivit_state_dict_from_vtm_params
from vtm_torch.config import get_cfg
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


def assert_step_matches(result: dict, want, noise=()) -> None:
    """A rank's ``train_probe`` result against ``Case.step``'s: the global
    loss, every gradient within GRAD_TOL of its tensor's largest (the
    names in ``noise`` are zero analytically: rounding noise in both, held
    below 1e-6 of the largest gradient), every parameter within PARAM_TOL
    but for near-zero gradients (see PARAM_TOL)."""
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
