"""Training and the entry points of the port's MViT on the CPU, tiny
(``torch_mvit_cases``): a train step against ``vtm``'s at rate 0 (loss,
every gradient, the parameter groups of ``MVIT.ZERO_DECAY_POS_CLS`` and layer
decay); ``MODEL.ACT_CHECKPOINT`` against the plain stack bit for bit with
drop path and dropout on; and ``test_net``, ``train_net`` (one tiny epoch,
as ``tests/test_mvit.py:110-150``), a checkpoint reload and
``model_benchmark``. About 25 s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtm.train import optimizer as jopt

from vtm_torch.checkpoints import checkpoint as cu
from vtm_torch.checkpoints.convert import mvit_state_dict_from_vtm_params
from vtm_torch.models import build_model, mvit
from vtm_torch.ops import flash_attention
from vtm_torch.tools import model_benchmark, test_net, train_net

from torch_conv_cases import cfgs
from torch_mvit_cases import V2, Case, grad_errors, mvit_opts

torch.set_num_threads(2)

# fp32 gradients of one train step against vtm's, of each tensor's largest
# entry (measured 3.1e-6 at most)
STEP_GRAD_TOL = 2e-5
SOLVER = ("SOLVER.OPTIMIZING_METHOD", "adamw", "SOLVER.WEIGHT_DECAY", "0.05", "SOLVER.LAYER_DECAY", "0.75",
          "SOLVER.BASE_LR", "0.001")


def test_train_step_matches_vtm():
    """v2 with a class token, rate 0, fp32: ``train_net``'s step (cross
    entropy on the train-mode logits, AdamW) against ``jax.value_and_grad``
    of ``vtm``'s: the loss, every gradient (captured as the step computes
    it), and each parameter's weight decay and layer-decay scale against
    ``vtm``'s ``_is_zero_wd`` and ``_layer_id`` (the position tables,
    ``rel_pos_*`` and ``cls_token`` without decay)."""
    case = Case(*V2, "MVIT.USE_MEAN_POOLING", "False", *SOLVER, fp32_params=True)
    trainer = train_net.build_trainer(case.cfg, "cpu")
    module = trainer.module
    for k, v in module.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), case.state[k], err_msg=k)
    x = case.video(4, seed=6)
    labels = np.array([1, 5, 0, 6])
    grads = {}
    hooks = [p.register_hook(lambda g, k=k: grads.__setitem__(k, g.detach().numpy().copy()))
             for k, p in module.named_parameters()]
    try:
        loss, _, _ = trainer.train_step(torch.from_numpy(x), torch.from_numpy(labels), torch.Generator())
    finally:
        for h in hooks:
            h.remove()
    jmodule = case.jbundle.module

    def jax_loss(p):
        logits, _ = jmodule.apply({"params": p}, jnp.asarray(x), train=True)
        return -jnp.take_along_axis(jax.nn.log_softmax(logits), jnp.asarray(labels)[:, None], axis=1).mean()

    want_loss, want = jax.jit(jax.value_and_grad(jax_loss))(case.params)
    want = {k: v.numpy() for k, v in mvit_state_dict_from_vtm_params(jax.tree_util.tree_map(np.asarray, want)).items()}
    assert abs(float(loss) - float(want_loss)) <= 1e-6 * abs(float(want_loss))
    errs = grad_errors(grads, want)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= STEP_GRAD_TOL, (worst, errs[worst])

    depth = case.cfg.MVIT.DEPTH
    flat = jax.tree_util.tree_flatten_with_path(case.params)[0]
    tree = jax.tree_util.tree_structure(case.params)

    def per_param(fn):
        values = [np.full(np.shape(x), float(fn(p, x)), np.float64) for p, x in flat]
        return {k: float(v.flatten()[0]) for k, v in
                mvit_state_dict_from_vtm_params(jax.tree_util.tree_unflatten(tree, values)).items()}

    jwd = per_param(lambda p, x: 0.0 if jopt._is_zero_wd(case.jcfg, p, x) else 0.05)
    jscale = per_param(lambda p, x: 0.75 ** (depth + 1 - jopt._layer_id(p, depth)))
    group_of = {id(p): g for g in trainer.optimizer.param_groups for p in g["params"]}
    named = dict(module.named_parameters())
    assert set(named) == set(jwd)
    for k, p in named.items():
        g = group_of[id(p)]
        assert g["weight_decay"] == jwd[k] and g["lr_scale"] == pytest.approx(jscale[k], rel=1e-6), k
    assert {k for k in named if jwd[k] == 0.0} >= {"cls_token", "blocks.0.attn.rel_pos_h", "blocks.2.attn.rel_pos_t"}


def test_act_checkpoint_equals_plain_stack_bit_for_bit(monkeypatch):
    """``MODEL.ACT_CHECKPOINT``: every block under
    ``torch.utils.checkpoint`` (which must run), with drop path 0.3 and
    dropout 0.2 drawn from one generator: the loss and every gradient equal
    the plain stack's bit for bit."""
    opts = mvit_opts(*V2, "MVIT.DROPPATH_RATE", "0.3", "MODEL.DROPOUT_RATE", "0.2")
    calls = []
    real = mvit.checkpoint
    monkeypatch.setattr(mvit, "checkpoint", lambda *a, **k: calls.append(1) or real(*a, **k))
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((4, 4, 32, 32, 3)).astype(np.float32))
    out = []
    for on in ("False", "True"):
        cfg, _ = cfgs(opts + ["MODEL.ACT_CHECKPOINT", on])
        module = build_model(cfg, "cpu", fp32_params=True).module.train()
        loss = module(x, generator=torch.Generator().manual_seed(4))[0].square().mean()
        loss.backward()
        out.append((loss.detach(), {k: p.grad for k, p in module.named_parameters()}))
    assert len(calls) == 4  # the checkpointed stack's four blocks
    (loss_a, grads_a), (loss_b, grads_b) = out
    assert torch.equal(loss_a, loss_b)
    assert all(torch.equal(grads_a[k], grads_b[k]) for k in grads_a)
    cfg, _ = cfgs(opts)
    plain = build_model(cfg, "cpu", fp32_params=True).module.train()
    with torch.no_grad():  # another seed draws other masks: the masks are live
        assert not torch.equal(plain(x, generator=torch.Generator().manual_seed(5))[0].square().mean(), loss_a)


def _entry_opts(tmp_path, *extra):
    return mvit_opts(*V2, "TRAIN.DATASET", "synthetic", "TEST.DATASET", "synthetic", "TRAIN.BATCH_SIZE", "8",
                     "TEST.BATCH_SIZE", "4", "SOLVER.MAX_EPOCH", "1", "SOLVER.OPTIMIZING_METHOD", "adamw",
                     "TRAIN.EVAL_PERIOD", "1", "TRAIN.CHECKPOINT_PERIOD", "1", "MVIT.DROPPATH_RATE", "0.1",
                     "MODEL.DROPOUT_RATE", "0.5", "DATA_LOADER.NUM_WORKERS", "0", "TRAIN.AUTO_RESUME", "False",
                     "TEST.NUM_ENSEMBLE_VIEWS", "1", "TEST.NUM_SPATIAL_CROPS", "1", "LOG_MODEL_INFO", "False",
                     "MODEL_BENCHMARK.ITERATIONS", "2", "MODEL_BENCHMARK.WARMUP_ITERATIONS", "1",
                     "OUTPUT_DIR", str(tmp_path), *extra)


def test_entry_points_run_mvit(tmp_path):
    """``test_net.test`` on 4 synthetic clips (top-1 in the stats),
    ``train_net.train`` for one epoch of 16 (drop path 0.1, dropout 0.5, an
    eval epoch, a checkpoint whose weights are the trained module's), then
    ``test_net`` again (it tests that checkpoint) and ``model_benchmark``:
    no attention kernel is launched."""
    cfg, _ = cfgs(_entry_opts(tmp_path / "test"))
    stats = test_net.test(cfg, device="cpu")[0][1]
    assert "top1_acc" in stats and np.isfinite(float(stats["top1_acc"]))
    cfg, _ = cfgs(_entry_opts(tmp_path))
    before = flash_attention.LAUNCHES
    module = train_net.train(cfg, device="cpu")
    path = cu.get_last_checkpoint(str(tmp_path))
    saved = torch.load(path, map_location="cpu", weights_only=True)["model_state"]
    for k, v in module.state_dict().items():
        assert torch.equal(saved[k], v), k
    assert "top1_acc" in test_net.test(cfg, device="cpu")[0][1]
    stats = model_benchmark.model_benchmark(cfg, device="cpu")
    assert stats["clips_per_sec"] > 0 and stats["attention_kernel_launches"] == 0
    assert flash_attention.LAUNCHES == before
