"""``train`` under the multigrid short cycle on a tiny SlowFast (whose head
pools globally there) against ``tools/train_net.py::train`` from the same
weights (``test_torch_multigrid.both_train``): the three phases' batches,
learning rates and losses. About 40 s."""

import torch

from torch_conv_cases import tiny_opts
from test_torch_multigrid import TRAIN_OPTS, both_train

torch.set_num_threads(2)


def test_short_cycle_train_matches_vtm(monkeypatch, tmp_path):
    """``train`` under the short cycle on a tiny SlowFast (global head pool),
    one epoch against ``vtm``'s: the three phases' batches (B8 at 16 pixels,
    B4 at 23, B2 at 32), their learning rates and losses."""
    opts = tiny_opts("SlowFast", "slowfast", "RESNET.ZERO_INIT_FINAL_BN", "True", "SLOWFAST.BETA_INV", "2",
                     *TRAIN_OPTS, "SOLVER.LR_POLICY", "cosine", "SOLVER.MAX_EPOCH", "1",
                     "MULTIGRID.SHORT_CYCLE", "True", "MULTIGRID.EPOCH_FACTOR", "1.0")
    _, _, _, port = both_train(monkeypatch, tmp_path, opts)
    assert [s[0] for s in port.shapes[:3]] == [8, 4, 2] and [s[2] for s in port.shapes[:3]] == [16, 23, 32]
