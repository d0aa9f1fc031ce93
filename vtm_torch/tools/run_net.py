"""Train-then-test entry point of the PyTorch package (port of ``tools/run_net.py``).

    python -m vtm_torch.tools.run_net --cfg CONFIG.yaml --opts KEY VALUE ...

Trains when ``TRAIN.ENABLE`` (``train_net.train``), then tests when
``TEST.ENABLE`` (``test_net.test``). With ``TEST.CHECKPOINT_FILE_PATH``
empty the test takes the last checkpoint the training wrote to
``OUTPUT_DIR``.

``main`` launches each step over the devices its batch can use
(``parallel.launch.run``: ``TRAIN.BATCH_SIZE`` for the training,
``TEST.BATCH_SIZE`` for the test), one process per device.

Runs on the first CUDA device; a machine without one raises. The CPU
(``device="cpu"``, plain versions of the kernels) is for tests only.
"""

from __future__ import annotations

from typing import Optional

import torch

from vtm_torch.config import assert_and_infer_cfg, load_config, parse_args
from vtm_torch.parallel import launch
from vtm_torch.tools.test_net import test
from vtm_torch.tools.train_net import _train, train


def run_net(cfg, device: Optional[torch.device | str] = None):
    """Returns ``test``'s results, or None when ``TEST.ENABLE`` is off."""
    if cfg.TRAIN.ENABLE:
        train(cfg, device)
    if cfg.TEST.ENABLE:
        # NUM_TEMPORAL_CLIPS [-1] sweeps the views; test() expands it
        return test(cfg, device)
    return None


def main():
    args = parse_args()
    for path in args.cfg_files or [None]:
        cfg = load_config(args, path)
        assert_and_infer_cfg(cfg)
        if cfg.TRAIN.ENABLE:
            launch.run(cfg, _train, cfg.TRAIN.BATCH_SIZE)
        if cfg.TEST.ENABLE:
            launch.run(cfg, test, cfg.TEST.BATCH_SIZE)


if __name__ == "__main__":
    main()
