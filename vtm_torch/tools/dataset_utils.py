"""Dataset subsampling and caching entry point of the PyTorch package (port
of ``tools/dataset_utils.py``), driven by the ``DATASET_UTILS.*`` flags.

    python -m vtm_torch.tools.dataset_utils --cfg CONFIG.yaml --opts DATASET_UTILS.CACHE_MODEL_PROBS True ...

``CACHE_MODEL_PROBS`` runs the model on the first CUDA device.
"""

from __future__ import annotations

from vtm_torch.analysis import dataset_tools
from vtm_torch.config import assert_and_infer_cfg, load_config, parse_args


def main():
    args = parse_args()
    for path in args.cfg_files or [None]:
        cfg = load_config(args, path)
        assert_and_infer_cfg(cfg)
        dataset_tools.run(cfg)


if __name__ == "__main__":
    main()
