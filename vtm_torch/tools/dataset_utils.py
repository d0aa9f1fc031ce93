"""Dataset subsampling and caching entry point of the PyTorch package (port
of ``tools/dataset_utils.py``), driven by the ``DATASET_UTILS.*`` flags.

    python -m vtm_torch.tools.dataset_utils --cfg CONFIG.yaml --opts DATASET_UTILS.CACHE_MODEL_PROBS True ...

``CACHE_MODEL_PROBS`` runs the model in one process per CUDA device the
test batch can use (``parallel.launch.run``), a data-parallel eval; the
other steps run here, in ``dataset_tools.run``'s order.
"""

from __future__ import annotations

from vtm_torch.analysis import dataset_tools
from vtm_torch.config import assert_and_infer_cfg, load_config, parse_args
from vtm_torch.parallel import launch


def main():
    args = parse_args()
    for path in args.cfg_files or [None]:
        cfg = load_config(args, path)
        assert_and_infer_cfg(cfg)
        steps = cfg.DATASET_UTILS
        if steps.CREATE_MINI_DATASETS:
            dataset_tools.create_mini_datasets(cfg)
        if steps.CACHE_MODEL_PROBS:
            launch.run(cfg, dataset_tools.cache_model_probs, cfg.TEST.BATCH_SIZE)
        if steps.CACHE_KL_DIVERGENCES:
            dataset_tools.cache_kl_divergences(cfg)
        if steps.SAVE_LENGTHS:
            dataset_tools.save_lengths(cfg)


if __name__ == "__main__":
    main()
