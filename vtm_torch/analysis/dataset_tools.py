"""Dataset caching / subsampling tools (copy of
``vtm/analysis/dataset_tools.py``), driven by the ``DATASET_UTILS.*``
config flags.

  * create_mini_datasets — 1-clip-per-class subsets of K400/SSv2/EPIC
  * cache_model_probs    — softmax predictions of a model over the test
                           set, saved as ``<ckpt>_distributions.npz``
  * cache_kl_divergences — pairwise KL matrices over those
                           distributions, diag=inf, saved as
                           ``<ckpt>_kl_divergences.npz``
  * save_lengths / load_lengths — per-video durations via ffprobe (or
                           EPIC timestamps) to ``*_lengths.csv``

Artifacts are numpy ``.npz``, as ``vtm`` writes them.
``cache_model_probs`` (and ``run``) forward the test set through
``vtm_torch``'s model on the first CUDA device unless given
``device="cpu"``.
"""

from __future__ import annotations

import datetime
import json
import os
import subprocess
from typing import Optional

import numpy as np
import torch

from vtm_torch.eval.metrics import softmax
from vtm_torch.utils.logging import get_logger

logger = get_logger(__name__)


def _ckpt_stem(cfg) -> str:
    return os.path.basename(cfg.TEST.CHECKPOINT_FILE_PATH).split(".")[0]


def _dist_path(cfg) -> str:
    return os.path.join(
        cfg.DATASET_UTILS.DISTRIBUTION_PATH, f"{_ckpt_stem(cfg)}_distributions.npz"
    )


def _kl_path(cfg) -> str:
    return os.path.join(
        cfg.DATASET_UTILS.DISTRIBUTION_PATH, f"{_ckpt_stem(cfg)}_kl_divergences.npz"
    )


# ------------------------------------------------------------ mini datasets


def create_mini_datasets(cfg):
    """One clip per class (reference dataset_utils.py:209-253), written
    next to the source annotations in a ``Mini-`` sibling directory."""
    import pandas as pd

    if cfg.TEST.DATASET == "kinetics":
        df = pd.read_csv(
            f"{cfg.DATA.PATH_TO_DATA_DIR}/test.csv",
            names=["video", "label"],
            sep=r"\s+",
        )
        df = df.groupby("label", group_keys=False).head(1)
        out = _mini_dir(cfg.DATA.PATH_TO_DATA_DIR)
        df.to_csv(f"{out}/test.csv", sep=" ", header=False, index=False)
        logger.info("mini kinetics: %d clips -> %s", len(df), out)
    elif cfg.TEST.DATASET == "ssv2":
        with open(
            f"{cfg.DATA.PATH_TO_DATA_DIR}/something-something-v2-validation.json"
        ) as f:
            records = json.load(f)
        with open(
            f"{cfg.DATA.PATH_TO_DATA_DIR}/something-something-v2-labels.json"
        ) as f:
            labels = json.load(f)
        seen, keep = set(), []
        for rec in records:
            lab = labels[rec["template"].replace("[", "").replace("]", "")]
            if lab not in seen:
                seen.add(lab)
                keep.append(rec)
        out = _mini_dir(cfg.DATA.PATH_TO_DATA_DIR)
        with open(f"{out}/something-something-v2-validation.json", "w") as f:
            json.dump(keep, f)
        frame_df = pd.read_csv(f"{cfg.DATA.PATH_TO_DATA_DIR}/val.csv", sep=" ")
        ids = {int(r["id"]) for r in keep}
        frame_df = frame_df[frame_df["original_vido_id"].isin(ids)]
        frame_df.to_csv(f"{out}/val.csv", sep=" ", index=False)
        logger.info("mini ssv2: %d clips -> %s", len(keep), out)
    elif cfg.TEST.DATASET == "epickitchens":
        df = pd.read_pickle(
            f"{cfg.EPICKITCHENS.ANNOTATIONS_DIR}/EPIC_100_validation.pkl"
        ).reset_index()
        df_verb = df.groupby("verb_class", group_keys=False).head(1)
        df_noun = df.groupby("noun_class", group_keys=False).head(1)
        mini = pd.concat([df_verb, df_noun]).set_index("narration_id")
        out = _mini_dir(cfg.EPICKITCHENS.ANNOTATIONS_DIR)
        mini.to_pickle(f"{out}/EPIC_100_validation.pkl")
        logger.info("mini epickitchens: %d clips -> %s", len(mini), out)
    else:
        raise ValueError(f"unsupported TEST.DATASET {cfg.TEST.DATASET!r}")


def _mini_dir(path: str) -> str:
    parts = path.rstrip("/").split("/")
    parts[-1] = f"Mini-{parts[-1]}"
    out = "/".join(parts)
    os.makedirs(out, exist_ok=True)
    return out


# ------------------------------------------------------- model predictions


def cache_model_probs(cfg, device: Optional[torch.device | str] = None):
    """Forward the test split through the model, cache softmax probs
    (reference dataset_utils.py:255-286). EPIC saves (verb, noun). Under a
    process group it is a data-parallel eval, as in ``vtm``: each rank
    forwards its rows of each batch, the probabilities are gathered in row
    order and rank 0 writes the file."""
    from vtm_torch.checkpoints.checkpoint import load_test_checkpoint
    from vtm_torch.data import construct_loader
    from vtm_torch.models import build_model
    from vtm_torch.parallel.mesh import entry_device, gather_rows, make_mesh
    from vtm_torch.tools.train_net import _host
    from vtm_torch.train.train_step import make_eval_step

    device = entry_device(device, "cache_model_probs", cfg.TEST.BATCH_SIZE)
    mesh = make_mesh(device_type=device.type)  # every batch padded to the data width
    bundle = load_test_checkpoint(cfg, build_model(cfg, device))
    eval_step = make_eval_step(bundle.module)
    loader = construct_loader(cfg, "test", mesh.data_rank, mesh.data)

    is_epic = cfg.TEST.DATASET == "epickitchens"
    verb_list, noun_list, prob_list = [], [], []
    for batch in loader:
        logits = eval_step(torch.as_tensor(np.asarray(batch["frames"]), device=device))
        logits = gather_rows(mesh, logits, batch)[0] if mesh.data > 1 else _host(logits)
        if is_epic:
            verb_list.append(softmax(logits[0]))
            noun_list.append(softmax(logits[1]))
        else:
            prob_list.append(softmax(logits))

    if mesh.rank != 0:
        return
    os.makedirs(cfg.DATASET_UTILS.DISTRIBUTION_PATH, exist_ok=True)
    if is_epic:
        np.savez(
            _dist_path(cfg),
            verb=np.concatenate(verb_list),
            noun=np.concatenate(noun_list),
        )
    else:
        np.savez(_dist_path(cfg), probs=np.concatenate(prob_list))
    logger.info("cached distributions -> %s", _dist_path(cfg))


# ------------------------------------------------------------ KL matrices


def pairwise_kl(probs: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    """[N, C] -> [N, N] with KL(P_i || P_j); diagonal = inf
    (reference dataset_utils.py:289-317)."""
    logp = np.log(np.clip(probs, eps, None))
    # KL(i,j) = sum_c p_i (log p_i - log p_j) = H_neg(i) - p_i @ log p_j
    self_term = (probs * logp).sum(axis=1)  # [N]
    cross = probs @ logp.T  # [N, N]
    kl = self_term[:, None] - cross
    np.fill_diagonal(kl, np.inf)
    return kl


def cache_kl_divergences(cfg):
    data = np.load(_dist_path(cfg))
    if "probs" in data:
        out = {"kl": pairwise_kl(data["probs"])}
    else:
        out = {
            "verb": pairwise_kl(data["verb"]),
            "noun": pairwise_kl(data["noun"]),
        }
    np.savez(_kl_path(cfg), **out)
    logger.info("cached KL divergences -> %s", _kl_path(cfg))


def load_kl_divergences(cfg):
    """(verb, noun) matrices for KLSimilarityEpickitchens."""
    data = np.load(_kl_path(cfg))
    if "kl" in data:
        return (data["kl"], data["kl"])
    return (data["verb"], data["noun"])


# ---------------------------------------------------------- video lengths


def _ffprobe_duration(path: str) -> float:
    out = subprocess.check_output(
        ["ffprobe", "-v", "quiet", "-of", "csv=p=0",
         "-show_entries", "format=duration", path],
        text=True,
    )
    return float(out.strip())


def save_lengths(cfg):
    """Per-video durations to csv (reference dataset_utils.py:320-348)."""
    import pandas as pd

    if cfg.TEST.DATASET == "kinetics":
        df = pd.read_csv(
            f"{cfg.DATA.PATH_TO_DATA_DIR}/test.csv", names=["video", "class"], sep=r"\s+"
        )
        rows = [
            (v, _ffprobe_duration(f"{cfg.DATA.PATH_PREFIX}{v}"))
            for v in df["video"]
        ]
        out = f"{cfg.DATA.PATH_TO_DATA_DIR}/kinetics_lengths.csv"
    elif cfg.TEST.DATASET == "ssv2":
        df = pd.read_csv(f"{cfg.DATA.PATH_TO_DATA_DIR}/val.csv", sep=r"\s+")
        rows = [
            (v, _ffprobe_duration(f"{cfg.DATA.PATH_TO_DATA_DIR}/videos/{v}.webm"))
            for v in df["original_vido_id"].unique()
        ]
        out = f"{cfg.DATA.PATH_TO_DATA_DIR}/ssv2_lengths.csv"
    elif cfg.TEST.DATASET == "epickitchens":
        df = pd.read_pickle(
            f"{cfg.EPICKITCHENS.ANNOTATIONS_DIR}/EPIC_100_validation.pkl"
        )
        fmt = "%H:%M:%S.%f"
        rows = [
            (
                name,
                (
                    datetime.datetime.strptime(r["stop_timestamp"], fmt)
                    - datetime.datetime.strptime(r["start_timestamp"], fmt)
                ).total_seconds(),
            )
            for name, r in df.iterrows()
        ]
        out = f"{cfg.EPICKITCHENS.ANNOTATIONS_DIR}/epickitchens_lengths.csv"
    else:
        raise ValueError(f"unsupported TEST.DATASET {cfg.TEST.DATASET!r}")
    pd.DataFrame(rows, columns=["video", "length"]).to_csv(out, index=False)
    logger.info("saved lengths -> %s", out)


def load_lengths(cfg):
    import pandas as pd

    if cfg.TEST.DATASET == "kinetics":
        return pd.read_csv(f"{cfg.DATA.PATH_TO_DATA_DIR}/kinetics_lengths.csv")
    if cfg.TEST.DATASET == "ssv2":
        return pd.read_csv(f"{cfg.DATA.PATH_TO_DATA_DIR}/ssv2_lengths.csv")
    return pd.read_csv(f"{cfg.EPICKITCHENS.ANNOTATIONS_DIR}/epickitchens_lengths.csv")


# ------------------------------------------------------------------- main


def run(cfg, device: Optional[torch.device | str] = None):
    if cfg.DATASET_UTILS.CREATE_MINI_DATASETS:
        create_mini_datasets(cfg)
    if cfg.DATASET_UTILS.CACHE_MODEL_PROBS:
        cache_model_probs(cfg, device)
    if cfg.DATASET_UTILS.CACHE_KL_DIVERGENCES:
        cache_kl_divergences(cfg)
    if cfg.DATASET_UTILS.SAVE_LENGTHS:
        save_lengths(cfg)
