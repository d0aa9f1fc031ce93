"""The port's merge visualisation, analysis tools and examples against the
JAX package's, on the CPU: the same PNG bytes from the same sources, the
same spliced clips under the same seeds, the same cached distributions,
KL matrices, mini datasets and lengths, and the examples run end to end
(VideoMAE's sheet byte for byte against ``examples/videomae_example.py``
from one checkpoint file)."""

import io
import pathlib
import sys

import jax  # noqa: F401  (the JAX package's CPU setup first, as the other parity tests do)
import numpy as np
import pandas as pd
import pytest
import torch

import vtm.analysis.dataset_tools as jdt
import vtm.analysis.splicing as jsp
import vtm.vis.vis as jvis
from vtm.config import get_cfg as jax_get_cfg
from vtm_torch.analysis import dataset_tools as tdt
from vtm_torch.analysis import splicing as tsp
from vtm_torch.config import get_cfg
from vtm_torch.examples import (
    clip_splicing_example,
    layer_duplication_example,
    timesformer_example,
    videomae_example,
    vivit_example,
)
from vtm_torch.merge import bipartite as tb
from vtm_torch.vis import vis as tvis

import test_torch_test_net as tnt

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _png(img) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


def _source(seed, n0, steps, class_token=False, threshold=None, batch=1):
    """A 0/1 source [batch, n, n0] from merges of random metrics, the port's
    functions (the hybrid threshold leaves empty rows)."""
    rng = np.random.default_rng(seed)
    source, n = None, n0
    for r in steps:
        x = torch.zeros((batch, n, 1))
        m = tb.bipartite_soft_matching(torch.from_numpy(rng.standard_normal((batch, n, 4)).astype(np.float32)),
                                       r, class_token)
        t = None if threshold is None else float(m.src_score.median())
        source = tb.merge_source(m, x, source, threshold=t)
        n -= m.r
    return source.numpy()


def _video(seed, t, h, w):
    return np.random.default_rng(seed).random((t, 3, h, w))


@pytest.mark.parametrize("class_token", [True, False])
def test_image_visualization_same_png(class_token):
    img_arr = (np.random.default_rng(0).random((64, 48, 3)) * 255).astype(np.uint8)
    from PIL import Image

    img = Image.fromarray(img_arr)
    source = _source(1, 12 + class_token, (3, 2), class_token)
    assert _png(tvis.make_visualization(img, source, 16, class_token)) == _png(
        jvis.make_visualization(img, source, 16, class_token))


@pytest.mark.parametrize("average_colour", [True, False])
def test_spatial_video_visualization_same_png(average_colour):
    video = _video(2, 4, 32, 48)
    source = _source(3, 6, (2,), batch=2)  # two frame groups of 2 frames, 6 patches each
    got = tvis.make_spatial_video_visualization(video, source, (16, 16, 2), False, average_colour)
    want = jvis.make_spatial_video_visualization(video, source, (16, 16, 2), False, average_colour)
    assert got.dtype == np.uint8 and got.shape == (4, 32, 48, 3)
    np.testing.assert_array_equal(got, want)
    assert _png(tvis.concatenate_images(got, 2, 2)) == _png(jvis.concatenate_images(want, 2, 2))


@pytest.mark.parametrize("hybrid", [False, True], ids=["merge", "hybrid"])
@pytest.mark.parametrize("separate", [False, True])
def test_spatiotemporal_visualization_same_png(hybrid, separate):
    """Full 3-D groups, the CLS column dropped; the hybrid's dropped tokens
    get their own group."""
    video = _video(4, 4, 32, 32)
    source = _source(5, 9, (3, 2), class_token=True, threshold=0.0 if hybrid else None)
    if hybrid:
        assert (source[0].sum(axis=0) == 0).any()
    got, gsep = tvis.make_spatiotemporal_video_visualization(video, source, (16, 16, 2), True, True, separate)
    want, jsep = jvis.make_spatiotemporal_video_visualization(video, source, (16, 16, 2), True, True, separate)
    np.testing.assert_array_equal(got, want)
    assert len(gsep) == len(jsep) == (int(source[0, :, 1:].argmax(axis=0).max()) + 1 if separate else 0)
    for g, j in zip(gsep, jsep):
        np.testing.assert_array_equal(g, j)
    assert _png(tvis.concatenate_images(got, 2, 2)) == _png(jvis.concatenate_images(want, 2, 2))


def test_colormap_is_vtms():
    assert tvis.generate_colormap(7, seed=3) == jvis.generate_colormap(7, seed=3)


class _Clips:
    """A small dataset of numbered clips with EPIC-KITCHENS-style verb/noun
    labels."""

    def __init__(self, n=8, t=8):
        rng = np.random.default_rng(0)
        self.frames = rng.random((n, t, 4, 4, 3)).astype(np.float32)
        self._labels = [i % 3 for i in range(n)]
        self._verb_labels = self._labels
        self._noun_labels = [i % 2 for i in range(n)]

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i):
        return {"frames": self.frames[i], "label": {"verb": self._verb_labels[i], "noun": self._noun_labels[i]},
                "index": i}


@pytest.mark.parametrize("policy,match_type", [("random", None), ("same_class", None), ("same_class", "noun"),
                                               ("kl_similarity", "verb"), ("kl_similarity", "noun")])
def test_spliced_clips_equal_vtms(policy, match_type):
    base = _Clips()
    kl = np.random.default_rng(1).random((2, 8, 8))
    got = tsp.SplicedDataset(base, policy, 2, 2, match_type, kl, seed=4)
    want = jsp.SplicedDataset(base, policy, 2, 2, match_type, kl, seed=4)
    assert len(got) == len(want) == 8
    for i in range(8):
        g, w = got[i], want[i]
        np.testing.assert_array_equal(g["frames"], w["frames"])
        assert g["label"] == w["label"]
        # the last tubelet is never replaced
        np.testing.assert_array_equal(g["frames"][-2:], base[i]["frames"][-2:])
    assert tsp.RandomKinetics(base, 2, 1).policy == "random"
    assert tsp.KLSimilarityEpickitchens(base, 2, 1).policy == "kl_similarity"


def test_pairwise_kl_and_cached_matrices_equal_vtms(tmp_path):
    probs = np.random.default_rng(2).dirichlet(np.ones(5), size=6)
    np.testing.assert_array_equal(tdt.pairwise_kl(probs), jdt.pairwise_kl(probs))
    for name, mod in (("torch", tdt), ("jax", jdt)):
        cfg = get_cfg() if name == "torch" else jax_get_cfg()
        cfg.merge_from_list(["DATASET_UTILS.DISTRIBUTION_PATH", str(tmp_path / name),
                             "TEST.CHECKPOINT_FILE_PATH", "/x/ckpt.pyth"])
        (tmp_path / name).mkdir()
        np.savez(tmp_path / name / "ckpt_distributions.npz", verb=probs, noun=probs[:, ::-1])
        mod.cache_kl_divergences(cfg)
    got = tdt.load_kl_divergences(cfg)
    for a, b in zip(np.load(tmp_path / "torch" / "ckpt_kl_divergences.npz").values(),
                    np.load(tmp_path / "jax" / "ckpt_kl_divergences.npz").values()):
        np.testing.assert_array_equal(a, b)
    assert len(got) == 2


def test_cache_model_probs_from_one_checkpoint_as_vtm(tmp_path):
    """One checkpoint file through both packages' ``cache_model_probs`` on
    the synthetic test set: the same softmax rows within 1e-5."""
    opts = tnt._videomae_opts()
    ckpt = tmp_path / "model.pyth"
    tnt._write_checkpoint(ckpt, opts)
    out = {}
    for name in ("torch", "jax"):
        cfg, jcfg = tnt._cfgs([*opts, "TEST.CHECKPOINT_FILE_PATH", str(ckpt), "OUTPUT_DIR", str(tmp_path),
                               "DATASET_UTILS.DISTRIBUTION_PATH", str(tmp_path / name)])
        if name == "torch":
            tdt.cache_model_probs(cfg, device="cpu")
        else:
            jdt.cache_model_probs(jcfg)
        out[name] = np.load(tmp_path / name / "model_distributions.npz")["probs"]
    assert out["torch"].shape == (24, 7)
    np.testing.assert_allclose(out["torch"].sum(axis=1), 1.0, rtol=1e-6)
    np.testing.assert_allclose(out["torch"], out["jax"], rtol=0, atol=1e-5)


def test_cache_model_probs_needs_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tdt.cache_model_probs(get_cfg())


def test_mini_dataset_and_lengths_as_vtm_writes_them(tmp_path):
    """The Kinetics mini dataset (one clip a class) and the EPIC-KITCHENS
    lengths from the annotations' timestamps, written by each package."""
    frame = pd.DataFrame({
        "narration_id": [f"P01_{i:02d}" for i in range(4)],
        "start_timestamp": ["00:00:01.00", "00:00:02.50", "00:01:00.00", "00:00:00.10"],
        "stop_timestamp": ["00:00:03.00", "00:00:04.00", "00:01:30.25", "00:00:00.90"],
    }).set_index("narration_id")
    written = {}
    for name, mod, get in (("torch", tdt, get_cfg), ("jax", jdt, jax_get_cfg)):
        data = tmp_path / name / "k400"
        ann = tmp_path / name / "epic"
        data.mkdir(parents=True)
        ann.mkdir()
        (data / "test.csv").write_text("".join(f"v{i}.mp4 {i % 3}\n" for i in range(7)))
        frame.to_pickle(ann / "EPIC_100_validation.pkl")
        cfg = get()
        cfg.merge_from_list(["TEST.DATASET", "kinetics", "DATA.PATH_TO_DATA_DIR", str(data),
                             "EPICKITCHENS.ANNOTATIONS_DIR", str(ann)])
        mod.create_mini_datasets(cfg)
        cfg.TEST.DATASET = "epickitchens"
        mod.save_lengths(cfg)
        written[name] = ((tmp_path / name / "Mini-k400" / "test.csv").read_text(),
                         (ann / "epickitchens_lengths.csv").read_text(),
                         mod.load_lengths(cfg))
    assert written["torch"][:2] == written["jax"][:2]
    assert written["torch"][0].count("\n") == 3
    pd.testing.assert_frame_equal(written["torch"][2], written["jax"][2])


def _example_opts(ckpt=None):
    opts = ["--opts", *tnt._videomae_opts("TEST.BATCH_SIZE", "1", "TOME.R_VALUE", "3")]
    return opts + (["TEST.CHECKPOINT_FILE_PATH", str(ckpt)] if ckpt else [])


def test_videomae_example_same_sheet_as_vtms(tmp_path, monkeypatch):
    """``--out`` (documented in both, parsed by the port's), one checkpoint
    file: the port's sheet is byte for byte ``examples/videomae_example.py``'s."""
    ckpt = tmp_path / "model.pyth"
    tnt._write_checkpoint(ckpt, tnt._videomae_opts())
    cfg_path = str(REPO / "configs/videomae/kinetics/tome_VideoMAE_B_16_224_K400.yaml")
    out = videomae_example.main(["--cfg", cfg_path, *_example_opts(ckpt), "--out", str(tmp_path / "mine.png")],
                                device="cpu")
    assert out == str(tmp_path / "mine.png")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["videomae_example.py", "--cfg", cfg_path, *_example_opts(ckpt)])
    sys.path.insert(0, str(REPO))
    from examples import videomae_example as jax_example

    jax_example.main()
    assert (tmp_path / "mine.png").read_bytes() == (tmp_path / "videomae_vis.png").read_bytes()


def test_vivit_example_parses_out_and_r(tmp_path):
    """``--out`` and ``--r`` stand after ``--opts`` as the usage line shows
    them; ``--r`` sets the merge: 9 tokens, 2 layers at r 2 leave 5."""
    out = vivit_example.main([
        "--cfg", str(REPO / "configs/vivit/kinetics/tome_vivit_8x32_224.yaml"), "--opts",
        "VIVIT.CONFIG_PATH", tnt._vivit_json(tmp_path), "DATA.NUM_FRAMES", "4", "DATA.TEST_CROP_SIZE", "32",
        "DATA.TRAIN_CROP_SIZE", "32", "MODEL.NUM_CLASSES", "5", "TPU.COMPUTE_DTYPE", "float32",
        "--out", str(tmp_path / "v.png"), "--r", "2"], device="cpu")
    from PIL import Image

    assert Image.open(out).size == (4 * 32, 1 * 32)


@pytest.mark.parametrize("model", ["TimeSformer", "Motionformer"])
def test_timesformer_example_per_frame_sheet(model, tmp_path):
    opts = (["MODEL.MODEL_NAME", "Motionformer", "MOTIONFORMER.EMBED_DIM", "32", "MOTIONFORMER.DEPTH", "2",
             "MOTIONFORMER.NUM_HEADS", "2", "MOTIONFORMER.TEMPORAL_RESOLUTION", "2", "DATA.NUM_FRAMES", "4"]
            if model == "Motionformer" else ["DATA.NUM_FRAMES", "4"])
    out = timesformer_example.main([
        "--cfg", str(REPO / "configs/timesformer/kinetics/tome_TimeSformer_divST_8x32_224.yaml"),
        "--out", str(tmp_path / "t.png"), "--opts", *opts, "DATA.TEST_CROP_SIZE", "32",
        "DATA.TRAIN_CROP_SIZE", "32", "MODEL.NUM_CLASSES", "5", "TPU.COMPUTE_DTYPE", "float32",
        "TOME.R_VALUE", "1"], device="cpu")
    from PIL import Image

    assert Image.open(out).size == (4 * 32, 32)


def test_layer_duplication_example_merges_in_the_run(tmp_path):
    logits, state = layer_duplication_example.main(
        ["--opts", *tnt._videomae_opts("TOME.LAYER_TO_DUPLICATE", "1", "TOME.LAYER_QUANTITY", "3",
                                      "TOME.R_VALUE", "1")], device="cpu")
    # 8 tokens, r 1 at the three steps of block 1 only
    assert tuple(logits.shape) == (1, 7) and state.size.shape[1] == 5


def test_clip_splicing_example_runs_both_policies():
    got = clip_splicing_example.main(["--opts", *tnt._videomae_opts("DATA.NUM_FRAMES", "8")], device="cpu")
    assert sorted(got) == ["random", "same_class"]
    assert all(0 <= top < 7 for _, top in got.values())
