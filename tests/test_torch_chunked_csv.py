"""The chunked Kinetics csv (``DATA.LOADER_CHUNK_SIZE``) against the JAX
package: the port reads each slab without pandas and must give the rows
``vtm``'s ``pandas.read_csv(chunksize=, skiprows=)`` gives (its header,
blank lines, comma splitting, types, index columns and reset cases), the
datasets the same videos and labels, and ``rotate_chunked_csv`` the same
slab an epoch; then ``train_net.train`` rotating through the slabs."""

import functools
import io
import types

import jax  # noqa: F401  (keeps the JAX package's CPU setup first, as the other parity tests do)
import numpy as np
import pytest
import torch

import tools.train_net as jax_train_net
from vtm.config import get_cfg as jax_get_cfg
from vtm.data.kinetics import Kinetics as JKinetics
from vtm_torch.config import get_cfg
from vtm_torch.data import kinetics
from vtm_torch.data.kinetics import Kinetics, read_csv_chunk
from vtm_torch.tools import train_net

torch.set_num_threads(2)

# text, chunk size, rows skipped: each case one of pandas' behaviours
CASES = {
    "header": ("a.mp4 1\nb.mp4 2\nc.mp4 3\nd.mp4 4\ne.mp4 5\n", 3, 0),
    "skip": ("a.mp4 1\nb.mp4 2\nc.mp4 3\nd.mp4 4\ne.mp4 5\n", 3, 1),
    "short_last_slab": ("a.mp4 1\nb.mp4 2\nc.mp4 3\nd.mp4 4\ne.mp4 5\n", 3, 2),
    "blank_lines_counted_then_dropped": ("a.mp4 1\n\nb.mp4 2\n\n\nc.mp4 3\nd.mp4 4\ne.mp4 5\n", 3, 4),
    "whitespace_line": ("a.mp4 1\n   \nb.mp4 2\nc.mp4 3\n", 2, 1),
    "commas_interleave": ("h,x\na,1\nb,2\nc,3\nd,4\n", 3, 1),
    "short_row_fills_na": ("h,x\na,1\nb\nc,3\n", 3, 0),
    "first_row_one_longer_is_an_index": ("h,x\na,1,2\nb,2,3\n", 2, 0),
    "quoted_comma": ('h\n"a,b" 1\nc 2\n', 3, 0),
    "integers": ("h\n007\n2\n-3\n", 3, 0),
    "floats": ("h\n1.50\n2\n1e3\n", 3, 0),
    "mixed_columns_upcast": ("h,x\n007,7\n2,inf\n", 2, 0),
    "booleans": ("h,x\ntrue,a\nFALSE,b\n", 2, 0),
    "missing_values": ('h\nNA\nnan\n""\nx\n', 4, 0),
    "crlf": ("a 1\r\nb 2\r\nc 3\r\n", 3, 0),
    "no_final_newline": ("a 1\nb 2\nc 3", 3, 0),
    "header_only": ("a.mp4 1\nb.mp4 2\n", 3, 1),
}


def _reader(cls, skip_rows: int):
    """An object with ``cls``'s ``_get_chunk`` bound and ``skip_rows`` set,
    as the dataset holds them."""
    obj = types.SimpleNamespace(skip_rows=skip_rows)
    obj._get_chunk = functools.partial(cls._get_chunk, obj)
    return obj


def _vtm_rows(text, chunk, skip):
    reader = _reader(JKinetics, skip)
    try:
        rows = [str(r) for r in reader._get_chunk(io.StringIO(text), chunk)]
    except Exception as err:  # noqa: BLE001 - pandas' errors, whatever their class
        return ("error", type(err).__name__), reader.skip_rows
    return rows, reader.skip_rows


def _port_rows(text, chunk, skip):
    reader = _reader(Kinetics, skip)
    try:
        rows = reader._get_chunk(io.StringIO(text), chunk)
    except ValueError as err:
        return ("error", type(err).__name__), reader.skip_rows
    return rows, reader.skip_rows


@pytest.mark.parametrize("case", list(CASES))
def test_chunk_rows_match_vtm(case):
    text, chunk, skip = CASES[case]
    want, want_skip = _vtm_rows(text, chunk, skip)
    got, got_skip = _port_rows(text, chunk, skip)
    assert want[:1] != ["error"] and want != ("error", "EmptyDataError"), want
    assert got == want and got_skip == want_skip


@pytest.mark.parametrize("text, chunk, skip", [
    ("a.mp4 1\nb.mp4 2\nc.mp4 3\n", 2, 9),  # past the end: both reset to the start
    ("h,x\na,1\nb,2\nc,3,4,5\n", 2, 1),  # a row too long after skipping: the reset reads the start
])
def test_unreadable_slab_resets_to_the_start_as_vtm(text, chunk, skip):
    want, want_skip = _vtm_rows(text, chunk, skip)
    got, got_skip = _port_rows(text, chunk, skip)
    assert got == want and got_skip == want_skip == 0


def test_unreadable_first_slab_raises_as_vtm():
    """At skip_rows 0 there is nothing to reset to: both raise."""
    text = "h,x\na,1\nb,2,3\n"
    assert _vtm_rows(text, 2, 0)[0] == ("error", "ParserError")
    with pytest.raises(ValueError, match="expected 2 fields"):
        read_csv_chunk(text.splitlines(), 2, 0)


def test_random_csvs_match_pandas():
    """Random csvs of paths, numbers, booleans, missing values, blank lines,
    quoted commas and ragged rows: every slab as pandas reads it."""
    import pandas

    rng = np.random.default_rng(0)
    tokens = ["a.mp4 1", "b/c.mp4 22", "x", "7", "007", "1.5", "-3", "NA", "", "True", "false", "  ", "p q r",
              '"q,r" 4', "1e3", "inf"]
    compared = 0
    for _ in range(400):
        ncol = int(rng.choice([1, 1, 2, 3]))
        lines = []
        for _ in range(int(rng.integers(0, 9))):
            if rng.random() < 0.15:
                lines.append(str(rng.choice(["", "   "])))
                continue
            k = ncol if rng.random() < 0.85 else int(rng.integers(1, ncol + 2))
            lines.append(",".join(str(rng.choice(tokens)) for _ in range(k)))
        text = "\n".join(lines) + ("\n" if rng.random() < 0.7 else "")
        chunk, skip = int(rng.integers(1, 6)), int(rng.integers(0, 5))
        try:
            want = [str(v) for v in pandas.array(
                next(iter(pandas.read_csv(io.StringIO(text), chunksize=chunk, skiprows=skip))).values.flatten(),
                dtype="string")]
        except (StopIteration, ValueError, pandas.errors.ParserError, pandas.errors.EmptyDataError):
            with pytest.raises(ValueError):
                read_csv_chunk(text.splitlines(), chunk, skip)
            continue
        assert read_csv_chunk(text.splitlines(), chunk, skip) == want, (text, chunk, skip)
        compared += 1
    assert compared > 150


def _csv_dir(tmp_path, n=10):
    """A train.csv of ``n`` rows; its videos need not exist to list them."""
    (tmp_path / "train.csv").write_text("".join(f"clips/v{i}.mp4 {i % 3}\n" for i in range(n)))
    return ["DATA.PATH_TO_DATA_DIR", str(tmp_path), "DATA.PATH_PREFIX", "/videos"]


def _cfgs(opts):
    cfg, jcfg = get_cfg(), jax_get_cfg()
    cfg.merge_from_list(list(opts))
    jcfg.merge_from_list(list(opts))
    return cfg, jcfg


@pytest.mark.parametrize("skip", [0, 3, 6, 9, 40])
def test_kinetics_lists_vtms_videos(tmp_path, skip):
    opts = _csv_dir(tmp_path) + ["DATA.LOADER_CHUNK_SIZE", "3", "DATA.SKIP_ROWS", str(skip)]
    cfg, jcfg = _cfgs(opts)
    if skip == 9:  # the header is the last row: an empty slab, which both refuse
        for cls, c in ((JKinetics, jcfg), (Kinetics, cfg)):
            with pytest.raises(AssertionError, match="empty dataset"):
                cls(c, "train")
        return
    port, ref = Kinetics(cfg, "train"), JKinetics(jcfg, "train")
    assert port._path_to_videos == ref._path_to_videos and port._labels == ref._labels
    assert port.skip_rows == ref.skip_rows


def test_rotation_walks_vtms_slabs(tmp_path, monkeypatch):
    """``rotate_chunked_csv`` epoch by epoch in both packages: the same
    SKIP_ROWS, and the rebuilt train loaders list the same videos."""
    opts = _csv_dir(tmp_path) + ["DATA.LOADER_CHUNK_SIZE", "3", "DATA.LOADER_CHUNK_OVERALL_SIZE", "9",
                                 "TRAIN.DATASET", "kinetics", "TRAIN.BATCH_SIZE", "1",
                                 "DATA_LOADER.NUM_WORKERS", "0"]
    cfg, jcfg = _cfgs(opts)
    for epoch in range(6):
        port, ref = train_net.rotate_chunked_csv(cfg, epoch), jax_train_net.rotate_chunked_csv(jcfg, epoch)
        assert (port is None) == (ref is None) == (epoch == 0)
        assert cfg.DATA.SKIP_ROWS == jcfg.DATA.SKIP_ROWS
        if port is not None:
            assert port.dataset._path_to_videos == ref.dataset._path_to_videos
            assert port.dataset._labels == ref.dataset._labels


def test_train_rotates_the_slabs(tmp_path, monkeypatch):
    """``train`` with ``DATA.LOADER_CHUNK_SIZE`` (once refused): each epoch's
    train loader lists the slab ``vtm`` reads that epoch."""
    opts = _csv_dir(tmp_path, 8) + [
        "MODEL.MODEL_NAME", "VideoMAE", "VIDEOMAE.MODEL", "vit_small_patch16_224", "DATA.TRAIN_CROP_SIZE", "32",
        "DATA.TEST_CROP_SIZE", "32", "DATA.NUM_FRAMES", "4", "MODEL.NUM_CLASSES", "3", "TPU.COMPUTE_DTYPE",
        "float32", "TRAIN.DATASET", "kinetics", "TRAIN.BATCH_SIZE", "2", "TRAIN.EVAL_PERIOD", "100",
        "TRAIN.CHECKPOINT_PERIOD", "100", "TRAIN.AUTO_RESUME", "False", "SOLVER.MAX_EPOCH", "3",
        "DATA.LOADER_CHUNK_SIZE", "4", "DATA.LOADER_CHUNK_OVERALL_SIZE", "8", "DATA_LOADER.NUM_WORKERS", "0",
        "OUTPUT_DIR", str(tmp_path / "out")]
    cfg, jcfg = _cfgs(opts)
    seen = []

    def recorded_epoch(loader, *args, **kwargs):
        seen.append(list(loader.dataset._path_to_videos))

    monkeypatch.setattr(train_net, "train_epoch", recorded_epoch)
    monkeypatch.setattr(train_net, "construct_loader", _with_synthetic_val(train_net.construct_loader))
    train_net.train(cfg, device="cpu")
    want = []
    for epoch in range(3):
        if epoch:
            jcfg.DATA.SKIP_ROWS = epoch % 2 * 4
        want.append(list(JKinetics(jcfg, "train")._path_to_videos))
    assert seen == want and len(set(map(tuple, seen))) == 2


def _with_synthetic_val(construct):
    """The val split on the synthetic dataset (the csv dir holds train only)."""
    def make(cfg, split, *args):
        if split == "val":
            cfg = cfg.clone()
            cfg.TRAIN.DATASET = cfg.TEST.DATASET = "synthetic"
        return construct(cfg, split, *args)
    return make


def test_reader_imports_no_pandas():
    import subprocess
    import sys

    code = ("import sys, vtm_torch.data.kinetics as k; "
            "k.read_csv_chunk(['h,x', 'a,1'], 1, 0); assert 'pandas' not in sys.modules")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                          cwd=str(kinetics.__file__).rsplit("/vtm_torch/", 1)[0])
    assert proc.returncode == 0, proc.stderr
