"""Kinetics dataset (copy of ``vtm/data/kinetics.py``; reference:
slowfast/datasets/kinetics.py).

csv lines ``<path><sep><label>``; test mode enumerates
NUM_ENSEMBLE_VIEWS x NUM_SPATIAL_CROPS clips per video
(kinetics.py:88-93,148-154); decode failures retry with a random
replacement video (kinetics.py:282-309); DATA.DUMMY_LOAD caches the
first decoded sample and replays it (kinetics.py:204-205,504-506).
"""

from __future__ import annotations

import os
import random
from typing import Optional

import numpy as np

from vtm_torch.data import decoder, transform
from vtm_torch.data.loader import register_dataset
from vtm_torch.data.masking import gen_mask
from vtm_torch.utils.logging import get_logger

logger = get_logger(__name__)

# pandas' default missing-value strings (``read_csv(na_values=...)``)
_NA_STRINGS = frozenset((
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND", "1.#QNAN",
    "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
))
_NA = "<NA>"  # how pandas' string array prints a missing value


def _as_bool(v: str) -> bool:
    if v in ("True", "TRUE", "true"):
        return True
    if v in ("False", "FALSE", "false"):
        return False
    raise ValueError(v)


def _typed_column(column):
    """(kind, values) of one column as ``read_csv`` types it: ``int`` where
    every field is an integer, ``bool`` where every field present is a
    boolean, ``float`` where every field present is a number (a gap makes an
    integer column float), else ``str``; a missing field is None."""
    present = [v for v in column if v is not None]
    if not present:  # all missing: a float column of NaN
        return float, column
    for cast in ((int,) if len(present) == len(column) else ()) + (_as_bool, float):
        try:
            values = [None if v is None else cast(v) for v in column]
        except ValueError:
            continue
        return (bool if cast is _as_bool else cast), values
    return str, column


def read_csv_chunk(lines, chunksize: int, skip_rows: int):
    """The first ``chunksize`` rows of a csv after its first ``skip_rows``
    lines, flattened row by row as strings: what
    ``pandas.array(next(read_csv(f, chunksize=, skiprows=)).values.flatten(),
    dtype="string")`` gives, for ``vtm``'s chunked Kinetics loader.

    As there: the lines skipped count blank ones; after them blank (or
    whitespace-only) lines are dropped; the first line left is a header and
    is dropped; fields split on commas (with csv quoting), so a row that
    holds a comma gives several values, interleaved with the other rows'; a
    first row of k fields more than the header makes every row's first k
    fields an index, which is dropped; a short row's missing fields and
    pandas' missing-value strings come out as ``<NA>``; columns are typed
    (``_typed_column``) and ``values`` gives them one type: all integer
    columns stay integers, integer and float ones become floats, any other
    mix keeps each value's own. Raises ValueError where pandas raises:
    nothing left after ``skip_rows``, or a row with more fields than that."""
    import csv

    rest = [line for line in lines[skip_rows:] if line.strip()]
    if not rest:
        raise ValueError(f"no columns to parse after skipping {skip_rows} rows")
    rows = list(csv.reader(rest[: chunksize + 1]))
    width = len(rows[0])
    body = rows[1:]
    index = max(len(body[0]) - width, 0) if body else 0
    cells = []
    for row in body:
        if len(row) > width + index:
            raise ValueError(f"expected {width + index} fields, saw {len(row)}: {row}")
        row = row[index:]
        cells.append([None if v in _NA_STRINGS else v for v in row] + [None] * (width - len(row)))
    typed = [_typed_column([row[j] for row in cells]) for j in range(width)]
    kinds = {kind for kind, _ in typed}
    common = int if kinds == {int} else float if kinds <= {int, float} else None

    def text(v):
        return _NA if v is None else str(common(v) if common else v)

    return [text(values[i]) for i in range(len(cells)) for _, values in typed]


@register_dataset("kinetics")
class Kinetics:
    _num_retries = 10

    def __init__(self, cfg, mode: str):
        assert mode in ("train", "val", "test")
        self.cfg = cfg
        self.mode = mode
        if mode in ("train", "val"):
            self._num_clips = 1
        else:
            self._num_clips = cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
        self._dummy_cache: Optional[tuple] = None
        self._construct_loader()

    def _get_chunk(self, fobj, chunksize):
        """One LOADER_CHUNK_SIZE slab of the csv, the rows ``vtm``'s pandas
        ``read_csv(chunksize=, skiprows=)`` gives (``read_csv_chunk``), read
        without pandas. Where the slab cannot be read (``skip_rows`` past the
        end, a malformed row) it resets ``skip_rows`` to 0 and reads once
        more from the start, as ``vtm`` does (reference kinetics.py:176-179)."""
        try:
            return read_csv_chunk(fobj.read().splitlines(), chunksize, self.skip_rows)
        except ValueError:
            if self.skip_rows == 0:
                raise
            self.skip_rows = 0
            fobj.seek(0)
            return self._get_chunk(fobj, chunksize)

    def _construct_loader(self):
        csv_name = {"train": "train.csv", "val": "val.csv", "test": "test.csv"}[self.mode]
        path_to_file = os.path.join(self.cfg.DATA.PATH_TO_DATA_DIR, csv_name)
        assert os.path.exists(path_to_file), f"{path_to_file} not found"
        self.skip_rows = self.cfg.DATA.SKIP_ROWS
        use_chunk = self.mode == "train" and self.cfg.DATA.LOADER_CHUNK_SIZE > 0
        self._path_to_videos, self._labels, self._spatial_temporal_idx = [], [], []
        with open(path_to_file) as f:
            if use_chunk:
                rows = self._get_chunk(f, self.cfg.DATA.LOADER_CHUNK_SIZE)
            else:
                rows = f.read().splitlines()
            for clip_idx, line in enumerate(rows):
                if not line:
                    continue
                fetch_info = line.split(self.cfg.DATA.PATH_LABEL_SEPARATOR)
                # 2-field "path label" is the common layout; 3-field adds
                # a frame-number column, 1-field has no label (reference
                # kinetics.py:131-147)
                if len(fetch_info) == 2:
                    path, label = fetch_info
                elif len(fetch_info) == 3:
                    path, _fn, label = fetch_info
                elif len(fetch_info) == 1:
                    path, label = fetch_info[0], 0
                else:
                    raise RuntimeError(
                        f"Failed to parse video fetch info {fetch_info}"
                    )
                for idx in range(self._num_clips):
                    self._path_to_videos.append(
                        os.path.join(self.cfg.DATA.PATH_PREFIX, path)
                    )
                    self._labels.append(int(label))
                    self._spatial_temporal_idx.append(idx)
        assert self._path_to_videos, f"empty dataset at {path_to_file}"
        logger.info(
            "Kinetics %s: %d clips from %d videos",
            self.mode,
            len(self._path_to_videos),
            len(self._path_to_videos) // self._num_clips,
        )

    def __len__(self):
        return len(self._path_to_videos)

    def __getitem__(self, index) -> dict:
        cfg = self.cfg
        # short-cycle multigrid passes (index, cycle_idx) tuples
        # (reference kinetics.py:191-200 / multigrid_helper.py)
        short_cycle_idx = None
        if isinstance(index, tuple):
            index, short_cycle_idx = index
        if cfg.DATA.DUMMY_LOAD and self._dummy_cache is not None:
            frames, label, clips = self._dummy_cache
            item = {"frames": frames, "label": label, "index": index}
            if clips is not None:
                item["clips"] = clips
            if cfg.AUG.GEN_MASK_LOADER:
                item["mask"] = gen_mask(cfg)
            return item

        if self.mode in ("train", "val"):
            temporal_sample_index = -1
            spatial_sample_index = -1
            min_scale, max_scale = cfg.DATA.TRAIN_JITTER_SCALES
            crop_size = cfg.DATA.TRAIN_CROP_SIZE
            if short_cycle_idx in (0, 1):
                crop_size = int(
                    round(
                        cfg.MULTIGRID.SHORT_CYCLE_FACTORS[short_cycle_idx]
                        * cfg.MULTIGRID.DEFAULT_S
                    )
                )
            if cfg.MULTIGRID.DEFAULT_S > 0:
                # decreasing the scale ~ larger sampling-grid span
                min_scale = int(
                    round(float(min_scale) * crop_size / cfg.MULTIGRID.DEFAULT_S)
                )
        else:
            temporal_sample_index = (
                self._spatial_temporal_idx[index] // cfg.TEST.NUM_SPATIAL_CROPS
            )
            spatial_sample_index = (
                self._spatial_temporal_idx[index] % cfg.TEST.NUM_SPATIAL_CROPS
                if cfg.TEST.NUM_SPATIAL_CROPS > 1
                else 1
            )
            # single-crop test resizes the short side to the JITTER
            # floor before the center crop (reference kinetics.py:246-251
            # — TEST_CROP_SIZE as the scale changes every test pixel)
            if cfg.TEST.NUM_SPATIAL_CROPS > 1:
                min_scale = max_scale = cfg.DATA.TEST_CROP_SIZE
            else:
                min_scale = max_scale = cfg.DATA.TRAIN_JITTER_SCALES[0]
            crop_size = cfg.DATA.TEST_CROP_SIZE

        sampling_rate = cfg.DATA.SAMPLING_RATE
        if self.mode == "train" and cfg.MULTIGRID.LONG_CYCLE_SAMPLING_RATE > 0:
            # short-T multigrid phases randomly stretch the sampling rate
            # so some clips still cover the original span (reference
            # utils.get_random_sampling_rate)
            sampling_rate = random.randint(
                sampling_rate, cfg.MULTIGRID.LONG_CYCLE_SAMPLING_RATE
            )

        # SSL multi-view sampling decodes n_temporal gap-constrained
        # clips in ONE pass (reference kinetics.py:256-311); 'frames'
        # is the first view — a separate whole-video decode would
        # double loader CPU for a key the SSL loop never reads
        n_temporal = cfg.DATA.TRAIN_CROP_NUM_TEMPORAL
        n_spatial = cfg.DATA.TRAIN_CROP_NUM_SPATIAL
        ssl_views = self.mode == "train" and n_temporal * n_spatial > 1

        raw_clips = None
        for retry in range(self._num_retries):
            if ssl_views:
                raw_clips = decoder.decode_clips(
                    self._path_to_videos[index],
                    sampling_rate,
                    cfg.DATA.NUM_FRAMES,
                    num_decode=n_temporal,
                    target_fps=cfg.DATA.TARGET_FPS,
                    min_delta=cfg.CONTRASTIVE.DELTA_CLIPS_MIN,
                    max_delta=cfg.CONTRASTIVE.DELTA_CLIPS_MAX,
                    time_diff_prob=cfg.DATA.TIME_DIFF_PROB
                    if self.mode == "train"
                    else 0.0,
                )
                frames = raw_clips[0] if raw_clips is not None else None
            else:
                frames = decoder.decode(
                    self._path_to_videos[index],
                    sampling_rate,
                    cfg.DATA.NUM_FRAMES,
                    clip_idx=temporal_sample_index,
                    num_clips=cfg.TEST.NUM_ENSEMBLE_VIEWS if self.mode == "test" else 1,
                    target_fps=cfg.DATA.TARGET_FPS,
                    use_offset=cfg.DATA.USE_OFFSET_SAMPLING,
                    time_diff_prob=cfg.DATA.TIME_DIFF_PROB
                    if self.mode == "train"
                    else 0.0,
                )
            if frames is not None:
                break
            logger.warning(
                "Failed to decode %s (try %d)", self._path_to_videos[index], retry
            )
            # the reference never substitutes videos in test mode (the
            # meter would aggregate the wrong clip under this video id,
            # kinetics.py:296-308) — keep retrying the same file there
            if self.mode != "test" and retry >= 2:
                index = random.randint(0, len(self) - 1)
        else:
            raise RuntimeError(
                f"Failed to decode after {self._num_retries} retries"
            )

        def finish(clip):
            # Reference kinetics.py:412-427 converts EVERY clip to
            # [0,1] float (.float()/255) before the aug chain — ssl
            # jitter -> AA -> normalize. That unconditional /255 also
            # puts raw-aug outputs (time difference, float [0,255])
            # into AA's expected range; the PIL conversions'
            # *255-truncate is an exact identity on uint8-origin
            # values (ToPILImage semantics, verified over all 256).
            clip = np.asarray(clip, np.float32) / 255.0
            if self.mode == "train" and cfg.DATA.SSL_COLOR_JITTER:
                clip = transform.color_jitter_video_ssl(
                    clip,
                    bri_con_sat=cfg.DATA.SSL_COLOR_BRI_CON_SAT,
                    hue=cfg.DATA.SSL_COLOR_HUE,
                    p_convert_gray=cfg.DATA.COLOR_RND_GRAYSCALE,
                    moco_v2_aug=cfg.DATA.SSL_MOCOV2_AUG,
                    gaussan_sigma_min=cfg.DATA.SSL_BLUR_SIGMA_MIN,
                    gaussan_sigma_max=cfg.DATA.SSL_BLUR_SIGMA_MAX,
                )
            clip = transform.train_augment(cfg, clip, self.mode)
            clip = transform.tensor_normalize(clip, cfg.DATA.MEAN, cfg.DATA.STD)
            clip = transform.spatial_sampling(
                clip,
                spatial_idx=spatial_sample_index,
                min_scale=min_scale,
                max_scale=max_scale,
                crop_size=crop_size,
                random_horizontal_flip=cfg.DATA.RANDOM_FLIP,
                inverse_uniform_sampling=cfg.DATA.INV_UNIFORM_SAMPLE,
                **transform.relative_crop_args(cfg, self.mode),
            )
            clip = transform.train_random_erase(cfg, clip, self.mode)
            return np.ascontiguousarray(clip, dtype=np.float32)

        clips = None
        if raw_clips is not None:
            # independent random augs per spatial view
            clips = np.stack(
                [finish(c) for c in raw_clips for _ in range(n_spatial)]
            )

        frames = finish(frames)
        label = self._labels[index]
        if cfg.DATA.DUMMY_LOAD and self._dummy_cache is None:
            self._dummy_cache = (frames, label, clips)
        item = {"frames": frames, "label": label, "index": index}
        if clips is not None:
            item["clips"] = clips
        if cfg.AUG.GEN_MASK_LOADER:
            item["mask"] = gen_mask(cfg)
        return item
