"""Structured logging (copy of ``vtm/utils/logging.py``, with the standard
library's ``json`` in place of ``simplejson``)."""

from __future__ import annotations

import logging as _logging
import json
import os
import sys

_FORMAT = "[%(asctime)s][%(levelname)s] %(filename)s:%(lineno)d: %(message)s"


def setup_logging(output_dir: str | None = None) -> None:
    root = _logging.getLogger()
    if root.handlers:
        return
    root.setLevel(_logging.INFO)
    sh = _logging.StreamHandler(sys.stdout)
    sh.setFormatter(_logging.Formatter(_FORMAT, datefmt="%m/%d %H:%M:%S"))
    root.addHandler(sh)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        fh = _logging.FileHandler(os.path.join(output_dir, "stdout.log"))
        fh.setFormatter(_logging.Formatter(_FORMAT, datefmt="%m/%d %H:%M:%S"))
        root.addHandler(fh)


def get_logger(name: str) -> _logging.Logger:
    return _logging.getLogger(name)


def log_json_stats(stats: dict, logger=None) -> None:
    """Emit a ``json_stats:`` line (the format downstream tooling greps
    for): floats rounded to 5 decimals, keys sorted."""
    stats = {
        k: (float(f"{v:.5f}") if isinstance(v, float) else v) for k, v in stats.items()
    }
    line = json.dumps(stats, sort_keys=True)
    (logger or get_logger(__name__)).info("json_stats: {:s}".format(line))
