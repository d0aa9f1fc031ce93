"""Find a cell's files by name: ``workloads/<cell>.json`` names its
configuration (``configs/<config>.json``) and its traffic mix
(``traffic/<traffic>.json``); ``metrics/<metric>.py`` holds each per-layer
metric. Which metrics a cell reports, ``BENCHMARK.json`` beside the
benchmark's folder says, and nothing else: a run computes its end-to-end
ones, and installs and reads its per-layer ones alone. Adding a cell, a
mix, a configuration or a metric adds files and entries and edits none."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import re

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


def check_name(name: str) -> str:
    if not NAME.fullmatch(name):
        raise ValueError(f"not a valid name: {name!r}")
    return name


def load_json(kind: str, name: str, root: pathlib.Path = ROOT) -> dict:
    path = root / kind / f"{check_name(name)}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    root: pathlib.Path = ROOT

    @property
    def end_to_end(self) -> list:
        return reported(self.name, self.root)[0]

    @property
    def per_layer(self) -> list:
        return reported(self.name, self.root)[1]

    @property
    def family(self) -> str:
        return self.config["family"]

    @property
    def model(self) -> dict:
        return self.config["model"]

    @property
    def r(self) -> int:
        return int(self.traffic["tome_r"])

    @property
    def family_modules(self):
        return family(self.family)


def load_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    workload = load_json("workloads", name, root)
    return Cell(name, workload, load_json("configs", workload["config"], root),
                load_json("traffic", workload["traffic"], root), root)


def reported(cell: str, root: pathlib.Path = ROOT) -> tuple:
    """(end-to-end, per-layer) metric names that ``BENCHMARK.json`` gives
    ``cell``: a metric with a ``workloads`` list where it lists the cell;
    without one, an end-to-end metric in every cell and a per-layer metric
    in every cell that reports the end-to-end metric it moves."""
    path = root.parent / "BENCHMARK.json"
    bench = json.loads(path.read_text()) if path.is_file() else {}
    e2e = [m["name"] for m in bench.get("end_to_end", []) if cell in m.get("workloads", [cell])]
    per = [m["name"] for m in bench.get("per_layer", [])
           if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]
    return e2e, per


def metric_names(root: pathlib.Path = ROOT) -> list:
    return sorted(p.stem for p in (root / "metrics").glob("*.py"))


def load_metric(name: str, root: pathlib.Path = ROOT):
    """The module of ``metrics/<name>.py`` (a metric's name may hold dots,
    so it is loaded from its path)."""
    path = root / "metrics" / f"{check_name(name)}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def family(name: str):
    """The reference and the counts of a model family: ``reference/<f>.py``
    and ``counts/<f>.py``."""
    return (importlib.import_module(f"portbench.reference.{check_name(name)}"),
            importlib.import_module(f"portbench.counts.{name}"))
