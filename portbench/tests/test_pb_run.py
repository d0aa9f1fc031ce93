"""The run's contract: its last line, its refusals, and what it imports."""

import json
import os
import pathlib
import subprocess
import sys

import torch

from portbench.core import driver
from portbench.tests import tiny

REPO = pathlib.Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _line(name, trace):
    return driver.run_cell(tiny.cell(name), 2**31 + 99, 0.3, trace, torch.device("cpu"), 0.0)


def test_last_line_has_the_contract_keys_and_the_checks_last():
    line = _line("videomae_b16_serve_r150", False)
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"setup_s", "clips_per_s"}  # the workload file's end-to-end metrics
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(v) == {"value", "limit"} for v in line["checks"].values())
    json.dumps(line)


def test_traced_line_carries_the_breakdown_and_the_window():
    line = _line("motionformer_b16_train_r18", True)
    assert list(line)[:5] == KEYS and list(line)[5:] == ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"host_ms_per_step.train", "train_mfu_pct", "device_idle_pct.train"} <= set(line["metrics"])
    assert set(line["metrics"]) <= set(tiny.cell("motionformer_b16_train_r18").per_layer)
    assert "setup_s" not in line["metrics"]


def test_a_traced_run_installs_only_its_cells_wraps(monkeypatch):
    from portbench.core import wraps

    installed = []
    original = wraps.Spans.install
    monkeypatch.setattr(wraps.Spans, "install", lambda self, metric: (installed.append(metric.NAME),
                                                                       original(self, metric)))
    _line("motionformer_b16_train_r18", True)
    assert installed == tiny.cell("motionformer_b16_train_r18").per_layer and "merge_ms_per_batch" not in installed


def test_without_a_card_the_run_fails_and_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "videomae_b16_serve_r0", "--seed",
                          str(2**31 + 5), "--seconds", "1", "--trace", "0"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_module_reachable_from_the_run_is_jax_or_the_jax_package():
    code = (
        "import sys, runpy, torch; sys.argv = ['run.py']; sys.path.insert(0, '.')\n"
        "import portbench.run as run, portbench.control, portbench.core.driver as d\n"
        "from portbench.core import spec, program, serve, train\n"
        "from portbench.tests import tiny\n"
        "[spec.load_metric(n) for n in spec.metric_names()]\n"
        "import vtm_torch.models, vtm_torch.tools.train_net, vtm_torch.ops.build\n"
        "d.run_cell(tiny.cell('motionformer_b16_train_r18'), 3, 0.2, True, torch.device('cpu'), 0.0)\n"
        "d.run_cell(tiny.cell('videomae_b16_serve_r150'), 3, 0.2, True, torch.device('cpu'), 0.0)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'vtm'}))\n"
        "print(run.forbidden_modules())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[-3:-1] == ["[]", "[]"]


def test_the_forbidden_check_compares_whole_top_level_names():
    sys.path.insert(0, str(REPO / "portbench"))
    import run

    before = dict(sys.modules)
    try:
        sys.modules.setdefault("vtm_torch_like", sys)
        assert "vtm_torch_like" not in run.forbidden_modules()
        sys.modules["vtm.fake"] = sys
        assert "vtm.fake" in run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(before)
