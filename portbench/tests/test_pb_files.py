"""Every file the harness finds by name parses, and BENCHMARK.json agrees
with them and with the contract's character rules."""

import json

import pytest

from portbench.core import spec

REPO = spec.ROOT.parent
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
LAYER_CHARS = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 _.,:;()/-+`'")


@pytest.mark.parametrize("kind", ["configs", "workloads", "traffic"])
def test_json_files_parse_and_are_named_by_the_rules(kind):
    files = sorted((spec.ROOT / kind).glob("*.json"))
    assert files
    for path in files:
        assert isinstance(json.loads(path.read_text()), dict)
        spec.check_name(path.stem)


@pytest.mark.parametrize("name", spec.metric_names())
def test_metric_files_load(name):
    metric = spec.load_metric(name)
    assert metric.NAME == name
    assert spec.UNIT.fullmatch(metric.UNIT)
    assert metric.SOURCE in ("device_trace", "program_span", "program_counter", "host_clock")
    assert callable(metric.read)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_has_its_files(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    loaded = spec.load_cell(cell)
    assert (loaded.workload["config"], loaded.workload["traffic"]) == (entry["config"], entry["traffic"])
    assert entry["chips"] == 1 and 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    assert set(loaded.workload["limits"]) and all(v > 0 for v in loaded.workload["limits"].values())
    # a limit names a number the cell's kind reads, and the gradient and change are always compared
    numbers = {"serve": {"logit_gap", "match_gap"},
               "train": {"loss_gap", "grad_norm_gap", "change_norm_gap", "match_gap"}}[loaded.traffic["kind"]]
    assert set(loaded.workload["limits"]) <= numbers and ("match_gap" in loaded.workload["limits"]) == (loaded.r > 0)
    if loaded.traffic["kind"] == "train":
        assert {"grad_norm_gap", "change_norm_gap"} <= set(loaded.workload["limits"])
    # every cell reports setup_s, another end-to-end metric and a per-layer one, each with its file
    assert "setup_s" in loaded.end_to_end and len(loaded.end_to_end) >= 2 and loaded.per_layer
    assert set(loaded.per_layer) <= set(spec.metric_names())
    assert all(next(m for m in BENCH["per_layer"] if m["name"] == name)["moves"] in loaded.end_to_end
               for name in loaded.per_layer)


def test_benchmark_json_follows_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and BENCH["command"][:2] == ["python3", "portbench/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]] + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for name in names:
        spec.check_name(name)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"portbench/configs/{c['name']}.json" and (REPO / c["file"]).is_file()
        assert c["reduced"] == [] and c["source"].startswith("https://")
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m.get("bound", 0.01) <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells
        assert set(m["layer"]) <= LAYER_CHARS and len(m["layer"]) <= 200
        metric = spec.load_metric(m["name"])
        assert (metric.UNIT, metric.SOURCE) == (m["unit"], m["source"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_a_workload_dropped_into_a_copy_is_found_without_a_code_change(tmp_path):
    import shutil

    root = tmp_path / "portbench"
    shutil.copytree(spec.ROOT, root, ignore=shutil.ignore_patterns("__pycache__"))
    new = {"config": "videomae_b16_k400", "traffic": "serve_b32_r0", "trace_iters": 4, "limits": {"logit_gap": 0.5}}
    (root / "workloads" / "videomae_b16_serve_new.json").write_text(json.dumps(new))
    (root / "metrics" / "new_metric.py").write_text("NAME, UNIT, SOURCE = 'new_metric', 'ms', 'host_clock'\n"
                                                   "def read(run):\n    return 1.0\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "videomae_b16_serve_new", "config": "videomae_b16_k400",
                               "traffic": "serve_b32_r0", "chips": 1, "why": "a new cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "videomae_b16_serve_r0" in m.get("workloads", []):
            m["workloads"].append("videomae_b16_serve_new")
    bench["per_layer"].append({"name": "new_metric", "unit": "ms", "better": "lower", "source": "host_clock",
                               "layer": "device", "moves": "clips_per_s", "workloads": ["videomae_b16_serve_new"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("videomae_b16_serve_new", root)
    assert cell.traffic["kind"] == "serve" and cell.family == "videomae" and cell.r == 0
    assert cell.end_to_end == spec.load_cell("videomae_b16_serve_r0").end_to_end
    assert cell.per_layer == spec.load_cell("videomae_b16_serve_r0").per_layer + ["new_metric"]
    assert "new_metric" not in spec.load_cell("videomae_b16_serve_r0", root).per_layer
    assert spec.load_metric("new_metric", root).read(None) == 1.0


def test_a_cell_reports_only_the_metrics_benchmark_json_gives_it():
    merged_train = spec.load_cell("motionformer_b16_train_r18")
    assert merged_train.end_to_end == ["train_clips_per_s", "setup_s"]
    assert "merge_ms_per_batch" not in merged_train.per_layer and "k3_roofline_pct" in merged_train.per_layer
    assert "merge_ms_per_batch" in spec.load_cell("videomae_b16_serve_r150").per_layer


@pytest.mark.parametrize("bad", ["a b", "a/b", "", "x" * 65, "é"])
def test_names_outside_the_rules_are_refused(bad):
    with pytest.raises(ValueError):
        spec.check_name(bad)
