"""On the card (``python -m pytest portbench/tests -q -m card``): a cell as
the benchmark runs it comes out correct, and the control (the reference in
fp8 in the program's place) at the cell's own size does not."""

import json
import pathlib
import subprocess
import sys

import pytest

from portbench import control

REPO = pathlib.Path(__file__).resolve().parents[2]


@pytest.mark.card
def test_a_cell_runs_and_is_correct(card):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "videomae_b16_serve_r0", "--seed",
                          str(2**31 + 1234), "--seconds", "3", "--trace", "0"], cwd=REPO, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["count"] == 1


@pytest.mark.card
@pytest.mark.parametrize("name", ["videomae_b16_serve_r0", "motionformer_b16_train_r0"])
def test_the_control_is_not_correct_at_the_cells_size(card, name):
    (record,) = control.main(["--workload", name, "--mode", "control", "--seeds", str(2**31 + 77)], device=card)
    from portbench.core import spec

    limits = spec.load_cell(name).workload["limits"]
    assert any(record["numbers"][k] > limits[k] for k in limits)
