"""The check fails where it should: at tiny widths on the CPU, the rest of
a run driven with the timed path broken underneath (an answer altered
where it is produced; a train step that leaves the state unchanged; half
of each batch left out, the mean taken over the rest; merging one token
more than the cell's r, or leaving one layer's merge out), and the control
(the reference in fp8 in the program's place) on the cell's own numbers.
The same control at the cells' sizes runs on the card
(``test_pb_card.py``, and ``control.py`` for the readings of PERF.md)."""

import pytest
import torch

from portbench import control
from portbench.core import driver, program, spec, train
from portbench.tests import tiny

CPU = torch.device("cpu")
SEED = 2**31 + 17


def run(cell, make_program=None):
    return driver.run_cell(cell, SEED, 0.3, False, CPU, 0.0, make_program)


def altered_answer(cell, params, batch, device, recorder):
    forward, holder = program.serving_forward(cell, params, batch, device, recorder)
    calls = [0]

    def broken(video):
        calls[0] += 1
        out = forward(video)
        if calls[0] > 1:  # one logit of one clip in each batch after the first
            out = out.clone()
            out[1, 2] += 0.5 * out.abs().max()
        return out

    return broken, holder


class UnchangedState(train.ProgramStepper):
    def step(self, frames, labels):
        for p in self.trainer.module.parameters():
            p.requires_grad_(False)
        return self.trainer.module(frames)[0].sum() * 0


class HalfBatch(train.ProgramStepper):
    def step(self, frames, labels):
        half = frames.shape[0] // 2
        return super().step(frames[:half], labels[:half])


def one_more(cell):
    """The cell with the program built at r + 1."""
    return spec.Cell(cell.name, cell.workload, cell.config, dict(cell.traffic, tome_r=cell.r + 1))


class MergingMore(train.ProgramStepper):
    def __init__(self, cell, params, batch, device, recorder=None):
        super().__init__(one_more(cell), params, batch, device, recorder)


def merging_more(cell, params, batch, device, recorder):
    return program.serving_forward(one_more(cell), params, batch, device, recorder)


def skip_one_merge(monkeypatch, family):
    """The model's reduce_tokens, with layer 1's merge left out."""
    module = __import__(f"vtm_torch.models.{family}", fromlist=["reduce_tokens"])
    original = module.reduce_tokens

    def reduce_tokens(policy, layer, metric, x, state):
        return (x, state) if layer == 1 else original(policy, layer, metric, x, state)

    monkeypatch.setattr(module, "reduce_tokens", reduce_tokens)


@pytest.mark.parametrize("name", ["videomae_b16_serve_r150", "motionformer_b16_train_r18"])
@pytest.mark.parametrize("fault", ["one_more", "one_left_out"])
def test_merging_off_the_cells_schedule_is_not_correct(name, fault, monkeypatch):
    cell = tiny.cell(name, limits={"logit_gap": 0.5, "match_gap": 0.05, "loss_gap": 1e-3, "grad_norm_gap": 0.1,
                                   "change_norm_gap": 0.5})
    assert run(cell)["correct"]
    serving = cell.traffic["kind"] == "serve"
    if fault == "one_more":
        broken = merging_more if serving else MergingMore
    else:
        skip_one_merge(monkeypatch, cell.family)
        broken = None
    line = run(cell, broken)
    match = line["checks"]["match_gap"]
    # off the schedule (inf), or, where a skipped layer leaves the later
    # merges the same shapes, decisions taken on another layer's keys
    assert not line["correct"] and not match["value"] <= match["limit"]
    if fault == "one_more":
        assert match["value"] == float("inf")


@pytest.mark.parametrize("name", ["videomae_b16_serve_r150", "videomae_b16_serve_r0"])
def test_an_answer_altered_where_it_is_produced_is_not_correct(name):
    cell = tiny.cell(name, limits={"logit_gap": 0.5, "match_gap": 0.05})
    assert run(cell)["correct"]
    line = run(cell, altered_answer)
    assert not line["correct"] and line["failed"] >= 1


@pytest.mark.parametrize("name", ["motionformer_b16_train_r18", "motionformer_b16_train_r0"])
@pytest.mark.parametrize("fault", [UnchangedState, HalfBatch])
def test_a_broken_train_step_is_not_correct(name, fault):
    cell = tiny.cell(name, limits={"loss_gap": 1e-3, "grad_norm_gap": 0.1, "change_norm_gap": 0.5, "match_gap": 0.05})
    assert run(cell)["correct"]
    assert not run(cell, fault)["correct"]


@pytest.mark.parametrize("name", ["videomae_b16_serve_r0", "motionformer_b16_train_r0"])
def test_the_control_is_not_correct_on_the_cells_limits(name):
    cell = tiny.cell(name)
    cell.workload["limits"] = dict(tiny.cell(name).workload["limits"])
    assert not run(cell, control.program_for(cell, "control"))["correct"]
