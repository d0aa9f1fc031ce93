"""Readings that set the limits of ``correct``, on the card:

    python3 portbench/control.py --workload <cell> --mode <mode> --seeds 1,2,3 [--seconds 2]

Runs the cell once a seed in one process, with a short window, and prints
one JSON line a seed with the numbers compared. ``--mode``:

* ``program``: the program, as a run of the benchmark drives it;
* ``control``: the plain reference computed in fp8 (e4m3, per-tensor
  scales), the precision below the configuration's bf16, in the program's
  place;
* ``half_batch`` (training): the float32 reference stepping on half of each
  batch, the mean taken over it, in the program's place.

The benchmark's own runs never run this.
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


class ReferenceStepper:
    """The reference's training step in the program's place."""

    def __init__(self, cell, params, batch, device, recorder, num, rows):
        ref_mod, _ = cell.family_modules
        solver = cell.config["port"]["SOLVER"]
        self.cell, self.num, self.rows, self.ref, self.recorder = cell, num, rows, ref_mod, recorder
        self.p = {k: t.clone() for k, t in params.items()}
        self.opt = ref_mod.AdamW(self.p, lr=solver["BASE_LR"] * solver["LRS"][0], wd=solver["WEIGHT_DECAY"])

    def step(self, frames, labels):
        from portbench.reference.common import exact_fp32

        with exact_fp32():
            loss, grads, _ = self.ref.loss_and_grads(self.p, frames[self.rows], labels[self.rows], self.cell.model,
                                                     self.cell.r, self.num, record=self.recorder.sink)
        self.opt.step(self.p, grads)
        return loss

    def first_gradients(self):
        return {k: m / (1 - self.opt.betas[0]) for k, m in self.opt.m.items()}

    def params(self):
        return self.p


def reference_forward(num):
    def make(cell, params, batch, device, recorder):
        from portbench.reference.common import exact_fp32

        ref_mod, _ = cell.family_modules

        def forward(video):
            with exact_fp32():
                return ref_mod.logits(params, video, cell.model, cell.r, num, record=recorder.sink)[0]

        return forward, params

    return make


def program_for(cell, mode: str):
    from portbench.reference.common import NUMERICS

    if mode == "program":
        return None
    if cell.traffic["kind"] == "serve":
        if mode != "control":
            raise SystemExit(f"{mode} is a training fault")
        return reference_forward(NUMERICS["fp8_e4m3"])
    num = NUMERICS["fp8_e4m3" if mode == "control" else "fp32"]
    rows = slice(None) if mode == "control" else slice(0, cell.traffic["batch"] // 2)
    return lambda c, params, batch, device, recorder: ReferenceStepper(c, params, batch, device, recorder, num, rows)


def main(argv=None, cell=None, device=None) -> list:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--mode", choices=("program", "control", "half_batch"), default="program")
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.core import driver, program, spec

    cell = cell or spec.load_cell(args.workload)
    if device is None:
        device = torch.device("cuda", 0)
        program.build_kernels()
    out = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        line = driver.run_cell(cell, seed, args.seconds, False, device, t0, program_for(cell, args.mode), detail := {})
        record = {"workload": cell.name, "mode": args.mode, "seed": seed,
                  "numbers": {k: v["value"] for k, v in line["checks"].items()},
                  "metrics": {k: v["value"] for k, v in line["metrics"].items()},
                  "attempted": line["attempted"], "detail": detail, "peak": line["device"]["memory_peak_bytes"],
                  "seconds": time.perf_counter() - t0}
        print(json.dumps(record), flush=True)
        out.append(record)
    return out


if __name__ == "__main__":
    main()
