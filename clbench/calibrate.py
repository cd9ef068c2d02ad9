"""The readings a cell's correctness limits are set from, on the card.

    python3 -m clbench.calibrate --workload <cell> --seeds 1,2,3 [--controls 3]

For each seed, in one process: the cell's set-up as a run makes it (the
program's first steps and its eval through the window's own calls, no
window), then the check's numbers of the program against the float64
reference. For the first ``--controls`` seeds also those of the control
(the reference put in the program's place, in float32 with TF32 on: the
precision below the configuration's float32 with TF32 off), of the faults
a training cell can have, planted in the reference put in the program's
place (``FAULTS``: half of each batch left out; one label of each step
altered), and of a fault planted in the program's conv weight gradient
(``PROGRAM_FAULTS``: the conv weights frozen, their gradient zero). A step
that leaves its state unchanged reads 1 by the change's measure and needs
no run. One JSON line a seed; the limits go in the cell's traffic file,
between the program's largest reading and the smallest reading of the
control or a fault that fails."""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from clbench import check, harness
from clbench.run import environment
from clbench.spec import Spec

FAULTS = ("half_batch", "label")
PROGRAM_FAULTS = ("frozen_conv",)


def _frozen(x, dy, w_shape, *args, **kwargs):
    return torch.zeros(w_shape, device=x.device, dtype=x.dtype)


@contextlib.contextmanager
def planted(fault: str | None):
    """The program's conv weight gradient (``ops/conv.py:weight_grad``,
    which runs on the card in float32) replaced as ``fault`` says."""
    if fault is None:
        yield
        return
    from clsurvey_torch.ops import conv

    orig = conv.weight_grad
    conv.weight_grad = {"frozen_conv": _frozen}[fault]
    try:
        yield
    finally:
        conv.weight_grad = orig


def program(spec: Spec, name: str, seed: int, device: str,
            fault: str | None = None) -> tuple[dict, dict]:
    """(the program's readings, the reference's inputs) of a run's
    set-up, with ``fault`` planted."""
    wl = spec.workload(name)
    cell = harness.Cell(spec.config(wl["config"]), wl, seed, device)
    dev = cell.dev
    with planted(fault):
        prog = harness.first_steps(cell)
    inputs = harness.reference_inputs(cell, prog)
    del cell
    harness._free(dev)
    return prog, inputs


def readings(spec: Spec, name: str, seed: int, controls: bool,
             device: str = "cuda") -> dict:
    wl = spec.workload(name)
    cfg = spec.config(wl["config"])
    dev = torch.device(device)
    t0 = time.perf_counter()
    prog, inputs = program(spec, name, seed, device)
    t1 = time.perf_counter()
    ref, p0 = harness.reference(cfg, wl, dev, inputs)
    t2 = time.perf_counter()
    out = {"seed": seed, "program": check.numbers(prog, ref, p0),
           "setup_s": t1 - t0, "reference_s": t2 - t1}
    if controls:
        ctrl, _ = harness.reference(cfg, wl, dev, inputs,
                                    dtype=torch.float32, tf32=True)
        out["control"] = check.numbers(ctrl, ref, p0)
        for fault in FAULTS:
            bad, _ = harness.reference(cfg, wl, dev, inputs, fault=fault)
            out[fault] = check.numbers(bad, ref, p0)
        del inputs
        for fault in PROGRAM_FAULTS:
            # the eval is judged from the weights the faulty run reached
            bad, bad_inputs = program(spec, name, seed, device, fault)
            bad_ref, _ = harness.reference(cfg, wl, dev, bad_inputs)
            out[fault] = check.numbers(bad, bad_ref, p0)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m clbench.calibrate")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True,
                        help="comma-separated seeds")
    parser.add_argument("--controls", type=int, default=3,
                        help="seeds (the first ones) that also read the "
                             "control and the faults")
    args = parser.parse_args(argv)
    environment()
    if not torch.cuda.is_available():
        print("clbench.calibrate: no CUDA card", file=sys.stderr)
        return 3
    spec = Spec()
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(spec, args.workload, seed,
                                  i < args.controls)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
