"""On the card, at each cell's own size: the program's readings lie
within the cell's limits, while the control (the plain reference in the
program's place in float32 with TF32 on, the precision below the
configuration's float32 with TF32 off) and each fault planted in the
reference (half of each batch left out; one label altered) and the conv
weights frozen in the program (their gradient zero) fail at least one of
them. A state left unchanged reads 1 by the change's
measure. Run
on the GPU machine with ``python -m pytest clbench/tests -m cuda -q``."""

from __future__ import annotations

import pytest
import torch

from clbench import calibrate, check
from clbench.spec import Spec

CELLS = [w["name"] for w in Spec().bench["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_and_the_faults_fail(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    spec = Spec()
    limits = spec.workload(cell)["limits"]
    out = calibrate.readings(spec, cell, 2 ** 35 + 3, controls=True)
    ok, table, _ = check.verdict(out["program"], limits)
    assert ok, table
    for kind in ("control",) + calibrate.FAULTS + calibrate.PROGRAM_FAULTS:
        ok, table, _ = check.verdict(out[kind], limits)
        assert not ok, (kind, table)
