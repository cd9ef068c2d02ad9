"""Phase 2 of the Continual Hyperparameter Framework — not ported yet.

Counterpart of ``clsurvey_tpu/framework/hyperparam.py``. This slice keeps
only the per-task phase-timing report that Phase-1-only methods write;
Phase 2 (``framework_single_task``: decay of the method hyperparameters
against the finetuning accuracy) comes with a later slice."""

from __future__ import annotations

import os

from clsurvey_torch.utils import io

PHASE_TIMING_FILENAME = "phase_timing.pth.tar"


def report_phase_timing(phase_times: dict, task_dir: str | None):
    """Print + pickle per-task phase wall-clock (ref:src/framework/
    framework_train.py:286-292). ``task_dir=None`` prints only."""
    for name, secs in phase_times.items():
        print(f"{name} elapsed_time = {secs:.2f}s")
    if phase_times and task_dir is not None:
        io.save(phase_times, os.path.join(task_dir, PHASE_TIMING_FILENAME))

