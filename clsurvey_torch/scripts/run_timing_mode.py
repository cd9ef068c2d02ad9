"""Per-phase wall-clock measurement under the reference's timing protocol.

The reference dedicates a runmode to timing comparisons
(ref:src/framework/main.py:289-300 ``overwrite_timing_args``): 4 tasks,
single lr=5e-3, batch 200, 10 epochs (no early stop), one finetune
iteration, collapsed EBLL autoencoder grid — then reports the per-task
phase timers (phase1 / presteps / convergence_iteration / postprocess,
ref:src/framework/framework_train.py:286-292).

This script runs that protocol for a method set over the protocol-shaped
synthetic dataset and collects each task's ``phase_timing.pth.tar`` into
``<out>.md``.

Counterpart of the JAX package's ``scripts/run_timing_mode.py``: the same
methods, runs and table, with ``--device`` (``cuda``, the default, raises
without a card; ``cpu``), a title line that names the device the run took
place on (the card's name and power limit as ``nvidia-smi`` prints them,
or CPU), and ``--out`` by default ``<CLSURVEY_ROOT>/survey/timing_mode``,
not under ``docs/``.

Run from the root of the repository:
    python -m clsurvey_torch.scripts.run_timing_mode [--methods SI,EWC,...]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time
import traceback

MODEL = "small_VGG9_cl_128_128"
GRID = "timing_mode"
PHASES = ("phase1", "presteps", "convergence_iteration", "postprocess")

# method -> (hyperparams DSL, static hyperparams DSL). EBLL's collapsed
# autoencoder grid mirrors the reference's timing overwrite
# (encoder_dims=[100], encoder_alphas=[1e-2], autoencoder_epochs=10).
METHODS = {
    "finetuning": (None, None),
    "SI": (None, None),
    "EWC": (None, None),
    "MAS": (None, None),
    "LWF": (None, None),
    "EBLL": (None, "0.01;10;1e-2;100"),
    "GEM": (None, "1024"),
    "ICARL": (None, "1024"),
    "packnet": (None, None),
    "HAT": (None, None),
}


def run(ds_name: str, methods, max_attempts: int, device: str = "cuda"):
    from clsurvey_torch.framework.common import RunArgs
    from clsurvey_torch.framework.main import main as run_main

    common = dict(model_name=MODEL, ds_name=ds_name,
                  runmode="timing_mode", gridsearch_name=GRID,
                  max_attempts_per_task=max_attempts, device=device)

    print("== first-task base model (SI dump) ==", flush=True)
    run_main(RunArgs(method_name="SI",
                     runmode="first_task_basemodel_dump",
                     model_name=MODEL, ds_name=ds_name,
                     num_epochs=10, batch_size=200,
                     lr_grid=(5e-3,), boot_lr_grid=(5e-3,),
                     device=device))

    statuses = {}
    for name in methods:
        hp, shp = METHODS[name]
        print(f"\n== {name} (timing_mode) ==", flush=True)
        t1 = time.time()
        try:
            run_main(RunArgs(method_name=name, hyperparams=hp,
                             static_hyperparams=shp, **common))
            statuses[name] = {"ok": True, "secs": round(time.time() - t1)}
        except Exception as e:
            traceback.print_exc()
            statuses[name] = {"ok": False, "error": str(e),
                              "secs": round(time.time() - t1)}
    return statuses


def collect(ds_name: str, methods, statuses, out: str,
            device: str = "cuda"):
    from clsurvey_torch.framework.hyperparam import PHASE_TIMING_FILENAME
    from clsurvey_torch.utils import io
    from clsurvey_torch.utils.config import load_config
    from clsurvey_torch.utils.device import describe

    cfg = load_config()
    rows = []
    for name in methods:
        pattern = os.path.join(cfg.tr_results_root_path, ds_name, name,
                               MODEL, "gridsearch", GRID, "*", "task_*",
                               PHASE_TIMING_FILENAME)
        per_task = {}
        for path in sorted(glob.glob(pattern)):
            task = os.path.basename(os.path.dirname(path))
            per_task[task] = io.load(path)
        rows.append((name, per_task))

    lines = [
        f"# timing_mode — per-phase wall-clock ({describe(device)})",
        "",
        "Protocol (ref:src/framework/main.py:289-300): 4 tasks, lr=5e-3,",
        "batch 200, 10 epochs, 1 finetune iteration, protocol-shaped",
        f"synthetic data (`{ds_name}`: 8,000 train imgs/task). Phases per",
        "task (ref:src/framework/framework_train.py:286-292): phase1 =",
        "maximal-plasticity LR grid, presteps = method preprocessing (EWC/",
        "MAS importance estimation, EBLL autoencoder), convergence_",
        "iteration = the converged Phase-2 attempt, postprocess = method",
        "poststep (iCaRL herding, GEM buffer fill). Task 1 reuses the",
        "shared SI base model for non-start-scratch methods (no row).", "",
        "All times in seconds.", "",
        "| method | task | phase1 | presteps | convergence | postprocess "
        "| total wall (method) |",
        "|---|---|---|---|---|---|---|",
    ]
    for name, per_task in rows:
        total = statuses.get(name, {}).get("secs", "")
        first = True
        if not per_task:
            lines.append(f"| {name} | — | | | | | {total} |")
            continue
        for task, times in per_task.items():
            cells = [f"{times.get(p, float('nan')):.1f}"
                     if times.get(p) is not None else "—" for p in PHASES]
            tot = str(total) if first else ""
            lines.append(f"| {name if first else ''} | {task} | "
                         + " | ".join(cells) + f" | {tot} |")
            first = False
    with open(out + ".md", "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(out + "_status.json", "w") as f:
        json.dump(statuses, f, indent=1)
    print("wrote", out + ".md")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--methods", default=",".join(METHODS))
    ap.add_argument("--tasks", type=int, default=10)
    ap.add_argument("--classes", type=int, default=20)
    ap.add_argument("--n", type=int, default=400)
    ap.add_argument("--max_attempts", type=int, default=10)
    ap.add_argument("--out", default=None,
                    help="stem of the table and status (default "
                         "<CLSURVEY_ROOT>/survey/timing_mode)")
    ap.add_argument("--collect_only", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu; "
                         "the table's title names it")
    a = ap.parse_args(argv)
    if a.out is None:
        from clsurvey_torch.utils.config import default_root
        a.out = os.path.join(default_root(), "survey", "timing_mode")
    ds_name = f"synthetic_{a.tasks}t_{a.classes}c_64px_{a.n}n"
    methods = [m for m in a.methods.split(",") if m]
    unknown = [m for m in methods if m not in METHODS]
    if unknown:
        ap.error(f"unknown timing methods {unknown}; "
                 f"choose from {list(METHODS)}")
    statuses = {}
    if not a.collect_only:
        statuses = run(ds_name, methods, a.max_attempts, a.device)
        print(json.dumps(statuses, indent=1))
    elif os.path.exists(a.out + "_status.json"):
        statuses = json.load(open(a.out + "_status.json"))
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    collect(ds_name, methods, statuses, a.out, a.device)


if __name__ == "__main__":
    main()
