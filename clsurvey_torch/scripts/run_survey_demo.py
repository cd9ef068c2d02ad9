"""Full-survey demo: every method through the complete pipeline.

Drives all 16 method variants (11 CL methods + 4 baselines + Joint) over a
10-task synthetic sequence in the Tiny-ImageNet shape regime (10 classes/
task, 64x64) through the full two-phase Continual Hyperparameter Framework,
the eval matrix, and the postprocessing/plot pipeline — the reference's
``main_tinyimagenet.sh`` protocol end-to-end
(ref:src/main_tinyimagenet.sh:28-39) at demo scale.

Counterpart of the JAX package's ``scripts/run_survey_demo.py``, with the
same variants, row store and rendering, and three differences: ``--device``
(``cuda``, the default, raises without a card; ``cpu``) in place of
``--cpu``; the default ``--out`` is ``<CLSURVEY_ROOT>/survey/survey_demo``,
not under ``docs/``, which holds the JAX package's committed tables; and
the figures are rendered only where matplotlib imports (``utilities/
plot.py`` is imported only then): elsewhere the table, the row store and
the summary are written, the figures are left as they are, and the script
says so.

Run from the root of the repository (on the card; add ``--device cpu``
for the CPU):
    python -m clsurvey_torch.scripts.run_survey_demo [--tasks 10] \
        [--epochs 12] [--out DIR/survey_demo] [--methods SI,EWC,...]

Per-run state is resumable: rerunning skips completed phases via the
framework's SUCCESS flags, so an interrupted sweep continues where it
stopped."""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

MODEL = "small_VGG9_cl_128_128"  # overridable via --model
GRID = "survey_demo"

# (method_name, decayed hyperparams DSL, static hyperparams DSL)
# demo-scale settings: reference defaults where feasible, reduced memory /
# generations for the 640-img/task synthetic set
METHODS = [
    ("SI", None, None),
    ("EWC", None, None),
    ("MAS", None, None),
    ("mean_IMM", None, None),
    ("mode_IMM", None, None),
    ("LWF", None, None),
    ("EBLL", None, "0.01;5;0.1;16"),
    ("GEM", None, "128"),
    ("ICARL", None, "128"),
    ("packnet", "0.75", None),
    # c=0.5 (not the survey's 2.5): at 640 imgs/task the CE gradient is
    # too weak to oppose the sparsity pressure, and the decay framework
    # would spend its attempts just discovering that
    ("HAT", "400,0.5", None),
    ("pathnet", "3", "8;5"),
    ("finetuning", None, None),
    ("finetuning_rehearsal_partial_mem", None, "64"),
    ("finetuning_rehearsal_full_mem", None, "128"),
    ("joint", None, None),
]

# HAT and PathNet train with the reference's momentum-less SGD + patience
# lr schedule (hat.py/pathnet.py Appr) and need a larger epoch budget to
# converge; at the shared demo budget they plateau near chance while the
# momentum-SGD engine methods converge (diagnosed: pathnet reaches 0.99
# val at 30 epochs vs 0.1 at 12).
EPOCHS_OVERRIDE = {"HAT": 60, "pathnet": 30}


def run_all(ds_name: str, epochs: int, batch_size: int,
            only=None, max_attempts: int = 3,
            lr_grid=(5e-2, 1e-2), boot_lr_grid=None, hp_overrides=None,
            shp_overrides=None, seed: int = 7, epochs_overrides=None,
            device: str = "cuda"):
    # Import every module the sweep will need up-front — including the
    # lazily-imported eval/postprocessing path — so code committed to the
    # repo mid-run can never be mixed into this process (a stale-paths /
    # fresh-evaluate split broke a prior sweep at eval time). The figures'
    # module is the exception: it needs matplotlib, which a machine that
    # only trains may not have.
    import clsurvey_torch.framework.evaluate  # noqa: F401
    import clsurvey_torch.utilities.postprocessing  # noqa: F401
    import clsurvey_torch.utils.orbax_io  # noqa: F401
    from clsurvey_torch.framework.common import RunArgs
    from clsurvey_torch.framework.main import main as run_main

    common = dict(model_name=MODEL, ds_name=ds_name, num_epochs=epochs,
                  batch_size=batch_size, lr_grid=tuple(lr_grid),
                  boot_lr_grid=tuple(boot_lr_grid) if boot_lr_grid else None,
                  gridsearch_name=GRID, max_attempts_per_task=max_attempts,
                  seed=seed, device=device)
    epoch_over = dict(EPOCHS_OVERRIDE)
    if epochs_overrides:
        epoch_over.update(epochs_overrides)

    t0 = time.time()
    print("== first-task base model (SI dump) ==", flush=True)
    run_main(RunArgs(method_name="SI",
                     runmode="first_task_basemodel_dump", **common))

    statuses = {}
    for name, hp, shp in METHODS:
        if only and name not in only:
            continue
        print(f"\n== {name} ==", flush=True)
        t1 = time.time()
        try:
            kw = dict(common)
            if name in epoch_over:
                # overrides RAISE the budget for the patience-controller
                # methods at demo scale; at protocol scale (>= the
                # override) every method gets the shared epoch budget
                kw["num_epochs"] = max(int(epoch_over[name]), epochs)
            if hp_overrides and name in hp_overrides:
                hp = hp_overrides[name]
            if shp_overrides and name in shp_overrides:
                shp = shp_overrides[name]
            run_main(RunArgs(method_name=name, test=True, hyperparams=hp,
                             static_hyperparams=shp, **kw))
            statuses[name] = {"ok": True, "secs": round(time.time() - t1)}
        except Exception as e:
            traceback.print_exc()
            statuses[name] = {"ok": False, "error": str(e),
                              "secs": round(time.time() - t1)}
    statuses["_total_secs"] = round(time.time() - t0)
    return statuses


def postprocess(ds_name: str, out_base: str, epochs: int | None = None):
    """Collect every method's eval artifacts, render the stacked plot and
    print the summary + hyperparam tables. Without matplotlib the figures
    (and the canonical record of what they cover) are left as they are."""
    import importlib.util

    from clsurvey_torch.utilities import postprocessing as post
    from clsurvey_torch.utils.config import load_config

    cfg = load_config()
    entries = []
    for name, _, _ in METHODS:
        method_entries = post.collect_gridsearch_exp_entries(
            cfg.test_results_root_path, ds_name, name, MODEL, GRID)
        entries.extend(method_entries)
    from clsurvey_torch import methods as methods_lib

    counts: dict = {}
    for e in entries:
        # the TRAIN tree is keyed by method.name (IMM variants share one,
        # eval_name differs)
        method_name = methods_lib.parse(e.eval_name).name
        post.collect_hyperparams(e, method_name, hyperparams_counts=counts)
    os.makedirs(os.path.dirname(out_base) or ".", exist_ok=True)
    rows, fresh = _merge_rows(entries, out_base)
    # Carried rows whose curves were persisted into the row store render
    # alongside the fresh artifacts — the figures are no longer hostage to
    # whatever happens to be in the current results tree (the runtime
    # trees die with the machine; the store is kept).
    carried = _carried_entries(rows, fresh)
    for e in carried:
        for k, vals in e.hyperparams.items():
            counts[k] = max(counts.get(k, 0), len(vals))
    all_entries = entries + carried
    hp_entries = _hp_entries(all_entries)
    post.pad_hyperparams(hp_entries, counts)
    # Canonical-figure policy: coverage is MONOTONE — the canonical names
    # update only when this render covers (fresh artifacts + stored
    # curves) a superset of what the current canonical figures cover
    # (tracked in <out>_canonical.json; if absent, the full row store —
    # the strict legacy policy). Anything narrower renders to
    # *_latestrun.* so committed evidence is never replaced by a subset
    # (a truncated table); an empty render touches nothing.
    canon_path = out_base + "_canonical.json"
    if os.path.exists(canon_path):
        with open(canon_path) as f:
            prior_covers = set(json.load(f)["covers"])
    else:
        prior_covers = set(rows)
    summary = "(no run artifacts in the current results tree; " \
              "table rendered from the row store)"
    figures = importlib.util.find_spec("matplotlib") is not None
    if all_entries and not figures:
        print("postprocess: matplotlib is not installed: the table, rows "
              "and summary are written, the figures are not rendered")
    if all_entries:
        covered = {e.eval_name for e in all_entries}
        canonical_ok = covered >= prior_covers
        base = out_base if canonical_ok else out_base + "_latestrun"
        # render onto the chosen names: the library never overwrites a
        # figure (reference parity, _versioned), but the docs link the
        # unsuffixed files — refresh those instead of accreting _vN copies
        for fig in (base + "_acc.png", base + "_forgetting.png"):
            if figures and os.path.exists(fig):
                os.unlink(fig)
        summary = post.analyze_experiments(
            all_entries, plot_seq_acc=True, plot_seq_forgetting=True,
            save_img_path=base if figures else None,
            all_diff_color_force=False)
        hp_table = post.print_hyperparam_table(hp_entries)
        with open(base + "_summary.txt", "w") as f:
            f.write(summary + "\n\n" + hp_table + "\n")
        if canonical_ok and figures:
            with open(canon_path, "w") as f:
                json.dump({"covers": sorted(covered)}, f, indent=1)
            # the canonical figures are now at least as fresh as any
            # partial refresh — drop the stale side files so the markdown
            # stops pointing readers at outdated curves
            for side in ("_latestrun_acc.png", "_latestrun_forgetting.png",
                         "_latestrun_summary.txt"):
                if os.path.exists(out_base + side):
                    os.unlink(out_base + side)
    _write_markdown(rows, fresh, out_base, ds_name, epochs)
    return all_entries, summary


def _hp_entries(entries):
    """Entries that belong in the converged-hyperparam table.

    no_framework methods (IMM) have no per-task hyperparam checkpoints —
    padding would render them as all-zero rows (mean_IMM/mode_IMM as
    ``0,0,...``), so they are excluded entirely;
    the summary table still carries them."""
    return [e for e in entries if e.hyperparams]


def _merge_rows(entries, out_base: str):
    """Fold the rows found in the CURRENT results tree into the persistent
    per-method row store (``<out>_rows.json``).

    A partial refresh (one method re-run, or a sweep cut by a cap) must
    never truncate the flagship table to whatever happens to be on disk
    at HEAD — it merges into the store, and the markdown renders the
    store. Rows record the commit + timestamp they were produced at so a
    reader can tell fresh rows from carried ones."""
    import subprocess
    rows_path = out_base + "_rows.json"
    rows = {}
    if os.path.exists(rows_path):
        with open(rows_path) as f:
            rows = json.load(f)
    try:
        head = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], capture_output=True,
            text=True, cwd=os.path.dirname(os.path.abspath(__file__))
        ).stdout.strip()
    except Exception:
        head = ""
    stamp = time.strftime("%Y-%m-%d")
    for e in entries:
        new = {
            "exp": e.exp_name, "avg_acc": round(e.avg_acc, 2),
            "avg_forgetting": (None if e.single_dot
                               else round(e.avg_forgetting, 2)),
            # persist the per-ref-task accuracy trajectories + converged
            # hyperparams so carried rows stay fully renderable after the
            # runtime results tree is gone (curves/figures were previously
            # unrecoverable once the VM died)
            "curves": {str(t): [round(float(v), 4) for v in e.seq_acc[t]]
                       for t in sorted(e.seq_acc)},
            "task_count": int(e.task_count),
            "hyperparams": {k: [_jsonable(v) for v in vals]
                            for k, vals in e.hyperparams.items()},
        }
        prev = rows.get(e.eval_name)
        if prev and all(prev.get(k) == v for k, v in new.items()):
            # same artifacts re-collected by a render — "produced at"
            # keeps pointing at the run that trained them, not at HEAD
            new["commit"] = prev.get("commit", head)
            new["date"] = prev.get("date", stamp)
        else:
            new["commit"], new["date"] = head, stamp
        rows[e.eval_name] = new
    with open(rows_path, "w") as f:
        json.dump(rows, f, indent=1)
    return rows, {e.eval_name for e in entries}


def _jsonable(v):
    if isinstance(v, (int, float, str, bool)) or v is None:
        return v
    if hasattr(v, "item"):  # numpy scalar
        return v.item()
    return float(v)


def _carried_entries(rows, fresh):
    """Reconstruct plot/table entries for row-store methods that are NOT
    in the current results tree but persisted their curves (``curves``
    key, written by :func:`_merge_rows`). Forgetting is
    recomputed from the stored accuracy series exactly like the live
    collector (postprocessing.collect)."""
    from clsurvey_torch.utilities.postprocessing import ExperimentDataEntry

    out = []
    for name, r in rows.items():
        if name in fresh or not r.get("curves"):
            continue
        e = ExperimentDataEntry("", name, "", "", r.get("exp", ""), "")
        e.seq_acc = {int(t): [float(v) for v in series]
                     for t, series in r["curves"].items()}
        e.seq_forgetting = {t: [s[0] - v for v in s[1:]]
                            for t, s in e.seq_acc.items()}
        e.task_count = int(r.get("task_count")
                           or (max(e.seq_acc) if e.seq_acc else 0))
        e.hyperparams = {k: list(v)
                         for k, v in r.get("hyperparams", {}).items()}
        out.append(e)
    return out


def _write_markdown(rows, fresh, out_base: str, ds_name: str = "",
                    epochs: int | None = None):
    """Render the merged row store as a Markdown results table.

    Rows whose artifacts are present in the current results tree are
    rendered plain; rows carried from the store (artifacts not on disk
    right now) are marked so the table never silently truncates NOR
    silently passes off stale rows as fresh. A hand-written
    ``<out>_notes.md`` (if present) is appended verbatim below the table
    so curated per-method explanations survive regeneration."""
    budget = f", {epochs} epochs/task" if epochs else ""
    title = (f"# Survey sweep — `{ds_name}`{budget}, full two-phase "
             "framework + eval matrix" if ds_name else
             "# Survey demo — all methods through the full pipeline")
    # hand-curated per-row caveats (<out>_flags.json: method -> text)
    # render INLINE so no headline number can outrun its own caveat
    # (rows the notes disavow must say so in the row)
    flags_path = out_base + "_flags.json"
    flags = {}
    if os.path.exists(flags_path):
        with open(flags_path) as f:
            flags = json.load(f)
    lines = [
        title, "",
        "| method | exp | avg acc (final model) | avg forgetting | "
        "produced at |",
        "|---|---|---|---|---|",
    ]
    for name_, r in sorted(rows.items(), key=lambda kv: -kv[1]["avg_acc"]):
        forg = ("n/a" if r["avg_forgetting"] is None
                else f"{r['avg_forgetting']:.2f}")
        if r.get("commit"):
            src = f"`{r['commit']}` {r['date']}"
            if name_ not in fresh:
                src += " (carried)"
        else:
            src = "(carried)" if name_ not in fresh else "—"
        acc = f"{r['avg_acc']:.2f}" + (" ⚠" if name_ in flags else "")
        lines.append(f"| {name_} | {r['exp']} | "
                     f"{acc} | {forg} | {src} |")
    for name_ in sorted(flags):
        if name_ in rows:
            lines.append(f"\n⚠ **{name_}** — {flags[name_]}")
    name = os.path.basename(out_base)
    lines += ["", f"![accuracy curves]({name}_acc.png)", "",
              f"![forgetting curves]({name}_forgetting.png)", ""]
    canon_path = out_base + "_canonical.json"
    if os.path.exists(canon_path):
        with open(canon_path) as f:
            covers = json.load(f)["covers"]
        lines += ["", f"(Canonical figures cover: {', '.join(covers)}. "
                  "Coverage is monotone: they update only when a render — "
                  "fresh artifacts plus row-store curves — covers a "
                  "superset of the above.)", ""]
        # rows whose curves were never persisted (older stores) and whose
        # runtime artifacts are gone cannot appear in any future render;
        # say so instead of letting the frozen coverage read as a bug
        stuck = [m for m in covers if m in rows and m not in fresh
                 and not rows[m].get("curves")]
        if stuck:
            lines += ["", f"(Curves for {', '.join(sorted(stuck))} predate "
                      "row-store curve persistence and their runtime "
                      "artifacts were cleaned, so the canonical figures "
                      "above are the only remaining render of them; "
                      "refreshes of the newer rows land in the "
                      "`*_latestrun.*` figures — the two sets together "
                      "are the full curve evidence.)", ""]
    if os.path.exists(out_base + "_latestrun_acc.png"):
        lines += ["", "(The most recent refresh's curves — every row with "
                  "persisted curves plus the current results tree — are in "
                  f"`{name}_latestrun_acc.png` / "
                  f"`{name}_latestrun_forgetting.png`.)", ""]
    notes_path = out_base + "_notes.md"
    if os.path.exists(notes_path):
        with open(notes_path) as f:
            lines += ["", f.read().rstrip(), ""]
    with open(out_base + ".md", "w") as f:
        f.write("\n".join(lines))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tasks", type=int, default=10)
    ap.add_argument("--classes", type=int, default=10)
    ap.add_argument("--px", type=int, default=64)
    ap.add_argument("--n", type=int, default=None,
                    help="train imgs per class (Tiny protocol: 400)")
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--batch_size", type=int, default=100)
    ap.add_argument("--max_attempts", type=int, default=3)
    ap.add_argument("--lr_grid", default="5e-2,1e-2",
                    help="protocol: 1e-2,5e-3,1e-3,5e-4,1e-4")
    ap.add_argument("--boot_lr_grid", default=None,
                    help="protocol: 1e-1,5e-2,1e-2,5e-3,1e-3,5e-4,1e-4")
    ap.add_argument("--hp", action="append", default=[],
                    help="per-method hyperparam override, e.g. HAT=800,2.5")
    ap.add_argument("--shp", action="append", default=[],
                    help="per-method static-hyperparam override, "
                         "e.g. GEM=1024 (protocol memory size)")
    ap.add_argument("--out", default=None,
                    help="stem of the table, rows, status, summary and "
                         "figures (default <CLSURVEY_ROOT>/survey/"
                         "survey_demo)")
    ap.add_argument("--seed", type=int, default=7,
                    help="training seed (results trees for different "
                         "seeds should use different --grid names)")
    ap.add_argument("--grid", default=None,
                    help="gridsearch name (default survey_demo); use a "
                         "distinct name per seed to keep trees apart")
    ap.add_argument("--epochs_override", action="append", default=[],
                    help="per-method epoch override, e.g. HAT=150 "
                         "(defaults: HAT=60, pathnet=30)")
    ap.add_argument("--methods", default=None,
                    help="comma-separated subset")
    ap.add_argument("--model", default=None,
                    help="model name (default small_VGG9_cl_128_128; "
                         "tiny_CNN_cl_32_32 for CPU drives)")
    ap.add_argument("--postprocess_only", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--ds_suffix", default="",
                    help="extra synthetic name segments, e.g. _hd200")
    a = ap.parse_args(argv)
    if a.out is None:
        from clsurvey_torch.utils.config import default_root
        a.out = os.path.join(default_root(), "survey", "survey_demo")
    if a.model:
        global MODEL
        MODEL = a.model
    if a.grid:
        global GRID
        GRID = a.grid
    ds_name = f"synthetic_{a.tasks}t_{a.classes}c_{a.px}px"
    if a.n:
        ds_name += f"_{a.n}n"
    ds_name += a.ds_suffix
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    if not a.postprocess_only:
        only = set(a.methods.split(",")) if a.methods else None
        hp_overrides = dict(s.split("=", 1) for s in a.hp)
        shp_overrides = dict(s.split("=", 1) for s in a.shp)
        statuses = run_all(
            ds_name, a.epochs, a.batch_size,
            only=only, max_attempts=a.max_attempts,
            lr_grid=tuple(float(x) for x in a.lr_grid.split(",")),
            boot_lr_grid=tuple(float(x) for x in a.boot_lr_grid.split(","))
            if a.boot_lr_grid else None,
            hp_overrides=hp_overrides, shp_overrides=shp_overrides,
            seed=a.seed,
            epochs_overrides=dict(s.split("=", 1)
                                  for s in a.epochs_override),
            device=a.device)
        print(json.dumps(statuses, indent=1))
        status_path = a.out + "_status.json"
        if only and os.path.isfile(status_path):
            # partial rerun: merge into the existing full-sweep statuses;
            # _total_secs accumulates across runs rather than being
            # overwritten by the partial run's (shorter) total
            with open(status_path) as f:
                merged = json.load(f)
            prior_total = merged.get("_total_secs", 0)
            merged.update(statuses)
            merged["_total_secs"] = prior_total + statuses.get(
                "_total_secs", 0)
            statuses = merged
        with open(status_path, "w") as f:
            json.dump(statuses, f, indent=1)
    postprocess(ds_name, a.out, epochs=a.epochs)


if __name__ == "__main__":
    main()
