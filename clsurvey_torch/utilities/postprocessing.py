"""Result postprocessing — summary metrics + plot data collection.

Counterpart of ``clsurvey_tpu/utilities/postprocessing.py``, so that the
port reads and renders its own results. Consumes the eval result dicts
written by framework/evaluate.py
(``test_method_performances<eval_name><i>.pth``, ``i`` 0-based like the
reference's ``get_perf_output_filename``, ref:src/utilities/utils.py:220-228;
Joint's single ``test_method_performancesJOINT_FULL_BATCH.pth``) and
produces:

- per-method final-model average accuracy and average forgetting (the
  survey's summary table, ref:src/utilities/main_postprocessing.py:175-187);
- the converged-hyperparameter table (ref:main_postprocessing.py:373-409);
- per-ref-task accuracy curves for the horizontally-stacked plots
  (utilities/plot.py, imported only by :func:`analyze_experiments` when it
  renders: it needs matplotlib), with per-family colors / linestyles /
  markers (ref:main_postprocessing.py:83-151) and Joint as a single final
  dot with a repeated-value curve (ref:main_postprocessing.py:363-370).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from clsurvey_torch.utils import io

JOINT_FULL_BATCH_FILENAME = "test_method_performancesJOINT_FULL_BATCH.pth"

METHOD_COLORS = {
    # per-method plot colors (family-grouped like the reference,
    # ref:main_postprocessing.py:83-128)
    "SI": "tab:blue", "EWC": "tab:cyan", "MAS": "tab:purple",
    "mean_IMM": "navy", "mode_IMM": "royalblue",
    "LWF": "tab:green", "EBLL": "darkgreen",
    "GEM": "tab:red", "ICARL": "firebrick",
    "packnet": "tab:orange", "HAT": "gold", "pathnet": "peru",
    "finetuning": "gray", "joint": "black",
    "finetuning_rehearsal_partial_mem": "silver",
    "finetuning_rehearsal_full_mem": "dimgray",
}

# extra distinct colors when forcing all-different colors
# (ref:main_postprocessing.py:412-422 get_colors)
_FALLBACK_COLORS = ["C0", "C2", "C1", "C4", "C6", "C7", "C3", "C9", "C8",
                    "C5", "teal", "olive", "maroon", "indigo", "crimson",
                    "slategray"]


def get_colors(n: int) -> list:
    """n distinct colors, cycling matplotlib defaults then named colors."""
    colors = list(_FALLBACK_COLORS)
    while len(colors) < n:
        colors.append(f"C{len(colors) % 10}")
    return colors[:n]


def _family_style(eval_name: str):
    """(linestyle, marker, markersize, single_dot) by method family
    (ref:main_postprocessing.py:130-151 get_family_linestyle/marker)."""
    linestyle, marker, markersize, single_dot = "-", "1", 3, False
    try:
        from clsurvey_torch import methods
        from clsurvey_torch.methods.base import Category
        m = methods.parse(eval_name)
        cat = m.category
        if cat == Category.BASELINE:
            linestyle, marker = ":", "4"
        elif cat == Category.MASK_BASED:
            marker = "x"
        elif cat == Category.DATA_BASED:
            marker = 11  # CARETDOWNBASE
        elif cat == Category.MODEL_BASED:
            marker = "+" if "IMM" in eval_name else "1"
        if m.name == "joint":
            single_dot = True
    except Exception:
        if eval_name == "joint":
            linestyle, marker, single_dot = ":", "4", True
    return linestyle, marker, markersize, single_dot


@dataclass
class ExperimentDataEntry:
    """One curve/table row (ref:main_postprocessing.py:44-172)."""

    dataset_name: str
    eval_name: str
    model_name: str
    gridsearch_name: str
    exp_name: str
    results_dir: str
    label: str = ""
    color: str = ""
    between_head_acc: bool = False  # plot seq_head_acc instead of seq_res
    # filled by collect():
    seq_acc: dict = field(default_factory=dict)        # ref task -> [acc..]
    seq_forgetting: dict = field(default_factory=dict)
    task_count: int = 0
    # filled by collect_hyperparams(): key -> [value per task]
    hyperparams: dict = field(default_factory=dict)

    def __post_init__(self):
        if not self.label:
            self.label = self.eval_name
        if not self.color:
            self.color = METHOD_COLORS.get(self.eval_name, "tab:gray")
        (self.linestyle, self.marker, self.markersize,
         self.single_dot) = _family_style(self.eval_name)

    # --- metrics (ref:main_postprocessing.py:342-360) -----------------------
    @property
    def final_model_accs(self) -> list:
        """Accuracy of the FINAL model on each ref task."""
        return [self.seq_acc[t][-1] for t in sorted(self.seq_acc)]

    @property
    def avg_acc(self) -> float:
        accs = self.final_model_accs
        return float(np.mean(accs)) if accs else float("nan")

    @property
    def avg_forgetting(self) -> float:
        """Mean over tasks of first-model-acc minus final-model-acc; tasks
        with a single model (no later training) contribute 0
        (ref:main_postprocessing.py:354-358; the reference's
        seq_forgetting lists omit the self-comparison entry)."""
        f = [(self.seq_forgetting[t][-1] if self.seq_forgetting[t] else 0.0)
             for t in sorted(self.seq_forgetting)]
        return float(np.mean(f)) if f else float("nan")

    def plot_label(self) -> str:
        """Legend label with the summary appended
        (ref:main_postprocessing.py:425-432 get_plot_label; Joint gets a
        '*' and no forgetting, ref:main_postprocessing.py:169-171)."""
        if self.single_dot:
            return f"{self.label}*: {self.avg_acc:.2f} (n/a)"
        return (f"{self.label}: {self.avg_acc:.2f} "
                f"({self.avg_forgetting:.2f})")


def _unwrap_series(raw, dataset_index: int, taskcount: int) -> list:
    """The reference stores seq_res either as a one-key dict
    ``{dataset_index: [...]}`` or a flat list; truncate to the models that
    saw this task (ref:main_postprocessing.py:342-351)."""
    if isinstance(raw, dict):
        assert len(raw) == 1, f"expected one-key series dict, got {raw}"
        raw = next(iter(raw.values()))
    return list(raw)[: taskcount - dataset_index]


def collect(entry: ExperimentDataEntry, max_task_count: int | None = None
            ) -> ExperimentDataEntry:
    """Load the per-ref-task result dicts for one experiment.

    Handles all three reference artifact layouts: 0-based per-task files
    (the reference convention), legacy 1-based files from older runs of
    this repo, and Joint's single full-batch file whose per-task accuracy
    is repeated into a flat curve (ref:main_postprocessing.py:276-307,
    363-370 reformat_single_sequence)."""
    joint_path = os.path.join(entry.results_dir, JOINT_FULL_BATCH_FILENAME)
    if io.exists(joint_path):
        raw = io.load(joint_path)[entry.eval_name]["seq_res"]
        if isinstance(raw, dict):
            # dict layouts: the reference's one-key {0: [full list]} wrap,
            # and our restricted-range {dataset_index: [acc]} extension —
            # a multi-element list value spreads from its start index
            pairs = {}
            for k, v in raw.items():
                if isinstance(v, (list, tuple)):
                    for i, acc in enumerate(v):
                        pairs[int(k) + i] = acc
                else:
                    pairs[int(k)] = v
        else:
            pairs = dict(enumerate(raw))
        T = max(pairs) + 1 if pairs else 0
        if max_task_count is not None:
            T = min(T, max_task_count)
        for t, acc in sorted(pairs.items()):
            if t >= T:
                continue
            curve = [acc] * (T - t)
            entry.seq_acc[t + 1] = curve
            entry.seq_forgetting[t + 1] = [curve[0] - v for v in curve[1:]]
        # an entry truncated to nothing must not survive the collected
        # filter (mirrors the per-task branch below)
        entry.task_count = T if entry.seq_acc else 0
        return entry

    # collect the 0-based per-task files actually present (a restricted
    # --test_starting_task_count run may not include index 0; a partial
    # eval may stop early — neither should shift or truncate other tasks)
    import re

    prefix = f"test_method_performances{entry.eval_name}"
    pat = re.compile(re.escape(prefix) + r"(\d+)\.pth$")
    indices = sorted(
        int(m.group(1)) for m in
        (pat.fullmatch(fn) for fn in (os.listdir(entry.results_dir)
                                      if os.path.isdir(entry.results_dir)
                                      else []))
        if m)
    acc_raw = {}
    src_idx = {}
    for idx in indices:
        res = io.load(os.path.join(entry.results_dir,
                                   f"{prefix}{idx}.pth"))[entry.eval_name]
        key = "seq_head_acc" if entry.between_head_acc else "seq_res"
        # the artifact's own one-key {dataset_index: [...]} dict is the
        # authority on which ref task it holds (ref:eval.py:178-180);
        # the filename index is only a fallback for flat-list artifacts
        # (this is what makes legacy 1-based-named files read correctly)
        sr = res.get("seq_res")
        di = (int(next(iter(sr))) if isinstance(sr, dict) and len(sr) == 1
              else idx)
        if max_task_count and di >= max_task_count:
            continue
        if di + 1 in acc_raw and src_idx[di + 1] == di:
            continue  # canonically-named file already supplied this task
        acc_raw[di + 1] = res[key]
        src_idx[di + 1] = idx
    # the sequence length is implied by the longest series (task i's
    # series has taskcount-i entries when eval completed), never by the
    # number of files found
    taskcount = max(
        [idx - 1 + len(_unwrap_series(raw, 0, 10 ** 9))
         for idx, raw in acc_raw.items()], default=0)
    for t in sorted(acc_raw):
        series = _unwrap_series(acc_raw[t], t - 1, taskcount)
        if not series:
            continue
        entry.seq_acc[t] = series
        # forgetting recomputed from the accuracy series, like the
        # reference (ref:main_postprocessing.py:354-358)
        entry.seq_forgetting[t] = [series[0] - v for v in series[1:]]
    # entries whose chosen metric is empty everywhere (e.g.
    # between_head_acc over artifacts that never populate seq_head_acc)
    # must not survive the collected filter
    entry.task_count = taskcount if entry.seq_acc else 0
    return entry


def collect_gridsearch_exp_entries(test_results_root_path: str,
                                   ds_name: str, eval_name: str,
                                   model_name: str, gridsearch_name: str,
                                   experiment_selection=None,
                                   exp_name_contains: str | None = None,
                                   exp_name_not_containing: str | None = None,
                                   label_prefix: str = "",
                                   label_func=None,
                                   colors: list | None = None,
                                   between_head_acc: bool = False) -> list:
    """Scan a gridsearch's test-results tree for experiments
    (ref:main_postprocessing.py:190-258)."""
    parent = os.path.join(test_results_root_path, "results", ds_name,
                          eval_name, model_name, gridsearch_name)
    if experiment_selection:
        if not isinstance(experiment_selection, list):
            experiment_selection = [experiment_selection]
        exp_names = [x.strip() for x in experiment_selection]
    elif os.path.isdir(parent):
        exp_names = sorted(
            d for d in os.listdir(parent)
            if os.path.isdir(os.path.join(parent, d)))
    else:
        return []
    if exp_name_contains:
        exp_names = [n for n in exp_names if exp_name_contains in n]
    if exp_name_not_containing:
        exp_names = [n for n in exp_names
                     if exp_name_not_containing not in n]
    entries = []
    for idx, exp_name in enumerate(exp_names):
        exp_dir = os.path.join(parent, exp_name)
        if label_func:
            label = label_func(exp_name)
        else:
            label = (label_prefix + eval_name) if label_prefix else eval_name
        entry = ExperimentDataEntry(
            ds_name, eval_name, model_name, gridsearch_name, exp_name,
            exp_dir, label=label,
            color=(colors[idx] if colors else ""),
            between_head_acc=between_head_acc)
        entries.append(collect(entry))
    return [e for e in entries if e.task_count > 0]


def collect_hyperparams(entry: ExperimentDataEntry, method_name: str,
                        hyperparams_selection: list | None = None,
                        hyperparams_counts: dict | None = None) -> dict:
    """Per-task converged hyperparameters from the TRAIN results tree
    (``task_N/TASK_TRAINING/hyperparams.pth.tar``,
    ref:main_postprocessing.py:318-338 + collect_hyperparams :373-392).
    Returns the shared ``hyperparams_counts`` used for table padding."""
    from clsurvey_torch.utils import paths as paths_lib

    counts = hyperparams_counts if hyperparams_counts is not None else {}
    for task in range(1, max(entry.task_count, 1) + 1):
        path = os.path.join(
            paths_lib.get_train_results_path(
                entry.dataset_name, method_name, entry.model_name,
                entry.gridsearch_name, entry.exp_name, task_counter=task,
                create=False),
            "TASK_TRAINING", "hyperparams.pth.tar")
        if not io.exists(path):
            continue
        try:
            hdict = io.load(path)
        except Exception:
            continue
        # the converged values live in state.hyperparams; flatten them plus
        # the top-level scalars, like the reference's key iteration
        flat = {k: v for k, v in hdict.items()
                if not isinstance(v, dict)}
        flat.update(hdict.get("state", {}).get("hyperparams", {}))
        keys = hyperparams_selection or list(flat.keys())
        for key in keys:
            if key not in flat:
                continue
            entry.hyperparams.setdefault(key, []).append(flat[key])
            counts[key] = max(counts.get(key, 0),
                              len(entry.hyperparams[key]))
    return counts


def pad_hyperparams(entries: list, hyperparams_counts: dict,
                    pad_value=0) -> None:
    """Pad per-entry hyperparam lists to the max count so they tabulate
    (ref:main_postprocessing.py:395-409 pad_dataframe)."""
    for key, count in hyperparams_counts.items():
        for e in entries:
            vals = e.hyperparams.setdefault(key, [])
            vals.extend([pad_value] * (count - len(vals)))


def print_hyperparam_table(entries: list, table_sep: str = "\t") -> str:
    """Per-method converged-hyperparameter table (the reference renders
    this as a dataframe next to the summary,
    ref:main_postprocessing.py:405-433)."""
    keys = sorted({k for e in entries for k in e.hyperparams})
    lines = [table_sep.join(["method", "exp"] + keys)]
    for e in entries:
        row = [e.eval_name, e.exp_name]
        for k in keys:
            vals = e.hyperparams.get(k, [])
            row.append(",".join(
                f"{v:.4g}" if isinstance(v, float) else str(v)
                for v in vals))
        lines.append(table_sep.join(row))
    table = "\n".join(lines)
    print(table)
    return table


def print_exp_statistics(entries: list, table_sep: str = "\t") -> str:
    """Summary table: avg acc / avg forgetting of the final model
    (ref:main_postprocessing.py:175-187)."""
    lines = ["-" * 50, "SUMMARY", "-" * 50,
             table_sep.join(["'EXPERIMENT'", "'AVG ACC(FINAL MODEL)'",
                             "'AVG FORGETTING(FINAL MODEL)'"])]
    for e in entries:
        lines.append(table_sep.join([
            e.label, f"{e.avg_acc:.2f}", f"({e.avg_forgetting:.2f})"]))
    table = "\n".join(lines)
    print(table)
    return table


def _versioned(path: str) -> str:
    """Never overwrite a rendered figure: suffix _v2, _v3, ...
    (ref:main_postprocessing.py:483-488)."""
    if not os.path.exists(path):
        return path
    stem, ext = os.path.splitext(path)
    n = 2
    while os.path.exists(f"{stem}_v{n}{ext}"):
        n += 1
    return f"{stem}_v{n}{ext}"


def analyze_experiments(entries: list, plot_seq_acc: bool = True,
                        plot_seq_forgetting: bool = False,
                        save_img_path: str | None = None,
                        img_extention: str = "png",
                        legend_location: str = "top",
                        all_diff_color_force: bool = False,
                        label_avg_plot_acc: bool = True,
                        ylim=None, taskcount: int | None = None) -> str:
    """Pipeline: collect -> plot -> summary (ref:main_postprocessing.py:
    12-41). ``all_diff_color_force`` overrides family colors with a
    distinct-per-entry palette (ref:main_postprocessing.py:479-480)."""
    entries = [e for e in entries if e.task_count > 0]
    if all_diff_color_force:
        for e, c in zip(entries, get_colors(len(entries))):
            e.color = c
    if label_avg_plot_acc:
        plot_entries = []
        for e in entries:
            import copy

            pe = copy.copy(e)
            pe.label = e.plot_label()
            plot_entries.append(pe)
    else:
        plot_entries = entries
    if save_img_path and entries:
        from clsurvey_torch.utilities import plot as plot_lib

        os.makedirs(os.path.dirname(save_img_path) or ".", exist_ok=True)
        if plot_seq_acc:
            plot_lib.plot_line_horizontal_sequence(
                plot_entries,
                _versioned(save_img_path + "_acc." + img_extention),
                metric="acc", ylim=ylim, legend=legend_location,
                taskcount=taskcount)
        if plot_seq_forgetting:
            plot_lib.plot_line_horizontal_sequence(
                plot_entries,
                _versioned(save_img_path + "_forgetting." + img_extention),
                metric="forgetting", ylim=ylim, legend=legend_location,
                taskcount=taskcount)
    return print_exp_statistics(entries)
