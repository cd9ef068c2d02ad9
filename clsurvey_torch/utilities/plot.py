"""Horizontally-stacked per-task accuracy curves, reference visual design
(ref:src/utilities/plot.py:10-246 ``plot_line_horizontal_sequence``).

Counterpart of ``clsurvey_tpu/utilities/plot.py``. All task panels share ONE
axis: panel ``i`` (showing reference task ``t``) is drawn shifted right by
``i * taskcount + t`` so each curve starts at the x position of the task
that produced its first model.  Panels get a whitesmoke background span,
per-task minor gridlines labeled ``T<t>``, a twin top axis labeled
"Evaluation on Task", and an expanded multi-column legend.  Per-curve
colors / linestyles / markers come from the entries (set by family in
utilities/postprocessing.py, mirroring
ref:src/utilities/main_postprocessing.py:83-151); "single dot" entries
(Joint) plot only their final point (ref:plot.py:68-71).

Needs matplotlib, which nothing else in the port imports: import this
module only to render a figure. Without matplotlib the import raises an
``ImportError`` that names it.
"""

from __future__ import annotations

import numpy as np

try:
    import matplotlib
except ImportError as e:
    raise ImportError("clsurvey_torch.utilities.plot renders figures with "
                      "matplotlib, which is not installed") from e

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

# panels shown when the sequence is longer than 10 tasks
# (ref:src/utilities/plot.py:38)
def _long_seq_panels(T: int, n: int = 5):
    """n evenly spaced evaluation panels across a long task sequence
    (covers the full range for any T, e.g. T=40 -> 0,10,20,29,39)."""
    return sorted({round(i * (T - 1) / (n - 1)) for i in range(n)})


def _entry_style(e, idx: int):
    """Fetch per-curve style with defaults for plain entries."""
    return dict(
        color=getattr(e, "color", f"C{idx % 10}"),
        linestyle=getattr(e, "linestyle", "-"),
        marker=getattr(e, "marker", "o"),
        markersize=getattr(e, "markersize", 3),
        single_dot=bool(getattr(e, "single_dot", False)),
    )


def plot_line_horizontal_sequence(entries, save_img_path: str,
                                  metric: str = "acc", ylim=None,
                                  legend: str = "top",
                                  labelmode: str = "minor",
                                  start_y_zero: bool = False,
                                  taskcount: int | None = None,
                                  ylabel: str | None = None,
                                  xlabel: str = "Training Sequence Per Task",
                                  figsize: tuple = (20, 8),
                                  figsize_per_task: float | None = None,
                                  dpi: int = 120):
    """Render the stacked-panel figure for a list of
    ``ExperimentDataEntry``-like objects.

    :param metric: 'acc' (seq_acc) or 'forgetting' (seq_forgetting)
    :param legend: 'top' (above the axes) or anything else (below)
    :param labelmode: 'minor' labels each panel's own task tick;
        'major' labels panel centers T1 (ref:plot.py:117-148)
    :param taskcount: panel width; defaults to the longest sequence
    """
    entries = [e for e in entries if getattr(e, "task_count", 0) > 0]
    if not entries:
        raise ValueError("no collected entries to plot")
    T = taskcount or max(e.task_count for e in entries)
    task_idxs = (list(range(T)) if T <= 10 else
                 _long_seq_panels(T))
    if figsize_per_task:  # back-compat: width scales with panel count
        figsize = (figsize_per_task * len(task_idxs) * 1.4, figsize[1] * 0.6)

    fig, ax = plt.subplots(figsize=figsize)
    minor_pos, major_pos = [], []
    legend_entries = []  # entries in the order their legend labels appear
    for i, t in enumerate(task_idxs):
        shift = i * T + t
        for idx, e in enumerate(entries):
            series = (e.seq_acc if metric == "acc" else e.seq_forgetting)
            data = series.get(t + 1)  # entries key ref tasks 1-based
            if not data:
                continue
            st = _entry_style(e, idx)
            x = np.arange(len(data)) + shift
            y = np.asarray(data, dtype=float)
            if st["single_dot"]:  # e.g. Joint: final point only
                x, y, st["markersize"] = x[-1:], y[-1:], 12
            # label on the entry's FIRST plotted panel (not panel 0 — a
            # restricted-range entry may have no task-1 series at all)
            label = e.label if e not in legend_entries else None
            if label is not None:
                legend_entries.append(e)
            ax.plot(x, y, color=st["color"], linestyle=st["linestyle"],
                    marker=st["marker"], markersize=st["markersize"],
                    linewidth=1.5, label=label)
        # panel background + gridline anchors (ref:plot.py:88-106)
        ax.axvspan(i * T + 0.1, (i + 1) * T - 0.1,
                   facecolor="whitesmoke", alpha=1.0)
        minor_pos.append(shift)
        # in-panel anchor, clamped inside the panel for short sequences
        major_pos.append(i * T + max(0, min(T - 1, round(T / 2 - 4))))

    panel_labels = [f"T{t + 1}" for t in task_idxs]
    if labelmode == "major":
        ax.set_xticks(major_pos)
        ax.set_xticklabels(["T1"] * len(major_pos))
    else:  # 'minor' default: label each panel's own-task tick
        ax.set_xticks(minor_pos, minor=True)
        ax.set_xticklabels(panel_labels, minor=True)
        ax.set_xticks(major_pos, minor=False)
        ax.set_xticklabels([], minor=False)
    ax.tick_params(axis="y", which="major", labelsize=18)
    ax.tick_params(axis="x", which="minor", labelsize=16)
    ax.tick_params(axis="x", which="major", labelsize=16, length=0)
    ax.xaxis.grid(True, linestyle="--", alpha=0.4, which="minor")
    ax.xaxis.grid(True, linestyle="-", alpha=0.8, which="major",
                  color="white")
    ax.set_xlim(-1, len(task_idxs) * T + 1)
    if ylim is not None:
        ax.set_ylim(top=ylim[1] if isinstance(ylim, (tuple, list))
                    else ylim)
        if isinstance(ylim, (tuple, list)):
            ax.set_ylim(bottom=ylim[0])
    if start_y_zero:
        ax.set_ylim(bottom=0)
    if ylabel is None:
        ylabel = ("Accuracy %" if metric == "acc" else "Forgetting %")
    ax.set_xlabel(xlabel, fontsize=19, labelpad=5)
    ax.set_ylabel(ylabel, fontsize=19, labelpad=5)

    # legend: expanded multi-column strip above or below (ref:plot.py:172-189)
    anchor = ((0.0, 1.20, 1.0, 0.1) if legend == "top"
              else (0.0, -0.36, 1.0, -0.136))
    leg = ax.legend(bbox_to_anchor=anchor, loc="upper center", ncol=4,
                    prop={"size": 16}, mode="expand", fancybox=True)
    if leg is not None:
        handles = getattr(leg, "legend_handles",
                          getattr(leg, "legendHandles", []))
        # handles appear in label order == legend_entries order (NOT the
        # entries list order: label-less entries produce no handle)
        for handle, e in zip(handles, legend_entries):
            if getattr(e, "single_dot", False):
                # marker-only: 'None' (a dashed style at linewidth 0 makes
                # matplotlib's scaled dash list all-zero and raises)
                handle.set_linestyle("None")
            else:
                handle.set_linewidth(2.0)

    # twin top axis: which task each panel evaluates (ref:plot.py:191-208)
    ax_top = ax.twiny()
    ax_top.set_xlim(*ax.get_xlim())
    # panel centers for any T (the reference hardcodes its 10-task offsets)
    ax_top.set_xticks([i * T + (T - 1) / 2.0 for i in range(len(task_idxs))])
    ax_top.set_xticklabels(panel_labels)
    ax_top.tick_params(axis="both", which="both", length=0)
    ax_top.tick_params(axis="x", which="major", labelsize=16)
    ax_top.set_xlabel("Evaluation on Task", fontsize=19, labelpad=10)

    fig.savefig(save_img_path, dpi=dpi, bbox_inches="tight")
    plt.close(fig)
    return save_img_path


def save_image_grid(images, save_img_path: str, labels=None,
                    denormalize: bool = False,
                    mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225),
                    ncol: int = 8, title: str | None = None):
    """Save a grid of images — the exemplar visual check
    (ref:src/utilities/plot.py:223-246 ``imshow_tensor``; caller
    ref:src/methods/rehearsal/model/gem.py:375-387 dumps rehearsal-memory
    samples for manual inspection).

    :param images: (N,H,W,3) uint8 or float array (NHWC — our resident
        memory layout, not torch's CHW)
    :param denormalize: undo ImageNet normalization for float inputs
    """
    images = np.asarray(images)
    if images.dtype == np.uint8:
        images = images.astype(np.float32) / 255.0
    elif denormalize:
        images = images * np.asarray(std) + np.asarray(mean)
    images = np.clip(images, 0.0, 1.0)
    n = images.shape[0]
    ncol = min(ncol, max(n, 1))
    nrow = (n + ncol - 1) // ncol
    fig, axes = plt.subplots(nrow, ncol,
                             figsize=(1.6 * ncol, 1.6 * nrow + 0.4),
                             squeeze=False)
    for i in range(nrow * ncol):
        axi = axes[i // ncol][i % ncol]
        axi.axis("off")
        if i < n:
            axi.imshow(images[i])
            if labels is not None:
                axi.set_title(str(labels[i]), fontsize=8)
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(save_img_path, dpi=100)
    plt.close(fig)
    return save_img_path
