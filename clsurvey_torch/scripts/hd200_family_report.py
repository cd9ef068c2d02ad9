"""Family-ordering comparison: the hd200 protocol table vs the survey.

The TPAMI survey's accuracy claims on real Tiny-ImageNet are not
reproducible without the real datasets (docs/DEVIATIONS.md), so the
operative accuracy evidence is ORDINAL: does the full-budget hard-mode
table order the method FAMILIES the way the survey's experiments do?
(That comparison is the achievable stand-in for the TPAMI +-0.5%
target.)

Reads a row store (``<out>_rows.json`` of ``run_survey_demo``, e.g. the
JAX package's ``docs/soak_hd200_rows.json``), aggregates by family, and
checks each of the survey's qualitative findings that has a counterpart in
this regime. Counterpart of the JAX package's
``scripts/hd200_family_report.py``: the same report, with the rows file
and the output path as arguments; it never writes under ``docs/``:
    python -m clsurvey_torch.scripts.hd200_family_report ROWS_JSON OUT_MD

Survey findings referenced (ref:README.md of the reference +
ref:src/main_tinyimagenet.sh protocol; TPAMI '21 survey, Sec. 7):
  F1  joint is the upper bound no CL method reaches
  F2  naive finetuning shows the worst forgetting
  F3  replay/rehearsal methods are the strongest CL family on accuracy
  F4  importance-based (EWC/SI/MAS) keep forgetting small but trade
      plasticity (accuracy clusters below the best families)
  F5  distillation (LwF/EBLL) is competitive when task data stays
      in-distribution for the teacher (the shared-basis generator is
      the friendly case)
  F6  mask/parameter-isolation methods (PackNet/HAT) give (near-)zero
      forgetting by construction, at a capacity cost that grows with
      the task count
  F7  IMM's merge trades final accuracy for backward transfer
"""

from __future__ import annotations

import argparse
import json
import os

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

FAMILIES = {
    "baseline": ["finetuning"],
    "joint (upper bound)": ["joint"],
    "importance": ["EWC", "SI", "MAS"],
    "distillation": ["LWF", "EBLL"],
    "model-merge (IMM)": ["mean_IMM", "mode_IMM"],
    "replay (method)": ["GEM", "ICARL"],
    "replay (baseline)": ["finetuning_rehearsal_partial_mem",
                          "finetuning_rehearsal_full_mem"],
    "mask/isolation": ["packnet", "HAT", "pathnet"],
}


def build_report(rows):

    def acc(m):
        return rows[m]["avg_acc"] if m in rows else None

    def forg(m):
        return rows[m].get("avg_forgetting") if m in rows else None

    lines = [
        "# hd200 family ordering vs the survey's findings",
        "",
        "Generated by `scripts/hd200_family_report.py` from the "
        "protocol-budget hard-mode row store "
        "([soak_hd200.md](soak_hd200.md): 70 epochs, 5-lr grid, "
        "10-attempt decay, Bayes-limited `_hd200` data — the regime "
        "where families are distinguishable). Ordinal comparison "
        "against the survey's qualitative findings; the absolute "
        "TPAMI numbers are unreachable without the real datasets "
        "(DEVIATIONS.md).",
        "",
        "## Family aggregates",
        "",
        "| family | methods present | mean acc | mean forgetting |",
        "|---|---|---|---|",
    ]
    fam_acc = {}
    for fam, methods in FAMILIES.items():
        present = [m for m in methods if m in rows]
        if not present:
            lines.append(f"| {fam} | — (no rows yet) | — | — |")
            continue
        a = sum(acc(m) for m in present) / len(present)
        fs = [forg(m) for m in present if forg(m) is not None]
        f_ = sum(fs) / len(fs) if fs else None
        fam_acc[fam] = a
        lines.append(
            f"| {fam} | {', '.join(present)} | {a:.2f} | "
            f"{f_:+.2f} |" if f_ is not None else
            f"| {fam} | {', '.join(present)} | {a:.2f} | n/a |")

    checks = []

    def check(fid, desc, ok):
        checks.append((fid, desc, ok))

    if acc("joint") is not None:
        others = [acc(m) for m in rows if m != "joint"]
        check("F1", "joint is the upper bound (above every CL method)",
              bool(others) and acc("joint") > max(others))
    if forg("finetuning") is not None:
        worst = max((forg(m) for m in rows
                     if forg(m) is not None), default=None)
        check("F2", "finetuning shows the worst forgetting",
              worst is not None and forg("finetuning") >= worst)
    replay = [acc(m) for m in
              FAMILIES["replay (method)"] + FAMILIES["replay (baseline)"]
              if m in rows]
    cl_methods = [m for m in rows if m not in ("joint", "finetuning")]
    if replay and cl_methods:
        best_cl = max(acc(m) for m in cl_methods)
        check("F3", "a replay method is at/near the top of the CL field "
              "(within 1 pt of best)", max(replay) >= best_cl - 1.0)
    imp = [m for m in FAMILIES["importance"] if m in rows]
    if imp:
        check("F4", "importance methods keep abs(forgetting) small "
              "(<= 2 pts each, vs finetuning's "
              f"{forg('finetuning'):+.2f})",
              all(abs(forg(m)) <= 2.0 for m in imp))
    dist = [m for m in FAMILIES["distillation"] if m in rows]
    if dist and imp:
        check("F5", "distillation is accuracy-competitive here (the "
              "in-distribution teacher regime): best distillation >= "
              "best importance",
              max(acc(m) for m in dist) >= max(acc(m) for m in imp))
    mask_zero = [m for m in ("packnet", "HAT") if m in rows]
    if mask_zero:
        check("F6", "mask methods hold (near-)zero forgetting "
              "(abs <= 0.5)",
              all(abs(forg(m) or 0.0) <= 0.5 for m in mask_zero))
    imm = [m for m in FAMILIES["model-merge (IMM)"] if m in rows]
    if imm:
        check("F7", "IMM shows the strongest backward transfer (most "
              "negative forgetting) while paying accuracy for it",
              min(forg(m) for m in imm) <= min(
                  (forg(m) for m in rows
                   if forg(m) is not None and m not in imm),
                  default=0.0))

    lines += ["", "## Survey findings — ordinal checks", "",
              "| finding | holds in our table? |", "|---|---|"]
    for fid, desc, ok in checks:
        lines.append(f"| {fid}: {desc} | {'**yes**' if ok else '**NO**'} |")
    missing = [m for fam in FAMILIES.values() for m in fam
               if m not in rows]
    if missing:
        lines += ["", f"Rows still missing: {', '.join(missing)} — "
                  "checks above use only landed rows and are re-run "
                  "as the queue completes."]

    return lines, checks


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rows", help="a row store, e.g. <out>_rows.json of "
                                 "run_survey_demo")
    ap.add_argument("out", help="the report's markdown (not under docs/)")
    a = ap.parse_args(argv)
    docs = os.path.join(os.path.realpath(REPO), "docs") + os.sep
    if os.path.realpath(a.out).startswith(docs):
        ap.error(f"{a.out} is under docs/, which holds the JAX package's "
                 f"reports")
    with open(a.rows) as f:
        rows = json.load(f)
    lines, _ = build_report(rows)
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    with open(a.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines))


if __name__ == "__main__":
    main()
