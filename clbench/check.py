"""The numbers that decide ``correct``, each against its limit.

A training cell's program is held against the plain reference (float64)
on its first three steps, from the same weights and rows and draws, and
on its eval after the first epoch. Each leaf's measure is over the larger
of the reference's norm of that leaf and of the median leaf (some
gradients are all but zero):

- ``loss_gap``: the largest gap of a step's loss, over the reference's;
- ``head_grad_diff``: the head bank's first gradient, as the optimizer got
  it: the norm of the difference from the reference's, over its norm;
- ``grad_diff`` and ``grad_diff_worst``: the first gradient, each leaf's
  norm of the difference from the reference's: the median leaf and the
  worst;
- ``change_gap_worst``: the parameters' change after three steps: the
  worst leaf's gap between the program's norm and the reference's, over
  the leaves whose reference gradient is at least ``MOVED`` of the median
  leaf's (a leaf below that moves by round-off alone);
- ``eval_logit_gap``: the val split's task logits of the program's eval
  after the first epoch against the reference's, which computes them from
  the weights that eval ran on (the program's state: the reference does
  not train a whole epoch): the largest gap over the reference's largest
  |logit|;
- ``eval_hits_off``: that eval's hits, as the program counted them by
  class, against the reference's: the hits that lie outside what the
  reference allows, a row without a decided answer in float32
  (``reference/train.py:AMBIGUOUS``) counting either way, plus any gap in
  the rows counted. Exact: its limit is 0.

Float32 flips a few max-pool and ReLU decisions that lie within its
rounding of a tie, and each flip sends a gradient entry elsewhere, so the
leaves upstream of the pools move by a few thousandths from seed to seed:
the limits sit above that. The first gradient's gap of norms is blind to
the control's error (TF32 turns each leaf's gradient by a few percent and
keeps its norm), so its difference is compared. ``grad_gap`` and
``grad_gap_worst`` (the first gradient's gaps of norms) and ``change_gap``
(the change's median leaf) are reported beside them, not compared.
``PERF.md`` gives the readings each limit was set from. The limits sit in
the cell's traffic file; a number whose limit is null there is reported
and not compared."""

from __future__ import annotations

import statistics

import torch

MOVED = 1e-3
HEAD = "heads.kernel"  # the task head bank, downstream of every decision


def _f64(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", torch.float64)


def _norms(tree: dict, names) -> dict:
    return {k: float(_f64(tree[k]).norm()) for k in names}


def leaf_gaps(prog: dict, ref: dict, names) -> list[float]:
    """Each leaf's gap between the program's norm and the reference's,
    over the larger of the reference's norm of the leaf and of the median
    leaf."""
    names = list(names)
    pn, rn = _norms(prog, names), _norms(ref, names)
    floor = statistics.median(rn.values())
    return [abs(pn[k] - rn[k]) / max(rn[k], floor, 1e-300) for k in names]


def leaf_diffs(prog: dict, ref: dict) -> list[float]:
    """Each leaf's norm of the difference between the program's and the
    reference's, over the same floor as :func:`leaf_gaps`."""
    rn = _norms(ref, ref)
    floor = statistics.median(rn.values())
    return [float((_f64(prog[k]) - _f64(ref[k])).norm())
            / max(rn[k], floor, 1e-300) for k in rn]


def moved(ref_grad: dict) -> list[str]:
    norms = _norms(ref_grad, ref_grad)
    floor = MOVED * statistics.median(norms.values())
    return [k for k, v in norms.items() if v >= floor]


def delta(after: dict, before: dict) -> dict:
    return {k: _f64(after[k]) - _f64(before[k]) for k in after}


def eval_off(prog_hits, prog_rows, ref: dict) -> int:
    hits = torch.as_tensor(prog_hits).round().long().numpy()
    rows = torch.as_tensor(prog_rows).round().long().numpy()
    low = ref["hits"] - ref["open_hit"]
    high = ref["hits"] + ref["open_miss"]
    over = (low - hits).clip(min=0) + (hits - high).clip(min=0)
    return int(over.sum() + abs(rows - ref["rows"]).sum())


def logit_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    if prog.shape != ref.shape:
        return float("inf")
    ref = _f64(ref)
    return float((_f64(prog) - ref).abs().max() / ref.abs().max())


def numbers(prog: dict, ref: dict, p0: dict) -> dict:
    """``prog`` and ``ref`` each hold ``losses`` (one a step),
    ``first_grad`` and ``params`` (after the last step) as {name: tensor},
    and ``eval``: the program's ``hits`` and ``rows`` by class and
    ``logits``; the reference's :func:`reference.train.eval_counts`."""
    grad = leaf_gaps(prog["first_grad"], ref["first_grad"],
                     ref["first_grad"])
    diff = leaf_diffs(prog["first_grad"], ref["first_grad"])
    head = float((_f64(prog["first_grad"][HEAD])
                  - _f64(ref["first_grad"][HEAD])).norm()
                 / _f64(ref["first_grad"][HEAD]).norm())
    change = leaf_gaps(delta(prog["params"], p0), delta(ref["params"], p0),
                       moved(ref["first_grad"]))
    return {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(prog["losses"], ref["losses"])),
        "head_grad_diff": head,
        "grad_diff": statistics.median(diff),
        "grad_diff_worst": max(diff),
        "change_gap_worst": max(change),
        "eval_logit_gap": logit_gap(prog["eval"]["logits"],
                                    ref["eval"]["logits"]),
        "eval_hits_off": eval_off(prog["eval"]["hits"],
                                  prog["eval"]["rows"], ref["eval"]),
        "grad_gap": statistics.median(grad),
        "grad_gap_worst": max(grad),
        "change_gap": statistics.median(change),
    }


def verdict(values: dict, limits: dict) -> tuple[bool, dict, dict]:
    """(every compared number within its limit, {compared name: {value,
    limit}}, {reported name: value})."""
    table = {k: {"value": values[k], "limit": v} for k, v in limits.items()
             if v is not None}
    ok = all(t["value"] <= t["limit"] for t in table.values())
    return ok, table, {k: v for k, v in values.items() if k not in table}
