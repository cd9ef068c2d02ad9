"""The share of the card's time in the train steps that one of the
program's spans takes (``clsurvey_torch/utils/spans.py``): the summed
``device_ms`` of its records that lie inside a ``train.step`` span of the
window, over the summed ``device_ms`` of the steps that hold one, in
percent. The program records such spans in one step in ``SAMPLE``, so the
other steps are left out of both sums; a record outside every step (an
eval's forward) is left out."""

from __future__ import annotations

import bisect


def share(rec, name: str) -> float | None:
    """The share of span ``name``, or None where the run holds no traced
    train step on the card or no such span inside one (a program without
    the span)."""
    t = rec.trace
    if t is None or rec.device.type != "cuda":
        return None
    try:
        from clsurvey_torch.utils import spans
    except ImportError:
        return None
    steps = sorted((r.start_ns, r.end_ns, r.device_ms)
                   for r in spans.records(spans.STEP, t.window)
                   if r.device_ms)
    if not steps:
        return None
    starts = [s for s, _, _ in steps]
    inside, holding = 0.0, set()
    for r in spans.records(name, t.window):
        i = bisect.bisect_right(starts, r.start_ns) - 1
        if i >= 0 and r.end_ns <= steps[i][1] and r.device_ms:
            inside += r.device_ms
            holding.add(i)
    if not inside:
        return None
    return 100.0 * inside / sum(steps[i][2] for i in holding)
