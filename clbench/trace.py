"""The device trace of a ``--trace 1`` run, and the harness's spans in it.

``torch.profiler`` (CUPTI) records the window: every kernel, copy and
memset the card ran, and the harness's own spans (``record_function``
ranges named ``clbench.<what>``: the window, each train epoch, each
epoch's boundary, each eval). CPU and device events share one clock, so an
idle gap of the card can be named by the span the host was in. The profiler
is imported when a traced run starts it, never at import."""

from __future__ import annotations

import contextlib
from collections import defaultdict
from dataclasses import dataclass, field

SPAN_PREFIX = "clbench."
WINDOW = SPAN_PREFIX + "window"
TOP = 10  # entries of each breakdown list


def span(name: str, traced: bool):
    """A named harness span when the run is traced; nothing otherwise."""
    if not traced:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(SPAN_PREFIX + name)


def start():
    """A started profiler over the CPU and the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    return prof


def _kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


@dataclass
class Trace:
    """Device operations ``(name, kind, start_ns, end_ns)`` inside the
    window, the harness's spans ``(name, start_ns, end_ns)`` and the
    window's bounds."""

    ops: list = field(default_factory=list)
    spans: list = field(default_factory=list)
    window: tuple = (0, 0)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_intervals(self) -> list[tuple[int, int]]:
        """The union of the device operations' intervals, clipped to the
        window, as disjoint sorted intervals."""
        lo, hi = self.window
        merged: list[list[int]] = []
        for _, _, s, e in sorted(self.ops, key=lambda o: o[2]):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def gaps(self) -> list[tuple[int, int]]:
        """The window's intervals in which no device operation ran."""
        out, at = [], self.window[0]
        for s, e in self.busy_intervals():
            if s > at:
                out.append((at, s))
            at = max(at, e)
        if self.window[1] > at:
            out.append((at, self.window[1]))
        return out

    def label(self, t: int) -> str:
        """The innermost harness span (other than the window) open at
        ``t``, or ``window``."""
        best, width = "window", None
        for name, s, e in self.spans:
            if name != "window" and s <= t < e and (
                    width is None or e - s < width):
                best, width = name, e - s
        return best

    def kernels(self, match) -> list[tuple[str, int, int]]:
        """(name, start, end) of the kernels whose name ``match``
        accepts."""
        return [(n, s, e) for n, k, s, e in self.ops
                if k == "kernel" and match(n)]

    def kernel_seconds(self, match, launches: int) -> float | None:
        """Device seconds of ``launches`` calls of the kernels ``match``
        accepts: the mean of the records kept times the launches. CUPTI
        drops a few records of a long trace, and the mean of those kept is
        not biased by that (``clsurvey_torch/utils/devtime.py``)."""
        found = self.kernels(match)
        if not found or not launches:
            return None
        return sum(e - s for _, s, e in found) / len(found) * launches / 1e9

    def breakdown(self) -> dict:
        """The device operations that took the most time, and the longest
        idle gaps named by the span the host was in, in seconds."""
        by_name: dict = defaultdict(int)
        for name, _, s, e in self.ops:
            by_name[name] += e - s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:TOP]
        return {"device_ops": [[n[:120], ns / 1e9] for n, ns in ops],
                "idle_gaps": [[self.label((s + e) // 2), (e - s) / 1e9]
                              for s, e in gaps]}


def read(prof) -> Trace:
    """Stop ``prof`` and read its events into a :class:`Trace` over its
    ``clbench.window`` span."""
    prof.__exit__(None, None, None)
    trace = Trace()
    window = None
    raw = []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if "CUDA" in str(ev.device_type()):
            user = getattr(ev, "is_user_annotation", None)
            if name.startswith(SPAN_PREFIX) or (user and user()) \
                    or "Sync" in name:
                continue  # a span's device copy, or a wait, not work
            raw.append((name, _kind(name), start, end))
        elif name.startswith(SPAN_PREFIX):
            short = name[len(SPAN_PREFIX):]
            trace.spans.append((short, start, end))
            if name == WINDOW:
                window = (start, end)
    if window is None:
        raise RuntimeError("the trace holds no clbench.window span")
    trace.window = window
    trace.ops = [o for o in raw if o[3] > window[0] and o[2] < window[1]]
    return trace
