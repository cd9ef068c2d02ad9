"""The program's spans: named intervals of its own work, on the profiler's
clock, recorded only while a ``torch.profiler`` records.

    with spans.span("train.step", n=rows, device=True):
        ...

Off (no profiler recording on this thread, the default), :func:`span`
returns one shared object that does nothing: the cost is one flag check.
On, it opens ``torch.profiler.record_function("clsurvey.<name>")``, so the
span shows in the profiler's trace (the benchmark's ``--trace 1`` window,
the CLI's ``--profile`` Chrome trace), and appends a :class:`Record`:
its name, host start and end, thread, the innermost span open on the same
thread (``parent``), the train step it belongs to (``step``: one counter
that each ``train.step`` span advances, so that the spans of one step share
it, whatever thread runs them), and ``n``, the work done (rows or bytes).

Host times are ``time.time_ns()``: Unix epoch nanoseconds, the clock the
profiler stamps its events with, so that a device trace's idle gap can be
put down to the span the host was in. With ``device=True`` (the span's work
runs on the card) a CUDA event pair is recorded on the current stream as
well, and resolved to ``device_ms`` when :func:`records` reads it; none is
recorded while the stream captures a CUDA graph.

The profiler follows its own thread and autograd's device threads, not a
thread of the program's own: :func:`carry` wraps a function handed to such
a thread so that its spans are on where the submitting thread's were. They
are recorded, but not in the profiler's trace.

At most ``CAP`` records are kept until :func:`reset`; spans past it are
counted by :func:`dropped`, not recorded."""

from __future__ import annotations

import threading
import time

import torch
from torch.autograd.profiler import record_function

PREFIX = "clsurvey."
STEP = "train.step"  # the span that advances the step counter
CAP = 1 << 16

_profiler_enabled = torch.autograd._profiler_enabled
_records: list = []
_dropped = 0
_step = 0
_local = threading.local()
_lock = threading.Lock()


class Record:
    """One span: host times in Unix epoch ns, ``device_ms`` the card's time
    between its events (None without them, or until :func:`records`)."""

    FIELDS = ("name", "start_ns", "end_ns", "thread", "parent", "step", "n",
              "device_ms")
    __slots__ = FIELDS + ("_events",)

    def __init__(self, name: str, start_ns: int, end_ns: int | None,
                 thread: int, parent: str | None, step: int, n=None,
                 device_ms: float | None = None):
        self.name, self.start_ns, self.end_ns = name, start_ns, end_ns
        self.thread, self.parent, self.step = thread, parent, step
        self.n, self.device_ms = n, device_ms
        self._events = None

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.FIELDS}


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("_name", "_n", "_device", "_rec", "_rf")

    def __init__(self, name: str, n, device: bool):
        self._name, self._n, self._device = name, n, device

    def __enter__(self) -> Record | None:
        global _dropped, _step
        stack = _stack()
        with _lock:  # spans open on several threads at once
            if len(_records) >= CAP:
                _dropped += 1
                self._rec = None
                return None
            if self._name == STEP:
                _step += 1
            rec = self._rec = Record(
                self._name, 0, None, threading.get_native_id(),
                stack[-1] if stack else None, _step, self._n)
            _records.append(rec)
        self._rf = record_function(PREFIX + rec.name)
        rec.start_ns = time.time_ns()  # next to the profiler's own stamp
        self._rf.__enter__()
        if self._device and not torch.cuda.is_current_stream_capturing():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            rec._events = [start, None]
        stack.append(rec.name)
        return rec

    def __exit__(self, *exc):
        rec = self._rec
        if rec is None:
            return False
        if rec._events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            rec._events[1] = end
        self._rf.__exit__(*exc)
        rec.end_ns = time.time_ns()
        _stack().pop()
        return False


def enabled() -> bool:
    """Whether a span opened on this thread now is recorded."""
    return _profiler_enabled() or getattr(_local, "carried", False)


def span(name: str, n=None, device: bool = False):
    """A context manager: the span ``name`` over its block where spans are
    on, the shared no-op :data:`OFF` otherwise. ``n``: the work done (rows
    or bytes); ``device``: the block's work runs on the card, so its time
    there is taken too."""
    return _Span(name, n, device) if enabled() else OFF


def carry(fn):
    """``fn``, or where spans are on in this thread, ``fn`` wrapped so that
    its spans are on in whatever thread runs it."""
    if not enabled():
        return fn

    def carried(*args, **kwargs):
        before = getattr(_local, "carried", False)
        _local.carried = True
        try:
            return fn(*args, **kwargs)
        finally:
            _local.carried = before

    return carried


def records(name: str | None = None, window=None) -> list[Record]:
    """The records, in the order their spans opened, each closed span's
    ``device_ms`` resolved (which waits for the card to reach its end);
    only those named ``name``, and only those lying within ``window``
    (start and end ns), where given."""
    out = []
    for r in list(_records):
        if r._events is not None and r._events[1] is not None:
            start, end = r._events
            end.synchronize()
            r.device_ms = start.elapsed_time(end)
            r._events = None
        if name is not None and r.name != name:
            continue
        if window is not None and (r.end_ns is None or r.start_ns < window[0]
                                   or r.end_ns > window[1]):
            continue
        out.append(r)
    return out


def dropped() -> int:
    """Spans not recorded since the last :func:`reset`: the cap was full."""
    return _dropped


def reset() -> None:
    """Forget every record and the dropped count; the step counter starts
    again."""
    global _dropped, _step
    with _lock:
        _records.clear()
        _dropped = _step = 0


def dump() -> dict:
    """The records and the dropped count, as JSON-ready values."""
    return {"records": [r.as_dict() for r in records()],
            "dropped": _dropped}
