"""Device time of a function's kernels on the card, as CUPTI sees it
(through ``torch.profiler``), warm and on a cold L2.

Used by ``chip_smoke.py`` and the kernel timing scripts
(``ops/tune_pool.py``, ``ops/tune_preprocess.py``), so that every number
they print is taken the same way. Needs a CUDA card; the profiler is
imported inside each function."""

from __future__ import annotations

import torch


def _per_call_us(events, iters: int) -> float | None:
    """Device us per call from the kernel records of ``iters`` calls: each
    kernel's mean record times its launches per call (its count over
    ``iters``, rounded up). CUPTI loses records, a few of a kernel in most
    profiles of many kernels (43 of a GEM step's 45 convs) and once enough
    of kernel A's that their sum over ``iters`` read 0.0206 ms against a
    0.0449 ms byte bound; the mean of the records kept is not biased by
    that. None if no device time was seen."""
    us = sum(e.self_device_time_total / e.count * -(-e.count // iters)
             for e in events if e.count)
    return us if us > 0 else None


def device_events(prof) -> list:
    """The averaged events of the card's own operations a profiler saw:
    the program's spans (``utils/spans.py``) also show on the card's side
    as annotations whose time is their kernels', which are left out."""
    return [e for e in prof.key_averages()
            if "CUDA" in str(getattr(e, "device_type", ""))
            and not getattr(e, "is_user_annotation", False)]


def kernel_us(prof) -> dict:
    """{kernel name: total device us} of the kernels a profiler saw."""
    return {e.key: e.self_device_time_total for e in device_events(prof)}


def _event_ms(fn, flush=None, iters: int = 20) -> float:
    """CUDA-event ms per call of ``fn``, each call between two events of
    its own (``flush()`` before it, outside them): the reading taken where
    the profiler sees no device time, as CUPTI now and then does not for
    the rest of a process. It counts the gaps between ``fn``'s kernels and
    a launch's latency too, so it is an upper bound of the device time."""
    print(f"devtime: the profiler saw no device time three times; "
          f"{getattr(fn, '__name__', 'fn')} timed with CUDA events",
          flush=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush()
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def time_ms(fn, iters: int = 50, warmup: int = 5) -> tuple[float, float]:
    """(device_ms, event_ms) per call of ``fn``. device_ms is the summed
    device time of the kernels ``fn`` launches; event_ms is CUDA-event time
    over ``iters`` back-to-back calls, which for a short kernel is bounded
    by the host's time per call rather than by the kernel. Back-to-back
    calls on one input keep it in the 50 MB L2 where it fits: warm.
    ``fn`` must launch the same kernels on every call. Where three
    profiles in a row see no device time, device_ms is :func:`_event_ms`'s
    reading."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(end) / iters
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = _per_call_us(device_events(prof), iters)
        if us is not None:
            return us / 1e3, event_ms
    return _event_ms(fn, iters=iters), event_ms


def cold_ms(fn, flush, iters: int = 20) -> float:
    """Device ms per call of ``fn`` on a cold L2: ``flush()``, which
    overwrites a buffer larger than the L2, runs before each call, and its
    kernels, named by a profile of ``flush`` alone, are left out of the
    sum. ``fn`` must launch the same kernels on every call. Where three
    profiles in a row see no device time, :func:`_event_ms`'s reading."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            flush()
            torch.cuda.synchronize()
        skip = set(kernel_us(prof))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush()
                fn()
            torch.cuda.synchronize()
        kept = [e for e in device_events(prof) if e.key not in skip]
        us = _per_call_us(kept, iters)
        if skip and us is not None:
            return us / 1e3
    return _event_ms(fn, flush, iters)
