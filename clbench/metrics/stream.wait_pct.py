"""stream.wait_pct: the card's idle time that falls inside the program's
``stream.wait`` spans (``_streamed_batches`` waiting for a chunk's gather
and the start of its copy, ``clsurvey_torch/utils/spans.py``), over the
traced window, in percent: how much of the card's idleness the streamed
epochs' chunk waits explain. A cell that streams nothing, or a program
without spans, reads nothing."""


def read(rec):
    t = rec.trace
    if t is None or rec.device.type != "cuda" or t.window_s <= 0:
        return None
    try:
        from clsurvey_torch.utils import spans
    except ImportError:
        return None
    waits = [(r.start_ns, r.end_ns)
             for r in spans.records("stream.wait", t.window)]
    if not waits:
        return None
    idle = sum(max(0, min(e, we) - max(s, ws))
               for s, e in t.gaps() for ws, we in waits)
    return 100.0 * idle / (t.window[1] - t.window[0])
