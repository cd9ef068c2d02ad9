"""stream.gather_GBps: the host's chunk gather (``ChunkFeed.load`` on the
feed's thread, ``clsurvey_torch/utils/rowgather.py`` into a pinned
buffer): the bytes of the window's ``stream.gather`` spans over their
seconds on the host's clock (``clsurvey_torch/utils/spans.py``). A cell
that streams nothing, or a program without spans, reads nothing."""


def read(rec):
    t = rec.trace
    if t is None or rec.device.type != "cuda":
        return None
    try:
        from clsurvey_torch.utils import spans
    except ImportError:
        return None
    gathers = spans.records("stream.gather", t.window)
    ns = sum(r.end_ns - r.start_ns for r in gathers)
    if not gathers or ns <= 0:
        return None
    return sum(r.n for r in gathers) / ns
