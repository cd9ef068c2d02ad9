"""mfu.step: the operations of the window's train steps (``flops.py``:
three forward passes a train image, one more for each teacher forward) over
the card's time in them, as a share of the card's dense peak in the cell's
precision. The time is the summed ``device_ms`` of the program's
``train.step`` spans (``clsurvey_torch/utils/spans.py``: a CUDA event pair
around each step), so eval, the epoch boundaries and the card's idle time
between steps are left out, as ``mfu`` does not. A program without spans
reads nothing."""

from clbench import flops


def read(rec):
    t = rec.trace
    if t is None or rec.device.type != "cuda":
        return None
    try:
        from clsurvey_torch.utils import spans
    except ImportError:
        return None
    steps = [r for r in spans.records("train.step", t.window)
             if r.device_ms]
    if not steps:
        return None
    work = sum(r.n for r in steps) * flops.train_flops(
        rec.cfg, rec.method.EXTRA_FORWARDS)
    seconds = sum(r.device_ms for r in steps) / 1e3
    return 100.0 * work / seconds / flops.PEAK_FLOPS[rec.workload["dtype"]]
