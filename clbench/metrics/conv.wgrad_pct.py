"""conv.wgrad_pct: the card's time in the exact float32 conv weight
gradient (``clsurvey_torch/ops/conv.py:weight_grad``: the patches written
out, then a GEMM) over its time in the train steps, in percent: the summed
``device_ms`` of the program's ``conv.wgrad`` spans over that of its
``train.step`` spans in the window (``clsurvey_torch/utils/spans.py``). A
program without spans reads nothing."""


def read(rec):
    t = rec.trace
    if t is None or rec.device.type != "cuda":
        return None
    try:
        from clsurvey_torch.utils import spans
    except ImportError:
        return None
    wgrad = sum(r.device_ms for r in spans.records("conv.wgrad", t.window)
                if r.device_ms)
    steps = sum(r.device_ms for r in spans.records("train.step", t.window)
                if r.device_ms)
    if not wgrad or not steps:
        return None
    return 100.0 * wgrad / steps
