"""roofline.pool: kernels B1 and B2 (``clsurvey_torch/ops/pool.py``,
``csrc/pool.cu``) against their byte bound: the bytes of the calls of the
train steps that hold ``pool`` spans (``pool_bytes.py``, from the
configuration's 2x2 pools: forward and backward at the train batch), at
3.35 TB/s, over the summed ``device_ms`` of those spans, one a call of
either (``clsurvey_torch/utils/spans.py``: they are recorded in one train
step in ``SAMPLE``, and not in an eval).
Where the spans' own bytes do not sum to those, the window held calls the
count does not know, and it reads nothing; so does a cell whose model has
no 2x2 pool, or a program without the span."""

from clbench import flops, pool_bytes


def read(rec):
    t = rec.trace
    if t is None or rec.device.type != "cuda":
        return None
    try:
        from clsurvey_torch.utils import spans
    except ImportError:
        return None
    calls = [r for r in spans.records("pool", t.window) if r.device_ms]
    if not calls:
        return None
    dtype = rec.workload["dtype"]
    steps = {r.step for r in calls}
    total = len(steps) * pool_bytes.train_bytes(rec.cfg, rec.batch, dtype)
    if sum(r.n for r in calls) != total:
        return None
    seconds = sum(r.device_ms for r in calls) / 1e3
    return 100.0 * total / flops.HBM_BYTES_PER_S / seconds
