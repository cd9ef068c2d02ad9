"""roofline.preprocess: kernel A (``ops/preprocess.py``,
``csrc/preprocess.cu``) against its byte bound. Its calls in the window are
one a train step, at the train batch with the flip mask, and one a val
batch without it; the bound reads each call's uint8 pixels (and mask)
once and writes its float32 pixels once, at 3.35 TB/s. Its device time is
the mean of its trace records times the launches the program counted."""

import re

from clbench import flops

KERNEL = re.compile(r"\bnormalize_flip(_vec)?_kernel\b")


def read(rec):
    launches = rec.launches.get("normalize_flip", 0)
    t = rec.trace
    if t is None or not launches:
        return None
    val_calls = len(rec.val_batches) * rec.epochs
    if launches != rec.train_steps + val_calls:
        return None  # calls the count below does not know
    px = rec.cfg["input_px"]
    flip = bool(rec.workload.get("augment", True))
    total = (rec.train_steps * flops.preprocess_bytes(rec.batch, px, flip)
             + rec.epochs * sum(flops.preprocess_bytes(b, px, False)
                                for b in rec.val_batches))
    seconds = t.kernel_seconds(KERNEL.search, launches)
    if not seconds:
        return None
    return 100.0 * total / flops.HBM_BYTES_PER_S / seconds
