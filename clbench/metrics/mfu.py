"""mfu: the operations the window's work needs (``flops.py``: three forward
passes a train image, one more for each teacher forward, one a val image)
over the window's seconds, as a share of the card's dense peak in the
cell's precision. The window's time includes everything the card waited
for; in a traced run the profiler's cost too."""

from clbench import flops


def read(rec):
    if rec.device.type != "cuda" or rec.window_s <= 0:
        return None
    work = (rec.train_images * flops.train_flops(
        rec.cfg, rec.method.EXTRA_FORWARDS)
        + rec.val_images * flops.forward_flops(rec.cfg))
    peak = flops.PEAK_FLOPS[rec.workload["dtype"]]
    return 100.0 * work / rec.window_s / peak
