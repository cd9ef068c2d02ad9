"""eval_img_per_s: the val images of the window over the seconds of its
eval spans on the host's clock, each opened after the epoch's boundary has
synchronised and closed by the eval's own read-back of its counters."""


def read(rec):
    if rec.device.type != "cuda" or rec.eval_s <= 0:
        return None
    return rec.val_images / rec.eval_s
