"""eval.device_img_per_s: the val rows of the window's evals over the card's
time in them: the summed ``device_ms`` of the program's ``eval`` spans
(``Engine.evaluate``, from its first launch to the counters' read-back;
``clsurvey_torch/utils/spans.py``). ``eval_img_per_s`` times the same evals
on the host's clock. A program without spans reads nothing."""


def read(rec):
    t = rec.trace
    if t is None or rec.device.type != "cuda":
        return None
    try:
        from clsurvey_torch.utils import spans
    except ImportError:
        return None
    evals = [r for r in spans.records("eval", t.window) if r.device_ms]
    if not evals:
        return None
    return sum(r.n for r in evals) / (sum(r.device_ms for r in evals) / 1e3)
