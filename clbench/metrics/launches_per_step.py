"""launches_per_step: the kernels the card ran in the traced window (the
train epochs, their boundaries and the evals) over the window's train
steps. CUPTI may drop a few records of a long trace, so the count can read
a little low."""


def read(rec):
    t = rec.trace
    if t is None or not rec.train_steps:
        return None
    kernels = sum(1 for _, kind, _, _ in t.ops if kind == "kernel")
    return kernels / rec.train_steps if kernels else None
