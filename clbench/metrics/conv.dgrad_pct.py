"""conv.dgrad_pct: the card's time in cuDNN's conv input gradients
(``clsurvey_torch/ops/conv.py``: ``Conv2dBackward``'s ``conv2d_input``)
over its time in the train steps, in percent: the summed ``device_ms`` of
the program's ``conv.dgrad`` spans inside its ``train.step`` spans in the
window, over that of the ``train.step`` spans (``step_share.py``). A
program without the span reads nothing."""

from clbench import step_share


def read(rec):
    return step_share.share(rec, "conv.dgrad")
