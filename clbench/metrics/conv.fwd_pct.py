"""conv.fwd_pct: the card's time in cuDNN's conv forwards of the train
steps (``clsurvey_torch/ops/conv.py``: ``Conv2dExactWeightGrad``'s
``F.conv2d``) over its time in the train steps, in percent: the summed
``device_ms`` of the program's ``conv.fwd`` spans inside its ``train.step``
spans in the window, over that of the ``train.step`` spans
(``step_share.py``). The evals' forwards are left out. A program without
the span reads nothing."""

from clbench import step_share


def read(rec):
    return step_share.share(rec, "conv.fwd")
