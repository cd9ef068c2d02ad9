"""``clsurvey_torch/utils/devtime.py``'s reading of a profile of
``iters`` calls, on made-up kernel records (no card needed): each kernel's
mean record times its launches per call, so lost records do not lower the
reading; a profile with no device time is refused (None: taken again)."""

from types import SimpleNamespace

import pytest

from clsurvey_torch.utils.devtime import _per_call_us


def _rec(count, total_us):
    return SimpleNamespace(count=count, self_device_time_total=total_us)


@pytest.mark.parametrize("records, iters, want", [
    # whole: 2 launches of one kernel and 1 of another a call
    ([_rec(20, 200.0), _rec(10, 50.0)], 10, 25.0),
    # cuDNN's helper kernels: the first record of a profile lost (39 of 40)
    ([_rec(39, 390.0), _rec(10, 10.0)], 10, 41.0),
    # a large share lost (20 of 50 launches of kernel A): its mean counts
    ([_rec(20, 20.0)], 50, 1.0),
    # two of three lost, beside a kernel seen whole
    ([_rec(1, 5.0), _rec(6, 12.0)], 3, 9.0),
    # no device time
    ([], 10, None),
], ids=["whole", "first_record_lost", "share_lost", "most_lost", "empty"])
def test_per_call_us(records, iters, want):
    got = _per_call_us(records, iters)
    assert got == (None if want is None else pytest.approx(want))
