"""clsurvey_torch's spans (``utils/spans.py``) on the CPU, and the
benchmark's eight readers of them:

- off (no profiler), ``span()`` is the shared no-op and records nothing,
  an epoch included;
- on, under a CPU ``torch.profiler``: name, parent, step, n and thread,
  nesting, and host times on the profiler's clock: its own event of the
  same ``clsurvey.*`` range within the record's interval, the starts
  within 1 ms in the median;
- ``reset()`` and the cap; ``carry`` into a thread of the program's own;
- a streamed epoch: one ``stream.gather`` and one ``stream.wait`` a chunk
  with the chunk's bytes, one ``train.step`` a step with consecutive step
  ids; ``Engine.evaluate``: one ``eval`` with the val rows;
  ``ops/conv.py:weight_grad``: one ``conv.wgrad`` with its rows; the
  port's conv and pool under a step: ``conv.fwd``, ``conv.dgrad``,
  ``conv.wgrad`` with their rows and ``pool`` with its bytes, a forward
  and a backward each, with the step and parent, and none unprofiled;
- ``--profile`` writes the spans beside its trace
  (``tests/test_torch_port_figures.py``);
- each reader's arithmetic on a hand-made record and span list, and None
  where its records are missing."""

import contextlib
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from clbench import flops, harness, pool_bytes, trace as trace_lib
from clbench.methods import finetune
from clbench.spec import Spec
from clsurvey_torch.engine import train as ttrain
from clsurvey_torch.methods.base import UpdateRule
from clsurvey_torch.models import registry as treg
from clsurvey_torch.ops import conv, pool
from clsurvey_torch.utils import spans

NAME, PX = "tiny_CNN_cl_32_32", 32
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
COUNTS = [4, 3]


@pytest.fixture(autouse=True)
def clean():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    spans.reset()
    yield
    spans.reset()
    torch.set_num_threads(threads)


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _engine(augment=True):
    spec = treg.parse_model_name("", NAME, (PX, PX))
    ctx = ttrain.make_context(spec, task=0, n_tasks=1, class_counts=COUNTS,
                              mean=MEAN, std=STD, update_rule=UpdateRule(),
                              device="cpu", augment=augment)
    model = treg.init_model_state(spec, 3, max_tasks=2, classes_per_task=4,
                                  class_counts=COUNTS)
    state = ttrain.state_from_model(model, None, "cpu")
    state.mstate = UpdateRule().init_state(None, {}, ctx)
    return ttrain.Engine(ctx), state


def _rows(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, PX, PX, 3), dtype=np.uint8),
            rng.integers(0, 3, (n,)).astype(np.int32))


def test_off_is_the_shared_noop_and_records_nothing():
    assert not spans.enabled()
    assert spans.span("train.step", 4, device=True) is spans.OFF
    with spans.span("eval", 3) as rec:
        assert rec is None
    engine, state = _engine()
    images, labels = _rows(32)
    engine.train_epoch(state, torch.from_numpy(images),
                       torch.from_numpy(labels).long(), torch.arange(32),
                       torch.Generator().manual_seed(0), 1e-2, 16)
    assert spans.records() == [] and spans.dropped() == 0


def test_on_records_name_parent_step_n_and_thread():
    with _profiled():
        assert spans.enabled()
        for i in range(2):
            with spans.span("train.step", 16):
                with spans.span("outer", 5):
                    with spans.span("inner"):
                        pass
        with spans.span("eval", 40):
            pass
    assert not spans.enabled()
    recs = spans.records()
    assert [(r.name, r.parent, r.step, r.n) for r in recs] == [
        ("train.step", None, 1, 16), ("outer", "train.step", 1, 5),
        ("inner", "outer", 1, None), ("train.step", None, 2, 16),
        ("outer", "train.step", 2, 5), ("inner", "outer", 2, None),
        ("eval", None, 2, 40)]
    me = threading.get_native_id()
    for r in recs:
        assert r.thread == me and r.device_ms is None
        assert 0 < r.start_ns <= r.end_ns
    step, outer, inner = recs[:3]
    assert step.start_ns <= outer.start_ns <= inner.start_ns
    assert inner.end_ns <= outer.end_ns <= step.end_ns
    assert spans.records("outer", (outer.start_ns, outer.end_ns)) == [outer]
    assert spans.records("outer", (outer.start_ns + 1, step.end_ns)) == []


def test_host_times_are_on_the_profilers_clock():
    """The profiler's event of each ``clsurvey.*`` range lies within its
    record's interval (stamped before the range opens and after it
    closes), to 0.1 ms; the two starts are within 1 ms of each other in
    the median (a pause of the process between the two stamps, under
    load, only widens the record)."""
    with _profiled() as prof:
        for i in range(20):
            with spans.span(f"s{i}"):
                torch.ones(64).sum()
    events = {ev.name(): ev for ev in prof.profiler.kineto_results.events()
              if ev.name().startswith(spans.PREFIX)}
    recs = spans.records()
    assert len(recs) == 20
    gaps = []
    for r in recs:
        ev = events[spans.PREFIX + r.name]
        start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
        assert r.start_ns - 100_000 <= start <= end <= r.end_ns + 100_000
        gaps.append(abs(start - r.start_ns))
    assert sorted(gaps)[len(gaps) // 2] < 1_000_000


def test_reset_and_the_cap(monkeypatch):
    monkeypatch.setattr(spans, "CAP", 3)
    with _profiled():
        for _ in range(5):
            with spans.span("train.step", 1):
                pass
    assert len(spans.records()) == 3 and spans.dropped() == 2
    spans.reset()
    assert spans.records() == [] and spans.dropped() == 0
    with _profiled():
        with spans.span("train.step"):
            pass
    assert [r.step for r in spans.records()] == [1]


def test_carry_turns_spans_on_in_a_thread_of_the_programs_own():
    def work(tag):
        with spans.span(tag, 7):
            return spans.enabled()

    with _profiled():
        with spans.span("stream.wait"):
            seen = {}
            for tag, fn in (("plain", work), ("carried", spans.carry(work))):
                t = threading.Thread(target=lambda: seen.update(
                    {tag: fn(tag)}))
                t.start()
                t.join(timeout=30)
                assert not t.is_alive()
    assert seen == {"plain": False, "carried": True}
    assert spans.carry(work) is work  # off: the function itself
    recs = {r.name: r for r in spans.records()}
    assert set(recs) == {"stream.wait", "carried"}
    assert recs["carried"].parent is None and recs["carried"].n == 7
    assert recs["carried"].thread != recs["stream.wait"].thread


def test_a_streamed_epoch_records_each_chunk_and_step():
    """100 rows in chunks of 48 (three batches of 16): three chunks, each
    gathered on the feed's thread and waited for on the caller's, and nine
    steps with consecutive step ids."""
    engine, state = _engine()
    images, labels = _rows(100)
    feed = ttrain.ChunkFeed(images.shape[1:], 48, "cpu")
    with _profiled():
        engine.train_epoch_chunked(
            state, images, labels, np.random.default_rng(1).permutation(100),
            torch.Generator().manual_seed(4), 1e-2, 16, 48, feed)
    chunk = 48 * PX * PX * 3
    assert feed.chunk_bytes == chunk
    by = {}
    for r in spans.records():
        by.setdefault(r.name, []).append(r)
    assert set(by) == {"train.step", "stream.gather", "stream.wait", "pool"}
    # tiny_CNN's two pools, forward and backward, in the sampled steps
    assert spans.SAMPLE == 8
    assert [(r.step, r.parent) for r in by["pool"]] == [
        (s, "train.step") for s in (1, 9) for _ in range(4)]
    assert [(r.n, r.parent) for r in by["stream.gather"]] == \
        [(chunk, None)] * 3
    assert [r.n for r in by["stream.wait"]] == [chunk] * 3
    main = threading.get_native_id()
    assert all(r.thread != main for r in by["stream.gather"])
    assert all(r.thread == main for r in by["stream.wait"]
               + by["train.step"])
    assert [r.step for r in by["train.step"]] == list(range(1, 10))
    assert [r.n for r in by["train.step"]] == [16] * 9
    # chunk c's wait ends after its gather
    for g, w in zip(by["stream.gather"], by["stream.wait"]):
        assert g.end_ns <= w.end_ns


def test_evaluate_records_one_eval_with_the_val_rows():
    engine, state = _engine()
    images, labels = _rows(90, seed=5)
    with _profiled():
        engine.evaluate(state.trainable, {}, torch.from_numpy(images),
                        labels, 32)
    recs = spans.records()
    # the pools of its batches open no span: they record inside steps only
    assert [(r.name, r.n, r.parent) for r in recs] == [("eval", 90, None)]


def test_weight_grad_records_one_span_with_its_rows():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(6, 3, 9, 9, generator=gen)
    w_shape = (4, 3, 3, 3)
    dy = torch.randn(6, 4, 9, 9, generator=gen)
    with _profiled():
        with spans.span("train.step", 6):
            got = conv.weight_grad(x, dy, w_shape, 1, 1)
    w = torch.zeros(w_shape, requires_grad=True)
    torch.nn.functional.conv2d(x, w, padding=1).backward(dy)
    torch.testing.assert_close(got, w.grad, rtol=1e-5, atol=1e-5)
    recs = spans.records("conv.wgrad")
    assert [(r.n, r.parent, r.step) for r in recs] == [(6, "train.step", 1)]


@pytest.mark.parametrize("profiled,in_step", [
    (True, True), (False, True), (True, False)],
    ids=["on", "off", "outside-a-step"])
def test_conv_and_pool_spans_under_a_step(profiled, in_step):
    """The port's conv (``Conv2dExactWeightGrad``, the card's route, here
    on CPU tensors) and 2x2 pool, forward and backward inside a
    ``train.step``: one ``conv.fwd``, ``conv.dgrad`` and ``conv.wgrad``
    with the conv's rows, one ``pool`` a B1 and a B2 call with its bytes,
    all of step 1 with the step as parent (on the CPU the backward runs on
    the caller's thread); unprofiled, none; outside a step, only the
    weight gradient's."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(5, 4, 6, 6, generator=gen).requires_grad_()
    w = torch.randn(8, 4, 3, 3, generator=gen).requires_grad_()
    b = torch.zeros(8, requires_grad=True)
    with _profiled() if profiled else contextlib.nullcontext():
        with (spans.span("train.step", 5) if in_step
              else contextlib.nullcontext()):
            y = conv.Conv2dExactWeightGrad.apply(x, w, b, 1, 1)
            out = pool.pool2x2(y.permute(0, 2, 3, 1).contiguous())
            out.square().sum().backward()
    assert x.grad is not None and w.grad is not None
    recs = [(r.name, r.n, r.parent, r.step) for r in spans.records()]
    if not profiled:
        assert recs == []
        return
    if not in_step:
        assert recs == [("conv.wgrad", 5, None, 0)]
        return
    moved = pool.call_bytes((5, 6, 6, 8), 4)
    assert moved == pool_bytes.call_bytes(5, (8, 6, 6), 4) == \
        5 * 8 * (36 * 4 + 9 * 5)
    assert sorted(recs[1:]) == sorted([
        ("conv.fwd", 5, "train.step", 1), ("pool", moved, "train.step", 1),
        ("pool", moved, "train.step", 1),
        ("conv.dgrad", 5, "train.step", 1),
        ("conv.wgrad", 5, "train.step", 1)])
    assert recs[0] == ("train.step", 5, None, 1)
    assert [r[0] for r in recs[1:3]] == ["conv.fwd", "pool"]


# ---------------------------------------------------------------------------
# the benchmark's readers
# ---------------------------------------------------------------------------

MS = 1_000_000  # ns
VGG16 = "vgg16-224-finetune-fp32"
# the bytes of B1 and B2 in a VGG-16 train step of 200 rows
_TRAIN_POOL = pool_bytes.train_bytes(Spec().config("vgg16_224"), 200,
                                     "float32")


def _spans():
    R = spans.Record
    return [
        R("train.step", 10 * MS, 40 * MS, 1, None, 1, 200, 28.0),
        R("conv.wgrad", 12 * MS, 20 * MS, 2, None, 1, 200, 5.0),
        R("train.step", 40 * MS, 70 * MS, 1, None, 2, 200, 28.0),
        R("conv.wgrad", 42 * MS, 50 * MS, 2, None, 2, 200, 3.0),
        R("stream.gather", 80 * MS, 130 * MS, 3, None, 2, 10 ** 9),
        R("stream.wait", 120 * MS, 200 * MS, 1, None, 2, 10 ** 9),
        R("eval", 300 * MS, 400 * MS, 1, None, 2, 3000, 100.0),
        # the convs' forwards and input gradients, inside the steps
        R("conv.fwd", 12 * MS, 14 * MS, 1, "train.step", 1, 200, 4.0),
        R("conv.dgrad", 20 * MS, 25 * MS, 2, None, 1, 200, 6.0),
        R("conv.fwd", 41 * MS, 42 * MS, 1, "train.step", 2, 200, 2.0),
        R("conv.dgrad", 50 * MS, 55 * MS, 2, None, 2, 200, 8.0),
        # B1 and B2 of two train steps
        R("pool", 15 * MS, 16 * MS, 1, "train.step", 1, _TRAIN_POOL, 6.0),
        R("pool", 45 * MS, 46 * MS, 1, "train.step", 2, _TRAIN_POOL, 6.0),
        # left out of the steps' shares: an eval's forward, one between
        # the steps, one that outlasts its step
        R("conv.fwd", 310 * MS, 320 * MS, 1, "eval", 2, 200, 50.0),
        R("conv.fwd", 200 * MS, 210 * MS, 1, None, 2, 200, 5.0),
        R("conv.dgrad", 38 * MS, 42 * MS, 2, None, 1, 200, 7.0),
        # left out: outside the window, or with no device time
        R("train.step", 2000 * MS, 2030 * MS, 1, None, 3, 200, 28.0),
        R("train.step", 500 * MS, 530 * MS, 1, None, 3, 200, None),
        R("stream.gather", 2000 * MS, 2100 * MS, 3, None, 3, 10 ** 9),
        R("pool", 2010 * MS, 2011 * MS, 1, "train.step", 3, 10 ** 9, 1.0),
    ]


def _record(device="cuda", trace=True, cell="alexnet224-stream-fp32"):
    spec = Spec()
    wl = spec.workload(cell)
    rec = harness.Record(spec.config(wl["config"]), wl, finetune,
                         torch.device(device))
    # two train steps of 200 rows and one eval of 300 in the window
    rec.train_steps, rec.batch, rec.epochs = 2, 200, 1
    rec.val_batches = [200, 100]
    if trace:  # the card busy but from 100 to 150 ms of a 1-s window
        rec.trace = trace_lib.Trace(
            ops=[("k", "kernel", 0, 100 * MS),
                 ("k", "kernel", 150 * MS, 1000 * MS)],
            window=(0, 1000 * MS))
    return rec


def _want_mfu_step():
    cfg = Spec().config("alexnet224")
    return 100.0 * 400 * flops.train_flops(cfg) / 0.056 / 67e12


READINGS = {
    "mfu.step": _want_mfu_step,
    "conv.wgrad_pct": lambda: 100.0 * 8.0 / 56.0,
    "conv.fwd_pct": lambda: 100.0 * 6.0 / 56.0,
    "conv.dgrad_pct": lambda: 100.0 * 14.0 / 56.0,
    "roofline.pool": lambda: 100.0 * 2 * _TRAIN_POOL / 3.35e12 / 12e-3,
    "eval.device_img_per_s": lambda: 3000 / 0.1,
    "stream.wait_pct": lambda: 3.0,  # 30 ms of the gap inside the wait
    "stream.gather_GBps": lambda: 20.0,  # 1 GB in 50 ms
}


# the cell a reader's record is of (the others read an AlexNet cell's)
CELL_OF = {"roofline.pool": VGG16}


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_reader_arithmetic(monkeypatch, metric):
    monkeypatch.setattr(spans, "_records", _spans())
    got = Spec().reader(metric).read(_record(
        cell=CELL_OF.get(metric, "alexnet224-stream-fp32")))
    assert got == pytest.approx(READINGS[metric](), rel=1e-12)


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_reader_reads_nothing_without_its_records(monkeypatch, metric):
    reader = Spec().reader(metric).read
    cell = CELL_OF.get(metric, "alexnet224-stream-fp32")
    monkeypatch.setattr(spans, "_records", _spans())
    assert reader(_record(trace=False, cell=cell)) is None
    assert reader(_record(device="cpu", cell=cell)) is None
    need = {"mfu.step": {"train.step"},
            "conv.wgrad_pct": {"conv.wgrad", "train.step"},
            "conv.fwd_pct": {"conv.fwd", "train.step"},
            "conv.dgrad_pct": {"conv.dgrad", "train.step"},
            "roofline.pool": {"pool"},
            "eval.device_img_per_s": {"eval"},
            "stream.wait_pct": {"stream.wait"},
            "stream.gather_GBps": {"stream.gather"}}[metric]
    for name in need:
        monkeypatch.setattr(spans, "_records",
                            [r for r in _spans() if r.name != name])
        assert reader(_record(cell=cell)) is None, name


def test_roofline_pool_reads_nothing_for_calls_it_does_not_know(
        monkeypatch):
    """Where the ``pool`` spans' bytes are not their steps' count (a call
    more, or one left out) or the cell's model has no 2x2 pool (AlexNet's
    pools are 3x3), ``roofline.pool`` reads nothing."""
    reader = Spec().reader("roofline.pool").read
    R = spans.Record
    more = R("pool", 46 * MS, 47 * MS, 1, "train.step", 2, 10 ** 6, 1.0)
    monkeypatch.setattr(spans, "_records", _spans() + [more])
    assert reader(_record(cell=VGG16)) is None
    monkeypatch.setattr(spans, "_records", _spans())
    assert reader(_record()) is None
    short = [r for r in _spans() if (r.name, r.step) != ("pool", 2)]
    short.append(R("pool", 45 * MS, 46 * MS, 1, "train.step", 2,
                   _TRAIN_POOL // 2, 3.0))
    monkeypatch.setattr(spans, "_records", short)
    assert reader(_record(cell=VGG16)) is None


def test_step_shares_read_only_the_sampled_steps(monkeypatch):
    """The program records its conv and pool spans in one step in
    ``SAMPLE``: ``conv.fwd_pct`` divides by the steps that hold one, and
    ``roofline.pool`` counts those steps' bytes."""
    R = spans.Record
    monkeypatch.setattr(spans, "_records", [
        R("train.step", 0, 30 * MS, 1, None, 1, 200, 20.0),
        R("train.step", 30 * MS, 60 * MS, 1, None, 2, 200, 40.0),
        R("train.step", 60 * MS, 90 * MS, 1, None, 3, 200, 60.0),
        R("conv.fwd", 35 * MS, 40 * MS, 1, "train.step", 2, 200, 10.0),
        R("pool", 40 * MS, 41 * MS, 1, "train.step", 2, _TRAIN_POOL, 8.0),
    ])
    rec = _record(cell=VGG16)
    assert Spec().reader("conv.fwd_pct").read(rec) == pytest.approx(25.0)
    assert Spec().reader("roofline.pool").read(rec) == pytest.approx(
        100.0 * _TRAIN_POOL / 3.35e12 / 8e-3)
