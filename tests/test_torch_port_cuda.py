"""clsurvey_torch's CUDA kernels against their plain PyTorch versions, on
the card. Every test here is marked ``cuda`` and skips without a card; on a
machine with one, run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_cuda.py -q

(``--noconftest``: the repo's conftest imports JAX, which a GPU machine
need not have; nothing here uses it.)

- kernel A (normalize + flip): bfloat16 bit-equal; float32 within 1 ulp
  (both sides round the product, then the difference; no FMA), through its
  vector kernel (width a multiple of 8), its scalar kernel (any width, a
  pointer that is not 16-byte aligned) and the two against each other;
- kernels B1/B2 (pool forward / backward): bit-equal values, codes and dx,
  float32 and bfloat16, tie-heavy inputs, even and odd sizes, on the vec
  route (C a multiple of 16 bytes, aligned) and the scalar route (other C,
  an input one element off), each launch counted on its route;
- the pool pair under ``torch.func.vmap(grad)``: one launch each, equal to
  a per-sample loop;
- the backbone on the card against the same backbone on the CPU;
- the port's float32 conv (``ops/conv.py``: its weight gradient a GEMM)
  against float64 on the card, at AlexNet's 5x5 conv, batched and per
  sample under ``vmap(grad)``;
- ``parallel/mesh.py:global_grads``: its gradients the caller's alone;
- the program's spans (``utils/spans.py``): one ``conv.wgrad`` a conv a
  backward, plain and under ``vmap(grad)``, with device time; a traced
  AlexNet epoch has the same device operations with its spans as without
  them, and its ``train.step`` records hold the profiler's events."""

import numpy as np
import pytest
import torch

from clsurvey_torch.models import registry as treg
from clsurvey_torch.models.convert import params_from_jax
from clsurvey_torch.ops import _kernels, pool, preprocess as pp
from clsurvey_torch.utils import device as device_lib

pytestmark = pytest.mark.cuda

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


@pytest.fixture()
def cuda():
    """The card, decided per test (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return device_lib.resolve("cuda")  # TF32 off, as the port runs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(200, 64, 64, 3), (5, 7, 9, 3),
                                   (3, 5, 8, 3), (7, 33, 24, 3),
                                   (2, 64, 60, 3)])
def test_preprocess_kernel_matches_plain(cuda, dtype, shape):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randint(0, 256, shape, dtype=torch.uint8, device=cuda,
                      generator=gen)
    flip = torch.randint(0, 2, (shape[0],), dtype=torch.uint8, device=cuda,
                         generator=gen)
    before = _kernels.LAUNCHES["normalize_flip"]
    for mask in (flip, None):
        got = pp.preprocess(x, MEAN, STD, mask, dtype)
        want = pp.normalize_flip_plain(x, MEAN, STD, mask, dtype)
        if dtype == torch.bfloat16:
            assert torch.equal(got, want)
        else:
            ulp = (torch.nextafter(want, torch.full_like(want, np.inf))
                   - want).abs()
            assert bool(((got - want).abs() <= ulp).all())
    assert _kernels.LAUNCHES["normalize_flip"] == before + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_preprocess_vector_and_scalar_kernels_agree(cuda, dtype):
    """The vector kernel (aligned, width % 8 == 0) and the scalar kernel
    at the same shape (the route an unaligned pointer takes): bit-equal."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    shape = (9, 16, 24, 3)
    aligned = torch.randint(0, 256, shape, dtype=torch.uint8, device=cuda,
                            generator=gen)
    flat = torch.empty(aligned.numel() + 1, dtype=torch.uint8, device=cuda)
    shifted = flat[1:].view(shape)
    shifted.copy_(aligned)
    assert aligned.data_ptr() % 16 == 0 and shifted.data_ptr() % 16 == 1
    flip = torch.randint(0, 2, (shape[0],), dtype=torch.uint8, device=cuda,
                         generator=gen)
    for mask in (flip, None):
        assert torch.equal(pp.preprocess(aligned, MEAN, STD, mask, dtype),
                           pp.preprocess(shifted, MEAN, STD, mask, dtype))


def test_pool_under_vmap_grad_is_one_launch_each(cuda):
    x = torch.randint(0, 3, (16, 1, 8, 8, 64), device=cuda).float()
    w = torch.randn(64, device=cuda)

    def f(w_, x1):
        return (pool.pool2x2(x1 * w_) ** 2).sum()

    before = dict(_kernels.LAUNCHES)
    got = torch.func.vmap(torch.func.grad(f), in_dims=(None, 0))(w, x)
    assert _kernels.LAUNCHES["pool_fwd"] == before["pool_fwd"] + 1
    assert _kernels.LAUNCHES["pool_bwd"] == before["pool_bwd"] + 1
    loop = torch.stack([torch.autograd.grad(
        f(wr := w.clone().requires_grad_(), x[i]), wr)[0]
        for i in range(x.shape[0])])
    torch.testing.assert_close(got, loop, rtol=1e-6, atol=1e-6)


def _offset(t: torch.Tensor, offset: int) -> torch.Tensor:
    """``t``'s values in a tensor whose base pointer is ``offset`` elements
    past an allocation's start (1: not 16-byte aligned)."""
    flat = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    out = flat[offset:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(200, 64, 64, 64), (200, 8, 8, 128),
                                   (6, 9, 7, 64), (3, 2, 3, 5),
                                   (4, 6, 8, 8), (5, 7, 6, 12),
                                   (2, 4, 4, 512)])
def test_pool_kernels_match_plain(cuda, dtype, shape, offset):
    """Bit-equal values, codes and dx on both routes: the vec route where C
    is a multiple of V (4 float32, 8 bfloat16) and the input is aligned,
    the scalar route at other C and at an input one element off; each
    launch counted on the route :func:`pool.pool_route` names."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = _offset(torch.randint(0, 3, shape, device=cuda,
                              generator=gen).to(dtype), offset)
    route = "vec" if offset == 0 and shape[3] % pool.VEC_WIDTH[dtype] == 0 \
        else "scalar"
    before = dict(_kernels.ROUTES)
    val, code = pool.pool_fwd(x)
    pval, pcode = pool.pool_fwd_plain(x)
    assert torch.equal(val, pval) and torch.equal(code, pcode)
    g = _offset(torch.randn(val.shape, device=cuda, generator=gen).to(dtype),
                offset)
    assert torch.equal(pool.pool_bwd(g, code, x.shape),
                       pool.pool_bwd_plain(g, code, x.shape))
    launched = {k: _kernels.ROUTES[k] - before[k] for k in before}
    assert launched == {f"pool_{k}_{r}": int(r == route)
                        for k in ("fwd", "bwd") for r in ("vec", "scalar")}


def test_pool_autograd_matches_max_pool2d(cuda):
    x = torch.randn(4, 16, 16, 64, device=cuda, requires_grad=True)
    g = torch.randn(4, 8, 8, 64, device=cuda)
    (dx,) = torch.autograd.grad(pool.pool2x2(x), x, g)
    ref = torch.nn.functional.max_pool2d(x.permute(0, 3, 1, 2), 2, 2)
    (dref,) = torch.autograd.grad(ref, x, g.permute(0, 3, 1, 2))
    assert torch.equal(pool.pool2x2(x), ref.permute(0, 2, 3, 1))
    assert torch.equal(dx, dref)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    with pytest.raises(ValueError):
        pool.pool_fwd(torch.zeros(2, 8, 8, 4, device=cuda).transpose(1, 2))
    with pytest.raises(ValueError):
        pool.pool_fwd(torch.zeros(2, 8, 8, 4, device=cuda,
                                  dtype=torch.float16))
    with pytest.raises(ValueError):
        pp.preprocess(torch.zeros(2, 8, 8, 4, dtype=torch.uint8,
                                  device=cuda), MEAN, STD)


def test_backbone_on_the_card_matches_the_cpu(cuda):
    spec = treg.parse_model_name("", "small_VGG9_cl_128_128", (64, 64))
    model = treg.init_model_state(spec, seed=0, max_tasks=1,
                                  classes_per_task=4)
    module = spec.make_backbone()
    x = torch.randn(8, 64, 64, 3, generator=torch.Generator().manual_seed(2))
    feats = {}
    for dev in ("cpu", cuda):
        params = {k: v.requires_grad_()
                  for k, v in params_from_jax(model["params"], dev).items()}
        out = torch.func.functional_call(module.to(dev), params,
                                         (x.to(dev),))
        grads = torch.autograd.grad(out.square().sum(), list(params.values()))
        feats[str(dev)] = (out.detach().cpu(), [g.cpu() for g in grads])
    (f_cpu, g_cpu), (f_gpu, g_gpu) = feats["cpu"], feats[str(cuda)]
    torch.testing.assert_close(f_gpu, f_cpu, rtol=1e-4, atol=1e-5)
    for a, b in zip(g_gpu, g_cpu):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-5)


def test_conv_weight_grad_is_float32_exact_on_the_card(cuda):
    """AlexNet's conv_1 (64 -> 192, 5x5, pad 2, 27x27) at batch 32,
    channels_last: forward, input and weight gradient of the port's conv
    in float32 within 1e-4 of the largest float64 entry (cuDNN's own
    float32 weight gradient here was 1e-2 off, ``utils/conv_precision``)."""
    from clsurvey_torch.ops.conv import conv2d

    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.relu(torch.randn(32, 64, 27, 27, generator=gen, device=cuda,
                               dtype=torch.float64)).requires_grad_()
    w = (torch.randn(192, 64, 5, 5, generator=gen, device=cuda,
                     dtype=torch.float64) * 0.035).requires_grad_()
    y = torch.nn.functional.conv2d(x, w, padding=2)
    dy = torch.randn(y.shape, generator=gen, device=cuda, dtype=torch.float64)
    want = (y,) + torch.autograd.grad(y, (x, w), dy)
    x32, w32 = (t.detach().float().contiguous(
        memory_format=torch.channels_last).requires_grad_() for t in (x, w))
    y32 = conv2d(x32, w32, None, 1, 2)
    got = (y32,) + torch.autograd.grad(
        y32, (x32, w32), dy.float().contiguous(
            memory_format=torch.channels_last))
    for g, e in zip(got, want):
        top = float(e.abs().max())
        assert float((g.double() - e).abs().max()) <= 1e-4 * top


def test_conv_per_sample_grads_are_float32_exact_on_the_card(cuda):
    """MAS's route: ``vmap(grad)`` over 16 samples of one row through the
    port's conv (the ``Conv2dExactWeightGrad`` vmap rule) at AlexNet's
    conv_1: each sample's input and weight gradient in float32 within 1e-4
    of its largest float64 entry."""
    from clsurvey_torch.ops.conv import conv2d

    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.relu(torch.randn(16, 64, 27, 27, generator=gen, device=cuda,
                               dtype=torch.float64))
    w = torch.randn(192, 64, 5, 5, generator=gen, device=cuda,
                    dtype=torch.float64) * 0.035
    dy = torch.randn(16, 192, 27, 27, generator=gen, device=cuda,
                     dtype=torch.float64)

    def per_sample(fn, *ts):
        def loss(row, weight, cot):
            return (fn(row[None], weight, padding=2) * cot[None]).sum()

        return torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)),
                               in_dims=(0, None, 0))(*ts)

    want = per_sample(torch.nn.functional.conv2d, x, w, dy)
    got = per_sample(conv2d, *(t.float().contiguous(
        memory_format=torch.channels_last) for t in (x, w, dy)))
    for g, e in zip(got, want):
        for i in range(16):
            top = float(e[i].abs().max())
            assert float((g[i].double() - e[i]).abs().max()) <= 1e-4 * top


def test_gradients_are_the_callers_alone_on_the_card(cuda):
    """``parallel/mesh.py:global_grads`` on the card, 200 calls in a row:
    each gradient it returns is referenced by the caller alone (use count
    1) the moment it returns, and no leaf keeps a ``.grad``. (The
    gradients of ``torch.autograd.grad`` were also held by its graph task
    until autograd's device thread let go of it.)"""
    from clsurvey_torch.parallel import mesh as mesh_lib

    gen = torch.Generator(device=cuda).manual_seed(2)
    leaves = [torch.randn(512, 512, generator=gen, device=cuda)
              .requires_grad_() for _ in range(4)]
    x = torch.randn(256, 512, generator=gen, device=cuda)
    counts = set()
    for _ in range(200):
        h = x
        for w in leaves:
            h = torch.tanh(h @ w)
        grads = mesh_lib.global_grads(h.square().sum(), leaves)
        counts.update(g._use_count() for g in grads)
        assert all(w.grad is None for w in leaves)
    assert counts == {1}


# ---------------------------------------------------------------------------
# the program's spans on the card (utils/spans.py)
# ---------------------------------------------------------------------------

def _profiled():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def test_conv_wgrad_spans_on_the_card(cuda):
    """One ``conv.wgrad`` span a conv a backward, with its rows and the
    card's time: two convs through the plain route, then one under MAS's
    ``vmap(grad)`` over 16 samples (the samples folded into the rows).
    ``utils/devtime.py`` counts no span among the card's kernels."""
    from clsurvey_torch.ops.conv import conv2d
    from clsurvey_torch.utils import devtime, spans

    gen = torch.Generator(device=cuda).manual_seed(0)

    def t(*shape):
        return torch.randn(*shape, generator=gen, device=cuda).contiguous(
            memory_format=torch.channels_last)

    x, w1, w2 = t(8, 64, 27, 27), t(192, 64, 5, 5) * 0.03, t(64, 192, 3, 3)
    w1.requires_grad_()
    w2.requires_grad_()
    spans.reset()
    with _profiled() as prof:
        out = conv2d(torch.relu(conv2d(x, w1, None, 1, 2)), w2, None, 1, 1)
        out.square().sum().backward()
        torch.cuda.synchronize()
    plain = spans.records("conv.wgrad")
    assert [r.n for r in plain] == [8, 8]
    # the spans' annotations on the card's side are no kernels of devtime's
    assert not [k for k in devtime.kernel_us(prof)
                if k.startswith(spans.PREFIX)]

    def loss(row, weight):
        return conv2d(row[None], weight, None, 1, 2).square().sum()

    spans.reset()
    with _profiled():
        torch.func.vmap(torch.func.grad(loss, argnums=1),
                        in_dims=(0, None))(t(16, 64, 27, 27), w1.detach())
    per_sample = spans.records("conv.wgrad")
    assert [r.n for r in per_sample] == [16]
    assert all(r.device_ms > 0 for r in plain + per_sample)
    spans.reset()


def _alexnet_epoch(cuda, steps=4, batch=16, px=64):
    """An epoch of AlexNet's train step on the card (64 px, dropout and
    flips on), its loss read back."""
    from clsurvey_torch.engine import train as ttrain
    from clsurvey_torch.methods.base import UpdateRule

    spec = treg.parse_model_name("", "alexnet", (px, px))
    ctx = ttrain.make_context(spec, task=0, n_tasks=1, class_counts=[5],
                              mean=MEAN, std=STD, update_rule=UpdateRule(),
                              device=cuda, augment=True)
    model = treg.init_model_state(spec, 0, max_tasks=1, classes_per_task=5,
                                  class_counts=[5])
    box = [ttrain.state_from_model(model, None, cuda)]
    box[0].mstate = UpdateRule().init_state(None, {}, ctx)
    engine = ttrain.Engine(ctx)
    gen = torch.Generator(device=cuda).manual_seed(0)
    n = steps * batch
    images = torch.randint(0, 256, (n, px, px, 3), dtype=torch.uint8,
                           device=cuda, generator=gen)
    labels = torch.randint(0, 5, (n,), device=cuda, generator=gen)

    def epoch():
        box[0], metrics = engine.train_epoch(
            box[0], images, labels, torch.arange(n),
            torch.Generator(device=cuda).manual_seed(1), 1e-3, batch)
        float(metrics["loss"])

    return epoch


def _traced(epoch):
    """``epoch`` traced as the benchmark traces its window: (the trace as
    ``clbench/trace.py`` reads it, the profiler)."""
    from clbench import trace as trace_lib

    prof = trace_lib.start()
    with trace_lib.span("window", True):
        epoch()
        torch.cuda.synchronize()
    return trace_lib.read(prof), prof


def test_step_spans_on_the_card_add_no_device_operation(cuda, monkeypatch):
    """A traced AlexNet epoch with the program's spans and without them:
    the same kernels, copies and memsets (the spans' device-side
    annotations are no operations of the card's), so the same
    ``launches_per_step``. Each ``train.step`` record holds the profiler's
    event of its range (to 0.1 ms; a handoff of the interpreter lock to
    autograd's thread between the two stamps widens a record), their ends
    within 1 ms in the median, and every step and conv weight gradient has
    its device time."""
    from clsurvey_torch.utils import spans

    epoch = _alexnet_epoch(cuda)
    epoch()  # cuDNN's algorithm search, outside the traces
    spans.reset()
    with_spans, prof = _traced(epoch)
    steps = spans.records("train.step")
    wgrad = spans.records("conv.wgrad")
    assert [r.step for r in steps] == [1, 2, 3, 4]
    assert sorted(r.step for r in wgrad) == [s for s in (1, 2, 3, 4)
                                             for _ in range(5)]
    assert all(r.device_ms > 0 for r in steps + wgrad)
    events = sorted(
        (ev.start_ns(), ev.start_ns() + ev.duration_ns())
        for ev in prof.profiler.kineto_results.events()
        if ev.name() == spans.PREFIX + spans.STEP
        and "CUDA" not in str(ev.device_type()))
    assert len(events) == len(steps)
    gaps = []
    for (s, e), r in zip(events, steps):
        assert r.start_ns - 100_000 <= s <= e <= r.end_ns + 100_000, \
            (r.start_ns, s, e, r.end_ns)
        gaps += [s - r.start_ns, r.end_ns - e]
    assert sorted(gaps)[len(gaps) // 2] < 1_000_000, gaps
    monkeypatch.setattr(spans, "span", lambda *a, **k: spans.OFF)
    without, _ = _traced(epoch)
    spans.reset()

    def ops(trace):
        return sorted((name, kind) for name, kind, _, _ in trace.ops)

    got, want = ops(with_spans), ops(without)
    assert got == want, (len(got), len(want), sorted(set(got) ^ set(want)))
    assert not any(name.startswith(spans.PREFIX) for name, _ in got)
