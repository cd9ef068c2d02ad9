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
  float32 and bfloat16, tie-heavy inputs, even and odd sizes (up to
  VGG-16's first pool at batch 200, (200,224,224,64)), on the vec
  route (C a multiple of 16 bytes, aligned) and the scalar route (other C,
  an input one element off), each launch counted on its route;
- the pool pair under ``torch.func.vmap(grad)``: one launch each, equal to
  a per-sample loop;
- the backbone on the card against the same backbone on the CPU;
- the port's float32 conv (``ops/conv.py``: its weight gradient kernel C)
  against float64 on the card, at AlexNet's 5x5 conv, batched and per
  sample under ``vmap(grad)``;
- kernel C (``csrc/conv_wgrad.cu``) at every conv shape of
  ``utils/conv_precision``, on the program's design and, where C_out is a
  multiple of 128, on the other too (warp-specialised and first): against
  float64 and its plain twin at 200 and 37 rows, per sample (16 of one
  row, 3 of two), bitwise repeatable, each call counted on its route;
  five calls a step of AlexNet at 224 px (scalar, vec, three
  warp-specialised); at VGG-16's 13 convs at 224 px
  (``clbench/configs/vgg16_224.json``, batch 16; the first keeps the twin)
  on both designs where both run, a VGG-16 train step's 12 calls on their
  routes (11 warp-specialised), and its conv1_2 at batch 200, 10,035,200
  output pixels split into slices, against float64;
- ``parallel/mesh.py:global_grads``: its gradients the caller's alone;
- the program's spans (``utils/spans.py``): one ``conv.wgrad`` a conv a
  backward, plain and under ``vmap(grad)``, with device time; one ``pool``
  a B1 and a B2 call inside a train step with its bytes and device time;
  a traced AlexNet epoch has the same device operations with its spans as
  without them, its ``train.step`` records hold the profiler's events, and
  the sampled step has a ``conv.fwd`` a conv and a ``conv.dgrad`` a conv
  but the first."""

import functools

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
                                   (2, 4, 4, 512), (200, 224, 224, 64)])
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
                        for k in ("fwd", "bwd") for r in ("vec", "scalar")
                        } | {"conv_wgrad_vec": 0, "conv_wgrad_scalar": 0,
                             "conv_wgrad_ws": 0}


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


# ---------------------------------------------------------------------------
# kernel C: the float32 conv weight gradient (ops/conv.py, csrc/conv_wgrad.cu)
# ---------------------------------------------------------------------------

WGRAD_REL_TOL = 1e-4  # against float64, of its largest entry (chip_smoke's)


def _wgrad_inputs(cuda, name, n, seed=0):
    """float64 ReLU'd input and normal cotangent at a card shape of
    ``utils/conv_precision``, and their float32 channels_last copies."""
    from clsurvey_torch.utils.conv_precision import SHAPES

    cin, cout, k, st, p, hw = SHAPES[name]
    oh = (hw + 2 * p - k) // st + 1
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.relu(torch.randn(n, cin, hw, hw, generator=gen, device=cuda,
                               dtype=torch.float64))
    dy = torch.randn(n, cout, oh, oh, generator=gen, device=cuda,
                     dtype=torch.float64)
    x32, dy32 = (t.float().contiguous(memory_format=torch.channels_last)
                 for t in (x, dy))
    return x, dy, x32, dy32, (cout, cin, k, k), st, p


def _worst_rel(got, want) -> float:
    """The largest over the leading dimension of each entry's error over
    its own largest float64 entry."""
    err = (got.double() - want).flatten(1).abs().amax(1)
    return float((err / want.flatten(1).abs().amax(1)).max())


def _designs(cin, cout):
    """The designs kernel C can run a call on (``ops/conv.py``): "program",
    the program's own route, and "other", the other design, where C_out and
    the channels allow the warp-specialised one. Decided from the shapes
    alone (static data, the same in every worker)."""
    both = cin % 4 == 0 and cout % 128 == 0
    return ["program", "other"] if both else ["program"]


def _route(design, cin, cout, x32, dy32, pixels):
    """(route to force, route counted) of ``design`` for this call: the
    program's forces none."""
    from clsurvey_torch.ops import conv

    copies = (conv.wgrad_route(cin, x32.data_ptr()),
              conv.wgrad_route(cout, dy32.data_ptr()))
    program = conv.wgrad_design(*copies, cout, pixels)
    if design == "program":
        return None, program
    other = copies[0] if program == "ws" else "ws"
    return other, other


def _forced(x32, dy32, w_shape, st, p, samples, route):
    """Kernel C on ``route``, chosen below :func:`conv.weight_grad_cuda`'s
    entry: that route's plan for this card, one launch."""
    from clsurvey_torch.ops import conv

    x_nhwc, dy_nhwc = conv._nhwc(x32, dy32, w_shape)
    n, _, oh, ow = dy32.shape
    plan = conv.wgrad_plan(w_shape, (oh, ow), n, samples, route,
                           conv.wgrad_route(w_shape[0], dy_nhwc.data_ptr()),
                           conv._sms(x32.device), conv._resident)
    out = conv._launch(plan, x_nhwc, dy_nhwc, w_shape, st, p)
    return out if samples else out[0]


def _by_design(shapes):
    """(name, design) for each {name: (C_in, C_out, ...)} and each design
    its shape allows."""
    return [pytest.param(name, design, id=f"{name}-{design}")
            for name, (cin, cout, *_) in shapes.items()
            for design in _designs(cin, cout)]


def _card_shapes():
    from clsurvey_torch.utils.conv_precision import SHAPES

    return SHAPES


@pytest.mark.parametrize("rows", [200, 37])
@pytest.mark.parametrize("name, design", _by_design(_card_shapes()))
def test_conv_wgrad_kernel_matches_float64_and_plain(cuda, name, design,
                                                     rows):
    """Kernel C at every card conv shape, at batch 200 and at a ragged 37
    rows (pixels that fill no tile), on each design the shape allows (the
    program's and, where C_out is a multiple of 128, the other): within
    1e-4 of the largest float64 entry, as the plain twin is, so the two
    within 2e-4 of each other; one launch on the route
    :func:`conv.wgrad_design` names for the program (or the other design
    forced), none where :func:`conv.takes_kernel`'s rule keeps the plain
    twin (small_VGG9's first conv: 27 patch columns)."""
    from clsurvey_torch.ops import conv

    x, dy, x32, dy32, w_shape, st, p = _wgrad_inputs(cuda, name, rows)
    want = conv.weight_grad_plain(x, dy, w_shape, st, p)
    cout, cin = w_shape[:2]
    force, route = _route(design, cin, cout, x32, dy32,
                          rows * dy.shape[2] * dy.shape[3])
    kernel = conv.takes_kernel(x32, dy32, w_shape)
    assert kernel == (name != "small_VGG9.conv_0")
    before = dict(_kernels.ROUTES)
    got = conv.weight_grad(x32, dy32, w_shape, st, p) if force is None \
        else _forced(x32, dy32, w_shape, st, p, None, force)
    launched = {k: _kernels.ROUTES[k] - before[k] for k in before}
    assert {k: n for k, n in launched.items() if n} == (
        {f"conv_wgrad_{route}": 1} if kernel else {})
    assert got.shape == w_shape
    if kernel:  # the port's conv weights' own layout
        assert got.is_contiguous(memory_format=torch.channels_last)
    plain = conv.weight_grad_plain(x32, dy32, w_shape, st, p)
    assert _worst_rel(got[None], want[None]) <= WGRAD_REL_TOL
    assert _worst_rel(plain[None], want[None]) <= WGRAD_REL_TOL
    assert float((got - plain).abs().max()) <= \
        2 * WGRAD_REL_TOL * float(want.abs().max())


@pytest.mark.parametrize("samples, per", [(16, 1), (3, 2)],
                         ids=["16x1", "3x2"])
@pytest.mark.parametrize("name, design", _by_design(_card_shapes()))
def test_conv_wgrad_kernel_per_sample(cuda, name, design, samples, per):
    """The per-sample form (MAS's ``vmap(grad)`` rule): V samples of
    ``per`` rows one after another, on each design the shape allows, each
    sample's gradient within 1e-4 of its own largest float64 entry, and
    equal to kernel C on that sample's rows alone to float32 rounding (the
    slices differ)."""
    from clsurvey_torch.ops import conv

    x, dy, x32, dy32, w_shape, st, p = _wgrad_inputs(cuda, name,
                                                     samples * per, seed=1)
    cout, cin = w_shape[:2]
    force, route = _route(design, cin, cout, x32, dy32,
                          per * dy.shape[2] * dy.shape[3])
    want = conv.weight_grad_plain(x, dy, w_shape, st, p, samples=samples)
    kernel = conv.takes_kernel(x32, dy32, w_shape)
    before = dict(_kernels.ROUTES)
    got = conv.weight_grad(x32, dy32, w_shape, st, p, samples=samples) \
        if force is None else _forced(x32, dy32, w_shape, st, p, samples,
                                      force)
    launched = {k: _kernels.ROUTES[k] - before[k] for k in before}
    assert {k: n for k, n in launched.items() if n} == (
        {f"conv_wgrad_{route}": 1} if kernel else {})
    assert got.shape == (samples, *w_shape)
    assert _worst_rel(got, want) <= WGRAD_REL_TOL
    for v in (0, samples - 1):
        rows = slice(v * per, (v + 1) * per)
        alone = conv.weight_grad(x32[rows], dy32[rows], w_shape, st, p)
        assert float((got[v] - alone).abs().max()) <= \
            2 * WGRAD_REL_TOL * float(want[v].abs().max())


@pytest.mark.parametrize("name, rows, samples, design", [
    ("alexnet.conv_0", 200, None, "program"),
    ("alexnet.conv_1", 200, None, "program"),
    ("alexnet.conv_3", 37, None, "program"),
    ("alexnet.conv_3", 37, None, "other"),
    ("small_VGG9.conv_1", 16, 16, "program"),
    ("small_VGG9.conv_3", 200, None, "program"),
    ("small_VGG9.conv_3", 200, None, "other"),
    ("small_VGG9.conv_3", 16, 16, "program"),
    ("small_VGG9.conv_3", 16, 16, "other")])
def test_conv_wgrad_kernel_is_bitwise_repeatable(cuda, name, rows, samples,
                                                 design):
    """Two calls on the same inputs give the same bits, on the program's
    design and on the other where the shape has one: the slices' partial
    sums, and the warp-specialised design's two sets of warps, are added
    in a fixed order, with no atomics."""
    from clsurvey_torch.ops import conv

    _, dy, x32, dy32, w_shape, st, p = _wgrad_inputs(cuda, name, rows)
    cout, cin = w_shape[:2]
    force, _ = _route(design, cin, cout, x32, dy32,
                      rows // (samples or 1) * dy.shape[2] * dy.shape[3])
    call = functools.partial(conv.weight_grad_cuda, x32, dy32, w_shape, st,
                             p, samples) if force is None else \
        functools.partial(_forced, x32, dy32, w_shape, st, p, samples, force)
    first = call()
    assert torch.equal(first, call())


def _vgg16_convs() -> dict:
    """{conv name: (C_in, C_out, input side)} of VGG-16's 13 3x3 convs at
    224 px, from the benchmark's configuration."""
    from clbench.reference import net
    from clbench.spec import Spec

    return {layer["name"]: (src[0], dst[0], src[1]) for layer, src, dst
            in net.shapes(Spec().config("vgg16_224"))
            if layer["op"] == "conv"}


def _vgg16_wgrad_inputs(cuda, name: str, n: int):
    cin, cout, hw = _vgg16_convs()[name]
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.relu(torch.randn(n, cin, hw, hw, generator=gen, device=cuda,
                               dtype=torch.float64))
    dy = torch.randn(n, cout, hw, hw, generator=gen, device=cuda,
                     dtype=torch.float64)
    x32, dy32 = (t.float().contiguous(memory_format=torch.channels_last)
                 for t in (x, dy))
    return x, dy, x32, dy32, (cout, cin, 3, 3)


def _vgg16_by_design():
    convs = _vgg16_convs()
    return [pytest.param(name, design, id=f"{name}-{design}")
            for name, (cin, cout, _) in convs.items()
            for design in _designs(cin, cout)]


@pytest.mark.parametrize("name, design", _vgg16_by_design())
def test_conv_wgrad_kernel_at_vgg16_shapes(cuda, name, design):
    """Kernel C at each of VGG-16's convs at 224 px, batch 16, on each
    design the shape allows: within 1e-4 of the largest float64 entry, one
    launch where :func:`conv.takes_kernel` sends the call to it (12 of the
    13; the first conv's 27 patch columns keep the twin), none where not,
    on the warp-specialised route at the 11 whose C_out is a multiple of
    128 and the first design's at conv1_2 (C_out 64)."""
    from clsurvey_torch.ops import conv

    x, dy, x32, dy32, w_shape = _vgg16_wgrad_inputs(cuda, name, 16)
    cout, cin = w_shape[:2]
    kernel = conv.takes_kernel(x32, dy32, w_shape)
    assert kernel == (name != "features.conv_0")
    force, route = _route(design, cin, cout, x32, dy32,
                          16 * dy.shape[2] * dy.shape[3])
    if design == "program" and kernel:
        assert route == ("vec" if cout == 64 else "ws")
    want = conv.weight_grad_plain(x, dy, w_shape, 1, 1)
    del x, dy
    before = dict(_kernels.ROUTES)
    got = conv.weight_grad(x32, dy32, w_shape, 1, 1) if force is None \
        else _forced(x32, dy32, w_shape, 1, 1, None, force)
    launched = {k: _kernels.ROUTES[k] - before[k] for k in before}
    assert {k: n for k, n in launched.items() if n} == (
        {f"conv_wgrad_{route}": 1} if kernel else {})
    assert _worst_rel(got[None], want[None]) <= WGRAD_REL_TOL


def test_conv_wgrad_kernel_at_vgg16_conv1_2_batch_200(cuda):
    """VGG-16's conv1_2 (64 -> 64 at 224 px) at batch 200: 10,035,200
    output pixels, the largest reduction of any cell, split over slices
    that a second pass sums: within 1e-4 of the largest float64 entry,
    and bitwise repeatable."""
    from clsurvey_torch.ops import conv

    x, dy, x32, dy32, w_shape = _vgg16_wgrad_inputs(
        cuda, "features.conv_1", 200)
    assert conv.takes_kernel(x32, dy32, w_shape)
    assert conv.wgrad_design("vec", "vec", 64, 10035200) == "vec"
    plan = conv.wgrad_plan(
        w_shape, (224, 224), 200, None, "vec", "vec",
        torch.cuda.get_device_properties(cuda).multi_processor_count,
        conv._resident)
    assert plan.pixels == 10035200 and plan.slices > 1
    want = conv.weight_grad_plain(x, dy, w_shape, 1, 1)
    del x, dy
    got = conv.weight_grad(x32, dy32, w_shape, 1, 1)
    assert _worst_rel(got[None], want[None]) <= WGRAD_REL_TOL
    assert torch.equal(got, conv.weight_grad(x32, dy32, w_shape, 1, 1))


def test_conv_wgrad_kernel_counts_five_a_step_of_alexnet(cuda):
    """Every float32 conv weight gradient of AlexNet's train step at 224
    px goes through kernel C: five launches a step, the first conv (C_in
    3) on the scalar route, the second (C_out 192) on the first design's
    vec route and the other three (13 x 13 pixels a row) on the
    warp-specialised route."""
    epoch = _epoch(cuda, px=224)  # 4 steps
    _kernels.reset_launches()
    epoch()
    assert _kernels.LAUNCHES["conv_wgrad"] == 20
    assert (_kernels.ROUTES["conv_wgrad_scalar"],
            _kernels.ROUTES["conv_wgrad_vec"],
            _kernels.ROUTES["conv_wgrad_ws"]) == (4, 4, 12)


def test_vgg16_step_sends_its_convs_to_the_warp_specialised_route(cuda):
    """A VGG-16 train step at 224 px (batch 8): its 12 kernel-routed conv
    weight gradients are 12 launches of kernel C, the 11 whose C_out is a
    multiple of 128 on the warp-specialised route, conv1_2 (C_out 64) on
    the first design's vec route; the first conv keeps the plain twin."""
    epoch = _epoch(cuda, "16normal_DROP_cl_4096_4096", steps=1, batch=8,
                   px=224)
    _kernels.reset_launches()
    epoch()
    assert _kernels.LAUNCHES["conv_wgrad"] == 12
    assert (_kernels.ROUTES["conv_wgrad_scalar"],
            _kernels.ROUTES["conv_wgrad_vec"],
            _kernels.ROUTES["conv_wgrad_ws"]) == (0, 1, 11)


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


def test_pool_spans_on_the_card(cuda):
    """Inside a train step, one ``pool`` span a B1 and a B2 call, each
    with the bytes the call moves (``ops/pool.py:call_bytes``) and the
    card's time; outside one, none."""
    from clsurvey_torch.utils import spans

    x = torch.randn(8, 32, 32, 64, device=cuda, requires_grad=True)
    spans.reset()
    with _profiled():
        pool.pool2x2(x).square().sum().backward()
        with spans.span(spans.STEP, 8):
            pool.pool2x2(x).square().sum().backward()
        torch.cuda.synchronize()
    recs = spans.records("pool")
    assert [r.n for r in recs] == [pool.call_bytes(x.shape, 4)] * 2
    assert all(r.device_ms > 0 and r.step == 1 for r in recs)
    spans.reset()


def _epoch(cuda, model="alexnet", steps=4, batch=16, px=64):
    """An epoch of ``model``'s train step on the card (AlexNet at 64 px by
    default; dropout and flips on), its loss read back."""
    from clsurvey_torch.engine import train as ttrain
    from clsurvey_torch.methods.base import UpdateRule

    spec = treg.parse_model_name("", model, (px, px))
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
    within 1 ms in the median, and every step, conv weight gradient and
    sampled step's conv forward and input gradient has its device time."""
    from clsurvey_torch.utils import spans

    epoch = _epoch(cuda)
    epoch()  # cuDNN's algorithm search, outside the traces
    spans.reset()
    with_spans, prof = _traced(epoch)
    steps = spans.records("train.step")
    wgrad = spans.records("conv.wgrad")
    assert [r.step for r in steps] == [1, 2, 3, 4]
    assert sorted(r.step for r in wgrad) == [s for s in (1, 2, 3, 4)
                                             for _ in range(5)]
    # the forwards and input gradients of the sampled step (one in 8)
    fwd, dgrad = spans.records("conv.fwd"), spans.records("conv.dgrad")
    assert [r.step for r in fwd] == [1] * 5
    assert [r.step for r in dgrad] == [1] * 4
    assert all(r.device_ms > 0 for r in steps + wgrad + fwd + dgrad)
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
