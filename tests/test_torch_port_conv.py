"""``clsurvey_torch/ops/conv.py``: the convolution whose float32 weight
gradient on the card is a GEMM over the unfolded input.

On the CPU, in float64: :func:`weight_grad` against the JAX package's
convolution (``lax.conv_general_dilated``, NHWC / HWIO, as flax's
``nn.Conv`` runs it) differentiated by ``jax.grad`` under
``jax.enable_x64``, and against autograd of ``F.conv2d``, at AlexNet's and
small_VGG9's kernel sizes, strides and paddings, with one row a chunk and
with every row in one chunk; :class:`Conv2dExactWeightGrad`'s whole
backward (input, weight, bias) against ``F.conv2d``'s; its per-sample
gradients under ``torch.func.vmap(torch.func.grad)`` (MAS's route, its
``vmap`` rules) and :func:`weight_grad`'s per-sample form against per-sample autograd of ``F.conv2d`` and
``jax.vmap(jax.grad)`` of the JAX package's convolution; and
:func:`conv2d`'s dispatch (``F.conv2d`` on the CPU, under ``torch.func``
too). Tolerance: 1e-12 of the largest entry (float64 sums in other
orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from clsurvey_torch.ops import conv as tconv

# (C_in, C_out, kernel, stride, padding, input side): AlexNet's five convs
# at 67 px (conv_0 15x15, conv_1 7x7 after the pool, conv_2-4 3x3) and
# small_VGG9's 3x3 SAME at 8 px
SHAPES = {
    "alexnet.conv_0": (3, 8, 11, 4, 2, 67),
    "alexnet.conv_1": (8, 12, 5, 1, 2, 7),
    "alexnet.conv_2": (12, 16, 3, 1, 1, 3),
    "small_VGG9.conv_0": (3, 8, 3, 1, 1, 8),
    "small_VGG9.conv_1": (8, 8, 3, 1, 1, 8),
}
REL = 1e-12


def _close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    tol = REL * max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


def _inputs(shape, n=3, seed=0):
    cin, cout, k, st, p, hw = shape
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.normal(size=(n, hw, hw, cin)), 0.0)  # NHWC, ReLU'd
    w = rng.normal(size=(k, k, cin, cout)) * (2.0 / (cin * k * k)) ** 0.5
    oh = (hw + 2 * p - k) // st + 1
    dy = rng.normal(size=(n, oh, oh, cout))
    return x, w, dy


def _jax_weight_grad(x, w, dy, st, p):
    """d <conv(x, w), dy> / d w, NHWC / HWIO, in float64."""
    with jax.enable_x64(True):
        def f(kernel):
            y = jax.lax.conv_general_dilated(
                jnp.asarray(x), kernel, (st, st), [(p, p), (p, p)],
                dimension_numbers=("NHWC", "HWIO", "NHWC"))
            return jnp.sum(y * jnp.asarray(dy))

        return np.asarray(jax.grad(f)(jnp.asarray(w)))


def _nchw(a):
    """NHWC numpy -> a channels_last NCHW float64 tensor."""
    return torch.from_numpy(a).permute(0, 3, 1, 2)


@pytest.mark.parametrize("chunk_bytes", [1, tconv.CHUNK_BYTES],
                         ids=["row_a_chunk", "one_chunk"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_weight_grad_matches_jax_and_autograd(name, chunk_bytes):
    cin, cout, k, st, p, hw = SHAPES[name]
    x, w, dy = _inputs(SHAPES[name])
    w_t = torch.from_numpy(w).permute(3, 2, 0, 1).contiguous()  # OIHW
    got = tconv.weight_grad(_nchw(x), _nchw(dy), tuple(w_t.shape), st, p,
                            chunk_bytes=chunk_bytes)
    want_jax = _jax_weight_grad(x, w, dy, st, p).transpose(3, 2, 0, 1)
    _close(got, want_jax, f"{name} against jax.grad")
    w_req = w_t.clone().requires_grad_()
    (want,) = torch.autograd.grad(
        F.conv2d(_nchw(x), w_req, stride=st, padding=p), w_req, _nchw(dy))
    _close(got, want, f"{name} against autograd of F.conv2d")


@pytest.mark.parametrize("chunk_bytes", [1, tconv.CHUNK_BYTES],
                         ids=["sample_a_chunk", "one_chunk"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_weight_grad_per_sample(name, chunk_bytes):
    """``weight_grad(samples=3)`` over 3 samples of 2 rows each, one after
    another: each sample's gradient, against :func:`weight_grad` of that
    sample's rows and ``jax.grad``."""
    cin, cout, k, st, p, hw = SHAPES[name]
    x, w, dy = _inputs(SHAPES[name], n=6, seed=5)
    w_shape = (cout, cin, k, k)
    got = tconv.weight_grad(_nchw(x), _nchw(dy), w_shape, st, p, samples=3,
                            chunk_bytes=chunk_bytes)
    assert got.shape == (3, *w_shape)
    for v in range(3):
        rows = slice(2 * v, 2 * v + 2)
        _close(got[v], tconv.weight_grad(_nchw(x[rows]), _nchw(dy[rows]),
                                         w_shape, st, p),
               f"{name} sample {v} against its rows alone")
        _close(got[v], _jax_weight_grad(x[rows], w, dy[rows], st, p)
               .transpose(3, 2, 0, 1), f"{name} sample {v} against jax.grad")


@pytest.mark.parametrize("input_grad", [True, False])
@pytest.mark.parametrize("name", ["alexnet.conv_0", "alexnet.conv_1",
                                  "small_VGG9.conv_1"])
def test_function_backward_matches_conv2d(name, input_grad):
    cin, cout, k, st, p, hw = SHAPES[name]
    x, w, dy = _inputs(SHAPES[name], seed=1)
    b = np.random.default_rng(2).normal(size=cout)
    grads = {}
    for route in ("port", "conv2d"):
        xt = _nchw(x).clone().requires_grad_(input_grad)
        wt = torch.from_numpy(w).permute(3, 2, 0, 1).contiguous() \
            .requires_grad_()
        bt = torch.from_numpy(b).requires_grad_()
        y = (tconv.Conv2dExactWeightGrad.apply(xt, wt, bt, st, p)
             if route == "port" else F.conv2d(xt, wt, bt, stride=st,
                                              padding=p))
        leaves = (xt, wt, bt) if input_grad else (wt, bt)
        grads[route] = (y.detach(),) + torch.autograd.grad(y, leaves,
                                                           _nchw(dy))
    for got, want in zip(grads["port"], grads["conv2d"]):
        _close(got, want, name)


def test_conv2d_keeps_f_conv2d_on_the_cpu_and_under_torch_func():
    x, w, _ = _inputs(SHAPES["alexnet.conv_1"])
    xt = _nchw(x).float()
    wt = torch.from_numpy(w).permute(3, 2, 0, 1).float().requires_grad_()
    y = tconv.conv2d(xt, wt, None, 1, 2)
    assert type(y.grad_fn).__name__ == "ConvolutionBackward0"
    assert torch.equal(y, F.conv2d(xt, wt, padding=2))

    def loss(weight, row):
        return tconv.conv2d(row[None], weight, None, 1, 2).square().sum()

    per_sample = torch.func.vmap(torch.func.grad(loss),
                                 in_dims=(None, 0))(wt.detach(), xt)
    for i in range(xt.shape[0]):
        w_i = wt.detach().clone().requires_grad_()
        (want,) = torch.autograd.grad(loss(w_i, xt[i]), w_i)
        torch.testing.assert_close(per_sample[i], want, rtol=1e-5,
                                   atol=1e-5)


# (C_in, C_out, kernel, stride, padding, input side): AlexNet's three
# kernel / stride / padding triples and small_VGG9's, 2-4 channels
VMAP_SHAPES = {
    "alexnet.conv_0": (3, 4, 11, 4, 2, 19),
    "alexnet.conv_1": (4, 3, 5, 1, 2, 7),
    "alexnet.conv_2": (3, 2, 3, 1, 1, 5),
    "small_VGG9.conv_0": (3, 4, 3, 1, 1, 8),
    "small_VGG9.conv_1": (4, 4, 3, 1, 1, 6),
}


def _jax_per_sample_grads(x, w, b, dy, st, p):
    """``jax.vmap(jax.grad)`` of <conv(x_v, w) + b, dy_v> per sample v,
    with respect to the row, the kernel and the bias, NHWC / HWIO, in
    float64."""
    with jax.enable_x64(True):
        def f(row, kernel, bias, cot):
            y = jax.lax.conv_general_dilated(
                row[None], kernel, (st, st), [(p, p), (p, p)],
                dimension_numbers=("NHWC", "HWIO", "NHWC")) + bias
            return jnp.sum(y * cot[None])

        grads = jax.vmap(jax.grad(f, argnums=(0, 1, 2)),
                         in_axes=(0, None, None, 0))(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), jnp.asarray(dy))
        return [np.asarray(g) for g in grads]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", list(VMAP_SHAPES))
def test_function_per_sample_grads_under_vmap(name, n):
    """MAS's route: ``vmap(grad)`` through :class:`Conv2dExactWeightGrad`
    (its ``vmap`` rules: the samples folded into the batch)
    gives each sample's input, weight and bias gradient."""
    cin, cout, k, st, p, hw = VMAP_SHAPES[name]
    x, w, dy = _inputs(VMAP_SHAPES[name], n=n, seed=3)
    b = np.random.default_rng(4).normal(size=cout)
    xt, dyt = _nchw(x), _nchw(dy)
    wt = torch.from_numpy(w).permute(3, 2, 0, 1).contiguous()
    bt = torch.from_numpy(b)
    calls = []

    def loss(row, weight, bias, cot):
        y = tconv.Conv2dExactWeightGrad.apply(row[None], weight, bias, st, p)
        calls.append(y.shape)
        return (y * cot[None]).sum()

    got = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2)),
                          in_dims=(0, None, None, 0))(xt, wt, bt, dyt)
    assert len(calls) == 1  # one batched call, not one per sample
    jx, jw, jb = _jax_per_sample_grads(x, w, b, dy, st, p)
    want_jax = (jx.transpose(0, 3, 1, 2), jw.transpose(0, 4, 3, 1, 2), jb)
    for i in range(n):
        leaves = [t.clone().requires_grad_() for t in (xt[i:i + 1], wt, bt)]
        want = torch.autograd.grad(
            F.conv2d(leaves[0], leaves[1], leaves[2], stride=st, padding=p),
            leaves, dyt[i:i + 1])
        for j, what in enumerate(("input", "weight", "bias")):
            _close(got[j][i], want[j][0] if j == 0 else want[j],
                   f"{name} sample {i} {what} against F.conv2d")
            _close(got[j][i], want_jax[j][i],
                   f"{name} sample {i} {what} against jax.vmap(jax.grad)")


# ---------------------------------------------------------------------------
# kernel C's plan and dispatch (the kernel itself runs on the card:
# tests/test_torch_port_cuda.py)
# ---------------------------------------------------------------------------

def _card_shapes():
    from clsurvey_torch.utils.conv_precision import SHAPES as CARD_SHAPES

    return CARD_SHAPES


def _resident(bm, route, dy_route):
    """Blocks an SM: the warp-specialised design's one, the first
    design's as the occupancy API reads them on the H100."""
    return 1 if route == "ws" else (4 if bm == 64 else 2)


@pytest.mark.parametrize("design", ["program", "first"])
@pytest.mark.parametrize("rows, samples", [(200, None), (37, None),
                                           (16, 16), (6, 3), (1, None)],
                         ids=["200", "37", "16x1", "3x2", "1"])
@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("name", list(_card_shapes()))
def test_wgrad_plan_slices_cover_every_pixel_once(name, rows, samples, sms,
                                                  design):
    """The split over output pixels at every card shape, on the program's
    design (:func:`tconv.wgrad_design`, the warp-specialised one where
    C_out is a multiple of 128 and a group has the pixels) and on the
    first: each group's (one sample's) pixels are cut into whole stages of
    the design's ring, every pixel of every row in exactly one slice, no
    slice empty or across a sample's edge; the tile is the design's (128 x
    192 or 256 x 96, 16-pixel stages; 64 or 128 x 128, 16 or 8 pixels) and
    fills C_out where it can; the workspace holds every slice's whole
    tiles, within ``WGRAD_WS_MAX_FLOATS`` on the warp-specialised design,
    and is left out where one slice of unpadded tiles is written to the
    gradient itself."""
    cin, cout, k, st, p, hw = _card_shapes()[name]
    oh = (hw + 2 * p - k) // st + 1
    w_shape = (cout, cin, k, k)
    v = samples or 1
    route = "vec" if design == "first" else tconv.wgrad_design(
        "vec", "vec", cout, rows // v * oh * oh)
    plan = tconv.wgrad_plan(w_shape, (oh, oh), rows, samples, route, "vec",
                            sms, _resident)
    assert plan.route == route and plan.groups == v
    assert plan.pixels == rows // v * oh * oh
    if route == "ws":
        assert (plan.bm, plan.bn, plan.bk) == (
            (256, 96, 16) if cout % 256 == 0 else (128, 192, 16))
    else:
        assert (plan.bm, plan.bn, plan.bk) == (
            (128, 128, 8) if cout % 128 == 0 else (64, 128, 16))
    assert plan.chunk % plan.bk == 0 and plan.slices >= 1
    covered = np.zeros(rows * oh * oh, dtype=int)
    for g in range(v):  # as the kernel cuts them: group g from g * pixels
        first, last = g * plan.pixels, (g + 1) * plan.pixels
        for s in range(plan.slices):
            start = first + s * plan.chunk
            end = min(start + plan.chunk, last)
            assert first <= start < end <= last
            covered[start:end] += 1
    assert (covered == 1).all()
    rows_pad = -(-cout // plan.bm) * plan.bm
    cols_pad = -(-cin * k * k // plan.bn) * plan.bn
    direct = plan.slices == 1 and (rows_pad, cols_pad) == (cout, cin * k * k)
    assert plan.ws_floats == (0 if direct else
                              v * plan.slices * rows_pad * cols_pad)
    if route == "ws":
        assert plan.ws_floats <= max(tconv.WGRAD_WS_MAX_FLOATS,
                                     v * rows_pad * cols_pad)


def _route_rule_cases():
    """(call, the program's route) at batch 200 and per sample (MAS's 16
    samples of one row): AlexNet's and small_VGG9's card shapes at 224
    and 64 px, VGG-16's 13 convs at 224 px (C_in, C_out, side)."""
    from clsurvey_torch.utils.conv_precision import SHAPES as CARD

    vgg16 = [(3, 64, 224), (64, 64, 224), (64, 128, 112), (128, 128, 112),
             (128, 256, 56), (256, 256, 56), (256, 256, 56), (256, 512, 28),
             (512, 512, 28), (512, 512, 28), (512, 512, 14), (512, 512, 14),
             (512, 512, 14)]
    shapes = {name: (cin, cout, (hw + 2 * p - k) // st + 1)
              for name, (cin, cout, k, st, p, hw) in CARD.items()}
    shapes |= {f"vgg16.conv_{i}": s for i, s in enumerate(vgg16)}
    # the first design keeps C_in 3 (scalar copies of x), C_out 64 and 192
    # and groups of fewer than WGRAD_WS_MIN_PIXELS
    ws = {"alexnet.conv_2", "alexnet.conv_3", "alexnet.conv_4",
          "small_VGG9.conv_2", "small_VGG9.conv_3", "small_VGG9.conv_4",
          "small_VGG9.conv_5"} | {f"vgg16.conv_{i}" for i in range(2, 13)}
    per_sample_ws = {"small_VGG9.conv_2", "small_VGG9.conv_3"} | {
        f"vgg16.conv_{i}" for i in range(2, 10)}
    cases = []
    for name, (cin, cout, side) in shapes.items():
        copies = "scalar" if cin % 4 else "vec"
        cases.append(pytest.param(cin, cout, 200 * side * side,
                                  "ws" if name in ws else copies,
                                  id=f"{name}-200"))
        cases.append(pytest.param(cin, cout, side * side,
                                  "ws" if name in per_sample_ws else copies,
                                  id=f"{name}-16x1"))
    return cases


@pytest.mark.parametrize("cin, cout, pixels, route", _route_rule_cases())
def test_wgrad_design_rule(cin, cout, pixels, route):
    """Which calls take the warp-specialised design: both tensors copied
    16 bytes at a time, C_out a multiple of 128 and at least
    ``WGRAD_WS_MIN_PIXELS`` output pixels a group; every conv of the three
    cells' weight gradients at batch 200 but AlexNet's first two and
    VGG-16's first two, and per sample only groups of 784 pixels and
    more."""
    assert tconv.wgrad_design(tconv.wgrad_route(cin, 0),
                              tconv.wgrad_route(cout, 0), cout,
                              pixels) == route


@pytest.mark.parametrize("channels, ptr, route", [
    (64, 256, "vec"),
    (3, 256, "scalar"),     # AlexNet's first conv's input
    (6, 256, "scalar"),     # not a multiple of 4
    (64, 260, "scalar"),    # one float past 16 bytes
])
def test_wgrad_route(channels, ptr, route):
    assert tconv.wgrad_route(channels, ptr) == route


@pytest.mark.parametrize("name", ["alexnet.conv_0", "small_VGG9.conv_1"])
def test_weight_grad_takes_the_plain_route_on_the_cpu(name):
    """Float32 on the CPU: :func:`weight_grad` is the plain twin, bit for
    bit, and launches nothing; a bfloat16 :func:`conv2d` stays
    ``F.conv2d``."""
    from clsurvey_torch.ops import _kernels

    x, w, dy = _inputs(SHAPES[name], seed=6)
    cin, cout, k, st, p, hw = SHAPES[name]
    xt, dyt = _nchw(x).float(), _nchw(dy).float()
    w_shape = (cout, cin, k, k)
    assert not tconv.takes_kernel(xt, dyt, w_shape)
    before = dict(_kernels.LAUNCHES)
    assert torch.equal(tconv.weight_grad(xt, dyt, w_shape, st, p),
                       tconv.weight_grad_plain(xt, dyt, w_shape, st, p))
    assert _kernels.LAUNCHES == before
    wt = torch.from_numpy(w).permute(3, 2, 0, 1).bfloat16().requires_grad_()
    y = tconv.conv2d(xt.bfloat16(), wt, None, st, p)
    assert type(y.grad_fn).__name__ == "ConvolutionBackward0"
