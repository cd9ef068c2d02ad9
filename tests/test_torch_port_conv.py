"""``clsurvey_torch/ops/conv.py``: the convolution whose float32 weight
gradient on the card is a GEMM over the unfolded input.

On the CPU, in float64: :func:`weight_grad` against the JAX package's
convolution (``lax.conv_general_dilated``, NHWC / HWIO, as flax's
``nn.Conv`` runs it) differentiated by ``jax.grad`` under
``jax.enable_x64``, and against autograd of ``F.conv2d``, at AlexNet's and
small_VGG9's kernel sizes, strides and paddings, with one row a chunk and
with every row in one chunk; :class:`Conv2dExactWeightGrad`'s whole
backward (input, weight, bias) against ``F.conv2d``'s; and
:func:`conv2d`'s dispatch (``F.conv2d`` on the CPU and under
``torch.func``). Tolerance: 1e-12 of the largest entry (float64 sums in
other orders)."""

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
