"""clsurvey_torch ops against clsurvey_tpu on the CPU: the preprocess
(kernel A's plain version) and the 2x2 max-pool pair (kernels B1/B2's plain
versions), on the same numpy-made inputs.

- normalize + flip vs JAX ``normalize`` + ``jnp.where`` flip: float32
  within 1 ulp, bfloat16 within 1 bf16 ulp (a 1-ulp float32 difference can
  move a rounding tie);
- the same vs ``normalize_pallas`` in interpret mode, whose kernel body XLA
  on the CPU contracts into one fused multiply-add: the port rounds the
  product ``x*scale`` first (as ``jnp`` normalize and kernel A do), so the
  two differ by up to half an ulp of the product plus one ulp of the
  result, which is the float32 tolerance there;
- pool forward and VJP vs ``pool_pallas.maxpool2x2`` (interpret mode) and
  ``reduce_window``: exact, float32 and bfloat16, tie-heavy inputs;
- ``torch.func.vmap(grad)`` through ``pool2x2`` (per-sample gradients, as
  MAS takes them): equal to a per-sample loop, and to ``jax.vmap(grad)``
  through the JAX pool within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clsurvey_torch.ops import _kernels, conv, pool, preprocess as pp
from clsurvey_tpu.ops import pool_pallas, preprocess as jpp

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _images(shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, shape, dtype=np.uint8), \
        rng.integers(0, 2, (shape[0],)).astype(np.uint8)


def _ulp(a: np.ndarray) -> np.ndarray:
    a = np.abs(a.astype(np.float32))
    return np.nextafter(a, np.float32(np.inf)) - a


def _assert_ulp(got: np.ndarray, want: np.ndarray, dtype: str,
                slack: np.ndarray | float = 0.0):
    got = got.astype(np.float32)
    want = want.astype(np.float32)
    if dtype == "float32":
        tol = _ulp(want) + slack
        assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()
    else:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -8, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_preprocess_matches_jax_normalize_and_flip(dtype):
    x, mask = _images((6, 16, 12, 3))
    got = pp.preprocess(torch.from_numpy(x), MEAN, STD,
                        torch.from_numpy(mask), TORCH_DT[dtype])
    jx = jpp.normalize(jnp.asarray(x), MEAN, STD, JAX_DT[dtype])
    want = jnp.where(jnp.asarray(mask.astype(bool))[:, None, None, None],
                     jx[:, :, ::-1, :], jx)
    assert got.dtype == TORCH_DT[dtype] and got.shape == x.shape
    _assert_ulp(got.float().numpy(), np.asarray(want, np.float32), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_preprocess_matches_normalize_pallas_interpret(dtype):
    x, mask = _images((4, 16, 16, 3), seed=1)  # H*W*3 % 128 == 0
    scale = 1.0 / (255.0 * jnp.asarray(STD, jnp.float32))
    shift = jnp.asarray(MEAN, jnp.float32) / jnp.asarray(STD, jnp.float32)
    jx = jpp.normalize_pallas(jnp.asarray(x), scale, shift,
                              dtype=JAX_DT[dtype])
    want = jnp.where(jnp.asarray(mask.astype(bool))[:, None, None, None],
                     jx[:, :, ::-1, :], jx)
    got = pp.preprocess(torch.from_numpy(x), MEAN, STD,
                        torch.from_numpy(mask), TORCH_DT[dtype])
    product = x.astype(np.float32) * np.asarray(scale)
    product = np.where(mask.astype(bool)[:, None, None, None],
                       product[:, :, ::-1, :], product)
    _assert_ulp(got.float().numpy(), np.asarray(want, np.float32), dtype,
                slack=0.5 * _ulp(product))


def test_affine_is_float32_arithmetic():
    scale, shift = pp.affine(MEAN, STD)
    np.testing.assert_array_equal(
        scale.numpy(), np.asarray(1.0 / (255.0 * jnp.asarray(STD))))
    np.testing.assert_array_equal(
        shift.numpy(), np.asarray(jnp.asarray(MEAN, jnp.float32)
                                  / jnp.asarray(STD, jnp.float32)))


def test_preprocess_without_mask_is_normalize():
    x, _ = _images((3, 8, 8, 3), seed=2)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(pp.preprocess(t, MEAN, STD).numpy(),
                                  pp.normalize(t, MEAN, STD).numpy())


def _xla_pool(x):
    return jax.lax.reduce_window(x, -jnp.inf, jax.lax.max,
                                 (1, 2, 2, 1), (1, 2, 2, 1), "VALID")


def _tie_inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 3, shape).astype(np.float32)
    out_shape = (shape[0], shape[1] // 2, shape[2] // 2, shape[3])
    g = rng.normal(0, 1, out_shape).astype(np.float32)
    # round through the dtype once so both packages see the same values
    x = np.asarray(jnp.asarray(x, JAX_DT[dtype]), np.float32)
    g = np.asarray(jnp.asarray(g, JAX_DT[dtype]), np.float32)
    return x, g


def _port_pool_and_grad(x, g, dtype):
    xt = torch.from_numpy(x).to(TORCH_DT[dtype]).requires_grad_()
    out = pool.pool2x2(xt)
    (dx,) = torch.autograd.grad(out, xt, torch.from_numpy(g).to(
        TORCH_DT[dtype]))
    return out.detach().float().numpy(), dx.float().numpy()


def _jax_pool_and_grad(fn, x, g, dtype):
    xj = jnp.asarray(x, JAX_DT[dtype])
    out, vjp = jax.vjp(fn, xj)
    (dx,) = vjp(jnp.asarray(g, JAX_DT[dtype]))
    return np.asarray(out, np.float32), np.asarray(dx, np.float32)


@pytest.mark.parametrize("shape", [(2, 8, 8, 64), (2, 16, 16, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_matches_pallas_interpret_and_reduce_window(shape, dtype):
    x, g = _tie_inputs(shape, dtype, seed=sum(shape))
    out, dx = _port_pool_and_grad(x, g, dtype)
    for fn in (pool_pallas.maxpool2x2, _xla_pool):
        want_out, want_dx = _jax_pool_and_grad(fn, x, g, dtype)
        np.testing.assert_array_equal(out, want_out)
        np.testing.assert_array_equal(dx, want_dx)


@pytest.mark.parametrize("shape", [(2, 7, 9, 5), (1, 3, 2, 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_odd_shapes_match_reduce_window(shape, dtype):
    x, g = _tie_inputs(shape, dtype, seed=3)
    out, dx = _port_pool_and_grad(x, g, dtype)
    want_out, want_dx = _jax_pool_and_grad(_xla_pool, x, g, dtype)
    np.testing.assert_array_equal(out, want_out)
    np.testing.assert_array_equal(dx, want_dx)


def test_pool_codes_follow_window_order():
    # one window per case: codes pick the first max in row-major order
    cases = {(1, 1, 1, 1): 0, (0, 1, 1, 1): 1, (0, 0, 1, 1): 2,
             (0, 0, 0, 1): 3, (2, 2, 2, 2): 0, (0, 3, 3, 0): 1}
    for (a, b, d, e), code in cases.items():
        x = torch.tensor([[a, b], [d, e]], dtype=torch.float32)
        val, got = pool.pool_fwd(x.view(1, 2, 2, 1))
        assert int(got) == code and float(val) == max(a, b, d, e)


def _two_pools(w, x1):
    """A scalar function of one sample through two pools."""
    return (pool.pool2x2(pool.pool2x2(x1[None] * w) * w) ** 2).sum()


@pytest.mark.parametrize("in_dim", [0, 1], ids=["leading", "inner"])
def test_vmap_grad_through_pool_equals_a_per_sample_loop(in_dim):
    rng = np.random.default_rng(7)
    x = rng.integers(0, 3, (5, 8, 8, 4)).astype(np.float32)  # ties
    w = rng.normal(0, 1, (4,)).astype(np.float32)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    stacked = xt if in_dim == 0 else xt.movedim(0, 1)
    for argnum in (0, 1):  # gradient wrt the shared weight, wrt the sample
        got = torch.func.vmap(torch.func.grad(_two_pools, argnums=argnum),
                              in_dims=(None, in_dim))(wt, stacked)
        loop = []
        for i in range(x.shape[0]):
            args = [wt.clone(), xt[i].clone()]
            args[argnum].requires_grad_()
            (g,) = torch.autograd.grad(_two_pools(*args), args[argnum])
            loop.append(g)
        assert torch.equal(got, torch.stack(loop))

    def jax_two_pools(w_, x1):
        y = pool_pallas.maxpool2x2(x1[None] * w_) * w_
        return jnp.sum(pool_pallas.maxpool2x2(y) ** 2)

    want = jax.vmap(jax.grad(jax_two_pools), in_axes=(None, 0))(
        jnp.asarray(w), jnp.asarray(x))
    got = torch.func.vmap(torch.func.grad(_two_pools),
                          in_dims=(None, 0))(wt, xt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_vmapped_pool_folds_into_one_batch(monkeypatch):
    """Under vmap the pool pair is called once each, on (V*B, H, W, C)."""
    seen = []
    fwd, bwd = pool.pool_fwd, pool.pool_bwd
    monkeypatch.setattr(pool, "pool_fwd",
                        lambda x: seen.append(("fwd", tuple(x.shape)))
                        or fwd(x))
    monkeypatch.setattr(pool, "pool_bwd",
                        lambda g, c, s: seen.append(("bwd", tuple(s)))
                        or bwd(g, c, s))
    x = torch.randn(6, 2, 4, 4, 3)
    torch.func.vmap(torch.func.grad(lambda x1: pool.pool2x2(x1).sum()))(x)
    assert seen == [("fwd", (12, 4, 4, 3)), ("bwd", (12, 4, 4, 3))]


def test_pool_backward_is_handed_no_zero_tensor_for_the_codes(monkeypatch):
    """The codes are a non-differentiable second output; autograd must not
    fill a zero tensor shaped like them for every backward (on the card
    that is one more device launch per pool and step)."""
    seen = []
    backward = pool.MaxPool2x2.backward
    monkeypatch.setattr(
        pool.MaxPool2x2, "backward",
        staticmethod(lambda ctx, g, g_code: seen.append(g_code)
                     or backward(ctx, g, g_code)))
    x = torch.randn(2, 4, 4, 3, requires_grad=True)
    pool.pool2x2(x).sum().backward()
    assert seen == [None] and x.grad.shape == x.shape


def test_pool_is_differentiable_once():
    x = torch.randn(1, 4, 4, 2, requires_grad=True)
    (dx,) = torch.autograd.grad((pool.pool2x2(x) ** 2).sum(), x,
                                create_graph=True)
    with pytest.raises(NotImplementedError, match="double backward"):
        dx.sum().backward()


def test_cpu_tensors_take_the_plain_versions():
    _kernels.reset_launches()
    x = torch.randn(2, 4, 4, 8, requires_grad=True)
    pool.pool2x2(x).sum().backward()
    pp.preprocess(torch.zeros(2, 4, 4, 3, dtype=torch.uint8), MEAN, STD)
    w = torch.randn(4, 8, 3, 3, requires_grad=True)
    conv.conv2d(x.permute(0, 3, 1, 2), w, None, 1, 1).sum().backward()
    conv.weight_grad(x.detach().permute(0, 3, 1, 2),
                     torch.randn(2, 4, 4, 4), tuple(w.shape), 1, 1)
    assert _kernels.LAUNCHES == {"normalize_flip": 0, "pool_fwd": 0,
                                 "pool_bwd": 0, "conv_wgrad": 0}


@pytest.mark.parametrize("x_shape, dtype, data_ptrs, code_ptr, route", [
    # the main path: C 64 / 128, fresh (256-byte aligned) allocations
    ((200, 64, 64, 64), torch.bfloat16, (256, 512), 1024, "vec"),
    ((200, 8, 8, 128), torch.float32, (256, 512), 1024, "vec"),
    # C a multiple of 4 but not of 8: vec in float32 only
    ((5, 7, 6, 12), torch.float32, (256, 512), 1024, "vec"),
    ((5, 7, 6, 12), torch.bfloat16, (256, 512), 1024, "scalar"),
    ((3, 2, 3, 5), torch.float32, (256, 512), 1024, "scalar"),
    # a data pointer one element past 16 bytes, either one of the two
    ((200, 64, 64, 64), torch.float32, (260, 512), 1024, "scalar"),
    ((200, 64, 64, 64), torch.bfloat16, (256, 514), 1024, "scalar"),
    # the code pointer needs V bytes: 4 (float32), 8 (bfloat16)
    ((200, 64, 64, 64), torch.float32, (256, 512), 1028, "vec"),
    ((200, 64, 64, 64), torch.bfloat16, (256, 512), 1028, "scalar"),
    # a dtype without kernels, and a row past the 32-bit index math
    ((2, 4, 4, 64), torch.float16, (256, 512), 1024, "scalar"),
    ((1, 2, 2 ** 17, 128), torch.float32, (256, 512), 1024, "scalar"),
])
def test_pool_route_is_a_function_of_shape_dtype_and_pointers(
        x_shape, dtype, data_ptrs, code_ptr, route):
    assert pool.pool_route(x_shape, dtype, data_ptrs, code_ptr) == route
