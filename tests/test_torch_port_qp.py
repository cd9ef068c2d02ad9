"""clsurvey_torch's GEM QP against clsurvey_tpu's on the CPU (numpy-made
problems, the shapes of ``tests/test_qp.py``):

- ``solve_bound_qp`` in float32 against the JAX package's at t in {1, 2, 4,
  8}: rtol and atol 2e-3 (both are float32 PDAS runs of 3t+24 masked
  solves; the float32 solves round differently);
- ``gem_project`` in float64 against the native C++ golden reference
  (``clsurvey_tpu.ops.qp_native``): within 1e-8, and the projected
  gradient agrees with every memory gradient;
- ``gem_project_if_violating``: an agreeing gradient comes back unchanged
  bit for bit with ``violated`` False, a violating one is projected, with
  no host read-back in between (0-d tensor flag)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clsurvey_torch.ops import qp as tqp
from clsurvey_tpu.ops import qp as jqp, qp_native


def _random_problem(rng, t, p=50, margin=0.5):
    M = rng.normal(0, 1, (t, p))
    g = rng.normal(0, 1, p)
    P = M @ M.T
    P = 0.5 * (P + P.T) + np.eye(t) * 1e-3
    q = M @ g
    return M, g, P, q, np.full(t, margin)


@pytest.mark.parametrize("t", [1, 2, 4, 8])
def test_float32_solve_matches_the_jax_solver(t):
    rng = np.random.default_rng(t)
    for _ in range(5):
        _, _, P, q, lb = _random_problem(rng, t)
        want = np.asarray(jqp.solve_bound_qp(
            jnp.asarray(P, jnp.float32), jnp.asarray(q, jnp.float32),
            jnp.asarray(lb, jnp.float32)))
        got = tqp.solve_bound_qp(*(torch.tensor(a, dtype=torch.float32)
                                   for a in (P, q, lb)))
        assert got.dtype == torch.float32 and (got >= 0.5).all()
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("t", [1, 2, 4, 8])
def test_float64_projection_matches_the_native_reference(t):
    assert qp_native.available()
    rng = np.random.default_rng(100 + t)
    M, g, *_ = _random_problem(rng, t, p=200, margin=1.0)
    M[0] = -g + rng.normal(0, 0.1, g.shape)  # at least one violation
    want = qp_native.gem_project(M, g, margin=1.0)
    got = tqp.gem_project(torch.tensor(g), torch.tensor(M), 1.0)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=1e-8)
    # every memory agrees now, up to the eps*v the diagonal adds
    assert (M @ got.numpy() >= -1e-2).all()


def test_project_only_when_violating():
    rng = np.random.default_rng(1)
    g = rng.normal(0, 1, 50)
    agree = np.stack([g + rng.normal(0, 0.01, 50) for _ in range(3)])
    x, violated = tqp.gem_project_if_violating(
        torch.tensor(g, dtype=torch.float32),
        torch.tensor(agree, dtype=torch.float32), torch.tensor(0.5))
    assert violated.shape == () and not bool(violated)
    assert torch.equal(x, torch.tensor(g, dtype=torch.float32))

    M = agree.copy()
    M[0] = -g + rng.normal(0, 0.1, g.shape)
    x, violated = tqp.gem_project_if_violating(
        torch.tensor(g, dtype=torch.float32),
        torch.tensor(M, dtype=torch.float32), torch.tensor(0.5))
    want, want_flag = jqp.gem_project_if_violating(
        jnp.asarray(g, jnp.float32), jnp.asarray(M, jnp.float32),
        jnp.float32(0.5))
    assert bool(violated) and bool(want_flag)
    np.testing.assert_allclose(x.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)
    assert (M @ x.numpy().astype(np.float64) >= -1e-2).all()
