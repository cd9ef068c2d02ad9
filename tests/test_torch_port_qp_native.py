"""clsurvey_torch's ``ops/qp_native.py`` against clsurvey_tpu's on the CPU.

- ``solve_bound_qp`` and ``gem_project`` bit-equal to the JAX package's
  binding of the same ``native/qp.cpp`` at t in {1, 2, 4, 8}, on problems
  made by numpy from a seed (the shapes of ``tests/test_qp.py``);
- the library is built under ``clsurvey_torch/_build/`` and nothing new
  appears in ``native/``;
- where the build fails (``CXX=false``, or a compiler that prints an error),
  ``available()`` is False and a solve raises a ``RuntimeError`` that holds
  the compiler's command and output;
- arrays that do not make one problem are refused before any pointer is
  passed."""

import os

import numpy as np
import pytest

from clsurvey_torch.ops import qp_native as tqn
from clsurvey_torch.utils import native
from clsurvey_tpu.ops import qp_native as jqn


def _problem(rng, t, p=50, margin=0.5):
    M = rng.normal(0, 1, (t, p))
    g = rng.normal(0, 1, p)
    P = M @ M.T
    P = 0.5 * (P + P.T) + np.eye(t) * 1e-3
    return M, g, P, M @ g, np.full(t, margin)


@pytest.mark.parametrize("t", [1, 2, 4, 8])
def test_bit_equal_to_the_jax_packages_binding(t):
    assert jqn.available() and tqn.available()
    rng = np.random.default_rng(t)
    for _ in range(5):
        M, g, P, q, lb = _problem(rng, t)
        got = tqn.solve_bound_qp(P, q, lb)
        want = jqn.solve_bound_qp(P, q, lb)
        assert got.dtype == np.float64 and got.shape == (t,)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tqn.solve_bound_qp(P, q, lb, 3),
                                      jqn.solve_bound_qp(P, q, lb, 3))
        M[0] = -g + rng.normal(0, 0.1, g.shape)  # at least one violation
        for margin in (0.0, 1.0):
            np.testing.assert_array_equal(tqn.gem_project(M, g, margin),
                                          jqn.gem_project(M, g, margin))
        np.testing.assert_array_equal(tqn.gem_project(M, g, 0.5, eps=1e-2),
                                      jqn.gem_project(M, g, 0.5, eps=1e-2))


def test_builds_under_the_ports_build_dir_and_not_in_native():
    assert jqn.available()  # the JAX package builds native/ in place
    before = sorted(os.listdir(native.NATIVE_DIR))
    path = native.library_path(tqn.SOURCE, tqn.CXX_FLAGS, "clsurvey_qp")
    assert os.path.dirname(path) == native.BUILD_DIR
    assert native.BUILD_DIR == os.path.join(native.REPO, "clsurvey_torch",
                                            "_build")
    assert tqn.available() and os.path.isfile(path)
    assert sorted(os.listdir(native.NATIVE_DIR)) == before


@pytest.fixture()
def unbuilt(tmp_path, monkeypatch):
    """A fresh build directory and a module that has not tried to load."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tqn, "_LIB", None)
    monkeypatch.setattr(tqn, "_BUILD_ERROR", None)
    return tmp_path


def _failing_compiler(tmp_path):
    path = tmp_path / "cxx"
    path.write_text("#!/bin/sh\necho 'qp.cpp:1: error: no compiler here' "
                    ">&2\nexit 3\n")
    path.chmod(0o755)
    return str(path), "exited 3", "no compiler here"


@pytest.mark.parametrize("compiler", ["false", "printing"])
def test_a_failed_build_raises_with_the_compilers_output(unbuilt,
                                                         monkeypatch,
                                                         compiler):
    if compiler == "false":
        cxx, code, said = "false", "exited 1", "false -O3 -fPIC"
    else:
        cxx, code, said = _failing_compiler(unbuilt)
    monkeypatch.setenv("CXX", cxx)
    assert not tqn.available()
    M, g, P, q, lb = _problem(np.random.default_rng(0), 2)
    for call in (lambda: tqn.solve_bound_qp(P, q, lb),
                 lambda: tqn.gem_project(M, g, 0.5)):
        with pytest.raises(RuntimeError) as err:
            call()
        assert "native QP library unavailable" in str(err.value)
        assert code in str(err.value) and said in str(err.value)
        assert tqn.SOURCE in str(err.value)
    assert not os.listdir(unbuilt / "build")  # no partial library left


def test_mismatched_arrays_are_refused():
    M, g, P, q, lb = _problem(np.random.default_rng(1), 3)
    with pytest.raises(ValueError, match="one problem"):
        tqn.solve_bound_qp(P[:2, :2], q, lb)
    with pytest.raises(ValueError, match="one problem"):
        tqn.solve_bound_qp(P, q, lb[:2])
    with pytest.raises(ValueError, match="memory"):
        tqn.gem_project(M, g[:-1], 0.5)
