"""GEM's dual QP, solved on the tensors' device.

Counterpart of ``clsurvey_tpu/ops/qp.py``. The reference calls the
``quadprog`` C extension per violating batch
(ref:src/methods/rehearsal/model/gem.py:58-80 ``project2cone2``): with
memory-gradient matrix M (t x p) and proposed gradient g,

    P = M M^T (symmetrized) + eps*I,  q = -(M g),  solve
    min_v  1/2 v^T P v - q^T v   s.t.  v >= margin        (bounds only)
    projected gradient: x = M^T v + g

The constraints are simple bounds, so a primal-dual active-set method
(PDAS) reaches the exact solution: free variables solve the reduced
system, clamped ones sit at the bound, and the active set updates from the
KKT residuals. As in the JAX package the iteration count is fixed (3t+24)
and each solve is masked rather than reduced, so the whole solve is a
fixed sequence of t x t device ops with no host round trip: the system is
solved with ``torch.linalg.solve_ex``, which does not read its error code
back, and the projection is selected with ``torch.where`` instead of a
branch on the host. Everything runs in the caller's dtype (float32 on the
training path, float64 in the tests)."""

from __future__ import annotations

import torch

GEM_EPS = 1e-3  # ref:gem.py:58 eps=1e-3 added to the diagonal


def solve_bound_qp(P: torch.Tensor, q: torch.Tensor, lb: torch.Tensor,
                   iters: int = 0) -> torch.Tensor:
    """min 1/2 v'Pv - q'v  s.t. v >= lb, via PDAS with masked solves.

    Returns the clamped primal-feasible ``v``. ``iters`` defaults to
    3t+24, the JAX package's count: PDAS typically converges in <= t
    active-set changes, and the extra iterations guard the rare cycling
    active set on near-degenerate gradients."""
    t = P.shape[0]
    if iters == 0:
        iters = 3 * t + 24

    def masked_solve(active):
        free = 1.0 - active
        # system: P_FF v_F = q_F - P_FA lb_A ; v_A = lb_A
        M = P * (free[:, None] * free[None, :]) + torch.diag(active)
        rhs = free * (q - P @ (lb * active)) + active * lb
        return torch.linalg.solve_ex(M, rhs)[0]

    active = torch.zeros(t, dtype=P.dtype, device=P.device)
    for _ in range(iters):
        v = masked_solve(active)
        mu = P @ v - q  # multiplier estimate; ~0 on free vars
        # PDAS update: active where (lb - v) + mu > 0
        active = ((lb - v) + mu > 0.0).to(P.dtype)
    return torch.maximum(masked_solve(active), lb)  # safeguard clamp


def gem_project(grad_flat: torch.Tensor, mem_grads: torch.Tensor,
                margin) -> torch.Tensor:
    """ref ``project2cone2``: the projected gradient x = M^T v + g.

    grad_flat: (p,) current-task gradient
    mem_grads: (t, p) past-task memory gradients
    margin:    scalar (GEM's decayed hyperparameter), number or tensor"""
    M, g = mem_grads, grad_flat.to(mem_grads.dtype)
    t = M.shape[0]
    P = M @ M.T
    P = 0.5 * (P + P.T) + torch.eye(t, dtype=P.dtype,
                                    device=P.device) * GEM_EPS
    # quadprog minimizes 1/2 v'Pv - a'v with a = -(M g) in the reference
    # call (ref:gem.py:76 ``q = np.dot(memories_np, gradient_np) * -1``)
    q = -(M @ g)
    lb = torch.ones(t, dtype=P.dtype, device=P.device) * margin
    return M.T @ solve_bound_qp(P, q, lb) + g


def gem_project_if_violating(grad_flat: torch.Tensor,
                             mem_grads: torch.Tensor, margin):
    """Project only when any <g, g_mem> < 0 (ref:gem.py:275-283). Both
    results are computed and one is selected on the device; returns
    (gradient, violated as a 0-d bool tensor)."""
    violates = (mem_grads @ grad_flat < 0).any()
    projected = gem_project(grad_flat, mem_grads, margin)
    return torch.where(violates, projected,
                       grad_flat.to(projected.dtype)), violates
