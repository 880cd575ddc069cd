"""Jitted, batched box-constrained quadratic programming.

Replaces the reference's cvxopt cone-QP call (reference:
bayes_drt/inversion.py:1043-1067) with a block-principal-pivoting active-set
solver that is pure XLA: each iteration is one masked K x K linear solve, and
the whole loop is a lax.while_loop, fully vmappable over a batch of spectra
(the batching the reference cannot get from a C QP solver). Solutions are
exact (machine precision) once the active set is identified — typically a
handful of iterations — unlike first-order methods whose accuracy stalls on
the ill-conditioned RBF normal matrices that arise here (cond ~1e7).

minimize    0.5 x^T P x + q^T x   (P symmetric positive definite)
subject to  lb <= x <= ub
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..progcache import precise_matmuls


class QPResult(NamedTuple):
    x: jax.Array
    n_iter: jax.Array
    kkt_violation: jax.Array
    converged: jax.Array
    at_lb: jax.Array = None   # final active sets — feed back as warm_sets
    at_ub: jax.Array = None   # for nearby re-solves (hyper-lambda outer loop)


def _spd_solve(M, rhs):
    """Cholesky solve for a symmetric positive-definite system: every
    system this solver builds is SPD by construction, and Cholesky + two
    triangular solves does half the work of the LU in jnp.linalg.solve."""
    chol = jnp.linalg.cholesky(M)
    y = jax.scipy.linalg.solve_triangular(chol, rhs, lower=True)
    return jax.scipy.linalg.solve_triangular(chol.T, y, lower=False)


def _masked_solve(P, q, at_lb, at_ub, lb, ub):
    """Solve the equality-constrained subproblem: clamped coords pinned at
    their bound, free coords solve P_FF x_F = -(q_F + P_FC x_C)."""
    clamped = jnp.logical_or(at_lb, at_ub)
    bound_val = jnp.where(at_ub, ub, jnp.where(at_lb, lb, 0.0))
    k = P.shape[0]
    eye = jnp.eye(k, dtype=P.dtype)
    # rows of clamped coords -> identity; columns of clamped coords zeroed in
    # free rows (their contribution moves to the rhs). The result is
    # SYMMETRIC (free block = P_FF, clamped block = I, off-blocks = 0) and
    # positive definite, so the Cholesky path applies.
    M = jnp.where(clamped[:, None], eye, P)
    M = jnp.where(jnp.logical_and(~clamped[:, None], clamped[None, :]), 0.0, M)
    rhs = jnp.where(clamped, bound_val, -q - P @ bound_val)
    return _spd_solve(M, rhs)


def qp_cold_sets(P, q, lb, ub):
    """The active set implied by the clipped unconstrained solution — the
    same cold start solve_qp_box uses internally, incl. the Jacobi
    equilibration (the raw f32 Cholesky can NaN at cond ~1e12; the boolean
    sets are invariant to the diagonal scaling since d > 0). For outer
    loops that seed their own warm starts (hyper-lambda / hyper-weights
    ridge): compute the first iteration's sets with THIS, not a raw
    _spd_solve."""
    k = P.shape[0]
    dtype = P.dtype
    lb = jnp.broadcast_to(jnp.asarray(lb, dtype=dtype), (k,))
    ub = jnp.broadcast_to(jnp.asarray(ub, dtype=dtype), (k,))
    diag = jnp.diagonal(P)
    d = jnp.where(diag > jnp.finfo(dtype).tiny, 1.0 / jnp.sqrt(diag), 1.0)
    Ps = d[:, None] * P * d[None, :]
    Ps = 0.5 * (Ps + Ps.T)
    if dtype == jnp.float32:
        Ps = Ps + (100.0 * jnp.finfo(dtype).eps) * jnp.eye(k, dtype=dtype)
    x0 = jnp.nan_to_num(_spd_solve(Ps, -(d * q)))
    return x0 < lb / d, x0 > ub / d


@partial(jax.jit, static_argnames=("max_iter",))
@precise_matmuls
def solve_qp_box(P, q, lb, ub, max_iter: int = 100, tol: float = 1e-10,
                 warm_sets=None) -> QPResult:
    """Block principal pivoting for the box-constrained QP.

    Murty's single-exchange safeguard kicks in when the violation count fails
    to decrease, guaranteeing finite termination.

    ``warm_sets``: optional (at_lb, at_ub) boolean arrays seeding the
    active set (e.g. the previous outer iteration's solution in the
    hyper-lambda loop) — a nearby warm start converges in 1-3 pivots
    instead of the cold start's ~14.
    """
    k = P.shape[0]
    dtype = P.dtype
    q = q.astype(dtype)
    lb = jnp.broadcast_to(jnp.asarray(lb, dtype=dtype), (k,))
    ub = jnp.broadcast_to(jnp.asarray(ub, dtype=dtype), (k,))

    # Jacobi equilibration: solve in x = d*y coordinates where P has unit
    # diagonal. The normal matrices this solver sees mix columns of wildly
    # different scale (e.g. the inductance column times modulus weights on a
    # wide-dynamic-range spectrum puts cond(P) ~ 1e12+, which NaNs the f32
    # Cholesky outright — found driving real PDAC instrument data). Scaling
    # is exact for the active-set logic (bounds scale by 1/d, gradients by
    # d, boolean sets unchanged); kkt_violation is reported in the ORIGINAL
    # coordinates.
    diag = jnp.diagonal(P)
    d = jnp.where(diag > jnp.finfo(dtype).tiny, 1.0 / jnp.sqrt(diag), 1.0)
    P_orig, q_orig = P, q
    P = d[:, None] * P * d[None, :]
    P = 0.5 * (P + P.T)                 # GEMM accumulation breaks symmetry
    machine = jnp.finfo(dtype).eps
    if dtype == jnp.float32:
        # f32 GEMM roundoff leaves the equilibrated matrix numerically
        # indefinite when cond exceeds ~1/eps_f32 (the PDAC spectrum hits
        # cond ~6e7); a 100*eps unit-diagonal jitter restores positive
        # definiteness while perturbing the solution below f32 solve
        # accuracy. f64 stays exact.
        P = P + (100.0 * machine) * jnp.eye(k, dtype=dtype)
    q = d * q
    lb = lb / d
    ub = ub / d

    scale = jnp.maximum(jnp.max(jnp.abs(q)), 1.0)
    # floor the tolerance at the dtype's resolution: the float64 default
    # (1e-10) is UNREACHABLE in float32 — the violation count then never
    # hits zero and the loop burns its whole max_iter budget (a
    # 14-iteration solve ran 2000 iterations)
    tol_eff = jnp.maximum(jnp.asarray(tol, dtype), 50.0 * machine)
    tol_p = tol_eff
    tol_d = tol_eff * scale

    def body(state):
        at_lb, at_ub, _, it, prev_nviol, _ = state
        x = _masked_solve(P, q, at_lb, at_ub, lb, ub)
        g = P @ x + q

        viol_f_lb = (~at_lb) & (~at_ub) & (x < lb - tol_p)
        viol_f_ub = (~at_lb) & (~at_ub) & (x > ub + tol_p)
        viol_lb = at_lb & (g < -tol_d)
        viol_ub = at_ub & (g > tol_d)
        any_viol = viol_f_lb | viol_f_ub | viol_lb | viol_ub
        nviol = jnp.sum(any_viol).astype(jnp.int32)

        # full exchange
        full_lb = (at_lb & ~viol_lb) | viol_f_lb
        full_ub = (at_ub & ~viol_ub) | viol_f_ub

        # Murty safeguard: flip only the highest-index violation
        idx = jnp.arange(k)
        top = jnp.max(jnp.where(any_viol, idx, -1))
        one_hot = idx == top
        single_lb = jnp.where(one_hot, (at_lb & ~viol_lb) | viol_f_lb, at_lb)
        single_ub = jnp.where(one_hot, (at_ub & ~viol_ub) | viol_f_ub, at_ub)

        use_full = nviol < prev_nviol
        new_lb = jnp.where(use_full, full_lb, single_lb)
        new_ub = jnp.where(use_full, full_ub, single_ub)
        done = nviol == 0
        return (new_lb, new_ub, x, it + 1,
                jnp.where(use_full, nviol, prev_nviol), done)

    def cond(state):
        _, _, _, it, _, done = state
        return jnp.logical_and(it < max_iter, ~done)

    if warm_sets is not None:
        at_lb0, at_ub0 = warm_sets
        x_init = jnp.zeros((k,), dtype)
    else:
        # start from the active set implied by the clipped unconstrained
        # solution
        x0 = _spd_solve(P, -q)
        at_lb0 = x0 < lb
        at_ub0 = x0 > ub
        x_init = jnp.clip(x0, lb, ub)
    init = (at_lb0, at_ub0, x_init, jnp.asarray(0, jnp.int32),
            jnp.asarray(k + 1, jnp.int32), jnp.asarray(False))
    at_lb, at_ub, x, it, _, done = jax.lax.while_loop(cond, body, init)

    free = (x > lb + tol_p) & (x < ub - tol_p)
    x = jnp.clip(x, lb, ub) * d            # back to original coordinates
    g = P_orig @ x + q_orig
    kkt = jnp.max(jnp.where(free, jnp.abs(g), 0.0))
    return QPResult(x=x, n_iter=it, kkt_violation=kkt, converged=done,
                    at_lb=at_lb, at_ub=at_ub)


def solve_nnls(P, q, max_iter: int = 100, tol: float = 1e-10) -> QPResult:
    """Non-negative QP: lb=0, ub=inf (reference nonneg=True path,
    inversion.py:1055-1057)."""
    k = P.shape[0]
    inf = jnp.asarray(jnp.inf, dtype=P.dtype)
    return solve_qp_box(P, q, jnp.zeros((k,), P.dtype), jnp.full((k,), inf),
                        max_iter=max_iter, tol=tol)


solve_qp_box_batch = jax.vmap(solve_qp_box, in_axes=(0, 0, None, None))
