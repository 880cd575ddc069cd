"""Ridge / hyperparametric ridge engines (functional JAX core).

Re-implements the reference's ridge machinery (reference:
bayes_drt/inversion.py:142-1067) as pure, jittable functions:

- ordinary ridge: one box-QP solve
- Ciucci–Chen hierarchical ("hyper-lambda") ridge: analytic per-coordinate
  lambda updates (reference: inversion.py:947-983) iterated in a
  lax.while_loop around the ADMM QP solver
- Effat–Ciucci outlier-robust ("hyper-weights") ridge: MAP weight updates
  (reference: inversion.py:1010-1041)

All matrix augmentation (R_inf / inductance columns for series
distributions) happens at the API layer; these functions see the final
(N, K) design matrices. Everything here is vmappable over a batch of
spectra — the batched replacement for the reference's one-QP-at-a-time cvxopt
loop.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..progcache import precise_matmuls

from .nnls import _spd_solve, qp_cold_sets, solve_qp_box


class RidgeData(NamedTuple):
    """Numeric inputs to a ridge solve (pytree; leaves may be batched)."""
    WA_re: jax.Array   # (N, K) weighted real design
    WA_im: jax.Array   # (N, K) weighted imag design
    WT_re: jax.Array   # (N,) weighted real target
    WT_im: jax.Array   # (N,) weighted imag target
    L2_base: jax.Array  # (3, K, K): discrete L^T L or integral M per order
    L_ops: jax.Array    # (3, KL, K): raw L matrices (discrete lambda updates)
    L1_vec: jax.Array   # (K,)
    reg_frac: jax.Array  # (3,) weights over 0th/1st/2nd derivative penalties
    lb: jax.Array       # (K,) lower bounds
    ub: jax.Array       # (K,) upper bounds


def assemble_qp(part: str, data: RidgeData, L2_mat):
    """P, q of the quadratic objective (reference: inversion.py:1043-1052)."""
    if part == "both":
        P = data.WA_re.T @ data.WA_re + data.WA_im.T @ data.WA_im + L2_mat
        q = -data.WA_re.T @ data.WT_re - data.WA_im.T @ data.WT_im + data.L1_vec
    elif part == "real":
        P = data.WA_re.T @ data.WA_re + L2_mat
        q = -data.WA_re.T @ data.WT_re + data.L1_vec
    elif part == "imag":
        P = data.WA_im.T @ data.WA_im + L2_mat
        q = -data.WA_im.T @ data.WT_im + data.L1_vec
    else:
        raise ValueError(f"Invalid part {part!r}")
    # a coordinate absent from both the design (zero column — e.g. the
    # R_inf column in an imag-only part fit) and the penalty has a zero
    # diagonal: the system is singular and a factorization solve would
    # poison every coordinate with NaNs (the reference's cvxopt returned
    # garbage there and its post-step overwrote it, inversion.py:854-873).
    # Pin such coordinates to 0 instead.
    dead = jnp.diagonal(P) == 0.0
    P = P + jnp.diag(dead.astype(P.dtype))
    q = jnp.where(dead, 0.0, q)
    return P, q


def build_l2_matrix(data: RidgeData, lam_vectors, dZ_re):
    """L2_mat = sum_n frac_n * D lam_n^(1/2) L2b_n lam_n^(1/2) D with
    D = diag(1/dZ_re) (reference: inversion.py:696-700)."""
    scale = jnp.sqrt(lam_vectors) / dZ_re[None, :]  # (3, K)
    terms = scale[:, :, None] * data.L2_base * scale[:, None, :]
    return jnp.einsum("n,nij->ij", data.reg_frac, terms)


# --- analytic lambda updates -------------------------------------------------

def hyper_lambda_discrete(L, coef, hl_beta, lambda_0):
    """lam = 1 / ((Lx)^2/(beta-1) + 1/lambda_0)
    (reference: inversion.py:947-954). Returns length-KL vector."""
    Lx2 = (L @ coef) ** 2
    return 1.0 / (Lx2 / (hl_beta - 1.0) + 1.0 / lambda_0)


def hyper_lambda_fbeta(L, coef, hl_fbeta, lambda_0):
    """lam = lambda_0 / ((Lx)^2/(max (Lx)^2 * f_beta) + 1)
    (reference: inversion.py:956-964)."""
    Lx2 = (L @ coef) ** 2
    return lambda_0 / (Lx2 / (jnp.max(Lx2) * hl_fbeta) + 1.0)


def hyper_lambda_integral(M, coef, lam_vec, hl_beta, lambda_0):
    """Quadratic-root lambda update for the integral penalty
    (reference: inversion.py:973-983). hl_beta/lambda_0 are per-coordinate."""
    sl_coef = jnp.sqrt(lam_vec) * coef
    s = M @ sl_coef - jnp.diagonal(M) * sl_coef
    C = coef * s
    a = hl_beta / 2.0
    b = 0.5 * (2.0 * a - 2.0) / lambda_0
    d = coef**2 * jnp.diagonal(M) + 2.0 * b
    disc = jnp.sqrt(4.0 * d * (2.0 * a - 2.0) + C**2)
    lam = (C**2 - jnp.sign(C) * C * disc + 2.0 * d * (2.0 * a - 2.0)) / (2.0 * d**2)
    return lam


def hyper_lambda_lm(L, coef, prev_lam, hl_beta, lambda_0, n_iter: int = 40):
    """Levenberg-Marquardt-style lambda solution: per-coordinate minimization
    of (a*lam - c*ln(lam))^2 with a = (Lx)^2 + (beta-1)/lambda_0 and
    c = beta - 1, started from the previous lambda (reference:
    inversion.py:650-670 — scipy least_squares with diagonal Jacobian).
    Damped Newton in u = ln(lam); coordinates are independent so the solve
    vectorizes exactly."""
    Lx2 = (L @ coef) ** 2
    zeta = (hl_beta - 1.0) / lambda_0
    a = Lx2 + zeta
    c = hl_beta - 1.0

    def body(_, u):
        g = a * jnp.exp(u) - c * u          # residual f(e^u)
        dg = a * jnp.exp(u) - c             # df/du
        hess = dg * dg + g * a * jnp.exp(u)
        step = g * dg / (jnp.abs(hess) + 1e-12)
        return u - jnp.clip(step, -2.0, 2.0)

    u0 = jnp.log(jnp.clip(prev_lam, 1e-15, None))
    u = jax.lax.fori_loop(0, n_iter, body, u0)
    return jnp.exp(u)


def hyper_b_update(lam_vec, a, sb, n_basis):
    """MAP update of the gamma-prior rate b with b ~ N(0, sb)
    (reference: inversion.py:985-990)."""
    lam_sum = jnp.sum(lam_vec)
    b = 0.25 * (jnp.sqrt(16.0 * a * n_basis * sb**2 + 4.0 * sb**4 * lam_sum**2)
                - 2.0 * lam_sum * sb**2)
    return jnp.clip(b, 1e-8, None)


def hyper_a_update(lam_vec, b, alpha_a, beta_a, n_iter: int = 60):
    """MAP update of the gamma-prior shape a by golden-section search of the
    scalar objective on (1, 5) (reference: inversion.py:992-1008)."""
    def obj(a):
        return (-2.0 * a * jnp.sum(jnp.log(b * lam_vec))
                + 2.0 * jax.scipy.special.gammaln(a)
                + 2.0 * beta_a * (a - 1.0)
                - 2.0 * (alpha_a - 1.0) * jnp.log(a - 1.0))

    gr = (jnp.sqrt(5.0) - 1.0) / 2.0
    lo0, hi0 = 1.0 + 1e-9, 5.0

    def body(_, state):
        lo, hi = state
        c = hi - gr * (hi - lo)
        d = lo + gr * (hi - lo)
        go_left = obj(c) < obj(d)
        return (jnp.where(go_left, lo, c), jnp.where(go_left, d, hi))

    lo, hi = jax.lax.fori_loop(0, n_iter, body, (jnp.asarray(lo0), jnp.asarray(hi0)))
    return (lo + hi) / 2.0


def hyper_weights_update(coef, A_re, A_im, T_re, T_im, hw_beta, wbar_re, wbar_im):
    """MAP weight update w = (wbar - 1/zeta)/(r^2/zeta + 1), zeta = beta/wbar
    (reference: inversion.py:1010-1041)."""
    zeta_re = hw_beta / wbar_re
    zeta_im = hw_beta / wbar_im
    r_re = T_re - A_re @ coef
    r_im = T_im - A_im @ coef
    w_re = (wbar_re - 1.0 / zeta_re) / (r_re**2 / zeta_re + 1.0)
    w_im = (wbar_im - 1.0 / zeta_im) / (r_im**2 / zeta_im + 1.0)
    return w_re, w_im


# --- drivers -----------------------------------------------------------------

class HyperLambdaConfig(NamedTuple):
    """Static configuration for the hyper-lambda iteration."""
    part: str = "both"
    penalty: str = "discrete"       # 'discrete' | 'integral' ('cholesky' uses 'discrete' updates)
    use_fbeta: bool = False
    use_lm: bool = False            # LM lambda solution (hl_solution='lm')
    n_fixed: int = 0                # leading coords excluded from lambda updates (series: 2)
    max_iter: int = 20
    use_dZ: bool = False
    use_hyper_a: bool = False
    use_hyper_b: bool = False
    qp_iter: int = 2000


class HyperLambdaState(NamedTuple):
    coef: jax.Array
    lam_vectors: jax.Array   # (3, K)
    hyper_as: jax.Array      # (3, K)
    hyper_bs: jax.Array      # (3, K)
    dZ_re: jax.Array         # (K,)
    it: jax.Array
    delta: jax.Array
    at_lb: jax.Array = None  # QP active sets carried across outer
    at_ub: jax.Array = None  # iterations (warm-started re-solves)


class RidgeResult(NamedTuple):
    coef: jax.Array
    lam_vectors: jax.Array
    cost: jax.Array
    n_iter: jax.Array
    converged: jax.Array
    weights_re: jax.Array
    weights_im: jax.Array


def _lambda_step(cfg: HyperLambdaConfig, data: RidgeData, state: HyperLambdaState,
                 hl_fbeta, lambda_0_scalar):
    """One analytic lambda update for all three orders
    (reference: inversion.py:631-691)."""
    coef_eff = state.coef / state.dZ_re
    ab_updated = jnp.logical_and(state.it > 0,
                                 cfg.use_hyper_a or cfg.use_hyper_b)
    hyper_lam0 = _lambda0_from_ab(cfg, state.hyper_as, state.hyper_bs,
                                  ab_updated)
    hyper_beta = 2.0 * state.hyper_as

    def per_order(n, lam_prev):
        if cfg.penalty == "integral":
            # plain Python float (weak-typed): a jnp.asarray literal here is
            # strong float64 under x64 and silently promotes the whole
            # while_loop carry when the caller requested float32
            factor = (100.0, 10.0, 1.0)[n]
            lv = hyper_lambda_integral(data.L2_base[n], factor * coef_eff,
                                       lam_prev, hyper_beta[n], hyper_lam0[n])
            return jnp.clip(lv, 1e-15, None)
        if cfg.use_fbeta:
            lv = hyper_lambda_fbeta(data.L_ops[n], coef_eff, hl_fbeta, lambda_0_scalar)
        elif cfg.use_lm:
            # the reference's LM branch uses the raw coefficients, without
            # the dZ division applied by the analytic branches
            # (inversion.py:650-670)
            lv = hyper_lambda_lm(data.L_ops[n], state.coef,
                                 lam_prev[cfg.n_fixed:],
                                 hyper_beta[n, cfg.n_fixed:],
                                 lambda_0_scalar)
        else:
            lv = hyper_lambda_discrete(data.L_ops[n], coef_eff,
                                       hyper_beta[n, cfg.n_fixed:],
                                       hyper_lam0[n, cfg.n_fixed:])
        # fixed leading coords (R_inf, inductance) keep lambda = 1
        if cfg.n_fixed > 0:
            lv = jnp.concatenate([jnp.ones((cfg.n_fixed,), lv.dtype), lv])
        return lv

    lam_new = jnp.stack([
        jnp.where(data.reg_frac[n] > 0, per_order(n, state.lam_vectors[n]),
                  state.lam_vectors[n])
        for n in range(3)
    ])
    return lam_new


def _lambda0_from_ab(cfg: HyperLambdaConfig, hyper_as, hyper_bs, ab_updated):
    """lambda_0 implied by the gamma hyperprior shape/rate.

    The reference initializes hyper_lambda0s with a factor-of-two halving
    ((2a-2)/(2b) integral, (2a-1)/(2b) discrete; inversion.py:466-475) but
    RECOMPUTES it as (2a-2)/b inside the hyper_a/hyper_b update blocks
    (inversion.py:550, 561) — we reproduce both regimes."""
    if cfg.penalty == "integral":
        init = (2.0 * hyper_as - 2.0) / (2.0 * hyper_bs)
    else:
        init = (2.0 * hyper_as - 1.0) / (2.0 * hyper_bs)
    updated = (2.0 * hyper_as - 2.0) / hyper_bs
    return jnp.where(ab_updated, updated, init)


@partial(jax.jit, static_argnames=("cfg",))
@precise_matmuls
def run_hyper_lambda(cfg: HyperLambdaConfig, data: RidgeData, x0,
                     hl_beta, lambda_0, hl_fbeta=0.1,
                     sb=None, alpha_a=None, beta_a=None,
                     B=None, dZ_scale=1.0, dZ_power=0.5,
                     xtol=1e-3, delta_mask=None) -> RidgeResult:
    """Hierarchical-ridge fixed point iteration
    (reference loop: inversion.py:489-753).

    hl_beta: (3,) per-order beta hyperparameters.
    lambda_0: scalar baseline regularization strength.
    B: optional (KB, K) dZ'/dlntau differentiation matrix for dZ weighting.
    delta_mask: (K,) multiplier on the relative coefficient change used for
        the convergence check (zero out the inductance column when unused).
    """
    k = data.WA_re.shape[1]
    dtype = data.WA_re.dtype
    hl_beta = jnp.broadcast_to(jnp.asarray(hl_beta, dtype), (3,))
    a_list = hl_beta / 2.0
    if cfg.penalty == "integral":
        b_list = 0.5 * (2.0 * a_list - 2.0) / lambda_0
    else:
        b_list = 0.5 * (2.0 * a_list - 1.0) / lambda_0
    hyper_as = jnp.broadcast_to(a_list[:, None], (3, k)).astype(dtype)
    hyper_bs = jnp.broadcast_to(b_list[:, None], (3, k)).astype(dtype)

    sb = jnp.broadcast_to(jnp.asarray(1.0 if sb is None else sb, dtype), (3,))
    alpha_a = jnp.broadcast_to(jnp.asarray(2.0 if alpha_a is None else alpha_a, dtype), (3,))
    beta_a = jnp.broadcast_to(jnp.asarray(2.0 if beta_a is None else beta_a, dtype), (3,))
    if delta_mask is None:
        delta_mask = jnp.ones((k,), dtype)
    n_basis = k - cfg.n_fixed

    state0 = HyperLambdaState(
        coef=jnp.asarray(x0, dtype),
        lam_vectors=jnp.full((3, k), lambda_0, dtype),
        hyper_as=hyper_as,
        hyper_bs=hyper_bs,
        dZ_re=jnp.ones((k,), dtype),
        it=jnp.asarray(0, jnp.int32),
        delta=jnp.asarray(jnp.inf, dtype),
        at_lb=jnp.zeros((k,), bool),
        at_ub=jnp.zeros((k,), bool),
    )

    def body(state):
        prev_coef = state.coef
        dZ_re = state.dZ_re
        if cfg.use_dZ:
            # B is (K - n_fixed, K): dZ'/dlntau at each basis tau
            # (reference: inversion.py:531-539)
            tail = jnp.abs((B @ prev_coef) / dZ_scale) ** dZ_power
            new_dZ = jnp.concatenate([jnp.ones((cfg.n_fixed,), dtype),
                                      jnp.clip(tail, 1e-8, None)])
            dZ_re = jnp.where(state.it > 0, new_dZ, dZ_re)

        h_bs, h_as = state.hyper_bs, state.hyper_as
        if cfg.use_hyper_b:
            new_bs = jnp.stack([
                jnp.broadcast_to(hyper_b_update(state.lam_vectors[n], h_as[n, 0],
                                                sb[n], n_basis), (k,))
                for n in range(3)])
            h_bs = jnp.where(state.it > 0, new_bs, h_bs)
        if cfg.use_hyper_a:
            new_as = jnp.stack([
                jnp.broadcast_to(hyper_a_update(state.lam_vectors[n], h_bs[n, 0],
                                                alpha_a[n], beta_a[n]), (k,))
                for n in range(3)])
            h_as = jnp.where(state.it > 0, new_as, h_as)

        state = state._replace(dZ_re=dZ_re, hyper_as=h_as, hyper_bs=h_bs)
        lam_new = _lambda_step(cfg, data, state, hl_fbeta, lambda_0)
        L2_mat = build_l2_matrix(data, lam_new, dZ_re)
        P, q = assemble_qp(cfg.part, data, L2_mat)
        # warm-start the QP with the previous outer iteration's active set:
        # lambda moves slowly between iterations, so the re-solve typically
        # pivots 1-3 times instead of the cold start's ~14. The first outer
        # iteration falls back to the cold (unconstrained-clip) sets,
        # computed with solve_qp_box's own equilibration (a raw f32
        # Cholesky NaNs at high cond) and only when actually needed.
        warm = jax.lax.cond(
            state.it > 0,
            lambda: (state.at_lb, state.at_ub),
            lambda: qp_cold_sets(P, q, data.lb, data.ub))
        res_qp = solve_qp_box(P, q, data.lb, data.ub, max_iter=cfg.qp_iter,
                              warm_sets=warm)
        coef = res_qp.x
        safe_prev = jnp.where(jnp.abs(prev_coef) > 0, prev_coef, 1.0)
        delta = jnp.mean(jnp.abs((coef - prev_coef) / safe_prev * delta_mask))
        return HyperLambdaState(coef, lam_new, h_as, h_bs, dZ_re,
                                state.it + 1, delta,
                                res_qp.at_lb, res_qp.at_ub)

    def cond(state):
        return jnp.logical_and(state.it < cfg.max_iter, state.delta >= xtol)

    state = jax.lax.while_loop(cond, body, state0)

    L2_mat = build_l2_matrix(data, state.lam_vectors, state.dZ_re)
    P, q = assemble_qp(cfg.part, data, L2_mat)
    cost = 0.5 * state.coef @ (P @ state.coef) + q @ state.coef
    return RidgeResult(coef=state.coef, lam_vectors=state.lam_vectors, cost=cost,
                       n_iter=state.it, converged=state.delta < xtol,
                       weights_re=jnp.zeros(()), weights_im=jnp.zeros(()))


@partial(jax.jit, static_argnames=("part", "qp_iter"))
@precise_matmuls
def run_ordinary_ridge(part: str, data: RidgeData, lambda_0, qp_iter: int = 2000) -> RidgeResult:
    """Single QP solve with lam = lambda_0 (reference: inversion.py:835-852)."""
    k = data.WA_re.shape[1]
    lam = jnp.full((3, k), lambda_0, data.WA_re.dtype)
    L2_mat = build_l2_matrix(data, lam, jnp.ones((k,), data.WA_re.dtype))
    P, q = assemble_qp(part, data, L2_mat)
    coef = solve_qp_box(P, q, data.lb, data.ub, max_iter=qp_iter).x
    cost = 0.5 * coef @ (P @ coef) + q @ coef
    return RidgeResult(coef=coef, lam_vectors=lam, cost=cost,
                       n_iter=jnp.asarray(1, jnp.int32),
                       converged=jnp.asarray(True),
                       weights_re=jnp.zeros(()), weights_im=jnp.zeros(()))


@partial(jax.jit, static_argnames=("part", "max_iter", "qp_iter"))
@precise_matmuls
def run_hyper_weights(part: str, data: RidgeData, A_re, A_im, T_re, T_im,
                      lambda_0, hw_beta, wbar_re, wbar_im,
                      max_iter: int = 20, xtol: float = 1e-3,
                      delta_mask=None, qp_iter: int = 2000) -> RidgeResult:
    """Outlier-robust hyper-weights iteration (reference: inversion.py:757-833).

    A_re/A_im/T_re/T_im are the *unweighted* design/target; the loop applies
    the evolving weights itself.
    """
    k = A_re.shape[1]
    dtype = A_re.dtype
    lam = jnp.full((3, k), lambda_0, dtype)
    L2_mat = build_l2_matrix(data, lam, jnp.ones((k,), dtype))
    if delta_mask is None:
        delta_mask = jnp.ones((k,), dtype)

    def assemble_with(w_re, w_im):
        d = data._replace(WA_re=w_re[:, None] * A_re, WA_im=w_im[:, None] * A_im,
                          WT_re=w_re * T_re, WT_im=w_im * T_im)
        return assemble_qp(part, d, L2_mat)

    def body(state):
        coef, w_re, w_im, it, _, at_lb, at_ub = state
        new_w_re, new_w_im = hyper_weights_update(coef, A_re, A_im, T_re, T_im,
                                                  hw_beta, wbar_re, wbar_im)
        w_re = jnp.where(it > 0, new_w_re, w_re)
        w_im = jnp.where(it > 0, new_w_im, w_im)
        P, q = assemble_with(w_re, w_im)
        # warm-start the QP with the previous outer iteration's active set:
        # the weights move slowly between iterations, so the re-solve
        # typically pivots 1-3 times instead of a cold start's ~14 (same
        # scheme as the hyper-lambda loop above; equilibrated cold sets,
        # computed only on the first iteration)
        warm = jax.lax.cond(
            it > 0,
            lambda: (at_lb, at_ub),
            lambda: qp_cold_sets(P, q, data.lb, data.ub))
        res_qp = solve_qp_box(P, q, data.lb, data.ub, max_iter=qp_iter,
                              warm_sets=warm)
        new_coef = res_qp.x
        safe_prev = jnp.where(jnp.abs(coef) > 0, coef, 1.0)
        delta = jnp.mean(jnp.abs((new_coef - coef) / safe_prev * delta_mask))
        return (new_coef, w_re, w_im, it + 1, delta,
                res_qp.at_lb, res_qp.at_ub)

    def cond(state):
        return jnp.logical_and(state[3] < max_iter, state[4] >= xtol)

    coef0 = jnp.full((k,), 1e-6, dtype)
    init = (coef0, wbar_re, wbar_im, jnp.asarray(0, jnp.int32),
            jnp.asarray(jnp.inf, dtype),
            jnp.zeros((k,), bool), jnp.zeros((k,), bool))
    coef, w_re, w_im, it, delta, _, _ = jax.lax.while_loop(cond, body, init)
    d_final = data._replace(WA_re=w_re[:, None] * A_re,
                            WA_im=w_im[:, None] * A_im,
                            WT_re=w_re * T_re, WT_im=w_im * T_im)
    P, q = assemble_qp(part, d_final, L2_mat)
    cost = 0.5 * coef @ (P @ coef) + q @ coef
    return RidgeResult(coef=coef, lam_vectors=lam, cost=cost, n_iter=it,
                       converged=delta < xtol, weights_re=w_re, weights_im=w_im)
