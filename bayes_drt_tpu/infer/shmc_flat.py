"""Flat-chain SHMC with a hand-written posterior gradient.

The generic SHMC path (infer/chees.py:sample_shmc) vmaps a per-spectrum
sampler over the batch and differentiates models/posterior.py with
``jax.grad``. This module runs the same sampler over ONE flat
(B*chains, D) chain axis, with the log posterior's value and gradient
written out by hand, so each leapfrog is a few batched matrix products and
elementwise passes over that axis.

The hand-written form is tractable exactly for the flagship workload (the
bench posterior): a single series distribution, no outliers, not fitY — the
Stan ``Series``/``Series_pos`` model (reference:
bayes_drt/stan_model_files/Series_modelcode.txt, sampled by
inversion.py:1218-1221), in centered or non-centered (ncp) coordinates. It
also exposes an algebraic simplification the generic path can't use: the
Stan model's ``q ~ normal(0, ups)`` soft prior on
``q = sqrt(sum_k ds_k (L_k x)^2)`` needs no square root at all — only
``q^2`` enters the density — so the gradient has no 1/sqrt term.

``flat_value_and_grad`` is pure jnp: the unit tests check it against
``jax.value_and_grad`` of models/posterior.py, which makes it the one
from-first-principles check of the posterior gradient. It is also the
starting point for a fused trajectory kernel, since a kernel cannot call
back into ``jax.grad``.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)
_HIGHEST = jax.lax.Precision.HIGHEST


class FlatSpec(NamedTuple):
    """Static description of the flattened single-series-DRT posterior.

    Offsets index the SAME flat layout ravel_pytree gives the generic path
    (discovered, not assumed), so flat draws are interchangeable with the
    generic samplers' draws for summarize/warm-start purposes."""
    K: int                  # basis size
    n: int                  # number of frequencies (target is (2n,))
    D: int                  # total flat parameter dimension
    ncp: bool
    nonneg: bool
    # (start, size) per parameter in the flat vector
    off_rinf: int = 0
    off_alpha_im: int = 0
    off_alpha_prop: int = 0
    off_alpha_re: int = 0
    off_d: int = 0
    off_induc: int = 0
    off_sigma_res: int = 0
    off_ups: int = 0
    off_x: int = 0


def flat_spec_for(cfg, data) -> FlatSpec:
    """Build a FlatSpec for an eligible PosteriorConfig, discovering the
    ravel_pytree layout from a marker template. Raises ValueError when the
    posterior is outside the hand-written model family."""
    from jax.flatten_util import ravel_pytree

    from ..models.posterior import init_unconstrained

    if (len(cfg.dists) != 1 or cfg.dists[0].dist_type != "series"
            or cfg.outliers or cfg.fitY or cfg.sa):
        raise ValueError(
            "the flat-chain sampler supports the single series-"
            f"distribution model family only (got {cfg.model_name()}); "
            "use the generic sampler for this model")
    template = init_unconstrained(cfg, data, jax.random.PRNGKey(0))
    flat, _ = ravel_pytree(template)
    D = int(flat.shape[0])
    offs = {}
    for name in template:
        marker = {k: (np.ones(np.shape(v)) if k == name
                      else np.zeros(np.shape(v)))
                  for k, v in template.items()}
        fl = np.asarray(ravel_pytree(marker)[0])
        idx = np.nonzero(fl)[0]
        if len(idx) == 0 or not (np.diff(idx) == 1).all():
            raise AssertionError(f"non-contiguous ravel slice for {name}")
        offs[name] = int(idx[0])
    K = cfg.dists[0].K
    n = int(np.shape(data.freq)[0])
    return FlatSpec(K=K, n=n, D=D, ncp=cfg.ncp, nonneg=cfg.nonneg,
                    off_rinf=offs["Rinf_raw"],
                    off_alpha_im=offs["alpha_im_raw"],
                    off_alpha_prop=offs["alpha_prop_raw"],
                    off_alpha_re=offs["alpha_re_raw"],
                    off_d=offs["d_strength_0"],
                    off_induc=offs["induc_raw"],
                    off_sigma_res=offs["sigma_res_raw"],
                    off_ups=offs["ups_raw_0"],
                    off_x=offs["x_0"])


class FlatShared(NamedTuple):
    """Traced shared numeric inputs (same for every spectrum in the batch)."""
    A: jax.Array        # (2n, K) stacked design matrix
    L: jax.Array        # (3, K, K) mode-scaled derivative matrices
    vecs: jax.Array     # (3, 2n): rinf_vec, induc_vec, lik_mask
    scal: jax.Array     # (8,): sigma_min, ups_alpha, ups_beta, induc_scale,
                        #        x_scale, ups_lognorm, 0, 0 — ups_lognorm is
                        #        the inv-gamma normalizer a*log(b)-lgamma(a),
                        #        precomputed so the kernel needs no lgamma


def flat_shared_for(cfg, data, dtype) -> FlatShared:
    n = np.shape(data.freq)[0]
    freq = jnp.asarray(data.freq, dtype)
    rv = jnp.concatenate([jnp.ones(n, dtype), jnp.zeros(n, dtype)])
    iv = jnp.concatenate([jnp.zeros(n, dtype),
                          (2.0 * jnp.pi) * freq]).astype(dtype)
    mask = jnp.asarray(data.lik_mask, dtype)
    vecs = jnp.stack([rv, iv, mask])
    from jax.scipy.special import gammaln
    ua = jnp.asarray(data.ups_alpha, dtype)
    ub = jnp.asarray(data.ups_beta, dtype)
    ups_lognorm = ua * jnp.log(ub) - gammaln(ua)
    scal = jnp.stack([jnp.asarray(data.sigma_min, dtype), ua, ub,
                      jnp.asarray(data.induc_scale, dtype),
                      jnp.asarray(data.x_scales[0], dtype),
                      ups_lognorm.astype(dtype), jnp.zeros((), dtype),
                      jnp.zeros((), dtype)])
    return FlatShared(A=jnp.asarray(data.A[0], dtype),
                      L=jnp.asarray(data.L[0], dtype),
                      vecs=vecs, scal=scal)


def _dotg(a, b, contract):
    return jax.lax.dot_general(a, b, dimension_numbers=(contract, ((), ())),
                               preferred_element_type=a.dtype,
                               precision=_HIGHEST)


def flat_value_and_grad(spec: FlatSpec, A, L, vecs, scal, q, target):
    """Batched value and gradient of the single-series-DRT log posterior.

    q: (R, D) unconstrained rows; target: (R, 2n) scaled impedance rows.
    Returns (lp (R,), grad (R, D)). Matches jax.value_and_grad of
    models/posterior.log_density (jacobian=True) on every row; the model
    terms mirror the Stan Series model (reference:
    stan_model_files/Series_modelcode.txt:40-70) exactly as log_density does.
    """
    K, n = spec.K, spec.n
    dt = q.dtype
    sigma_min = scal[0]
    ups_alpha = scal[1]
    ups_beta = scal[2]
    induc_scale = scal[3]
    x_scale = scal[4]
    rv = vecs[0]
    iv = vecs[1]
    mask = vecs[2]

    r_ = q[:, spec.off_rinf]
    ai = q[:, spec.off_alpha_im]
    ap = q[:, spec.off_alpha_prop]
    ar = q[:, spec.off_alpha_re]
    iu = q[:, spec.off_induc]
    sr = q[:, spec.off_sigma_res]
    d = q[:, spec.off_d:spec.off_d + 3]
    u = q[:, spec.off_ups:spec.off_ups + K]
    v = q[:, spec.off_x:spec.off_x + K]

    er = jnp.exp(r_)
    ei = jnp.exp(iu)
    es = jnp.exp(sr)
    eap = jnp.exp(ap)
    ear = jnp.exp(ar)
    eai = jnp.exp(ai)
    rinf = er * 100.0
    induc = ei * induc_scale
    sres = es * 0.05
    a_p = eap * 0.05
    a_re = ear * 0.05
    a_im = eai * 0.05
    ups = jnp.exp(u) * 0.15
    ds = jnp.exp(d)

    if spec.nonneg:
        xr_base = jnp.exp(v)
    else:
        xr_base = v
    x_raw = xr_base * ups if spec.ncp else xr_base
    x = x_raw * x_scale

    # ---- likelihood ----
    pred = (_dotg(x, A, ((1,), (1,)))
            + rinf[:, None] * rv[None, :] + induc[:, None] * iv[None, :])
    p_re = pred[:, :n]
    p_im = pred[:, n:]
    var = (sigma_min * sigma_min + (sres * sres)[:, None]
           + (a_p[:, None] * pred) ** 2
           + jnp.concatenate([(a_re[:, None] * p_re) ** 2,
                              (a_re[:, None] * p_re) ** 2], axis=1)
           + jnp.concatenate([(a_im[:, None] * p_im) ** 2,
                              (a_im[:, None] * p_im) ** 2], axis=1))
    resid = target - pred
    ivar = 1.0 / var
    loglik = jnp.sum(mask[None, :] * (-0.5 * resid * resid * ivar
                                      - 0.5 * jnp.log(var) - _LOG_SQRT_2PI),
                     axis=1)

    # ---- q-penalty (no sqrt needed: only q^2 enters the density) ----
    Lx0 = _dotg(x_raw, L[0], ((1,), (1,)))
    Lx1 = _dotg(x_raw, L[1], ((1,), (1,)))
    Lx2 = _dotg(x_raw, L[2], ((1,), (1,)))
    S = (ds[:, 0:1] * Lx0 * Lx0 + ds[:, 1:2] * Lx1 * Lx1
         + ds[:, 2:3] * Lx2 * Lx2)
    iu2 = 1.0 / (ups * ups)
    log15 = math.log(0.15)
    lp_q = jnp.sum(-0.5 * S * iu2 - u - (log15 + _LOG_SQRT_2PI), axis=1)

    # ---- dups smoothness prior ----
    a_w = ups[:, :-2]
    b_w = ups[:, 2:]
    c_w = ups[:, 1:-1]
    dups = 0.5 * (c_w - 0.5 * (a_w + b_w)) / c_w
    lp_dups = jnp.sum(-0.5 * dups * dups, axis=1) - (K - 2) * _LOG_SQRT_2PI

    # ---- scalar priors (half-normal on the exp-raw scales) ----
    pri = (-0.5 * (er * er + ei * ei + es * es + eap * eap + ear * ear
                   + eai * eai) - 6.0 * _LOG_SQRT_2PI)
    c5 = 5.0 * math.log(5.0) - math.lgamma(5.0)
    pri = pri + jnp.sum(c5 - 6.0 * d - 5.0 * jnp.exp(-d), axis=1)
    cu = scal[5]     # ups_alpha*log(ups_beta) - lgamma(ups_alpha), host-side
    pri = pri + jnp.sum(cu - (ups_alpha + 1.0) * u
                        - ups_beta * jnp.exp(-u), axis=1)

    # ---- Jacobian of the exp transforms (+ ncp change of variables) ----
    jac = (r_ + ai + ap + ar + iu + sr + jnp.sum(d, axis=1)
           + jnp.sum(u, axis=1))
    if spec.nonneg:
        jac = jac + jnp.sum(v, axis=1)
    if spec.ncp:
        jac = jac + jnp.sum(u, axis=1) + K * log15

    lp = loglik + lp_q + lp_dups + pri + jac

    # ================= gradient =================
    # likelihood: w = dl/dvar, gl = direct dl/dpred
    gl = mask[None, :] * resid * ivar
    w = mask[None, :] * 0.5 * (resid * resid * ivar - 1.0) * ivar
    wsum = w[:, :n] + w[:, n:]
    g_pred = gl + w * (2.0 * (a_p * a_p)[:, None] * pred)
    g_pred = g_pred + jnp.concatenate(
        [2.0 * (a_re * a_re)[:, None] * p_re * wsum,
         2.0 * (a_im * a_im)[:, None] * p_im * wsum], axis=1)

    g_x = _dotg(g_pred, A, ((1,), (0,)))          # (R, K)
    g_xraw = x_scale * g_x
    g_r = jnp.sum(g_pred * rv[None, :], axis=1) * rinf + 1.0 - er * er
    g_iu = jnp.sum(g_pred * iv[None, :], axis=1) * induc + 1.0 - ei * ei
    g_sr = jnp.sum(w, axis=1) * 2.0 * sres * sres + 1.0 - es * es
    g_ap = (jnp.sum(w * pred * pred, axis=1) * 2.0 * a_p * a_p
            + 1.0 - eap * eap)
    g_ar = (jnp.sum(wsum * p_re * p_re, axis=1) * 2.0 * a_re * a_re
            + 1.0 - ear * ear)
    g_ai = (jnp.sum(wsum * p_im * p_im, axis=1) * 2.0 * a_im * a_im
            + 1.0 - eai * eai)

    # q-penalty: dlp/dLx_k = -ds_k * Lx_k / ups^2
    gLx0 = -ds[:, 0:1] * Lx0 * iu2
    gLx1 = -ds[:, 1:2] * Lx1 * iu2
    gLx2 = -ds[:, 2:3] * Lx2 * iu2
    g_xraw = g_xraw + (_dotg(gLx0, L[0], ((1,), (0,)))
                       + _dotg(gLx1, L[1], ((1,), (0,)))
                       + _dotg(gLx2, L[2], ((1,), (0,))))

    g_d = jnp.stack([
        -0.5 * jnp.sum(Lx0 * Lx0 * iu2, axis=1) * ds[:, 0],
        -0.5 * jnp.sum(Lx1 * Lx1 * iu2, axis=1) * ds[:, 1],
        -0.5 * jnp.sum(Lx2 * Lx2 * iu2, axis=1) * ds[:, 2],
    ], axis=1) + 1.0 - 6.0 + 5.0 * jnp.exp(-d)

    # ups: q-penalty (chain through ups = exp(u)*0.15 included), prior,
    # jacobians, dups coupling, and the ncp x_raw = base*ups dependence
    g_u = (S * iu2 - 1.0) - (ups_alpha + 1.0) + ups_beta * jnp.exp(-u) + 1.0
    if spec.ncp:
        g_u = g_u + 1.0 + g_xraw * x_raw
    wd = -dups
    g_a = wd * (-0.25 / c_w)
    g_c = wd * 0.25 * (a_w + b_w) / (c_w * c_w)
    zero2 = jnp.zeros((q.shape[0], 2), dt)
    zero1 = jnp.zeros((q.shape[0], 1), dt)
    g_ups_dups = (jnp.concatenate([g_a, zero2], axis=1)
                  + jnp.concatenate([zero2, g_a], axis=1)
                  + jnp.concatenate([zero1, g_c, zero1], axis=1))
    g_u = g_u + g_ups_dups * ups

    if spec.ncp:
        dxdv = x_raw if spec.nonneg else ups
    else:
        dxdv = x_raw if spec.nonneg else jnp.ones_like(x_raw)
    g_v = g_xraw * dxdv
    if spec.nonneg:
        g_v = g_v + 1.0

    parts = [(spec.off_rinf, g_r[:, None]),
             (spec.off_alpha_im, g_ai[:, None]),
             (spec.off_alpha_prop, g_ap[:, None]),
             (spec.off_alpha_re, g_ar[:, None]),
             (spec.off_d, g_d),
             (spec.off_induc, g_iu[:, None]),
             (spec.off_sigma_res, g_sr[:, None]),
             (spec.off_ups, g_u),
             (spec.off_x, g_v)]
    parts.sort(key=lambda t: t[0])
    grad = jnp.concatenate([p for _, p in parts], axis=1)
    return lp, grad


# ===================== trajectory =====================

def _leaf_step(spec, A, L, vecs, scal, m_inv, epsc, q_init, p_init, g_init,
               lp_init, H0, j, targets, max_e, i, u, st):
    """One leapfrog + streaming-multinomial-selection step over (R, D) rows.

    Identical math to the per-spectrum leaf in infer/chees.py:sample_shmc
    (backward leg with flipped momentum until i == j, then the forward leg;
    divergent legs freeze and are never selected). Written over plain
    values, with every per-row scalar a (R, 1) column and the
    freeze/divergence flags {0, 1} float masks, so a kernel can reuse it.
    """
    (qq, pp, gg, lp, logw, pq, plp, pgq, pkin, sacc, dead, ever) = st
    dt = qq.dtype

    def sel(mask_col, a, b):
        # mask_col: (R, 1) float in {0, 1}; full-shape select
        m = jnp.broadcast_to(mask_col, a.shape) > 0.5
        return jnp.where(m, a, b)

    flip = i == j
    qq = jnp.where(flip, q_init, qq)
    pp = jnp.where(flip, p_init, pp)
    gg = jnp.where(flip, g_init, gg)
    lp = jnp.where(flip, lp_init, lp)
    dead = jnp.where(flip, jnp.zeros_like(dead), dead)

    p_half = pp + 0.5 * epsc * gg
    q_new = qq + epsc * p_half * m_inv
    lp1, g_new = flat_value_and_grad(spec, A, L, vecs, scal, q_new, targets)
    lp_new = lp1[:, None]
    p_new = p_half + 0.5 * epsc * g_new
    kin = 0.5 * jnp.sum(p_new * p_new * m_inv, axis=1, keepdims=True)
    Hn = -lp_new + kin
    w = H0 - Hn
    badf = jnp.maximum(jnp.isnan(Hn).astype(dt),
                       ((Hn - H0) > max_e).astype(dt))
    freeze = jnp.maximum(badf, dead)
    w = jnp.where(freeze > 0.5, -jnp.inf, w)
    logw_new = jnp.logaddexp(logw, w)
    take = jnp.log(u) < (w - logw_new)          # (R, 1) i1, same-shape ops
    takef = take.astype(dt)
    pq = sel(takef, q_new, pq)
    plp = jnp.where(take, lp_new, plp)
    pgq = sel(takef, g_new, pgq)
    pkin = jnp.where(take, kin, pkin)
    sacc = sacc + jnp.minimum(1.0, jnp.exp(w))
    dead_new = jnp.maximum(dead, badf)
    ever = jnp.maximum(ever, dead_new)
    alivef = 1.0 - dead_new
    return (sel(alivef, q_new, qq), sel(alivef, p_new, pp),
            sel(alivef, g_new, gg), jnp.where(alivef > 0.5, lp_new, lp),
            logw_new, pq, plp, pgq, pkin, sacc, dead_new, ever)


def _traj_init_state(q, p0, grad, lp_col, kin0, dtype):
    rt = q.shape[0]
    z = jnp.zeros((rt, 1), dtype)
    # initial state enters the multinomial with weight 1 (logw = 0)
    return (q, -p0, grad, lp_col, z, q, lp_col, grad, kin0, z, z, z)


def _traj_xla(spec, n_leap, max_e, shared, q, p0, grad, logp, eps,
              m_inv_rows, targets, j, u_sel, unroll=1):
    """The trajectory: lax.scan over leaves."""
    A, L, vecs, scal = shared.A, shared.L, shared.vecs, shared.scal
    kin0 = 0.5 * jnp.sum(p0 * p0 * m_inv_rows, axis=1, keepdims=True)
    lp_col = logp[:, None]
    H0 = -lp_col + kin0
    epsc = eps[:, None]

    def body(st, xs):
        i, u = xs
        st = _leaf_step(spec, A, L, vecs, scal, m_inv_rows, epsc, q, p0,
                        grad, lp_col, H0, j, targets, max_e, i, u[:, None],
                        st)
        return st, None

    st0 = _traj_init_state(q, p0, grad, lp_col, kin0, q.dtype)
    st, _ = jax.lax.scan(body, st0, (jnp.arange(n_leap), u_sel),
                         unroll=unroll)
    (_, _, _, _, _, pq, plp, pgq, pkin, sacc, _, ever) = st
    return pq, plp[:, 0], pgq, pkin[:, 0], sacc[:, 0], ever[:, 0] > 0.5


# ===================== sampler =====================

def _pool_eps_rows(eps_bc, cfg):
    """Per-spectrum pooled sampling step size over the chain axis of a
    (B, C) step-size array (min by default, cfg.eps_quantile quantile)."""
    q = getattr(cfg, "eps_quantile", 0.0)
    if q <= 0.0:
        return eps_bc.min(axis=1)
    return jnp.quantile(eps_bc, q, axis=1)


@partial(jax.jit, static_argnames=("spec", "warmup", "samples", "cfg",
                                   "chains"))
def sample_shmc_flat(spec: FlatSpec, shared: FlatShared, targets, q0, key,
                     warmup: int, samples: int, cfg, chains: int,
                     init_step_size: float = 1.0):
    """Synchronous static multinomial HMC over ONE flat chain axis.

    The whole batch — B spectra x ``chains`` chains — runs as (B*chains, D)
    rows through one lax.scan trajectory per draw.
    Adaptation matches infer/chees.py:sample_shmc: per-ROW dual averaging,
    Welford pooled within-chain then averaged per SPECTRUM into that
    spectrum's shared diagonal metric, and a per-spectrum pooled sampling
    step size (min / cfg.eps_quantile quantile over its chains).

    targets: (B*chains, 2n) per-row scaled stacked impedance (each
    spectrum's row repeated ``chains`` times); q0: (B*chains, D).
    Returns (draws (B, C, S, D), info dict with a leading B axis).
    """
    from .nuts import (_da_init, _da_update, _regularized_variance,
                       _window_flags, find_reasonable_step_size)
    from .chees import _halton2

    rt, dim = q0.shape
    nb = rt // chains
    dtype = q0.dtype
    n_leap_s = cfg.n_steps
    n_leap_w = cfg.warm_steps or cfg.n_steps
    max_e = cfg.max_energy_error

    def vg(q2, t2):
        return flat_value_and_grad(spec, shared.A, shared.L, shared.vecs,
                                   shared.scal, q2, t2)

    def rows(m_inv):
        return jnp.broadcast_to(m_inv[:, None, :],
                                (nb, chains, dim)).reshape(rt, dim)

    logp0, grad0 = vg(q0, targets)
    m_inv0 = jnp.ones((nb, dim), dtype)
    key, k_eps = jax.random.split(key)

    def row_fn(t_row):
        def f(qq):
            lp, g = vg(qq[None, :], t_row[None, :])
            return lp[0], g[0]
        return f

    eps0 = jax.vmap(
        lambda q, t, lp, g, k, mi: find_reasonable_step_size(
            row_fn(t), q, lp, g, k, mi, init_eps=init_step_size)
    )(q0, targets, logp0, grad0, jax.random.split(k_eps, rt), rows(m_inv0))

    total = warmup + samples
    if cfg.adapt_mass:
        in_slow_np, win_end_np = _window_flags(warmup, cfg)
    else:
        in_slow_np = np.zeros(warmup, bool)
        win_end_np = np.zeros(warmup, bool)
    in_warm_np = np.arange(total) < warmup
    h1 = _halton2(total)
    h2 = _halton2(2 * total)[total:]
    jit_mult = jnp.asarray(cfg.jitter_lo + (1.0 - cfg.jitter_lo) * h1, dtype)
    nl_sched = np.concatenate([np.full(warmup, n_leap_w),
                               np.full(samples, n_leap_s)])
    j_split = jnp.asarray(np.floor(h2 * (nl_sched + 1)).clip(0, nl_sched)
                          .astype(np.int32))
    in_warm = jnp.asarray(in_warm_np)
    in_slow = jnp.asarray(np.concatenate([in_slow_np, np.zeros(samples, bool)]))
    win_end = jnp.asarray(np.concatenate([win_end_np, np.zeros(samples, bool)]))

    da0 = jax.vmap(lambda e: _da_init(e, dtype))(eps0)
    wf0 = (jnp.zeros((rt, dim), dtype), jnp.zeros((rt, dim), dtype),
           jnp.zeros((), dtype))

    def make_step(n_leap, adapting=True, eps_fixed=None):
        def traj(sh, q, p0, grad, logp, eps, m_inv_rows, tgt, j, u_sel):
            return _traj_xla(spec, n_leap, max_e, sh, q, p0, grad, logp,
                             eps, m_inv_rows, tgt, j, u_sel,
                             unroll=cfg.leaf_unroll)

        def step(carry, xs):
            q, logp, grad, da, wf, m_inv, key = carry
            is_warm, slow, wend, h, j = xs
            key, k_mom, k_sel = jax.random.split(key, 3)

            if adapting:
                eps_samp = _pool_eps_rows(
                    jnp.exp(da.log_eps_bar).reshape(nb, chains), cfg)
                eps = jnp.where(is_warm, jnp.exp(da.log_eps),
                                jnp.broadcast_to(eps_samp[:, None],
                                                 (nb, chains)).reshape(rt))
            else:
                eps = jnp.broadcast_to(eps_fixed[:, None],
                                       (nb, chains)).reshape(rt)
            eps = eps * h

            m_inv_rows = rows(m_inv)
            z = jax.random.normal(k_mom, (rt, dim), dtype)
            p0 = z / jnp.sqrt(m_inv_rows)
            u_sel = jax.random.uniform(k_sel, (n_leap, rt), dtype)

            q_next, logp_next, grad_next, kin_next, sacc, ever = traj(
                shared, q, p0, grad, logp, eps, m_inv_rows, targets, j, u_sel)
            accept_prob = sacc / n_leap
            H1 = -logp_next + kin_next

            if adapting:
                da_new = _da_update(da, accept_prob, cfg)
                da = jax.tree.map(lambda n_, o: jnp.where(is_warm, n_, o),
                                  da_new, da)
            if adapting and cfg.adapt_mass:
                mean, m2, n_ = wf
                n1 = n_ + 1.0
                dlt = q_next - mean
                mean_new = mean + dlt / n1
                m2_new = m2 + dlt * (q_next - mean_new)
                wf = jax.tree.map(lambda a, b_: jnp.where(slow, a, b_),
                                  (mean_new, m2_new, n1), wf)
                mean, m2, n_ = wf
                var_within = (m2 / jnp.maximum(n_ - 1.0, 1.0)).reshape(
                    nb, chains, dim).mean(axis=1)
                reg = _regularized_variance(var_within, chains * n_)
                m_inv = jnp.where(wend & (n_ > 1), reg, m_inv)
                wf = jax.tree.map(
                    lambda a: jnp.where(wend, jnp.zeros_like(a), a), wf)
                da_reset = jax.vmap(lambda e: _da_init(e, dtype))(
                    jnp.exp(da.log_eps))
                da = jax.tree.map(lambda r, o: jnp.where(wend, r, o),
                                  da_reset, da)

            out = (q_next, logp_next, accept_prob, ever, H1)
            return (q_next, logp_next, grad_next, da, wf, m_inv, key), out

        return step

    step_w = make_step(n_leap_w)

    def warm_step(carry, xs):
        carry, out = step_w(carry, xs)
        return carry, out[3]

    carry0 = (q0, logp0, grad0, da0, wf0, m_inv0, key)
    xs_w = (in_warm[:warmup], in_slow[:warmup], win_end[:warmup],
            jit_mult[:warmup], j_split[:warmup])
    xs_s = (in_warm[warmup:], in_slow[warmup:], win_end[warmup:],
            jit_mult[warmup:], j_split[warmup:])
    carry, warm_div = jax.lax.scan(warm_step, carry0, xs_w,
                                   unroll=cfg.draw_unroll)
    eps_fixed = _pool_eps_rows(
        jnp.exp(carry[3].log_eps_bar).reshape(nb, chains), cfg)
    step_s = make_step(n_leap_s, adapting=False, eps_fixed=eps_fixed)

    def sample_step(carry, xs):
        return step_s(carry, xs)

    carry, outs = jax.lax.scan(sample_step, carry, xs_s,
                               unroll=cfg.draw_unroll)
    q_s, logp_s, acc_s, div_s, en_s = outs
    (_, _, _, da, _, m_inv, _) = carry

    def per_spec(x_t_rows):
        # (T, rt, ...) -> (B, C, T, ...)
        t = x_t_rows.shape[0]
        return jnp.moveaxis(x_t_rows.reshape((t, nb, chains)
                                             + x_t_rows.shape[2:]), 0, 2)

    draws = per_spec(q_s)
    info = {
        "logp": per_spec(logp_s),
        "accept_prob": per_spec(acc_s),
        "diverging": per_spec(div_s),
        "n_leapfrog": jnp.full((nb, chains, samples), n_leap_s, jnp.int32),
        "energy": per_spec(en_s),
        "step_size": jnp.exp(da.log_eps_bar).reshape(nb, chains),
        "inv_mass": m_inv,
        "warmup_diverging": per_spec(warm_div),
    }
    return draws, info
