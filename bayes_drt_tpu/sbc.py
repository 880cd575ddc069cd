"""Simulation-based calibration (SBC) of the sampling stack.

Talts et al. 2018: draw (theta, y) pairs from the model's joint prior
predictive, fit each y with the sampler under test, and rank the true theta
among the posterior draws. If the sampler targets the right posterior, every
rank statistic is uniform — a property that certifies the WHOLE tower
(posterior implementation + sampler + adaptation + precision policy) at
once, where truth-recovery RMSE and coverage-on-one-family cannot.

The Stan-style Series model (reference:
bayes_drt/stan_model_files/Series_modelcode.txt:24-69) is not directly
generative: the soft prior ``q ~ normal(0, ups)`` with
``q_j = sqrt(sum_k ds_k (L_k x)_j^2)`` is an unnormalized Gaussian in x
whose normalizing constant depends on (ups, ds). Writing

    M(ups, ds) = sum_k ds_k L_k^T diag(ups^-2) L_k                   (K, K)

the exp(-q^2/2ups^2) factor is exp(-x^T M x / 2), so the joint prior
factorizes EXACTLY as

    p(ups_raw, ds)  propto  IG(ups_raw; a, b) * IG(ds; 5, 5)
                            * N(dups(ups); 0, 1)            (soft smoothness)
                            * prod_j ups_j^-1 * |M|^{-1/2}  (marginalized x)
    x | ups, ds  ~  N(0, M^{-1})                            (exact Gaussian)

with the remaining scalars (Rinf, induc, sigma_res, alpha_*) independent
half-normals by construction. So:

1. ``sample_prior_marginal`` draws the (ups_raw, ds) marginal by NUTS —
   many vmapped chains, ONE retained draw per chain, so retained draws are
   independent across chains by construction (cross-chain rank-Rhat of the
   retained set is returned as the convergence certificate). NUTS here is
   the Stan-parity-tested sampler, independent of the production SHMC
   stack under test.
2. ``generate_datasets`` samples x by a Cholesky solve, the scalars from
   their half-normals, and y through the model's own predict_target /
   sigma_tot — the data-generating process IS models/posterior.py.
3. The caller fits the batch with the PRODUCTION path
   (``fit_spectra_batch(..., z_scale=1, monitor_thin=...)``; z_scale=1 so
   the fitted model is bit-identical to the generative one) and feeds the
   thinned ``monitor_draws`` to ``sbc_ranks`` / ``rank_uniformity``.

``benchmarks/sbc.py`` is the accelerator driver; ``tests/test_round4.py`` runs a
small-N version end-to-end on CPU.

The ``_outliers`` model variants reuse the SAME (ups_raw, ds) marginal —
the per-frequency outlier scales are independent of the x-hierarchy, so
``generate_datasets`` simply draws ``sigma_out_raw ~ Exponential(lambda)``
and ``sigma_out_scale ~ InvGamma(a, b)`` from their exact priors and adds
sigma_out monitors at ``outlier_monitor_indices`` (matched by the batch
summarizer). SBC arms for Series and Series_outliers are therefore PAIRED
on the x-hierarchy prior draws.
"""

from __future__ import annotations

import numpy as np

from .models.posterior import (outlier_monitor_indices, predict_target,
                               sigma_tot)
from .models.priors import inv_gamma_lpdf, std_normal_lpdf

MONITOR_SCALARS = ("Rinf", "induc", "sigma_res", "alpha_prop",
                   "alpha_re", "alpha_im")


def _marginal_logdensity(cfg, data):
    """Log density of the (ups_raw, ds) prior marginal on the unconstrained
    vector u = [log ups_raw (K,), log ds (3,)], x integrated out exactly."""
    import jax.numpy as jnp

    L = data.L[0]                      # (3, K, K) mode-scaled penalty roots
    k = L.shape[-1]

    def logp(u):
        ups_raw = jnp.exp(u[:k])
        ds = jnp.exp(u[k:])
        ups = 0.15 * ups_raw
        lp = inv_gamma_lpdf(ups_raw, data.ups_alpha, data.ups_beta)
        lp += inv_gamma_lpdf(ds, 5.0, 5.0)
        lp += jnp.sum(u)               # log|J| of the exp transforms
        dups = 0.5 * (ups[1:-1] - 0.5 * (ups[:-2] + ups[2:])) / ups[1:-1]
        lp += std_normal_lpdf(dups)
        w = 1.0 / ups**2
        m = (ds[0] * (L[0].T * w) @ L[0] + ds[1] * (L[1].T * w) @ L[1]
             + ds[2] * (L[2].T * w) @ L[2])
        chol = jnp.linalg.cholesky(m)
        # -sum(log ups) from the normal_lpdf(q, 0, ups) normalization,
        # -1/2 logdet M from integrating the Gaussian in x
        lp -= jnp.sum(jnp.log(ups))
        lp -= jnp.sum(jnp.log(jnp.diagonal(chol)))
        return lp

    return logp, k


def sample_prior_marginal(cfg, data, n_draws, seed=0, warmup=600,
                          max_tree_depth=7, chunk=16):
    """n_draws independent draws of (ups_raw, ds): one NUTS chain per draw
    (vmapped), warmup + 1 retained draw each. Returns (ups_raw (n, K),
    ds (n, 3), diagnostics) where diagnostics carries the cross-chain
    rank-Rhat of the retained set — the prior-exactness certificate.

    The chains run in ``chunk``-sized slices of one compiled program: each
    leapfrog step does a (K, K) Cholesky, and one program over many chains
    at K~100 exhausted an earlier accelerator's memory (64 chains failed,
    16 ran)."""
    import jax
    import jax.numpy as jnp

    from .infer.diagnostics import ess_bulk, rhat_rank
    from .infer.nuts import NUTSConfig, sample_nuts

    logp, k = _marginal_logdensity(cfg, data)
    cfg_n = NUTSConfig(max_depth=max_tree_depth, tree_scan=True)
    key = jax.random.PRNGKey(seed)

    def one_chain(ck):
        k1, k2, k3 = jax.random.split(ck, 3)
        # init at a CONSTANT ups profile jittered by one shared log-factor:
        # iid IG draws have huge relative second differences (dups), i.e.
        # start far outside the smoothness prior's typical set and force
        # long early trajectories; a flat profile starts at the dups mode
        mode_ups = data.ups_beta / (data.ups_alpha + 1.0)
        jit_u = 0.5 * jax.random.normal(k1, (), dtype=data.target.dtype)
        g_ds = jax.random.gamma(k2, 5.0, (3,)) / 5.0
        u0 = jnp.concatenate([
            jnp.full((k,), jnp.log(mode_ups) + jit_u, data.target.dtype),
            jnp.log(g_ds).astype(data.target.dtype)])
        draws, info = sample_nuts(logp, u0, k3, warmup=warmup, samples=2,
                                  cfg=cfg_n)
        return draws[-1], info["diverging"].mean()

    prog = jax.jit(jax.vmap(one_chain))
    keys = jax.random.split(key, n_draws)
    us_parts, div_parts = [], []
    for lo in range(0, n_draws, chunk):
        u, dv = prog(keys[lo:lo + chunk])
        us_parts.append(np.asarray(u))
        div_parts.append(np.asarray(dv))
    us = np.concatenate(us_parts, axis=0)
    div = np.concatenate(div_parts, axis=0)
    # retained draws are one per independent chain: for the Rhat check,
    # fold them into pseudo-chains of length n//8 (needs >= 4 per chain)
    m = (n_draws // 8) * 8
    diag = {"divergence_rate": float(np.mean(np.asarray(div)))}
    if m // 8 >= 4:
        pseudo = us[:m].reshape(8, m // 8, us.shape[-1])
        diag["rank_rhat_max"] = float(np.max(rhat_rank(pseudo)))
        diag["ess_bulk_min"] = float(np.min(ess_bulk(pseudo)))
    return np.exp(us[:, :k]), np.exp(us[:, k:]), diag


def generate_datasets(cfg, data, ups_raw, ds, gamma_eval_phi, seed=0):
    """Exact prior-predictive datasets given marginal draws.

    Returns (Z_batch complex (n, N), truths dict of (n,)/(n, E) arrays in
    the model's scaled space — fit with z_scale=1 to compare).

    With ``cfg.outliers`` the per-frequency outlier scales are drawn from
    their exact priors — ``sigma_out_raw ~ Exponential(lambda)``,
    ``sigma_out_scale ~ InvGamma(alpha, beta)`` (reference:
    Series_outliers_modelcode.txt via models/posterior.py:314-319) — and
    the truth vector gains sigma_out at ``outlier_monitor_indices``,
    matching the batch summarizer's monitor columns."""
    import jax
    import jax.numpy as jnp

    n_sets = ups_raw.shape[0]
    L = data.L[0]
    k = L.shape[-1]
    n = data.freq.shape[0]
    rng = np.random.default_rng(seed)

    def gen_one(ups_raw_i, ds_i, key):
        ups = 0.15 * ups_raw_i
        w = 1.0 / ups**2
        m = (ds_i[0] * (L[0].T * w) @ L[0] + ds_i[1] * (L[1].T * w) @ L[1]
             + ds_i[2] * (L[2].T * w) @ L[2])
        chol = jnp.linalg.cholesky(m)
        # split count is conditional so the plain-Series stream stays
        # bit-identical to the committed round-4 SBC runs
        if cfg.outliers:
            k1, k2, k3, k4, k5 = jax.random.split(key, 5)
        else:
            k1, k2, k3 = jax.random.split(key, 3)
        # x_raw ~ N(0, M^{-1}): x = chol^{-T} xi
        xi = jax.random.normal(k1, (k,), dtype=chol.dtype)
        x_raw = jax.scipy.linalg.solve_triangular(chol.T, xi, lower=False)
        # half-normal scalars, exactly the model's constrain() scaling
        hn = jnp.abs(jax.random.normal(k2, (6,), dtype=chol.dtype))
        c = {
            "x_0": x_raw * data.x_scales[0],
            "Rinf": 100.0 * hn[0],
            "induc": hn[1] * data.induc_scale,
            "sigma_res": 0.05 * hn[2],
            "alpha_prop": 0.05 * hn[3],
            "alpha_re": 0.05 * hn[4],
            "alpha_im": 0.05 * hn[5],
        }
        truth_extra = jnp.zeros((0,), chol.dtype)
        if cfg.outliers:
            so_raw = (jax.random.exponential(k4, (n,), dtype=chol.dtype)
                      / data.sigma_out_lambda)
            g = jax.random.gamma(k5, data.sigma_out_alpha, (n,),
                                 dtype=chol.dtype)
            so_scale = data.sigma_out_beta / g
            c["sigma_out"] = so_raw * so_scale * 0.05
            idx = jnp.asarray(outlier_monitor_indices(n))
            truth_extra = c["sigma_out"][idx]
        pred = predict_target(cfg, data, c)
        st = sigma_tot(cfg, data, c, pred)
        y = pred + st * jax.random.normal(k3, pred.shape, dtype=pred.dtype)
        truth = jnp.concatenate([
            jnp.stack([c[s] for s in MONITOR_SCALARS]),
            gamma_eval_phi @ c["x_0"], truth_extra])
        return y, truth

    import jax.random as jrandom
    keys = jrandom.split(jrandom.PRNGKey(rng.integers(2**31)), n_sets)
    ys, truths = jax.jit(jax.vmap(gen_one))(
        jnp.asarray(ups_raw, data.target.dtype),
        jnp.asarray(ds, data.target.dtype), keys)
    ys = np.asarray(ys)
    z = ys[:, :n] + 1j * ys[:, n:]
    return z, np.asarray(truths)


def monitor_ess(monitor_draws, chains):
    """Per-monitor bulk ESS of stored (possibly unthinned) monitor draws.

    monitor_draws: (n_sets, chains*per_chain, n_mon), chain-major (the
    layout _make_summarize writes). Returns (n_sets, n_mon) ESS estimates
    via FFT autocovariance with Geyer's initial-positive-sequence
    truncation, chains pooled within each dataset. Used to CHOOSE the SBC
    monitor thinning from measurement instead of a guessed stride."""
    md = np.asarray(monitor_draws, np.float64)
    n_sets, L, n_mon = md.shape
    s = L // chains
    x = md.reshape(n_sets, chains, s, n_mon)
    xc = x - x.mean(axis=2, keepdims=True)
    nfft = 1
    while nfft < 2 * s:
        nfft *= 2
    f = np.fft.rfft(xc, n=nfft, axis=2)
    acov = np.fft.irfft(f * np.conj(f), n=nfft, axis=2)[:, :, :s].real / s
    # chains pooled within dataset; guard zero-variance monitors
    rho = acov.mean(axis=1) / np.maximum(acov[:, :, :1].mean(axis=1), 1e-300)
    ess = np.empty((n_sets, n_mon))
    for i in range(n_sets):
        for j in range(n_mon):
            r = rho[i, :, j]
            # Geyer: sum consecutive lag pairs while positive
            m = (s - 1) // 2 * 2
            pair = (r[1:1 + m].reshape(-1, 2).sum(axis=1)
                    if m >= 2 else np.empty(0))
            k = 0
            while k < len(pair) and pair[k] > 0:
                k += 1
            tau = 1.0 + 2.0 * r[1:1 + 2 * k].sum() if k else 1.0
            ess[i, j] = chains * s / max(tau, 1.0)
    return ess


def sbc_ranks(truths, monitor_draws):
    """Rank of each true value among its thinned posterior draws.
    truths: (n_sets, n_mon); monitor_draws: (n_sets, L, n_mon).
    Returns integer ranks in {0..L}, shape (n_sets, n_mon)."""
    return np.sum(np.asarray(monitor_draws) < truths[:, None, :], axis=1)


def rank_uniformity(ranks, n_levels, n_bins=10):
    """Chi-squared rank-uniformity test per monitor (Talts et al. 2018).
    ranks: (n_sets, n_mon) in {0..n_levels}. Returns (p_values (n_mon,),
    chi2 (n_mon,))."""
    from scipy.stats import chi2 as chi2_dist

    ranks = np.asarray(ranks)
    n_sets, n_mon = ranks.shape
    edges = np.linspace(0, n_levels + 1, n_bins + 1)
    # ranks live on the discrete support {0..n_levels}; when n_bins does not
    # divide n_levels+1 the equal-width bins hold unequal numbers of support
    # points (e.g. 101 values into 16 bins -> 6 or 7 per bin), so a flat
    # n_sets/n_bins expectation adds a deterministic noncentrality to the
    # chi2 statistic. Use the exact per-bin expected counts instead.
    support_counts, _ = np.histogram(np.arange(n_levels + 1), bins=edges)
    expected = n_sets * support_counts / (n_levels + 1)
    stats = np.empty(n_mon)
    for j in range(n_mon):
        counts, _ = np.histogram(ranks[:, j], bins=edges)
        stats[j] = np.sum((counts - expected) ** 2 / expected)
    return chi2_dist.sf(stats, n_bins - 1), stats


def ecdf_envelope_violations(ranks, n_levels, alpha=0.05):
    """Fraction of monitors whose rank-ECDF leaves a pointwise
    (Dvoretzky-Kiefer-Wolfowitz) confidence band — a visual-free stand-in
    for the ECDF-envelope plots of Sailynoja et al. 2022."""
    ranks = np.asarray(ranks)
    n_sets, n_mon = ranks.shape
    eps = np.sqrt(np.log(2.0 / alpha) / (2 * n_sets))
    grid = np.arange(n_levels + 1)
    viol = np.zeros(n_mon, dtype=bool)
    for j in range(n_mon):
        ecdf = np.searchsorted(np.sort(ranks[:, j]), grid, side="right") / n_sets
        ideal = (grid + 1) / (n_levels + 1)
        viol[j] = np.any(np.abs(ecdf - ideal) > eps + 1.0 / (n_levels + 1))
    return viol
