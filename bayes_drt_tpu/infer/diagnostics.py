"""MCMC diagnostics: split-Rhat and bulk ESS.

The reference has no diagnostics beyond Stan's console output; these power
the ESS/sec benchmark metric (BASELINE.json) and convergence checks in the
Inverter API. Host-side numpy (FFT autocorrelation with Geyer's initial
positive sequence) — diagnostics run once per fit, not in the hot path.
"""

from __future__ import annotations

import numpy as np


def split_chains(draws):
    """(chains, draws, ...) -> (2*chains, draws//2, ...)"""
    draws = np.asarray(draws)
    c, n = draws.shape[:2]
    half = n // 2
    return np.concatenate([draws[:, :half], draws[:, half:2 * half]], axis=0)


def rhat(draws) -> np.ndarray:
    """Split-Rhat (Gelman et al.). draws: (chains, n, dim) -> (dim,)."""
    x = split_chains(draws)
    c, n = x.shape[:2]
    chain_mean = x.mean(axis=1)
    chain_var = x.var(axis=1, ddof=1)
    w = chain_var.mean(axis=0)
    b = n * chain_mean.var(axis=0, ddof=1)
    var_plus = (n - 1) / n * w + b / n
    return np.sqrt(var_plus / np.where(w > 0, w, 1.0))


def _autocov_fft(x):
    """Per-chain autocovariance via FFT. x: (c, n, d)."""
    c, n, d = x.shape
    xc = x - x.mean(axis=1, keepdims=True)
    m = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(xc, n=m, axis=1)
    acov = np.fft.irfft(f * np.conj(f), n=m, axis=1)[:, :n].real
    return acov / n


def ess(draws) -> np.ndarray:
    """Bulk effective sample size. draws: (chains, n, dim) -> (dim,)."""
    x = split_chains(np.asarray(draws, dtype=float))
    c, n, d = x.shape
    if n < 4:
        return np.full(d, float(c * n))
    acov = _autocov_fft(x)                      # (c, n, d)
    chain_var = acov[:, 0]                      # biased var (ddof=0)
    mean_var = chain_var.mean(axis=0) * n / (n - 1.0)
    var_plus = mean_var * (n - 1.0) / n + x.mean(axis=1).var(axis=0, ddof=1)
    var_plus = np.where(var_plus > 0, var_plus, 1.0)

    rho = 1.0 - (mean_var - acov.mean(axis=0)) / var_plus   # (n, d)
    rho[0] = 1.0

    out = np.empty(d)
    for j in range(d):
        # Geyer initial monotone positive sequence: pair (rho_0 + rho_1),
        # (rho_2 + rho_3), ... — positivity/monotonicity hold only for this
        # even-odd pairing
        t = 0
        pair_sums = []
        while t + 1 < n:
            s = rho[t, j] + rho[t + 1, j]
            if s < 0:
                break
            pair_sums.append(s)
            t += 2
        # enforce monotone decrease
        for i in range(1, len(pair_sums)):
            pair_sums[i] = min(pair_sums[i], pair_sums[i - 1])
        tau = -1.0 + 2.0 * sum(pair_sums)
        tau = max(tau, 1.0 / np.log10(c * n + 10.0))
        out[j] = c * n / tau
    return out


def ess_jnp(draws):
    """Bulk ESS as a pure-jnp program: (chains, n, d) -> (d,).

    Same estimator as :func:`ess` (split chains, FFT autocovariance, Geyer
    initial monotone positive sequence) but jit/vmap-compatible so it can
    run ON DEVICE inside a batched sampling program — the data-dependent
    truncation becomes a masked prefix (cumprod of the pair-positivity
    flags) and the monotone enforcement a cumulative minimum. Matches the
    numpy version to float tolerance; powers the in-program min-ESS
    diagnostics of fit_spectra_batch (BASELINE.json's headline metric is
    HMC ESS/sec, reference: Stan's sampling output, inversion.py:1218-1221).
    """
    import jax
    import jax.numpy as jnp

    x = draws
    c0, n0 = x.shape[0], x.shape[1]
    half = n0 // 2
    x = jnp.concatenate([x[:, :half], x[:, half:2 * half]], axis=0)
    c, n = 2 * c0, half
    if n < 4:
        return jnp.full(x.shape[-1], float(c * n), x.dtype)

    xc = x - x.mean(axis=1, keepdims=True)
    m = int(2 ** np.ceil(np.log2(2 * n)))
    f = jnp.fft.rfft(xc, n=m, axis=1)
    acov = jnp.fft.irfft(f * jnp.conj(f), n=m, axis=1)[:, :n].real / n

    chain_var = acov[:, 0]                                   # (c, d)
    mean_var = chain_var.mean(axis=0) * n / (n - 1.0)
    var_plus = mean_var * (n - 1.0) / n + x.mean(axis=1).var(axis=0, ddof=1)
    var_plus = jnp.where(var_plus > 0, var_plus, 1.0)

    rho = 1.0 - (mean_var - acov.mean(axis=0)) / var_plus    # (n, d)
    rho = rho.at[0].set(1.0)

    n_pairs = n // 2
    pair = rho[0:2 * n_pairs:2] + rho[1:2 * n_pairs:2]       # (n_pairs, d)
    # initial positive sequence: keep the maximal prefix of nonneg pair sums
    kept = jnp.cumprod((pair >= 0).astype(rho.dtype), axis=0)
    # monotone decrease over the kept prefix (masked entries sit at +inf so
    # they never lower the running minimum, and are zeroed out of the sum)
    mono = jax.lax.cummin(jnp.where(kept > 0, pair, jnp.inf), axis=0)
    tau = -1.0 + 2.0 * jnp.sum(jnp.where(kept > 0, mono, 0.0), axis=0)
    tau = jnp.maximum(tau, 1.0 / np.log10(c * n + 10.0))
    return c * n / tau


def _rank_normalize(x):
    """Fractional-rank inverse-normal transform (Vehtari et al. 2021 eq. 14):
    z = Phi^-1((r - 3/8)/(S + 1/4)) with average ranks for ties, pooled over
    all chains and draws. x: (c, n, d) -> (c, n, d)."""
    from scipy.special import ndtri
    from scipy.stats import rankdata
    c, n, d = x.shape
    r = rankdata(x.reshape(c * n, d), axis=0, method="average")
    return ndtri((r - 0.375) / (c * n + 0.25)).reshape(c, n, d)


def rhat_rank(draws) -> np.ndarray:
    """Rank-normalized split-Rhat (Vehtari et al. 2021): the max of split-Rhat
    on rank-normalized draws (bulk) and on rank-normalized folded draws
    |x - median| (tails). This is what modern Stan/arviz report; the plain
    :func:`rhat` is kept for continuity. draws: (chains, n, dim) -> (dim,)."""
    x = np.asarray(draws, dtype=float)
    z = _rank_normalize(x)
    folded = np.abs(x - np.median(x.reshape(-1, x.shape[-1]), axis=0))
    zf = _rank_normalize(folded)
    return np.maximum(rhat(z), rhat(zf))


def ess_bulk(draws) -> np.ndarray:
    """Bulk ESS on rank-normalized draws (Vehtari et al. 2021).
    draws: (chains, n, dim) -> (dim,)."""
    return ess(_rank_normalize(np.asarray(draws, dtype=float)))


def ess_tail(draws) -> np.ndarray:
    """Tail ESS (Vehtari et al. 2021): the minimum of the ESS of the 5% and
    95% quantile indicator functions. draws: (chains, n, dim) -> (dim,)."""
    x = np.asarray(draws, dtype=float)
    flat = x.reshape(-1, x.shape[-1])
    out = None
    for q in (0.05, 0.95):
        ind = (x <= np.quantile(flat, q, axis=0)).astype(float)
        e = ess(ind)
        out = e if out is None else np.minimum(out, e)
    return out


def _rank_normalize_jnp(x):
    """Device-side rank-normal transform: ordinal ranks via double argsort
    (ties are measure-zero for continuous draws), pooled over chains+draws.
    x: (c, n, d) -> (c, n, d)."""
    import jax.numpy as jnp
    from jax.scipy.special import ndtri
    c, n, d = x.shape
    flat = x.reshape(c * n, d)
    ranks = jnp.argsort(jnp.argsort(flat, axis=0), axis=0) + 1
    z = ndtri((ranks.astype(x.dtype) - 0.375) / (c * n + 0.25))
    return z.reshape(c, n, d)


def _split_rhat_jnp(x):
    """Plain split-Rhat as a jnp program. x: (c, n, d) -> (d,)."""
    import jax.numpy as jnp
    half = x.shape[1] // 2
    xs = jnp.concatenate([x[:, :half], x[:, half:2 * half]], axis=0)
    n = half
    cm = xs.mean(axis=1)
    w = xs.var(axis=1, ddof=1).mean(axis=0)
    b = n * cm.var(axis=0, ddof=1)
    var_plus = (n - 1) / n * w + b / n
    return jnp.sqrt(var_plus / jnp.maximum(w, jnp.finfo(x.dtype).tiny))


def _map_param_chunks(fn, draws, d_chunk):
    """Apply a per-parameter diagnostic ``fn((c, n, chunk)) -> (chunk,)``
    sequentially over parameter blocks with ``lax.map``. Every estimator
    here treats parameters independently, so chunking is exact; it exists
    to bound the FFT/argsort workspace — at 4 chains x 500 draws x D~211 x
    B=1024 the all-parameters-at-once form needs several 3.3 GB device
    temps and ran out of a 16 GB accelerator's memory."""
    import jax
    import jax.numpy as jnp
    c, n, d = draws.shape
    n_chunks = -(-d // d_chunk)
    pad = n_chunks * d_chunk - d
    x = jnp.concatenate([draws, draws[:, :, :1].repeat(pad, axis=2)],
                        axis=2) if pad else draws
    x = x.reshape(c, n, n_chunks, d_chunk)
    out = jax.lax.map(fn, jnp.moveaxis(x, 2, 0))     # (n_chunks, d_chunk)
    return out.reshape(-1)[:d]


def rhat_rank_jnp(draws, d_chunk=None):
    """Rank-normalized split-Rhat as a pure-jnp program so it can run ON
    DEVICE inside batched sampling programs (same estimator as
    :func:`rhat_rank`; ordinal instead of average ranks — identical for
    continuous draws). draws: (chains, n, d) -> (d,). ``d_chunk`` bounds
    device memory by running parameter blocks sequentially (exact)."""
    import jax.numpy as jnp

    def _all(x):
        z = _rank_normalize_jnp(x)
        med = jnp.median(x.reshape(-1, x.shape[-1]), axis=0)
        zf = _rank_normalize_jnp(jnp.abs(x - med))
        return jnp.maximum(_split_rhat_jnp(z), _split_rhat_jnp(zf))

    if d_chunk is None or d_chunk >= draws.shape[-1]:
        return _all(draws)
    return _map_param_chunks(_all, draws, d_chunk)


def ess_bulk_jnp(draws, d_chunk=None):
    """Bulk ESS (rank-normalized) as a pure-jnp program.
    draws: (chains, n, d) -> (d,). ``d_chunk`` bounds device memory by
    running parameter blocks sequentially (exact)."""
    if d_chunk is None or d_chunk >= draws.shape[-1]:
        return ess_jnp(_rank_normalize_jnp(draws))
    return _map_param_chunks(
        lambda x: ess_jnp(_rank_normalize_jnp(x)), draws, d_chunk)


def e_bfmi(energy) -> float:
    """Energy Bayesian fraction of missing information (Betancourt 2016):
    Var(dE)/Var(E) per chain, averaged. Values < ~0.3 flag poor energy-set
    exploration. energy: (chains, n) or (n,)."""
    e = np.atleast_2d(np.asarray(energy, dtype=float))
    num = np.mean(np.diff(e, axis=1) ** 2, axis=1)
    den = np.var(e, axis=1)
    return float(np.mean(num / np.where(den > 0, den, 1.0)))


def summary(draws) -> dict:
    """Per-parameter posterior summary. draws: (chains, n, dim)."""
    x = np.asarray(draws)
    flat = x.reshape(-1, x.shape[-1])
    return {
        "mean": flat.mean(axis=0),
        "sd": flat.std(axis=0, ddof=1),
        "q2.5": np.percentile(flat, 2.5, axis=0),
        "q97.5": np.percentile(flat, 97.5, axis=0),
        "rhat": rhat(x),
        "ess": ess(x),
        "rhat_rank": rhat_rank(x),
        "ess_bulk": ess_bulk(x),
        "ess_tail": ess_tail(x),
    }
