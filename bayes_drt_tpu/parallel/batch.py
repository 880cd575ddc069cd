"""Massively batched inversion over spectra and chains.

The reference processes spectra in a serial Python loop with one Stan
subprocess per chain (reference: inversion.py:1218, code_EchemActa/
"Run fits.ipynb" batch loops). Here the whole batch is ONE XLA program:

    vmap over spectra  x  vmap over chains  x  NUTS/L-BFGS

and, on several devices, the spectra/chain axes are sharded over a
jax.sharding.Mesh so each device samples its shard independently — no
inter-device communication inside a fit (spectra are independent);
collectives appear only if results are gathered.
"""

from __future__ import annotations

import warnings
from functools import partial
from typing import NamedTuple, Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.matrices import (construct_A, construct_L, construct_M,
                            default_epsilon, get_tau_basis)
from ..models.build import (build_posterior, sort_distributions,
                            z_scale_for)
from ..models.posterior import (constrain, init_unconstrained, log_density,
                                outlier_monitor_indices, predict_target)
from ..infer.diagnostics import ess_bulk_jnp, ess_jnp, rhat_rank_jnp
from ..infer.chees import (ChEESConfig, SHMCConfig, sample_chees,
                           sample_shmc)
from ..infer.nuts import NUTSConfig, sample_nuts
from ..infer.map import newton_polish, run_lbfgs
from ..infer.ridge import (HyperLambdaConfig, RidgeData,
                           run_hyper_lambda, run_hyper_weights,
                           run_ordinary_ridge)
from ..progcache import (cached_program as _cached_program,
                         data_shapes, precise_matmuls)


def _pad_rows(arr, b):
    """Pad the leading (spectra) axis to b rows by repeating the first row
    (matches _pad_pow2's padding of the spectra themselves)."""
    if arr.shape[0] == b:
        return arr
    pad = np.repeat(arr[:1], b - arr.shape[0], axis=0)
    return np.concatenate([arr, pad], axis=0)


def _pad_pow2(Z_batch, min_size: int = 8):
    """Pad the batch to the next power of two (>= min_size) by repeating the
    first spectrum. Batch runtime is nearly flat in B, and padding means a
    handful of compiled program shapes cover every batch size — important
    because each new shape costs a full XLA compile."""
    b = Z_batch.shape[0]
    target = min_size
    while target < b:
        target *= 2
    if target == b:
        return Z_batch, b
    pad = np.repeat(Z_batch[:1], target - b, axis=0)
    return np.concatenate([Z_batch, pad], axis=0), b



class BatchFitResult(NamedTuple):
    """Results for a batch of spectra."""
    coef: np.ndarray          # (B, K) posterior-mean (sample) or MAP coefficients, rescaled
    r_inf: np.ndarray         # (B,)
    inductance: np.ndarray    # (B,)
    gamma_lo: Optional[np.ndarray]   # (B, K) 2.5th percentile coefs (sample mode)
    gamma_hi: Optional[np.ndarray]   # (B, K) 97.5th percentile coefs
    z_scales: np.ndarray      # (B,)
    tau: np.ndarray           # (K,)
    epsilon: float
    diagnostics: dict
    basis: str = "gaussian"   # RBF family the coefficients live in


# named sampler presets for fit_spectra_batch(quality=...). 'fast' is the
# bench.py production config, held to bench.py's quality gates; 'strict' is
# the calibrated-interval config certified by tests on its convergence
# diagnostics (benchmarks/sweep_strict.py). Throughput and gates on the
# current hardware are in PERF.md.
QUALITY_PRESETS = {
    "fast": dict(
        sampler="shmc", ncp=True, chains=4, warmup=150, samples=250,
        shmc_cfg=SHMCConfig(n_steps=32, warm_steps=32, leaf_unroll=2,
                            draw_unroll=2, recompute_grad=True,
                            eps_quantile=0.5, precision="high")),
    # md8, not Stan's md10: the DRT posterior's trajectories saturate at
    # ~255 leapfrogs (md8), so md10 only multiplies the per-draw cost
    # (benchmarks/sweep_strict.py). An earlier run, whose record is gone,
    # measured at B=32 with --escalate: gamma RMSE 0.71% Rp, coverage
    # 0.997, logp split-Rhat p50 1.08 / p90 1.18, divergence 0.4%.
    "strict": dict(
        sampler="nuts", ncp=True, chains=4, warmup=1000, samples=1000,
        max_tree_depth=8, tree_scan=True, scan_unroll=2),
}


def setup_device():
    """The device the one-time setup (matrix construction, ridge seeding)
    runs on: the host CPU backend, so an accelerator compiles only the
    fitting programs. The CPU backend is always initialised alongside an
    accelerator backend unless JAX_PLATFORMS excludes it; then there is no
    host device and this raises, rather than moving the setup elsewhere."""
    try:
        return jax.devices("cpu")[0]
    except RuntimeError as exc:
        raise RuntimeError(
            "bayes_drt_tpu builds its matrices on the host CPU backend; "
            "include 'cpu' in JAX_PLATFORMS (e.g. JAX_PLATFORMS=cuda,cpu)"
        ) from exc


def _cpu_context():
    """Run the enclosed setup on ``setup_device()``."""
    return jax.default_device(setup_device())


def _make_summarize(cfg, unravel, chains, samples, n_dists,
                    monitor_thin: int = 0):
    """Per-spectrum posterior summary computed ON DEVICE from the chain
    draws: posterior means/percentiles, convergence scalars (logp split-Rhat,
    divergence/accept/leapfrog stats), per-spectrum bulk ESS of logp and of
    gamma at monitor points (ESS/sec is the BASELINE headline metric — a
    throughput number is meaningless without it), optional TRUE pointwise
    gamma credible bands, and the sampler state for chained refits. Shared
    by fit_spectra_batch and fit_spectra_ragged.

    ``monitor_thin`` > 0 additionally returns thinned per-draw monitor
    values (Rinf, induc, sigma_res, alpha_prop, alpha_re, alpha_im, gamma at
    the ``gamma_eval_tau`` points) under ``monitor_draws`` — the raw
    material for rank statistics (simulation-based calibration)."""

    def summarize(dat, draws, info, phi_mon, phi_eval):
        flat = draws.reshape(-1, draws.shape[-1])
        xs = jax.vmap(lambda q: constrain(cfg, dat, unravel(q))["x_0"])(flat)
        rinf = jax.vmap(lambda q: constrain(cfg, dat, unravel(q))["Rinf"])(flat)
        induc = jax.vmap(lambda q: constrain(cfg, dat, unravel(q))["induc"])(flat)
        # split-Rhat of the per-chain log density: a cheap scalar
        # convergence check per spectrum
        lp = info["logp"]                             # (chains, samples)
        half = lp.shape[1] // 2
        lp_split = jnp.concatenate([lp[:, :half], lp[:, half:2 * half]])
        cm = lp_split.mean(axis=1)
        w_var = lp_split.var(axis=1, ddof=1).mean()
        b_var = half * cm.var(ddof=1)
        var_plus = (half - 1) / half * w_var + b_var / half
        lp_rhat = jnp.sqrt(var_plus / jnp.maximum(w_var, 1e-12))
        # absolute between-chain log-density gap (nats): max over chains of
        # (best chain mean logp - chain mean logp). A chain whose retained
        # draws sit K >> 1 nats below the best chain contributes e^-K
        # posterior weight — it is STUCK in a spurious local mode, not
        # exploring an alternative explanation. Unlike split-Rhat this is
        # budget-independent (healthy 4-chain gaps are ~2 nats even at
        # screening budgets; the BimodalBP-DDT Y~0 trap sits ~800 nats
        # below, benchmarks/probe_bpddt.py), so it can gate escalation at
        # every budget.
        cmeans = lp.mean(axis=1)
        lp_gap = cmeans.max() - cmeans.min()
        out = {
            "coef": xs.mean(axis=0),
            "coef_lo": jnp.percentile(xs, 2.5, axis=0),
            "coef_hi": jnp.percentile(xs, 97.5, axis=0),
            "r_inf": rinf.mean(),
            "induc": induc.mean(),
            "divergence_rate": info["diverging"].mean(),
            "accept_prob": info["accept_prob"].mean(),
            "n_leapfrog": info["n_leapfrog"].astype(jnp.float32).mean(),
            "logp_rhat": lp_rhat,
            "logp_chain_gap": lp_gap,
            # sampler state for chained refits (warm_start=): final
            # positions, adapted metric, and adapted step size per chain
            "state_q": draws[:, -1, :],
            "state_inv_mass": info["inv_mass"],
            "state_step_size": info["step_size"],
        }
        gmon = (xs @ phi_mon.T).reshape(chains, samples, -1)
        mon = jnp.concatenate([lp[:, :, None], gmon], axis=-1)
        ess_q = ess_jnp(mon)
        out["ess_logp"] = ess_q[0]
        out["min_ess"] = ess_q.min()
        # per-parameter rank-normalized diagnostics (Vehtari et al. 2021)
        # over ALL unconstrained parameters: rank statistics are invariant
        # under monotone per-parameter transforms, so these equal the
        # constrained-space values Stan users see for the (monotone)
        # constrain maps, and they measure the sampler's mixing in its own
        # space for the rest (ncp products). The worst-parameter bulk ESS
        # actually discriminates where the monitor-based min_ess saturates.
        # d_chunk=32 runs parameter blocks sequentially (exact): at the
        # B=1024 x 4x500 draws x D~211 the unchunked FFT/argsort
        # workspace is several 3.3 GB device temps and OOMs
        out["rank_rhat_max"] = rhat_rank_jnp(draws, d_chunk=32).max()
        out["ess_bulk_min"] = ess_bulk_jnp(draws, d_chunk=32).min()
        # metric-normalized slow-direction detector: largest eigenvalue of
        # the posterior covariance in the adapted metric's coordinates
        # (power iteration on the pooled, per-chain-centered draws). A
        # diagonal metric equalizes MARGINAL scales, so lambda_max ~ 1 for
        # near-independent posteriors; a strong correlation ridge (the 2RC
        # double-delta class, benchmarks/probe_2rc.py) leaves a slow
        # direction the metric cannot see — lambda_max >> 1 — which is
        # exactly when a fixed-length trajectory under-mixes. Between-chain
        # scatter (chains centered on the GLOBAL mean) keeps the detector
        # live even when within-chain movement along the ridge is slow.
        im = info["inv_mass"]                     # (chains, D) diagonal,
        if im.ndim == 3:                          # or (chains, D, D) dense
            im = jnp.diagonal(im, axis1=-2, axis2=-1)
        y = (draws - draws.reshape(-1, draws.shape[-1]).mean(0)) \
            / jnp.sqrt(jnp.maximum(im, 1e-30))[:, None, :]
        yf = y.reshape(-1, y.shape[-1])
        nrm = yf.shape[0] - 1

        def piter(v, _):
            w = yf.T @ (yf @ v) / nrm
            return w / (jnp.linalg.norm(w) + 1e-30), jnp.linalg.norm(w)

        v0 = jnp.ones((yf.shape[1],), yf.dtype) / jnp.sqrt(yf.shape[1])
        _, lams = jax.lax.scan(piter, v0, None, length=24)
        out["metric_lambda_max"] = lams[-1]
        if phi_eval.shape[0] > 0:
            ge = xs @ phi_eval.T
            out["gamma_eval_mean"] = ge.mean(axis=0)
            out["gamma_eval_lo"] = jnp.percentile(ge, 2.5, axis=0)
            out["gamma_eval_hi"] = jnp.percentile(ge, 97.5, axis=0)
        if not cfg.fitY:
            # posterior-predictive impedance at f_train: the MEAN OVER DRAWS
            # of the per-draw model prediction — Stan's generated-quantities
            # semantics (reference: Parallel_modelcode.txt:76-81, and the
            # committed Zout_*.csv are this at f_train). For parallel
            # distributions Z depends on x through an elementwise complex
            # INVERSION, so Z(E[x]) != E[Z(x)]: under multimodal mixing
            # (distinct chains in different nuisance modes, e.g. the
            # BimodalBP-DDT cells, benchmarks/probe_bpddt.py) the
            # mean-coefficient reconstruction can cross Y ~ 0 and blow up by
            # orders of magnitude while every individual draw fits the data.
            preds = jax.vmap(
                lambda q: predict_target(cfg, dat, constrain(cfg, dat,
                                                             unravel(q))))(flat)
            out["z_hat_mean"] = preds.mean(axis=0)
            out["z_hat_std"] = preds.std(axis=0)
        if monitor_thin:
            td = draws[:, monitor_thin - 1::monitor_thin, :]
            td = td.reshape(-1, draws.shape[-1])

            def mon_of(q):
                c = constrain(cfg, dat, unravel(q))
                vals = jnp.stack([c["Rinf"], c["induc"], c["sigma_res"],
                                  c["alpha_prop"], c["alpha_re"],
                                  c["alpha_im"]])
                cols = [vals, phi_eval @ c["x_0"]]
                if cfg.outliers:
                    # sigma_out at fixed frequencies — extra SBC monitors
                    # for the _outliers model variants
                    idx = jnp.asarray(outlier_monitor_indices(
                        c["sigma_out"].shape[0]))
                    cols.append(c["sigma_out"][idx])
                return jnp.concatenate(cols)

            out["monitor_draws"] = jax.vmap(mon_of)(td)
        for i in range(1, n_dists):
            xi = jax.vmap(lambda q: constrain(cfg, dat, unravel(q))[f"x_{i}"])(flat)
            out[f"coef_{i}"] = xi.mean(axis=0)
        return out

    return summarize


def _normalize_distributions(distributions):
    """Light normalization of the mini-DSL with the SAME defaults as
    Inverter.set_distributions, so an under-specified DDT dict yields
    identical matrices and Ystar scaling through both APIs (bc defaults to
    'blocking', NOT construct_A's 'transmissive'). Full validation lives in
    Inverter.set_distributions."""
    if distributions is None:
        return {"DRT": {"kernel": "DRT", "dist_type": "series"}}
    distributions = {k: dict(v) for k, v in distributions.items()}
    for info in distributions.values():
        if info.get("kernel") == "DRT":
            info.setdefault("dist_type", "series")
        else:
            info.setdefault("dist_type", "parallel")
            info.setdefault("symmetry", "planar")
            info.setdefault("bc", "blocking")
            info.setdefault("ct", False)
    return distributions


def _build_shared(frequencies, basis_freq=None, epsilon=None, mode="sample",
                  nonneg=False, dtype=None, distributions=None, ncp=False,
                  basis="gaussian", outliers=False, sigma_min=0.002):
    """Shared per-batch setup: matrices at the common frequency grid for an
    arbitrary distributions dict (default: single series DRT).

    The returned (normalized) distribution dicts additionally carry the
    resolved collocation grid under private keys ``_tau``/``_epsilon`` —
    the geometry ``predict_Z_batch`` needs to rebuild A matrices at new
    frequencies."""
    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    frequencies = np.sort(np.asarray(frequencies, float))[::-1]
    distributions = _normalize_distributions(distributions)

    build_dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    dist_mats = {}
    first_tau, first_eps = None, None
    with _cpu_context():
        for name, info in distributions.items():
            bf = info.get("basis_freq", basis_freq)
            if bf is None:
                tau = get_tau_basis(frequencies)
            else:
                tau = 1.0 / (2 * np.pi * np.asarray(bf, float))
            eps = info.get("epsilon", epsilon)
            eps = default_epsilon(tau) if eps is None else float(eps)
            f_coll = 1.0 / (2 * np.pi * tau)
            kw = dict(tau=tau, epsilon=eps, basis=info.get("basis", basis),
                      kernel=info.get("kernel", "DRT"),
                      dist_type=info["dist_type"],
                      symmetry=info.get("symmetry", "planar"),
                      bc=info.get("bc", "transmissive"),
                      ct=info.get("ct", False), k_ct=info.get("k_ct", None),
                      dtype=build_dtype)
            mats = {
                "A_re": np.asarray(construct_A(frequencies, "real", **kw)),
                "A_im": np.asarray(construct_A(frequencies, "imag", **kw)),
            }
            for o in (0, 1, 2):
                mats[f"L{o}"] = np.asarray(construct_L(
                    f_coll, tau=tau, epsilon=eps, order=o,
                    basis=info.get("basis", basis), dtype=build_dtype))
            dist_mats[name] = mats
            info["_tau"], info["_epsilon"] = tau, eps
            if first_tau is None:
                first_tau, first_eps = tau, eps

    z_dummy = np.ones(len(frequencies)) + 0j   # replaced per spectrum via vmap
    cfg, data = build_posterior(distributions, dist_mats, frequencies, z_dummy,
                                mode=mode, nonneg=nonneg, dtype=dtype, ncp=ncp,
                                outliers=outliers, sigma_min=sigma_min)
    return frequencies, first_tau, first_eps, cfg, data, distributions


def fit_spectra_batch(frequencies, Z_batch, mode: str = "sample",
                      basis_freq=None, epsilon=None, nonneg: bool = False,
                      outliers: bool = False,
                      chains: int = 4, warmup: int = 500, samples: int = 500,
                      max_iter: int = 2000, n_restarts: int = 2,
                      polish: bool = True,
                      init_from_ridge: bool = False,
                      ridge_kw: Optional[dict] = None,
                      random_seed: int = 0, mesh: Optional[Mesh] = None,
                      max_tree_depth: int = 10, dtype=None,
                      distributions=None, precondition: Optional[str] = None,
                      pilot_warmup: int = 50, pilot_samples: int = 25,
                      ncp: bool = False, unroll: int = 1,
                      flat_tree: bool = False,
                      tree_scan: bool = False,
                      scan_unroll: int = 1,
                      basis: str = "gaussian",
                      gamma_eval_tau=None,
                      monitor_thin: int = 0,
                      z_scale=None, sigma_min: float = 0.002,
                      sampler: str = "nuts", chees_cfg=None, shmc_cfg=None,
                      warm_start: "BatchFitResult" = None,
                      quality: Optional[str] = None,
                      escalate: Optional[bool] = None,
                      escalate_gate: Optional[dict] = None,
                      escalate_kw: Optional[dict] = None) -> BatchFitResult:
    """Fit B spectra sharing one frequency grid in a single XLA program.

    Z_batch: complex array (B, N). mode='sample' runs ``chains`` NUTS chains
    per spectrum; mode='optimize' runs ``n_restarts`` L-BFGS restarts per
    spectrum. With ``mesh`` (axes named 'spectra' [, 'chains']), the batch is
    sharded across devices. ``distributions`` uses the Inverter mini-DSL
    (default: single series DRT); for multi-distribution fits the returned
    ``coef`` holds the first distribution, with the others under
    ``diagnostics['coef_<i>']`` (scaled-space).

    ``precondition='pooled'`` (sample mode): run a short diagonal-metric
    pilot, POOL the pilot draws across every spectrum and chain in the batch
    (centering per chain, so only within-posterior covariance pools) to
    estimate one full-rank dense metric shared by the whole batch, then
    sample with that fixed metric, warm-starting each chain from its pilot
    state. The pooling sidesteps the n_draws >> dim requirement a per-chain
    dense adaptation would have: B*chains*pilot_samples draws estimate one
    (D, D) covariance. Best suited to batches of spectra with similar
    posterior geometry (replicates, parameter sweeps, time series); the
    pilot budget is taken out of ``warmup``, so the total NUTS iterations
    per chain stay warmup+samples.

    ``warm_start`` (sample mode): a previous sample-mode BatchFitResult for
    the SAME batch layout (B, chains, model). Chains resume from that
    fit's final positions with its adapted per-chain metric held fixed
    (step size re-adapts), so a chained refit of slowly-evolving spectra
    (streaming/time-series serving) needs only a small ``warmup``.

    ``quality``: named sampler preset overriding the sampler-choice kwargs
    (sampler/cfg/budget; data/model kwargs are untouched):

    - 'fast'   — the production configuration (SHMC n32/w32,
      eps_quantile=0.5, precision='high', ncp, 4x(150+250)): the bench.py
      config, held to bench.py's recovery gates (batch RMSE < 3% Rp,
      p90 < 5% Rp, 95%-CI coverage > 0.93). Mixing DIAGNOSTICS at this
      budget are screening-grade, not Stan-grade.
    - 'strict' — calibrated-interval configuration (NUTS, ncp, true-f32
      matmuls, long adaptation) with certified per-spectrum convergence;
      see QUALITY_PRESETS and PERF.md.

    ``escalate`` (sample mode): refit spectra that fail a per-spectrum
    mixing gate (worst-parameter bulk ESS, ``escalation_mask``) with an
    adaptive-trajectory sampler — by default NUTS max_depth=8 in true f32
    at the same budget. Default None = ON for the fixed-trajectory
    ``sampler='shmc'`` path (Stan adapts trajectory length per posterior;
    a static trajectory silently under-mixes e.g. the 2RC double-delta
    family — benchmarks/probe_2rc.py), OFF for nuts/chees. The refit is a
    second cached program over only the flagged spectra; clean batches pay
    only the host-side gate check. ``escalate_gate`` overrides threshold
    kwargs of ``escalation_mask``; ``escalate_kw`` overrides the refit's
    sampler kwargs. ``diagnostics['escalated']`` records the mask.

    ``init_from_ridge`` (single-distribution fits): seed the fit from a
    hyper-lambda ridge solution (the single-spectrum
    ``Inverter.fit(init_from_ridge=True)`` semantics, reference:
    inversion.py:1616-1682). In optimize mode, ONE L-BFGS run from the
    init replaces ``n_restarts`` random restarts (series: batched ridge;
    parallel: per-spectrum host ridge). In sample mode, every chain starts
    at the ridge solution's coordinates — the escape hatch for multimodal
    parallel posteriors whose random-init chains stick in the Y~0
    spurious mode (BimodalBP-DDT, benchmarks/probe_bpddt.py); the
    gate-triggered escalation refit applies it automatically. With
    ``outliers=True``, spectra rows whose ridge residual exceeds 3
    standard deviations seed ``sigma_out`` high (z-score variant of the
    reference's IQR check). ``ridge_kw`` overrides the underfitted-ridge
    defaults.
    """
    if quality is not None:
        if quality not in QUALITY_PRESETS:
            raise ValueError(f"Unknown quality preset {quality!r}; options "
                             f"are {sorted(QUALITY_PRESETS)}")
        if mode != "sample":
            raise ValueError("quality presets configure the sampler; use "
                             "mode='sample'")
        p = QUALITY_PRESETS[quality]
        sampler = p["sampler"]
        ncp = p["ncp"]
        chains = p["chains"]
        warmup = p["warmup"]
        samples = p["samples"]
        shmc_cfg = p.get("shmc_cfg", shmc_cfg)
        max_tree_depth = p.get("max_tree_depth", max_tree_depth)
        tree_scan = p.get("tree_scan", tree_scan)
        scan_unroll = p.get("scan_unroll", scan_unroll)

    Z_batch = np.asarray(Z_batch)
    # matrices are built at DESCENDING frequencies (_build_shared); reorder
    # the data columns to match so ascending instrument exports fit correctly
    order = np.argsort(np.asarray(frequencies, float))[::-1]
    frequencies = np.asarray(frequencies, float)[order]
    Z_batch = Z_batch[:, order]
    Z_batch, b_real = _pad_pow2(Z_batch)
    b, n = Z_batch.shape
    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    frequencies, tau, eps, cfg, data, dists_norm = _build_shared(
        frequencies, basis_freq, epsilon, mode="sample" if mode == "sample" else "optimize",
        nonneg=nonneg, dtype=dtype, distributions=distributions,
        ncp=ncp and mode == "sample", basis=basis, outliers=outliers,
        sigma_min=sigma_min)
    n_dists = len(cfg.dists)

    if init_from_ridge:
        if n_dists > 1:
            raise ValueError("Ridge initialization can only be performed "
                             "for single-distribution fits")
        if mode == "sample" and (warm_start is not None
                                 or precondition is not None):
            raise ValueError("init_from_ridge is a cold-start "
                             "initialization; drop warm_start/precondition")

    # per-spectrum scaling, including the calibrated Ystar admittance-std
    # targets for a single parallel planar DDT
    # (reference: inversion.py:2411-2443). z_scale= overrides the data-
    # derived scale (pre-scaled serving batches; simulation-based
    # calibration needs z_scale=1 so the fitted model IS the generative one)
    if z_scale is None:
        z_scales = np.atleast_1d(z_scale_for(dists_norm, Z_batch,
                                             fit_type="map"))
    else:
        zs = np.broadcast_to(np.asarray(z_scale, float), (b_real,))
        z_scales = np.concatenate([zs, np.full(b - b_real, zs[-1])])
    Zs = Z_batch / z_scales[:, None]
    targets = jnp.asarray(np.concatenate([Zs.real, Zs.imag], axis=1), dtype=dtype)

    template = init_unconstrained(cfg, data, jax.random.PRNGKey(0))
    template = jax.tree.map(lambda a: a.astype(dtype), template)
    _, unravel = ravel_pytree(template)
    key = jax.random.PRNGKey(random_seed)
    spectrum_keys = jax.random.split(key, b)
    flat_fit = None        # set by the shmc flat_chain path

    def logp_for(dat, target):
        d = dat._replace(target=target)
        return lambda q: log_density(cfg, d, unravel(q), jacobian=(mode == "sample"))

    def _ridge_init_values():
        """Per-spectrum ridge-seeded init values (numpy, b_real rows): the
        reference's init_from_ridge semantics (inversion.py:1616-1682)
        generalized to the batch — a batched hyper-lambda ridge pass for a
        single SERIES distribution, or per-spectrum admittance ridge fits
        (host loop) for a single PARALLEL distribution. Sampling parallel
        models NEEDS this escape hatch: random-init chains can stick in the
        Y~0 spurious mode ~800 nats below the data-fitting mode (the
        BimodalBP-DDT trap, benchmarks/probe_bpddt.py), where the
        proportional-error term alpha_prop*Z_hat flattens the likelihood."""
        rdefaults = dict(penalty="integral", hyper_lambda=True,
                         lambda_0=1.0, hl_beta=5, weights="modulus")
        rdefaults.update(ridge_kw or {})
        d0 = cfg.dists[0]
        if d0.dist_type == "series":
            rres = ridge_fit_spectra_batch(
                frequencies, Z_batch, basis_freq=basis_freq, epsilon=epsilon,
                basis=basis, **rdefaults)
            # ridge returns b_real rows; re-pad (padding repeats spectrum 0)
            iv_x = _pad_rows(np.asarray(rres.coef), b)
            iv_rinf_t = _pad_rows(np.asarray(rres.r_inf), b)
            iv_induc_t = _pad_rows(np.asarray(rres.inductance), b)
            if iv_x.shape[1] != d0.K:
                raise ValueError(
                    f"ridge init basis ({iv_x.shape[1]}) does not "
                    f"match the fit basis ({d0.K})")
            # into the scaled coordinates (constrain() applies the
            # Rinf*100 / induc transforms; init_unconstrained's iv contract
            # expects the pre-transform values)
            iv_x = iv_x / z_scales[:, None]
            iv_rinf = np.maximum(iv_rinf_t / z_scales, 1e-10) / 100.0
            iv_induc = np.maximum(iv_induc_t / z_scales, 1e-10)
            iv_sig = None
            if outliers:
                n_f = len(np.asarray(data.freq))
                rv = np.concatenate([np.ones(n_f), np.zeros(n_f)])
                lv = np.concatenate([np.zeros(n_f),
                                     2.0 * np.pi * np.asarray(data.freq)])
                zhat = (iv_x @ np.asarray(data.A[0]).T
                        + (iv_rinf * 100.0)[:, None] * rv[None, :]
                        + iv_induc[:, None] * lv[None, :])
                resid = np.asarray(targets) - zhat
                sig = resid.std(axis=1, keepdims=True) + 1e-12
                flag = ((np.abs(resid[:, :n_f]) > 3 * sig)
                        | (np.abs(resid[:, n_f:]) > 3 * sig))
                iv_sig = np.where(flag, 1.0, 0.1)
        else:
            # single parallel distribution: the batched ridge path is
            # series-only, so run the reference-faithful per-spectrum
            # admittance ridge on the host (one-time init math, CPU-cheap)
            from ..inverter import Inverter   # lazy: inverter -> parallel
            name0 = sort_distributions(dists_norm)[0]
            clean = {name0: {k: v for k, v in dists_norm[name0].items()
                             if not k.startswith("_")}}
            iv_x = np.zeros((b_real, d0.K))
            iv_rinf = np.zeros(b_real)
            iv_induc = np.zeros(b_real)
            iv_sig = np.full((b_real, len(np.asarray(data.freq))),
                             0.1) if outliers else None
            with _cpu_context():
                inv = Inverter(distributions=clean, basis_freq=basis_freq,
                               basis=basis, epsilon=epsilon)
                for i in range(b_real):
                    inv.ridge_fit(frequencies, Z_batch[i], **rdefaults)
                    coef = inv.distribution_fits[name0]["coef"]
                    # scaled admittance = z_scale * Y, so parallel
                    # coefficients SCALE UP by z_scale
                    # (reference: inversion.py:2445-2450)
                    iv_x[i] = coef * z_scales[i]
                    iv_rinf[i] = max(float(inv.R_inf) / z_scales[i],
                                     1e-10) / 100.0
                    iv_induc[i] = max(float(inv.inductance) / z_scales[i],
                                      1e-10)
                    if outliers:
                        oidx = inv.check_outliers(frequencies, Z_batch[i],
                                                  threshold=3,
                                                  use_existing_fit=True)
                        iv_sig[i][np.asarray(oidx).ravel()] = 1.0
            iv_x = _pad_rows(iv_x, b)
            iv_rinf = _pad_rows(iv_rinf, b)
            iv_induc = _pad_rows(iv_induc, b)
            if iv_sig is not None:
                iv_sig = _pad_rows(iv_sig, b)
        return iv_x, iv_rinf, iv_induc, iv_sig

    if mode == "sample":
        # basis-evaluation matrices for in-program gamma diagnostics of the
        # FIRST distribution: phi_mon feeds the per-spectrum bulk-ESS monitor
        # (gamma at n_mon points spanning the grid, plus logp); phi_eval
        # (optional, from gamma_eval_tau) yields TRUE pointwise posterior
        # credible bands of gamma(tau) — per-draw evaluation, unlike the
        # conservative per-coefficient coef_lo/hi bands
        from ..ops.basis import get_basis_func
        phi_fn = get_basis_func(basis)
        k0 = len(tau)
        mon_idx = np.unique(np.linspace(0, k0 - 1, 8).astype(int))
        phi_mon_np = np.asarray(phi_fn(
            np.log(tau[mon_idx][:, None] / tau[None, :]), eps))
        if gamma_eval_tau is not None:
            ge_tau = np.asarray(gamma_eval_tau, float)
            phi_eval_np = np.asarray(phi_fn(
                np.log(ge_tau[:, None] / tau[None, :]), eps))
        else:
            phi_eval_np = np.zeros((0, k0))
        phi_mon_j = jnp.asarray(phi_mon_np, dtype)
        phi_eval_j = jnp.asarray(phi_eval_np, dtype)

        nuts_cfg = NUTSConfig(max_depth=max_tree_depth, unroll=unroll,
                              flat_tree=flat_tree,
                              tree_scan=tree_scan, scan_unroll=scan_unroll)

        summarize = _make_summarize(cfg, unravel, chains, samples, n_dists,
                                    monitor_thin=monitor_thin)

        def init_q0s(dat, target, k_init, n):
            p0s = jax.vmap(lambda k: init_unconstrained(
                cfg, dat._replace(target=target), k))(jax.random.split(k_init, n))
            return jax.vmap(lambda p: ravel_pytree(
                jax.tree.map(lambda a: a.astype(dtype), p))[0])(p0s)

        def pooled_summary(dat, draws, info, phi_mon, phi_eval):
            # chees/shmc adapt ONE metric for all chains of a spectrum;
            # broadcast to the per-chain layout warm_start and the shared
            # summarize expect
            info = dict(info)
            info["inv_mass"] = jnp.broadcast_to(
                info["inv_mass"][None, :], (chains,) + info["inv_mass"].shape)
            info["step_size"] = jnp.broadcast_to(info["step_size"], (chains,))
            out = summarize(dat, draws, info, phi_mon, phi_eval)
            if "traj_time" in info:
                out["state_traj_time"] = info["traj_time"]
            return out

        if sampler == "shmc":
            sh_cfg = shmc_cfg if shmc_cfg is not None else SHMCConfig()
            flat_fit = None
            if sh_cfg.flat_chain:
                # ---- flat-chain path: ONE (B*chains, D) chain axis with
                # the hand-written posterior gradient (infer/shmc_flat) ----
                from ..infer.shmc_flat import (FlatShared, flat_shared_for,
                                               flat_spec_for,
                                               sample_shmc_flat)
                if mesh is not None:
                    raise ValueError(
                        "flat_chain does not shard over a mesh "
                        "yet; drop mesh= or use the generic shmc path")
                if warm_start is not None or precondition is not None:
                    raise ValueError("flat_chain does not "
                                     "support warm_start/precondition; use "
                                     "the generic shmc path")
                spec_flat = flat_spec_for(cfg, data)   # raises if ineligible
                shared_flat = flat_shared_for(cfg, data, dtype)

                def flat_fit(targets_b, skeys, dat, phi_mon, phi_eval,
                             s_A, s_L, s_vecs, s_scal):
                    sh = FlatShared(s_A, s_L, s_vecs, s_scal)
                    q0 = jax.vmap(lambda t, k: init_q0s(
                        dat, t, jax.random.split(k)[0], chains))(
                            targets_b, skeys)
                    q0f = q0.reshape(-1, q0.shape[-1])
                    tgt_rows = jnp.repeat(targets_b, chains, axis=0)
                    k_run = jax.random.fold_in(skeys[0], 7)
                    draws, info = sample_shmc_flat(
                        spec_flat, sh, tgt_rows, q0f, k_run, warmup=warmup,
                        samples=samples, cfg=sh_cfg, chains=chains)
                    return jax.vmap(
                        lambda dr, inf: pooled_summary(dat, dr, inf,
                                                       phi_mon, phi_eval)
                    )(draws, info)

            def fit_one(target, skey, dat, phi_mon, phi_eval,
                        q0_override=None):
                logp = logp_for(dat, target)
                k_init, k_run = jax.random.split(skey)
                q0 = (q0_override if q0_override is not None
                      else init_q0s(dat, target, k_init, chains))
                draws, info = sample_shmc(logp, q0, k_run, warmup=warmup,
                                          samples=samples, cfg=sh_cfg)
                return pooled_summary(dat, draws, info, phi_mon, phi_eval)

            prog_extra = ("shmc", sh_cfg, chains, warmup, samples,
                          phi_mon_np.shape, phi_eval_np.shape)
        elif sampler == "chees":
            ch_cfg = chees_cfg if chees_cfg is not None else ChEESConfig()

            def fit_one(target, skey, dat, phi_mon, phi_eval,
                        q0_override=None):
                logp = logp_for(dat, target)
                k_init, k_run = jax.random.split(skey)
                q0 = (q0_override if q0_override is not None
                      else init_q0s(dat, target, k_init, chains))
                draws, info = sample_chees(logp, q0, k_run, warmup=warmup,
                                           samples=samples, cfg=ch_cfg)
                return pooled_summary(dat, draws, info, phi_mon, phi_eval)

            prog_extra = ("chees", ch_cfg, chains, warmup, samples,
                          phi_mon_np.shape, phi_eval_np.shape)
        elif sampler == "nuts":
            def fit_one(target, skey, dat, phi_mon, phi_eval,
                        q0_override=None):
                logp = logp_for(dat, target)

                def one_chain(ckey):
                    k_init, k_run = jax.random.split(ckey)
                    p0 = init_unconstrained(cfg, dat._replace(target=target),
                                            k_init)
                    q0, _ = ravel_pytree(
                        jax.tree.map(lambda a: a.astype(dtype), p0))
                    return sample_nuts(logp, q0, k_run, warmup=warmup,
                                       samples=samples, cfg=nuts_cfg)

                def one_chain_q0(ckey, q0):
                    k_run = jax.random.split(ckey)[1]
                    return sample_nuts(logp, q0, k_run, warmup=warmup,
                                       samples=samples, cfg=nuts_cfg)

                if q0_override is None:
                    draws, info = jax.vmap(one_chain)(
                        jax.random.split(skey, chains))
                else:
                    draws, info = jax.vmap(one_chain_q0)(
                        jax.random.split(skey, chains), q0_override)
                return summarize(dat, draws, info, phi_mon, phi_eval)

            prog_extra = (nuts_cfg, chains, warmup, samples,
                          phi_mon_np.shape, phi_eval_np.shape)
        else:
            raise ValueError(f"Unknown sampler {sampler!r}; options are "
                             "'nuts', 'chees', 'shmc'")
    else:
        def _map_out(dat, res):
            c = constrain(cfg, dat, unravel(res.params))
            out = {
                "coef": c["x_0"],
                "coef_lo": c["x_0"],
                "coef_hi": c["x_0"],
                "r_inf": c["Rinf"],
                "induc": c["induc"],
                "value": res.value,
                "n_iter": res.n_iter.astype(jnp.float32),
                # convergence certificate (MapResult semantics): grad
                # infinity norm at the returned optimum, and whether the
                # run exited on tolerance rather than the iteration cap
                "grad_norm": res.grad_norm,
                "converged": res.converged,
            }
            for i in range(1, n_dists):
                out[f"coef_{i}"] = c[f"x_{i}"]
            return out

        def _polish(loss, res):
            # Newton-certify the optimum: the L-BFGS cap binds before
            # Stan-grade convergence on this posterior (CLAUDE.md); a damped
            # Newton pass on the ~110-dim problem reaches grad-norm <= tol
            # in a few dozen cheap (D, D) factorizations
            if not polish:
                return res
            pol = newton_polish(loss, res.params)
            return pol._replace(n_iter=res.n_iter + pol.n_iter)

        if init_from_ridge:
            # one L-BFGS run from the batched ridge solution (the
            # single-spectrum init_from_ridge semantics,
            # reference: inversion.py:1616-1682); iv arrays are computed
            # host-side below and routed through vmapped jit arguments
            def fit_one(target, skey, *args):
                if outliers:
                    iv_x, iv_rinf, iv_induc, iv_sig, dat = args
                else:
                    iv_x, iv_rinf, iv_induc, dat = args
                    iv_sig = None
                iv = {"x_0": iv_x, "Rinf_raw": iv_rinf, "induc_raw": iv_induc}
                if iv_sig is not None:
                    iv["sigma_out_raw"] = iv_sig
                logp = logp_for(dat, target)
                loss = lambda q: -logp(q)
                p0 = init_unconstrained(cfg, dat._replace(target=target),
                                        skey, init_values=iv)
                q0, _ = ravel_pytree(
                    jax.tree.map(lambda a: a.astype(dtype), p0))
                res = _polish(loss, run_lbfgs(loss, q0, max_iter=max_iter))
                return _map_out(dat, res)

            prog_extra = ("ridge-init", bool(outliers), max_iter, polish)
        else:
            def fit_one(target, skey, dat):
                logp = logp_for(dat, target)
                loss = lambda q: -logp(q)

                def one_restart(rkey):
                    p0 = init_unconstrained(cfg, dat._replace(target=target),
                                            rkey)
                    q0, _ = ravel_pytree(
                        jax.tree.map(lambda a: a.astype(dtype), p0))
                    return run_lbfgs(loss, q0, max_iter=max_iter)

                res = jax.vmap(one_restart)(jax.random.split(skey, n_restarts))
                best = jnp.argmin(jnp.where(jnp.isfinite(res.value),
                                            res.value, jnp.inf))
                res = _polish(loss, jax.tree.map(lambda a: a[best], res))
                return _map_out(dat, res)

            prog_extra = (n_restarts, max_iter, polish)

    base_key = ("fit_spectra_batch", mode, cfg, data_shapes(data),
                prog_extra, monitor_thin, mesh)

    extra_args = ()
    if mode == "sample" and warm_start is not None:
        # ---- chained refit: resume from a previous batch's sampler state ----
        # (production serving: streaming/time-series spectra where the
        # posterior moves slowly between batches — chains start at the last
        # positions with the already-adapted metric fixed and only the step
        # size re-adapting, so ``warmup`` can be a small fraction of a cold
        # start's)
        if precondition is not None:
            raise ValueError("warm_start and precondition are mutually "
                             "exclusive")
        ws = warm_start.diagnostics
        for k in ("state_q", "state_inv_mass", "state_step_size"):
            if k not in ws:
                raise ValueError(
                    "warm_start must be a sample-mode BatchFitResult carrying "
                    f"sampler state (missing diagnostics[{k!r}])")
        if ws.get("state_cfg") is not None and ws["state_cfg"] != cfg:
            raise ValueError(
                "warm_start was sampled under a different model "
                f"configuration ({ws['state_cfg'].model_name()}, "
                f"ncp={ws['state_cfg'].ncp}) than this fit "
                f"({cfg.model_name()}, ncp={cfg.ncp}); resuming across "
                "parameterizations would mix coordinate systems")
        b_prev = np.asarray(ws["state_q"]).shape[0]
        if b_prev != b_real:
            # silently padding a smaller prior batch would seed real spectra
            # with spectrum-0's positions and fixed metric; a larger one
            # would crash deep inside np.repeat
            raise ValueError(
                f"warm_start holds sampler state for {b_prev} spectra but "
                f"this fit has {b_real}; chained refits must keep the batch "
                "layout (same spectra, same order) across calls")
        wq = _pad_rows(np.asarray(ws["state_q"]), b)
        wm = _pad_rows(np.asarray(ws["state_inv_mass"]), b)
        weps = _pad_rows(np.asarray(ws["state_step_size"]), b)
        if wq.shape[1] != chains:
            raise ValueError(f"warm_start carries {wq.shape[1]} chains, "
                             f"this fit requests {chains}")
        if sampler == "shmc":
            warm_sh = (shmc_cfg if shmc_cfg is not None
                       else SHMCConfig())._replace(adapt_mass=False)

            def fit_one(target, skey, wq_, wm_, weps_, dat, phi_mon,
                        phi_eval):   # noqa: F811
                logp = logp_for(dat, target)
                draws, info = sample_shmc(
                    logp, wq_, skey, warmup=warmup, samples=samples,
                    cfg=warm_sh, metric=wm_.mean(axis=0),
                    init_step_size=weps_.mean())
                return pooled_summary(dat, draws, info, phi_mon, phi_eval)

            extra_args = (jnp.asarray(wq, dtype), jnp.asarray(wm, dtype),
                          jnp.asarray(weps, dtype))
            shared_args = (data, phi_mon_j, phi_eval_j)
            fit_in_axes = (0, 0, 0, 0, 0, None, None, None)
            prog_key = base_key + ("warm-shmc", warm_sh, chains, warmup,
                                   samples)
        elif sampler == "chees":
            # resume with the pooled (chains share one) metric/step size and
            # the adapted trajectory time, all held fixed
            warm_ch = (chees_cfg if chees_cfg is not None
                       else ChEESConfig())._replace(adapt_mass=False)
            wtt = np.asarray(ws.get("state_traj_time",
                                    np.full(b_prev, np.nan)))
            if np.any(np.isnan(wtt)):
                raise ValueError(
                    "warm_start for sampler='chees' needs "
                    "diagnostics['state_traj_time'] (a previous chees fit)")
            wtt = _pad_rows(wtt, b)

            def fit_one(target, skey, wq_, wm_, weps_, wtt_, dat, phi_mon,
                        phi_eval):   # noqa: F811
                logp = logp_for(dat, target)
                draws, info = sample_chees(
                    logp, wq_, skey, warmup=warmup, samples=samples,
                    cfg=warm_ch, metric=wm_.mean(axis=0),
                    init_step_size=weps_.mean(), init_traj_time=wtt_)
                return pooled_summary(dat, draws, info, phi_mon, phi_eval)

            extra_args = (jnp.asarray(wq, dtype), jnp.asarray(wm, dtype),
                          jnp.asarray(weps, dtype), jnp.asarray(wtt, dtype))
            shared_args = (data, phi_mon_j, phi_eval_j)
            fit_in_axes = (0, 0, 0, 0, 0, 0, None, None, None)
            prog_key = base_key + ("warm-chees", warm_ch, chains, warmup,
                                   samples)
        else:
            warm_cfg = nuts_cfg._replace(adapt_mass=False)

            def fit_one(target, skey, wq_, wm_, weps_, dat, phi_mon, phi_eval):   # noqa: F811
                logp = logp_for(dat, target)

                def one_chain(ckey, q0, m_inv_c, eps_c):
                    return sample_nuts(logp, q0, ckey, warmup=warmup,
                                       samples=samples, cfg=warm_cfg,
                                       metric=m_inv_c, init_step_size=eps_c)

                draws, info = jax.vmap(one_chain)(jax.random.split(skey, chains),
                                                  wq_, wm_, weps_)
                return summarize(dat, draws, info, phi_mon, phi_eval)

            extra_args = (jnp.asarray(wq, dtype), jnp.asarray(wm, dtype),
                          jnp.asarray(weps, dtype))
            shared_args = (data, phi_mon_j, phi_eval_j)
            fit_in_axes = (0, 0, 0, 0, 0, None, None, None)
            prog_key = base_key + ("warm", warm_cfg, chains, warmup, samples)
    elif mode == "sample" and precondition == "pooled":
        if sampler in ("chees", "shmc"):
            raise ValueError(
                "precondition='pooled' builds a dense metric; "
                "sample_chees/sample_shmc support diagonal metrics only "
                "(their chain-pooled Welford adaptation replaces the pooled "
                "pilot). Use sampler='nuts' or drop precondition.")
        # ---- stage 1: short diagonal-metric pilot over the whole batch ----
        def pilot_one(target, skey, dat):
            logp = logp_for(dat, target)

            def one_chain(ckey):
                k_init, k_run = jax.random.split(ckey)
                p0 = init_unconstrained(cfg, dat._replace(target=target), k_init)
                q0, _ = ravel_pytree(jax.tree.map(lambda a: a.astype(dtype), p0))
                draws, _ = sample_nuts(logp, q0, k_run, warmup=pilot_warmup,
                                       samples=pilot_samples, cfg=nuts_cfg)
                return draws

            return jax.vmap(one_chain)(jax.random.split(skey, chains))

        def build_pilot():
            fn = jax.vmap(pilot_one, in_axes=(0, 0, None))
            if mesh is not None:
                return jax.jit(fn,
                               out_shardings=NamedSharding(mesh, P("spectra")))
            return jax.jit(fn)

        if mesh is not None:
            sh = NamedSharding(mesh, P("spectra", None))
            targets = jax.device_put(targets, sh)
            spectrum_keys = jax.device_put(spectrum_keys, sh)
        pilot_fn = _cached_program(
            base_key + ("pilot", pilot_warmup, pilot_samples), build_pilot)
        pilot = pilot_fn(targets, spectrum_keys, data)
        q0_main = pilot[:, :, -1, :]

        # ---- pooled within-chain covariance -> one shared dense metric ----
        # centering per (spectrum, chain) removes the between-spectra mean
        # scatter, so only within-posterior covariance pools; the cholesky
        # runs in float64 on the host for stability
        d64 = np.asarray(pilot, np.float64)
        centered = d64 - d64.mean(axis=2, keepdims=True)
        flat_d = centered.reshape(-1, d64.shape[-1])
        dof = max(d64.shape[0] * d64.shape[1] * (d64.shape[2] - 1), 1)
        cov = flat_d.T @ flat_d / dof
        dim = cov.shape[0]
        jitter = max(1e-6 * float(np.mean(np.diag(cov))), 1e-12)
        for _ in range(8):
            try:
                chol64 = np.linalg.cholesky(cov + jitter * np.eye(dim))
                break
            except np.linalg.LinAlgError:
                jitter *= 10.0
        else:
            raise RuntimeError("pooled pilot covariance is not positive "
                               "definite; use precondition=None")
        m_inv_j = jnp.asarray(cov + jitter * np.eye(dim), dtype)
        chol_j = jnp.asarray(chol64, dtype)

        main_warmup = max(20, warmup - pilot_warmup - pilot_samples)
        main_cfg = NUTSConfig(max_depth=max_tree_depth, adapt_mass=False,
                              unroll=unroll, flat_tree=flat_tree,
                              tree_scan=tree_scan,
                              scan_unroll=scan_unroll)

        def fit_one(target, skey, q0c, dat, m_inv, chol, phi_mon, phi_eval):  # noqa: F811 — pooled-path override
            logp = logp_for(dat, target)

            def one_chain(ckey, q0):
                # the shared metric is passed with in_axes=None, NOT vmapped:
                # one (D, D) matrix for the whole batch, so velocity updates
                # become matmuls with no per-element metric traffic
                return sample_nuts(logp, q0, ckey, warmup=main_warmup,
                                   samples=samples, cfg=main_cfg,
                                   metric=(m_inv, chol))

            draws, info = jax.vmap(one_chain)(jax.random.split(skey, chains),
                                              q0c)
            return summarize(dat, draws, info, phi_mon, phi_eval)

        spectrum_keys = jax.vmap(lambda k: jax.random.fold_in(k, 1))(spectrum_keys)
        extra_args = (q0_main,)
        shared_args = (data, m_inv_j, chol_j, phi_mon_j, phi_eval_j)
        fit_in_axes = (0, 0, 0, None, None, None, None, None)
        prog_key = base_key + ("pooled-main", main_cfg, main_warmup, samples)
    else:
        prog_key = base_key
        if mode == "sample":
            shared_args = (data, phi_mon_j, phi_eval_j)
            fit_in_axes = (0, 0, None, None, None)
            if flat_fit is not None:
                shared_args = shared_args + tuple(shared_flat)
            if init_from_ridge:
                if flat_fit is not None:
                    raise ValueError("init_from_ridge does not support "
                                     "flat_chain; use the "
                                     "generic sampler paths")
                # host-side ridge pass -> per-spectrum chain starting
                # positions (every chain starts at the ridge solution's
                # coordinates, non-overridden params Stan-random — the
                # single-spectrum Inverter.fit(init_from_ridge=True)
                # semantics, reference: inversion.py:1616-1682)
                iv_x, iv_rinf, iv_induc, iv_sig = _ridge_init_values()
                with _cpu_context():
                    def q0_for_spectrum(t_row, sk, ivx, ivr, ivl, ivs):
                        iv = {"x_0": ivx, "Rinf_raw": ivr, "induc_raw": ivl}
                        if ivs is not None:
                            iv["sigma_out_raw"] = ivs
                        ks = jax.random.split(
                            jax.random.fold_in(sk, 977), chains)
                        p0s = jax.vmap(lambda k: init_unconstrained(
                            cfg, data._replace(target=t_row), k,
                            init_values=iv))(ks)
                        return jax.vmap(lambda p: ravel_pytree(
                            jax.tree.map(lambda a: a.astype(dtype),
                                         p))[0])(p0s)

                    q0_init = jnp.stack([
                        q0_for_spectrum(
                            targets[i], spectrum_keys[i], iv_x[i],
                            iv_rinf[i], iv_induc[i],
                            None if iv_sig is None else iv_sig[i])
                        for i in range(b)])
                extra_args = (q0_init.astype(dtype),)
                fit_in_axes = (0, 0, 0, None, None, None)
                prog_key = base_key + ("ridge-init-q0",)
                _inner_fit = fit_one

                def fit_one(target, skey, q0c, dat, phi_mon, phi_eval):  # noqa: F811 — ridge-init arg order
                    return _inner_fit(target, skey, dat, phi_mon, phi_eval,
                                      q0_override=q0c)
        elif init_from_ridge:
            # ---- host-side ridge init pass (series: batched; parallel:
            # per-spectrum host loop) ----
            iv_x, iv_rinf, iv_induc, iv_sig = _ridge_init_values()
            extra_args = (jnp.asarray(iv_x, dtype),
                          jnp.asarray(iv_rinf, dtype),
                          jnp.asarray(iv_induc, dtype))
            if iv_sig is not None:
                extra_args = extra_args + (jnp.asarray(iv_sig, dtype),)
            shared_args = (data,)
            fit_in_axes = (0, 0) + (0,) * len(extra_args) + (None,)
        else:
            shared_args = (data,)
            fit_in_axes = (0, 0, None)

    def build_fit():
        if flat_fit is not None:
            # the flat path handles the batch axis itself (one fused
            # trajectory launch per draw for ALL spectra x chains)
            return jax.jit(flat_fit)
        fn = jax.vmap(fit_one, in_axes=fit_in_axes)
        if mesh is not None:
            return jax.jit(fn, out_shardings=NamedSharding(mesh, P("spectra")))
        return jax.jit(fn)

    if mesh is not None:
        targets = jax.device_put(targets, NamedSharding(mesh, P("spectra", None)))
        spectrum_keys = jax.device_put(spectrum_keys,
                                       NamedSharding(mesh, P("spectra", None)))
        extra_args = tuple(
            jax.device_put(a, NamedSharding(mesh, P(*(["spectra"]
                                                      + [None] * (a.ndim - 1)))))
            for a in extra_args)
    batched = _cached_program(prog_key, build_fit)

    out = batched(targets, spectrum_keys, *extra_args, *shared_args)
    shard_layout = None
    if mesh is not None:
        # record where the result actually lives so callers/tests can verify
        # the batch was partitioned across the mesh (device id -> row range)
        shard_layout = tuple(sorted(
            (s.device.id, s.index[0].start or 0, s.index[0].stop or b)
            for s in out["coef"].addressable_shards))
    out = {k: np.asarray(v)[:b_real] for k, v in out.items()}
    z_scales = z_scales[:b_real]

    # rescale per distribution type: series coefficients multiply by the
    # Z scale, parallel (admittance) coefficients divide
    # (reference: inversion.py:2445-2450)
    def rescale(i):
        if cfg.dists[i].dist_type == "parallel":
            return 1.0 / z_scales[:, None]
        return z_scales[:, None]

    scale0 = rescale(0)
    diagnostics = {k: out[k] for k in out
                   if k not in ("coef", "coef_lo", "coef_hi", "r_inf", "induc")}
    # resolved per-distribution geometry in cfg order (series first, then
    # parallel, each name-sorted — the order coef/coef_<i> follow), so
    # predict_Z_batch can rebuild A matrices at arbitrary frequencies
    diagnostics["dist_geometry"] = tuple(
        {"name": nm, "kernel": dists_norm[nm].get("kernel", "DRT"),
         "dist_type": dists_norm[nm]["dist_type"],
         "symmetry": dists_norm[nm].get("symmetry", "planar"),
         "bc": dists_norm[nm].get("bc", "transmissive"),
         "ct": dists_norm[nm].get("ct", False),
         "k_ct": dists_norm[nm].get("k_ct", None),
         "basis": dists_norm[nm].get("basis", basis),
         "tau": dists_norm[nm]["_tau"],
         "epsilon": dists_norm[nm]["_epsilon"]}
        for nm in sort_distributions(dists_norm))
    if mode == "sample":
        # static model config alongside the sampler state, so warm_start can
        # refuse resumes across parameterizations
        diagnostics["state_cfg"] = cfg
    if shard_layout is not None:
        diagnostics["shard_layout"] = shard_layout
    for i in range(1, n_dists):
        if f"coef_{i}" in diagnostics:
            diagnostics[f"coef_{i}"] = diagnostics[f"coef_{i}"] * rescale(i)
    for k_ge in ("gamma_eval_mean", "gamma_eval_lo", "gamma_eval_hi"):
        if k_ge in diagnostics:
            diagnostics[k_ge] = diagnostics[k_ge] * scale0
    # posterior-mean Z_hat is in scaled impedance space (stacked re|im)
    for k_z in ("z_hat_mean", "z_hat_std"):
        if k_z in diagnostics:
            diagnostics[k_z] = diagnostics[k_z] * z_scales[:, None]
    if "z_hat_mean" in diagnostics:
        # training grid (descending), so predict_Z_batch can serve the
        # draws-mean prediction at f_train (Stan generated-quantities
        # parity) instead of reconstructing from mean coefficients
        diagnostics["f_train"] = np.asarray(frequencies, float)
    if "monitor_draws" in diagnostics:
        # columns: Rinf, induc (impedance units) | sigma_res, alpha_prop,
        # alpha_re, alpha_im (left in scaled space) | gamma at eval taus
        # (dist-0 coefficient scale) | sigma_out monitors (impedance units
        # — an impedance-space noise scale, NOT a coefficient, so it scales
        # by z_scales like Rinf, not by scale0)
        md = diagnostics["monitor_draws"].copy()
        n_eval = 0 if gamma_eval_tau is None else len(np.asarray(gamma_eval_tau))
        md[:, :, :2] *= z_scales[:, None, None]
        md[:, :, 6:6 + n_eval] *= scale0[:, None, :]
        md[:, :, 6 + n_eval:] *= z_scales[:, None, None]
        diagnostics["monitor_draws"] = md
    result = BatchFitResult(
        coef=out["coef"] * scale0,
        r_inf=out["r_inf"] * z_scales,
        inductance=out["induc"] * z_scales,
        gamma_lo=out["coef_lo"] * scale0 if mode == "sample" else None,
        gamma_hi=out["coef_hi"] * scale0 if mode == "sample" else None,
        z_scales=z_scales, tau=tau, epsilon=eps, diagnostics=diagnostics,
        basis=dists_norm[next(iter(dists_norm))].get("basis", basis))

    # ---- reduced-precision guard ----
    # precision='high' lets the backend run f32 matmuls in a cheaper
    # emulation (TF32 on NVIDIA GPUs). An earlier run, whose record is gone,
    # found such a mode at equal quality on the verified DRT families but
    # 0.01-0.02*Rp worse on unusually sharp posteriors (the 2RC double-delta
    # cells at n_steps=128). Rather than trust an allowlist, measure the
    # gradient discrepancy this posterior induces at the points the chains
    # ended at; the guard keys on the precision the fit asked for, whatever
    # the backend (on CPU both precisions agree and the probe reads ~0).
    if (mode == "sample" and sampler == "shmc" and flat_fit is None
            and sh_cfg.precision == "high"
            and "state_q" in diagnostics):
        qp = jnp.asarray(_pad_rows(np.asarray(diagnostics["state_q"]), b),
                         dtype)
        probe_fn = _cached_program(
            base_key + ("high-precision-probe",),
            lambda: jax.jit(_high_precision_probe_program(cfg, unravel)))
        err = np.asarray(probe_fn(targets, qp, data))[:b_real]
        diagnostics["high_grad_err"] = err
        # deterministic regime guard: 'high' was only ever certified for the
        # production SCREENING configuration; at long trajectories / strict
        # sampling budgets it degraded sharp posteriors (2RC n128 full
        # budget: 8/10 vs f32 10/10 within the gates) — warn exactly in that
        # regime instead of trusting a threshold the endpoint probe cannot
        # calibrate (see HIGH_GRAD_TOL note)
        if sh_cfg.n_steps > HIGH_WARN_STEPS or samples > HIGH_WARN_SAMPLES:
            warnings.warn(
                f"precision='high' (reduced-precision matmuls) at n_steps="
                f"{sh_cfg.n_steps}/samples={samples} is outside the "
                "verified screening regime: on sharp posteriors it costs "
                "0.01-0.02*Rp at long trajectories (the 2RC n128 "
                "regression, 8/10 vs f32 10/10); use "
                "SHMCConfig(precision='highest') for final runs "
                f"(measured grad discrepancy p50 "
                f"{float(np.median(err)):.1e}, max {float(err.max()):.1e})")

    # ---- gate-triggered escalation: refit the under-mixed tail ----
    # Stan's NUTS adapts trajectory length per posterior automatically
    # (reference: inversion.py:1218-1221 hands every spectrum to the same
    # adaptive sampler); the production SHMC path runs a FIXED trajectory,
    # which silently under-mixes posteriors with one slow direction (the
    # 2RC double-delta family: recovery monotone in trajectory length,
    # benchmarks/probe_2rc.py). Parity here means the default entry point
    # detects that tail in-program and escalates it — only the flagged
    # spectra pay the adaptive sampler's cost.
    if (mode == "sample" and escalate is None):
        # default ON for the fixed-trajectory production sampler (a NUTS
        # refit adds trajectory adaptivity) AND for single-distribution
        # NUTS fits (a ridge-seeded refit escapes multimodal traps NUTS
        # trajectories cannot — the BimodalBP-DDT Y~0 mode,
        # benchmarks/probe_bpddt.py; for multi-dist NUTS the refit would
        # only reseed, so it stays opt-in)
        escalate = (warm_start is None and flat_fit is None
                    and (sampler == "shmc"
                         or (sampler == "nuts" and n_dists == 1
                             and not init_from_ridge)))
    if mode == "sample" and escalate:
        gate_kw = dict(n_draws=chains * samples)
        gate_kw.update(escalate_gate or {})
        esc_mask = escalation_mask(diagnostics, b_real, **gate_kw)
        diagnostics["escalated"] = esc_mask
        if esc_mask.any():
            esc_kw = dict(sampler="nuts", max_tree_depth=8, tree_scan=True,
                          scan_unroll=2, ncp=ncp)
            if n_dists == 1:
                # seed the refit's chains from a ridge solution: stuck
                # chains (the logp_chain_gap gate) are an INITIALIZATION
                # pathology, not a trajectory-length one
                esc_kw["init_from_ridge"] = True
            esc_kw.update(escalate_kw or {})
            sub_z_scale = None
            if z_scale is not None:
                sub_z_scale = np.broadcast_to(
                    np.asarray(z_scale, float), (b_real,))[esc_mask]
            ge_tau_sub = gamma_eval_tau
            warnings.warn(
                f"{int(esc_mask.sum())}/{b_real} spectra failed the mixing "
                f"gate; refitting them with "
                f"{esc_kw.get('sampler', 'nuts')} (escalate=False disables)")
            sub = fit_spectra_batch(
                frequencies, Z_batch[:b_real][esc_mask], mode="sample",
                basis_freq=basis_freq, epsilon=epsilon, nonneg=nonneg,
                outliers=outliers, chains=chains, warmup=warmup,
                samples=samples,
                random_seed=random_seed + 1, distributions=distributions,
                basis=basis, gamma_eval_tau=ge_tau_sub,
                monitor_thin=monitor_thin, z_scale=sub_z_scale,
                sigma_min=sigma_min, escalate=False, **esc_kw)
            result = _splice_results(result, sub, esc_mask)
    return result


# mixing-gate thresholds for the automatic escalation pass. The values come
# from an earlier run, whose record is gone, over the full 80-cell
# committed-reference sweep at the production SHMC config
# (benchmarks/paper_batch.py): the failing 2RC double-delta cells separated
# from every healthy cell by the worst-parameter bulk ESS — the slow
# direction is a PARAMETER-space direction, invisible to the logp monitor
# (the 3 failing cells sat at logp split-Rhat 1.55-1.87 while healthy cells
# ranged to 23). Re-checking them on the current hardware is open
# (ROADMAP.md).
ESCALATE_ESS_BULK_MIN = 2.0

# precision='high' gradient-discrepancy probe: relative L2 error of the
# log-density gradient under 'high' vs true-f32 ('highest') matmuls,
# evaluated at the chains' final positions; recorded as
# diagnostics['high_grad_err'] for every precision='high' SHMC fit. In the
# same earlier sweep the raw endpoint discrepancy was CONFOUNDED by
# posterior sharpness (healthy noiseless cells reached 0.27 while the 2RC
# regression cells sat at 0.013-0.036), so it is NOT a default escalation
# gate (tol=inf = opt-in via escalate_gate=dict(high_tol=...)); the
# ENFORCED guard is the deterministic regime warning (long trajectories /
# strict budgets — where the 2RC n128 regression appeared: 8/10 vs f32
# 10/10 within the gates).
HIGH_GRAD_TOL = np.inf
HIGH_WARN_STEPS = 64              # n_steps above which 'high' warns
HIGH_WARN_SAMPLES = 400           # samples above which 'high' warns


ESCALATE_LOGP_GAP = 100.0         # nats; stuck-chain detector, active at
                                  # Stan-grade budgets (>= ESCALATE_MIN_
                                  # DRAWS draws) where converged healthy
                                  # chains sit within ~40 nats while the
                                  # BP-DDT trap sits ~800 below — see
                                  # escalation_mask docstring
ESCALATE_LOGP_RHAT = 4.5          # absolute gate (strict budgets)
ESCALATE_MIN_DRAWS = 1600         # chains*samples below which the logp
                                  # gate is OFF: split-Rhat is mechanically
                                  # high at screening budgets (bench median
                                  # ~2.6 at 4x250 vs ~1.5 at 4x500) and
                                  # recovery there is certified by
                                  # SBC/coverage, not by Rhat
ESCALATE_LAMBDA_MAX = np.inf      # NON-discriminating in the earlier
                                  # sweep: healthy ill-identified
                                  # (noiseless) posteriors reached lambda
                                  # ~4e4 while the 2RC failure class sat at
                                  # 855-2693 — recorded as a diagnostic,
                                  # not a default gate


def escalation_mask(diagnostics, b_real, ess_bulk_min=None,
                    high_tol=None, logp_rhat=None, lambda_max=None,
                    n_draws=None, logp_gap=None):
    """Per-spectrum under-mixing flags from in-program diagnostics.

    Returns a boolean (b_real,) mask flagging spectra where any of:

    - between-chain mean-logp gap (``logp_chain_gap``) above
      ESCALATE_LOGP_GAP nats — a stuck-chain detector: a chain K nats
      below the best carries e^-K posterior weight, so a 100+ nat gap at
      a converged budget is never legitimate multimodality (healthy
      full-budget gaps are ~<40 nats; the BimodalBP-DDT Y~0 trap sits
      ~800 nats below, benchmarks/probe_bpddt.py). Budget-aware by
      default (screening-budget funnel chains freeze at legitimately
      different logp levels); an explicit ``logp_gap=`` applies
      unconditionally;

    - worst-parameter bulk ESS (rank-normalized, Vehtari et al. 2021)
      below its floor — catastrophic non-mixing;
    - logp split-Rhat above the absolute gate, only at Stan-grade budgets
      (chains*samples >= ESCALATE_MIN_DRAWS; split-Rhat is mechanically
      high at screening budgets) — chains sitting at different density
      levels. Calibration: every posterior-predictive-Z disagreement vs
      the reference's committed Stan fits had logp_rhat >= 4.95 while the
      healthy full-budget population's median sits ~1.5 (a batch-RELATIVE
      rule was tried and dropped: small per-family batches of
      mostly-pathological spectra push their own median past the gate;
      values from the earlier sweep noted at ESCALATE_ESS_BULK_MIN);
    - metric-normalized slow-direction eigenvalue (``metric_lambda_max``)
      above its gate — OPT-IN (default off): measured non-discriminating
      as a universal gate because healthy ill-identified posteriors are
      equally wide (see ESCALATE_LAMBDA_MAX note), but useful on
      populations known to be well-identified;
    - the reduced-precision gradient-discrepancy probe
      (``diagnostics['high_grad_err']``, present for precision='high'
      SHMC fits) above its tolerance — also OPT-IN by default (the raw
      endpoint-gradient discrepancy is confounded by posterior sharpness;
      see the precision='high' regime warning for the enforced guard)."""
    if ess_bulk_min is None:
        ess_bulk_min = ESCALATE_ESS_BULK_MIN
    if high_tol is None:
        high_tol = HIGH_GRAD_TOL
    if lambda_max is None:
        lambda_max = ESCALATE_LAMBDA_MAX
    ess = np.asarray(diagnostics["ess_bulk_min"])[:b_real]
    mask = ess < ess_bulk_min
    if "logp_chain_gap" in diagnostics:
        gap = np.asarray(diagnostics["logp_chain_gap"])[:b_real]
        if logp_gap is None:
            # budget-aware like the logp_rhat gate: at screening budgets
            # (short warmup) healthy funnel chains freeze at legitimately
            # different logp levels (bench-config ZARC: gap p50 ~77,
            # max ~620 nats) and the gate cannot discriminate; at
            # Stan-grade budgets chains converge in distribution and the
            # stuck-mode gap (~800 nats, benchmarks/probe_bpddt.py)
            # separates cleanly from healthy (~<40)
            if n_draws is None or n_draws >= ESCALATE_MIN_DRAWS:
                mask = mask | (gap > ESCALATE_LOGP_GAP)
        else:
            mask = mask | (gap > logp_gap)
    lp = np.asarray(diagnostics["logp_rhat"])[:b_real]
    if logp_rhat is None:
        if n_draws is None or n_draws >= ESCALATE_MIN_DRAWS:
            mask = mask | (lp > ESCALATE_LOGP_RHAT)
    else:
        mask = mask | (lp > logp_rhat)
    if "metric_lambda_max" in diagnostics:
        mask = mask | (np.asarray(
            diagnostics["metric_lambda_max"])[:b_real] > lambda_max)
    if "high_grad_err" in diagnostics:
        mask = mask | (np.asarray(diagnostics["high_grad_err"])[:b_real]
                       > high_tol)
    return np.asarray(mask, bool)


def _high_precision_probe_program(cfg, unravel):
    """Per-spectrum relative L2 discrepancy of grad(log density) under
    'high' vs true-f32 ('highest') matmuls, max over the probe
    points (one per chain). jax.default_matmul_precision is a trace-time
    context, so both gradients live in ONE jitted program."""
    def probe(targets_b, qpts, dat):
        def one(target, qc):
            d = dat._replace(target=target)

            def f(q):
                return log_density(cfg, d, unravel(q), jacobian=True)

            def gp(q):
                with jax.default_matmul_precision("high"):
                    gh = jax.grad(f)(q)
                with jax.default_matmul_precision("highest"):
                    gf = jax.grad(f)(q)
                return (jnp.linalg.norm(gh - gf)
                        / (jnp.linalg.norm(gf) + 1e-30))

            return jax.vmap(gp)(qc).max()

        return jax.vmap(one)(targets_b, qpts)

    return probe


def _splice_results(result, sub, mask):
    """Overwrite the masked rows of ``result`` with ``sub``'s rows (the
    escalation refit). Array fields and per-spectrum diagnostics splice;
    non-array / non-batch diagnostics keep the primary run's values."""
    idx = np.flatnonzero(mask)
    b = result.coef.shape[0]

    def splice(a, s):
        a = np.array(a, copy=True)
        a[idx] = s
        return a

    diag = dict(result.diagnostics)
    for k, v in sub.diagnostics.items():
        cur = diag.get(k)
        if (isinstance(cur, np.ndarray) and isinstance(v, np.ndarray)
                and cur.ndim >= 1 and cur.shape[0] == b
                and v.shape[:1] == (len(idx),)
                and cur.shape[1:] == v.shape[1:]):
            diag[k] = splice(cur, v)
    diag["escalated"] = np.asarray(mask, bool)
    return result._replace(
        coef=splice(result.coef, sub.coef),
        r_inf=splice(result.r_inf, sub.r_inf),
        inductance=splice(result.inductance, sub.inductance),
        gamma_lo=(splice(result.gamma_lo, sub.gamma_lo)
                  if result.gamma_lo is not None else None),
        gamma_hi=(splice(result.gamma_hi, sub.gamma_hi)
                  if result.gamma_hi is not None else None),
        z_scales=splice(result.z_scales, sub.z_scales),
        diagnostics=diag)


def fit_spectra_ragged(spectra, mode: str = "sample", basis_freq=None,
                       epsilon=None, nonneg: bool = False,
                       outliers: bool = False, chains: int = 4,
                       warmup: int = 500, samples: int = 500,
                       max_iter: int = 2000, n_restarts: int = 2,
                       random_seed: int = 0, mesh: Optional[Mesh] = None,
                       max_tree_depth: int = 10, dtype=None,
                       distributions=None,
                       ncp: bool = False, unroll: int = 1,
                       flat_tree: bool = False,
                       tree_scan: bool = False,
                       scan_unroll: int = 1,
                       basis: str = "gaussian",
                       gamma_eval_tau=None, sigma_min: float = 0.002,
                       sampler: str = "nuts", chees_cfg=None, shmc_cfg=None,
                       warm_start: "BatchFitResult" = None) -> BatchFitResult:
    """Fit spectra with DIFFERENT frequency grids in one XLA program.

    ``spectra``: list of (frequencies, Z) pairs. Grids are padded to a
    common length and masked out of the likelihood; every spectrum gets its
    own A matrices over shared per-distribution bases (the padded/bucketed
    heterogeneity strategy from SURVEY.md section 7). ``basis_freq``
    defaults to 10 ppd spanning the union of all measured ranges plus one
    decade each side.

    Full parity with fit_spectra_batch: ``distributions`` mini-DSL (incl.
    the calibrated Ystar scaling for a single parallel planar DDT),
    ``sampler='chees'``, ``gamma_eval_tau`` pointwise credible bands,
    per-spectrum min-ESS/logp-Rhat diagnostics, ``warm_start`` chained
    refits, and physical mesh partitioning with a shard-layout proof.
    """
    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    b_real_in = len(spectra)
    freqs = [np.sort(np.asarray(f, float))[::-1] for f, _ in spectra]
    zs = [np.asarray(z)[np.argsort(np.asarray(f, float))[::-1]]
          for f, z in spectra]
    # pad the BATCH like fit_spectra_batch (few compiled shapes) and the
    # grids to a multiple of 16
    b = max(8, 1 << (b_real_in - 1).bit_length())
    if b > b_real_in:
        freqs = freqs + [freqs[0]] * (b - b_real_in)
        zs = zs + [zs[0]] * (b - b_real_in)
    b_real = b_real_in
    lens = np.array([len(f) for f in freqs])
    n_max = int(-(-lens.max() // 16) * 16)

    dists_norm = _normalize_distributions(distributions)
    names = sort_distributions(dists_norm)

    f_hi = max(f.max() for f in freqs)
    f_lo = min(f.min() for f in freqs)
    if basis_freq is None:
        tmin = np.log10(1 / (2 * np.pi * f_hi)) - 1
        tmax = np.log10(1 / (2 * np.pi * f_lo)) + 1
        default_tau = np.logspace(tmin, tmax, int(10 * (tmax - tmin) + 1))
    else:
        default_tau = 1.0 / (2 * np.pi * np.asarray(basis_freq, float))

    # pad grids (dummy = last real frequency, masked out of the likelihood)
    freq_pad = np.stack([np.concatenate([f, np.full(n_max - len(f), f[-1])])
                         for f in freqs])
    mask = np.stack([np.concatenate([np.ones(len(f)), np.zeros(n_max - len(f))])
                     for f in freqs])
    # per-spectrum scale incl. the Ystar admittance-std branch
    # (reference: inversion.py:2411-2443)
    z_scales = np.array([float(z_scale_for(dists_norm, z, fit_type="map"))
                         for z in zs])
    z_pad = np.stack([np.concatenate([z / s_, np.zeros(n_max - len(z))])
                      for z, s_ in zip(zs, z_scales)])
    targets = np.concatenate([z_pad.real, z_pad.imag], axis=1)
    masks2 = np.concatenate([mask, mask], axis=1)

    build_dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    A_stacks = []
    dist_mats = {}
    first_tau, first_eps, first_basis = None, None, basis
    with _cpu_context():
        fp = jnp.asarray(freq_pad, build_dtype)
        for nm in names:
            info = dists_norm[nm]
            bf = info.get("basis_freq", None)
            tau_d = (default_tau if bf is None
                     else 1.0 / (2 * np.pi * np.asarray(bf, float)))
            eps_d = info.get("epsilon", epsilon)
            eps_d = default_epsilon(tau_d) if eps_d is None else float(eps_d)
            f_coll = 1.0 / (2 * np.pi * tau_d)
            basis_d = info.get("basis", basis)
            kw = dict(tau=jnp.asarray(tau_d, build_dtype), epsilon=eps_d,
                      basis=basis_d, kernel=info.get("kernel", "DRT"),
                      dist_type=info["dist_type"],
                      symmetry=info.get("symmetry", "planar"),
                      bc=info.get("bc", "transmissive"),
                      ct=info.get("ct", False), k_ct=info.get("k_ct", None),
                      dtype=build_dtype)
            batched_A = jax.vmap(lambda f, part: construct_A(f, part, **kw),
                                 in_axes=(0, None))
            A_re_d = np.asarray(batched_A(fp, "real"))
            A_im_d = np.asarray(batched_A(fp, "imag"))
            A_stacks.append(np.concatenate([A_re_d, A_im_d], axis=1))
            mats = {"A_re": A_re_d[0], "A_im": A_im_d[0]}
            for o in (0, 1, 2):
                mats[f"L{o}"] = np.asarray(construct_L(
                    f_coll, tau=tau_d, epsilon=eps_d, order=o, basis=basis_d,
                    dtype=build_dtype))
            dist_mats[nm] = mats
            if first_tau is None:
                first_tau, first_eps, first_basis = tau_d, eps_d, basis_d

    cfg, data0 = build_posterior(dists_norm, dist_mats, freq_pad[0],
                                 z_pad[0], mode="sample" if mode == "sample"
                                 else "optimize", nonneg=nonneg, dtype=dtype,
                                 ncp=ncp and mode == "sample",
                                 outliers=outliers, sigma_min=sigma_min)
    n_dists = len(cfg.dists)

    template = jax.tree.map(lambda a: a.astype(dtype),
                            init_unconstrained(cfg, data0, jax.random.PRNGKey(0)))
    _, unravel = ravel_pytree(template)
    keys = jax.random.split(jax.random.PRNGKey(random_seed), b)
    tau, eps = first_tau, first_eps

    if mode == "sample":
        from ..ops.basis import get_basis_func
        phi_fn = get_basis_func(first_basis)
        k0 = len(tau)
        mon_idx = np.unique(np.linspace(0, k0 - 1, 8).astype(int))
        phi_mon_np = np.asarray(phi_fn(
            np.log(tau[mon_idx][:, None] / tau[None, :]), eps))
        if gamma_eval_tau is not None:
            ge_tau = np.asarray(gamma_eval_tau, float)
            phi_eval_np = np.asarray(phi_fn(
                np.log(ge_tau[:, None] / tau[None, :]), eps))
        else:
            phi_eval_np = np.zeros((0, k0))
        phi_mon_j = jnp.asarray(phi_mon_np, dtype)
        phi_eval_j = jnp.asarray(phi_eval_np, dtype)

        nuts_cfg = NUTSConfig(max_depth=max_tree_depth, unroll=unroll,
                              flat_tree=flat_tree,
                              tree_scan=tree_scan, scan_unroll=scan_unroll)
        ch_cfg = chees_cfg if chees_cfg is not None else ChEESConfig()
        sh_cfg = shmc_cfg if shmc_cfg is not None else SHMCConfig()
        if sampler not in ("nuts", "chees", "shmc"):
            raise ValueError(f"Unknown sampler {sampler!r}; options are "
                             "'nuts', 'chees', 'shmc'")
        summarize = _make_summarize(cfg, unravel, chains, samples, n_dists)

        def init_q0s(d, k_init, n):
            p0s = jax.vmap(lambda k: init_unconstrained(cfg, d, k))(
                jax.random.split(k_init, n))
            return jax.vmap(lambda p: ravel_pytree(
                jax.tree.map(lambda a: a.astype(dtype), p))[0])(p0s)

        def pooled_summary(d, draws, info, phi_mon, phi_eval):
            info = dict(info)
            info["inv_mass"] = jnp.broadcast_to(
                info["inv_mass"][None, :], (chains,) + info["inv_mass"].shape)
            info["step_size"] = jnp.broadcast_to(info["step_size"], (chains,))
            out = summarize(d, draws, info, phi_mon, phi_eval)
            if "traj_time" in info:
                out["state_traj_time"] = info["traj_time"]
            return out

        def run_plain(d, skey, phi_mon, phi_eval):
            logp = lambda q: log_density(cfg, d, unravel(q), jacobian=True)
            if sampler in ("chees", "shmc"):
                k_init, k_run = jax.random.split(skey)
                q0 = init_q0s(d, k_init, chains)
                if sampler == "chees":
                    draws, info = sample_chees(logp, q0, k_run, warmup=warmup,
                                               samples=samples, cfg=ch_cfg)
                else:
                    draws, info = sample_shmc(logp, q0, k_run, warmup=warmup,
                                              samples=samples, cfg=sh_cfg)
                return pooled_summary(d, draws, info, phi_mon, phi_eval)

            def one_chain(ckey):
                k1, k2 = jax.random.split(ckey)
                p0 = init_unconstrained(cfg, d, k1)
                qq, _ = ravel_pytree(jax.tree.map(lambda a: a.astype(dtype), p0))
                return sample_nuts(logp, qq, k2, warmup=warmup,
                                   samples=samples, cfg=nuts_cfg)

            draws, info = jax.vmap(one_chain)(jax.random.split(skey, chains))
            return summarize(d, draws, info, phi_mon, phi_eval)

        if warm_start is not None:
            ws = warm_start.diagnostics
            for k_ in ("state_q", "state_inv_mass", "state_step_size"):
                if k_ not in ws:
                    raise ValueError(
                        "warm_start must be a sample-mode BatchFitResult "
                        f"carrying sampler state (missing diagnostics[{k_!r}])")
            if ws.get("state_cfg") is not None and ws["state_cfg"] != cfg:
                raise ValueError(
                    "warm_start was sampled under a different model "
                    "configuration than this fit; resuming across "
                    "parameterizations would mix coordinate systems")
            b_prev = np.asarray(ws["state_q"]).shape[0]
            if b_prev != b_real:
                raise ValueError(
                    f"warm_start holds sampler state for {b_prev} spectra "
                    f"but this fit has {b_real}; chained refits must keep "
                    "the batch layout across calls")
            wq = _pad_rows(np.asarray(ws["state_q"]), b)
            wm = _pad_rows(np.asarray(ws["state_inv_mass"]), b)
            weps = _pad_rows(np.asarray(ws["state_step_size"]), b)
            if wq.shape[1] != chains:
                raise ValueError(f"warm_start carries {wq.shape[1]} chains, "
                                 f"this fit requests {chains}")
            if sampler == "shmc":
                warm_sh = sh_cfg._replace(adapt_mass=False)

                def fit_one(A_rows, target, freq_row, mask_row, skey,
                            wq_, wm_, weps_, dat, phi_mon, phi_eval):
                    d = dat._replace(A=A_rows, target=target, freq=freq_row,
                                     lik_mask=mask_row)
                    logp = lambda q: log_density(cfg, d, unravel(q),
                                                 jacobian=True)
                    draws, info = sample_shmc(
                        logp, wq_, skey, warmup=warmup, samples=samples,
                        cfg=warm_sh, metric=wm_.mean(axis=0),
                        init_step_size=weps_.mean())
                    return pooled_summary(d, draws, info, phi_mon, phi_eval)

                extra = (jnp.asarray(wq, dtype), jnp.asarray(wm, dtype),
                         jnp.asarray(weps, dtype))
                prog_tag = ("warm-shmc", warm_sh)
            elif sampler == "chees":
                warm_ch = ch_cfg._replace(adapt_mass=False)
                wtt = np.asarray(ws.get("state_traj_time",
                                        np.full(b_prev, np.nan)))
                if np.any(np.isnan(wtt)):
                    raise ValueError(
                        "warm_start for sampler='chees' needs "
                        "diagnostics['state_traj_time']")
                wtt = _pad_rows(wtt, b)

                def fit_one(A_rows, target, freq_row, mask_row, skey,
                            wq_, wm_, weps_, wtt_, dat, phi_mon, phi_eval):
                    d = dat._replace(A=A_rows, target=target, freq=freq_row,
                                     lik_mask=mask_row)
                    logp = lambda q: log_density(cfg, d, unravel(q),
                                                 jacobian=True)
                    draws, info = sample_chees(
                        logp, wq_, skey, warmup=warmup, samples=samples,
                        cfg=warm_ch, metric=wm_.mean(axis=0),
                        init_step_size=weps_.mean(), init_traj_time=wtt_)
                    return pooled_summary(d, draws, info, phi_mon, phi_eval)

                extra = (jnp.asarray(wq, dtype), jnp.asarray(wm, dtype),
                         jnp.asarray(weps, dtype), jnp.asarray(wtt, dtype))
                prog_tag = ("warm-chees", warm_ch)
            else:
                warm_cfg = nuts_cfg._replace(adapt_mass=False)

                def fit_one(A_rows, target, freq_row, mask_row, skey,
                            wq_, wm_, weps_, dat, phi_mon, phi_eval):
                    d = dat._replace(A=A_rows, target=target, freq=freq_row,
                                     lik_mask=mask_row)
                    logp = lambda q: log_density(cfg, d, unravel(q),
                                                 jacobian=True)

                    def one_chain(ckey, q0, m_inv_c, eps_c):
                        return sample_nuts(logp, q0, ckey, warmup=warmup,
                                           samples=samples, cfg=warm_cfg,
                                           metric=m_inv_c,
                                           init_step_size=eps_c)

                    draws, info = jax.vmap(one_chain)(
                        jax.random.split(skey, chains), wq_, wm_, weps_)
                    return summarize(d, draws, info, phi_mon, phi_eval)

                extra = (jnp.asarray(wq, dtype), jnp.asarray(wm, dtype),
                         jnp.asarray(weps, dtype))
                prog_tag = ("warm", warm_cfg)
        else:
            def fit_one(A_rows, target, freq_row, mask_row, skey, dat,
                        phi_mon, phi_eval):
                d = dat._replace(A=A_rows, target=target, freq=freq_row,
                                 lik_mask=mask_row)
                return run_plain(d, skey, phi_mon, phi_eval)

            extra = ()
            prog_tag = ()

        sampler_key = {"chees": ("chees", ch_cfg), "shmc": ("shmc", sh_cfg),
                       "nuts": nuts_cfg}[sampler]
        prog_extra = (sampler_key, chains, warmup, samples,
                      phi_mon_np.shape, phi_eval_np.shape) + prog_tag
        shared_args = (data0, phi_mon_j, phi_eval_j)
        n_extra = len(extra)
        fit_in_axes = (0, 0, 0, 0, 0) + (0,) * n_extra + (None, None, None)
    else:
        def fit_one(A_rows, target, freq_row, mask_row, skey, dat):
            d = dat._replace(A=A_rows, target=target, freq=freq_row,
                             lik_mask=mask_row)
            loss = lambda q: -log_density(cfg, d, unravel(q), jacobian=False)

            def one_restart(rkey):
                p0 = init_unconstrained(cfg, d, rkey)
                qq, _ = ravel_pytree(jax.tree.map(lambda a: a.astype(dtype), p0))
                return run_lbfgs(loss, qq, max_iter=max_iter)

            res = jax.vmap(one_restart)(jax.random.split(skey, n_restarts))
            best = jnp.argmin(jnp.where(jnp.isfinite(res.value), res.value,
                                        jnp.inf))
            c = constrain(cfg, d, unravel(res.params[best]))
            out = {"coef": c["x_0"], "coef_lo": c["x_0"], "coef_hi": c["x_0"],
                   "r_inf": c["Rinf"], "induc": c["induc"],
                   "value": res.value[best]}
            for i in range(1, n_dists):
                out[f"coef_{i}"] = c[f"x_{i}"]
            return out

        extra = ()
        prog_extra = (n_restarts, max_iter)
        shared_args = (data0,)
        fit_in_axes = (0, 0, 0, 0, 0, None)

    A_tuple = tuple(jnp.asarray(a, dtype) for a in A_stacks)
    args = (A_tuple, jnp.asarray(targets, dtype),
            jnp.asarray(freq_pad, dtype), jnp.asarray(masks2, dtype),
            keys) + extra
    prog_key = ("fit_spectra_ragged", mode, cfg, data_shapes(data0),
                data_shapes(args), prog_extra, mesh)

    def build_fit():
        fn = jax.vmap(fit_one, in_axes=fit_in_axes)
        if mesh is not None:
            return jax.jit(fn, out_shardings=NamedSharding(mesh, P("spectra")))
        return jax.jit(fn)

    if mesh is not None:
        args = jax.tree.map(
            lambda a: jax.device_put(a, NamedSharding(
                mesh, P(*(["spectra"] + [None] * (a.ndim - 1))))), args)
    batched = _cached_program(prog_key, build_fit)
    out = batched(*args, *shared_args)
    shard_layout = None
    if mesh is not None:
        shard_layout = tuple(sorted(
            (sd.device.id, sd.index[0].start or 0, sd.index[0].stop or b)
            for sd in out["coef"].addressable_shards))
    out = {kk: np.asarray(v)[:b_real] for kk, v in out.items()}
    z_scales = z_scales[:b_real]

    def rescale(i):
        if cfg.dists[i].dist_type == "parallel":
            return 1.0 / z_scales[:, None]
        return z_scales[:, None]

    scale0 = rescale(0)
    diagnostics = {kk: out[kk] for kk in out
                   if kk not in ("coef", "coef_lo", "coef_hi", "r_inf",
                                 "induc")}
    if mode == "sample":
        diagnostics["state_cfg"] = cfg
    if shard_layout is not None:
        diagnostics["shard_layout"] = shard_layout
    for i in range(1, n_dists):
        if f"coef_{i}" in diagnostics:
            diagnostics[f"coef_{i}"] = diagnostics[f"coef_{i}"] * rescale(i)
    for k_ge in ("gamma_eval_mean", "gamma_eval_lo", "gamma_eval_hi"):
        if k_ge in diagnostics:
            diagnostics[k_ge] = diagnostics[k_ge] * scale0
    # scaled-impedance-space posterior-mean Z_hat (rows beyond each
    # spectrum's true grid length are padding; no shared f_train here, so
    # predict_Z_batch's draws-mean fast path stays off for ragged fits)
    for k_z in ("z_hat_mean", "z_hat_std"):
        if k_z in diagnostics:
            diagnostics[k_z] = diagnostics[k_z] * z_scales[:, None]
    return BatchFitResult(
        coef=out["coef"] * scale0, r_inf=out["r_inf"] * z_scales,
        inductance=out["induc"] * z_scales,
        gamma_lo=out["coef_lo"] * scale0 if mode == "sample" else None,
        gamma_hi=out["coef_hi"] * scale0 if mode == "sample" else None,
        z_scales=z_scales, tau=tau, epsilon=eps, diagnostics=diagnostics,
        basis=first_basis)


def _format_weights_batch(Z, weights):
    """Batched version of Inverter._format_weights: (B, N) complex spectra ->
    (w_re, w_im) rows, supporting the full reference weights vocabulary
    (unity/modulus/Orazem/proportional/prop_adj, scalars, shared or
    per-spectrum arrays; reference: inversion.py weight formatting)."""
    Z = np.asarray(Z)
    b, n = Z.shape
    if weights is None or (isinstance(weights, str) and weights == "unity"):
        w = np.ones((b, n)) * (1 + 1j)
    elif isinstance(weights, str):
        if weights == "modulus":
            w = (1 + 1j) / np.abs(Z)
        elif weights == "Orazem":
            w = (1 + 1j) / (np.abs(Z.real) + np.abs(Z.imag))
        elif weights == "proportional":
            w = 1 / np.abs(Z.real) + 1j / np.abs(Z.imag)
        elif weights == "prop_adj":
            zmod2 = np.real(Z * Z.conjugate())
            q25 = np.percentile(zmod2, 25, axis=1, keepdims=True)
            w = 1 / (np.abs(Z.real) + q25) + 1j / (np.abs(Z.imag) + q25)
        else:
            raise ValueError(
                f"Invalid weights argument {weights!r}. String options are "
                "'unity', 'modulus', 'Orazem', 'proportional', and 'prop_adj'")
    elif isinstance(weights, complex):
        w = np.full((b, n), weights)
    elif isinstance(weights, (int, float)):
        w = np.full((b, n), weights * (1 + 1j))
    else:
        w = np.asarray(weights)
        if w.ndim == 1:
            w = np.broadcast_to(w[None, :], (b, n))
        if w.shape != (b, n):
            raise ValueError(f"Weights array shape {w.shape} must be (N,) or "
                             f"(B, N) = {(b, n)}")
        if np.isrealobj(w):
            w = w * (1 + 1j)
    return np.ascontiguousarray(w.real), np.ascontiguousarray(w.imag)


def ridge_fit_spectra_batch(frequencies, Z_batch, basis_freq=None,
                            epsilon=None, penalty: str = "integral",
                            hyper_lambda: bool = True,
                            hl_beta: float = 2.5, lambda_0: float = 1e-2,
                            reg_ord=2, nonneg: bool = True,
                            weights: str = "modulus", max_iter: int = 20,
                            xtol: float = 1e-3, mesh: Optional[Mesh] = None,
                            basis: str = "gaussian",
                            dtype=None, cv_lambdas=None,
                            hyper_weights: bool = False, hw_beta: float = 2.0,
                            hw_wbar=1.0) -> BatchFitResult:
    """Batched (hyper-lambda or ordinary) ridge DRT fits: B spectra in one
    vmapped XLA program (vs the reference's ~0.1 s serial cvxopt solves,
    inversion.py:1043-1067). Shares one frequency/basis grid across the
    batch; first-class like fit_spectra_batch: the design matrices ride as
    jit ARGUMENTS through a cached program (zero re-tracing across calls
    with the same shapes), the full reference weights vocabulary is
    supported, and under a ``mesh`` the batch is physically partitioned
    (out_shardings + diagnostics['shard_layout'] proof).

    ``cv_lambdas``: optional (L,) grid of lambda_0 values. When given,
    ``lambda_0`` is ignored and each spectrum's regularization strength is
    selected by Re-Im cross-validation (the reference's serial
    ``ridge_ReImCV`` loop, inversion.py:902-945) — for every lambda a
    real-part fit predicts the imaginary component and vice versa, the
    summed squared prediction errors pick the per-spectrum argmin, and the
    final both-part fit runs at the selected lambda. The whole
    (L lambdas x B spectra x 2 parts + final) sweep is ONE cached XLA
    program: per spectrum, a lax.scan over the grid (reusing the
    lambda-invariant weighted design), vmapped over the batch.
    Diagnostics gain ``cv_lambda`` (B,), ``cv_recv``/``cv_imcv``/
    ``cv_totcv`` (B, L); a warning fires if any spectrum selects a grid
    boundary (same semantics as the reference's single-spectrum warning).

    ``hyper_weights=True`` (requires ``hyper_lambda=False``): the
    Effat-Ciucci outlier-robust ridge (reference: inversion.py:757-833) —
    MAP point weights iterate against the residuals so corrupted points
    are down-weighted automatically. ``hw_wbar`` accepts the same weights
    vocabulary as ``weights`` and sets the prior mean weights (the
    likelihood ``weights`` argument is unused in this mode, mirroring the
    single-spectrum API); the fitted per-point weights land in
    ``diagnostics['weights_re'/'weights_im']`` (B, N), **in the caller's
    point order** — small values mark outliers."""
    if hyper_weights and hyper_lambda:
        raise ValueError("hyper_lambda and hyper_weights fits cannot be "
                         "combined; pass hyper_lambda=False")
    if hyper_weights and cv_lambdas is not None:
        raise ValueError("cv_lambdas is not supported with hyper_weights")
    Z_batch = np.asarray(Z_batch)
    # reorder data columns to the descending-frequency matrix convention
    f_order = np.argsort(np.asarray(frequencies, float))[::-1]
    frequencies = np.asarray(frequencies, float)[f_order]
    Z_batch = Z_batch[:, f_order]
    Z_batch, b_real = _pad_pow2(Z_batch)
    b, n = Z_batch.shape
    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    if basis_freq is None:
        tau = get_tau_basis(frequencies)
    else:
        tau = 1.0 / (2 * np.pi * np.asarray(basis_freq, float))
    eps = default_epsilon(tau) if epsilon is None else float(epsilon)
    f_coll = 1.0 / (2 * np.pi * tau)
    kb = len(tau)
    k = kb + 2

    with _cpu_context():
        A_re = np.zeros((n, k))
        A_re[:, 0] = 1.0
        A_re[:, 2:] = np.asarray(construct_A(frequencies, "real", tau=tau,
                                             basis=basis,
                                             epsilon=eps, dtype=dtype))
        A_im = np.zeros((n, k))
        A_im[:, 1] = 2 * np.pi * frequencies * 1e-4
        A_im[:, 2:] = np.asarray(construct_A(frequencies, "imag", tau=tau,
                                             basis=basis,
                                             epsilon=eps, dtype=dtype))
        L2_base, L_ops = [], []
        for order in (0, 1, 2):
            if penalty == "integral":
                M = np.zeros((k, k))
                M[2:, 2:] = np.asarray(construct_M(f_coll, order=order,
                                                   basis=basis,
                                                   epsilon=eps, dtype=dtype))
                L2_base.append(M)
                L_ops.append(np.zeros((kb, k)))
            else:
                L = np.concatenate(
                    [np.zeros((kb, 2)),
                     np.asarray(construct_L(f_coll, tau=tau, epsilon=eps,
                                            basis=basis,
                                            order=order, dtype=dtype))], axis=1)
                L_ops.append(L)
                L2_base.append(L.T @ L)

    if isinstance(reg_ord, (int, np.integer)):
        frac = np.zeros(3)
        frac[reg_ord] = 1.0
    else:
        frac = np.asarray(reg_ord, float)

    z_scales = np.std(np.abs(Z_batch), axis=1) / np.sqrt(n / 81)
    Zs = Z_batch / z_scales[:, None]
    # with hyper_weights the point weights EVOLVE during the fit (prior
    # mean set by hw_wbar) and the likelihood `weights` argument is unused
    # — mirror the single-spectrum API, skip building it
    if not hyper_weights:
        w_re, w_im = _format_weights_batch(Zs, weights)

    lb = np.zeros(k) if nonneg else np.concatenate([np.zeros(2),
                                                    np.full(kb, -10.0)])
    ub = np.full(k, np.inf)
    cfg = HyperLambdaConfig(part="both", penalty=penalty, n_fixed=2,
                            max_iter=max_iter)

    def make_data(t_re, t_im, wr, wi, A_re_j, A_im_j, L2_base_j, L_ops_j,
                  L1_vec, frac_j, lb_j, ub_j):
        return RidgeData(WA_re=wr[:, None] * A_re_j,
                         WA_im=wi[:, None] * A_im_j,
                         WT_re=wr * t_re, WT_im=wi * t_im,
                         L2_base=L2_base_j, L_ops=L_ops_j, L1_vec=L1_vec,
                         reg_frac=frac_j, lb=lb_j, ub=ub_j)

    def solve_at(scfg, part, data, lam):
        if hyper_lambda:
            return run_hyper_lambda(scfg, data, jnp.full(k, 1e-6, dtype),
                                    jnp.full(3, hl_beta, dtype), lam,
                                    xtol=xtol)
        return run_ordinary_ridge(part, data, lam)

    def fit_one(lam, t_re, t_im, wr, wi, *sh):
        data = make_data(t_re, t_im, wr, wi, *sh)
        res = solve_at(cfg, "both", data, lam)
        return res.coef, res.n_iter, res.converged

    if not hyper_weights:
        mapped = tuple(jnp.asarray(a, dtype)
                       for a in (Zs.real, Zs.imag, w_re, w_im))
    shared = tuple(jnp.asarray(a, dtype)
                   for a in (A_re, A_im, np.array(L2_base), np.array(L_ops),
                             np.zeros(k), frac, lb, ub))
    dtype_key = str(np.dtype(np.float64 if dtype == jnp.float64
                             else np.float32))

    if hyper_weights:
        # outlier-robust ridge: the mapped weight rows carry the PRIOR mean
        # weights (wbar); run_hyper_weights evolves the actual point weights
        # against the residuals itself
        wbar_re, wbar_im = _format_weights_batch(Zs, hw_wbar)
        mapped = tuple(jnp.asarray(a, dtype)
                       for a in (Zs.real, Zs.imag, wbar_re, wbar_im))
        prog_key = ("ridge_hw_spectra_batch", cfg, float(hw_beta),
                    float(lambda_0), float(xtol), int(max_iter), b,
                    data_shapes(mapped + shared), dtype_key, mesh)

        def build_fit():
            def hw_one(t_re, t_im, wbr, wbi, *sh):
                data = make_data(t_re, t_im, wbr, wbi, *sh)
                A_re_j, A_im_j = sh[0], sh[1]
                res = run_hyper_weights("both", data, A_re_j, A_im_j,
                                        t_re, t_im, lambda_0, hw_beta,
                                        wbr, wbi, max_iter=max_iter,
                                        xtol=xtol)
                return (res.coef, res.n_iter, res.converged,
                        res.weights_re, res.weights_im)

            fn = precise_matmuls(
                jax.vmap(hw_one, in_axes=(0, 0, 0, 0) + (None,) * 8))
            if mesh is not None:
                return jax.jit(fn,
                               out_shardings=NamedSharding(mesh, P("spectra")))
            return jax.jit(fn)
    elif cv_lambdas is None:
        prog_key = ("ridge_fit_spectra_batch", cfg, bool(hyper_lambda),
                    float(hl_beta), float(lambda_0), float(xtol), b,
                    data_shapes(mapped + shared), dtype_key, mesh)

        def build_fit():
            # bind lambda_0 as a Python float so it constant-folds exactly
            # as the pre-CV closure did (bit-identical programs)
            fn = precise_matmuls(jax.vmap(
                partial(fit_one, lambda_0),
                in_axes=(0, 0, 0, 0) + (None,) * 8))
            if mesh is not None:
                return jax.jit(fn,
                               out_shardings=NamedSharding(mesh, P("spectra")))
            return jax.jit(fn)
    else:
        cv_lams = np.asarray(cv_lambdas, float)
        cfg_re = cfg._replace(part="real")
        cfg_im = cfg._replace(part="imag")

        def cv_fit_one(t_re, t_im, wr, wi, *sh_and_grid):
            """Full CV for one spectrum: grid sweep (lax.scan), per-spectrum
            argmin, final both-part fit. The RidgeData is built ONCE — it is
            lambda-invariant — and the scan reuses it."""
            sh, grid = sh_and_grid[:-1], sh_and_grid[-1]
            A_re_j, A_im_j = sh[0], sh[1]
            data = make_data(t_re, t_im, wr, wi, *sh)

            def per_lam(carry, lam):
                # held-out prediction errors at one lambda: fit on one part,
                # score the other, unweighted (reference: inversion.py:
                # 906-921). Part-specific offset recovery (854-873): the
                # imag-only fit cannot see R_inf — recover it as the mean
                # real residual; the real-only fit cannot see the inductance
                # — project the imag residual onto the omega column.
                coef_r = solve_at(cfg_re, "real", data, lam).coef
                coef_i = solve_at(cfg_im, "imag", data, lam).coef
                coef_i = coef_i.at[0].set(
                    jnp.mean(t_re - A_re_j[:, 2:] @ coef_i[2:]))
                bvec = A_im_j[:, 1]
                zi_resid = t_im - A_im_j[:, 2:] @ coef_r[2:]
                coef_r = coef_r.at[1].set((bvec @ zi_resid) / (bvec @ bvec))
                imcv = jnp.sum((t_im - A_im_j @ coef_r) ** 2)
                recv = jnp.sum((t_re - A_re_j @ coef_i) ** 2)
                return carry, (recv, imcv)

            _, (recv, imcv) = jax.lax.scan(per_lam, 0, grid)   # (L,) each
            # select by INDEX (f32-safe: comparing recovered lambda values
            # against grid endpoints would need a dtype-aware tolerance)
            idx = jnp.argmin(recv + imcv)
            lam_star = grid[idx]
            res = solve_at(cfg, "both", data, lam_star)
            return (res.coef, res.n_iter, res.converged, lam_star,
                    recv, imcv, idx.astype(jnp.int32))

        def cv_program(t_re, t_im, wr, wi, *sh_and_grid):
            return jax.vmap(cv_fit_one,
                            in_axes=(0, 0, 0, 0) + (None,) * 9)(
                t_re, t_im, wr, wi, *sh_and_grid)

        shared = shared + (jnp.asarray(cv_lams, dtype),)
        prog_key = ("ridge_cv_spectra_batch", cfg, bool(hyper_lambda),
                    float(hl_beta), float(xtol), b, len(cv_lams),
                    data_shapes(mapped + shared), dtype_key, mesh)

        def build_fit():
            fn = precise_matmuls(cv_program)
            if mesh is not None:
                return jax.jit(fn,
                               out_shardings=NamedSharding(mesh, P("spectra")))
            return jax.jit(fn)

    if mesh is not None:
        sh = NamedSharding(mesh, P("spectra", None))
        mapped = tuple(jax.device_put(a, sh) for a in mapped)
    batched = _cached_program(prog_key, build_fit)
    out = batched(*mapped, *shared)
    shard_layout = None
    if mesh is not None:
        shard_layout = tuple(sorted(
            (sd.device.id, sd.index[0].start or 0, sd.index[0].stop or b)
            for sd in out[0].addressable_shards))
    coefs, n_iter, converged = (np.asarray(a)[:b_real] for a in out[:3])
    z_scales = z_scales[:b_real]

    coefs = coefs * z_scales[:, None]
    diagnostics = {"n_iter": n_iter, "converged": converged}
    if hyper_weights:
        # return per-point weights in the CALLER's point order (the batch
        # reorders columns to descending frequency internally; a user
        # locating outliers via argmin must not need to know that)
        inv_order = np.empty_like(f_order)
        inv_order[f_order] = np.arange(len(f_order))
        diagnostics["weights_re"] = np.asarray(out[3])[:b_real][:, inv_order]
        diagnostics["weights_im"] = np.asarray(out[4])[:b_real][:, inv_order]
    if cv_lambdas is not None:
        lam_sel = np.asarray(out[3])[:b_real].astype(float)
        recv = np.asarray(out[4])[:b_real]
        imcv = np.asarray(out[5])[:b_real]
        idx_sel = np.asarray(out[6])[:b_real]
        diagnostics.update(cv_lambda=lam_sel, cv_recv=recv, cv_imcv=imcv,
                           cv_totcv=recv + imcv)
        n_boundary = int(np.sum((idx_sel == 0)
                                | (idx_sel == len(cv_lams) - 1)))
        if n_boundary:
            warnings.warn(
                f"Re-Im CV selected a boundary lambda for {n_boundary} "
                "spectra; re-run with an expanded cv_lambdas range for an "
                "accurate estimate.")
    if shard_layout is not None:
        diagnostics["shard_layout"] = shard_layout
    return BatchFitResult(
        coef=coefs[:, 2:], r_inf=coefs[:, 0], inductance=coefs[:, 1] * 1e-4,
        gamma_lo=None, gamma_hi=None, z_scales=z_scales, tau=tau, epsilon=eps,
        diagnostics=diagnostics, basis=basis)


def drift_fit_spectra_batch(frequencies, times, Z_batch, drift_model="x1",
                            basis_freq=None, epsilon=None,
                            nonneg: bool = False, sigma_min: float = 0.002,
                            max_iter: int = 2000, random_seed: int = 0,
                            inductance_scale: float = 1.0,
                            init_from_ridge: bool = True, n_restarts: int = 2,
                            min_tau_drift: float = 200.0,
                            max_tau_drift: float = 10000.0,
                            mesh: Optional[Mesh] = None,
                            basis: str = "gaussian", dtype=None,
                            distributions=None) -> BatchFitResult:
    """Batched MAP fits of time-evolving spectra: B cells measured on the
    SAME frequency sweep schedule (shared per-point measurement times) fit
    in one vmapped XLA program — the fleet form of ``Inverter.
    drift_map_fit`` (reference: inversion.py:1291-1564, which fits one
    evolving spectrum at a time).

    ``times``: measurement time of each frequency point (len == len(
    frequencies), seconds) — shared by the batch, as when one instrument
    schedule sweeps every cell. Measurement order is preserved (NOT sorted
    to descending frequency) so times stay aligned, matching the
    single-spectrum path.

    ``distributions``: optional single-entry mini-DSL dict (drift fits
    support one distribution, same restriction as the reference).

    Returns a BatchFitResult whose ``coef``/``r_inf``/``inductance`` are
    the time-zero (or final, for *-from-final models) values;
    ``diagnostics['drift']`` carries every rescaled drift parameter
    (x0/x1/dx/x2 vectors, tau_1/tau_2/tau_Rinf, delta_Rinf, RQ-element
    parameters), ``diagnostics['value']``/``['n_iter']`` the per-cell
    optimizer state. Ridge-seeded (one batched hyper-lambda ridge pass
    anchors x0/x1/R_inf) plus ``n_restarts`` random restarts, best loss
    wins — the single-spectrum workflow, vectorized."""
    from ..models.drift import (DRIFT_MODELS, DriftConfig, DriftData,
                                constrain_drift, drift_log_density,
                                init_drift_params, predict_drift_target)
    if drift_model not in DRIFT_MODELS:
        raise ValueError(f"Invalid drift_model {drift_model!r}. Options "
                         f"are {DRIFT_MODELS}")
    frequencies = np.asarray(frequencies, float)
    times = np.asarray(times, float)
    if len(times) != len(frequencies):
        raise ValueError("times must have same length as frequencies")
    Z_batch = np.asarray(Z_batch)
    if Z_batch.ndim != 2 or Z_batch.shape[1] != len(frequencies):
        raise ValueError(f"Z_batch must be (B, {len(frequencies)})")
    Z_batch, b_real = _pad_pow2(Z_batch)
    b, n = Z_batch.shape
    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32

    if distributions is None:
        distributions = {"DRT": {"kernel": "DRT", "dist_type": "series"}}
    if len(distributions) != 1:
        raise ValueError("drift fits support a single distribution")
    dist_name, info = next(iter(distributions.items()))
    info = dict(info)
    if info.get("kernel", "DRT") == "DRT":
        info.setdefault("dist_type", "series")
    else:
        info.setdefault("dist_type", "parallel")
        info.setdefault("symmetry", "planar")
        info.setdefault("bc", "blocking")
    info.setdefault("ct", False)
    dist_type = info["dist_type"]

    if basis_freq is None:
        tau = get_tau_basis(np.sort(frequencies)[::-1])
    else:
        tau = 1.0 / (2 * np.pi * np.asarray(basis_freq, float))
    eps = default_epsilon(tau) if epsilon is None else float(epsilon)
    f_coll = 1.0 / (2 * np.pi * tau)

    with _cpu_context():
        kw = dict(tau=tau, basis=basis, epsilon=eps,
                  kernel=info.get("kernel", "DRT"),
                  dist_type=dist_type, symmetry=info.get("symmetry", "planar"),
                  bc=info.get("bc", "transmissive"), ct=info["ct"],
                  k_ct=info.get("k_ct", None))
        A_re = np.asarray(construct_A(frequencies, "real", **kw))
        A_im = np.asarray(construct_A(frequencies, "imag", **kw))
        # drift penalty stack: the mode-scaled L operators the
        # single-spectrum path builds (inverter.drift_map_fit)
        L = np.stack([1.5 * s * np.asarray(construct_L(
            f_coll, tau=tau, basis=basis, epsilon=eps, order=o))
            for o, s in ((0, 0.24), (1, 0.16), (2, 0.08))])

    # scale with the NORMALIZED dist info so under-specified DDT dicts get
    # the same bc default ('blocking') the Inverter applies
    z_scales = np.asarray(z_scale_for({dist_name: info}, Z_batch, "map"))
    Zs = Z_batch / z_scales[:, None]
    targets = np.concatenate([Zs.real, Zs.imag], axis=1)  # (B, 2N)

    cfg = DriftConfig(drift_model=drift_model, dist_type=dist_type,
                      nonneg=nonneg, K=len(tau))
    data = DriftData(
        A_re=jnp.asarray(A_re, dtype), A_im=jnp.asarray(A_im, dtype),
        L=jnp.asarray(L, dtype), Z=jnp.zeros((2 * n,), dtype),
        freq=jnp.asarray(frequencies, dtype),
        times=jnp.asarray(times, dtype),
        sigma_min=jnp.asarray(sigma_min, dtype),
        ups_alpha=jnp.asarray(0.05, dtype), ups_beta=jnp.asarray(0.1, dtype),
        induc_scale=jnp.asarray(inductance_scale, dtype),
        tau_bounds=jnp.asarray([min_tau_drift, max_tau_drift], dtype),
        tau2_bounds=jnp.asarray([max(min_tau_drift, 500.0), max_tau_drift],
                                dtype),
        rq_tau_bounds=jnp.asarray([tau.min(), tau.max()], dtype),
        k_bounds=jnp.asarray([1e-4, 1.0], dtype),
        t_max=jnp.asarray(times.max(), dtype),
        t_min=jnp.asarray(times.min(), dtype))

    # host-side ridge anchor for x0/x1/R_inf/inductance — the reference's
    # recommended drift workflow (inversion.py:1411-1432), one BATCHED
    # hyper-lambda ridge pass for the whole fleet
    pos_x = nonneg or dist_type == "parallel"
    if init_from_ridge and (info.get("kernel", "DRT") != "DRT"
                            or dist_type != "series"):
        # ridge_fit_spectra_batch builds series-DRT design matrices; its
        # coefficients live in a different space than a parallel/DDT drift
        # fit's, so seeding from them would start the optimizer nowhere
        # useful (the single-spectrum path ridge-fits the actual kernel,
        # inverter.py drift_map_fit). Fall back to neutral inits.
        warnings.warn(
            "init_from_ridge seeds from a series-DRT ridge fit, which does "
            "not match this distribution's coefficient space; using neutral "
            "inits instead — consider raising n_restarts.")
        init_from_ridge = False
    if init_from_ridge:
        rr = ridge_fit_spectra_batch(
            frequencies, Z_batch, basis_freq=1.0 / (2 * np.pi * tau),
            penalty="integral", hyper_lambda=True, lambda_0=1.0, hl_beta=5.0,
            weights="modulus", basis=basis, dtype=dtype)
        x_r = rr.coef / z_scales[:, None]
        if dist_type == "parallel":
            x_r = rr.coef * z_scales[:, None]
        rinf_r = np.clip(rr.r_inf / z_scales, 1e-6, None)
        induc_r = np.clip(rr.inductance / z_scales, 1e-10, None)
        iv_x = (np.log(np.clip(x_r, 1e-10, None)) if pos_x
                else np.asarray(x_r))
        iv_rinf = np.log(rinf_r / 100.0)
        iv_induc = np.log(induc_r)
    else:
        iv_x = np.zeros((b, len(tau)))
        iv_rinf = np.full(b, np.log(1e-2))
        iv_induc = np.full(b, np.log(1e-10))

    keys = jax.random.split(jax.random.PRNGKey(random_seed), b)

    def fit_one(target, skey, ivx, ivr, ivi, dat):
        d = dat._replace(Z=target)
        loss = lambda p: -drift_log_density(cfg, d, p, jacobian=False)
        iv = {"Rinf0_raw": ivr, "induc_raw": ivi, "dRinf_raw": 0.0,
              "x0": ivx, "x1": ivx,
              "dx": jnp.full_like(ivx, 1e-3), "x2": jnp.full_like(ivx, 1e-3)}
        k_ridge, k_rand = jax.random.split(skey)
        p0 = init_drift_params(cfg, d, k_ridge, init_values=iv)
        p0 = jax.tree.map(lambda a: jnp.asarray(a, dtype), p0)
        best = run_lbfgs(loss, p0, max_iter=max_iter)
        if n_restarts > 0:
            def one_restart(rkey):
                pr = jax.tree.map(lambda a: jnp.asarray(a, dtype),
                                  init_drift_params(cfg, d, rkey))
                return run_lbfgs(loss, pr, max_iter=max_iter)

            rand = jax.vmap(one_restart)(jax.random.split(k_rand, n_restarts))
            ib = jnp.argmin(jnp.where(jnp.isfinite(rand.value),
                                      rand.value, jnp.inf))
            rand_p = jax.tree.map(lambda a: a[ib], rand.params)
            rand_v = rand.value[ib]
            # NaN-aware selection: a diverged (NaN) run must never beat a
            # finite one, in either direction
            bv = jnp.where(jnp.isfinite(best.value), best.value, jnp.inf)
            rv = jnp.where(jnp.isfinite(rand_v), rand_v, jnp.inf)
            take_ridge = bv <= rv
            params = jax.tree.map(
                lambda a, r: jnp.where(take_ridge, a, r), best.params, rand_p)
            value = jnp.where(take_ridge, best.value, rand_v)
            n_it = jnp.where(take_ridge, best.n_iter, rand.n_iter[ib])
        else:
            params, value, n_it = best.params, best.value, best.n_iter
        c = constrain_drift(cfg, d, params)
        # reconstruction quality at the fitted drift trajectory (the same
        # check the single-spectrum drift test gates on)
        pred = predict_drift_target(cfg, d, c)
        zmod = jnp.sqrt(target[: d.freq.shape[0]] ** 2
                        + target[d.freq.shape[0]:] ** 2)
        resid = jnp.sqrt((pred[: d.freq.shape[0]] - target[: d.freq.shape[0]]) ** 2
                         + (pred[d.freq.shape[0]:] - target[d.freq.shape[0]:]) ** 2)
        med_resid = jnp.median(resid / jnp.maximum(zmod, 1e-30))
        return c, value, n_it.astype(jnp.float32), med_resid

    mapped = (jnp.asarray(targets, dtype), keys,
              jnp.asarray(iv_x, dtype), jnp.asarray(iv_rinf, dtype),
              jnp.asarray(iv_induc, dtype))
    prog_key = ("drift_fit_spectra_batch", cfg, int(n_restarts),
                int(max_iter), float(sigma_min), b,
                data_shapes(mapped), data_shapes(data),
                str(np.dtype(np.float64 if dtype == jnp.float64
                             else np.float32)), mesh)

    def build_fit():
        fn = precise_matmuls(jax.vmap(fit_one,
                                      in_axes=(0, 0, 0, 0, 0, None)))
        if mesh is not None:
            return jax.jit(fn, out_shardings=NamedSharding(mesh, P("spectra")))
        return jax.jit(fn)

    if mesh is not None:
        # per-array specs: iv_rinf/iv_induc are rank-1, the rest rank-2
        mapped = tuple(
            jax.device_put(a, NamedSharding(
                mesh, P(*(("spectra",) + (None,) * (a.ndim - 1)))))
            for a in mapped)
    batched = _cached_program(prog_key, build_fit)
    c, value, n_it, med_resid = batched(*mapped, data)

    shard_layout = None
    if mesh is not None:
        shard_layout = tuple(sorted(
            (sd.device.id, sd.index[0].start or 0, sd.index[0].stop or b)
            for sd in value.addressable_shards))

    c = {k_: np.asarray(v)[:b_real] for k_, v in c.items()}
    value = np.asarray(value)[:b_real]
    n_it = np.asarray(n_it)[:b_real]
    med_resid = np.asarray(med_resid)[:b_real]
    z_scales = z_scales[:b_real]

    # rescale to original impedance units (offsets are always series-scaled;
    # coefficient vectors follow the distribution type — inverter.
    # _rescale_coef semantics)
    def rescale_vec(v):
        if dist_type == "parallel":
            return v / z_scales[:, None]
        return v * z_scales[:, None]

    drift = {}
    for k_, v in c.items():
        if k_ in ("x0", "x1", "dx", "x2"):
            drift[k_] = rescale_vec(v)
        elif k_ in ("Rinf_0", "delta_Rinf", "induc", "sigma_res", "R_rq"):
            drift[k_] = v * z_scales
        elif not k_.startswith(("ups_", "d_strength_")):
            drift[k_] = v          # time constants, exponents, error alphas
    static_key = "x1" if drift_model.endswith("from-final") else "x0"
    diagnostics = {"value": value, "n_iter": n_it,
                   "median_rel_resid": med_resid,
                   "drift_model": drift_model, "drift": drift}
    if shard_layout is not None:
        diagnostics["shard_layout"] = shard_layout
    return BatchFitResult(
        coef=drift.get(static_key, drift.get("x0")),
        r_inf=drift["Rinf_0"], inductance=drift["induc"],
        gamma_lo=None, gamma_hi=None, z_scales=z_scales, tau=tau,
        epsilon=eps, diagnostics=diagnostics, basis=basis)


def evaluate_gamma(result: BatchFitResult, eval_tau, which: str = "coef"):
    """gamma(tau) curves for every spectrum in a batch result, using the
    basis family the fit was built with (result.basis).

    ``which``: 'coef' (point estimate / posterior mean), 'lo'/'hi'
    (credible-band edges), or a diagnostics key holding a coefficient
    array — e.g. 'coef_1' for the second distribution of a multidist
    batch fit (all distributions share the result's tau/epsilon grid
    when built from one basis_freq)."""
    from ..ops.basis import get_basis_func
    eval_tau = np.asarray(eval_tau, float)
    if which in ("coef", "lo", "hi"):
        coefs = {"coef": result.coef, "lo": result.gamma_lo,
                 "hi": result.gamma_hi}[which]
    else:
        coefs = result.diagnostics[which]
    phi = get_basis_func(getattr(result, "basis", "gaussian"))
    y = np.log(eval_tau[:, None] / result.tau[None, :])
    bases = np.asarray(phi(y, result.epsilon))
    return coefs @ bases.T


def predict_Z_batch(result: BatchFitResult, frequencies):
    """Predicted impedance at arbitrary frequencies for every spectrum of a
    batch fit: Z = R_inf + jwL + sum(series A@x) + sum(parallel 1/(A@x)),
    evaluated at the point-estimate / posterior-mean coefficients — the
    same semantics as Inverter.predict_Z without percentile (reference:
    inversion.py:2669-2961; the committed Zout_*.csv results are this at
    f_train). Returns a complex (B, N) array.

    Uses the per-distribution geometry recorded by fit_spectra_batch under
    ``diagnostics['dist_geometry']``; A matrices at the new frequencies are
    built once on the CPU backend (one-time setup math, like training).

    When the requested frequencies are exactly the training grid of a
    sample-mode fit, returns the stored POSTERIOR-MEAN over per-draw model
    predictions instead (``diagnostics['z_hat_mean']``) — the reference's
    committed Zout_*.csv are Stan generated quantities with these
    semantics (inversion.py:2700-2703). The distinction only matters for
    parallel distributions, where Z is nonlinear in the coefficients:
    Z at the mean coefficient can be arbitrarily wrong under multimodal
    chain mixing while E[Z] over draws stays faithful (the BimodalBP-DDT
    regression, benchmarks/probe_bpddt.py)."""
    geometry = result.diagnostics["dist_geometry"]
    frequencies = np.asarray(frequencies, float)
    f_train = result.diagnostics.get("f_train")
    if f_train is not None and len(f_train) == len(frequencies):
        # match the requested grid against f_train up to reordering
        idx = np.argsort(f_train)[::-1][np.argsort(
            np.argsort(frequencies)[::-1])]
        if np.allclose(f_train[idx], frequencies, rtol=1e-10):
            zm = np.asarray(result.diagnostics["z_hat_mean"], float)
            n = len(f_train)
            return (zm[:, :n] + 1j * zm[:, n:])[:, idx]
    z = (np.asarray(result.r_inf, float)[:, None]
         + 1j * 2 * np.pi * frequencies[None, :]
         * np.asarray(result.inductance, float)[:, None])
    with _cpu_context():
        for i, g in enumerate(geometry):
            kw = dict(tau=g["tau"], epsilon=g["epsilon"], basis=g["basis"],
                      kernel=g["kernel"], dist_type=g["dist_type"],
                      symmetry=g["symmetry"], bc=g["bc"], ct=g["ct"],
                      k_ct=g["k_ct"])
            A = (np.asarray(construct_A(frequencies, "real", **kw))
                 + 1j * np.asarray(construct_A(frequencies, "imag", **kw)))
            coef = (result.coef if i == 0
                    else result.diagnostics[f"coef_{i}"])
            t = np.asarray(coef) @ A.T
            z = z + (1.0 / t if g["dist_type"] == "parallel" else t)
    return z
