"""The calibrated hierarchical Bayesian model as one parameterized pure-JAX
log posterior.

Replaces the reference's 14 compiled Stan programs
(reference: bayes_drt/stan_model_files/*, selected by
inversion.py:1566-1614) with a single function parameterized by:

- number/type of distributions (series / parallel) -> covers Series,
  Parallel, Series-Parallel, Series-2Parallel, and the MultiDist
  generalization (any number of each)
- ``nonneg`` (the ``_pos`` model variants): series coefficient vectors
  constrained >= 0 (parallel coefficients are always >= 0)
- ``outliers`` (the ``_outliers`` variants): per-frequency outlier error
  contribution with exponential/inverse-gamma hyperprior
- ``fitY`` (the ``_fitY`` variants): fit admittance directly, no R_inf or
  inductance
- ``sa`` (the ``_SA`` variant, Parallel_fitY_SA_modelcode.txt): row-scaled
  design matrix with the likelihood evaluated in unscaled admittance space
  (Y_hat = S_inv @ (SA @ x)) — algebraically identical to the plain fitY
  model, a floating-point row-equilibration experiment (reference:
  inversion.py:1756-1810)

Constrained (<lower=0>) parameters use the same exp transform Stan uses;
``jacobian=True`` adds the log|J| terms (sampling measure), ``jacobian=False``
reproduces Stan's ``optimizing`` objective (constrained-space density) so MAP
results match the reference (pystan optimizing vs sampling semantics).

Stan "soft priors" on transformed quantities (q, dups, x_sum) carry no
Jacobian terms, exactly as in the Stan programs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .priors import exponential_lpdf, inv_gamma_lpdf, normal_lpdf, std_normal_lpdf


class DistConfig(NamedTuple):
    """Static per-distribution configuration (hashable)."""
    name: str
    dist_type: str          # 'series' | 'parallel'
    kernel: str = "DRT"     # 'DRT' | 'DDT' (informational)
    K: int = 0              # number of basis functions


class PosteriorConfig(NamedTuple):
    """Static model configuration selecting the Stan-model-equivalent."""
    dists: tuple            # tuple[DistConfig, ...]
    nonneg: bool = False
    outliers: bool = False
    fitY: bool = False
    part: str = "both"      # 'both' | 'real' | 'imag' (likelihood mask)
    ncp: bool = False       # non-centered coefficients: sample z with
                            # x = ups * z (elementwise; log-additive for
                            # nonneg), log|J| = sum(log ups). A pure change
                            # of variables — the posterior over (x, ups, ...)
                            # is IDENTICAL — that removes the multiplicative
                            # ups->x funnel the centered form gives NUTS.
    sa: bool = False        # _SA variant: data.A holds the row-equilibrated
                            # SA = S @ A and predictions are un-scaled via
                            # data.sa_inv before the likelihood (fitY only).

    @property
    def n_series(self):
        return sum(1 for d in self.dists if d.dist_type == "series")

    @property
    def n_parallel(self):
        return sum(1 for d in self.dists if d.dist_type == "parallel")

    def model_name(self) -> str:
        """Reference-style model name (reference: inversion.py:1579-1610)."""
        ns, npar = self.n_series, self.n_parallel
        if ns == 1 and npar == 0:
            name = "Series"
        elif ns == 0 and npar == 1:
            name = "Parallel"
        elif ns == 1 and npar == 1:
            name = "Series-Parallel"
        elif ns == 1 and npar == 2:
            name = "Series-2Parallel"
        else:
            name = "MultiDist"
        if self.nonneg and ns >= 1:
            name += "_pos"
        if self.fitY:
            name += "_fitY"
        if self.sa:
            name += "_SA"
        if self.outliers:
            name += "_outliers"
        return name


class PosteriorData(NamedTuple):
    """Numeric inputs (pytree; vmappable over a batch of spectra)."""
    A: tuple                # per dist: (2N, K) stacked [[A'], [A'']]
    L: tuple                # per dist: (3, K, K) mode-scaled L0/L1/L2
    target: jax.Array       # (2N,) stacked Z (or Y when fitY)
    freq: jax.Array         # (N,)
    sigma_min: jax.Array
    ups_alpha: jax.Array
    ups_beta: jax.Array
    induc_scale: jax.Array
    x_sum_invscale: jax.Array
    x_scales: tuple         # per dist scalar (xp_scale for parallel dists)
    sigma_out_lambda: jax.Array
    sigma_out_alpha: jax.Array
    sigma_out_beta: jax.Array
    lik_mask: jax.Array     # (2N,) 1/0 mask for part='both'/'real'/'imag'
    sa_inv: object = None   # (2N,) S_inv diagonal when cfg.sa (else None;
                            # None is an empty pytree leaf so existing
                            # programs/caches are unaffected)


def _x_is_positive(cfg: PosteriorConfig, dist: DistConfig) -> bool:
    if dist.dist_type == "parallel":
        return True
    return cfg.nonneg


def init_unconstrained(cfg: PosteriorConfig, data: PosteriorData, key,
                       init_values: Optional[dict] = None, jitter: float = 2.0):
    """Stan-style random init: unconstrained ~ U(-jitter, jitter)
    (Stan default init=2), optionally overridden by constrained-space
    ``init_values`` (e.g. from a ridge fit, reference: inversion.py:1616-1682).
    """
    n = data.freq.shape[0]
    shapes = {}
    for i, d in enumerate(cfg.dists):
        shapes[f"x_{i}"] = (d.K,)
        shapes[f"ups_raw_{i}"] = (d.K,)
        shapes[f"d_strength_{i}"] = (3,)
    if not cfg.fitY:
        shapes["Rinf_raw"] = ()
        shapes["induc_raw"] = ()
    shapes["sigma_res_raw"] = ()
    shapes["alpha_prop_raw"] = ()
    shapes["alpha_re_raw"] = ()
    shapes["alpha_im_raw"] = ()
    if cfg.outliers:
        shapes["sigma_out_raw"] = (n,)
        shapes["sigma_out_scale"] = (n,)

    keys = jax.random.split(key, len(shapes))
    params = {name: jax.random.uniform(k, shape, minval=-jitter, maxval=jitter)
              for k, (name, shape) in zip(keys, sorted(shapes.items()))}

    if init_values:
        iv = dict(init_values)
        if "Rinf_raw" in iv and not cfg.fitY:
            params["Rinf_raw"] = jnp.log(jnp.clip(jnp.asarray(iv["Rinf_raw"]), 1e-10, None))
        if "induc_raw" in iv and not cfg.fitY:
            params["induc_raw"] = jnp.log(jnp.clip(jnp.asarray(iv["induc_raw"]), 1e-10, None))
        for i, d in enumerate(cfg.dists):
            key_i = f"x_{i}"
            if key_i in iv:
                # constrain() applies x = x_raw * x_scale, so invert the
                # scale here as well as the exp (and ncp) transforms
                x0 = jnp.asarray(iv[key_i]) / data.x_scales[i]
                ups_i = jnp.exp(params[f"ups_raw_{i}"]) * 0.15
                if _x_is_positive(cfg, d):
                    u0 = jnp.log(jnp.clip(x0, 1e-10, None))
                    params[key_i] = u0 - jnp.log(ups_i) if cfg.ncp else u0
                else:
                    # exact zeros (active-set QP ridge inits) sit on the
                    # sqrt penalty's non-differentiable point -> NaN
                    # gradient at the very first L-BFGS step; nudge to a
                    # tiny interior value (cvxopt's interior-point ridge,
                    # which the reference inits from, never returns exact
                    # zeros)
                    x0 = jnp.where(x0 == 0.0, 1e-8, x0)
                    params[key_i] = x0 / ups_i if cfg.ncp else x0
        if "sigma_out_raw" in iv and cfg.outliers:
            params["sigma_out_raw"] = jnp.log(jnp.clip(jnp.asarray(iv["sigma_out_raw"]),
                                                       1e-10, None))
    return params


def constrain(cfg: PosteriorConfig, data: PosteriorData, params: dict) -> dict:
    """Map unconstrained parameters to the Stan-model quantities
    (Rinf, induc, per-dist x, error-structure parameters)."""
    out = {}
    if not cfg.fitY:
        out["Rinf"] = jnp.exp(params["Rinf_raw"]) * 100.0
        out["induc"] = jnp.exp(params["induc_raw"]) * data.induc_scale
    else:
        out["Rinf"] = jnp.zeros(())
        out["induc"] = jnp.zeros(())
    for i, d in enumerate(cfg.dists):
        ups = jnp.exp(params[f"ups_raw_{i}"]) * 0.15
        out[f"ups_{i}"] = ups
        out[f"d_strength_{i}"] = jnp.exp(params[f"d_strength_{i}"])
        u = params[f"x_{i}"]
        if _x_is_positive(cfg, d):
            x_raw = jnp.exp(u) * ups if cfg.ncp else jnp.exp(u)
        else:
            x_raw = u * ups if cfg.ncp else u
        out[f"x_raw_{i}"] = x_raw
        out[f"x_{i}"] = x_raw * data.x_scales[i]
    out["sigma_res"] = jnp.exp(params["sigma_res_raw"]) * 0.05
    out["alpha_prop"] = jnp.exp(params["alpha_prop_raw"]) * 0.05
    out["alpha_re"] = jnp.exp(params["alpha_re_raw"]) * 0.05
    out["alpha_im"] = jnp.exp(params["alpha_im_raw"]) * 0.05
    if cfg.outliers:
        out["sigma_out"] = (jnp.exp(params["sigma_out_raw"])
                            * jnp.exp(params["sigma_out_scale"]) * 0.05)
    return out


def predict_target(cfg: PosteriorConfig, data: PosteriorData, c: dict):
    """Model prediction of the stacked target vector.

    Series dists contribute A @ x; parallel dists contribute the elementwise
    complex inversion of Y = A @ x (reference: Parallel_modelcode.txt:45-49);
    R_inf and inductance offsets added unless fitY."""
    n = data.freq.shape[0]
    pred = jnp.zeros_like(data.target)
    for i, d in enumerate(cfg.dists):
        contrib = data.A[i] @ c[f"x_{i}"]
        if d.dist_type == "parallel" and not cfg.fitY:
            y_re, y_im = contrib[:n], contrib[n:]
            denom = y_re**2 + y_im**2
            contrib = jnp.concatenate([y_re / denom, -y_im / denom])
        pred = pred + contrib
    if cfg.sa:
        # _SA model: Y_hat = S_inv @ (SA @ x)
        # (reference: Parallel_fitY_SA_modelcode.txt:45-46)
        pred = data.sa_inv * pred
    if not cfg.fitY:
        rinf_vec = jnp.concatenate([jnp.ones(n), jnp.zeros(n)])
        induc_vec = jnp.concatenate([jnp.zeros(n), 2.0 * jnp.pi * data.freq])
        pred = pred + c["Rinf"] * rinf_vec + c["induc"] * induc_vec
    return pred


def sigma_tot(cfg: PosteriorConfig, data: PosteriorData, c: dict, pred):
    """Heteroscedastic error scale (reference: Series_modelcode.txt:48-49)."""
    n = data.freq.shape[0]
    pred_re = jnp.tile(pred[:n], 2)
    pred_im = jnp.tile(pred[n:], 2)
    var = (data.sigma_min**2 + c["sigma_res"]**2 + (c["alpha_prop"] * pred)**2
           + (c["alpha_re"] * pred_re)**2 + (c["alpha_im"] * pred_im)**2)
    if cfg.outliers:
        var = var + jnp.tile(c["sigma_out"], 2)**2
    return jnp.sqrt(var)


def outlier_monitor_indices(n: int) -> tuple:
    """Frequency indices at which sigma_out is monitored for rank statistics
    (simulation-based calibration of the ``_outliers`` model variants).
    Shared by the batch summarizer's ``monitor_draws`` and
    ``sbc.generate_datasets`` so the monitor columns line up by
    construction."""
    return (n // 5, n // 2, (4 * n) // 5)


def log_density(cfg: PosteriorConfig, data: PosteriorData, params: dict,
                jacobian: bool = True):
    """Joint log density matching the Stan programs' model blocks.

    jacobian=True: sampling measure on the unconstrained space (Stan NUTS).
    jacobian=False: Stan's ``optimizing`` objective (MAP in constrained space).
    """
    c = constrain(cfg, data, params)
    lp = jnp.zeros(())

    # log|J| of the exp transforms for all <lower=0> parameters
    if jacobian:
        for name, u in params.items():
            if name.startswith("x_"):
                i = int(name.split("_")[1])
                if not _x_is_positive(cfg, cfg.dists[i]):
                    continue
            lp = lp + jnp.sum(u)
        if cfg.ncp:
            # x = ups * z (free sign: dx/dz = ups) or x = exp(u) * ups
            # (positive: the sum(u) above covers d exp(u), leaving the
            # same extra sum(log ups) factor)
            for i in range(len(cfg.dists)):
                lp = lp + jnp.sum(jnp.log(c[f"ups_{i}"]))

    # priors on raw scalars (reference: Series_modelcode.txt:55-69)
    if not cfg.fitY:
        lp = lp + std_normal_lpdf(jnp.exp(params["Rinf_raw"]))
        lp = lp + std_normal_lpdf(jnp.exp(params["induc_raw"]))
    lp = lp + std_normal_lpdf(jnp.exp(params["sigma_res_raw"]))
    if not cfg.fitY:
        # the fitY model omits the alpha_* priors (Parallel_fitY_modelcode.txt:66)
        lp = lp + std_normal_lpdf(jnp.exp(params["alpha_prop_raw"]))
        lp = lp + std_normal_lpdf(jnp.exp(params["alpha_re_raw"]))
        lp = lp + std_normal_lpdf(jnp.exp(params["alpha_im_raw"]))

    x_raw_sum = jnp.zeros(())
    for i, d in enumerate(cfg.dists):
        ds = c[f"d_strength_{i}"]
        lp = lp + inv_gamma_lpdf(ds, 5.0, 5.0)
        ups_raw = jnp.exp(params[f"ups_raw_{i}"])
        lp = lp + inv_gamma_lpdf(ups_raw, data.ups_alpha, data.ups_beta)
        x_raw = c[f"x_raw_{i}"]
        # NOTE: a stacked [A; L0; L1; L2] @ x_raw single-GEMM variant is
        # an untested alternative to these four separate matvecs.
        L = data.L[i]
        q = jnp.sqrt(ds[0] * (L[0] @ x_raw)**2 + ds[1] * (L[1] @ x_raw)**2
                     + ds[2] * (L[2] @ x_raw)**2)
        ups = c[f"ups_{i}"]
        lp = lp + normal_lpdf(q, 0.0, ups)
        dups = 0.5 * (ups[1:-1] - 0.5 * (ups[:-2] + ups[2:])) / ups[1:-1]
        lp = lp + std_normal_lpdf(dups)
        x_raw_sum = x_raw_sum + jnp.sum(x_raw)

    # soft sum constraint for multi-distribution models
    # (reference: Series-Parallel_modelcode.txt:56-57, 89)
    if len(cfg.dists) > 1:
        lp = lp + std_normal_lpdf(x_raw_sum * data.x_sum_invscale)

    if cfg.outliers:
        sigma_out_raw = jnp.exp(params["sigma_out_raw"])
        sigma_out_scale = jnp.exp(params["sigma_out_scale"])
        lp = lp + exponential_lpdf(sigma_out_raw, data.sigma_out_lambda)
        lp = lp + inv_gamma_lpdf(sigma_out_scale, data.sigma_out_alpha,
                                 data.sigma_out_beta)

    pred = predict_target(cfg, data, c)
    st = sigma_tot(cfg, data, c, pred)
    z = (data.target - pred) / st
    loglik_terms = (-0.5 * z * z - jnp.log(st)
                    - 0.5 * jnp.log(2.0 * jnp.pi)) * data.lik_mask
    lp = lp + jnp.sum(loglik_terms)
    return lp


def make_log_density(cfg: PosteriorConfig, data: PosteriorData,
                     jacobian: bool = True):
    """Closure suitable for jit/grad/vmap."""
    def f(params):
        return log_density(cfg, data, params, jacobian=jacobian)
    return f
