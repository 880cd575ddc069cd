"""Round-3 additions: adaptive samplers (ChEES / synchronous static
multinomial HMC), in-program ESS, pointwise gamma credible bands, the
promoted first-class batched ridge, and ragged-path parity."""

import numpy as np
import pandas as pd
import pytest

import jax
import jax.numpy as jnp

from bayes_drt_tpu import progcache
from bayes_drt_tpu.infer.chees import (ChEESConfig, SHMCConfig, sample_chees,
                                       sample_shmc)
from bayes_drt_tpu.infer.diagnostics import ess, ess_jnp
from bayes_drt_tpu.parallel import (evaluate_gamma, fit_spectra_batch,
                                    fit_spectra_ragged, make_mesh,
                                    ridge_fit_spectra_batch)


def load_batch(b=4, noise=0.002, seed=0):
    df = pd.read_csv("/root/reference/data/simulated/Z_ZARC_Macdonald_0.25.csv")
    freq = df["Freq"].values
    Z = df["Zreal"].values + 1j * df["Zimag"].values
    rng = np.random.default_rng(seed)
    Zb = Z[None, :] + noise * (rng.standard_normal((b, len(Z)))
                               + 1j * rng.standard_normal((b, len(Z))))
    return freq, Zb


def _gaussian_target(d=8, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(d, d))
    cov = a @ a.T / d + np.eye(d) * 0.1
    prec = jnp.asarray(np.linalg.inv(cov))
    return cov, (lambda q: -0.5 * q @ prec @ q)


# ---------------------------------------------------------------- samplers

def test_ess_jnp_matches_numpy_estimator():
    rng = np.random.default_rng(0)
    x = np.zeros((4, 300, 3))
    e = rng.normal(size=(4, 301, 3))
    for t in range(300):
        x[:, t] = (0.7 * x[:, t - 1] if t else e[:, 0]) + e[:, t + 1]
    a = ess(x)
    b = np.asarray(jax.jit(ess_jnp)(jnp.asarray(x)))
    np.testing.assert_allclose(a, b, rtol=1e-10)
    # vmaps over a batch axis
    vb = jax.vmap(ess_jnp)(jnp.asarray(np.stack([x, x])))
    np.testing.assert_allclose(np.asarray(vb[0]), a, rtol=1e-10)


def test_chees_samples_correlated_gaussian():
    cov, logp = _gaussian_target()
    d = cov.shape[0]
    key = jax.random.PRNGKey(0)
    q0 = jax.random.normal(key, (4, d))
    draws, info = sample_chees(logp, q0, key, warmup=400, samples=400,
                               cfg=ChEESConfig())
    flat = np.asarray(draws).reshape(-1, d)
    assert np.abs(flat.mean(axis=0)).max() < 0.25
    emp = np.cov(flat.T)
    assert np.max(np.abs(emp - cov) / (np.abs(cov) + 0.2)) < 0.5
    assert float(np.mean(info["diverging"])) < 0.01
    # trajectory adaptation engaged and the state is finite
    assert np.isfinite(float(info["traj_time"]))
    assert float(ess(np.asarray(draws)).min()) > 100


def test_shmc_samples_correlated_gaussian():
    cov, logp = _gaussian_target()
    d = cov.shape[0]
    key = jax.random.PRNGKey(1)
    q0 = jax.random.normal(key, (4, d))
    draws, info = sample_shmc(logp, q0, key, warmup=400, samples=400,
                              cfg=SHMCConfig(n_steps=16))
    flat = np.asarray(draws).reshape(-1, d)
    assert np.abs(flat.mean(axis=0)).max() < 0.25
    emp = np.cov(flat.T)
    assert np.max(np.abs(emp - cov) / (np.abs(cov) + 0.2)) < 0.5
    assert float(np.mean(info["diverging"])) < 0.01
    # every draw of every chain runs exactly n_steps leapfrogs (the
    # batch-synchronous property the design is built on)
    assert np.all(np.asarray(info["n_leapfrog"]) == 16)
    assert float(ess(np.asarray(draws)).min()) > 100


def test_shmc_recompute_grad_bit_identical():
    """recompute_grad only changes WHERE the selected state's gradient is
    computed (once per draw instead of a masked select per leaf) — the
    sampled chain must be bit-identical on the deterministic CPU backend."""
    cov, logp = _gaussian_target()
    d = cov.shape[0]
    key = jax.random.PRNGKey(3)
    q0 = jax.random.normal(key, (4, d))
    base, _ = sample_shmc(logp, q0, key, warmup=200, samples=200,
                          cfg=SHMCConfig(n_steps=16))
    slim, _ = sample_shmc(logp, q0, key, warmup=200, samples=200,
                          cfg=SHMCConfig(n_steps=16, recompute_grad=True))
    np.testing.assert_array_equal(np.asarray(base), np.asarray(slim))


def test_shmc_eps_quantile():
    """eps_quantile=0 is the pooled-min default (bit-identical); a positive
    quantile freezes a larger sampling eps and still samples the target."""
    cov, logp = _gaussian_target()
    d = cov.shape[0]
    key = jax.random.PRNGKey(5)
    q0 = jax.random.normal(key, (4, d))
    base, _ = sample_shmc(logp, q0, key, warmup=200, samples=200,
                          cfg=SHMCConfig(n_steps=16))
    zero, _ = sample_shmc(logp, q0, key, warmup=200, samples=200,
                          cfg=SHMCConfig(n_steps=16, eps_quantile=0.0))
    np.testing.assert_array_equal(np.asarray(base), np.asarray(zero))

    med, info_m = sample_shmc(logp, q0, key, warmup=200, samples=200,
                              cfg=SHMCConfig(n_steps=16, eps_quantile=0.5))
    assert float(info_m["step_size"].min()) > 0.0
    flat = np.asarray(med).reshape(-1, d)
    assert np.abs(flat.mean(axis=0)).max() < 0.25
    emp = np.cov(flat.T)
    assert np.max(np.abs(emp - cov) / (np.abs(cov) + 0.2)) < 0.5


def test_shmc_precision_knob():
    """SHMCConfig(precision=) selects the matmul precision the sampler
    program is traced under. On the CPU backend every precision lowers to
    the same f64/f32 dot, so 'high' must be bit-identical to the 'highest'
    default — this pins the knob's plumbing (cfg-aware wrapper, program
    cache keying), while an accelerator A/B (benchmarks/precision_gates.py)
    measures its effect where the two precisions actually differ."""
    cov, logp = _gaussian_target()
    d = cov.shape[0]
    key = jax.random.PRNGKey(7)
    q0 = jax.random.normal(key, (4, d))
    base, _ = sample_shmc(logp, q0, key, warmup=200, samples=200,
                          cfg=SHMCConfig(n_steps=16))
    high, _ = sample_shmc(logp, q0, key, warmup=200, samples=200,
                          cfg=SHMCConfig(n_steps=16, precision="high"))
    np.testing.assert_array_equal(np.asarray(base), np.asarray(high))


def test_shmc_rbg_stream_samples_correctly():
    """rng_impl='rbg' re-keys onto the hardware RngBitGenerator stream —
    different draws, same target distribution."""
    cov, logp = _gaussian_target()
    d = cov.shape[0]
    key = jax.random.PRNGKey(4)
    q0 = jax.random.normal(key, (4, d))
    draws, info = sample_shmc(logp, q0, key, warmup=400, samples=400,
                              cfg=SHMCConfig(n_steps=16, rng_impl="rbg"))
    flat = np.asarray(draws).reshape(-1, d)
    assert np.abs(flat.mean(axis=0)).max() < 0.25
    emp = np.cov(flat.T)
    assert np.max(np.abs(emp - cov) / (np.abs(cov) + 0.2)) < 0.5
    assert float(np.mean(info["diverging"])) < 0.01


@pytest.mark.parametrize("sampler", ["chees", "shmc"])
def test_adaptive_sampler_batch_smoke(sampler):
    freq, Zb = load_batch(b=2)
    gt = pd.read_csv("/root/reference/data/simulated/gamma_ZARC.csv")
    res = fit_spectra_batch(freq, Zb, mode="sample", chains=2, warmup=60,
                            samples=60, ncp=True, sampler=sampler,
                            random_seed=0, gamma_eval_tau=gt["tau"].values)
    d = res.diagnostics
    assert np.isfinite(res.coef).all()
    for k in ("min_ess", "ess_logp", "gamma_eval_mean", "gamma_eval_lo",
              "gamma_eval_hi", "state_q", "state_inv_mass",
              "state_step_size"):
        assert k in d, k
    assert (d["gamma_eval_lo"] <= d["gamma_eval_hi"] + 1e-12).all()
    assert (d["min_ess"] > 0).all()
    if sampler == "chees":
        assert "state_traj_time" in d


def test_shmc_warm_start_refit():
    freq, Zb = load_batch(b=2)
    res0 = fit_spectra_batch(freq, Zb, mode="sample", chains=2, warmup=60,
                             samples=60, ncp=True, sampler="shmc",
                             random_seed=0)
    res1 = fit_spectra_batch(freq, Zb, mode="sample", chains=2, warmup=10,
                             samples=60, ncp=True, sampler="shmc",
                             random_seed=1, warm_start=res0)
    assert np.isfinite(res1.coef).all()
    # warm refit keeps recovery in the same ballpark as the source fit
    gt = pd.read_csv("/root/reference/data/simulated/gamma_ZARC.csv")
    g0 = evaluate_gamma(res0, gt["tau"].values)
    g1 = evaluate_gamma(res1, gt["tau"].values)
    rp = np.trapezoid(gt["gamma"].values, np.log(gt["tau"].values))
    r0 = np.sqrt(np.mean((g0.mean(0) - gt["gamma"].values) ** 2))
    r1 = np.sqrt(np.mean((g1.mean(0) - gt["gamma"].values) ** 2))
    assert r1 < max(2.0 * r0, 0.08 * rp), (r0, r1)


def test_warm_start_batch_size_mismatch_raises():
    freq, Zb = load_batch(b=2)
    res0 = fit_spectra_batch(freq, Zb, mode="sample", chains=2, warmup=30,
                             samples=20, ncp=True, tree_scan=True,
                             random_seed=0)
    freq3, Zb3 = load_batch(b=3)
    with pytest.raises(ValueError, match="batch layout"):
        fit_spectra_batch(freq3, Zb3, mode="sample", chains=2, warmup=10,
                          samples=10, ncp=True, tree_scan=True,
                          warm_start=res0)


def test_da_init_seeds_eps_bar():
    """warmup=0 resumes must sample at the carried step size, not eps=1
    (advisor round-2 finding)."""
    from bayes_drt_tpu.infer.nuts import _da_init
    da = _da_init(jnp.asarray(0.37), jnp.float64)
    np.testing.assert_allclose(float(jnp.exp(da.log_eps_bar)), 0.37,
                               rtol=1e-12)


def test_gamma_eval_bands_contain_mean_and_rescale():
    freq, Zb = load_batch(b=2)
    gt = pd.read_csv("/root/reference/data/simulated/gamma_ZARC.csv")
    res = fit_spectra_batch(freq, Zb, mode="sample", chains=2, warmup=60,
                            samples=80, ncp=True, tree_scan=True,
                            max_tree_depth=5, random_seed=0,
                            gamma_eval_tau=gt["tau"].values)
    d = res.diagnostics
    lo, mid, hi = (d["gamma_eval_lo"], d["gamma_eval_mean"],
                   d["gamma_eval_hi"])
    assert (lo <= mid + 1e-9).all() and (mid <= hi + 1e-9).all()
    # rescaled to physical units: the posterior-mean band center must agree
    # with the rescaled coefficient curve
    g = evaluate_gamma(res, gt["tau"].values)
    np.testing.assert_allclose(mid, g, rtol=0.3, atol=0.05)
    # pointwise bands are on average tighter than the conservative
    # per-coefficient bands pushed through the all-positive basis (not a
    # pointwise guarantee — coefficient correlations can locally invert it)
    glo_cons = evaluate_gamma(res, gt["tau"].values, which="lo")
    ghi_cons = evaluate_gamma(res, gt["tau"].values, which="hi")
    assert (hi - lo).mean() <= (ghi_cons - glo_cons).mean() + 1e-6


# ------------------------------------------------------------ batched ridge

def test_ridge_batch_weights_vocabulary():
    freq, Zb = load_batch(b=3)
    gt = pd.read_csv("/root/reference/data/simulated/gamma_ZARC.csv")
    rp = np.trapezoid(gt["gamma"].values, np.log(gt["tau"].values))
    # proportional/prop_adj weight by 1/|Z'|, 1/|Z''| separately, which
    # up-weights near-zero imaginary points at the frequency extremes —
    # intrinsically noisier recovery on this workload (true of the
    # reference's weighting too), hence the looser gate
    for w, gate in (("unity", 0.10), ("modulus", 0.10), ("Orazem", 0.10),
                    ("proportional", 0.25), ("prop_adj", 0.25),
                    (None, 0.10), (2.0, 0.10)):
        res = ridge_fit_spectra_batch(freq, Zb, weights=w)
        g = evaluate_gamma(res, gt["tau"].values)
        rmse = np.sqrt(np.mean((g - gt["gamma"].values[None, :]) ** 2,
                               axis=1))
        assert (rmse < gate * rp).all(), (w, rmse)
    with pytest.raises(ValueError, match="Invalid weights"):
        ridge_fit_spectra_batch(freq, Zb, weights="bogus")


def test_ridge_batch_ordinary_mode():
    freq, Zb = load_batch(b=3)
    res = ridge_fit_spectra_batch(freq, Zb, hyper_lambda=False, lambda_0=0.1,
                                  penalty="discrete")
    assert np.isfinite(res.coef).all()
    assert (res.diagnostics["n_iter"] == 1).all()
    gt = pd.read_csv("/root/reference/data/simulated/gamma_ZARC.csv")
    g = evaluate_gamma(res, gt["tau"].values)
    rp = np.trapezoid(gt["gamma"].values, np.log(gt["tau"].values))
    rmse = np.sqrt(np.mean((g - gt["gamma"].values[None, :]) ** 2, axis=1))
    assert (rmse < 0.2 * rp).all(), rmse


def test_ridge_batch_reim_cv_matches_serial():
    """Batched Re-Im CV (one lax.scan program over the lambda grid) must
    reproduce the serial Inverter.ridge_ReImCV loop: identical normalized
    CV curves and the same selected lambda (reference: inversion.py:902-945
    — incl. the part-fit offset recovery at 854-873, without which the
    imag-fit's missing R_inf floods recv and flattens the curve)."""
    from bayes_drt_tpu import Inverter

    df = pd.read_csv("/root/reference/data/simulated/Z_ZARC_Macdonald_0.25.csv")
    freq = df["Freq"].values
    Z = df["Zreal"].values + 1j * df["Zimag"].values
    lams = np.logspace(-7, 3, 11)
    kw = dict(penalty="discrete", reg_ord=2, nonneg=True, weights="modulus",
              hyper_lambda=False)

    inv = Inverter()
    lam_serial = inv.ridge_ReImCV(freq, Z, lambdas=lams, **kw)
    serial = np.log10(inv.cv_result["totcv"].values)

    res = ridge_fit_spectra_batch(freq, Z[None, :], penalty="discrete",
                                  hyper_lambda=False, cv_lambdas=lams)
    d = res.diagnostics
    assert d["cv_lambda"][0] == lam_serial
    batched = np.log10(d["cv_totcv"][0])
    # identical curves up to the per-spectrum z-scale (a constant shift)
    np.testing.assert_allclose(batched - batched.min(),
                               serial - serial.min(), atol=1e-6)
    # the CV-selected fit itself is sound
    gt = pd.read_csv("/root/reference/data/simulated/gamma_ZARC.csv")
    g = evaluate_gamma(res, gt["tau"].values)
    rp = np.trapezoid(gt["gamma"].values, np.log(gt["tau"].values))
    rmse = np.sqrt(np.mean((g[0] - gt["gamma"].values) ** 2))
    assert rmse < 0.2 * rp, rmse


def test_ridge_batch_cv_hyper_lambda_batch():
    """CV over the hyper-lambda solver on a real batch: per-spectrum
    selection, full diagnostics, boundary warning when the grid is
    too narrow."""
    freq, Zb = load_batch(b=3)
    lams = np.logspace(-4, 1, 5)
    res = ridge_fit_spectra_batch(freq, Zb, cv_lambdas=lams, max_iter=8)
    d = res.diagnostics
    assert d["cv_lambda"].shape == (3,)
    assert d["cv_totcv"].shape == (3, 5)
    assert np.isfinite(res.coef).all()
    assert np.all(np.isin(d["cv_lambda"], lams))
    gt = pd.read_csv("/root/reference/data/simulated/gamma_ZARC.csv")
    g = evaluate_gamma(res, gt["tau"].values)
    rp = np.trapezoid(gt["gamma"].values, np.log(gt["tau"].values))
    rmse = np.sqrt(np.mean((g - gt["gamma"].values[None, :]) ** 2, axis=1))
    assert (rmse < 0.15 * rp).all(), rmse
    # a grid whose optimum sits on the boundary must warn
    with pytest.warns(UserWarning, match="boundary lambda"):
        ridge_fit_spectra_batch(freq, Zb, hyper_lambda=False,
                                penalty="discrete",
                                cv_lambdas=np.logspace(1, 3, 3))


def test_ridge_batch_hyper_weights_downweights_outliers():
    """Batched Effat-Ciucci outlier-robust ridge: corrupted points get
    small fitted weights and the recovery stays clean (reference:
    inversion.py:757-833, one spectrum at a time)."""
    from bayes_drt_tpu import Inverter

    freq, Zb = load_batch(b=3)
    bad = np.array([7, 23])
    Zb_bad = Zb.copy()
    Zb_bad[:, bad] *= (1.35 - 0.3j)      # gross corruption
    res = ridge_fit_spectra_batch(freq, Zb_bad, hyper_lambda=False,
                                  hyper_weights=True, penalty="discrete",
                                  lambda_0=1e-3)
    d = res.diagnostics
    w = np.abs(d["weights_re"] + 1j * d["weights_im"])   # (B, N)
    # weights come back in the CALLER's point order: the corrupted points
    # carry the SMALLEST weights in every spectrum, at their raw indices
    assert (np.sort(np.argsort(w, axis=1)[:, :2], axis=1)
            == np.sort(bad)[None, :]).all(), w[:, bad]
    gt = pd.read_csv("/root/reference/data/simulated/gamma_ZARC.csv")
    g = evaluate_gamma(res, gt["tau"].values)
    rp = np.trapezoid(gt["gamma"].values, np.log(gt["tau"].values))
    rmse = np.sqrt(np.mean((g - gt["gamma"].values[None, :]) ** 2, axis=1))
    assert (rmse < 0.15 * rp).all(), rmse
    # exact parity with the single-spectrum path (machine precision)
    inv = Inverter()
    inv.ridge_fit(freq, Zb_bad[0], hyper_lambda=False, hyper_weights=True,
                  penalty="discrete", lambda_0=1e-3)
    w_s = np.abs(inv.distribution_fits["DRT"]["weights"])
    order = np.argsort(np.asarray(freq, float))[::-1]
    np.testing.assert_allclose(w[0][order], w_s[order],
                               rtol=1e-10, atol=1e-12)
    # ascending-frequency input: same weights, still in the caller's order
    res_a = ridge_fit_spectra_batch(freq[::-1].copy(),
                                    Zb_bad[:, ::-1].copy(),
                                    hyper_lambda=False, hyper_weights=True,
                                    penalty="discrete", lambda_0=1e-3)
    w_a = np.abs(res_a.diagnostics["weights_re"]
                 + 1j * res_a.diagnostics["weights_im"])
    np.testing.assert_allclose(w_a, w[:, ::-1], rtol=1e-8, atol=1e-10)
    with pytest.raises(ValueError, match="cannot be combined"):
        ridge_fit_spectra_batch(freq, Zb_bad, hyper_weights=True)


def test_ridge_batch_program_cached_across_calls():
    """Second call with identical shapes must reuse the cached program —
    the round-2 'NEVER close a fresh jit over big arrays per call' rule."""
    freq, Zb = load_batch(b=3, seed=1)
    ridge_fit_spectra_batch(freq, Zb)      # ensure the program exists
    n1 = len(progcache._PROGRAM_CACHE)
    freq2, Zb2 = load_batch(b=3, seed=2)   # same shapes, different values
    ridge_fit_spectra_batch(freq2, Zb2)
    assert len(progcache._PROGRAM_CACHE) == n1   # reused, no new program
    freq3, Zb3 = load_batch(b=16, seed=3)  # new batch shape -> one new entry
    ridge_fit_spectra_batch(freq3, Zb3)
    assert len(progcache._PROGRAM_CACHE) == n1 + 1


def test_ridge_batch_actually_partitions():
    freq, Zb = load_batch(b=8)
    mesh = make_mesh(8)
    res = ridge_fit_spectra_batch(freq, Zb, mesh=mesh)
    layout = res.diagnostics["shard_layout"]
    device_ids = [d for d, _, _ in layout]
    assert len(set(device_ids)) == 8, layout
    ranges = sorted((lo, hi) for _, lo, hi in layout)
    assert ranges == [(i, i + 1) for i in range(8)], layout
    # and matches the unsharded result
    res_u = ridge_fit_spectra_batch(freq, Zb)
    np.testing.assert_allclose(res.coef, res_u.coef, rtol=1e-5, atol=1e-7)


def test_ridge_batch_cv_partitions_across_mesh():
    """The CV program (scan-over-grid around the vmapped solver) must
    physically partition the batch like the plain program does."""
    freq, Zb = load_batch(b=8)
    mesh = make_mesh(8)
    lams = np.logspace(-4, 0, 3)
    res = ridge_fit_spectra_batch(freq, Zb, hyper_lambda=False,
                                  penalty="discrete", cv_lambdas=lams,
                                  mesh=mesh)
    layout = res.diagnostics["shard_layout"]
    assert len({d for d, _, _ in layout}) == 8, layout
    res_u = ridge_fit_spectra_batch(freq, Zb, hyper_lambda=False,
                                    penalty="discrete", cv_lambdas=lams)
    np.testing.assert_allclose(res.coef, res_u.coef, rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(res.diagnostics["cv_lambda"],
                                  res_u.diagnostics["cv_lambda"])


# ------------------------------------------------------------- ragged parity

def _ragged_spectra(b=2, noise=0.002, seed=0):
    d1 = pd.read_csv("/root/reference/data/simulated/Z_ZARC_Macdonald_0.25.csv")
    d2 = pd.read_csv("/root/reference/data/simulated/Z_trunc_noiseless.csv")
    return [
        (d1["Freq"].values, d1["Zreal"].values + 1j * d1["Zimag"].values),
        (d2["Freq"].values, d2["Zreal"].values + 1j * d2["Zimag"].values),
    ]


def test_ragged_full_diagnostics_and_bands():
    gt = pd.read_csv("/root/reference/data/simulated/gamma_ZARC.csv")
    res = fit_spectra_ragged(_ragged_spectra(), mode="sample", chains=2,
                             warmup=50, samples=50, max_tree_depth=6,
                             random_seed=0, ncp=True, tree_scan=True,
                             gamma_eval_tau=gt["tau"].values)
    d = res.diagnostics
    for k in ("min_ess", "ess_logp", "logp_rhat", "state_q",
              "state_inv_mass", "state_step_size", "gamma_eval_mean",
              "gamma_eval_lo", "gamma_eval_hi"):
        assert k in d, k
    assert d["min_ess"].shape == (2,)
    assert (d["gamma_eval_lo"] <= d["gamma_eval_hi"] + 1e-12).all()


def test_ragged_warm_start_refit():
    res0 = fit_spectra_ragged(_ragged_spectra(), mode="sample", chains=2,
                              warmup=60, samples=50, max_tree_depth=6,
                              random_seed=0, ncp=True, tree_scan=True)
    res1 = fit_spectra_ragged(_ragged_spectra(), mode="sample", chains=2,
                              warmup=10, samples=50, max_tree_depth=6,
                              random_seed=1, ncp=True, tree_scan=True,
                              warm_start=res0)
    assert np.isfinite(res1.coef).all()
    gt = pd.read_csv("/root/reference/data/simulated/gamma_ZARC.csv")
    g1 = evaluate_gamma(res1, gt["tau"].values)
    rp = np.trapezoid(gt["gamma"].values, np.log(gt["tau"].values))
    rmse0 = np.sqrt(np.mean((g1[0] - gt["gamma"].values) ** 2))
    assert rmse0 < 0.15 * rp, rmse0


def test_ragged_partitions_across_mesh():
    spectra = _ragged_spectra() * 4      # 8 spectra, two grid lengths
    mesh = make_mesh(8)
    res = fit_spectra_ragged(spectra, mode="optimize", n_restarts=1,
                             max_iter=300, random_seed=0, mesh=mesh)
    layout = res.diagnostics["shard_layout"]
    assert len({d for d, _, _ in layout}) == 8, layout
    ranges = sorted((lo, hi) for _, lo, hi in layout)
    assert ranges == [(i, i + 1) for i in range(8)], layout


def test_ragged_ddt_ystar_scaling_parity():
    """Ragged fits use the same calibrated Ystar z-scale rule as the
    uniform-grid batch for a single parallel planar DDT
    (reference: inversion.py:2422-2434)."""
    from bayes_drt_tpu.models.build import z_scale_for
    df = pd.read_csv(
        "/root/reference/data/simulated/Z_BimodalTP-DDT_Macdonald_0.25.csv")
    freq = df["Freq"].values
    Z = df["Zreal"].values + 1j * df["Zimag"].values
    dists = {"DDT": {"kernel": "DDT", "dist_type": "parallel",
                     "symmetry": "planar", "bc": "transmissive"}}
    res = fit_spectra_ragged([(freq, Z)], mode="optimize", n_restarts=1,
                             max_iter=200, random_seed=0,
                             distributions=dists)
    idx = np.argsort(freq)[::-1]
    expected = float(z_scale_for(
        {"DDT": dict(dists["DDT"])}, Z[idx], fit_type="map"))
    np.testing.assert_allclose(res.z_scales[0], expected, rtol=1e-10)
    # and the under-specified dict defaults to bc='blocking' like the
    # Inverter DSL (advisor round-2 finding)
    res2 = fit_spectra_ragged([(freq, Z)], mode="optimize", n_restarts=1,
                              max_iter=200, random_seed=0,
                              distributions={"DDT": {"kernel": "DDT"}})
    expected2 = float(z_scale_for(
        {"DDT": {"kernel": "DDT", "dist_type": "parallel",
                 "symmetry": "planar", "bc": "blocking"}},
        Z[idx], fit_type="map"))
    np.testing.assert_allclose(res2.z_scales[0], expected2, rtol=1e-10)


def test_inverter_fit_shmc_sampler():
    """The single-spectrum Inverter.fit exposes the batch APIs' samplers:
    sampler='shmc' targets the identical posterior and recovers the ZARC
    ground truth at the short budget."""
    from bayes_drt_tpu import Inverter
    df = pd.read_csv("/root/reference/data/simulated/Z_ZARC_Macdonald_0.25.csv")
    freq = df["Freq"].values
    Z = df["Zreal"].values + 1j * df["Zimag"].values
    gt = pd.read_csv("/root/reference/data/simulated/gamma_ZARC.csv")
    rp = np.trapezoid(gt["gamma"].values, np.log(gt["tau"].values))
    inv = Inverter()
    inv.fit(freq, Z, mode="sample", chains=4, warmup=150, samples=150,
            ncp=True, sampler="shmc", random_seed=0, check_outliers=False)
    assert inv.fit_type == "bayes"
    g = inv.predict_distribution("DRT", eval_tau=gt["tau"].values)
    rmse = np.sqrt(np.mean((g - gt["gamma"].values) ** 2))
    assert rmse < 0.05 * rp, rmse
    assert inv.sample_diagnostics["divergence_rate"] < 0.02
    with pytest.raises(ValueError, match="Unknown sampler"):
        inv.fit(freq, Z, mode="sample", sampler="bogus")


def test_batch_apis_accept_ascending_frequencies():
    """Instrument exports often store frequencies ascending; the batch APIs
    build matrices at DESCENDING frequencies, so the data columns must be
    reordered to match (regression: they previously were not, silently
    misaligning every fit of ascending input)."""
    freq, Zb = load_batch(b=2)
    order = np.argsort(freq)            # ascending permutation
    f_asc, Z_asc = freq[order], Zb[:, order]

    r_desc = ridge_fit_spectra_batch(freq, Zb, hyper_lambda=False)
    r_asc = ridge_fit_spectra_batch(f_asc, Z_asc, hyper_lambda=False)
    np.testing.assert_allclose(r_asc.coef, r_desc.coef, rtol=1e-10)
    np.testing.assert_allclose(r_asc.r_inf, r_desc.r_inf, rtol=1e-10)

    m_desc = fit_spectra_batch(freq, Zb, mode="optimize", n_restarts=1,
                               max_iter=60, random_seed=0)
    m_asc = fit_spectra_batch(f_asc, Z_asc, mode="optimize", n_restarts=1,
                              max_iter=60, random_seed=0)
    # identical program + identical (reordered) inputs => identical output
    np.testing.assert_array_equal(m_asc.coef, m_desc.coef)


def test_drift_batch_fits_fleet():
    """drift_fit_spectra_batch: B drifting cells on one sweep schedule fit
    in one program (the fleet form of Inverter.drift_map_fit, reference:
    inversion.py:1291-1564). Gated the same way the single-spectrum drift
    tests are: the fitted drift trajectory reproduces each cell's data."""
    from bayes_drt_tpu.parallel import drift_fit_spectra_batch

    rng = np.random.default_rng(0)
    base_freq = np.logspace(5, -1, 31)
    freq = np.tile(base_freq, 3)
    times = np.linspace(0, 3 * 1800.0, len(freq))
    omega = 2 * np.pi * freq
    Zb = []
    for s in (0.3, 0.7):
        z_static = 1.0 + 1.0 / (1 + (1j * omega * 1e-3) ** 0.85)
        f_t = 1 - np.exp(-times / 600.0)
        z = z_static + f_t * (s / (1 + (1j * omega * 0.05) ** 0.9))
        z += 0.001 * (rng.standard_normal(len(z))
                      + 1j * rng.standard_normal(len(z)))
        Zb.append(z)

    res = drift_fit_spectra_batch(freq, times, np.array(Zb),
                                  drift_model="x1", random_seed=0,
                                  n_restarts=1, min_tau_drift=100.0,
                                  max_iter=1200)
    d = res.diagnostics
    assert res.coef.shape == (2, len(res.tau))
    assert np.isfinite(res.coef).all()
    # the fitted time-evolution reproduces the data (same gate as
    # tests/test_drift.py::test_drift_x1_fit)
    assert (d["median_rel_resid"] < 0.05).all(), d["median_rel_resid"]
    # drift params present, rescaled, and within their bounds
    drift = d["drift"]
    for key in ("x0", "x1", "tau_1", "tau_Rinf", "Rinf_0", "induc"):
        assert key in drift, key
    assert (drift["tau_1"] >= 100.0).all() and (drift["tau_1"] <= 1e4).all()
    # validation errors mirror the single path
    with pytest.raises(ValueError, match="drift_model"):
        drift_fit_spectra_batch(freq, times, np.array(Zb),
                                drift_model="bogus")
    with pytest.raises(ValueError, match="same length"):
        drift_fit_spectra_batch(freq, times[:-1], np.array(Zb))
    # mesh path: rank-1 init arrays must shard too, layout proof recorded
    mesh = make_mesh(8)
    res_m = drift_fit_spectra_batch(freq, times, np.array(Zb),
                                    drift_model="x1", random_seed=0,
                                    n_restarts=1, min_tau_drift=100.0,
                                    max_iter=1200, mesh=mesh)
    layout = res_m.diagnostics["shard_layout"]
    assert len({dev for dev, _, _ in layout}) == 8, layout
    # the sharded program is a different XLA compilation; after 1200
    # L-BFGS steps on a nonconvex posterior FP-association differences
    # compound, so gate on fit QUALITY, not coefficient equality
    assert (res_m.diagnostics["median_rel_resid"] < 0.05).all(), \
        res_m.diagnostics["median_rel_resid"]


def test_batch_ridge_f32_real_instrument_spectrum():
    """Regression: the PDAC ZPlot spectrum (|Z| spanning 1.4e3..1e7 ohms)
    NaN'd the f32 batch ridge outright — cond(P) ~6e13 before the QP's
    Jacobi equilibration existed. Must stay finite and converged in f32
    (the accelerator serving dtype)."""
    import jax.numpy as jnp
    from bayes_drt_tpu.native import load_eis_file
    freq, Z = load_eis_file(
        "/root/reference/data/experimental/"
        "PDAC_COM3_02109_Contact10_2065C_500C.txt")
    res = ridge_fit_spectra_batch(freq, Z[None, :], dtype=jnp.float32)
    assert np.isfinite(res.coef).all()
    assert np.asarray(res.diagnostics["converged"]).all()
    # reconstruction sanity: Rp within 2x of the f64 fit
    rp32 = np.trapezoid(res.coef[0], np.log(res.tau))
    r64 = ridge_fit_spectra_batch(freq, Z[None, :], dtype=jnp.float64)
    rp64 = np.trapezoid(r64.coef[0], np.log(r64.tau))
    assert 0.5 < rp32 / rp64 < 2.0, (rp32, rp64)
