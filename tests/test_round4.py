"""Round-4 additions: traj_store SHMC, Newton MAP certificates, SBC
machinery, monitor draws / z_scale plumbing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bayes_drt_tpu.infer.chees import SHMCConfig, sample_shmc
from bayes_drt_tpu.infer.map import newton_polish, run_lbfgs
from bayes_drt_tpu.parallel.batch import _build_shared, fit_spectra_batch
from bayes_drt_tpu import sbc


def _corr_gauss(d=8, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((d, d))
    cov = a @ a.T / d + np.eye(d)
    prec = jnp.asarray(np.linalg.inv(cov))
    return cov, (lambda q: -0.5 * q @ prec @ q), rng


def test_traj_store_matches_streaming_statistically():
    d = 8
    cov, logp, rng = _corr_gauss(d)
    q0 = jnp.asarray(rng.standard_normal((4, d)))
    key = jax.random.PRNGKey(0)
    for ts in (False, True):
        cfg = SHMCConfig(n_steps=16, warm_steps=8, traj_store=ts,
                         eps_quantile=0.5)
        draws, info = sample_shmc(logp, q0, key, warmup=300, samples=500,
                                  cfg=cfg)
        x = np.asarray(draws).reshape(-1, d)
        assert np.abs(x.mean(0)).max() < 0.15
        rel = np.abs(np.cov(x.T) - cov).max() / np.abs(cov).max()
        assert rel < 0.15, (ts, rel)
        assert np.asarray(info["accept_prob"]).mean() > 0.6


def test_traj_store_divergences_never_selected():
    """Force divergences with a tiny energy budget: dead legs must carry
    w=-inf (never selected), so every returned draw stays finite even
    though the unfrozen integrator state blows up."""
    _, logp, rng = _corr_gauss(4, seed=1)
    q0 = jnp.asarray(rng.standard_normal((2, 4)))
    # delta=0.05 adapts the step size UP (target accept 5%), so with a tight
    # energy budget most legs die mid-trajectory
    cfg = SHMCConfig(n_steps=8, traj_store=True, max_energy_error=0.5,
                     delta=0.05)
    draws, info = sample_shmc(logp, q0, jax.random.PRNGKey(1), warmup=50,
                              samples=100, cfg=cfg)
    assert np.isfinite(np.asarray(draws)).all()
    assert np.asarray(info["diverging"]).mean() > 0.2


def test_newton_polish_certifies_capped_lbfgs():
    # Rosenbrock-flavored quartic: L-BFGS at a tight cap leaves a large
    # gradient; the polish must certify (grad-norm <= tol)
    def loss(x):
        return (jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2)
                + jnp.sum((1.0 - x[:-1]) ** 2))

    x0 = jnp.zeros(12)
    r1 = run_lbfgs(loss, x0, max_iter=10)
    assert not bool(r1.converged)
    r2 = newton_polish(loss, r1.params, max_iter=100)
    assert bool(r2.converged)
    assert float(r2.grad_norm) < 1e-5
    assert float(r2.value) <= float(r1.value) + 1e-12


def test_batch_map_reports_certificate():
    from tests.test_parallel import load_batch
    freq, zb = load_batch(b=2)
    res = fit_spectra_batch(freq, zb, mode="optimize", max_iter=800,
                            init_from_ridge=True, random_seed=0)
    d = res.diagnostics
    assert d["grad_norm"].shape == (2,)
    assert d["converged"].all(), (d["grad_norm"], d["n_iter"])
    # certified: grad-norm at floored-tol scale, far below a cap-bound run
    assert (d["grad_norm"] < 1e-3).all(), d["grad_norm"]
    # the polish must not cost recovery: objective strictly better than the
    # unpolished cap-bound run
    res0 = fit_spectra_batch(freq, zb, mode="optimize", max_iter=800,
                             polish=False, init_from_ridge=True,
                             random_seed=0)
    assert (d["value"] <= res0.diagnostics["value"] + 1e-9).all()


# --- SBC ------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_model():
    freq = np.logspace(4, -1, 21)
    bf = np.logspace(4.5, -1.5, 25)
    frequencies, tau, eps, cfg, data, dn = _build_shared(
        freq, basis_freq=bf, mode="sample")
    return frequencies, tau, eps, cfg, data


def test_marginal_matches_joint_quadratic_form(small_model):
    """The marginal's M(ups, ds) must be exactly the x-quadratic form of the
    model's own soft prior: for fixed (ups, ds), the joint prior difference
    between two x values equals the Gaussian N(0, M^{-1}) difference."""
    from bayes_drt_tpu.models.posterior import log_density

    _, _, _, cfg, data = small_model
    k = data.L[0].shape[-1]
    rng = np.random.default_rng(3)
    u = jnp.asarray(np.concatenate([rng.normal(-1, 0.3, k),
                                    rng.normal(0, 0.3, 3)]))
    ups_raw, ds = jnp.exp(u[:k]), jnp.exp(u[k:])
    ups = 0.15 * ups_raw
    L = data.L[0]
    w = 1.0 / ups ** 2
    m = (ds[0] * (L[0].T * w) @ L[0] + ds[1] * (L[1].T * w) @ L[1]
         + ds[2] * (L[2].T * w) @ L[2])

    # prior-only density (likelihood masked out) at two x values
    data0 = data._replace(lik_mask=jnp.zeros_like(data.lik_mask))
    base = {"Rinf_raw": jnp.asarray(0.1), "induc_raw": jnp.asarray(0.1),
            "sigma_res_raw": jnp.asarray(0.1),
            "alpha_prop_raw": jnp.asarray(0.1),
            "alpha_re_raw": jnp.asarray(0.1), "alpha_im_raw": jnp.asarray(0.1),
            "ups_raw_0": jnp.log(ups_raw),
            "d_strength_0": jnp.log(ds)}
    x1 = jnp.asarray(rng.normal(0, 0.2, k))
    x2 = jnp.asarray(rng.normal(0, 0.2, k))
    lp1 = log_density(cfg, data0, {**base, "x_0": x1}, jacobian=True)
    lp2 = log_density(cfg, data0, {**base, "x_0": x2}, jacobian=True)
    want = -0.5 * (x1 @ m @ x1 - x2 @ m @ x2)
    np.testing.assert_allclose(float(lp1 - lp2), float(want), rtol=1e-8)


def test_sbc_generate_and_rank_machinery(small_model):
    frequencies, tau, eps, cfg, data = small_model
    rng = np.random.default_rng(4)
    n_sets = 24
    k = data.L[0].shape[-1]
    # synthetic marginal draws (any positive values exercise the machinery)
    ups_raw = np.exp(rng.normal(-1.5, 0.3, (n_sets, k)))
    ds = np.exp(rng.normal(0, 0.3, (n_sets, 3)))
    from bayes_drt_tpu.ops.basis import get_basis_func
    ge_tau = np.array([1e-3, 1e-1, 10.0])
    phi = np.asarray(get_basis_func("gaussian")(
        np.log(ge_tau[:, None] / tau[None, :]), eps))
    z, truths = sbc.generate_datasets(cfg, data, ups_raw, ds,
                                      jnp.asarray(phi, data.target.dtype),
                                      seed=5)
    assert z.shape == (n_sets, 21) and np.isfinite(z).all()
    assert truths.shape == (n_sets, 6 + 3) and np.isfinite(truths).all()
    assert (truths[:, 0] > 0).all()    # Rinf half-normal

    # rank machinery: calibrated draws -> uniform; shifted draws -> not
    L_draws = 40
    cal = rng.standard_normal((200, L_draws, 2))
    tr = rng.standard_normal((200, 2))
    ranks = sbc.sbc_ranks(tr, cal)
    assert ranks.shape == (200, 2) and ranks.min() >= 0 and ranks.max() <= L_draws
    p_ok, _ = sbc.rank_uniformity(ranks, L_draws, n_bins=8)
    assert (p_ok > 1e-4).all(), p_ok
    p_bad, _ = sbc.rank_uniformity(
        sbc.sbc_ranks(tr + 1.5, cal), L_draws, n_bins=8)
    assert (p_bad < 1e-6).all(), p_bad


def test_sbc_end_to_end_small(small_model):
    """Machinery end-to-end on CPU: prior draws -> datasets -> production
    batched fit (z_scale=1, monitor_thin) -> ranks. Uniformity is asserted
    only loosely (budget is tiny); the real certification runs on an
    accelerator (benchmarks/sbc.py)."""
    frequencies, tau, eps, cfg, data = small_model
    n_sets = 8
    ups_raw, ds, diag = sbc.sample_prior_marginal(cfg, data, n_sets, seed=2,
                                                  warmup=150)
    assert diag["divergence_rate"] < 0.2
    from bayes_drt_tpu.ops.basis import get_basis_func
    ge_tau = np.array([1e-2, 1.0])
    phi = np.asarray(get_basis_func("gaussian")(
        np.log(ge_tau[:, None] / tau[None, :]), eps))
    z, truths = sbc.generate_datasets(cfg, data, ups_raw, ds,
                                      jnp.asarray(phi, data.target.dtype),
                                      seed=6)
    res = fit_spectra_batch(
        frequencies, z, mode="sample", chains=2, warmup=60, samples=60,
        random_seed=0, ncp=True, sampler="shmc",
        shmc_cfg=SHMCConfig(n_steps=8, warm_steps=8, eps_quantile=0.5),
        basis_freq=1.0 / (2 * np.pi * tau), gamma_eval_tau=ge_tau,
        z_scale=1.0, monitor_thin=6)
    md = res.diagnostics["monitor_draws"]
    assert md.shape == (n_sets, 2 * 10, 8)
    ranks = sbc.sbc_ranks(truths, md)
    assert ranks.shape == (n_sets, 8)
    assert (ranks >= 0).all() and (ranks <= md.shape[1]).all()
    # z_scale=1 honored
    np.testing.assert_allclose(res.z_scales, 1.0)


def test_sbc_outlier_model_generate_and_fit():
    """SBC arm for the Series_outliers variant: the generator draws
    sigma_out from its exact prior (Exponential(lambda) x InvGamma(a, b)
    x 0.05 — posterior.py:314-319), the truth vector and the batch
    summarizer's monitor_draws gain sigma_out at the same 3 fixed
    frequencies, and ranks line up column-for-column."""
    from bayes_drt_tpu.models.posterior import outlier_monitor_indices
    from bayes_drt_tpu.ops.basis import get_basis_func

    freq = np.logspace(4, -1, 21)
    bf = np.logspace(4.5, -1.5, 25)
    frequencies, tau, eps, cfg, data, dn = _build_shared(
        freq, basis_freq=bf, mode="sample", outliers=True)
    assert cfg.outliers
    rng = np.random.default_rng(7)
    n_sets = 24
    k = data.L[0].shape[-1]
    ups_raw = np.exp(rng.normal(-1.5, 0.3, (n_sets, k)))
    ds = np.exp(rng.normal(0, 0.3, (n_sets, 3)))
    ge_tau = np.array([1e-2, 1.0])
    phi = np.asarray(get_basis_func("gaussian")(
        np.log(ge_tau[:, None] / tau[None, :]), eps))
    z, truths = sbc.generate_datasets(cfg, data, ups_raw, ds,
                                      jnp.asarray(phi, data.target.dtype),
                                      seed=8)
    idx = outlier_monitor_indices(len(freq))
    assert truths.shape == (n_sets, 6 + 2 + len(idx))
    so = truths[:, 8:]
    assert (so > 0).all()
    # parameterization check: E[sigma_out] = 0.05 * (1/lambda) * b/(a-1)
    lam = float(data.sigma_out_lambda)
    a, b = float(data.sigma_out_alpha), float(data.sigma_out_beta)
    want_mean = 0.05 * (1.0 / lam) * b / (a - 1.0)
    assert 0.5 * want_mean < so.mean() < 2.0 * want_mean, (so.mean(), want_mean)

    res = fit_spectra_batch(
        frequencies, z[:8], mode="sample", chains=2, warmup=40, samples=40,
        random_seed=0, ncp=True, sampler="shmc", outliers=True,
        shmc_cfg=SHMCConfig(n_steps=8, warm_steps=8, eps_quantile=0.5),
        basis_freq=1.0 / (2 * np.pi * tau), gamma_eval_tau=ge_tau,
        z_scale=1.0, monitor_thin=8)
    md = res.diagnostics["monitor_draws"]
    assert md.shape == (8, 2 * 5, 6 + 2 + len(idx))
    assert np.isfinite(md).all()
    ranks = sbc.sbc_ranks(truths[:8], md)
    assert ranks.shape == (8, md.shape[-1])
    assert (ranks >= 0).all() and (ranks <= md.shape[1]).all()


def test_rank_diagnostics_param_chunking_exact():
    """d_chunk runs parameter blocks sequentially (bounds the FFT/argsort
    workspace at the north-star budget, where the all-at-once form OOMs
    HBM) and must be numerically exact vs the unchunked program, including
    the padded final block."""
    from bayes_drt_tpu.infer.diagnostics import ess_bulk_jnp, rhat_rank_jnp

    x = jnp.asarray(np.random.default_rng(3).normal(size=(4, 120, 37)))
    for fn in (rhat_rank_jnp, ess_bulk_jnp):
        ref = np.asarray(fn(x))
        for ch in (5, 16, 37, 64):
            np.testing.assert_allclose(np.asarray(fn(x, d_chunk=ch)), ref,
                                       rtol=1e-10)


def test_shmc_per_chain_eps():
    """eps_quantile < 0 disables sampling-phase pooling: every chain runs
    at its OWN adapted step size (Stan/pystan per-chain semantics). The
    trajectory is static-length, so this costs nothing — the probe on the
    2RC double-delta cells (benchmarks/probe_2rc.py arm shmc-qpc) measured
    it quality-neutral there, but the mode must sample the target and
    report per-chain (non-pooled) frozen step sizes."""
    d = 8
    cov, logp, rng = _corr_gauss(d, seed=7)
    q0 = jnp.asarray(rng.standard_normal((4, d)))
    draws, info = sample_shmc(logp, q0, jax.random.PRNGKey(2), warmup=300,
                              samples=500,
                              cfg=SHMCConfig(n_steps=16, eps_quantile=-1.0))
    x = np.asarray(draws).reshape(-1, d)
    assert np.abs(x.mean(0)).max() < 0.15
    rel = np.abs(np.cov(x.T) - cov).max() / np.abs(cov).max()
    assert rel < 0.15, rel
    assert np.isfinite(x).all()
