"""The flat (hand-written) single-series-DRT value-and-grad and the
flat-chain trajectory must reproduce the generic posterior machinery exactly.

The hand-written gradient is the load-bearing piece of the flat-chain
sampler (infer/shmc_flat.py): any algebra slip shows up here as a mismatch
against jax.value_and_grad of models/posterior.log_density."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.flatten_util import ravel_pytree

from bayes_drt_tpu import sim
from bayes_drt_tpu.infer.shmc_flat import (flat_shared_for, flat_spec_for,
                                           flat_value_and_grad)
from bayes_drt_tpu.models.posterior import init_unconstrained, log_density
from bayes_drt_tpu.parallel.batch import _build_shared


def _setup(ncp, nonneg, dtype=jnp.float64):
    freq = np.logspace(6, -2, 41)
    Z = sim.reference_circuit("ZARC", freq)
    _, _, _, cfg, data, _ = _build_shared(freq, mode="sample", ncp=ncp,
                                          nonneg=nonneg, dtype=dtype)
    zs = np.abs(Z).max()
    target = jnp.asarray(np.concatenate([Z.real, Z.imag]) / zs, dtype)
    data = data._replace(target=target)
    return cfg, data, target


@pytest.mark.parametrize("ncp,nonneg", [(True, False), (False, False),
                                        (True, True), (False, True)])
def test_flat_value_and_grad_matches_generic(ncp, nonneg):
    cfg, data, target = _setup(ncp, nonneg)
    spec = flat_spec_for(cfg, data)
    shared = flat_shared_for(cfg, data, jnp.float64)

    key = jax.random.PRNGKey(3)
    R = 5
    q_rows = []
    for i in range(R):
        p = init_unconstrained(cfg, data, jax.random.fold_in(key, i))
        q_rows.append(ravel_pytree(
            jax.tree.map(lambda a: a.astype(jnp.float64), p))[0])
    q2d = jnp.stack(q_rows)
    targets = jnp.broadcast_to(target[None, :], (R, target.shape[0]))

    lp_flat, g_flat = flat_value_and_grad(spec, shared.A, shared.L,
                                          shared.vecs, shared.scal,
                                          q2d, targets)

    _, unravel = ravel_pytree(init_unconstrained(cfg, data,
                                                 jax.random.PRNGKey(0)))
    vg = jax.vmap(jax.value_and_grad(
        lambda q: log_density(cfg, data, unravel(q), jacobian=True)))
    lp_ref, g_ref = vg(q2d)

    np.testing.assert_allclose(np.asarray(lp_flat), np.asarray(lp_ref),
                               rtol=1e-10, atol=1e-9)
    np.testing.assert_allclose(np.asarray(g_flat), np.asarray(g_ref),
                               rtol=1e-9, atol=1e-9)


def test_flat_spec_rejects_ineligible_models():
    freq = np.logspace(6, -2, 21)
    _, _, _, cfg, data, _ = _build_shared(freq, mode="sample",
                                          outliers=True)
    with pytest.raises(ValueError, match="single series"):
        flat_spec_for(cfg, data)


def _reference_trajectory(vg, q, p0, eps, m_inv, n_leap, j, u, max_e):
    """One row's static multinomial trajectory, leapfrog by leapfrog in
    numpy: backward leg (flipped momentum) until step j, then the forward
    leg from the initial state; a divergent leg freezes and is never
    selected. Returns (q, logp, grad, kinetic, summed accept stat, any
    divergence) of the selected state."""
    lp0, g0 = vg(q)
    h0 = -lp0 + 0.5 * np.sum(p0 * p0 * m_inv)
    qq, pp, gg, dead, ever = q, -p0, g0, False, False
    logw, sacc = 0.0, 0.0
    sel = (q, lp0, g0, 0.5 * np.sum(p0 * p0 * m_inv))
    for i in range(n_leap):
        if i == j:
            qq, pp, gg, dead = q, p0, g0, False
        p_half = pp + 0.5 * eps * gg
        q_new = qq + eps * p_half * m_inv
        lp, g = vg(q_new)
        p_new = p_half + 0.5 * eps * g
        kin = 0.5 * np.sum(p_new * p_new * m_inv)
        h = -lp + kin
        bad = bool(np.isnan(h) or (h - h0) > max_e)
        w = -np.inf if (bad or dead) else h0 - h
        logw_new = np.logaddexp(logw, w)
        if np.log(u[i]) < w - logw_new:
            sel = (q_new, lp, g, kin)
        logw = logw_new
        sacc += min(1.0, float(np.exp(w)))
        dead = dead or bad
        ever = ever or dead
        if not dead:
            qq, pp, gg = q_new, p_new, g
    return sel + (sacc, ever)


def test_fit_spectra_batch_pallas_traj_end_to_end():
    """fit_spectra_batch(sampler='shmc', flat_chain=True) recovers the ZARC
    distribution with the standard diagnostics."""
    from bayes_drt_tpu.infer.chees import SHMCConfig
    from bayes_drt_tpu.parallel import evaluate_gamma, fit_spectra_batch

    freq, Zb = sim.make_benchmark_batch(4, freq=np.logspace(5, -1, 31),
                                        noise_level=0.003, seed=3)
    cfg = SHMCConfig(n_steps=8, warm_steps=8, eps_quantile=0.5,
                     flat_chain=True)
    res = fit_spectra_batch(freq, Zb, mode="sample", chains=2, warmup=60,
                            samples=40, random_seed=0, ncp=True,
                            sampler="shmc", shmc_cfg=cfg,
                            dtype=np.float32)
    assert res.coef.shape == (4, len(res.tau))
    assert np.isfinite(res.coef).all()
    d = res.diagnostics
    assert np.isfinite(d["logp_rhat"]).all()
    assert (d["accept_prob"] > 0.2).all()
    # recovered distribution must track the analytic ZARC DRT
    tau = np.logspace(-7, 1, 201)
    gt = sim.reference_gamma("ZARC", tau)
    g = evaluate_gamma(res, tau)
    rp = np.trapezoid(gt, np.log(tau))
    rmse = np.sqrt(np.mean((g - gt[None, :]) ** 2, axis=1))
    assert (rmse < 0.15 * rp).all(), rmse


def test_fit_spectra_batch_flat_chain_matches_pallas_traj():
    """The flat-chain XLA trajectory (lax.scan over leaves) must select the
    same state as a step-by-step leapfrog built on flat_value_and_grad."""
    from bayes_drt_tpu.infer.shmc_flat import _traj_xla

    cfg, data, target = _setup(ncp=True, nonneg=False)
    spec = flat_spec_for(cfg, data)
    shared = flat_shared_for(cfg, data, jnp.float64)
    rt, D = 6, spec.D
    key = jax.random.PRNGKey(0)
    q = jnp.stack([ravel_pytree(jax.tree.map(
        lambda a: a.astype(jnp.float64),
        init_unconstrained(cfg, data, jax.random.fold_in(key, i))))[0]
        for i in range(rt)])
    targets = jnp.broadcast_to(target[None, :], (rt, target.shape[0]))
    lp, g = flat_value_and_grad(spec, shared.A, shared.L, shared.vecs,
                                shared.scal, q, targets)
    k1, k2, k3 = jax.random.split(key, 3)
    m_inv = jnp.exp(jax.random.uniform(k1, (rt, D), jnp.float64, -1.0, 1.0))
    p0 = jax.random.normal(k2, (rt, D), jnp.float64) / jnp.sqrt(m_inv)
    # row 5's huge step size drives that row's legs divergent
    eps = jnp.asarray([1e-7, 1e-6, 1e-5, 1e-4, 1e-3, 5.0])
    n_leap, j, max_e = 7, 3, 1000.0
    u_sel = jax.random.uniform(k3, (n_leap, rt), jnp.float64)
    out = _traj_xla(spec, n_leap, max_e, shared, q, p0, g, lp, eps, m_inv,
                    targets, jnp.asarray(j, jnp.int32), u_sel)
    out = [np.asarray(o) for o in out]

    def vg_row(r):
        def vg(qr):
            lp_r, g_r = flat_value_and_grad(
                spec, shared.A, shared.L, shared.vecs, shared.scal,
                jnp.asarray(qr)[None, :], targets[r:r + 1])
            return float(lp_r[0]), np.asarray(g_r[0])
        return vg

    for r in range(rt):
        ref = _reference_trajectory(
            vg_row(r), np.asarray(q[r]), np.asarray(p0[r]), float(eps[r]),
            np.asarray(m_inv[r]), n_leap, j, np.asarray(u_sel[:, r]), max_e)
        for name, a, b in zip(["q", "logp", "grad", "kin", "sacc"],
                              out[:5], ref[:5]):
            np.testing.assert_allclose(a[r], b, rtol=1e-9, atol=1e-9,
                                       err_msg=f"row {r} {name}")
        assert bool(out[5][r]) == ref[5], f"row {r} divergence flag"
    assert out[5][5] and not out[5][0]


def test_fit_spectra_batch_pallas_traj_rejects_unsupported():
    from bayes_drt_tpu.infer.chees import SHMCConfig
    from bayes_drt_tpu.parallel import fit_spectra_batch

    freq, Zb = sim.make_benchmark_batch(2, freq=np.logspace(5, -1, 21),
                                        noise_level=0.003, seed=0)
    cfg = SHMCConfig(n_steps=4, flat_chain=True)
    with pytest.raises(ValueError, match="single series"):
        fit_spectra_batch(freq, Zb, mode="sample", chains=2, warmup=10,
                          samples=10, sampler="shmc", shmc_cfg=cfg,
                          outliers=True, dtype=np.float32)
