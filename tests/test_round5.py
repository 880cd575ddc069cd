"""Round-5 additions: batched posterior-predictive impedance
(predict_Z_batch — the batched analogue of the reference's predict_Z /
Stan Z_hat_tilde generated quantities, Series_modelcode.txt:70-73) and
sigma_min plumbing through the batch APIs (reference fit(sigma_min=...),
inversion.py:1116-1119)."""

import numpy as np
import pandas as pd
import pytest

from bayes_drt_tpu import Inverter
from bayes_drt_tpu.parallel import (evaluate_gamma, fit_spectra_batch,
                                    predict_Z_batch)


def _load(name):
    df = pd.read_csv(f"/root/reference/data/simulated/{name}")
    return df["Freq"].values, df["Zreal"].values + 1j * df["Zimag"].values


def test_predict_z_batch_single_drt():
    freq, z = _load("Z_ZARC_uniform_1.0.csv")
    zb = np.stack([z, z * 2.0])     # second spectrum scaled: distinct fits
    res = fit_spectra_batch(freq, zb, mode="optimize", max_iter=600,
                            init_from_ridge=True, random_seed=0)
    z_hat = predict_Z_batch(res, freq)
    assert z_hat.shape == zb.shape
    rel = np.abs(z_hat - zb) / np.abs(zb)
    assert np.median(rel, axis=1).max() < 0.02, np.median(rel, axis=1)
    # new-frequency evaluation: finite, and consistent with the training
    # grid where they coincide
    f_new = np.logspace(5, -1, 37)
    z_new = predict_Z_batch(res, f_new)
    assert z_new.shape == (2, 37) and np.isfinite(z_new).all()


def test_predict_z_batch_matches_inverter_multidist():
    """Cross-path proof: a synthetic BatchFitResult carrying an Inverter
    fit's coefficients must predict the SAME impedance as Inverter.predict_Z
    (series + parallel terms, R_inf, inductance)."""
    from bayes_drt_tpu.parallel.batch import BatchFitResult

    freq, z = _load("Z_DRT-2-TpDDT_uniform_0.25.csv")
    bf = np.logspace(5, -1, 31)
    eps_val = 1.0
    dists = {
        "DRT": {"kernel": "DRT", "basis_freq": bf, "epsilon": eps_val},
        "TP-DDT": {"kernel": "DDT", "symmetry": "planar",
                   "bc": "transmissive", "dist_type": "parallel",
                   "basis_freq": bf, "epsilon": eps_val},
    }
    inv = Inverter(distributions=dists)
    inv.fit(freq, z, nonneg=True, random_seed=0, n_restarts=2, max_iter=300)
    tau = 1.0 / (2 * np.pi * bf)
    geometry = tuple(
        {"name": nm, "kernel": d["kernel"], "dist_type":
         d.get("dist_type", "series"), "symmetry": d.get("symmetry", "planar"),
         "bc": d.get("bc", "transmissive"), "ct": False, "k_ct": None,
         "basis": "gaussian", "tau": tau, "epsilon": eps_val}
        for nm, d in (("DRT", dists["DRT"]), ("TP-DDT", dists["TP-DDT"])))
    res = BatchFitResult(
        coef=inv.distribution_fits["DRT"]["coef"][None, :],
        r_inf=np.array([inv.R_inf]), inductance=np.array([inv.inductance]),
        gamma_lo=None, gamma_hi=None, z_scales=np.ones(1), tau=tau,
        epsilon=eps_val,
        diagnostics={"dist_geometry": geometry,
                     "coef_1": inv.distribution_fits["TP-DDT"]["coef"][None, :]})
    f_new = np.logspace(4.5, -0.5, 29)
    z_batch = predict_Z_batch(res, f_new)[0]
    z_inv = inv.predict_Z(f_new)
    np.testing.assert_allclose(z_batch, z_inv, rtol=1e-6, atol=1e-9)


def test_fit_spectra_batch_records_geometry():
    freq, z = _load("Z_BimodalTP-DDT_uniform_0.25.csv")
    dists = {"DDT": {"kernel": "DDT", "symmetry": "planar",
                     "bc": "transmissive", "dist_type": "parallel",
                     "basis_freq": np.logspace(5, -2, 25)}}
    res = fit_spectra_batch(freq, z[None, :], mode="optimize", max_iter=400,
                            n_restarts=1, random_seed=0, distributions=dists)
    (g,) = res.diagnostics["dist_geometry"]
    assert g["kernel"] == "DDT" and g["dist_type"] == "parallel"
    assert g["bc"] == "transmissive" and len(g["tau"]) == 25
    z_hat = predict_Z_batch(res, freq)
    assert np.median(np.abs(z_hat - z) / np.abs(z)) < 0.05


def test_split_manifest_is_total():
    """Every test module must be assigned to exactly one split in BOTH
    tests/SPLITS.md and tests/run_splits.sh (the rig kills any single
    pytest process at ~27 min, so an unassigned module silently never
    runs — see SPLITS.md)."""
    import glob
    import os
    import re

    here = os.path.dirname(__file__)
    modules = sorted(os.path.basename(p)[:-3]
                     for p in glob.glob(os.path.join(here, "test_*.py")))

    md = open(os.path.join(here, "SPLITS.md")).read()
    md_counts = {m: len(re.findall(rf"\b{m}\b(?!\.py)",
                                   md.split("Timing history")[0].split("|--")[-1]))
                 for m in modules}
    sh = open(os.path.join(here, "run_splits.sh")).read()
    sh_counts = {m: sh.count(f"tests/{m}.py") for m in modules}

    missing_md = [m for m, c in md_counts.items() if c == 0]
    dup_md = [m for m, c in md_counts.items() if c > 1]
    bad_sh = [m for m, c in sh_counts.items() if c != 1]
    assert not missing_md, f"modules missing from SPLITS.md table: {missing_md}"
    assert not dup_md, f"modules listed twice in SPLITS.md table: {dup_md}"
    assert not bad_sh, f"modules not exactly once in run_splits.sh: {bad_sh}"


def test_sigma_min_reaches_posterior():
    """sigma_min is the error-scale floor (reference: inversion.py:1116-1119);
    an absurdly large floor must visibly loosen the fit."""
    from bayes_drt_tpu.parallel.batch import _build_shared

    freq, z = _load("Z_ZARC_uniform_1.0.csv")
    *_, data, _ = _build_shared(freq, sigma_min=0.005)
    assert float(data.sigma_min) == pytest.approx(0.005)

    zb = z[None, :]
    res_tight = fit_spectra_batch(freq, zb, mode="optimize", max_iter=500,
                                  n_restarts=1, random_seed=0)
    res_loose = fit_spectra_batch(freq, zb, mode="optimize", max_iter=500,
                                  n_restarts=1, random_seed=0, sigma_min=5.0)
    r_tight = np.median(np.abs(predict_Z_batch(res_tight, freq) - zb)
                        / np.abs(zb))
    r_loose = np.median(np.abs(predict_Z_batch(res_loose, freq) - zb)
                        / np.abs(zb))
    assert r_loose > 3 * r_tight, (r_tight, r_loose)


# ---- round-5 late additions: mixing-gate escalation + quality presets ----

def test_escalation_refits_flagged_spectra():
    """Spectra failing the mixing gate are refit with the adaptive sampler
    and spliced back (Stan's per-posterior adaptivity for the DEFAULT
    batch path — reference inversion.py:1218-1221 hands every spectrum to
    adaptive NUTS; the fixed-trajectory SHMC path must escalate its
    under-mixed tail automatically)."""
    import warnings

    from bayes_drt_tpu.infer.chees import SHMCConfig

    freq, z = _load("Z_ZARC_uniform_1.0.csv")
    zb = np.stack([z, z * 1.1, z * 0.9])
    cfg = SHMCConfig(n_steps=8, warm_steps=8)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        res = fit_spectra_batch(freq, zb, mode="sample", chains=2, warmup=20,
                                samples=20, sampler="shmc", shmc_cfg=cfg,
                                ncp=True,
                                escalate_gate=dict(ess_bulk_min=1e9),
                                escalate_kw=dict(sampler="nuts",
                                                 max_tree_depth=4))
        msgs = [str(x.message) for x in w]
    assert res.diagnostics["escalated"].all()
    assert any("failed the mixing gate" in m for m in msgs), msgs
    assert np.isfinite(res.coef).all()
    assert res.coef.shape == (3, 101)

    # a clean batch never triggers (gate at 0) and records the mask
    res2 = fit_spectra_batch(freq, zb, mode="sample", chains=2, warmup=20,
                             samples=20, sampler="shmc", shmc_cfg=cfg,
                             ncp=True, escalate_gate=dict(ess_bulk_min=0.0))
    assert res2.diagnostics["escalated"].sum() == 0

    # default: ON for shmc (auto) and for single-dist nuts (ridge-seeded
    # refit = multimodal-trap escape, round 5); the mask is recorded either
    # way. Gates forced off so the tiny test budget never refits.
    res3 = fit_spectra_batch(freq, zb, mode="sample", chains=2, warmup=20,
                             samples=20, sampler="nuts", max_tree_depth=3,
                             escalate_gate=dict(ess_bulk_min=0.0))
    assert res3.diagnostics["escalated"].sum() == 0
    # OFF when the primary fit is already ridge-seeded (the refit would
    # only reseed)
    res4 = fit_spectra_batch(freq, zb, mode="sample", chains=2, warmup=20,
                             samples=20, sampler="nuts", max_tree_depth=3,
                             init_from_ridge=True)
    assert "escalated" not in res4.diagnostics


def test_escalation_splice_changes_only_flagged_rows():
    """_splice_results overwrites exactly the masked rows."""
    from bayes_drt_tpu.infer.chees import SHMCConfig

    freq, z = _load("Z_ZARC_uniform_1.0.csv")
    zb = np.stack([z, z * 1.2])
    cfg = SHMCConfig(n_steps=8, warm_steps=8)
    kw = dict(mode="sample", chains=2, warmup=15, samples=15,
              sampler="shmc", shmc_cfg=cfg, ncp=True)
    base = fit_spectra_batch(freq, zb, escalate=False, **kw)

    from bayes_drt_tpu.parallel import batch as batch_mod
    sub = fit_spectra_batch(freq, zb[1:], escalate=False, mode="sample",
                            chains=2, warmup=15, samples=15, sampler="nuts",
                            max_tree_depth=3, ncp=True)
    mask = np.array([False, True])
    spliced = batch_mod._splice_results(base, sub, mask)
    np.testing.assert_array_equal(spliced.coef[0], base.coef[0])
    np.testing.assert_array_equal(spliced.coef[1], sub.coef[0])
    np.testing.assert_array_equal(spliced.r_inf[0], base.r_inf[0])
    np.testing.assert_array_equal(spliced.r_inf[1], sub.r_inf[0])
    assert spliced.diagnostics["escalated"].tolist() == [False, True]
    # per-spectrum diagnostics spliced; non-batch keys kept
    np.testing.assert_array_equal(spliced.diagnostics["logp_rhat"][1],
                                  sub.diagnostics["logp_rhat"][0])
    np.testing.assert_array_equal(spliced.diagnostics["logp_rhat"][0],
                                  base.diagnostics["logp_rhat"][0])


def test_quality_presets():
    """quality= presets expand to the documented sampler configs and
    reject misuse; unknown names raise."""
    freq, z = _load("Z_ZARC_uniform_1.0.csv")
    zb = z[None, :]
    with pytest.raises(ValueError, match="Unknown quality"):
        fit_spectra_batch(freq, zb, mode="sample", quality="wat")
    with pytest.raises(ValueError, match="mode='sample'"):
        fit_spectra_batch(freq, zb, mode="optimize", quality="fast")
    from bayes_drt_tpu.parallel.batch import QUALITY_PRESETS
    assert set(QUALITY_PRESETS) >= {"fast", "strict"}
    for name, p in QUALITY_PRESETS.items():
        assert {"sampler", "ncp", "chains", "warmup", "samples"} <= set(p)
    # 'strict' is the calibrated-interval config: adaptive NUTS, true f32
    assert QUALITY_PRESETS["strict"]["sampler"] == "nuts"


def test_escalation_mask_thresholds():
    from bayes_drt_tpu.parallel.batch import escalation_mask

    d = {"ess_bulk_min": np.array([1.0, 3.0, 10.0]),
         "logp_rhat": np.array([1.0, 1.0, 1.0])}
    assert escalation_mask(d, 3, ess_bulk_min=2.0).tolist() == [
        True, False, False]
    d["high_grad_err"] = np.array([0.0, 1e-3, 0.0])
    assert escalation_mask(d, 3, ess_bulk_min=2.0,
                           high_tol=2e-4).tolist() == [True, True, False]
    # chains at different density levels (the posterior-predictive-Z
    # failure class) and the metric-normalized slow-direction detector
    d2 = {"ess_bulk_min": np.array([5.0, 5.0, 5.0]),
          "logp_rhat": np.array([1.2, 9.0, 1.2]),
          "metric_lambda_max": np.array([1.0, 1.0, 40.0])}
    assert escalation_mask(d2, 3, ess_bulk_min=2.0, logp_rhat=4.5,
                           lambda_max=20.0).tolist() == [False, True, True]


def test_predict_z_fast_path_reorders():
    """At f_train, predict_Z_batch serves the stored posterior-mean Z_hat
    (Stan generated-quantities semantics, the committed Zout_*.csv), in the
    caller's frequency order."""
    from bayes_drt_tpu.parallel.batch import BatchFitResult

    f_tr = np.array([100.0, 10.0, 1.0])
    zm = np.array([[1.0, 2.0, 3.0, -1.0, -2.0, -3.0]])
    res = BatchFitResult(
        coef=np.zeros((1, 2)), r_inf=np.zeros(1), inductance=np.zeros(1),
        gamma_lo=None, gamma_hi=None, z_scales=np.ones(1),
        tau=np.array([1.0]), epsilon=1.0,
        diagnostics={"dist_geometry": (), "f_train": f_tr,
                     "z_hat_mean": zm})
    z = predict_Z_batch(res, np.array([1.0, 10.0, 100.0]))
    np.testing.assert_allclose(z, [[3.0 - 3j, 2.0 - 2j, 1.0 - 1j]])
    z2 = predict_Z_batch(res, f_tr)
    np.testing.assert_allclose(z2, [[1.0 - 1j, 2.0 - 2j, 3.0 - 3j]])


def test_z_hat_mean_matches_point_reconstruction_when_linear():
    """For a pure-series (linear) model the draws-mean Z_hat must equal the
    mean-coefficient reconstruction; for parallel models they genuinely
    differ (Z is nonlinear in x — the BimodalBP-DDT regression,
    benchmarks/probe_bpddt.py), which is exactly why the fast path exists."""
    freq, z = _load("Z_ZARC_uniform_1.0.csv")
    res = fit_spectra_batch(freq, z[None, :], mode="sample", chains=2,
                            warmup=40, samples=40, ncp=True, sampler="nuts",
                            max_tree_depth=5, escalate=False, random_seed=0)
    d = res.diagnostics
    assert "z_hat_mean" in d and "z_hat_std" in d and "f_train" in d
    n = len(freq)
    z_fast = predict_Z_batch(res, d["f_train"])
    np.testing.assert_array_equal(
        z_fast, d["z_hat_mean"][:, :n] + 1j * d["z_hat_mean"][:, n:])
    # strip f_train to force the mean-coefficient path: linear model ->
    # identical up to accumulation order
    d2 = dict(d)
    d2.pop("f_train")
    z_point = predict_Z_batch(res._replace(diagnostics=d2), d["f_train"])
    np.testing.assert_allclose(z_point, z_fast, rtol=1e-8)


def test_monitor_ess_detects_autocorrelation():
    """monitor_ess (the SBC auto-thinning estimator) recovers ~N for iid
    draws and ~N/tau for an AR(1) chain with known integrated
    autocorrelation time tau = (1+rho)/(1-rho)."""
    from bayes_drt_tpu.sbc import monitor_ess

    rng = np.random.default_rng(0)
    n_sets, chains, s = 4, 4, 500
    iid = rng.normal(size=(n_sets, chains * s, 2))
    e = monitor_ess(iid, chains)
    assert np.median(e) > 0.5 * chains * s, np.median(e)

    rho = 0.9                                   # tau = 19
    x = np.zeros((n_sets, chains, s))
    eps = rng.normal(size=(n_sets, chains, s))
    for t in range(1, s):
        x[:, :, t] = rho * x[:, :, t - 1] + eps[:, :, t]
    ar = x.reshape(n_sets, chains * s)[:, :, None]
    e_ar = monitor_ess(ar, chains)
    tau = (1 + rho) / (1 - rho)
    est_tau = chains * s / np.median(e_ar)
    assert 0.5 * tau < est_tau < 2.0 * tau, (est_tau, tau)


def test_escalation_mask_logp_gap():
    """Stuck-chain (absolute between-chain mean-logp gap) gate: explicit
    threshold applies unconditionally; the default is budget-aware (off at
    screening budgets, where healthy short-warmup funnel chains freeze at
    legitimately different logp levels)."""
    from bayes_drt_tpu.parallel.batch import (ESCALATE_MIN_DRAWS,
                                              escalation_mask)

    d = {"ess_bulk_min": np.array([5.0, 5.0, 5.0]),
         "logp_rhat": np.array([1.2, 1.2, 1.2]),
         "logp_chain_gap": np.array([2.0, 150.0, 800.0])}
    assert escalation_mask(d, 3, logp_gap=100.0).tolist() == [
        False, True, True]
    # budget-aware default: active only at Stan-grade budgets
    assert escalation_mask(d, 3, n_draws=ESCALATE_MIN_DRAWS).tolist() == [
        False, True, True]
    assert escalation_mask(d, 3, n_draws=600).tolist() == [
        False, False, False]


def test_sample_init_from_ridge_series():
    """Sample-mode ridge-seeded chain starts (reference
    inversion.py:1616-1682 generalized to the batch): recovery intact and
    the program is distinct from the random-init one."""
    freq, z = _load("Z_ZARC_uniform_1.0.csv")
    res = fit_spectra_batch(freq, z[None, :], mode="sample", chains=2,
                            warmup=40, samples=40, ncp=True, sampler="nuts",
                            max_tree_depth=5, init_from_ridge=True,
                            escalate=False, random_seed=0)
    gt = pd.read_csv("/root/reference/data/simulated/gamma_ZARC.csv")
    g = evaluate_gamma(res, gt["tau"].values)[0]
    rp = np.trapezoid(gt["gamma"].values, np.log(gt["tau"].values))
    rmse = np.sqrt(np.mean((g - gt["gamma"].values) ** 2))
    assert rmse < 0.10 * rp, rmse
    zp = predict_Z_batch(res, freq)[0]
    assert np.median(np.abs(zp - z) / np.abs(z)) < 0.05


def test_bpddt_trap_escalation_rescue():
    """The BimodalBP-DDT Y~0 trap (benchmarks/probe_bpddt.py): random-init
    chains stick in a spurious mode ~800 nats below the data-fitting one
    (huge induc + tiny Y, the proportional-error term flattens the
    likelihood), poisoning E[Z] by ~300x while gamma recovery passes. The
    stuck-chain gate + ridge-seeded escalation refit must rescue it
    through the default batch API."""
    freq, z = _load("Z_BimodalBP-DDT_noiseless.csv")
    dists = {"DDT": {"kernel": "DDT", "symmetry": "planar", "bc": "blocking",
                     "dist_type": "parallel",
                     "basis_freq": np.logspace(6, -3, 91)}}
    with pytest.warns(UserWarning, match="mixing gate"):
        res = fit_spectra_batch(
            freq, z[None, :], mode="sample", chains=4, warmup=150,
            samples=150, ncp=True, sampler="nuts", tree_scan=True,
            max_tree_depth=8, random_seed=3, distributions=dists,
            sigma_min=0.005,
            # unconditional gap gate (the test budget is screening-size;
            # the default gate needs Stan-grade budgets)
            escalate_gate={"logp_gap": 100.0})
    assert res.diagnostics["escalated"][0]
    zp = predict_Z_batch(res, freq)[0]
    zdev = np.median(np.abs(zp - z) / np.abs(z))
    assert zdev < 0.05, zdev
