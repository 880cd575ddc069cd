"""Accelerator numbers for BASELINE configs 1-5: ordinary ridge, hyper-lambda
ridge, MAP (L-BFGS), HMC with the outlier error model, and DDT HMC —
batched at B=512 (B=256 for the multi-matrix DDT workload).

Reference anchors (BASELINE.md): hyper-lambda ridge 0.10 s/spectrum
(tutorials/1 "Initial ridge fit time"), MAP ~2.0 s/spectrum (tutorials/0
"MAP fit time"), outlier-model MAP 12-18 s (tutorials/3), DDT HMC
109.7 s at 2x(200+200) (tutorials/5). Ordinary ridge has no recorded
reference number; the 0.10 s ridge row is its (conservative) anchor too.

Protocol: prime each program (compile + lazy link), best-of-3 timed runs,
recovery gate on the ZARC ground truth. Prints one line per config.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pandas as pd

B = 512
REPEATS = 3


def main():
    import jax
    from bayes_drt_tpu.progcache import enable_compile_cache
    enable_compile_cache()
    from bayes_drt_tpu import sim
    from bayes_drt_tpu.parallel import (evaluate_gamma, fit_spectra_batch,
                                        ridge_fit_spectra_batch)

    freq, Zb = sim.make_benchmark_batch(B, circuit="ZARC",
                                        noise_level=0.0025, seed=0)
    gt = pd.read_csv("/root/reference/data/simulated/gamma_ZARC.csv")
    gt_tau, gt_g = gt["tau"].values, gt["gamma"].values
    rp = np.trapezoid(gt_g, np.log(gt_tau))

    from bayes_drt_tpu.infer.chees import SHMCConfig
    # the bench.py production sampler config (round-3 final): 32-step
    # trajectories + median step-size pooling, 150 warmup draws; reference
    # anchors for the HMC rows are scaled to the same 4x400 budget
    shmc = dict(sampler="shmc",
                shmc_cfg=SHMCConfig(n_steps=32, warm_steps=32,
                                    leaf_unroll=2, draw_unroll=2,
                                    recompute_grad=True, eps_quantile=0.5))

    configs = [
        ("ridge-ordinary", 0.10,
         lambda seed: ridge_fit_spectra_batch(freq, Zb, hyper_lambda=False,
                                              penalty="integral",
                                              weights="modulus",
                                              lambda_0=1e-2)),
        ("ridge-hyper-lambda", 0.10,
         lambda seed: ridge_fit_spectra_batch(freq, Zb)),
        ("map-lbfgs", 2.0,
         lambda seed: fit_spectra_batch(freq, Zb, mode="optimize",
                                        max_iter=2000, n_restarts=2,
                                        random_seed=seed)),
        # config 3 production variant: ONE L-BFGS run seeded from a batched
        # hyper-lambda ridge pass (init_from_ridge). CPU quality study:
        # cap=1500 matches the 2x2000 random-restart quality (B=8 rmse/Rp
        # mean 0.0094 vs 0.0086, max 0.0135 vs 0.0139) at 37% of the
        # L-BFGS work.
        ("map-ridge-init", 2.0,
         lambda seed: fit_spectra_batch(freq, Zb, mode="optimize",
                                        max_iter=1500, init_from_ridge=True,
                                        random_seed=seed)),
        # config 4: HMC with the outlier error model (Tutorial 3's error
        # structure on the standard workload; ref anchor = the 12-18 s
        # outlier-model MAP row scaled by the 81.1/2.0 HMC/MAP ratio of
        # the same tutorial series -> ~608 s, conservatively 515.5/2)
        ("hmc-outliers", 515.5 * 400 / 1000,
         lambda seed: fit_spectra_batch(freq, Zb, mode="sample", chains=4,
                                        warmup=150, samples=250,
                                        random_seed=seed, ncp=True,
                                        outliers=True, **shmc)),
    ]

    # config 5: DDT (transmissive planar) HMC — Tutorial 5's workload
    # (ref: 109.7 s at 2x(200+200); scaled to this 4x(250+250) budget:
    # 109.7 * (2000/800) = 274 s/spectrum)
    ddt = pd.read_csv(
        "/root/reference/data/simulated/Z_BimodalTP-DDT_uniform_0.25.csv")
    f_ddt = ddt["Freq"].values
    z_ddt = ddt["Zreal"].values + 1j * ddt["Zimag"].values
    rng = np.random.default_rng(0)
    zr = np.max(z_ddt.real) - np.min(z_ddt.real)
    Zd = z_ddt[None, :] + 0.0025 * zr * (
        rng.standard_normal((B, len(z_ddt)))
        + 1j * rng.standard_normal((B, len(z_ddt))))
    dists = {"TP-DDT": {"kernel": "DDT", "dist_type": "parallel",
                        "symmetry": "planar", "bc": "transmissive"}}
    gt_ddt = pd.read_csv("/root/reference/data/simulated/gamma_BimodalTP-DDT.csv")
    configs.append(
        ("hmc-ddt-tp", 109.7 * 1600 / 800,
         lambda seed: fit_spectra_batch(f_ddt, Zd, mode="sample", chains=4,
                                        warmup=150, samples=250,
                                        random_seed=seed, ncp=True,
                                        nonneg=True, distributions=dists,
                                        **shmc)))

    # config 6: Series-Parallel multi-distribution HMC (DRT + TP-DDT, the
    # reference's DRT-2-TpDDT workload; ref: 198.6-362.3 s/spectrum at the
    # paper budget, code_EchemActa/"Run fits.ipynb" — anchored at the
    # FASTEST observation, unscaled, so the multiplier is conservative)
    B_SP = 256
    sp = pd.read_csv(
        "/root/reference/data/simulated/Z_DRT-2-TpDDT_noiseless.csv")
    f_sp = sp["Freq"].values
    z_sp = sp["Zreal"].values + 1j * sp["Zimag"].values
    zr_sp = np.max(z_sp.real) - np.min(z_sp.real)
    rng_sp = np.random.default_rng(1)
    Zsp = z_sp[None, :] + 0.0025 * zr_sp * (
        rng_sp.standard_normal((B_SP, len(z_sp)))
        + 1j * rng_sp.standard_normal((B_SP, len(z_sp))))
    sp_dists = {
        "DRT": {"kernel": "DRT", "basis_freq": np.logspace(6, -2, 81)},
        "TP-DDT": {"kernel": "DDT", "symmetry": "planar",
                   "bc": "transmissive", "dist_type": "parallel",
                   "basis_freq": np.logspace(6, -2, 81), "x_scale": 0.8},
    }
    gt_sp = pd.read_csv(
        "/root/reference/data/simulated/gamma_DRT-2-TpDDT.csv")
    configs.append(
        ("hmc-multidist-sp", 198.6,
         lambda seed: fit_spectra_batch(f_sp, Zsp, mode="sample", chains=4,
                                        warmup=150, samples=250,
                                        random_seed=seed, ncp=True,
                                        nonneg=True, distributions=sp_dists,
                                        **shmc)))

    only = set(sys.argv[1:])
    for name, ref_sec, run in configs:
        if only and name not in only:
            continue
        t0 = time.time()
        run(0)
        print(f"[{name}] prime {time.time()-t0:.1f}s", file=sys.stderr,
              flush=True)
        best, res = float("inf"), None
        for rep in range(REPEATS):
            t0 = time.time()
            r = run(rep + 1)
            el = time.time() - t0
            print(f"[{name}] rep{rep} {el:.2f}s", file=sys.stderr, flush=True)
            if el < best:
                best, res = el, r

        if name == "hmc-multidist-sp":
            # gate BOTH recovered distributions against the committed truth
            # (both dists share one basis grid, so evaluate_gamma covers the
            # second via its diagnostics key)
            tau_q = gt_sp["tau"].values
            g_drt = evaluate_gamma(res, tau_q)
            g_tp = evaluate_gamma(res, tau_q, which="coef_1")
            for label, gb, col in (("gamma", g_drt, "gamma"),
                                   ("ftp", g_tp, "ftp")):
                truth = gt_sp[col].values
                rp_d = np.trapezoid(truth, np.log(tau_q))
                r_d = np.sqrt(np.mean((gb.mean(0) - truth) ** 2))
                print(f"  [{name}] {label}: rmse={100*r_d/abs(rp_d):.2f}%Rp",
                      flush=True)
            spm = B_SP / (best / 60.0)
            ref_spm = 60.0 / ref_sec
            print(f"{name}: best={best:.3f}s spm={spm:.0f} "
                  f"sec/spectrum={best/B_SP*1e3:.3f}ms "
                  f"vs_ref={spm/ref_spm:.0f}x", flush=True)
            continue
        if name == "hmc-ddt-tp":
            tau_q, g_q = gt_ddt["tau"].values, gt_ddt["gamma"].values
        else:
            tau_q, g_q = gt_tau, gt_g
        rp_q = np.trapezoid(g_q, np.log(tau_q))
        g = evaluate_gamma(res, tau_q)
        rmse = float(np.sqrt(np.mean((g.mean(0) - g_q) ** 2)))
        per = np.sqrt(np.mean((g - g_q[None, :]) ** 2, axis=1))
        p90 = float(np.percentile(per, 90))
        spm = B / (best / 60.0)
        ref_spm = 60.0 / ref_sec
        print(f"{name}: best={best:.3f}s spm={spm:.0f} "
              f"sec/spectrum={best/B*1e3:.3f}ms "
              f"vs_ref={spm/ref_spm:.0f}x "
              f"rmse={100*rmse/rp_q:.2f}%Rp p90={100*p90/rp_q:.2f}%Rp",
              flush=True)


if __name__ == "__main__":
    main()
