"""Calibrate the quality='strict' preset.

Goal: a one-flag configuration with STAN-GRADE certified per-spectrum
convergence — logp split-Rhat < 1.2 and min-ESS > 100 (the monitor-based
bulk ESS over logp + gamma) — plus a measured throughput number, so
calibrated-interval users have a documented quality/throughput frontier
(PERF.md) next to the screening-grade 'fast' preset.

Workload: the bench.py population (B noisy ZARC replicas at the
reference's standard 0.25% noise). Arms sweep sampler x budget; every arm
reports the per-spectrum p50/p90/max of logp split-Rhat and min-ESS, plus
recovery quality (the numbers that certify the preset in
tests/test_round5.py are the p-max ones).

Usage: python benchmarks/sweep_strict.py [--b 64] [--arms nuts1000 ...]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pandas as pd


ARMS = {
    # name: (sampler-kwargs, warmup, samples)
    "shmc_fast": (dict(sampler="shmc"), 150, 250),          # the 'fast' preset
    "nuts500": (dict(sampler="nuts", max_tree_depth=10,
                     tree_scan=True, scan_unroll=2), 500, 500),
    "nuts1000": (dict(sampler="nuts", max_tree_depth=10,
                      tree_scan=True, scan_unroll=2), 1000, 1000),
    # md8 saturates the DRT posterior's
    # trajectories anyway (n_leap ~255 at md8, probe_bpddt.py arms agree
    # md8 == md10 on every gate)
    "nuts1000_md8": (dict(sampler="nuts", max_tree_depth=8,
                          tree_scan=True, scan_unroll=2), 1000, 1000),
    "nuts2000": (dict(sampler="nuts", max_tree_depth=10,
                      tree_scan=True, scan_unroll=2), 1000, 2000),
    "shmc128": (dict(sampler="shmc", n_steps=128), 500, 500),
    "shmc128_1000": (dict(sampler="shmc", n_steps=128), 1000, 1000),
}


def run_arm(name, freq, Zb, gt_tau, gt_g, rp, chains=4, escalate=False):
    from bayes_drt_tpu.infer.chees import SHMCConfig
    from bayes_drt_tpu.parallel import evaluate_gamma, fit_spectra_batch

    kw, warmup, samples = ARMS[name]
    kw = dict(kw)
    sampler = kw.pop("sampler")
    skw = dict(chains=chains, warmup=warmup, samples=samples, ncp=True,
               random_seed=0, gamma_eval_tau=gt_tau,
               escalate=None if escalate else False)
    if sampler == "shmc":
        n_steps = kw.pop("n_steps", 32)
        skw["sampler"] = "shmc"
        skw["shmc_cfg"] = SHMCConfig(n_steps=n_steps, warm_steps=n_steps,
                                     leaf_unroll=2, draw_unroll=2,
                                     recompute_grad=True, eps_quantile=0.5,
                                     precision="highest")
    else:
        skw["sampler"] = "nuts"
        skw.update(kw)

    def run(seed):
        return fit_spectra_batch(freq, Zb, mode="sample",
                                 **{**skw, "random_seed": seed})

    run(0)                      # compile
    t0 = time.time()
    res = run(1)
    el = time.time() - t0

    d = res.diagnostics
    gammas = evaluate_gamma(res, gt_tau)
    per_rmse = np.sqrt(np.mean((gammas - gt_g[None, :]) ** 2, axis=1)) / rp
    cov = float(np.mean((gt_g[None, :] >= d["gamma_eval_lo"])
                        & (gt_g[None, :] <= d["gamma_eval_hi"])))
    lp = np.asarray(d["logp_rhat"])
    me = np.asarray(d["min_ess"])
    row = dict(
        arm=name, B=len(Zb), chains=chains, warmup=warmup, samples=samples,
        seconds=round(el, 1),
        spm=round(len(Zb) / (el / 60.0), 1),
        rmse_mean=float(per_rmse.mean()), rmse_p90=float(np.percentile(per_rmse, 90)),
        coverage=cov,
        lp_rhat_p50=float(np.median(lp)), lp_rhat_p90=float(np.percentile(lp, 90)),
        lp_rhat_max=float(lp.max()),
        min_ess_p50=float(np.median(me)), min_ess_p10=float(np.percentile(me, 10)),
        min_ess_min=float(me.min()),
        ess_bulk_min_p10=float(np.percentile(np.asarray(d["ess_bulk_min"]), 10)),
        div_rate=float(np.asarray(d["divergence_rate"]).mean()),
        n_escalated=int(np.asarray(d.get("escalated", np.zeros(1))).sum()),
    )
    print(pd.Series(row).to_string(), file=sys.stderr, flush=True)
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--b", type=int, default=64)
    ap.add_argument("--arms", nargs="+", default=["shmc_fast", "nuts1000"])
    ap.add_argument("--out", default="sweep_strict.csv")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--escalate", action="store_true",
                    help="measure the arm with the DEFAULT "
                         "mixing-gate escalation (what the "
                         "quality presets actually ship)")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from bayes_drt_tpu.progcache import enable_compile_cache
    enable_compile_cache()

    from bayes_drt_tpu import sim
    freq, Zb = sim.make_benchmark_batch(args.b, circuit="ZARC",
                                        noise_level=0.0025, seed=0)
    gt = pd.read_csv("/root/reference/data/simulated/gamma_ZARC.csv")
    gt_tau, gt_g = gt["tau"].values, gt["gamma"].values
    rp = float(np.trapezoid(gt_g, np.log(gt_tau)))

    rows = [run_arm(a, freq, Zb, gt_tau, gt_g, rp,
                escalate=args.escalate) for a in args.arms]
    df = pd.DataFrame(rows)
    out = os.path.join(os.path.dirname(__file__), "results", args.out)
    df.to_csv(out, index=False)
    print(df.to_string(index=False, float_format=lambda v: f"{v:.4f}"))
    print(f"-> {out}")


if __name__ == "__main__":
    main()
