"""Localize the 2RC_*_0.25 paper-batch HMC outliers.

The full-budget sweep (paper_batch.py, an earlier run) left exactly
three FAILs: 2RC (double-delta DRT) at 0.25 noise under all three noise
models, agreement-with-Stan RMSE 0.105-0.115 vs the 0.10*Rp heuristic,
improving monotonically with noise. MAP on the same spectra agrees with
Stan's MAP at 0.02-0.03*Rp, so matrices/penalties/mode are not the cause —
the posterior MEAN differs. This probe reruns the whole 2RC family (all 10
noise cells, one batched program) at the full 4x(500+500) budget under
three sampler arms to separate the candidate causes:

  prod-f32 : shmc + ncp + eps_q0.5, precision='highest'  -> isolates 'high'
  nuts-ncp : NUTS md8 + ncp, precision='highest'         -> isolates SHMC
  nuts-cen : NUTS md8, CENTERED, precision='highest'     -> strict Stan-
             coordinate parity (same coordinates Stan samples in)

If nuts-cen still lands ~0.105-0.115, the committed "systematic smoothing
difference, not a convergence artifact" explanation holds for the whole
stack; any arm that pulls the number under 0.10 indicts the knobs that arm
removed. Reference anchor: code_EchemActa/bayes_results/Gout_2RC_*.csv
(Stan 4x1000, Run fits.ipynb).

CONCLUSION (an earlier run, 7 arms): TRAJECTORY LENGTH.
Both NUTS arms pass every gated cell (0.053-0.078 on the 0.25 cells), so
the "smoothing difference" explanation was wrong. rmse_vs_ref is monotone
in leapfrogs/draw: n32 0.105-0.107, n64 0.096-0.109, n128 0.083-0.093
(all PASS), NUTS md8 (<=255 leaves) 0.053-0.078. Step-size pooling is
exonerated (q0/q25/q50/per-chain within noise of each other), as are
precision (all SHMC arms ran 'highest') and warm_steps. The double-delta
posterior has a slow mixing direction needing 4-8x the production
trajectory; remedy for delta-like spectra: SHMCConfig(n_steps=128) or
sampler='nuts'.

Usage: python benchmarks/probe_2rc.py [--warmup 500 --samples 500]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pandas as pd

SIM = "/root/reference/data/simulated"
BAYR = "/root/reference/code_EchemActa/bayes_results"
NOISES = (["noiseless"]
          + [f"{k}_{v}" for k in ("uniform", "Macdonald", "Orazem")
             for v in ("0.25", "1.0", "2.5")])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--warmup", type=int, default=500)
    ap.add_argument("--samples", type=int, default=500)
    ap.add_argument("--arms", nargs="+",
                    default=["prod-f32", "nuts-ncp", "nuts-cen"])
    ap.add_argument("--out", default="probe_2rc.csv",
                    help="filename under benchmarks/results/")
    args = ap.parse_args()

    import jax
    from bayes_drt_tpu.progcache import enable_compile_cache
    enable_compile_cache()

    from bayes_drt_tpu.infer.chees import SHMCConfig
    from bayes_drt_tpu.parallel import evaluate_gamma as eg
    from bayes_drt_tpu.parallel import fit_spectra_batch

    cases = [n for n in NOISES
             if os.path.exists(f"{SIM}/Z_2RC_{n}.csv")]
    dfs = [pd.read_csv(f"{SIM}/Z_2RC_{n}.csv") for n in cases]
    freq = dfs[0]["Freq"].values
    zb = np.stack([d["Zreal"].values + 1j * d["Zimag"].values for d in dfs])

    def shmc(**kw):
        base = dict(n_steps=32, warm_steps=32, leaf_unroll=2, draw_unroll=2,
                    recompute_grad=True, eps_quantile=0.5,
                    precision="highest")
        base.update(kw)
        return dict(ncp=True, sampler="shmc", shmc_cfg=SHMCConfig(**base))

    arm_kw = {
        "prod-f32": shmc(),
        # SHMC knob arms: which configuration dimension closes the gap the
        # NUTS arms expose on the low-noise double-delta cells?
        "shmc-n64": shmc(n_steps=64, warm_steps=64),
        "shmc-n128": shmc(n_steps=128, warm_steps=128),
        "shmc-q25": shmc(eps_quantile=0.25),
        "shmc-q0": shmc(eps_quantile=0.0),
        "shmc-qpc": shmc(eps_quantile=-1.0),  # per-chain eps, no pooling
        "shmc-n64q25": shmc(n_steps=64, warm_steps=64, eps_quantile=0.25),
        "nuts-ncp": dict(ncp=True, sampler="nuts", tree_scan=True,
                         scan_unroll=2, max_tree_depth=8),
        "nuts-cen": dict(ncp=False, sampler="nuts", tree_scan=True,
                         scan_unroll=2, max_tree_depth=8),
    }

    rows = []
    for arm in args.arms:
        t0 = time.time()
        res = fit_spectra_batch(freq, zb, mode="sample", chains=4,
                                warmup=args.warmup, samples=args.samples,
                                random_seed=0, **arm_kw[arm])
        el = time.time() - t0
        print(f"arm {arm}: {el:.1f}s", file=sys.stderr, flush=True)
        for i, n in enumerate(cases):
            ref = pd.read_csv(f"{BAYR}/Gout_2RC_{n}.csv")
            tau_ref, g_ref = ref["tau"].values, ref["gamma"].values
            g_us = eg(res, tau_ref)[i]
            rp = max(abs(float(np.trapezoid(g_ref, np.log(tau_ref)))),
                     float(np.max(np.abs(g_ref))), 1e-12)
            rows.append({
                "arm": arm, "case": f"2RC_{n}",
                "rmse_vs_ref": float(np.sqrt(np.mean((g_us - g_ref) ** 2))) / rp,
                "logp_rhat": float(res.diagnostics["logp_rhat"][i]),
                "div_rate": float(res.diagnostics["divergence_rate"][i]),
                "seconds": round(el, 1),
            })

    df = pd.DataFrame(rows)
    out = os.path.join(os.path.dirname(__file__), "results", args.out)
    df.to_csv(out, index=False)
    piv = df.pivot(index="case", columns="arm", values="rmse_vs_ref")
    print(piv.to_string(float_format=lambda v: f"{v:.4f}"))
    print(f"-> {out}")


if __name__ == "__main__":
    main()
