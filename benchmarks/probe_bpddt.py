"""Localize the BimodalBP-DDT HMC failures (ext sweep: 6/7 cells FAIL with
z_dev ~ 300-600x and logp split-Rhat 23-39 while gamma recovery PASSES).

Mechanism hypothesis: 1-2 chains per cell initialize in (or wander into)
the Y_hat ~ 0 region of the blocking-DDT parallel model, where
Z_p = Y/(|Y|^2) is astronomically large and the data is 'explained' by a
huge Rinf (Rinf = Rinf_raw*100, Parallel_modelcode.txt:38); the collective
escape direction (all K coefficients must grow together against the ups
hierarchy) is slower than the md8 trajectory cap (255 leapfrogs), so the
chain never rejoins at the full 4x(500+500) budget. Stan's default cap is
max_treedepth=10 (1023 leapfrogs) — the reference's committed fits mixed.

Arms (all NUTS/ncp, B = the failing cells on their shared 41-pt grid):
  md8   : reproduce the ext-sweep arm
  md10  : Stan's default trajectory cap
  w1000 : md8 with doubled warmup
Per cell and arm: logp split-Rhat, z_dev vs committed Zout, and the
PER-CHAIN mean Rinf over the last 50 retained draws (monitor_draws) —
stuck chains show up as one chain at Rinf ~ 100-600 vs ~0 for the rest.

Writes benchmarks/results/probe_bpddt.csv.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pandas as pd

SIM = "/root/reference/data/simulated"
BAYR = "/root/reference/code_EchemActa/bayes_results"

CELLS = ["BimodalBP-DDT_noiseless", "BimodalBP-DDT_uniform_0.25",
         "BimodalBP-DDT_Macdonald_0.05"]


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--arms", nargs="+", default=["md8", "md10", "w1000"])
    ap.add_argument("--cells", nargs="+", default=CELLS)
    ap.add_argument("--samples", type=int, default=500)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default="probe_bpddt.csv")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from bayes_drt_tpu.progcache import enable_compile_cache
    enable_compile_cache()

    from bayes_drt_tpu.parallel import fit_spectra_batch, predict_Z_batch

    dists = {"DDT": {"kernel": "DDT", "symmetry": "planar", "bc": "blocking",
                     "dist_type": "parallel",
                     "basis_freq": np.logspace(6, -3, 91)}}

    dfs = [pd.read_csv(f"{SIM}/Z_{c}.csv") for c in args.cells]
    freq = dfs[0]["Freq"].values
    zb = np.stack([d["Zreal"].values + 1j * d["Zimag"].values for d in dfs])
    sigma_min = 0.002  # probe cells are all noisy or gated identically

    ARMS = {
        "md8": dict(warmup=500, md=8),
        "md10": dict(warmup=500, md=10),
        "w1000": dict(warmup=1000, md=8),
    }
    chains = 4
    rows = []
    for arm in args.arms:
        a = ARMS[arm]
        t0 = time.time()
        res = fit_spectra_batch(
            freq, zb, mode="sample", chains=chains, warmup=a["warmup"],
            samples=args.samples, ncp=True, sampler="nuts", tree_scan=True,
            scan_unroll=2, max_tree_depth=a["md"], distributions=dists,
            sigma_min=sigma_min, monitor_thin=1, escalate=False,
            random_seed=0)
        el = time.time() - t0
        md = res.diagnostics["monitor_draws"]       # (B, chains*samples, M)
        rinf_draws = md[:, :, 0].reshape(len(args.cells), chains, -1)
        for i, c in enumerate(args.cells):
            zr = pd.read_csv(f"{BAYR}/Zout_{c}.csv")
            z_ref = zr["Zreal"].values + 1j * zr["Zimag"].values
            z_us = predict_Z_batch(res, zr["freq"].values)[i]
            z_dev = float(np.median(np.abs(z_us - z_ref) / np.abs(z_ref)))
            per_chain_rinf = rinf_draws[i, :, -50:].mean(axis=1)
            rows.append({
                "arm": arm, "cell": c, "seconds": round(el, 1),
                "logp_rhat": float(res.diagnostics["logp_rhat"][i]),
                "div": float(res.diagnostics["divergence_rate"][i]),
                "z_dev": z_dev,
                "n_leapfrog": float(res.diagnostics["n_leapfrog"][i]),
                **{f"rinf_c{j}": float(v)
                   for j, v in enumerate(per_chain_rinf)},
            })
            print(rows[-1], file=sys.stderr, flush=True)

    df = pd.DataFrame(rows)
    out = os.path.join(os.path.dirname(__file__), "results", args.out)
    df.to_csv(out, index=False)
    print(df.to_string(index=False, float_format=lambda v: f"{v:.4g}"))


if __name__ == "__main__":
    main()
