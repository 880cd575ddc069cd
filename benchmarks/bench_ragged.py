"""Accelerator throughput of fit_spectra_ragged — heterogeneous frequency grids.

The realistic production shape (SURVEY.md section 7 'vmapped heterogeneity'):
a fleet of spectra measured on DIFFERENT grids (different ppd, different
ranges, different lengths), all fit in ONE padded/masked XLA program. This
measures what a batch service pays for the padding + per-spectrum A-matrix
stacks relative to the uniform-grid fast path.

Protocol: back-to-back in one process, warm run first, best of three timed
runs. Run on the accelerator:

    python benchmarks/bench_ragged.py [B]
"""

import os
import sys
import time

import numpy as np
import pandas as pd

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_ragged_fleet(B, seed=0):
    """B ZARC spectra on heterogeneous grids: ppd in {8, 10, 12}, span
    shifted up to a decade per spectrum, 0.25% noise."""
    from bayes_drt_tpu import sim
    rng = np.random.default_rng(seed)
    spectra = []
    for i in range(B):
        ppd = rng.choice([8, 10, 12])
        lo = -2 + rng.uniform(0, 1.0)
        hi = 6 - rng.uniform(0, 1.0)
        n = int((hi - lo) * ppd) + 1
        freq = np.logspace(hi, lo, n)
        Z = sim.reference_circuit("ZARC", freq)
        sigma = 0.0025 * np.abs(Z)
        Z = Z + sigma * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        spectra.append((freq, Z))
    return spectra


def main():
    import jax
    from bayes_drt_tpu.progcache import enable_compile_cache
    enable_compile_cache()

    from bayes_drt_tpu.infer.chees import SHMCConfig
    from bayes_drt_tpu.parallel import fit_spectra_ragged

    B = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    chains, warmup, samples = 4, 150, 250
    cfg = SHMCConfig(n_steps=32, warm_steps=32, leaf_unroll=2, draw_unroll=2,
                     recompute_grad=True, eps_quantile=0.5)
    spectra = make_ragged_fleet(B)
    lens = np.array([len(f) for f, _ in spectra])
    print(f"B={B} grids: n in [{lens.min()},{lens.max()}] "
          f"(mean {lens.mean():.1f})", flush=True)

    gt = pd.read_csv("/root/reference/data/simulated/gamma_ZARC.csv")
    gt_tau, gt_g = gt["tau"].values, gt["gamma"].values
    rp = np.trapezoid(gt_g, np.log(gt_tau))

    def run(tag, seed):
        t0 = time.time()
        res = fit_spectra_ragged(spectra, mode="sample", chains=chains,
                                 warmup=warmup, samples=samples,
                                 random_seed=seed, ncp=True, sampler="shmc",
                                 shmc_cfg=cfg, gamma_eval_tau=gt_tau)
        el = time.time() - t0
        d = res.diagnostics
        from bayes_drt_tpu.parallel import evaluate_gamma
        g = evaluate_gamma(res, gt_tau)
        per = np.sqrt(np.mean((g - gt_g[None, :]) ** 2, axis=1))
        cov = float(np.mean((gt_g[None, :] >= d["gamma_eval_lo"])
                            & (gt_g[None, :] <= d["gamma_eval_hi"])))
        print(f"{tag}: {el:7.2f}s  {B / (el / 60):8.0f} spm  "
              f"rmse/Rp mean {per.mean() / rp:.4f} p90 "
              f"{np.percentile(per, 90) / rp:.4f}  cov {cov:.3f}  "
              f"lpR {np.median(d['logp_rhat']):.2f}  "
              f"minESS {np.median(d['min_ess']):.1f}", flush=True)
        return el

    run("warm", 0)
    best = min(run(f"r{i}  ", 1 + i) for i in range(3))
    print(f"best: {best:.2f}s = {B / (best / 60):.0f} spectra/min", flush=True)


if __name__ == "__main__":
    main()
