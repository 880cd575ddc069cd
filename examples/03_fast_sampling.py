"""Short-budget HMC done right: the non-centered parameterization.

The hierarchical DRT posterior couples the coefficient vector x to its
local complexity scales ups (q ~ N(0, ups); reference:
bayes_drt/stan_model_files/Series_modelcode.txt:55-69). Sampled in the
centered coordinates Stan uses, that coupling is a funnel: at short chain
budgets the sampler mixes slowly through the ups hierarchy and the
per-spectrum log-density split-Rhat stays far above 1.

``ncp=True`` samples z with x = ups * z and the matching Jacobian — a pure
change of variables targeting the IDENTICAL posterior — and removes the
funnel. Measured at the benchmark budget (4 chains x (250+250), ZARC,
0.25% noise): recovered-gamma RMSE drops ~3x and divergences go to zero,
at the same cost per draw.

Run from the repo root: python examples/03_fast_sampling.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import pandas as pd

from bayes_drt_tpu.parallel import evaluate_gamma, fit_spectra_batch

DATA = "/root/reference/data/simulated"


def main():
    df = pd.read_csv(f"{DATA}/Z_ZARC_Macdonald_0.25.csv")
    freq = df["Freq"].values
    z = df["Zreal"].values + 1j * df["Zimag"].values
    rng = np.random.default_rng(0)
    b = 8
    zb = z[None, :] + 0.002 * (rng.standard_normal((b, len(z)))
                               + 1j * rng.standard_normal((b, len(z))))

    gt = pd.read_csv(f"{DATA}/gamma_ZARC.csv")
    rp = np.trapezoid(gt["gamma"].values, np.log(gt["tau"].values))

    for ncp in (False, True):
        res = fit_spectra_batch(freq, zb, mode="sample", chains=2,
                                warmup=150, samples=150, max_tree_depth=6,
                                random_seed=1, ncp=ncp)
        gam = evaluate_gamma(res, gt["tau"].values)
        rmse = float(np.sqrt(np.mean((gam.mean(axis=0)
                                      - gt["gamma"].values) ** 2)))
        print(f"ncp={ncp!s:5}: gamma RMSE {rmse / rp * 100:.2f}% of Rp, "
              f"divergence rate "
              f"{res.diagnostics['divergence_rate'].mean():.3f}, "
              f"logp split-Rhat "
              f"{res.diagnostics['logp_rhat'].mean():.2f}")

    # the batch-first production sampler: synchronous static multinomial HMC
    # (every draw of every chain runs the same static-scan trajectory —
    # zero batch divergence under vmap; bench.py's configuration).
    # eps_quantile=0.5 freezes the MEDIAN of the per-chain adapted step
    # sizes for sampling instead of the conservative min: divergent legs
    # are never multinomial-selected, so out-running the most timid chain
    # costs only wasted trajectory and mixes every chain faster — it is
    # what lets 32-step trajectories match 48-step quality.
    from bayes_drt_tpu.infer.chees import SHMCConfig
    res = fit_spectra_batch(freq, zb, mode="sample", chains=4, warmup=150,
                            samples=250, random_seed=1, ncp=True,
                            sampler="shmc",
                            shmc_cfg=SHMCConfig(n_steps=32, warm_steps=32,
                                                recompute_grad=True,
                                                eps_quantile=0.5),
                            gamma_eval_tau=gt["tau"].values)
    gam = evaluate_gamma(res, gt["tau"].values)
    rmse = float(np.sqrt(np.mean((gam.mean(axis=0) - gt["gamma"].values) ** 2)))
    cov = float(np.mean((gt["gamma"].values[None, :]
                         >= res.diagnostics["gamma_eval_lo"])
                        & (gt["gamma"].values[None, :]
                           <= res.diagnostics["gamma_eval_hi"])))
    print(f"ncp+shmc   : gamma RMSE {rmse / rp * 100:.2f}% of Rp, "
          f"divergence rate {res.diagnostics['divergence_rate'].mean():.3f}, "
          f"pointwise 95%-CI coverage {cov:.3f}, "
          f"min-ESS median {np.median(res.diagnostics['min_ess']):.1f}")

    # pooled preconditioning: one shared dense metric estimated from pilot
    # draws pooled across the whole batch (see fit_spectra_batch docstring)
    res = fit_spectra_batch(freq, zb, mode="sample", chains=2, warmup=150,
                            samples=150, max_tree_depth=6, random_seed=1,
                            ncp=True, precondition="pooled",
                            pilot_warmup=50, pilot_samples=25)
    gam = evaluate_gamma(res, gt["tau"].values)
    rmse = float(np.sqrt(np.mean((gam.mean(axis=0) - gt["gamma"].values) ** 2)))
    print(f"ncp+pooled : gamma RMSE {rmse / rp * 100:.2f}% of Rp, "
          f"divergence rate {res.diagnostics['divergence_rate'].mean():.3f}")


if __name__ == "__main__":
    main()
