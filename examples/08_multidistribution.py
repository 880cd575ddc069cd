"""Multi-distribution inversion: separate DRT and DDT processes in one fit.

The reference's flagship multi-distribution workload (paper section on
mixed-process electrodes; simulated as `Z_DRT-2-TpDDT`): a spectrum whose
impedance is the sum of a series DRT (charge transfer) and a parallel
transmissive-planar DDT (mass transport). One fit recovers BOTH
distributions, with credible bands from HMC.

Shows the single-spectrum `Inverter` path and the batched
`fit_spectra_batch(distributions=...)` path (the production form).

Run: python examples/08_multidistribution.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np
import pandas as pd

from bayes_drt_tpu import Inverter

DISTS = {
    "DRT": {"kernel": "DRT", "basis_freq": np.logspace(6, -2, 81)},
    "TP-DDT": {"kernel": "DDT", "symmetry": "planar", "bc": "transmissive",
               "dist_type": "parallel",
               "basis_freq": np.logspace(6, -2, 81), "x_scale": 0.8},
}

df = pd.read_csv("/root/reference/data/simulated/Z_DRT-2-TpDDT_uniform_0.25.csv")
freq = df["Freq"].values
Z = df["Zreal"].values + 1j * df["Zimag"].values
gt = pd.read_csv("/root/reference/data/simulated/gamma_DRT-2-TpDDT.csv")

# --- single spectrum: MAP first (fast), then HMC for credible bands ---
inv = Inverter(distributions=DISTS)
inv.fit(freq, Z, nonneg=True, random_seed=0)
print("model:", inv.stan_model_name)          # Series-Parallel

inv.fit(freq, Z, mode="sample", nonneg=True, random_seed=0,
        sampler="shmc", ncp=True, warmup=150, samples=250)

fig, axes = plt.subplots(1, 2, figsize=(9, 3.2))
for ax, (name, col) in zip(axes, (("DRT", "gamma"), ("TP-DDT", "ftp"))):
    inv.plot_distribution(distribution=name, ax=ax, plot_ci=True)
    ax.plot(gt["tau"], gt[col], "k--", lw=1, label="true")
    ax.set_title(name)
    ax.legend()
fig.tight_layout()
os.makedirs("examples/out", exist_ok=True)
fig.savefig("examples/out/multidist_recovery.png", dpi=100)
plt.close("all")

for name, col in (("DRT", "gamma"), ("TP-DDT", "ftp")):
    g = inv.predict_distribution(name, eval_tau=gt["tau"].values)
    rp = np.trapezoid(gt[col].values, np.log(gt["tau"].values))
    rmse = np.sqrt(np.mean((g - gt[col].values) ** 2))
    print(f"{name}: recovered-distribution RMSE = {100 * rmse / abs(rp):.2f}% "
          f"of its Rp")

# --- batched form: a fleet of noisy replicas through one XLA program ---
from bayes_drt_tpu.parallel import fit_spectra_batch

B = 8
rng = np.random.default_rng(1)
zr = np.max(Z.real) - np.min(Z.real)
Zb = Z[None, :] + 0.0025 * zr * (rng.standard_normal((B, len(Z)))
                                 + 1j * rng.standard_normal((B, len(Z))))
res = fit_spectra_batch(freq, Zb, mode="sample", chains=4, warmup=150,
                        samples=250, random_seed=0, ncp=True, nonneg=True,
                        sampler="shmc", distributions=DISTS)
# per-distribution coefficients: res.coef is the first distribution (DRT),
# res.diagnostics['coef_1'] the second (TP-DDT), both already rescaled
print(f"batched: {B} spectra fit; logp split-Rhat median "
      f"{np.median(res.diagnostics['logp_rhat']):.2f}")
print("figures written to examples/out/")
