"""Batched inversion — the capability the reference cannot offer.

Fits a whole directory's worth of spectra in single XLA programs:
hyper-lambda ridge (milliseconds/spectrum) and full HMC posteriors
(hundreds of spectra for the price of one).

Run: python examples/01_batched_inversion.py

Note: the first run of each program shape pays an XLA compile (seconds on
CPU, longer on a GPU); batches are padded to power-of-two sizes so repeated
runs reuse compiled shapes.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import glob
import time

import numpy as np
import pandas as pd

from bayes_drt_tpu.parallel import (evaluate_gamma, fit_spectra_batch,
                                    ridge_fit_spectra_batch)

# gather all uniform-noise simulated ZARC-family spectra on a shared grid
files = sorted(glob.glob("/root/reference/data/simulated/Z_*ZARC*_uniform_*.csv"))
dfs = [pd.read_csv(f) for f in files]
freq = dfs[0]["Freq"].values
batch = [d for d in dfs if len(d) == len(freq)]
Zb = np.stack([d["Zreal"].values + 1j * d["Zimag"].values for d in batch])
print(f"{len(Zb)} spectra on a shared {len(freq)}-point grid")

# --- batched hyper-lambda ridge ---
t0 = time.time()
res = ridge_fit_spectra_batch(freq, Zb)
print(f"batched ridge: {time.time() - t0:.2f} s "
      f"({(time.time() - t0) / len(Zb) * 1e3:.0f} ms/spectrum incl. compile)")
print("R_inf:", np.round(res.r_inf, 3))

# per-spectrum lambda selection by Re-Im cross-validation: the whole
# (grid x batch x 2 part-fits + final fit) sweep is one XLA program
res_cv = ridge_fit_spectra_batch(freq, Zb,
                                 cv_lambdas=np.logspace(-5, 1, 7))
print("CV-selected lambda per spectrum:",
      np.round(np.log10(res_cv.diagnostics["cv_lambda"]), 1))

# --- batched MAP ---
t0 = time.time()
res_map = fit_spectra_batch(freq, Zb, mode="optimize", n_restarts=2)
print(f"batched MAP: {time.time() - t0:.2f} s")

# --- batched HMC (small budget for the example) ---
t0 = time.time()
res_hmc = fit_spectra_batch(freq, Zb, mode="sample", chains=2, warmup=100,
                            samples=100, max_tree_depth=8)
print(f"batched HMC (2x(100+100)): {time.time() - t0:.2f} s")
print("divergence rate:", res_hmc.diagnostics["divergence_rate"].mean())

# credible-interval widths per spectrum
tau_eval = np.logspace(-7, 2, 50)
width = (evaluate_gamma(res_hmc, tau_eval, "hi")
         - evaluate_gamma(res_hmc, tau_eval, "lo")).mean(axis=1)
print("mean CI width per spectrum:", np.round(width, 4))
