"""Drift-fleet throughput: batched vs serial time-evolving MAP fits.

Workload: B cells measured on one three-sweep schedule (93 points each),
each drifting by a growing ZARC with per-cell magnitude/time-constant, fit
with the x1 drift model (ridge-seeded + 2 restarts, the single-spectrum
default workflow). Compares ONE `drift_fit_spectra_batch` program against
the serial `Inverter.drift_map_fit` loop it replaces (measured on one cell
and extrapolated — the reference has no batch drift path at all; its
analogue is re-running the per-spectrum workflow).

Run alone on the accelerator (no concurrent python jobs), best-of-N repeats
after a priming call, same protocol as benchmarks/baseline_configs.py.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def make_fleet(b, seed=0):
    rng = np.random.default_rng(seed)
    base_freq = np.logspace(5, -1, 31)
    freq = np.tile(base_freq, 3)
    times = np.linspace(0, 3 * 1800.0, len(freq))
    omega = 2 * np.pi * freq
    scales = rng.uniform(0.2, 0.8, b)
    taus_d = rng.uniform(400.0, 1200.0, b)
    Zb = []
    for s, td in zip(scales, taus_d):
        z = 1.0 + 1.0 / (1 + (1j * omega * 1e-3) ** 0.85) \
            + (1 - np.exp(-times / td)) * (s / (1 + (1j * omega * 0.05) ** 0.9))
        z += 0.001 * (rng.standard_normal(len(z))
                      + 1j * rng.standard_normal(len(z)))
        Zb.append(z)
    return freq, times, np.array(Zb)


def main():
    import jax
    from bayes_drt_tpu.progcache import enable_compile_cache
    enable_compile_cache()
    from bayes_drt_tpu import Inverter
    from bayes_drt_tpu.parallel import drift_fit_spectra_batch

    B = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    freq, times, Zb = make_fleet(B)
    kw = dict(drift_model="x1", random_seed=0, n_restarts=2,
              min_tau_drift=100.0, max_iter=1500)

    # prime compile + program cache
    drift_fit_spectra_batch(freq, times, Zb, **kw)
    best, res = float("inf"), None
    for rep in range(3):
        t0 = time.time()
        r = drift_fit_spectra_batch(freq, times, Zb,
                                    **{**kw, "random_seed": 1 + rep})
        el = time.time() - t0
        print(f"batched rep{rep}: {el:.2f}s", file=sys.stderr)
        if el < best:
            best, res = el, r
    resid = res.diagnostics["median_rel_resid"]
    print(f"batched: B={B} in {best:.2f}s = {best / B * 1e3:.1f} ms/cell; "
          f"median_rel_resid p50={np.median(resid):.4f} "
          f"max={resid.max():.4f}", file=sys.stderr)

    # serial single-cell comparison (same budget), one cell, best of 2
    inv = Inverter()
    inv.drift_map_fit(freq, Zb[0], times, **kw)   # prime
    s_best = float("inf")
    for rep in range(2):
        t0 = time.time()
        inv.drift_map_fit(freq, Zb[min(rep + 1, B - 1)], times,
                          **{**kw, "random_seed": 1 + rep})
        s_best = min(s_best, time.time() - t0)
    print(f"serial single-cell: {s_best:.2f}s -> {B} cells ~ "
          f"{s_best * B:.0f}s serial", file=sys.stderr)
    print(f"fleet speedup: {s_best * B / best:.1f}x "
          f"({best / B * 1e3:.1f} ms/cell batched vs "
          f"{s_best * 1e3:.0f} ms serial)", flush=True)


if __name__ == "__main__":
    main()
