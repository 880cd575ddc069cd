"""Benchmark: massively batched HMC inversion throughput.

Workload: B simulated ZARC spectra (N=81 frequencies, K=101 basis functions,
the reference's standard problem size), each fit with full-budget sampling —
4 chains x (150 warmup + 250 retained draws) — in ONE XLA program vmapped
over spectra and chains. Configuration (the ``fast`` preset of
parallel/batch.py):

- sampler: synchronous static multinomial HMC (sample_shmc) — every draw of
  every chain runs the same static-scan trajectory (Betancourt's static
  multinomial scheme), so the vmapped batch never waits on a straggler and
  none of NUTS' per-leaf tree bookkeeping is paid. n_steps=32 leapfrogs per
  draw, warmup draws (discarded) 32 as well.
- eps_quantile=0.5: sampling runs at the MEDIAN of the per-chain adapted
  step sizes instead of the min. A divergent leg is never
  multinomial-selected, so out-running the most timid chain trades some
  wasted trajectory for faster mixing for everyone.
- warmup=150: a longer warmup gives some chain more chances to freeze a
  too-small step size that drags every chain's mixing down.
- non-centered parameterization (ncp=True): identical posterior, lower
  recovery error at this budget.
- matmul precision: PRECISION below, the same as the ``fast`` preset.
  Reduced-precision matmuls with an 8-bit mantissa are catastrophic for the
  leapfrog gradients (an earlier run: RMSE 5.6 %Rp, coverage 0.870,
  logp-Rhat 51); PERF.md records the gates of 'high' and 'highest' on the
  current hardware.

Ground truth is the analytic ZARC DRT (``sim.reference_gamma``) on the
GT_TAU grid below, which spans the ZARC's time constant +-4 decades (the
truncated tails hold under 0.1% of Rp).

The warm-up call compiles and primes the cross-call program cache, so the
timed runs measure execution; the best of three timed runs is reported.

Baseline: the reference fits ONE spectrum with Stan NUTS at 4 chains x
(500+500) in 515.5 s on CPU (BASELINE.md, code_EchemActa/"Run fits.ipynb"
4x1000 cell). HMC cost is linear in total iterations, so the reference is
scaled to THIS benchmark's warmup+draws budget (4 x 400 iterations:
515.5 x 400/1000 = 206.2 s/spectrum) — cutting our warmup does not
inflate the vs_baseline multiplier.

Prints one JSON line:
  {"metric": ..., "value": spectra/min, "unit": "spectra/min",
   "vs_baseline": N, "ess_per_sec": ..., "min_ess_median": ...}

Correctness gates (throughput only counts if the posterior is right):
- batch-mean recovered gamma RMSE < 3% of Rp
- per-spectrum RMSE p90 < 5% of Rp
- TRUE pointwise 95%-credible-band coverage of the ground-truth
  distribution > 0.93 (per-draw gamma evaluation)
- median per-spectrum min-ESS (bulk ESS over logp + gamma monitors,
  computed in-program) > 3.5 and median logp split-Rhat < 4.0 — the
  trajectory-length guard: halving the trajectory budget fails these
  before it moves the RMSE gate.
"""

import json
import sys
import time

import numpy as np


B = 1024
CHAINS = 4
WARMUP = 150
SAMPLES = 250
N_STEPS = 32
WARM_STEPS = 32
EPS_QUANTILE = 0.5
PRECISION = "high"
# ground-truth tau grid: the ZARC time constant (1e-3 s) +-4 decades
GT_TAU = np.logspace(-7, 1, 201)
# reference 4x1000 scaled to this benchmark's 4x(WARMUP+SAMPLES) budget
BASELINE_SEC_PER_SPECTRUM = 515.5 * (WARMUP + SAMPLES) / 1000.0

GATE_RMSE = 0.03          # of Rp, batch mean
GATE_P90 = 0.05           # of Rp, per-spectrum p90
GATE_COVERAGE = 0.93      # pointwise 95% CI coverage
GATE_MIN_ESS = 3.5        # median per-spectrum min-ESS
GATE_LOGP_RHAT = 4.0      # median per-spectrum logp split-Rhat


def ground_truth():
    """(tau, gamma, Rp) of the analytic ZARC DRT on GT_TAU."""
    from bayes_drt_tpu import sim
    gt_g = sim.reference_gamma("ZARC", GT_TAU)
    return GT_TAU, gt_g, float(np.trapezoid(gt_g, np.log(GT_TAU)))


def quality_gates(res, gt_tau, gt_g, rp):
    """The five correctness gates of a fit made with gamma_eval_tau=gt_tau:
    (dict of the measured values, whether all gates pass)."""
    from bayes_drt_tpu.parallel import evaluate_gamma
    d = res.diagnostics
    gammas = evaluate_gamma(res, gt_tau)
    per_rmse = np.sqrt(np.mean((gammas - gt_g[None, :]) ** 2, axis=1))
    g = {
        "rmse": float(np.sqrt(np.mean((gammas.mean(axis=0) - gt_g) ** 2))),
        "p90": float(np.percentile(per_rmse, 90)),
        "coverage": float(np.mean((gt_g[None, :] >= d["gamma_eval_lo"])
                                  & (gt_g[None, :] <= d["gamma_eval_hi"]))),
        "min_ess_med": float(np.median(d["min_ess"])),
        "logp_rhat_med": float(np.median(d["logp_rhat"])),
    }
    ok = ((g["rmse"] < GATE_RMSE * rp) and (g["p90"] < GATE_P90 * rp)
          and (g["coverage"] > GATE_COVERAGE)
          and (g["min_ess_med"] > GATE_MIN_ESS)
          and (g["logp_rhat_med"] < GATE_LOGP_RHAT))
    return g, ok


def main():
    from bayes_drt_tpu.progcache import enable_compile_cache
    enable_compile_cache()
    from bayes_drt_tpu.infer.chees import SHMCConfig
    from bayes_drt_tpu.parallel import fit_spectra_batch

    from bayes_drt_tpu import sim
    # noisy replicas of the reference's simulated ZARC circuit at its
    # standard 0.25% uniform noise level (Data simulation.ipynb)
    freq, Zb = sim.make_benchmark_batch(B, circuit="ZARC",
                                        noise_level=0.0025, seed=0)
    gt_tau, gt_g, rp = ground_truth()

    # recompute_grad: don't carry the selected proposal's (C, D) gradient
    # through the leaf scan — one gradient recompute per draw instead of a
    # masked select per leaf (same posterior, draws differ only by float
    # re-association)
    shmc_cfg = SHMCConfig(n_steps=N_STEPS, warm_steps=WARM_STEPS,
                          leaf_unroll=2, draw_unroll=2, recompute_grad=True,
                          eps_quantile=EPS_QUANTILE, precision=PRECISION)

    def run(seed):
        return fit_spectra_batch(freq, Zb, mode="sample", chains=CHAINS,
                                 warmup=WARMUP, samples=SAMPLES,
                                 random_seed=seed, ncp=True, sampler="shmc",
                                 shmc_cfg=shmc_cfg, gamma_eval_tau=gt_tau)

    # warm the compile cache with an identical-structure run so the timed
    # runs measure sampling, not XLA compilation
    run(0)

    elapsed, res, timings = float("inf"), None, []
    for rep in range(3):
        t0 = time.time()
        r = run(1 + rep)
        el = time.time() - t0
        timings.append(round(el, 2))
        if el < elapsed:
            elapsed, res = el, r

    d = res.diagnostics
    g, ok = quality_gates(res, gt_tau, gt_g, rp)
    rmse, p90, coverage = g["rmse"], g["p90"], g["coverage"]
    min_ess_med, lp_rhat_med = g["min_ess_med"], g["logp_rhat_med"]
    ess_per_sec = float(np.sum(d["min_ess"]) / elapsed)

    spectra_per_min = B / (elapsed / 60.0)
    baseline_throughput = 60.0 / BASELINE_SEC_PER_SPECTRUM
    import jax
    dev = jax.devices()[0]
    result = {
        "metric": "batched HMC DRT inversion throughput (4 chains x (150 warmup + 250 draws)/spectrum, N=81, K=101; reference baseline scaled to the same budget)",
        "value": round(spectra_per_min, 2),
        "unit": "spectra/min",
        "vs_baseline": round(spectra_per_min / baseline_throughput, 1),
        "ess_per_sec": round(ess_per_sec, 1),
        "min_ess_median": round(min_ess_med, 2),
        "best_of": len(timings),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "timings_s": timings,
    }
    # diagnostics to stderr so stdout stays a single JSON line
    print(f"elapsed={elapsed:.1f}s B={B} gamma_rmse={rmse:.4f} "
          f"per_spec_p90={p90:.4f} ci_coverage={coverage:.3f} "
          f"min_ess_med={min_ess_med:.2f} logp_rhat_med={lp_rhat_med:.2f} "
          f"ess_per_sec={ess_per_sec:.0f} "
          f"(gate {'OK' if ok else 'FAIL'}) "
          f"div_rate={d['divergence_rate'].mean():.3f} "
          f"n_leapfrog={d['n_leapfrog'].mean():.0f}",
          file=sys.stderr)
    if not ok:
        result["value"] = 0.0
        result["vs_baseline"] = 0.0
        result["error"] = (f"quality gate failed: mean RMSE {rmse:.4f}, "
                           f"p90 {p90:.4f} (Rp {rp:.3f}), "
                           f"coverage {coverage:.3f}, "
                           f"min_ess_med {min_ess_med:.2f}, "
                           f"logp_rhat_med {lp_rhat_med:.2f}")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
