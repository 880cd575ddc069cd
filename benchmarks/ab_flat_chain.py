"""A/B: generic SHMC (vmapped per-spectrum leaf scan, jax.grad) vs the
flat-chain SHMC (one (B*chains, D) chain axis, hand-written gradient).

Both arms run the bench.py workload (``fast`` preset budget, escalation
off) in ONE process, in turns base, flat, flat, base, after one compiling
call each, and print wall time, spectra/min and the five bench.py gates:

    python benchmarks/ab_flat_chain.py [B] [n_steps] [warmup] [samples]

The times decide whether a fused trajectory kernel over the flat layout is
worth writing (PERF.md). Needs an accelerator: it exits non-zero on CPU.
"""

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import jax
    dev = jax.devices()[0]
    if dev.platform == "cpu":
        print("ab_flat_chain: JAX found no accelerator", file=sys.stderr)
        return 1

    import bench
    from bayes_drt_tpu import sim
    from bayes_drt_tpu.infer.chees import SHMCConfig
    from bayes_drt_tpu.parallel import fit_spectra_batch
    from bayes_drt_tpu.progcache import enable_compile_cache
    enable_compile_cache()

    b = int(sys.argv[1]) if len(sys.argv) > 1 else bench.B
    n_steps = int(sys.argv[2]) if len(sys.argv) > 2 else bench.N_STEPS
    warmup = int(sys.argv[3]) if len(sys.argv) > 3 else bench.WARMUP
    samples = int(sys.argv[4]) if len(sys.argv) > 4 else bench.SAMPLES
    freq, zb = sim.make_benchmark_batch(b, circuit="ZARC",
                                        noise_level=0.0025, seed=0)
    gt_tau, gt_g, rp = bench.ground_truth()

    base = SHMCConfig(n_steps=n_steps, warm_steps=n_steps, leaf_unroll=2,
                      draw_unroll=2, recompute_grad=True,
                      eps_quantile=bench.EPS_QUANTILE,
                      precision=bench.PRECISION)
    # the flat path carries the selected gradient (no recompute_grad) and
    # runs its own matmuls at full f32 precision
    arms = {"base": base,
            "flat": base._replace(flat_chain=True, recompute_grad=False)}

    def run(tag, seed):
        t0 = time.perf_counter()
        res = fit_spectra_batch(freq, zb, mode="sample", chains=bench.CHAINS,
                                warmup=warmup, samples=samples,
                                random_seed=seed, ncp=True, sampler="shmc",
                                shmc_cfg=arms[tag], gamma_eval_tau=gt_tau,
                                escalate=False)
        el = time.perf_counter() - t0
        g, ok = bench.quality_gates(res, gt_tau, gt_g, rp)
        print(f"{tag:5s} seed {seed}: {el:8.3f} s {b / (el / 60):9.1f} "
              f"spectra/min  rmse/Rp {g['rmse'] / rp:.4f}  p90/Rp "
              f"{g['p90'] / rp:.4f}  cov {g['coverage']:.3f}  "
              f"minESS {g['min_ess_med']:.2f}  lpR {g['logp_rhat_med']:.2f}"
              f"  div {float(np.mean(res.diagnostics['divergence_rate'])):.3f}"
              f"  gates {'OK' if ok else 'FAIL'}", flush=True)

    print(f"device {dev.device_kind} x{len(jax.devices())}; B={b} "
          f"chains={bench.CHAINS} n_steps={n_steps} warmup={warmup} "
          f"samples={samples}", flush=True)
    for tag in arms:
        run(tag, 0)                        # compiles
    for i, tag in enumerate(("base", "flat", "flat", "base")):
        run(tag, 1 + i)
    return 0


if __name__ == "__main__":
    sys.exit(main())
