"""What matmul precision 'high' means on this device, and the bench.py gates
of the ``fast`` preset under 'high' and under 'highest'.

1. Lowering: an f32 (4096, 101) @ (101, 162) product — the shape of the
   batched design-matrix product in the sampler — compiled under each
   precision. Prints the dot's precision fields from the compiled HLO and
   the product's relative error against float64 numpy (about 1e-7 is true
   f32, about 1e-6 bf16x3, about 1e-3 TF32, about 1e-2 bf16).
2. Gates and times: the bench.py workload (B=1024, escalation at its
   default) fit twice per precision — the first call compiles, the second
   is the steady time — with the gates of the second fit.

    python benchmarks/precision_gates.py [B]

Needs an accelerator: it exits non-zero on CPU.
"""

import os
import re
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PRECISIONS = ("high", "highest")


def lowering_report(precision, rng):
    import jax
    import jax.numpy as jnp
    a = rng.standard_normal((4096, 101)).astype(np.float32)
    b = rng.standard_normal((101, 162)).astype(np.float32)
    with jax.default_matmul_precision(precision):
        fn = jax.jit(lambda x, y: x @ y)
        compiled = fn.lower(a, b).compile()
        out = np.asarray(fn(jnp.asarray(a), jnp.asarray(b)), np.float64)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    err = float(np.linalg.norm(out - ref) / np.linalg.norm(ref))
    hlo = compiled.as_text()
    fields = sorted(set(re.findall(
        r'(operand_precision[^\]]*\]|"algorithm":"[A-Z0-9_]+"|'
        r'custom_call_target="[^"]+"|tf32|TF32)', hlo)))
    print(f"  precision={precision!r}: relative error {err:.3e}; compiled "
          f"HLO: {fields}", flush=True)


def main():
    import jax
    dev = jax.devices()[0]
    if dev.platform == "cpu":
        print("precision_gates: JAX found no accelerator", file=sys.stderr)
        return 1

    import bench
    from bayes_drt_tpu import sim
    from bayes_drt_tpu.parallel import fit_spectra_batch
    from bayes_drt_tpu.parallel.batch import QUALITY_PRESETS
    from bayes_drt_tpu.progcache import enable_compile_cache
    enable_compile_cache()

    print(f"device {dev.device_kind} x{len(jax.devices())}", flush=True)
    print("[lowering]", flush=True)
    rng = np.random.default_rng(0)
    for p in PRECISIONS + ("default",):
        lowering_report(p, rng)

    b = int(sys.argv[1]) if len(sys.argv) > 1 else bench.B
    freq, zb = sim.make_benchmark_batch(b, circuit="ZARC",
                                        noise_level=0.0025, seed=0)
    gt_tau, gt_g, rp = bench.ground_truth()
    fast = QUALITY_PRESETS["fast"]
    print(f"[gates] B={b}, fast preset budget, escalation at its default",
          flush=True)
    for p in PRECISIONS:
        kw = {k: v for k, v in fast.items() if k != "shmc_cfg"}
        times = []
        for seed in (1, 2):
            t0 = time.perf_counter()
            res = fit_spectra_batch(
                freq, zb, mode="sample", random_seed=seed,
                gamma_eval_tau=gt_tau,
                shmc_cfg=fast["shmc_cfg"]._replace(precision=p), **kw)
            times.append(time.perf_counter() - t0)
        g, ok = bench.quality_gates(res, gt_tau, gt_g, rp)
        d = res.diagnostics
        probe = d.get("high_grad_err")
        probe = ("" if probe is None else
                 f" grad discrepancy median {float(np.median(probe)):.3e}")
        print(f"  precision={p!r}: first call {times[0]:.3f} s, second "
              f"{times[1]:.3f} s; "
              f"rmse/Rp {g['rmse'] / rp:.4f} p90/Rp {g['p90'] / rp:.4f} "
              f"coverage {g['coverage']:.4f} min_ess_med "
              f"{g['min_ess_med']:.3f} logp_rhat_med {g['logp_rhat_med']:.3f}"
              f" div {float(np.mean(d['divergence_rate'])):.4f} escalated "
              f"{int(np.sum(d.get('escalated', 0)))}/{b}{probe} -> "
              f"{'OK' if ok else 'FAIL'}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
