"""Capture a jax.profiler device trace of the production sampling step and
attribute the per-draw cost (settle the cost model with device counters
instead of wall-clock inference).

Two artifacts:
1. A jax.profiler trace of ONE timed production fit (B spectra, the bench
   config) under benchmarks/results/trace_r5/ — open with TensorBoard or
   xprof; the trace_viewer timeline attributes device time per op.
2. A stdout cost decomposition from op-level self-times (the
   device_stats summary the profiler embeds), written to
   benchmarks/results/profile_draw_r5.txt.

Also times the SAME program at B=512/1024 back-to-back in one process with
the profiler OFF (relative scaling), then profiles the B=1024 run.

Usage: python benchmarks/profile_draw.py [--b 1024] [--profile-b 1024]
"""

import argparse
import glob
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pandas as pd


def build_runner(B, warmup, samples):
    from bayes_drt_tpu.infer.chees import SHMCConfig
    from bayes_drt_tpu.parallel import fit_spectra_batch
    from bayes_drt_tpu import sim

    freq, Zb = sim.make_benchmark_batch(B, circuit="ZARC",
                                        noise_level=0.0025, seed=0)
    cfg = SHMCConfig(n_steps=32, warm_steps=32, leaf_unroll=2, draw_unroll=2,
                     recompute_grad=True, eps_quantile=0.5, precision="high")

    def run(seed):
        return fit_spectra_batch(freq, Zb, mode="sample", chains=4,
                                 warmup=warmup, samples=samples,
                                 random_seed=seed, ncp=True, sampler="shmc",
                                 shmc_cfg=cfg, escalate=False)

    return run


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--b-scaling", nargs="+", type=int, default=[512, 1024])
    ap.add_argument("--profile-b", type=int, default=1024)
    ap.add_argument("--warmup", type=int, default=150)
    ap.add_argument("--samples", type=int, default=250)
    args = ap.parse_args()

    import jax
    from bayes_drt_tpu.progcache import enable_compile_cache
    enable_compile_cache()

    total_draws = args.warmup + args.samples

    # ---- stage 1: drift-free B-scaling (one process, back-to-back) ----
    rows = []
    for B in args.b_scaling:
        run = build_runner(B, args.warmup, args.samples)
        run(0)                                   # compile
        times = []
        for rep in range(3):
            t0 = time.time()
            run(1 + rep)
            times.append(time.time() - t0)
        el = min(times)
        rows.append(dict(B=B, seconds=round(el, 2),
                         ms_per_draw=round(1e3 * el / total_draws, 2),
                         ms_per_draw_per_512=round(
                             1e3 * el / total_draws / (B / 512), 3),
                         spm=round(B / (el / 60), 0), timings=times))
        print(rows[-1], file=sys.stderr, flush=True)
    scaling = pd.DataFrame(rows)

    # ---- stage 2: profiler trace of the production shape ----
    trace_dir = os.path.join(os.path.dirname(__file__), "results",
                             "trace_r5")
    os.makedirs(trace_dir, exist_ok=True)
    run = build_runner(args.profile_b, args.warmup, args.samples)
    run(0)
    with jax.profiler.trace(trace_dir):
        t0 = time.time()
        run(9)
        el = time.time() - t0
    print(f"profiled run: {el:.2f}s -> {trace_dir}", file=sys.stderr,
          flush=True)

    out = [f"B-scaling (one process, best-of-3, {args.warmup}+{args.samples}"
           f" draws x 4 chains, shmc n32):",
           scaling.to_string(index=False), "",
           f"profiled run at B={args.profile_b}: {el:.2f}s "
           f"({1e3 * el / total_draws:.2f} ms/draw)",
           f"trace: {trace_dir}"]

    # try to extract an op-level summary from the trace (plugin layout
    # varies by jax version; fall back to just the trace artifact)
    try:
        import gzip
        import json as js
        cands = sorted(glob.glob(os.path.join(
            trace_dir, "plugins", "profile", "*", "*.trace.json.gz")))
        if cands:
            with gzip.open(cands[-1], "rt") as f:
                tr = js.load(f)
            evs = [e for e in tr.get("traceEvents", [])
                   if e.get("ph") == "X" and e.get("dur")]
            df = pd.DataFrame([{"name": e["name"], "dur_us": e["dur"]}
                               for e in evs])
            # keep device-stream op events only: drop python/runtime rows
            agg = (df.groupby("name")["dur_us"].agg(["sum", "count"])
                     .sort_values("sum", ascending=False).head(40))
            out += ["", "top-40 trace events by total self duration (us):",
                    agg.to_string()]
    except Exception as e:                                  # noqa: BLE001
        out += ["", f"(trace summary extraction failed: {e!r})"]

    report = "\n".join(out)
    print(report)
    with open(os.path.join(os.path.dirname(__file__), "results",
                           "profile_draw_r5.txt"), "w") as f:
        f.write(report + "\n")


if __name__ == "__main__":
    main()
