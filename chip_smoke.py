"""Smoke test of the main path on an NVIDIA GPU.

Run from the repository root:

    python chip_smoke.py               # one GPU: phases 1-7 below
    python chip_smoke.py --devices 4   # four GPUs: the sharded fit only

It drives the package through the entry points a user calls, at the full
width the package supports (N=81 frequencies, K=101 basis functions), in ONE
process, and prints what each phase finds with its first-call (compile) and
second-call (steady) wall time:

1. device     — JAX's platform must be "gpu"; the card's name and power limit
2. setup      — construct_A/construct_L at N=81, K=101 on the host CPU
                backend and on the card, and where fits build them
3. single     — Inverter().fit (MAP) and Inverter().ridge_fit on one ZARC
4. hmc        — fit_spectra_batch(quality="fast") at B=1024, with the five
                bench.py gates against the analytic ZARC DRT
5. nuts       — fit_spectra_batch(quality="strict") at B=32 (the NUTS
                tree_scan program every escalation refit also uses)
6. ridge      — ridge_fit_spectra_batch at B=1024
7. cli        — `python -m bayes_drt_tpu fit` on 8 CSV spectra, in process

With ``--devices 4`` only the sharded path runs: the ``fast`` preset at
B=4096 over make_mesh() on four cards, compared with the same fit on one.

Any failed phase or gate raises, so the script exits non-zero; the last
line of standard output is a JSON object with ``"ok": true`` only when
every phase passed. Without a GPU it exits non-zero before any phase.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

N_FREQ = 81
B_HMC = 1024
B_NUTS = 32
B_RIDGE = 1024
B_MESH = 4096
N_CLI = 8
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "smoke_out")

# single-spectrum and ridge recovery limits, as fractions of Rp (the
# batched HMC fits are held to bench.py's gates instead)
GATE_SINGLE_RMSE = 0.05
GATE_SINGLE_RESID = 0.01      # median relative |Z_hat - Z| / |Z|
GATE_RIDGE_RMSE = 0.05


def log(msg):
    print(msg, flush=True)


def timed(name, fn):
    """Call ``fn`` twice; print and return (first s, second s, result of
    the second call). ``fn`` must block until its device work is done."""
    t0 = time.perf_counter()
    fn()
    t1 = time.perf_counter()
    out = fn()
    t2 = time.perf_counter()
    log(f"  {name}: first {t1 - t0:.3f} s, second {t2 - t1:.3f} s")
    return t1 - t0, t2 - t1, out


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def phase_device():
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        return None
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log("[1/7] device")
    log(smi.stdout.strip())
    log(f"  jax: platform={devs[0].platform} kind={devs[0].device_kind} "
        f"count={len(devs)}")
    return devs


def phase_setup(n_freq=N_FREQ):
    import jax
    from bayes_drt_tpu.ops.matrices import (construct_A, construct_L,
                                            default_epsilon, get_tau_basis)
    from bayes_drt_tpu.parallel.batch import setup_device

    freq = np.logspace(6, -2, n_freq)
    tau = get_tau_basis(freq)
    eps = default_epsilon(tau)
    f_coll = 1.0 / (2 * np.pi * tau)
    log(f"[2/7] setup: N={len(freq)}, K={len(tau)}; fits build their "
        f"matrices on {setup_device()}")

    def build():
        mats = [construct_A(freq, part, tau=tau, epsilon=eps)
                for part in ("real", "imag")]
        mats += [construct_L(f_coll, tau=tau, epsilon=eps, order=o)
                 for o in (0, 1, 2)]
        return [m.block_until_ready() for m in mats]

    out = {}
    for dev in dict.fromkeys([setup_device(), jax.devices()[0]]):
        with jax.default_device(dev):
            _, _, mats = timed(f"construct_A x2 + construct_L x3 on {dev}",
                               build)
        check(all(np.isfinite(np.asarray(m)).all() for m in mats),
              f"non-finite matrix built on {dev}")
        check(mats[0].shape == (len(freq), len(tau)), "A has the wrong shape")
        out[dev.platform] = [np.asarray(m) for m in mats]
    if len(out) == 2:
        diff = max(float(np.max(np.abs(a - b)) / np.max(np.abs(a)))
                   for a, b in zip(*out.values()))
        log(f"  card vs host: max relative difference {diff:.2e}")
        check(diff < 1e-4, "matrices built on the card differ from the host")


def phase_single(n_freq=N_FREQ):
    import bench
    from bayes_drt_tpu import Inverter, sim

    gt_tau, gt_g, rp = bench.ground_truth()
    freq, zb = sim.make_benchmark_batch(1, freq=np.logspace(6, -2, n_freq))
    z = zb[0]
    log("[3/7] single spectrum")
    for name in ("fit", "ridge_fit"):
        inv = Inverter()

        def run():
            getattr(inv, name)(freq, z)
            return (inv.predict_distribution("DRT", eval_tau=gt_tau),
                    inv.predict_Z(freq))

        _, _, (g, z_hat) = timed(f"Inverter.{name}", run)
        rmse = float(np.sqrt(np.mean((g - gt_g) ** 2)))
        resid = float(np.median(np.abs(z_hat - z) / np.abs(z)))
        log(f"  {name}: gamma RMSE {rmse:.4f} ({rmse / rp:.2%} of Rp), "
            f"median relative Z residual {resid:.2e}")
        check(rmse < GATE_SINGLE_RMSE * rp, f"{name}: gamma RMSE too large")
        check(resid < GATE_SINGLE_RESID, f"{name}: Z residual too large")


def _report_gates(label, res, gt, b):
    import bench
    gt_tau, gt_g, rp = gt
    g, ok = bench.quality_gates(res, gt_tau, gt_g, rp)
    d = res.diagnostics
    esc = int(np.sum(d.get("escalated", np.zeros(b, bool))))
    log(f"  {label} gates: gamma_rmse={g['rmse']:.4f} (< "
        f"{bench.GATE_RMSE * rp:.4f}) per_spec_p90={g['p90']:.4f} (< "
        f"{bench.GATE_P90 * rp:.4f}) ci_coverage={g['coverage']:.3f} (> "
        f"{bench.GATE_COVERAGE}) min_ess_med={g['min_ess_med']:.2f} (> "
        f"{bench.GATE_MIN_ESS}) logp_rhat_med={g['logp_rhat_med']:.2f} (< "
        f"{bench.GATE_LOGP_RHAT}) -> {'OK' if ok else 'FAIL'}")
    probe = ""
    if "high_grad_err" in d:
        probe = (", precision='high' gradient discrepancy median "
                 f"{float(np.median(d['high_grad_err'])):.2e}")
    log(f"  {label}: divergence rate {float(np.mean(d['divergence_rate'])):.4f}"
        f", escalated {esc}/{b}{probe}")
    check(res.coef.shape[0] == b and np.isfinite(res.coef).all(),
          f"{label}: non-finite or mis-shaped coefficients")
    check(ok, f"{label}: quality gate failed")
    return g


def _peak_bytes():
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def phase_hmc(b=B_HMC, n_freq=N_FREQ, **fit_kw):
    import bench
    from bayes_drt_tpu import sim
    from bayes_drt_tpu.parallel import fit_spectra_batch

    gt = bench.ground_truth()
    freq, zb = sim.make_benchmark_batch(b, freq=np.logspace(6, -2, n_freq))
    log(f"[4/7] batched HMC: B={b}, quality='fast'")
    kw = dict(mode="sample", quality="fast", gamma_eval_tau=gt[0])
    kw.update(fit_kw)
    _, steady, res = timed(
        "fit_spectra_batch", lambda: fit_spectra_batch(freq, zb, **kw))
    log(f"  steady throughput {b / (steady / 60.0):.1f} spectra/min; "
        f"device peak bytes in use {_peak_bytes()}")
    return _report_gates("fast", res, gt, b)


def phase_nuts(b=B_NUTS, n_freq=N_FREQ):
    import bench
    from bayes_drt_tpu import sim
    from bayes_drt_tpu.parallel import fit_spectra_batch

    gt = bench.ground_truth()
    freq, zb = sim.make_benchmark_batch(b, freq=np.logspace(6, -2, n_freq),
                                        seed=1)
    log(f"[5/7] NUTS: B={b}, quality='strict'")
    _, _, res = timed("fit_spectra_batch", lambda: fit_spectra_batch(
        freq, zb, mode="sample", quality="strict", gamma_eval_tau=gt[0]))
    return _report_gates("strict", res, gt, b)


def phase_ridge(b=B_RIDGE, n_freq=N_FREQ):
    import bench
    from bayes_drt_tpu import sim
    from bayes_drt_tpu.parallel import evaluate_gamma, ridge_fit_spectra_batch

    gt_tau, gt_g, rp = bench.ground_truth()
    freq, zb = sim.make_benchmark_batch(b, freq=np.logspace(6, -2, n_freq),
                                        seed=2)
    log(f"[6/7] batched ridge: B={b}")
    _, _, res = timed("ridge_fit_spectra_batch",
                      lambda: ridge_fit_spectra_batch(freq, zb))
    g = evaluate_gamma(res, gt_tau)
    rmse = np.sqrt(np.mean((g - gt_g[None, :]) ** 2, axis=1))
    log(f"  ridge: gamma RMSE mean {rmse.mean():.4f}, p90 "
        f"{np.percentile(rmse, 90):.4f} (Rp {rp:.4f})")
    check(np.isfinite(g).all(), "ridge: non-finite distributions")
    check(rmse.mean() < GATE_RIDGE_RMSE * rp, "ridge: gamma RMSE too large")


def phase_cli(n=N_CLI, n_freq=N_FREQ, out_dir=OUT_DIR):
    from bayes_drt_tpu import cli, native, sim

    in_dir = os.path.join(out_dir, "cli_in")
    res_dir = os.path.join(out_dir, "cli_out")
    os.makedirs(in_dir, exist_ok=True)
    freq, zb = sim.make_benchmark_batch(n, freq=np.logspace(6, -2, n_freq),
                                        seed=3)
    for i, z in enumerate(zb):
        np.savetxt(os.path.join(in_dir, f"zarc_{i}.csv"),
                   np.column_stack([freq, z.real, z.imag]), delimiter=",",
                   header="Freq,Zreal,Zimag", comments="")
    log(f"[7/7] cli: fit {n} CSV spectra, mode optimize; native loader "
        f"built: {native.available()}")
    argv = ["fit", in_dir, "--pattern", "*.csv", "--mode", "optimize",
            "--out", res_dir]
    _, _, rc = timed("cli fit", lambda: cli.main(argv))
    check(rc == 0, f"cli fit returned {rc}")
    gouts = [f for f in os.listdir(res_dir) if f.startswith("Gout_")]
    check(os.path.exists(os.path.join(res_dir, "summary.csv")),
          "cli fit wrote no summary.csv")
    check(len(gouts) == n, f"cli fit wrote {len(gouts)} Gout files, not {n}")


def phase_mesh(n_devices=4, b=B_MESH, n_freq=N_FREQ):
    """The sharded ``fast`` fit over ``n_devices`` compared with one device.

    The two runs use the same seeds, so every spectrum gets the same random
    streams, but the per-device programs have different batch shapes
    (b/n_devices rows against b), and XLA may pick different algorithms for
    each; chaotic HMC trajectories then amplify last-bit differences, so
    the draws are not bitwise equal. The comparison is statistical: both
    fits pass the five gates, and per spectrum and tau point the two
    posterior means agree within the half-width of the 95% credible band
    at >= 95% of the points (Monte-Carlo error of a mean at this budget is
    a fraction of the band). The escalation refit is off in both runs: it
    runs unsharded and would only repeat the same one-device program."""
    import jax
    import bench
    from bayes_drt_tpu import sim
    from bayes_drt_tpu.parallel import (evaluate_gamma, fit_spectra_batch,
                                        make_mesh)

    check(len(jax.devices()) >= n_devices,
          f"need {n_devices} devices, JAX sees {len(jax.devices())}")
    gt = bench.ground_truth()
    freq, zb = sim.make_benchmark_batch(b, freq=np.logspace(6, -2, n_freq))
    mesh = make_mesh(n_devices)
    log(f"[mesh] B={b}, quality='fast', mesh {dict(mesh.shape)}")
    kw = dict(mode="sample", quality="fast", gamma_eval_tau=gt[0],
              escalate=False)
    _, _, res_m = timed("sharded fit",
                        lambda: fit_spectra_batch(freq, zb, mesh=mesh, **kw))
    layout = res_m.diagnostics["shard_layout"]
    log(f"  shard layout (device, first row, end row): {layout}")
    check(len({d for d, _, _ in layout}) == n_devices,
          "the batch did not spread over every device")
    _, _, res_1 = timed("one-device fit",
                        lambda: fit_spectra_batch(freq, zb, **kw))
    _report_gates("sharded", res_m, gt, b)
    _report_gates("one-device", res_1, gt, b)
    g_m = evaluate_gamma(res_m, gt[0])
    g_1 = evaluate_gamma(res_1, gt[0])
    half = 0.5 * (res_1.diagnostics["gamma_eval_hi"]
                  - res_1.diagnostics["gamma_eval_lo"])
    within = float(np.mean(np.abs(g_m - g_1) <= half))
    exact = bool(np.array_equal(res_m.coef, res_1.coef))
    log(f"  sharded vs one device: bitwise equal {exact}; posterior means "
        f"within the 95% band half-width at {within:.4f} of points (>= 0.95)"
        f"; max |coef difference| {float(np.max(np.abs(res_m.coef - res_1.coef))):.3e}")
    check(within >= 0.95, "sharded and one-device fits disagree")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4 = run only the sharded fit over four GPUs")
    args = ap.parse_args(argv)

    devs = phase_device()
    if devs is None:
        print("chip_smoke: JAX found no GPU; this script measures only on "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    from bayes_drt_tpu.progcache import enable_compile_cache
    log(f"  compile cache: {enable_compile_cache()}")

    if args.devices == 4:
        phase_mesh(4)
    else:
        phase_setup()
        phase_single()
        phase_hmc()
        phase_nuts()
        phase_ridge()
        phase_cli()
    import jax
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
