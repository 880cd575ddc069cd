"""Production batch-fitting CLI: directory of spectra in, results out.

One-command equivalent of the reference's paper workflow
(code_EchemActa/"Run fits.ipynb": loop over instrument files, fit each,
save `Gout_*.csv` distributions) — but bucketed by frequency grid through
the native loader and fit in batched XLA programs, so a directory of
hundreds of spectra costs about the same as one.

    python -m bayes_drt_tpu fit data/*.DTA --out results/
    python -m bayes_drt_tpu fit data_dir --pattern '*.csv' --mode optimize

Outputs, per input file `<stem>`:
  <out>/Gout_<stem>.csv   — tau, gamma [, gamma_lo, gamma_hi]  (the
                            reference's bayes_results/map_results format)
and one `<out>/summary.csv` with per-spectrum offsets (R_inf, inductance),
Rp, reconstruction quality (median relative Z residual), and sampling
diagnostics (min-ESS, logp split-Rhat, divergence rate). Unparseable files
are skipped (status column records the error). `--peaks` additionally fits
HN peaks to each recovered distribution (`Peaks_<stem>.csv`, the
reference's peak-fit workflow, peak_fit.py:76-128).
"""

from __future__ import annotations

import argparse
import csv
import glob
import os
import sys
import time

import numpy as np


def _expand_paths(paths, pattern):
    files = []
    for p in paths:
        if os.path.isdir(p):
            files.extend(sorted(glob.glob(os.path.join(p, pattern))))
        else:
            files.extend(sorted(glob.glob(p)) or [p])
    seen, out = set(), []
    for f in files:
        if f not in seen:
            seen.add(f)
            out.append(f)
    return out


def _write_csv(path, rows):
    """Write a list of dicts as CSV; columns are the union of the keys in
    first-seen order, and a key missing from a row is written empty."""
    fields = list(dict.fromkeys(k for row in rows for k in row))
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        w.writerows(rows)


def _write_columns(path, cols):
    """Write equal-length 1-D arrays as the columns of a CSV."""
    arrs = [np.asarray(v, float) for v in cols.values()]
    _write_csv(path, [dict(zip(cols, map(float, vals)))
                      for vals in zip(*arrs)])


def _eval_tau(tau_basis, n_points):
    lo, hi = np.log10(tau_basis.min()), np.log10(tau_basis.max())
    return np.logspace(lo, hi, n_points)


def _fit_parser(sub):
    p = sub.add_parser(
        "fit", help="batch-fit spectra from instrument/CSV files",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("paths", nargs="+",
                   help="spectrum files, globs, or directories")
    p.add_argument("--pattern", default="*.DTA",
                   help="glob used inside directory arguments")
    p.add_argument("--out", default="drt_results", help="output directory")
    p.add_argument("--mode", choices=("sample", "optimize", "ridge"),
                   default="sample",
                   help="sample = full HMC posterior (credible bands); "
                        "optimize = MAP; ridge = hyper-lambda ridge")
    p.add_argument("--sampler", choices=("shmc", "nuts", "chees"),
                   default="shmc")
    p.add_argument("--chains", type=int, default=4)
    p.add_argument("--warmup", type=int, default=250)
    p.add_argument("--samples", type=int, default=250)
    p.add_argument("--max-iter", type=int, default=1500,
                   help="L-BFGS iteration cap (optimize mode)")
    p.add_argument("--nonneg", action="store_true",
                   help="constrain the distribution non-negative")
    p.add_argument("--outliers", action="store_true",
                   help="sample/optimize: include the per-point outlier "
                        "error contribution; ridge: use the outlier-robust "
                        "hyper-weights iteration")
    p.add_argument("--centered", action="store_true",
                   help="sample the centered (strict Stan-coordinate) "
                        "parameterization instead of the non-centered "
                        "production default")
    p.add_argument("--quality", choices=("fast", "strict"), default=None,
                   help="named sampler preset (sample mode): 'fast' = the "
                        "production config, 'strict' = the "
                        "calibrated-interval config (PERF.md)")
    p.add_argument("--no-escalate", action="store_true",
                   help="disable the mixing-gate escalation refit of "
                        "under-mixed spectra (sample mode)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval-points", type=int, default=200,
                   help="points in the output tau grid")
    p.add_argument("--mesh", action="store_true",
                   help="shard each batch over all visible devices")
    p.add_argument("--peaks", action="store_true",
                   help="also fit HN peaks to each recovered distribution "
                        "(writes Peaks_<stem>.csv and a n_peaks column)")
    p.add_argument("--ridge-cv", action="store_true",
                   help="ridge mode: select each spectrum's lambda_0 by "
                        "Re-Im cross-validation over --cv-grid (one XLA "
                        "program for the whole grid x batch sweep)")
    p.add_argument("--cv-grid", default="1e-7,1e2,19",
                   help="lambda grid for --ridge-cv as lo,hi,n (logspace)")
    p.set_defaults(func=cmd_fit)
    return p


def cmd_fit(args):
    # persistent XLA compile cache: a serving sweep must not pay the cold
    # compile on every invocation (JAX_COMPILATION_CACHE_DIR overrides the
    # location)
    from .progcache import enable_compile_cache
    enable_compile_cache()
    from .native import load_spectra
    from .parallel import (evaluate_gamma, fit_spectra_batch, make_mesh,
                           ridge_fit_spectra_batch)

    cv_lams = None
    if args.ridge_cv:
        try:
            lo, hi, n_cv = args.cv_grid.split(",")
            lo, hi, n_cv = float(lo), float(hi), int(n_cv)
            if not (0 < lo < hi and n_cv >= 2):
                raise ValueError
        except ValueError:
            print("invalid --cv-grid: expected lo,hi,n with 0 < lo < hi "
                  "and n >= 2 (e.g. 1e-7,1e2,19)", file=sys.stderr)
            return 2
        cv_lams = np.logspace(np.log10(lo), np.log10(hi), n_cv)
        if args.outliers and args.mode == "ridge":
            print("--ridge-cv and --outliers cannot be combined in ridge "
                  "mode", file=sys.stderr)
            return 2

    files = _expand_paths(args.paths, args.pattern)
    if not files:
        print("no input files matched", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    failed = []
    buckets = load_spectra(files, skip_errors=True, failed=failed)
    for path, err in failed:
        print(f"SKIP {path}: {err}", file=sys.stderr)
    n_loaded = sum(len(b["paths"]) for b in buckets)
    print(f"{n_loaded}/{len(files)} spectra in {len(buckets)} frequency-grid "
          f"bucket(s)", file=sys.stderr)
    if not buckets:
        print("no spectra loaded", file=sys.stderr)
        return 2
    mesh = make_mesh() if args.mesh else None

    rows = [{"file": os.path.basename(p), "status": f"load_error: {err}"}
            for p, err in failed]
    for bi, bucket in enumerate(buckets):
        freq, Zb, paths = bucket["freq"], bucket["Z"], bucket["paths"]
        tau_eval = _eval_tau(_basis_tau(freq), args.eval_points)
        t0 = time.time()
        if args.mode == "ridge":
            if args.outliers:
                # Effat-Ciucci outlier-robust ridge (hyper-weights)
                res = ridge_fit_spectra_batch(freq, Zb, mesh=mesh,
                                              hyper_lambda=False,
                                              hyper_weights=True)
            else:
                res = ridge_fit_spectra_batch(freq, Zb, mesh=mesh,
                                              cv_lambdas=cv_lams)
        elif args.mode == "optimize":
            res = fit_spectra_batch(
                freq, Zb, mode="optimize", max_iter=args.max_iter,
                init_from_ridge=True, outliers=args.outliers,
                nonneg=args.nonneg, random_seed=args.seed, mesh=mesh)
        else:
            from .infer.chees import SHMCConfig
            kw = dict(sampler=args.sampler, chains=args.chains,
                      warmup=args.warmup, samples=args.samples,
                      ncp=not args.centered,
                      shmc_cfg=SHMCConfig(n_steps=32, warm_steps=32,
                                          leaf_unroll=2, draw_unroll=2,
                                          recompute_grad=True,
                                          eps_quantile=0.5))
            if args.quality:
                kw = dict(quality=args.quality)
            res = fit_spectra_batch(
                freq, Zb, mode="sample",
                outliers=args.outliers, nonneg=args.nonneg,
                random_seed=args.seed,
                escalate=False if args.no_escalate else None,
                gamma_eval_tau=tau_eval, mesh=mesh, **kw)
        elapsed = time.time() - t0

        gammas = evaluate_gamma(res, tau_eval)
        if args.mode == "sample":
            lo = res.diagnostics["gamma_eval_lo"]
            hi = res.diagnostics["gamma_eval_hi"]
        ln_tau = np.log(tau_eval)
        resid = _median_rel_residuals(freq, Zb, res)

        for i, path in enumerate(paths):
            stem = os.path.splitext(os.path.basename(path))[0]
            cols = {"tau": tau_eval, "gamma": gammas[i]}
            if args.mode == "sample":
                cols["gamma_lo"] = lo[i]
                cols["gamma_hi"] = hi[i]
            _write_columns(os.path.join(args.out, f"Gout_{stem}.csv"), cols)
            rp = float(np.trapezoid(gammas[i], ln_tau))
            row = {
                "file": os.path.basename(path),
                "status": "ok",
                "mode": args.mode,
                "R_inf": float(res.r_inf[i]),
                "inductance": float(res.inductance[i]),
                "Rp": rp,
                "median_rel_resid": float(resid[i]),
                "fit_seconds_bucket": round(elapsed, 3),
                "bucket": bi,
            }
            if args.mode == "ridge" and args.ridge_cv:
                row["cv_lambda"] = float(res.diagnostics["cv_lambda"][i])
            if args.mode == "sample":
                d = res.diagnostics
                row["min_ess"] = float(d["min_ess"][i])
                row["logp_split_rhat"] = float(d["logp_rhat"][i])
                row["rank_rhat_max"] = float(d["rank_rhat_max"][i])
                row["ess_bulk_min"] = float(d["ess_bulk_min"][i])
                row["divergence_rate"] = float(d["divergence_rate"][i])
            if args.peaks:
                from .peaks import evaluate_fit_distribution, fit_peaks
                px = np.asarray(fit_peaks(tau_eval, gammas[i], rp))
                _write_columns(os.path.join(args.out, f"Peaks_{stem}.csv"), {
                    "R": px[0::4], "tau0": np.exp(px[1::4]),
                    "alpha": px[2::4], "beta": px[3::4]})
                row["n_peaks"] = len(px) // 4
                g_fit = np.asarray(evaluate_fit_distribution(px, tau_eval))
                gmax = max(float(np.abs(gammas[i]).max()), 1e-30)
                row["peak_fit_rmse_rel"] = float(
                    np.sqrt(np.mean((g_fit - gammas[i]) ** 2)) / gmax)
            rows.append(row)
        print(f"bucket {bi}: {len(paths)} spectra x {len(freq)} freqs "
              f"fit in {elapsed:.2f}s ({args.mode})", file=sys.stderr)

    _write_csv(os.path.join(args.out, "summary.csv"), rows)
    print(f"wrote {len(rows)} Gout_*.csv + summary.csv to {args.out}",
          file=sys.stderr)
    return 0


def _basis_tau(frequencies):
    from .ops.matrices import get_tau_basis
    return get_tau_basis(np.sort(np.asarray(frequencies, float))[::-1])


def _median_rel_residuals(frequencies, Z_batch, res):
    """Per-spectrum median |Z_hat - Z| / |Z| of the fitted batch — the
    reconstruction-quality column of summary.csv. Reconstruction uses the
    point-estimate coefficients (posterior mean in sample mode)."""
    from .ops.matrices import construct_A
    order = np.argsort(np.asarray(frequencies, float))[::-1]
    freq = np.asarray(frequencies, float)[order]
    z = np.asarray(Z_batch)[:, order]
    A_re = np.asarray(construct_A(freq, "real", tau=res.tau,
                                  basis=res.basis, epsilon=res.epsilon))
    A_im = np.asarray(construct_A(freq, "imag", tau=res.tau,
                                  basis=res.basis, epsilon=res.epsilon))
    z_hat = (res.r_inf[:, None] + res.coef @ A_re.T
             + 1j * (2 * np.pi * freq[None, :] * res.inductance[:, None]
                     + res.coef @ A_im.T))
    return np.median(np.abs(z_hat - z) / np.maximum(np.abs(z), 1e-300),
                     axis=1)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m bayes_drt_tpu",
        description="Batched Bayesian DRT/DDT inversion in JAX")
    sub = parser.add_subparsers(dest="command", required=True)
    _fit_parser(sub)
    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    raise SystemExit(main())
