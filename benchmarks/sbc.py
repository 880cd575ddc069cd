"""Simulation-based calibration of the production sampler stack.

Certifies (or falsifies) the whole shmc + ncp + median-eps-pooling +
matmul-precision
tower against the exact Series posterior (see bayes_drt_tpu/sbc.py for the
exact generative factorization of the Stan-style soft prior; reference
anchor: bayes_drt/stan_model_files/Series_modelcode.txt:24-69).

Stages (prior draws and fits run as single
batched XLA programs):
1. NUTS draws of the (ups_raw, ds) prior marginal — one vmapped chain per
   simulated dataset, cross-chain rank-Rhat reported as the prior
   certificate.
2. Exact prior-predictive datasets (x | ups, ds is Gaussian via Cholesky).
3. ONE production fit_spectra_batch over all datasets (z_scale=1 so the
   fitted model IS the generative model), thinned monitor draws.
4. Rank statistics for Rinf, induc, sigma_res, alpha_prop, alpha_re,
   alpha_im and gamma at several tau; chi-squared uniformity p-values and
   DKW ECDF-envelope violations per monitor.

Usage:
  python benchmarks/sbc.py                     # production config
  python benchmarks/sbc.py --precision high    # reduced-precision matmuls
  python benchmarks/sbc.py --sampler nuts      # Stan-parity anchor
  python benchmarks/sbc.py --n-sets 256 --thin 25
  python benchmarks/sbc.py --outliers          # Series_outliers variant
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

MON_NAMES = ["Rinf", "induc", "sigma_res", "alpha_prop", "alpha_re",
             "alpha_im", "gamma(1e-4)", "gamma(1e-2)", "gamma(1)",
             "gamma(1e2)"]
GE_TAU = np.array([1e-4, 1e-2, 1.0, 1e2])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-sets", type=int, default=512)
    ap.add_argument("--chains", type=int, default=4)
    ap.add_argument("--warmup", type=int, default=150)
    ap.add_argument("--samples", type=int, default=250)
    ap.add_argument("--thin", type=int, default=0,
                    help="monitor thinning stride; 0 (default) = choose "
                         "from the MEASURED monitor autocorrelation: store "
                         "unthinned monitor draws, estimate per-monitor "
                         "ESS, and thin to one draw per integrated "
                         "autocorrelation time (earlier production-arm "
                         "failures were thin-10 autocorrelation, not bias)")
    ap.add_argument("--n-steps", type=int, default=32)
    ap.add_argument("--precision", default="high")
    ap.add_argument("--sampler", default="shmc", choices=("shmc", "nuts"))
    ap.add_argument("--prior-warmup", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bins", type=int, default=16)
    ap.add_argument("--outliers", action="store_true",
                    help="SBC of the Series_outliers variant: sigma_out "
                         "drawn from its exact prior, monitored at 3 "
                         "frequencies; the (ups, ds) prior stage is shared "
                         "with (and cached from) the plain-Series arms, so "
                         "the comparison is paired on the x-hierarchy")
    args = ap.parse_args()

    import jax
    from bayes_drt_tpu.progcache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp

    from bayes_drt_tpu import sbc
    from bayes_drt_tpu.infer.chees import SHMCConfig
    from bayes_drt_tpu.ops.basis import get_basis_func
    from bayes_drt_tpu.parallel import fit_spectra_batch
    from bayes_drt_tpu.parallel.batch import _build_shared

    freq = np.logspace(6, -2, 81)          # the flagship bench grid (K=101)
    frequencies, tau, eps, cfg, data, dn = _build_shared(
        freq, mode="sample", outliers=args.outliers)
    print(f"model: {cfg.model_name()} K={data.L[0].shape[-1]} N={len(freq)}",
          file=sys.stderr, flush=True)

    # the prior marginal depends only on (seed, n_sets, prior_warmup) — cache
    # it on disk so sampler/precision arms reuse identical datasets (it is
    # the slowest stage, and it makes the arms paired comparisons)
    import glob
    cache_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "results")
    os.makedirs(cache_dir, exist_ok=True)
    cache = (f"{cache_dir}/sbc_prior_s{args.seed}_n{args.n_sets}"
             f"_w{args.prior_warmup}.npz")
    if not os.path.exists(cache):
        # a larger cached run with the same seed/warmup contains this one
        # as its prefix (chunked sampling is deterministic per chain)
        for cand in sorted(glob.glob(
                f"{cache_dir}/sbc_prior_s{args.seed}_n*"
                f"_w{args.prior_warmup}.npz")):
            n_cand = int(cand.split("_n")[1].split("_")[0])
            if n_cand >= args.n_sets:
                cache = cand
                break
    t0 = time.time()
    if os.path.exists(cache):
        with np.load(cache) as f:
            ups_raw = f["ups_raw"][:args.n_sets]
            ds = f["ds"][:args.n_sets]
            pdiag = {k: float(f[k]) for k in f.files
                     if k not in ("ups_raw", "ds")}
        print(f"prior marginal: loaded {cache}", file=sys.stderr, flush=True)
    else:
        ups_raw, ds, pdiag = sbc.sample_prior_marginal(
            cfg, data, args.n_sets, seed=args.seed, warmup=args.prior_warmup)
        np.savez(cache, ups_raw=ups_raw, ds=ds, **pdiag)
    print(f"prior marginal: {args.n_sets} draws in {time.time()-t0:.1f}s "
          f"{pdiag}", file=sys.stderr, flush=True)

    phi = np.asarray(get_basis_func("gaussian")(
        np.log(GE_TAU[:, None] / tau[None, :]), eps))
    z, truths = sbc.generate_datasets(cfg, data, ups_raw, ds,
                                      jnp.asarray(phi, data.target.dtype),
                                      seed=args.seed + 1)
    print(f"datasets: Rinf range [{truths[:,0].min():.1f}, "
          f"{truths[:,0].max():.1f}]", file=sys.stderr, flush=True)

    kw = dict(mode="sample", chains=args.chains, warmup=args.warmup,
              samples=args.samples, random_seed=args.seed + 2, ncp=True,
              gamma_eval_tau=GE_TAU, z_scale=1.0,
              monitor_thin=args.thin if args.thin > 0 else 1,
              outliers=args.outliers,
              # certify the RAW sampler config: the mixing-gate escalation
              # refit (default-on for shmc) would mix NUTS draws into some
              # datasets and unpair the sampler/precision arms
              escalate=False)
    if args.sampler == "shmc":
        kw.update(sampler="shmc",
                  shmc_cfg=SHMCConfig(n_steps=args.n_steps,
                                      warm_steps=args.n_steps,
                                      leaf_unroll=2, draw_unroll=2,
                                      recompute_grad=True, eps_quantile=0.5,
                                      precision=args.precision))
    else:
        kw.update(sampler="nuts", max_tree_depth=6, tree_scan=True,
                  scan_unroll=2)

    t0 = time.time()
    res = fit_spectra_batch(frequencies, z, **kw)
    el = time.time() - t0
    d = res.diagnostics
    md = d["monitor_draws"]                       # (n_sets, L, n_mon)
    if args.thin == 0:
        # measured-autocorrelation thinning: estimate each
        # monitor's ESS from the UNTHINNED draws and keep one draw per
        # integrated autocorrelation time of the SLOWEST monitor, so the
        # rank statistics are computed from (approximately) independent
        # draws — SBC's exchangeability requirement. The round-4
        # production-arm chi2 failures (sigma_res p=7e-4) were exactly
        # thin-10 autocorrelation at ESS-per-1000-draws ~ 25.
        ess = sbc.monitor_ess(md, args.chains)
        ess_med = np.median(ess, axis=0)
        total = md.shape[1]
        thin_auto = int(np.ceil(total / max(float(ess_med.min()), 4.0)))
        s_per = total // args.chains
        thin_auto = min(thin_auto, s_per)          # >= 1 draw per chain
        mdc = md.reshape(md.shape[0], args.chains, s_per, md.shape[2])
        md = mdc[:, :, thin_auto - 1::thin_auto, :].reshape(
            md.shape[0], -1, md.shape[2])
        print(f"auto-thin: per-monitor ESS(med) = "
              f"{np.array2string(ess_med, precision=1)} -> stride "
              f"{thin_auto}, L={md.shape[1]}", file=sys.stderr, flush=True)
    n_levels = md.shape[1]
    print(f"fits: {args.n_sets} x {args.chains}x({args.warmup}+"
          f"{args.samples}) in {el:.1f}s  div={d['divergence_rate'].mean():.3f} "
          f"lpR(med)={np.median(d['logp_rhat']):.2f} "
          f"rankRhat(med)={np.median(d['rank_rhat_max']):.2f}",
          file=sys.stderr, flush=True)

    mon_names = list(MON_NAMES)
    if args.outliers:
        from bayes_drt_tpu.models.posterior import outlier_monitor_indices
        mon_names += [f"sigma_out(f[{i}])"
                      for i in outlier_monitor_indices(len(freq))]
    assert md.shape[-1] == len(mon_names) == truths.shape[-1]

    ranks = sbc.sbc_ranks(truths, md)
    pvals, stats = sbc.rank_uniformity(ranks, n_levels, n_bins=args.bins)
    viol = sbc.ecdf_envelope_violations(ranks, n_levels)

    print(f"\nSBC over {args.n_sets} datasets, L={n_levels} thinned draws, "
          f"{args.bins}-bin chi2 (sampler={args.sampler}, "
          f"precision={args.precision}, n_steps={args.n_steps}, "
          f"w{args.warmup}+s{args.samples}, "
          f"model={'Series_outliers' if args.outliers else 'Series'}):")
    for j, nm in enumerate(mon_names):
        flag = "OK " if pvals[j] > 0.005 and not viol[j] else "FAIL"
        print(f"  {flag} {nm:<16} chi2={stats[j]:7.1f} p={pvals[j]:.4f} "
              f"ecdf_viol={bool(viol[j])}")
    n_ok = int(np.sum((pvals > 0.005) & ~viol))
    print(f"summary: {n_ok}/{len(mon_names)} monitors calibrated "
          f"(chi2 p>0.005 and ECDF inside DKW band)")


if __name__ == "__main__":
    main()
