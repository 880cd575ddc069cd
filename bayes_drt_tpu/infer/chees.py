"""ChEES-HMC: adaptive fixed-length jittered HMC, designed accelerator-first.

Replaces the same Stan sampling call NUTS does (reference: pystan
``model.sampling``, bayes_drt/inversion.py:1218-1221) but with the classic
accelerator trade: instead of NUTS' per-leaf masked tree bookkeeping, every
chain of a spectrum takes the SAME number of plain
leapfrog steps per draw, and the trajectory length is *learned* during
warmup by maximizing the Change in the Estimator of the Expected Square
(ChEES) criterion across chains (Hoffman, Radul & Sountsov, AISTATS 2021;
TFP's GradientBasedTrajectoryLengthAdaptation is the reference public
implementation of the same scheme).

Key structural properties that make this the batch-friendly form:

- the per-draw work is a single while_loop of UNMASKED leapfrog steps —
  no checkpoint stacks, no per-leaf selects, no subtree merges;
- chains of one spectrum share one diagonal metric (Welford windows
  pooled across chains — C draws of statistics per iteration instead of 1)
  and one jittered trajectory TIME, while the step size adapts PER CHAIN
  (measured on this posterior: NUTS' per-chain adapted step sizes differ by
  3x across chains of one spectrum; a pooled step size leaves the
  tightest-curvature chain permanently rejecting). Per-chain step counts
  n_c = ceil(h*T/eps_c) run inside one while_loop to max_c n_c with a
  per-chain freeze mask — a single (C,)-wide select per step, nothing like
  NUTS' per-leaf checkpoint-stack bookkeeping;
- trajectory jitter is a shared Halton sequence (quasi-random, as in the
  paper), which both guarantees ergodicity (fixed-length HMC can resonate)
  and gives every draw an unbiased spread of lengths.

The proposal is plain Metropolis-Hastings (accept with min(1, e^{H0-H})) —
with jittered lengths this is a valid HMC scheme targeting the same
posterior as the reference's Stan programs.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..progcache import precise_matmuls
from .nuts import (_da_init, _da_update, _regularized_variance,
                   _window_flags, find_reasonable_step_size)


class ChEESConfig(NamedTuple):
    """Configuration for the ChEES-HMC sampler (NUTSConfig analogue)."""
    max_steps: int = 128          # hard cap on leapfrogs per draw (the
                                  # while_loop's worst-case trip count)
    min_steps: int = 8            # FLOOR on leapfrogs per draw. Essential on
                                  # stiff posteriors: with 1-3 leaves the
                                  # per-leaf accept stat is bimodal (dH<0 ->
                                  # 1.0, or catastrophic -> 0) and dual
                                  # averaging drifts eps into the divergent
                                  # regime; >=8 leaves probe the trajectory
                                  # tail the way NUTS' trees do
    delta: float = 0.9            # dual-averaging target acceptance (the
                                  # reference's Stan control: adapt_delta
                                  # 0.9, inversion.py:1221)
    t0: float = 10.0
    gamma: float = 0.05
    kappa: float = 0.75
    max_energy_error: float = 1000.0
    init_buffer: int = 75         # Stan-style mass-adaptation windows,
    term_buffer: int = 50         # pooled across chains
    base_window: int = 25
    adapt_mass: bool = True
    adam_lr: float = 0.025        # Adam step size on log trajectory time
                                  # (the paper/TFP default)
    init_steps: int = 8           # initial trajectory = init_steps * eps


class _AdamState(NamedTuple):
    m: jax.Array
    v: jax.Array
    t: jax.Array


def _adam_init(dtype):
    z = jnp.zeros((), dtype)
    return _AdamState(m=z, v=z, t=z)


def _adam_update(st: _AdamState, grad, lr, b1=0.9, b2=0.999, eps=1e-8):
    t = st.t + 1.0
    m = b1 * st.m + (1.0 - b1) * grad
    v = b2 * st.v + (1.0 - b2) * grad * grad
    mhat = m / (1.0 - b1 ** t)
    vhat = v / (1.0 - b2 ** t)
    step = lr * mhat / (jnp.sqrt(vhat) + eps)
    return _AdamState(m=m, v=v, t=t), step


def _pool_eps(eps_chains, cfg):
    """Pool per-chain adapted step sizes into the one sampling-phase eps.

    Default (eps_quantile=0) is the conservative min — a chain that
    warmed up in a mild region would otherwise freeze a too-large eps and
    diverge all sampling. A quantile > 0 runs above the most timid chain:
    divergent legs are never multinomial-selected, so the cost is wasted
    trajectory, while every other chain mixes at a less-crippled eps.

    eps_quantile < 0 disables pooling entirely: every chain samples at its
    OWN adapted step size (Stan/NUTS semantics — reference pystan adapts
    per chain, inversion.py:1216). The trajectory is static-length, so
    per-chain eps costs nothing extra; use it for sharply-peaked
    posteriors (e.g. near-delta DRTs) where the pooled eps is too coarse
    for the tight chains."""
    q = getattr(cfg, "eps_quantile", 0.0)
    if q < 0.0:
        return eps_chains
    if q == 0.0:
        return eps_chains.min()
    return jnp.quantile(eps_chains, q)


def _halton2(total: int) -> np.ndarray:
    """Van der Corput base-2 sequence in (0, 1): the shared quasi-random
    trajectory jitter (same role as the paper's Halton schedule)."""
    out = np.zeros(total)
    for i in range(total):
        f, r, x = 0.5, 0.0, i + 1
        while x > 0:
            r += f * (x & 1)
            x >>= 1
            f *= 0.5
        out[i] = r
    return out


@partial(jax.jit, static_argnames=("logp_fn", "warmup", "samples", "cfg"))
@precise_matmuls
def sample_chees(logp_fn: Callable, q0, key, warmup: int = 500,
                 samples: int = 500, cfg: ChEESConfig = ChEESConfig(),
                 init_step_size: float = 1.0, metric=None,
                 init_traj_time=None):
    """Run ALL chains of one posterior jointly: q0 is (C, D).

    Returns (draws (C, samples, D), info dict). The chain axis is internal
    (adaptation pools across it); vmap this function over spectra only.

    ``metric``: optional fixed (D,) inverse-mass vector (diag only). With
    ``cfg.adapt_mass=False`` it stays fixed. ``init_traj_time``: optional
    trajectory-time warm start (e.g. a previous fit's adapted value).
    """
    value_and_grad = jax.vmap(jax.value_and_grad(logp_fn))
    n_chains, dim = q0.shape
    dtype = q0.dtype
    total = warmup + samples

    logp0, grad0 = value_and_grad(q0)
    if metric is not None:
        m_inv0 = jnp.asarray(metric, dtype)
    else:
        m_inv0 = jnp.ones((dim,), dtype)
    key, k_eps = jax.random.split(key)
    eps0 = jax.vmap(
        lambda q, lp, g, k: find_reasonable_step_size(
            lambda qq: jax.value_and_grad(logp_fn)(qq), q, lp, g, k, m_inv0,
            init_eps=init_step_size)
    )(q0, logp0, grad0, jax.random.split(k_eps, n_chains))

    # trajectory TIME (step size x steps); adapting time rather than step
    # count keeps the learned length meaningful across step-size changes
    if init_traj_time is None:
        traj0 = eps0.mean() * cfg.init_steps
    else:
        traj0 = jnp.asarray(init_traj_time, dtype)
    max_e = cfg.max_energy_error

    if cfg.adapt_mass:
        in_slow_np, win_end_np = _window_flags(warmup, cfg)
    else:
        in_slow_np = np.zeros(warmup, bool)
        win_end_np = np.zeros(warmup, bool)
    in_slow = jnp.asarray(np.concatenate([in_slow_np, np.zeros(samples, bool)]))
    win_end = jnp.asarray(np.concatenate([win_end_np, np.zeros(samples, bool)]))
    in_warm = jnp.asarray(np.arange(total) < warmup)
    halton = jnp.asarray(_halton2(total), dtype)

    da0 = jax.vmap(lambda e: _da_init(e, dtype))(eps0)   # per-chain DA
    # per-chain Welford accumulators, pooled WITHIN-chain variance at window
    # ends: pooling raw draws across chains would fold the (early-warmup,
    # enormous) between-chain scatter into the metric and wreck it; pooling
    # the per-chain deviations gives C times the statistics of Stan's
    # per-chain scheme with none of that bias
    if cfg.adapt_mass:
        wf0 = (jnp.zeros((n_chains, dim), dtype),
               jnp.zeros((n_chains, dim), dtype), jnp.zeros((), dtype))
    else:
        wf0 = (jnp.zeros((0,), dtype), jnp.zeros((0,), dtype),
               jnp.zeros((), dtype))
    adam0 = _adam_init(dtype)

    def step(carry, xs):
        q, logp, grad, da, wf, m_inv, adam, log_traj, key = carry
        is_warm, slow, wend, h = xs
        key, k_mom, k_j, k_sel = jax.random.split(key, 4)

        # per-chain step size DURING WARMUP (chains adapt to their local
        # terrain while they find the typical set); during SAMPLING all
        # chains target the same posterior, so they share the most
        # conservative adapted step size — a chain whose warmup happened to
        # sit in a mild region would otherwise freeze a too-large eps and
        # spend the sampling phase diverging in the funnel neck
        eps_samp = jnp.exp(da.log_eps_bar).min()
        eps = jnp.where(is_warm, jnp.exp(da.log_eps),
                        jnp.broadcast_to(eps_samp, (n_chains,)))
        # jittered trajectory: time = h * T_max, so lengths sweep (0, T_max]
        # quasi-uniformly; the TIME is shared, the step count is per-chain
        traj = jnp.exp(log_traj)
        n_steps = jnp.clip(jnp.ceil(h * traj / eps).astype(jnp.int32),
                           cfg.min_steps, cfg.max_steps)        # (C,)

        z = jax.random.normal(k_mom, (n_chains, dim), dtype)
        p0 = z / jnp.sqrt(m_inv)[None, :]
        kin0 = 0.5 * jnp.sum(p0 * p0 * m_inv[None, :], axis=1)
        H0 = -logp + kin0
        epsc = eps[:, None]

        # Betancourt's static multinomial HMC: split the n-step trajectory
        # uniformly around the current state (j backward, n - j forward; the
        # split FRACTION is shared across chains so both phases run compact
        # loops) and sample the next state from ALL visited states with
        # weights e^{H0 - H} via a streaming logsumexp — the same
        # within-trajectory robustness NUTS gets in funnels (a divergent
        # tail is simply never selected and integration freezes), with none
        # of the tree/U-turn bookkeeping.
        uj = jax.random.uniform(k_j, (), dtype)
        j_back = jnp.clip(jnp.floor(uj * (n_steps + 1)).astype(jnp.int32),
                          0, n_steps)
        n_fwd = n_steps - j_back

        def run_phase(acc, q_s, p_s, g_s, lp_s, n_lim, pbase):
            """Stream n_lim (per chain) leapfrogs into the multinomial
            accumulator; returns (acc, end_state)."""
            n_hi = n_lim.max()

            def leap(st):
                (i, qq, pp, gg, lp, logw, pq, plp, pgrad, pkin, sacc,
                 dead, anydiv) = st
                act1 = (i < n_lim) & (~dead)
                act = act1[:, None]
                p_half = pp + 0.5 * epsc * gg
                q_new = qq + epsc * p_half * m_inv[None, :]
                lp_new, g_new = value_and_grad(q_new)
                p_new = p_half + 0.5 * epsc * g_new
                kin = 0.5 * jnp.sum(p_new * p_new * m_inv[None, :], axis=1)
                Hn = -lp_new + kin
                w = H0 - Hn
                bad = jnp.isnan(Hn) | ((Hn - H0) > max_e)
                w = jnp.where(bad, -jnp.inf, w)
                logw_new = jnp.where(act1, jnp.logaddexp(logw, w), logw)
                u = jax.random.uniform(
                    jax.random.fold_in(k_sel, i * 2 + pbase),
                    (n_chains,), dtype)
                take = act1 & (~bad) & (jnp.log(u) < (w - logw_new))
                pq = jnp.where(take[:, None], q_new, pq)
                plp = jnp.where(take, lp_new, plp)
                pgrad = jnp.where(take[:, None], g_new, pgrad)
                pkin = jnp.where(take, kin, pkin)
                sacc = sacc + jnp.where(act1,
                                        jnp.minimum(1.0, jnp.exp(w)), 0.0)
                ok = act & (~bad)[:, None]
                return (i + 1,
                        jnp.where(ok, q_new, qq),
                        jnp.where(ok, p_new, pp),
                        jnp.where(ok, g_new, gg),
                        jnp.where(ok[:, 0], lp_new, lp),
                        logw_new, pq, plp, pgrad, pkin, sacc,
                        dead | (act1 & bad), anydiv | (act1 & bad))

            (logw, pq, plp, pgrad, pkin, sacc, anydiv) = acc
            st = (jnp.asarray(0, jnp.int32), q_s, p_s, g_s, lp_s,
                  logw, pq, plp, pgrad, pkin, sacc,
                  jnp.zeros(n_chains, bool), anydiv)
            st = jax.lax.while_loop(lambda t: t[0] < n_hi, leap, st)
            (_, q_e, p_e, g_e, lp_e, logw, pq, plp, pgrad, pkin, sacc,
             _, anydiv) = st
            return ((logw, pq, plp, pgrad, pkin, sacc, anydiv),
                    (q_e, p_e))

        acc0 = (jnp.zeros(n_chains, dtype), q, logp, grad, kin0,
                jnp.zeros(n_chains, dtype), jnp.zeros(n_chains, bool))
        acc1, (q_b, p_b) = run_phase(acc0, q, -p0, grad, logp, j_back, 0)
        acc2, (q_f, p_f) = run_phase(acc1, q, p0, grad, logp, n_fwd, 1)
        (logw, q_next, logp_next, grad_next, kin_next, sacc, diverging) = acc2

        accept_prob = sacc / jnp.maximum(n_steps, 1)
        H1 = -logp_next + kin_next

        # ---- ChEES gradient on log T_max (pooled across chains) ----
        # criterion: E[(||q' - m'||^2 - ||q - m||^2)^2] evaluated at the
        # selected proposals; the T-derivative flows through the dominant
        # trajectory endpoint (forward if the forward leg is longer), whose
        # reach time scales with T: d||q_e - m||^2/dlogT = 2 (q_e - m).v_e
        # * t_e.
        use_fwd = (n_fwd >= j_back)
        q_e = jnp.where(use_fwd[:, None], q_f, q_b)
        v_e = jnp.where(use_fwd[:, None], p_f, -p_b) * m_inv[None, :]
        t_e = jnp.maximum(n_fwd, j_back).astype(dtype) * eps
        m_cur = q.mean(axis=0)
        wsum = jnp.maximum(accept_prob.sum(), 1e-6)
        m_prop = jnp.sum(accept_prob[:, None] * q_next, axis=0) / wsum
        dsq = (jnp.sum((q_next - m_prop[None, :]) ** 2, axis=1)
               - jnp.sum((q - m_cur[None, :]) ** 2, axis=1))
        dd = 2.0 * dsq * jnp.sum((q_e - m_prop[None, :]) * v_e, axis=1) * t_e
        w_c = jnp.where(jnp.isfinite(dd), accept_prob, 0.0)
        dd = jnp.where(jnp.isfinite(dd), dd, 0.0)
        grad_c = jnp.sum(w_c * dd) / jnp.maximum(jnp.sum(w_c), 1e-6)
        # Adam's m/sqrt(v) normalization makes the update magnitude ~adam_lr
        # regardless of the criterion's scale — the reason the paper adapts
        # with Adam rather than plain SGD
        adam_new, step_t = _adam_update(adam, grad_c, cfg.adam_lr)
        log_traj_new = log_traj + step_t      # ascent on the ChEES criterion
        # cap: trajectory cannot exceed what max_steps can realize, nor
        # shrink below one step
        log_traj_new = jnp.clip(log_traj_new,
                                jnp.log(eps.mean()),
                                jnp.log(eps.mean() * cfg.max_steps))
        adam = jax.tree.map(lambda n, o: jnp.where(is_warm, n, o),
                            adam_new, adam)
        log_traj = jnp.where(is_warm, log_traj_new, log_traj)

        # ---- PER-CHAIN dual averaging (the _DAState fields are (C,)) ----
        da_new = _da_update(da, accept_prob, cfg)
        da = jax.tree.map(lambda n, o: jnp.where(is_warm, n, o), da_new, da)

        # ---- mass adaptation: per-chain Welford, pooled within-chain ----
        if cfg.adapt_mass:
            mean, m2, n = wf
            n1 = n + 1.0
            dlt = q_next - mean
            mean_new = mean + dlt / n1
            m2_new = m2 + dlt * (q_next - mean_new)
            wf = jax.tree.map(lambda a, b: jnp.where(slow, a, b),
                              (mean_new, m2_new, n1), wf)
            mean, m2, n = wf
            var_within = (m2 / jnp.maximum(n - 1.0, 1.0)).mean(axis=0)
            reg = _regularized_variance(var_within, n_chains * n)
            m_inv = jnp.where(wend & (n > 1), reg, m_inv)
            wf = jax.tree.map(lambda a: jnp.where(wend, jnp.zeros_like(a), a),
                              wf)
            da_reset = jax.vmap(lambda e: _da_init(e, dtype))(
                jnp.exp(da.log_eps))
            da = jax.tree.map(lambda r, o: jnp.where(wend, r, o), da_reset, da)

        out = (q_next, logp_next, accept_prob, diverging,
               jnp.broadcast_to(n_steps, (n_chains,)), H1, eps, traj)
        return (q_next, logp_next, grad_next, da, wf, m_inv, adam, log_traj,
                key), out

    def warm_step(carry, xs):
        carry, out = step(carry, xs)
        # keep the scalar adaptation trace (divergences, acceptance, step
        # size, step count, trajectory time) — the warmup telemetry that
        # makes adaptation failures diagnosable
        return carry, (out[3], out[2], out[4], out[6], out[7])

    def sample_step(carry, xs):
        carry, out = step(carry, xs)
        return carry, out

    carry0 = (q0, logp0, grad0, da0, wf0, m_inv0, adam0,
              jnp.log(traj0).astype(dtype), key)
    xs_w = (in_warm[:warmup], in_slow[:warmup], win_end[:warmup],
            halton[:warmup])
    xs_s = (in_warm[warmup:], in_slow[warmup:], win_end[warmup:],
            halton[warmup:])
    carry, warm_trace = jax.lax.scan(warm_step, carry0, xs_w)
    warm_div, warm_acc, warm_nstep, warm_eps, warm_traj = warm_trace
    carry, outs = jax.lax.scan(sample_step, carry, xs_s)
    q_s, logp_s, acc_s, div_s, nstep_s, en_s, _, _ = outs
    (qf, _, _, da, _, m_inv, _, log_traj, _) = carry

    # draws come out of scan time-major (samples, C, ...) -> (C, samples, ...)
    draws = jnp.swapaxes(q_s, 0, 1)
    info = {
        "logp": jnp.swapaxes(logp_s, 0, 1),
        "accept_prob": jnp.swapaxes(acc_s, 0, 1),
        "diverging": jnp.swapaxes(div_s, 0, 1),
        "n_leapfrog": jnp.swapaxes(nstep_s, 0, 1),
        "energy": jnp.swapaxes(en_s, 0, 1),
        "step_size": jnp.exp(da.log_eps_bar),
        "inv_mass": m_inv,
        "traj_time": jnp.exp(log_traj),
        "warmup_diverging": jnp.swapaxes(warm_div, 0, 1),
        "warmup_accept": jnp.swapaxes(warm_acc, 0, 1),
        "warmup_n_leapfrog": jnp.swapaxes(warm_nstep, 0, 1),
        "warmup_step_size": jnp.swapaxes(warm_eps, 0, 1),
        "warmup_traj_time": warm_traj,
    }
    return draws, info


class SHMCConfig(NamedTuple):
    """Synchronous jittered static multinomial HMC (sample_shmc).

    The fully batch-synchronous form: every draw of every chain of every
    spectrum runs EXACTLY ``n_steps`` leapfrogs as a static lax.scan — no
    while_loop, no per-element trip counts, so a vmapped batch never waits
    on a straggler and XLA pipelines the whole trajectory. ``n_steps`` is
    the md-equivalent quality knob (NUTS at max_depth 5 runs 31 leapfrogs
    on this posterior with the U-turn criterion never firing — a saturated
    tree IS fixed-length multinomial HMC, minus ~70% per-leaf bookkeeping).
    """
    n_steps: int = 32
    warm_steps: int = 0           # leapfrogs per WARMUP draw (0 = n_steps).
                                  # Warmup draws are discarded — adaptation
                                  # needs draw count, not reach — so shorter
                                  # warmup trajectories buy throughput at no
                                  # sampling-quality cost
    delta: float = 0.9            # adapt_delta (reference control)
    t0: float = 10.0
    gamma: float = 0.05
    kappa: float = 0.75
    max_energy_error: float = 1000.0
    init_buffer: int = 75
    term_buffer: int = 50
    base_window: int = 25
    adapt_mass: bool = True
    leaf_unroll: int = 1          # lax.scan unroll of the n_steps leapfrog
                                  # scan (XLA fuses across leaves)
    draw_unroll: int = 1          # lax.scan unroll of the draws scan
                                  # (amortizes the fixed per-draw loop
                                  # overhead)
    jitter_lo: float = 0.67       # per-draw step-size multiplier h is
                                  # halton-distributed in [jitter_lo, 1]:
                                  # trajectory TIME jitters ~1.5x while the
                                  # step count stays static (smaller h only
                                  # improves integration accuracy)
    rng_impl: str = "threefry"    # 'rbg' re-keys onto XLA's hardware
                                  # RngBitGenerator stream (identical
                                  # distributions, different stream): the
                                  # per-draw (C, D) momentum refresh is
                                  # threefry-COMPUTE bound at large D
    recompute_grad: bool = False  # don't carry the selected proposal's
                                  # (C, D) gradient through the leaf scan
                                  # (one masked select + carry per leaf);
                                  # recompute it ONCE per draw after
                                  # selection — trades 1/n_steps extra
                                  # gradient evals for n_steps fewer (C, D)
                                  # selects. Same posterior; draws differ
                                  # only by float re-association.
    eps_quantile: float = 0.0     # sampling-phase step size = this quantile
                                  # of the per-chain adapted step sizes
                                  # (0 = the pooled MIN, the conservative
                                  # default). A divergent leg is never
                                  # multinomial-selected, so running above
                                  # the most timid chain's eps trades some
                                  # wasted trajectory for faster mixing.
                                  # < 0 = NO pooling: each chain samples at
                                  # its own adapted eps (Stan semantics;
                                  # best for sharply-peaked posteriors).
    flat_chain: bool = False      # run the whole batch as ONE flat
                                  # (B*chains, D) chain axis with the
                                  # hand-written posterior gradient
                                  # (infer/shmc_flat.py). Batch API only;
                                  # single-series-DRT only.
    traj_store: bool = False      # store-then-select trajectory form: the
                                  # leaf scan emits (q, logp, kin, w) as
                                  # stacked scan outputs and ONE Gumbel-max
                                  # categorical per draw replaces the
                                  # streaming per-leaf multinomial update.
                                  # Identical target distribution (reservoir
                                  # sampling and Gumbel-max are both exact
                                  # categorical selection; different RNG
                                  # stream -> different but equally valid
                                  # draws). Cuts the per-leaf bookkeeping to
                                  # the flip selects only: no proposal
                                  # carries, no freeze selects (a dead leg's
                                  # states keep integrating but carry
                                  # w = -inf so they are never selected).
    precision: str = "highest"    # matmul precision for the whole sampler
                                  # program. 'highest' = true f32 — the
                                  # library default, because reduced-
                                  # precision gradient noise destabilizes
                                  # leapfrog integration (progcache.
                                  # precise_matmuls). 'high' lets the
                                  # backend use a cheaper f32 emulation
                                  # (TF32 on NVIDIA GPUs) — opt-in; check
                                  # the quality gates before adopting it.


def _cfg_matmul_precision(fn):
    """Trace ``fn`` under ``cfg.precision`` (SHMCConfig-aware precise_matmuls).

    Same rationale as progcache.precise_matmuls — reduced-precision matmuls
    are NOT safe for leapfrog gradients — but lets SHMCConfig select 'high'
    where its accuracy is verified adequate.
    """
    import functools

    @functools.wraps(fn)
    def wrapped(logp_fn, q0, key, warmup=500, samples=500,
                cfg=SHMCConfig(), init_step_size=1.0, metric=None):
        with jax.default_matmul_precision(cfg.precision):
            return fn(logp_fn, q0, key, warmup=warmup, samples=samples,
                      cfg=cfg, init_step_size=init_step_size, metric=metric)
    return wrapped


@partial(jax.jit, static_argnames=("logp_fn", "warmup", "samples", "cfg"))
@_cfg_matmul_precision
def sample_shmc(logp_fn: Callable, q0, key, warmup: int = 500,
                samples: int = 500, cfg: SHMCConfig = SHMCConfig(),
                init_step_size: float = 1.0, metric=None):
    """Static multinomial HMC over all chains of one posterior: q0 is (C, D).

    Each draw: sample momentum, split the static n-step trajectory
    uniformly around the current state (j backward, n - j forward,
    Betancourt's static scheme), integrate with a per-draw jittered step
    size, and select the next state from all n + 1 states with multinomial
    weights e^{H0 - H} via a streaming logsumexp. The split index and
    jitter are shared across chains and spectra (quasi-random halton), so
    the whole batch executes ONE identical static program per draw.

    Warmup adaptation as in sample_chees: per-chain dual averaging on the
    trajectory-averaged acceptance statistic, per-chain Welford pooled as
    within-chain variance into one shared diagonal metric, pooled sampling
    step size (min by default, a per-chain quantile via
    ``cfg.eps_quantile``). vmap over spectra only (chains are internal).
    """
    value_and_grad = jax.vmap(jax.value_and_grad(logp_fn))
    n_chains, dim = q0.shape
    dtype = q0.dtype
    total = warmup + samples
    n_leap_s = cfg.n_steps
    n_leap_w = cfg.warm_steps or cfg.n_steps
    max_e = cfg.max_energy_error

    logp0, grad0 = value_and_grad(q0)
    if metric is not None:
        m_inv0 = jnp.asarray(metric, dtype)
    else:
        m_inv0 = jnp.ones((dim,), dtype)
    if cfg.rng_impl == "rbg":
        # re-key the (old-style uint32[2]) threefry key onto the hardware
        # RngBitGenerator stream; all downstream split/normal/uniform calls
        # then lower to XLA RngBitGenerator ops
        kd = jnp.asarray(key, jnp.uint32).reshape(-1)
        key = jax.random.wrap_key_data(jnp.concatenate([kd, kd])[:4],
                                       impl="rbg")
    key, k_eps = jax.random.split(key)
    eps0 = jax.vmap(
        lambda q, lp, g, k: find_reasonable_step_size(
            lambda qq: jax.value_and_grad(logp_fn)(qq), q, lp, g, k, m_inv0,
            init_eps=init_step_size)
    )(q0, logp0, grad0, jax.random.split(k_eps, n_chains))

    if cfg.adapt_mass:
        in_slow_np, win_end_np = _window_flags(warmup, cfg)
    else:
        in_slow_np = np.zeros(warmup, bool)
        win_end_np = np.zeros(warmup, bool)
    in_slow = jnp.asarray(np.concatenate([in_slow_np, np.zeros(samples, bool)]))
    win_end = jnp.asarray(np.concatenate([win_end_np, np.zeros(samples, bool)]))
    in_warm = jnp.asarray(np.arange(total) < warmup)
    # two host-static quasi-random streams: step-size jitter and the
    # trajectory split fraction
    h1 = _halton2(total)
    h2 = _halton2(2 * total)[total:]
    jit_mult = jnp.asarray(cfg.jitter_lo + (1.0 - cfg.jitter_lo) * h1, dtype)
    nl_sched = np.concatenate([np.full(warmup, n_leap_w),
                               np.full(samples, n_leap_s)])
    j_split = jnp.asarray(np.floor(h2 * (nl_sched + 1)).clip(0, nl_sched)
                          .astype(np.int32))

    da0 = jax.vmap(lambda e: _da_init(e, dtype))(eps0)
    if cfg.adapt_mass:
        wf0 = (jnp.zeros((n_chains, dim), dtype),
               jnp.zeros((n_chains, dim), dtype), jnp.zeros((), dtype))
    else:
        wf0 = (jnp.zeros((0,), dtype), jnp.zeros((0,), dtype),
               jnp.zeros((), dtype))

    def make_step(n_leap, adapting=True, eps_fixed=None):
      """``adapting=False`` specializes the SAMPLING phase: dual averaging,
      Welford and the pooled step-size min are all frozen after warmup, so
      the sampling step closes over the adapted step size and skips the
      adaptation bookkeeping entirely (bit-identical draws — the skipped
      ops were masked no-ops)."""
      def step(carry, xs):
        q, logp, grad, da, wf, m_inv, key = carry
        is_warm, slow, wend, h, j = xs
        key, k_mom, k_sel = jax.random.split(key, 3)

        if adapting:
            eps_samp = _pool_eps(jnp.exp(da.log_eps_bar), cfg)
            eps = jnp.where(is_warm, jnp.exp(da.log_eps),
                            jnp.broadcast_to(eps_samp, (n_chains,)))
        else:
            eps = jnp.broadcast_to(eps_fixed, (n_chains,))
        eps = eps * h
        epsc = eps[:, None]

        z = jax.random.normal(k_mom, (n_chains, dim), dtype)
        p0 = z / jnp.sqrt(m_inv)[None, :]
        kin0 = 0.5 * jnp.sum(p0 * p0 * m_inv[None, :], axis=1)
        H0 = -logp + kin0

        if cfg.traj_store:
            # store-then-select: the leaf carries ONLY the integrator state;
            # per-leaf proposal bookkeeping (logaddexp, take, proposal
            # carries, freeze selects) is replaced by stacked scan outputs
            # and one Gumbel-max categorical after the trajectory. A dead
            # (divergent) leg keeps integrating — its states carry
            # w = -inf, so NaNs/infs can never be selected, and `dead`
            # persists so a leg never resurrects after an energy excursion.
            def leaf_s(st, i):
                qq, pp, gg, dead = st
                flip = i == j
                qq = jnp.where(flip, q, qq)
                pp = jnp.where(flip, p0, pp)
                gg = jnp.where(flip, grad, gg)
                dead = jnp.where(flip, False, dead)
                p_half = pp + 0.5 * epsc * gg
                q_new = qq + epsc * p_half * m_inv[None, :]
                lp_new, g_new = value_and_grad(q_new)
                p_new = p_half + 0.5 * epsc * g_new
                kin = 0.5 * jnp.sum(p_new * p_new * m_inv[None, :], axis=1)
                Hn = -lp_new + kin
                bad = jnp.isnan(Hn) | ((Hn - H0) > max_e)
                dead = dead | bad
                w = jnp.where(dead, -jnp.inf, H0 - Hn)
                return ((q_new, p_new, g_new, dead),
                        (q_new, lp_new, kin, w, dead))

            st0 = (q, -p0, grad, jnp.zeros(n_chains, bool))
            _, ys = jax.lax.scan(leaf_s, st0, jnp.arange(n_leap),
                                 unroll=cfg.leaf_unroll)
            qs, lps, kins, ws, dead_trace = ys
            # categorical over the n+1 trajectory states (initial state has
            # weight 1 <=> w = 0) via Gumbel-max — the same distribution the
            # streaming reservoir update realizes, in one pass
            w_all = jnp.concatenate(
                [jnp.zeros((1, n_chains), dtype), ws], axis=0)
            u_g = jax.random.uniform(k_sel, (n_leap + 1, n_chains), dtype,
                                     minval=jnp.finfo(dtype).tiny, maxval=1.0)
            idx = jnp.argmax(w_all - jnp.log(-jnp.log(u_g)), axis=0)
            sel = idx - 1
            took = sel >= 0
            safe = jnp.maximum(sel, 0)
            q_sel = jnp.take_along_axis(
                qs, safe[None, :, None], axis=0)[0]
            q_next = jnp.where(took[:, None], q_sel, q)
            logp_next = jnp.where(
                took, jnp.take_along_axis(lps, safe[None, :], axis=0)[0],
                logp)
            kin_next = jnp.where(
                took, jnp.take_along_axis(kins, safe[None, :], axis=0)[0],
                kin0)
            _, grad_next = value_and_grad(q_next)
            diverging = dead_trace.any(axis=0)
            accept_prob = jnp.minimum(1.0, jnp.exp(ws)).sum(axis=0) / n_leap
        else:
          def leaf(st, xs_leaf):
            i, u = xs_leaf
            (qq, pp, gg, lp, logw, pq, plp, pgrad, pkin, sacc, dead) = st
            # the backward leg integrates with +eps from (q, -p0) (momentum
            # flip = time reversal); at i == j it ends — reset to the start
            # state with +p0 and clear the freeze flag (a divergent backward
            # leg must not block the forward one)
            flip = i == j
            qq = jnp.where(flip, q, qq)
            pp = jnp.where(flip, p0, pp)
            gg = jnp.where(flip, grad, gg)
            lp = jnp.where(flip, logp, lp)
            dead = jnp.where(flip, False, dead)

            p_half = pp + 0.5 * epsc * gg
            q_new = qq + epsc * p_half * m_inv[None, :]
            lp_new, g_new = value_and_grad(q_new)
            p_new = p_half + 0.5 * epsc * g_new
            kin = 0.5 * jnp.sum(p_new * p_new * m_inv[None, :], axis=1)
            Hn = -lp_new + kin
            w = H0 - Hn
            bad = jnp.isnan(Hn) | ((Hn - H0) > max_e)
            w = jnp.where(bad | dead, -jnp.inf, w)
            logw_new = jnp.logaddexp(logw, w)
            take = jnp.log(u) < (w - logw_new)
            pq = jnp.where(take[:, None], q_new, pq)
            plp = jnp.where(take, lp_new, plp)
            if not cfg.recompute_grad:
                pgrad = jnp.where(take[:, None], g_new, pgrad)
            pkin = jnp.where(take, kin, pkin)
            sacc = sacc + jnp.minimum(1.0, jnp.exp(w))
            dead_new = dead | bad
            ok = (~dead_new)[:, None]
            return ((jnp.where(ok, q_new, qq), jnp.where(ok, p_new, pp),
                     jnp.where(ok, g_new, gg), jnp.where(ok[:, 0], lp_new, lp),
                     logw_new, pq, plp, pgrad, pkin, sacc, dead_new),
                    dead_new)

          # recompute_grad drops the (C, D) selected-gradient carry: the
          # scan carries a zero-width placeholder and the gradient of the
          # selected state is recomputed once after the trajectory
          grad_carry0 = (jnp.zeros((n_chains, 0), dtype)
                         if cfg.recompute_grad else grad)
          st0 = (q, -p0, grad, logp,
                 jnp.zeros(n_chains, dtype), q, logp, grad_carry0, kin0,
                 jnp.zeros(n_chains, dtype), jnp.zeros(n_chains, bool))
          # ALL selection uniforms in one RNG call (a per-leaf
          # fold_in+threefry would cost ~20 extra ops per leaf)
          u_sel = jax.random.uniform(k_sel, (n_leap, n_chains), dtype)
          st, dead_trace = jax.lax.scan(leaf, st0,
                                        (jnp.arange(n_leap), u_sel),
                                        unroll=cfg.leaf_unroll)
          (_, p_end, _, _, logw, q_next, logp_next, grad_next, kin_next,
           sacc, _) = st
          if cfg.recompute_grad:
              _, grad_next = value_and_grad(q_next)
          diverging = dead_trace.any(axis=0)
          accept_prob = sacc / n_leap

        H1 = -logp_next + kin_next

        if adapting:
            da_new = _da_update(da, accept_prob, cfg)
            da = jax.tree.map(lambda n_, o: jnp.where(is_warm, n_, o),
                              da_new, da)

        if adapting and cfg.adapt_mass:
            mean, m2, n = wf
            n1 = n + 1.0
            dlt = q_next - mean
            mean_new = mean + dlt / n1
            m2_new = m2 + dlt * (q_next - mean_new)
            wf = jax.tree.map(lambda a, b_: jnp.where(slow, a, b_),
                              (mean_new, m2_new, n1), wf)
            mean, m2, n = wf
            var_within = (m2 / jnp.maximum(n - 1.0, 1.0)).mean(axis=0)
            reg = _regularized_variance(var_within, n_chains * n)
            m_inv = jnp.where(wend & (n > 1), reg, m_inv)
            wf = jax.tree.map(lambda a: jnp.where(wend, jnp.zeros_like(a), a),
                              wf)
            da_reset = jax.vmap(lambda e: _da_init(e, dtype))(
                jnp.exp(da.log_eps))
            da = jax.tree.map(lambda r, o: jnp.where(wend, r, o), da_reset, da)

        out = (q_next, logp_next, accept_prob, diverging,
               jnp.broadcast_to(jnp.asarray(n_leap, jnp.int32), (n_chains,)),
               H1)
        return (q_next, logp_next, grad_next, da, wf, m_inv, key), out

      return step

    step_w = make_step(n_leap_w)

    def warm_step(carry, xs):
        carry, out = step_w(carry, xs)
        return carry, out[3]

    carry0 = (q0, logp0, grad0, da0, wf0, m_inv0, key)
    xs_w = (in_warm[:warmup], in_slow[:warmup], win_end[:warmup],
            jit_mult[:warmup], j_split[:warmup])
    xs_s = (in_warm[warmup:], in_slow[warmup:], win_end[warmup:],
            jit_mult[warmup:], j_split[warmup:])
    carry, warm_div = jax.lax.scan(warm_step, carry0, xs_w,
                                   unroll=cfg.draw_unroll)
    # sampling runs at the frozen pooled step size — close the
    # specialized non-adapting step over it
    eps_fixed = _pool_eps(jnp.exp(carry[3].log_eps_bar), cfg)
    step_s = make_step(n_leap_s, adapting=False, eps_fixed=eps_fixed)

    def sample_step(carry, xs):
        carry, out = step_s(carry, xs)
        return carry, out

    carry, outs = jax.lax.scan(sample_step, carry, xs_s,
                               unroll=cfg.draw_unroll)
    q_s, logp_s, acc_s, div_s, nstep_s, en_s = outs
    (_, _, _, da, _, m_inv, _) = carry

    draws = jnp.swapaxes(q_s, 0, 1)
    info = {
        "logp": jnp.swapaxes(logp_s, 0, 1),
        "accept_prob": jnp.swapaxes(acc_s, 0, 1),
        "diverging": jnp.swapaxes(div_s, 0, 1),
        "n_leapfrog": jnp.swapaxes(nstep_s, 0, 1),
        "energy": jnp.swapaxes(en_s, 0, 1),
        "step_size": jnp.exp(da.log_eps_bar),
        "inv_mass": m_inv,
        "warmup_diverging": jnp.swapaxes(warm_div, 0, 1),
    }
    return draws, info
