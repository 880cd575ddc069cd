"""From-scratch NUTS (No-U-Turn Sampler) in pure JAX.

Replaces Stan's C++ NUTS (reference: pystan ``model.sampling``,
bayes_drt/inversion.py:1218-1221, control={'adapt_delta': 0.9,
'adapt_t0': 10}) with an iterative multinomial NUTS:

- fixed ``max_depth`` with a checkpoint-stack U-turn scheme so tree building
  is a shape-static lax.while_loop (jittable, vmappable over chains and
  spectra — the batching Stan's recursion cannot give)
- multinomial sampling of the proposal within/between subtrees with biased
  progressive sampling (Betancourt 2017), generalized U-turn criterion on
  velocity/momentum sums
- dual-averaging step-size adaptation (gamma=0.05, kappa=0.75, t0 and
  target delta from the reference's control dict)
- Stan-style expanding-window diagonal mass-matrix adaptation
  (init/term buffers 75/50, base window 25) with Welford accumulation and
  regularized variance estimates

The sampler targets the same posterior as the reference's Stan programs; any
correct NUTS draws from the same distribution, so posterior means match
within Monte Carlo error.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..progcache import precise_matmuls


class NUTSConfig(NamedTuple):
    max_depth: int = 10
    delta: float = 0.9            # adapt_delta (reference control)
    t0: float = 10.0              # adapt_t0 (reference control)
    gamma: float = 0.05
    kappa: float = 0.75
    max_energy_error: float = 1000.0
    init_buffer: int = 75
    term_buffer: int = 50
    base_window: int = 25
    dense_mass: bool = False      # dense (full covariance) metric; cuts
                                  # trajectory lengths ~5-7x on the funnel-like
                                  # DRT posterior (Stan's dense_e analogue)
    adapt_mass: bool = True       # False: keep the initial/passed-in metric
                                  # fixed and adapt only the step size (used
                                  # with a precomputed pooled-batch metric)
    unroll: int = 1               # leapfrogs per while-loop iteration in the
                                  # tree builder (amortizes batch-wide loop
                                  # sync overhead; see _build_subtree)
    flat_tree: bool = False       # single flat while_loop per draw instead
                                  # of nested doubling loops (identical
                                  # draws; see nuts_transition_flat)
    fused_draws: bool = False     # ONE persistent while_loop over the whole
                                  # chain (all warmup+sample draws), with
                                  # masked draw boundaries — no per-draw loop
                                  # entry or scan step, and vmapped batch
                                  # elements never synchronize at draw
                                  # boundaries (same math/RNG as flat_tree,
                                  # equal up to FP reassociation of the
                                  # step-size adaptation; see
                                  # _sample_nuts_fused)
    tree_scan: bool = False       # run the flat tree builder as a
                                  # STATIC-length lax.scan (2^max_depth - 1
                                  # iterations, alive-masked) instead of a
                                  # while_loop. Bit-identical draws. Fastest
                                  # form under a large vmapped batch: a
                                  # vmapped while_loop already runs to the
                                  # batch-max trip count but pays a per-
                                  # iteration sync/dispatch cost that scan
                                  # pipelines away; prefer the
                                  # while_loop for single chains with short
                                  # trajectories. Implies flat_tree.
    scan_unroll: int = 1          # leaves inlined per tree_scan iteration
                                  # (lax.scan unroll): lets XLA fuse across
                                  # leaves at the cost of a bigger program;
                                  # only meaningful with tree_scan=True.


class _EdgeState(NamedTuple):
    q: jax.Array
    p: jax.Array
    grad: jax.Array
    logp: jax.Array


def _vel(p, m_inv):
    """Velocity M^{-1} p; m_inv is a vector (diag metric) or matrix (dense)."""
    if m_inv.ndim == 2:
        return m_inv @ p
    return m_inv * p


def _leapfrog(value_and_grad: Callable, z: _EdgeState, eps, m_inv) -> _EdgeState:
    p_half = z.p + 0.5 * eps * z.grad
    q_new = z.q + eps * _vel(p_half, m_inv)
    logp_new, grad_new = value_and_grad(q_new)
    p_new = p_half + 0.5 * eps * grad_new
    return _EdgeState(q=q_new, p=p_new, grad=grad_new, logp=logp_new)


def _kinetic(p, m_inv):
    return 0.5 * jnp.dot(p, _vel(p, m_inv))


def _sample_momentum(key, m_inv, mass_chol, dtype):
    """p ~ N(0, M). Diag: p = z / sqrt(m_inv). Dense: with Sigma = L L^T the
    inverse metric, p = L^{-T} z has cov (L L^T)^{-1} = M."""
    dim = m_inv.shape[-1]
    z = jax.random.normal(key, (dim,), dtype)
    if m_inv.ndim == 2:
        return jax.scipy.linalg.solve_triangular(mass_chol.T, z, lower=False)
    return z / jnp.sqrt(m_inv)


class _SubtreeResult(NamedTuple):
    edge: _EdgeState          # outermost state of the new subtree
    first: _EdgeState         # innermost (first-generated) state
    prop_q: jax.Array
    prop_logp: jax.Array
    prop_grad: jax.Array
    prop_kin: jax.Array       # kinetic energy at the proposal leaf
    log_weight: jax.Array     # logsumexp of (H0 - H) over subtree leaves
    rho: jax.Array            # momentum sum over subtree
    turning: jax.Array
    diverging: jax.Array
    sum_accept: jax.Array
    n_leaves: jax.Array


def _is_turning(v_left, v_right, rho):
    """Generalized U-turn criterion: velocity at either end anti-aligned with
    the momentum sum across the (sub)tree."""
    return jnp.logical_or(jnp.dot(v_left, rho) <= 0.0,
                          jnp.dot(v_right, rho) <= 0.0)


def _build_subtree(value_and_grad, key, z0: _EdgeState, depth, eps_signed,
                   m_inv, H0, max_depth: int, max_energy_error,
                   unroll: int = 1) -> _SubtreeResult:
    """Run 2^depth leapfrog steps from z0, with progressive multinomial
    proposal sampling and checkpoint-based internal U-turn checks.

    Checkpoint scheme: leaf i starts a subtree of size 2^k iff i % 2^k == 0;
    its start state and the momentum prefix sum are stored in slot k. When
    leaf i completes a subtree of size 2^k (i.e. (i+1) % 2^k == 0) the U-turn
    condition is checked between the stored start and the current leaf with
    the subtree momentum sum. This covers every subtree of the balanced tree
    in O(max_depth) memory — the iterative equivalent of Stan's recursion.

    ``unroll``: leaves processed per while-loop iteration. Under vmap every
    loop iteration is a batch-wide sync point with fixed overhead (cond
    reduction, carry selects, kernel launches); unrolling packs more
    arithmetic per iteration at the price of up to unroll-1 wasted
    (masked-out) leapfrogs at each subtree boundary.
    """
    dim = z0.q.shape[0]
    n_leaves_total = jnp.left_shift(1, depth)
    kd = max_depth + 1
    ks = jnp.arange(kd)
    pow2 = jnp.left_shift(1, ks)

    def one_leaf(st):
        (i, z, prop_q, prop_logp, prop_grad, prop_kin, logw, rho, v_ck,
         rho_ck, first, turning, diverging, sum_acc) = st
        z_new = _leapfrog(value_and_grad, z, eps_signed, m_inv)
        # velocity computed ONCE per leapfrog and reused for the kinetic
        # energy, the end-point U-turn check, and the stored checkpoint
        # (for a dense metric this saves kd matvecs per step)
        v_new = _vel(z_new.p, m_inv)
        kin = 0.5 * jnp.dot(z_new.p, v_new)
        H = -z_new.logp + kin
        w = H0 - H                       # log multinomial weight vs initial
        w = jnp.where(jnp.isnan(H), -jnp.inf, w)
        div = (H - H0) > max_energy_error
        div = jnp.logical_or(div, jnp.isnan(H))

        # progressive multinomial proposal within the subtree
        logw_new = jnp.logaddexp(logw, w)
        u = jax.random.uniform(jax.random.fold_in(key, i))
        take = jnp.log(u) < (w - logw_new)
        prop_q = jnp.where(take, z_new.q, prop_q)
        prop_logp = jnp.where(take, z_new.logp, prop_logp)
        prop_grad = jnp.where(take, z_new.grad, prop_grad)
        prop_kin = jnp.where(take, kin, prop_kin)

        first = jax.tree.map(lambda a, b: jnp.where(i == 0, a, b), z_new, first)

        # store checkpoints for subtrees this leaf starts (only start
        # VELOCITIES are needed by the U-turn checks; positions and momenta
        # are not stored)
        start_mask = (jnp.mod(i, pow2) == 0) & (pow2 <= n_leaves_total)
        v_ck = jnp.where(start_mask[:, None], v_new[None, :], v_ck)
        rho_ck = jnp.where(start_mask[:, None], rho[None, :], rho_ck)

        rho = rho + z_new.p

        # check U-turns for subtrees this leaf completes
        end_mask = (jnp.mod(i + 1, pow2) == 0) & (pow2 <= n_leaves_total)
        rho_subs = rho[None, :] - rho_ck                     # (kd, dim)
        turn_k = jnp.logical_or(
            jnp.einsum("kd,kd->k", v_ck, rho_subs) <= 0.0,
            rho_subs @ v_new <= 0.0)
        turning = jnp.logical_or(turning, jnp.any(turn_k & end_mask & (pow2 > 1)))

        sum_acc = sum_acc + jnp.minimum(1.0, jnp.exp(w))
        return (i + 1, z_new, prop_q, prop_logp, prop_grad, prop_kin,
                logw_new, rho, v_ck, rho_ck, first, turning,
                jnp.logical_or(diverging, div), sum_acc)

    def alive(st):
        i = st[0]
        turning, diverging = st[11], st[12]
        return (i < n_leaves_total) & (~turning) & (~diverging)

    def body(st):
        # first leaf needs no guard: cond() just established liveness
        st = one_leaf(st)
        for _ in range(unroll - 1):
            ok = alive(st)
            st_new = one_leaf(st)
            st = jax.tree.map(lambda a, b: jnp.where(ok, a, b), st_new, st)
        return st

    cond = alive

    zeros = jnp.zeros((kd, dim), z0.q.dtype)
    init = (jnp.asarray(0, jnp.int32), z0, z0.q, z0.logp, z0.grad,
            _kinetic(z0.p, m_inv),
            jnp.asarray(-jnp.inf, z0.q.dtype), jnp.zeros((dim,), z0.q.dtype),
            zeros, zeros, z0, jnp.asarray(False), jnp.asarray(False),
            jnp.asarray(0.0, z0.q.dtype))
    (i, z, prop_q, prop_logp, prop_grad, prop_kin, logw, rho, _, _, first,
     turning, diverging, sum_acc) = jax.lax.while_loop(cond, body, init)
    return _SubtreeResult(edge=z, first=first, prop_q=prop_q,
                          prop_logp=prop_logp, prop_grad=prop_grad,
                          prop_kin=prop_kin, log_weight=logw, rho=rho,
                          turning=turning, diverging=diverging,
                          sum_accept=sum_acc, n_leaves=i)


class NUTSInfo(NamedTuple):
    accept_prob: jax.Array
    diverging: jax.Array
    n_leapfrog: jax.Array
    energy: jax.Array
    tree_depth: jax.Array


class _FlatState(NamedTuple):
    """Full state of one in-flight flat-loop NUTS transition (the carry of
    nuts_transition_flat's while_loop, shared with the fused sampler)."""
    depth: jax.Array
    z_minus: _EdgeState
    z_plus: _EdgeState
    prop_q: jax.Array
    prop_logp: jax.Array
    prop_grad: jax.Array
    prop_kin: jax.Array
    logw: jax.Array
    rho: jax.Array
    turning: jax.Array
    diverging: jax.Array
    sum_acc: jax.Array
    n_leaves: jax.Array
    key: jax.Array
    i: jax.Array
    z: _EdgeState
    sprop_q: jax.Array
    sprop_logp: jax.Array
    sprop_grad: jax.Array
    sprop_kin: jax.Array
    slogw: jax.Array
    srho: jax.Array
    v_ck: jax.Array           # (max_depth, dim): checkpoint velocities for
    rho_ck: jax.Array         # subtree sizes 2^1..2^max_depth (size-1
                              # subtrees never run a U-turn check, so row 0
                              # of the classic scheme is omitted)
    sfirst_p: jax.Array       # momentum of the subtree's first leaf (only
                              # .p of the first state feeds the cross-
                              # subtree turn checks)
    sturn: jax.Array
    sdiv: jax.Array
    ssum: jax.Array
    go_right: jax.Array
    key_sub: jax.Array
    key_swap: jax.Array


def _sel(pred, a, b):
    return jax.tree.map(lambda x, y: jnp.where(pred, x, y), a, b)


def _flat_init(q, logp, grad, p0, kin0, key_tree, n_ck: int) -> _FlatState:
    """Fresh transition state at the start of a draw (momentum p0 already
    sampled; kin0 = kinetic(p0)). ``n_ck`` = max_depth checkpoint rows."""
    dim = q.shape[0]
    dtype = q.dtype
    z0 = _EdgeState(q=q, p=p0, grad=grad, logp=logp)
    zeros_ck = jnp.zeros((n_ck, dim), dtype)
    i32 = lambda v: jnp.asarray(v, jnp.int32)
    fdt = lambda v: jnp.asarray(v, dtype)
    return _FlatState(
        depth=i32(0), z_minus=z0, z_plus=z0, prop_q=q, prop_logp=logp,
        prop_grad=grad, prop_kin=kin0, logw=fdt(0.0), rho=p0,
        turning=jnp.asarray(False), diverging=jnp.asarray(False),
        sum_acc=fdt(0.0), n_leaves=i32(0), key=key_tree,
        i=i32(0), z=z0, sprop_q=q, sprop_logp=logp, sprop_grad=grad,
        sprop_kin=fdt(0.0), slogw=fdt(-jnp.inf),
        srho=jnp.zeros((dim,), dtype), v_ck=zeros_ck, rho_ck=zeros_ck,
        sfirst_p=p0, sturn=jnp.asarray(False), sdiv=jnp.asarray(False),
        ssum=fdt(0.0), go_right=jnp.asarray(False), key_sub=key_tree,
        key_swap=key_tree)


def _flat_body(value_and_grad: Callable, st: _FlatState, eps, m_inv, H0,
               pow2, max_energy_error) -> _FlatState:
    """One leapfrog step of the flat tree builder: masked subtree start,
    leaf bookkeeping, and masked subtree merge. eps and H0 may be traced
    per-element values (they vary per draw in the fused sampler)."""
    sel = _sel
    (depth, z_minus, z_plus, prop_q, prop_logp, prop_grad, prop_kin,
     logw, rho, turning, diverging, sum_acc, n_leaves, key,
     i, z, sprop_q, sprop_logp, sprop_grad, sprop_kin, slogw, srho,
     v_ck, rho_ck, sfirst_p, sturn, sdiv, ssum, go_right, key_sub,
     key_swap) = st

    # ---- subtree start (i == 0): direction, fresh keys, reset ----
    start = i == 0
    key_n, kdir, ksub_n, kswap_n = jax.random.split(key, 4)
    key = sel(start, key_n, key)
    go_right = jnp.where(start, jax.random.bernoulli(kdir), go_right)
    key_sub = sel(start, ksub_n, key_sub)
    key_swap = sel(start, kswap_n, key_swap)
    z = sel(start, sel(go_right, z_plus, z_minus), z)
    slogw = jnp.where(start, -jnp.inf, slogw)
    srho = jnp.where(start, jnp.zeros_like(srho), srho)
    sturn = jnp.where(start, False, sturn)
    sdiv = jnp.where(start, False, sdiv)
    ssum = jnp.where(start, 0.0, ssum)

    n_sub = jnp.left_shift(1, depth)
    eps_signed = jnp.where(go_right, eps, -eps)

    # ---- one leaf (same math as _build_subtree's one_leaf) ----
    z_new = _leapfrog(value_and_grad, z, eps_signed, m_inv)
    v_new = _vel(z_new.p, m_inv)
    kin = 0.5 * jnp.dot(z_new.p, v_new)
    H = -z_new.logp + kin
    w = H0 - H
    w = jnp.where(jnp.isnan(H), -jnp.inf, w)
    div_leaf = ((H - H0) > max_energy_error) | jnp.isnan(H)

    slogw_new = jnp.logaddexp(slogw, w)
    u = jax.random.uniform(jax.random.fold_in(key_sub, i))
    take = jnp.log(u) < (w - slogw_new)
    sprop_q = jnp.where(take, z_new.q, sprop_q)
    sprop_logp = jnp.where(take, z_new.logp, sprop_logp)
    sprop_grad = jnp.where(take, z_new.grad, sprop_grad)
    sprop_kin = jnp.where(take, kin, sprop_kin)
    sfirst_p = jnp.where(i == 0, z_new.p, sfirst_p)

    start_mask = (jnp.mod(i, pow2) == 0) & (pow2 <= n_sub)
    v_ck = jnp.where(start_mask[:, None], v_new[None, :], v_ck)
    rho_ck = jnp.where(start_mask[:, None], srho[None, :], rho_ck)
    srho = srho + z_new.p
    end_mask = (jnp.mod(i + 1, pow2) == 0) & (pow2 <= n_sub)
    rho_subs = srho[None, :] - rho_ck
    turn_k = jnp.logical_or(
        jnp.einsum("kd,kd->k", v_ck, rho_subs) <= 0.0,
        rho_subs @ v_new <= 0.0)
    sturn = jnp.logical_or(sturn, jnp.any(turn_k & end_mask))
    sdiv = jnp.logical_or(sdiv, div_leaf)
    ssum = ssum + jnp.minimum(1.0, jnp.exp(w))
    slogw = slogw_new
    z = z_new
    i = i + 1

    # ---- subtree complete: merge into the main tree (masked) ----
    upd = (i >= n_sub) | sturn | sdiv
    ok = (~sturn) & (~sdiv)

    sum_acc = jnp.where(upd, sum_acc + ssum, sum_acc)
    n_leaves = jnp.where(upd, n_leaves + i, n_leaves)

    swap = jnp.log(jax.random.uniform(key_swap)) < (slogw - logw)
    accept_sub = upd & ok & swap
    prop_q = jnp.where(accept_sub, sprop_q, prop_q)
    prop_logp = jnp.where(accept_sub, sprop_logp, prop_logp)
    prop_grad = jnp.where(accept_sub, sprop_grad, prop_grad)
    prop_kin = jnp.where(accept_sub, sprop_kin, prop_kin)
    logw = jnp.where(upd & ok, jnp.logaddexp(logw, slogw), logw)

    old_plus, old_minus = z_plus, z_minus
    z_plus = sel(upd & ok & go_right, z, z_plus)
    z_minus = sel(upd & ok & (~go_right), z, z_minus)
    rho_new = rho + srho
    merged_turn = _is_turning(_vel(z_minus.p, m_inv),
                              _vel(z_plus.p, m_inv), rho_new)
    inner_old = sel(go_right, old_plus, old_minus)
    rho_lx = rho + sfirst_p
    turn_lx = _is_turning(
        _vel(jnp.where(go_right, old_minus.p, sfirst_p), m_inv),
        _vel(jnp.where(go_right, sfirst_p, old_plus.p), m_inv), rho_lx)
    rho_rx = srho + inner_old.p
    turn_rx = _is_turning(
        _vel(jnp.where(go_right, inner_old.p, z.p), m_inv),
        _vel(jnp.where(go_right, z.p, inner_old.p), m_inv), rho_rx)
    merged_turn = merged_turn | turn_lx | turn_rx
    rho = jnp.where(upd & ok, rho_new, rho)
    turning = jnp.where(upd, sturn | (ok & merged_turn), turning)
    diverging = jnp.where(upd, diverging | sdiv, diverging)
    depth = jnp.where(upd, depth + 1, depth)
    i = jnp.where(upd, 0, i)

    return _FlatState(
        depth, z_minus, z_plus, prop_q, prop_logp, prop_grad,
        prop_kin, logw, rho, turning, diverging, sum_acc, n_leaves,
        key, i, z, sprop_q, sprop_logp, sprop_grad, sprop_kin,
        slogw, srho, v_ck, rho_ck, sfirst_p, sturn, sdiv, ssum,
        go_right, key_sub, key_swap)


def _flat_alive(st: _FlatState, max_depth: int):
    return (st.depth < max_depth) & (~st.turning) & (~st.diverging)


def nuts_transition_flat(value_and_grad: Callable, q, logp, grad, key, eps,
                         m_inv, max_depth: int = 10,
                         max_energy_error: float = 1000.0, mass_chol=None,
                         tree_scan: bool = False, scan_unroll: int = 1):
    """One NUTS draw built with a SINGLE while_loop over leapfrog steps.

    Mathematically identical to ``nuts_transition`` (same RNG stream, same
    draws bit-for-bit), but the tree doubling and merge bookkeeping run as
    MASKED operations inside one flat loop instead of a per-subtree inner
    while_loop. Two wins on accelerator runtimes: (a) one loop entry per
    draw instead of 1 + tree_depth, so any fixed loop setup/teardown cost
    is paid once; (b) under vmap the batch no longer synchronizes at every
    subtree boundary — each element advances through its own doubling
    schedule, so a draw costs max-total-leaves instead of
    sum-of-per-subtree maxima.
    """
    key_mom, key_tree = jax.random.split(key)
    dtype = q.dtype
    p0 = _sample_momentum(key_mom, m_inv, mass_chol, dtype)
    H0 = -logp + _kinetic(p0, m_inv)
    # checkpoint rows cover subtree sizes 2^1..2^max_depth; size-1 subtrees
    # never run a U-turn check, so the classic scheme's row 0 is dropped
    pow2 = jnp.left_shift(1, jnp.arange(1, max_depth + 1))

    init = _flat_init(q, logp, grad, p0, _kinetic(p0, m_inv), key_tree,
                      max_depth)
    if tree_scan:
        # static trip count: a NUTS tree at max_depth visits at most
        # 2^max_depth - 1 leaves (subtree sizes 1, 2, ..., 2^(max_depth-1)).
        # Finished trees are frozen by the alive mask; the wasted leapfrogs
        # cost nothing extra under a large vmap (a vmapped while_loop runs
        # to the batch max anyway) and the scan pipelines across iterations.
        def scan_body(s, _):
            s_new = _flat_body(value_and_grad, s, eps, m_inv, H0, pow2,
                               max_energy_error)
            return _sel(_flat_alive(s, max_depth), s_new, s), None

        st, _ = jax.lax.scan(scan_body, init, None,
                             length=(1 << max_depth) - 1,
                             unroll=scan_unroll)
    else:
        st = jax.lax.while_loop(
            lambda s: _flat_alive(s, max_depth),
            lambda s: _flat_body(value_and_grad, s, eps, m_inv, H0, pow2,
                                 max_energy_error),
            init)

    accept_prob = st.sum_acc / jnp.maximum(st.n_leaves, 1)
    energy = -st.prop_logp + st.prop_kin
    info = NUTSInfo(accept_prob=accept_prob, diverging=st.diverging,
                    n_leapfrog=st.n_leaves, energy=energy,
                    tree_depth=st.depth)
    return st.prop_q, st.prop_logp, st.prop_grad, info


def nuts_transition(value_and_grad: Callable, q, logp, grad, key, eps, m_inv,
                    max_depth: int = 10, max_energy_error: float = 1000.0,
                    mass_chol=None, unroll: int = 1):
    """One NUTS draw. Returns (q_new, logp_new, grad_new, NUTSInfo)."""
    key_mom, key_tree = jax.random.split(key)
    dim = q.shape[0]
    p0 = _sample_momentum(key_mom, m_inv, mass_chol, q.dtype)
    H0 = -logp + _kinetic(p0, m_inv)
    z0 = _EdgeState(q=q, p=p0, grad=grad, logp=logp)

    def body(st):
        (depth, z_minus, z_plus, prop_q, prop_logp, prop_grad, prop_kin,
         logw, rho, turning, diverging, sum_acc, n_leaves, key) = st
        key, key_dir, key_sub, key_swap = jax.random.split(key, 4)
        go_right = jax.random.bernoulli(key_dir)
        edge = jax.tree.map(lambda a, b: jnp.where(go_right, a, b),
                            z_plus, z_minus)
        eps_signed = jnp.where(go_right, eps, -eps)
        sub = _build_subtree(value_and_grad, key_sub, edge, depth, eps_signed,
                             m_inv, H0, max_depth, max_energy_error,
                             unroll=unroll)
        sum_acc = sum_acc + sub.sum_accept
        n_leaves = n_leaves + sub.n_leaves
        ok = (~sub.turning) & (~sub.diverging)

        # biased progressive sampling between old tree and new subtree
        swap = jnp.log(jax.random.uniform(key_swap)) < (sub.log_weight - logw)
        accept_sub = ok & swap
        prop_q = jnp.where(accept_sub, sub.prop_q, prop_q)
        prop_logp = jnp.where(accept_sub, sub.prop_logp, prop_logp)
        prop_grad = jnp.where(accept_sub, sub.prop_grad, prop_grad)
        prop_kin = jnp.where(accept_sub, sub.prop_kin, prop_kin)
        logw = jnp.where(ok, jnp.logaddexp(logw, sub.log_weight), logw)

        # merge edges/rho only when the subtree is valid
        old_plus, old_minus = z_plus, z_minus
        z_plus = jax.tree.map(lambda new, old: jnp.where(ok & go_right, new, old),
                              sub.edge, z_plus)
        z_minus = jax.tree.map(lambda new, old: jnp.where(ok & (~go_right), new, old),
                               sub.edge, z_minus)
        rho_new = rho + sub.rho
        merged_turn = _is_turning(_vel(z_minus.p, m_inv), _vel(z_plus.p, m_inv),
                                  rho_new)
        # Stan's sharper extra checks across the merge boundary: the old tree
        # extended by the subtree's innermost momentum, and the subtree
        # extended by the old tree's adjacent edge momentum (stan-dev/stan
        # base_nuts transition; prevents runaway max-depth trajectories)
        inner_old = jax.tree.map(lambda a, b: jnp.where(go_right, a, b),
                                 old_plus, old_minus)
        rho_lx = rho + sub.first.p
        turn_lx = _is_turning(
            _vel(jnp.where(go_right, old_minus.p, sub.first.p), m_inv),
            _vel(jnp.where(go_right, sub.first.p, old_plus.p), m_inv),
            rho_lx)
        rho_rx = sub.rho + inner_old.p
        turn_rx = _is_turning(
            _vel(jnp.where(go_right, inner_old.p, sub.edge.p), m_inv),
            _vel(jnp.where(go_right, sub.edge.p, inner_old.p), m_inv),
            rho_rx)
        merged_turn = merged_turn | turn_lx | turn_rx
        rho = jnp.where(ok, rho_new, rho)
        turning = jnp.logical_or(sub.turning, ok & merged_turn)
        diverging = jnp.logical_or(diverging, sub.diverging)
        return (depth + 1, z_minus, z_plus, prop_q, prop_logp, prop_grad,
                prop_kin, logw, rho, turning, diverging, sum_acc, n_leaves,
                key)

    def cond(st):
        depth, turning, diverging = st[0], st[9], st[10]
        return (depth < max_depth) & (~turning) & (~diverging)

    init = (jnp.asarray(0, jnp.int32), z0, z0, q, logp, grad,
            _kinetic(p0, m_inv),
            jnp.asarray(0.0, q.dtype), p0, jnp.asarray(False),
            jnp.asarray(False), jnp.asarray(0.0, q.dtype),
            jnp.asarray(0, jnp.int32), key_tree)
    (depth, _, _, prop_q, prop_logp, prop_grad, prop_kin, _, _, _,
     diverging, sum_acc, n_leaves, _) = jax.lax.while_loop(cond, body, init)

    accept_prob = sum_acc / jnp.maximum(n_leaves, 1)
    # energy of the accepted state (Stan's energy__), for E-BFMI diagnostics
    energy = -prop_logp + prop_kin
    info = NUTSInfo(accept_prob=accept_prob, diverging=diverging,
                    n_leapfrog=n_leaves, energy=energy, tree_depth=depth)
    return prop_q, prop_logp, prop_grad, info


def find_reasonable_step_size(value_and_grad, q, logp, grad, key, m_inv,
                              init_eps=1.0, max_tries=60, mass_chol=None):
    """Double/halve eps until the one-step acceptance crosses ~0.5
    (Hoffman & Gelman 2014 heuristic, as in Stan's init_stepsize)."""
    p0 = _sample_momentum(key, m_inv, mass_chol, q.dtype)
    H0 = -logp + _kinetic(p0, m_inv)
    z0 = _EdgeState(q=q, p=p0, grad=grad, logp=logp)

    def ratio(eps):
        z = _leapfrog(value_and_grad, z0, eps, m_inv)
        H = -z.logp + _kinetic(z.p, m_inv)
        r = H0 - H
        return jnp.where(jnp.isnan(r), -jnp.inf, r)

    r0 = ratio(init_eps)
    direction = jnp.where(r0 > jnp.log(0.5), 1.0, -1.0)

    def body(st):
        eps, _, i = st
        eps_new = eps * jnp.power(2.0, direction)
        return eps_new, ratio(eps_new), i + 1

    def cond(st):
        eps, r, i = st
        keep = jnp.where(direction > 0, r > jnp.log(0.5), r < jnp.log(0.5))
        return keep & (i < max_tries) & (eps < 1e7) & (eps > 1e-10)

    eps, _, _ = jax.lax.while_loop(cond, body, (jnp.asarray(init_eps, q.dtype), r0,
                                                jnp.asarray(0, jnp.int32)))
    return eps


def _window_flags(warmup: int, cfg: NUTSConfig):
    """Stan-style adaptation schedule flags (host-side, static)."""
    init_b, term_b, base = cfg.init_buffer, cfg.term_buffer, cfg.base_window
    if warmup < 20:
        # degenerate: adapt step size only
        return np.zeros(warmup, bool), np.zeros(warmup, bool)
    if init_b + term_b + base > warmup:
        init_b = int(0.15 * warmup)
        term_b = int(0.10 * warmup)
        base = warmup - init_b - term_b
    in_slow = np.zeros(warmup, bool)
    win_end = np.zeros(warmup, bool)
    slow_start, slow_stop = init_b, warmup - term_b
    in_slow[slow_start:slow_stop] = True
    t = slow_start
    w = base
    while t < slow_stop:
        end = t + w
        if end + 2 * w > slow_stop:
            end = slow_stop
        win_end[end - 1] = True
        t = end
        w *= 2
    return in_slow, win_end


class _DAState(NamedTuple):
    log_eps: jax.Array
    log_eps_bar: jax.Array
    h_bar: jax.Array
    mu: jax.Array
    t: jax.Array


def _da_init(eps, dtype):
    # log_eps_bar seeds at log(eps), not 0: sampling draws use
    # exp(log_eps_bar), so a warm_start refit with warmup=0 must sample at
    # the carried adapted step size rather than silently at eps=1.0 (Stan
    # likewise seeds eps_bar with the adapted eps)
    return _DAState(log_eps=jnp.log(eps).astype(dtype),
                    log_eps_bar=jnp.log(eps).astype(dtype),
                    h_bar=jnp.zeros((), dtype),
                    mu=(jnp.log(10.0) + jnp.log(eps)).astype(dtype),
                    t=jnp.zeros((), dtype))


def _da_update(da: _DAState, accept_prob, cfg: NUTSConfig):
    t = da.t + 1.0
    eta = 1.0 / (t + cfg.t0)
    h_bar = (1.0 - eta) * da.h_bar + eta * (cfg.delta - accept_prob)
    log_eps = da.mu - jnp.sqrt(t) / cfg.gamma * h_bar
    w = jnp.power(t, -cfg.kappa)
    log_eps_bar = w * log_eps + (1.0 - w) * da.log_eps_bar
    return _DAState(log_eps=log_eps, log_eps_bar=log_eps_bar, h_bar=h_bar,
                    mu=da.mu, t=t)



def _welford_init(dim, dtype, adapt_mass: bool, dense_mass: bool):
    """Welford accumulator (mean, M2, n): variance vector (diag) or full
    covariance (dense); empty when the metric is fixed."""
    if not adapt_mass:
        return (jnp.zeros((0,), dtype), jnp.zeros((0,), dtype),
                jnp.zeros((), dtype))
    m2_shape = (dim, dim) if dense_mass else (dim,)
    return (jnp.zeros((dim,), dtype), jnp.zeros(m2_shape, dtype),
            jnp.zeros((), dtype))


def _welford_add(wf, x, dense_mass: bool):
    mean, m2, n = wf
    n1 = n + 1.0
    d = x - mean
    mean = mean + d / n1
    d2 = x - mean
    m2 = m2 + (jnp.outer(d, d2) if dense_mass else d * d2)
    return mean, m2, n1


def _regularized_variance(cov, n):
    """Stan-style shrunk variance estimate for the new metric at a window
    end: cov * n/(n+5) + 1e-3 * 5/(n+5)."""
    return cov * (n / (n + 5.0)) + 1e-3 * (5.0 / (n + 5.0))


def _sample_nuts_fused(value_and_grad: Callable, q0, logp0, grad0, key,
                       warmup: int, samples: int, cfg: NUTSConfig,
                       m_inv0, chol0, eps0):
    """Run a whole NUTS chain (warmup + samples) in ONE persistent
    lax.while_loop over leapfrog steps.

    Draw boundaries (momentum refresh, dual-averaging update, mass-window
    update, draw write) are MASKED operations inside the loop, so there is
    no per-draw scan step or while_loop entry, and under vmap batch elements
    never synchronize at draw boundaries: the loop runs max-over-batch of
    TOTAL leapfrogs instead of sum-over-draws of per-draw maxima.

    Same RNG stream and same math as the flat_tree scan path: draws are
    bit-identical when warmup=0; with adaptation they agree to floating-
    point reassociation (XLA fuses the dual-averaging arithmetic differently
    in the two program structures, and the ulp-level step-size difference
    grows chaotically), with identical tree shapes (n_leapfrog).

    Draw writes use a trash-row scheme: every iteration writes row
    ``min(d - warmup, samples)`` of a (samples+1)-row buffer; non-boundary
    iterations and warmup draws land in the extra row and are discarded.
    """
    dim = q0.shape[0]
    dtype = q0.dtype
    total = warmup + samples
    kd = cfg.max_depth    # checkpoint rows: subtree sizes 2^1..2^max_depth
    pow2 = jnp.left_shift(1, jnp.arange(1, cfg.max_depth + 1))

    if cfg.adapt_mass:
        in_slow_np, win_end_np = _window_flags(warmup, cfg)
        in_slow = jnp.asarray(np.concatenate([in_slow_np,
                                              np.zeros(samples, bool)]))
        win_end = jnp.asarray(np.concatenate([win_end_np,
                                              np.zeros(samples, bool)]))
    wf0 = _welford_init(dim, dtype, cfg.adapt_mass, dense_mass=False)

    qs0 = jnp.zeros((samples + 1, dim), dtype)
    fbuf = jnp.zeros((samples + 1,), dtype)
    carry0 = (jnp.asarray(0, jnp.int32),             # d: draws completed
              jnp.asarray(True),                     # need_refresh
              q0, logp0, grad0,
              _da_init(eps0, dtype), wf0, m_inv0, chol0, key,
              jnp.zeros((), dtype),                  # eps of in-flight draw
              jnp.zeros((), dtype),                  # H0 of in-flight draw
              _flat_init(q0, logp0, grad0, jnp.zeros_like(q0),
                         jnp.zeros((), dtype), key, kd),
              qs0, fbuf, fbuf, jnp.zeros((samples + 1,), bool),
              jnp.zeros((samples + 1,), jnp.int32), fbuf,
              jnp.zeros((warmup + 1,), bool))

    def body(c):
        (d, refresh, q, logp, grad, da, wf, m_inv, chol, key, eps_draw, H0,
         st, qs, logps, accb, divb, nlfb, enb, wdivb) = c
        is_warm = d < warmup

        # ---- masked draw start: fresh keys, momentum, step size ----
        key_next, k_step = jax.random.split(key)
        key_mom, key_tree = jax.random.split(k_step)
        p0 = _sample_momentum(key_mom, m_inv, chol, dtype)
        kin0 = _kinetic(p0, m_inv)
        eps_new = jnp.where(is_warm, jnp.exp(da.log_eps),
                            jnp.exp(da.log_eps_bar))
        st = _sel(refresh, _flat_init(q, logp, grad, p0, kin0, key_tree, kd),
                  st)
        H0 = jnp.where(refresh, -logp + kin0, H0)
        eps_draw = jnp.where(refresh, eps_new, eps_draw)
        key = _sel(refresh, key_next, key)

        # ---- one leapfrog of the flat tree builder ----
        st = _flat_body(value_and_grad, st, eps_draw, m_inv, H0, pow2,
                        cfg.max_energy_error)
        done = ~_flat_alive(st, cfg.max_depth)

        # ---- masked draw completion ----
        accept = st.sum_acc / jnp.maximum(st.n_leaves, 1)
        energy = -st.prop_logp + st.prop_kin
        q = jnp.where(done, st.prop_q, q)
        logp = jnp.where(done, st.prop_logp, logp)
        grad = jnp.where(done, st.prop_grad, grad)
        da = _sel(done & is_warm, _da_update(da, accept, cfg), da)

        if cfg.adapt_mass:
            slow_d = jnp.take(in_slow, d, mode="clip")
            wend_d = jnp.take(win_end, d, mode="clip")
            wf = _sel(done & slow_d, _welford_add(wf, q, dense_mass=False),
                      wf)
            mean, m2, n = wf
            cov = m2 / jnp.maximum(n - 1.0, 1.0)
            reg = _regularized_variance(cov, n)
            m_inv = jnp.where(done & wend_d & (n > 1), reg, m_inv)
            wf = jax.tree.map(
                lambda a: jnp.where(done & wend_d, jnp.zeros_like(a), a), wf)
            da = _sel(done & wend_d, _da_init(jnp.exp(da.log_eps), dtype), da)

        sidx = jnp.where(done & (d >= warmup), d - warmup, samples)
        qs = qs.at[sidx].set(st.prop_q)
        logps = logps.at[sidx].set(st.prop_logp)
        accb = accb.at[sidx].set(accept)
        divb = divb.at[sidx].set(st.diverging)
        nlfb = nlfb.at[sidx].set(st.n_leaves)
        enb = enb.at[sidx].set(energy)
        widx = jnp.where(done & is_warm, d, warmup)
        wdivb = wdivb.at[widx].set(st.diverging)

        d = d + done.astype(jnp.int32)
        return (d, done, q, logp, grad, da, wf, m_inv, chol, key, eps_draw,
                H0, st, qs, logps, accb, divb, nlfb, enb, wdivb)

    final = jax.lax.while_loop(lambda c: c[0] < total, body, carry0)
    (_, _, _, _, _, da, _, m_inv, _, _, _, _, _, qs, logps, accb, divb,
     nlfb, enb, wdivb) = final
    info = {
        "logp": logps[:samples],
        "accept_prob": accb[:samples],
        "diverging": divb[:samples],
        "n_leapfrog": nlfb[:samples],
        "energy": enb[:samples],
        "step_size": jnp.exp(da.log_eps_bar),
        "inv_mass": m_inv,
        "warmup_diverging": wdivb[:warmup],
    }
    return qs[:samples], info


@partial(jax.jit, static_argnames=("logp_fn", "warmup", "samples", "cfg"))
@precise_matmuls
def sample_nuts(logp_fn: Callable, q0, key, warmup: int = 200,
                samples: int = 200, cfg: NUTSConfig = NUTSConfig(),
                init_step_size: float = 1.0, metric=None):
    """Run one NUTS chain: warmup with step-size + diag-mass adaptation, then
    sampling. Returns (draws (samples, D), info dict of stacked per-draw
    diagnostics). vmap over q0/key for multiple chains/spectra.

    ``metric``: optional precomputed inverse mass matrix — a (D,) variance
    vector or a (D, D) covariance (pass ``(m_inv, cholesky(m_inv))`` for
    dense). With ``cfg.adapt_mass=False`` it stays fixed and only the step
    size adapts; closing a SHARED metric over a vmapped call keeps it
    unbatched (one matrix for the whole batch → plain matmuls, no per-element
    metric traffic).
    """
    value_and_grad = jax.value_and_grad(logp_fn)
    dim = q0.shape[0]
    dtype = q0.dtype
    total = warmup + samples

    logp0, grad0 = value_and_grad(q0)
    if metric is not None:
        if isinstance(metric, (tuple, list)):
            m_inv0 = jnp.asarray(metric[0], dtype)
            chol0 = jnp.asarray(metric[1], dtype)
        else:
            m_inv0 = jnp.asarray(metric, dtype)
            chol0 = (jnp.linalg.cholesky(m_inv0) if m_inv0.ndim == 2
                     else jnp.zeros((0,), dtype))
    elif cfg.dense_mass:
        m_inv0 = jnp.eye(dim, dtype=dtype)
        chol0 = jnp.eye(dim, dtype=dtype)
    else:
        m_inv0 = jnp.ones((dim,), dtype)
        chol0 = jnp.zeros((0,), dtype)   # unused placeholder for diag metric
    key, k_eps = jax.random.split(key)
    eps0 = find_reasonable_step_size(value_and_grad, q0, logp0, grad0, k_eps,
                                     m_inv0, init_eps=init_step_size,
                                     mass_chol=chol0)

    if cfg.fused_draws:
        import warnings
        warnings.warn(
            "NUTSConfig(fused_draws=True) was measured SLOWER than "
            "flat_tree/tree_scan at equal draws, compiles very "
            "slowly, and can exhaust device memory at large batch sizes; "
            "it is kept only for API/algorithm completeness. Use "
            "tree_scan=True instead.", stacklevel=2)
        if cfg.adapt_mass and cfg.dense_mass:
            raise ValueError(
                "fused_draws does not support dense mass adaptation (the "
                "masked window update would pay a cholesky per leapfrog); "
                "pass a fixed dense metric with adapt_mass=False, or use "
                "flat_tree")
        return _sample_nuts_fused(value_and_grad, q0, logp0, grad0, key,
                                  warmup, samples, cfg, m_inv0, chol0, eps0)

    if cfg.adapt_mass:
        in_slow_np, win_end_np = _window_flags(warmup, cfg)
    else:
        in_slow_np = np.zeros(warmup, bool)
        win_end_np = np.zeros(warmup, bool)
    in_slow = jnp.asarray(np.concatenate([in_slow_np, np.zeros(samples, bool)]))
    win_end = jnp.asarray(np.concatenate([win_end_np, np.zeros(samples, bool)]))
    in_warm = jnp.asarray(np.arange(total) < warmup)

    da0 = _da_init(eps0, dtype)
    wf0 = _welford_init(dim, dtype, cfg.adapt_mass, cfg.dense_mass)

    def step(carry, xs):
        q, logp, grad, da, wf, m_inv, chol, key = carry
        is_warm, slow, wend = xs
        key, k_step = jax.random.split(key)
        eps = jnp.where(is_warm, jnp.exp(da.log_eps), jnp.exp(da.log_eps_bar))
        if cfg.flat_tree or cfg.tree_scan:
            q, logp, grad, info = nuts_transition_flat(
                value_and_grad, q, logp, grad, k_step, eps, m_inv,
                max_depth=cfg.max_depth,
                max_energy_error=cfg.max_energy_error, mass_chol=chol,
                tree_scan=cfg.tree_scan, scan_unroll=cfg.scan_unroll)
        else:
            q, logp, grad, info = nuts_transition(
                value_and_grad, q, logp, grad, k_step, eps, m_inv,
                max_depth=cfg.max_depth,
                max_energy_error=cfg.max_energy_error,
                mass_chol=chol, unroll=cfg.unroll)

        da_new = _da_update(da, info.accept_prob, cfg)
        da = jax.tree.map(lambda n, o: jnp.where(is_warm, n, o), da_new, da)

        if not cfg.adapt_mass:
            return (q, logp, grad, da, wf, m_inv, chol, key), info

        wf_new = _welford_add(wf, q, cfg.dense_mass)
        wf = jax.tree.map(lambda n, o: jnp.where(slow, n, o), wf_new, wf)

        # end of a slow window: set mass matrix from regularized (co)variance,
        # reset Welford and re-center dual averaging at the current step size
        mean, m2, n = wf
        cov = m2 / jnp.maximum(n - 1.0, 1.0)
        if cfg.dense_mass:
            # shrink off-diagonals toward the diagonal when the window holds
            # fewer draws than dimensions (raw covariance is rank-deficient
            # and would cripple the metric in its null directions)
            alpha = n / (n + dim + 5.0)
            diag_part = jnp.diag(jnp.diagonal(cov))
            shrunk = alpha * cov + (1.0 - alpha) * diag_part
            reg = (shrunk * (n / (n + 5.0))
                   + 1e-3 * (5.0 / (n + 5.0)) * jnp.eye(dim, dtype=dtype))
            # (dense variant of _regularized_variance: identity-scaled floor)
            new_chol = jnp.linalg.cholesky(reg)
            ok = wend & (n > 1) & jnp.all(jnp.isfinite(new_chol))
            m_inv = jnp.where(ok, reg, m_inv)
            chol = jnp.where(ok, new_chol, chol)
        else:
            reg = _regularized_variance(cov, n)
            m_inv = jnp.where(wend & (n > 1), reg, m_inv)
        wf = jax.tree.map(lambda a: jnp.where(wend, jnp.zeros_like(a), a), wf)
        da_reset = _da_init(jnp.exp(da.log_eps), dtype)
        da = jax.tree.map(lambda r, o: jnp.where(wend, r, o), da_reset, da)

        return (q, logp, grad, da, wf, m_inv, chol, key), info

    def warm_step(carry, xs):
        # warmup: keep only scalar diagnostics, never stack draws (large
        # batches would otherwise hold warmup positions in HBM for nothing)
        carry, info = step(carry, xs)
        return carry, info.diverging

    def sample_step(carry, xs):
        carry, info = step(carry, xs)
        q, logp = carry[0], carry[1]
        out = (q, logp, info.accept_prob, info.diverging, info.n_leapfrog,
               info.energy, info.tree_depth)
        return carry, out

    carry0 = (q0, logp0, grad0, da0, wf0, m_inv0, chol0, key)
    carry, warm_div = jax.lax.scan(
        warm_step, carry0,
        (in_warm[:warmup], in_slow[:warmup], win_end[:warmup]))
    carry, outs = jax.lax.scan(
        sample_step, carry,
        (in_warm[warmup:], in_slow[warmup:], win_end[warmup:]))
    qs, logps, accept, div, n_leap, energy, depth = outs
    info = {
        "logp": logps,
        "accept_prob": accept,
        "diverging": div,
        "n_leapfrog": n_leap,
        "energy": energy,
        "step_size": jnp.exp(carry[3].log_eps_bar),
        "inv_mass": carry[5],
        "warmup_diverging": warm_div,
    }
    return qs, info
