"""MAP estimation by jitted L-BFGS.

Replaces Stan's C++ L-BFGS (reference: pystan ``model.optimizing``,
bayes_drt/inversion.py:1216) with an optax L-BFGS + zoom line search driven
by a lax.while_loop — jittable and vmappable over chains and spectra, so
thousands of MAP fits run as one XLA program on an accelerator. ``run_lbfgs_restarts``
exploits that: the hierarchical posterior is multimodal from random inits
(Stan has the same fragility), so several restarts run in parallel and the
best optimum wins — effectively free when batched, unlike serial Stan
reruns.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from ..progcache import precise_matmuls
import optax
import optax.tree_utils as otu


class MapResult(NamedTuple):
    params: dict
    value: jax.Array      # final objective (negative log posterior)
    grad_norm: jax.Array
    n_iter: jax.Array
    converged: jax.Array


@partial(jax.jit, static_argnames=("loss_fn", "max_iter", "memory_size",
                                   "max_linesearch_steps"))
@precise_matmuls
def run_lbfgs(loss_fn: Callable, x0, max_iter: int = 4000, tol: float = 1e-8,
              ftol_rel: float = 1e-13, memory_size: int = 10,
              max_linesearch_steps: int = 40) -> MapResult:
    """Minimize ``loss_fn`` over a pytree of parameters.

    Stops on gradient infinity norm < tol (Stan's tol_grad analogue) or
    relative objective stagnation below ``ftol_rel`` (Stan's tol_rel_obj
    analogue).

    Both tolerances are floored at a multiple of the iterate dtype's
    machine eps: the f64-calibrated defaults are unreachable in float32,
    where they silently turn the while_loop into a fixed ``max_iter``-
    iteration burn (the same f32-tolerance bug class as the box-QP
    KKT tolerance).
    """
    eps = jnp.finfo(jax.tree.leaves(x0)[0].dtype).eps
    tol = jnp.maximum(tol, 50.0 * eps)
    ftol_rel = jnp.maximum(ftol_rel, 10.0 * eps)
    opt = optax.lbfgs(
        memory_size=memory_size,
        linesearch=optax.scale_by_zoom_linesearch(
            max_linesearch_steps=max_linesearch_steps,
            initial_guess_strategy="one"),
    )
    value_and_grad = optax.value_and_grad_from_state(loss_fn)

    def step(carry):
        params, state, _, _ = carry
        value, grad = value_and_grad(params, state=state)
        updates, state = opt.update(grad, state, params, value=value,
                                    grad=grad, value_fn=loss_fn)
        params = optax.apply_updates(params, updates)
        gnorm = otu.tree_norm(grad, ord=jnp.inf)
        return params, state, value, gnorm

    def cond(carry):
        params, state, prev_value, gnorm = carry
        it = otu.tree_get(state, "count")
        value = otu.tree_get(state, "value")
        grad_large = gnorm > tol
        df = prev_value - value
        stagnant = jnp.logical_and(it > 2,
                                   df < ftol_rel * (jnp.abs(value) + 1.0))
        return jnp.logical_and(it < max_iter,
                               jnp.logical_and(grad_large, ~stagnant))

    init = (x0, opt.init(x0), jnp.asarray(jnp.inf), jnp.asarray(jnp.inf))
    params, state, value, gnorm = jax.lax.while_loop(cond, step, init)
    it = otu.tree_get(state, "count")
    final_value = otu.tree_get(state, "value")
    # converged means "exited on tolerance, not on the iteration cap" —
    # a cap-bound run is not a certificate (use newton_polish for one)
    return MapResult(params=params, value=final_value, grad_norm=gnorm,
                     n_iter=it,
                     converged=jnp.isfinite(final_value) & (it < max_iter))


@partial(jax.jit, static_argnames=("loss_fn", "max_iter"))
@precise_matmuls
def newton_polish(loss_fn: Callable, x0, max_iter: int = 100,
                  tol: float = 1e-8) -> MapResult:
    """Damped (Levenberg) Newton refinement after L-BFGS.

    The unconstrained DRT posterior is only ~110-dimensional, so one full
    Hessian factorization per step is cheap, and local quadratic
    convergence turns a cap-bound L-BFGS iterate into a certified optimum
    (grad infinity norm <= tol — the convergence certificate pystan's
    ``model.optimizing`` reports via tol_grad; reference:
    inversion.py:1216). Levenberg damping (H + lam*diag scaling, accept/
    reject on the objective) keeps steps sane where the Hessian is
    indefinite away from the mode. jittable and vmappable like run_lbfgs.
    """
    from jax.flatten_util import ravel_pytree

    flat0, unravel = ravel_pytree(x0)
    eps = jnp.finfo(flat0.dtype).eps
    tol = jnp.maximum(jnp.asarray(tol, flat0.dtype), 50.0 * eps)

    def f(v):
        return loss_fn(unravel(v))

    vg = jax.value_and_grad(f)
    hess = jax.hessian(f)

    def step(carry):
        x, val, g, lam, it = carry
        h = hess(x)
        diag = jnp.maximum(jnp.abs(jnp.diagonal(h)), 1.0)
        s = jnp.linalg.solve(h + lam * jnp.diag(diag), g)
        x_new = x - s
        val_new, g_new = vg(x_new)
        ok = jnp.isfinite(val_new) & (val_new <= val)
        x = jnp.where(ok, x_new, x)
        val = jnp.where(ok, val_new, val)
        g = jnp.where(ok, g_new, g)
        lam = jnp.where(ok, jnp.maximum(lam / 3.0, 1e-12), lam * 10.0)
        return x, val, g, lam, it + 1

    def cond(carry):
        x, val, g, lam, it = carry
        return ((it < max_iter)
                & (jnp.linalg.norm(g, ord=jnp.inf) > tol)
                & (lam < 1e10))

    val0, g0 = vg(flat0)
    init = (flat0, val0, g0, jnp.asarray(1e-3, flat0.dtype),
            jnp.asarray(0, jnp.int32))
    x, val, g, lam, it = jax.lax.while_loop(cond, step, init)
    gnorm = jnp.linalg.norm(g, ord=jnp.inf)
    return MapResult(params=unravel(x), value=val, grad_norm=gnorm,
                     n_iter=it, converged=jnp.isfinite(val) & (gnorm <= tol))


def run_lbfgs_restarts(loss_fn: Callable, init_fn: Callable, key, n_restarts: int,
                       max_iter: int = 4000, **kw) -> MapResult:
    """Run ``n_restarts`` L-BFGS fits from ``init_fn(key_i)`` inits in
    parallel (vmap) and return the best optimum.

    The multimodality mitigation the reference gets from hand-tuned ridge
    initialization (reference: inversion.py:1154-1160) — done by batching.
    """
    keys = jax.random.split(key, n_restarts)
    x0s = jax.vmap(init_fn)(keys)
    results = jax.vmap(lambda x0: run_lbfgs(loss_fn, x0, max_iter=max_iter, **kw))(x0s)
    values = jnp.where(jnp.isfinite(results.value), results.value, jnp.inf)
    best = jnp.argmin(values)
    return jax.tree.map(lambda a: a[best], results)
