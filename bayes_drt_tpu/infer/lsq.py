"""Bounded nonlinear least squares in pure JAX (Levenberg-Marquardt with
smooth bound transforms).

Replaces scipy.optimize.least_squares in the peak-fitting path (reference:
bayes_drt/peak_fit.py:124,191,263,308,378,456) with a jittable, vmappable
solver — so HN peak decomposition can run batched over thousands of
recovered distributions on an accelerator.

Bounds are enforced by smooth reparameterization:
  (lb, ub) finite  -> x = lb + (ub-lb)*sigmoid(u)
  (lb, inf)        -> x = lb + softplus(u)
  (-inf, ub)       -> x = ub - softplus(u)
  (-inf, inf)      -> x = u
then plain LM runs in u-space with autodiff Jacobians.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from ..progcache import precise_matmuls


def _softplus(u):
    return jnp.logaddexp(u, 0.0)


def _inv_softplus(x):
    x = jnp.clip(x, 1e-10, None)
    return jnp.where(x > 30.0, x, jnp.log(jnp.expm1(x)))


def make_bound_transform(lb, ub):
    """Returns (to_x, to_u): smooth maps between bounded x and free u."""
    lb = jnp.asarray(lb, float)
    ub = jnp.asarray(ub, float)
    two_sided = jnp.isfinite(lb) & jnp.isfinite(ub)
    lower_only = jnp.isfinite(lb) & ~jnp.isfinite(ub)
    upper_only = ~jnp.isfinite(lb) & jnp.isfinite(ub)

    lb_s = jnp.where(jnp.isfinite(lb), lb, 0.0)
    ub_s = jnp.where(jnp.isfinite(ub), ub, 1.0)
    width = jnp.where(two_sided, ub_s - lb_s, 1.0)

    def to_x(u):
        x2 = lb_s + width * jax.nn.sigmoid(u)
        xl = lb_s + _softplus(u)
        xu = ub_s - _softplus(u)
        return jnp.where(two_sided, x2,
                         jnp.where(lower_only, xl,
                                   jnp.where(upper_only, xu, u)))

    def to_u(x):
        frac = jnp.clip((x - lb_s) / width, 1e-7, 1.0 - 1e-7)
        u2 = jnp.log(frac) - jnp.log1p(-frac)
        ul = _inv_softplus(x - lb_s)
        uu = _inv_softplus(ub_s - x)
        return jnp.where(two_sided, u2,
                         jnp.where(lower_only, ul,
                                   jnp.where(upper_only, uu, x)))

    return to_x, to_u


class LsqResult(NamedTuple):
    x: jax.Array
    cost: jax.Array
    n_iter: jax.Array
    grad_norm: jax.Array


@partial(jax.jit, static_argnames=("residual_fn", "max_iter"))
@precise_matmuls
def bounded_lm(residual_fn: Callable, x0, lb, ub, max_iter: int = 200,
               xtol: float = 1e-10, gtol: float = 1e-10,
               lam0: float = 1e-3) -> LsqResult:
    """Minimize 0.5*||residual_fn(x)||^2 subject to lb <= x <= ub."""
    to_x, to_u = make_bound_transform(lb, ub)
    # nudge the start strictly inside the bounds
    x0 = jnp.clip(jnp.asarray(x0, float),
                  jnp.asarray(lb, float) + 1e-8, jnp.asarray(ub, float) - 1e-8)
    u0 = to_u(x0)

    def res_u(u):
        return residual_fn(to_x(u))

    def cost_of(u):
        r = res_u(u)
        return 0.5 * jnp.sum(r * r)

    def body(state):
        u, lam, cost, _, it = state
        r = res_u(u)
        J = jax.jacfwd(res_u)(u)
        g = J.T @ r
        H = J.T @ J
        d = jnp.diagonal(H)
        d = jnp.where(d > 1e-12, d, 1.0)

        def try_step(lam_try):
            du = jnp.linalg.solve(H + lam_try * jnp.diag(d), -g)
            return u + du

        # one accept/reject with adaptive damping (two candidate lambdas)
        u_a = try_step(lam)
        c_a = cost_of(u_a)
        u_b = try_step(lam * 10.0)
        c_b = cost_of(u_b)

        improved_a = c_a < cost
        improved_b = c_b < cost
        u_new = jnp.where(improved_a, u_a, jnp.where(improved_b, u_b, u))
        c_new = jnp.where(improved_a, c_a, jnp.where(improved_b, c_b, cost))
        lam_new = jnp.where(improved_a, lam * 0.3,
                            jnp.where(improved_b, lam * 3.0, lam * 30.0))
        lam_new = jnp.clip(lam_new, 1e-12, 1e12)
        gnorm = jnp.max(jnp.abs(g))
        return u_new, lam_new, c_new, gnorm, it + 1

    def cond(state):
        u, lam, cost, gnorm, it = state
        return (it < max_iter) & (gnorm > gtol) & (lam < 1e11)

    init = (u0, jnp.asarray(lam0), cost_of(u0), jnp.asarray(jnp.inf),
            jnp.asarray(0, jnp.int32))
    u, lam, cost, gnorm, it = jax.lax.while_loop(cond, body, init)
    return LsqResult(x=to_x(u), cost=cost, n_iter=it, grad_norm=gnorm)
