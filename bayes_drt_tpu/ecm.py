"""Equivalent-circuit model (ECM) fitting.

The reference's legacy utility module fits equivalent circuits directly to
impedance data (reference: code_EchemActa/bayes-drt_20201113/eis_utils.py,
``fit_ec_model``/``fit_var_RC``). This module provides that capability on
the JAX stack: circuits are composed from the elements in ``sim`` and
fit with the jitted bounded Levenberg-Marquardt (infer/lsq.py) — vmappable
over batches of spectra.

A circuit is a list of (element, init_params) pairs, summed in series:

    circuit = [("R", {"R": 1.0}),
               ("ZARC", {"R": 1.0, "tau": 1e-3, "phi": 0.8}),
               ("L", {"L": 1e-7})]
    result = fit_ecm(freq, Z, circuit)
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from .infer.lsq import bounded_lm

# element -> (param names, lower bounds, upper bounds, log-scale flags)
ELEMENTS = {
    "R": (("R",), (0.0,), (np.inf,), (True,)),
    "L": (("L",), (0.0,), (np.inf,), (True,)),
    "C": (("C",), (0.0,), (np.inf,), (True,)),
    "RC": (("R", "tau"), (0.0, 0.0), (np.inf, np.inf), (True, True)),
    "ZARC": (("R", "tau", "phi"), (0.0, 0.0, 0.0), (np.inf, np.inf, 1.0),
             (True, True, False)),
    "Gerischer": (("R", "tau"), (0.0, 0.0), (np.inf, np.inf), (True, True)),
    "HN": (("R", "tau", "alpha", "beta"), (0.0, 0.0, 0.0, 0.0),
           (np.inf, np.inf, 1.0, 1.0), (True, True, False, False)),
}


def _element_z(name, params, omega):
    if name == "R":
        return params[0] * jnp.ones_like(omega, dtype=complex)
    if name == "L":
        return 1j * omega * params[0]
    if name == "C":
        return 1.0 / (1j * omega * params[0])
    if name == "RC":
        return params[0] / (1 + 1j * omega * params[1])
    if name == "ZARC":
        return params[0] / (1 + (1j * omega * params[1]) ** params[2])
    if name == "Gerischer":
        return params[0] / jnp.sqrt(1 + 1j * omega * params[1])
    if name == "HN":
        return params[0] / (1 + (1j * omega * params[1]) ** params[3]) ** params[2]
    raise ValueError(f"Unknown element {name!r}. Options: {sorted(ELEMENTS)}")


def ecm_impedance(circuit, freq, x=None):
    """Impedance of a series-connected circuit. ``x`` optionally overrides the
    flattened parameter vector (log-scale for positive-scale params)."""
    omega = 2 * jnp.pi * jnp.asarray(freq, float)
    z = jnp.zeros(len(omega), dtype=complex)
    idx = 0
    for name, init in circuit:
        names, _, _, logs = ELEMENTS[name]
        if x is None:
            params = [init[k] for k in names]
        else:
            params = []
            for k, is_log in zip(names, logs):
                v = x[idx]
                params.append(jnp.exp(v) if is_log else v)
                idx += 1
        z = z + _element_z(name, params, omega)
    return z


def fit_ecm(freq, Z, circuit, weights="modulus", max_iter=300):
    """Fit a series equivalent circuit to impedance data.

    Returns dict with per-element fitted parameters, the impedance residual,
    and chi-square. Positive-scale parameters are optimized in log space.
    """
    freq = np.asarray(freq, float)
    Z = np.asarray(Z)
    x0, lb, ub = [], [], []
    for name, init in circuit:
        names, lbs, ubs, logs = ELEMENTS[name]
        for k, lo, hi, is_log in zip(names, lbs, ubs, logs):
            v = float(init[k])
            if is_log:
                x0.append(np.log(max(v, 1e-12)))
                lb.append(-30.0)
                ub.append(30.0)
            else:
                x0.append(v)
                lb.append(lo)
                ub.append(hi)
    x0, lb, ub = map(np.asarray, (x0, lb, ub))

    if weights == "modulus":
        w = 1.0 / np.abs(Z)
    elif weights in (None, "unity"):
        w = np.ones(len(Z))
    else:
        raise ValueError(f"Invalid weights {weights!r}")
    w_j = jnp.asarray(np.concatenate([w, w]))
    z_flat = jnp.asarray(np.concatenate([Z.real, Z.imag]))
    freq_j = jnp.asarray(freq)

    def residuals(x):
        z_fit = ecm_impedance(circuit, freq_j, x)
        return (jnp.concatenate([z_fit.real, z_fit.imag]) - z_flat) * w_j

    res = bounded_lm(residuals, jnp.asarray(x0), jnp.asarray(lb),
                     jnp.asarray(ub), max_iter=max_iter)
    x = np.asarray(res.x)

    fitted = []
    idx = 0
    for name, init in circuit:
        names, _, _, logs = ELEMENTS[name]
        params = {}
        for k, is_log in zip(names, logs):
            params[k] = float(np.exp(x[idx]) if is_log else x[idx])
            idx += 1
        fitted.append((name, params))

    z_fit = np.asarray(ecm_impedance(circuit, freq, jnp.asarray(x)))
    chi_sq = float(np.sum((np.abs(z_fit - Z) * w) ** 2) / len(freq))
    return {"circuit": fitted, "x": x, "Z_fit": z_fit, "chi_sq": chi_sq,
            "cost": float(res.cost)}


def estimate_hfr(freq, Z):
    """High-frequency resistance estimate: interpolate Z' at the Z''=0
    crossing, or extrapolate from the highest frequencies (legacy
    eis_utils HFR estimation)."""
    freq = np.asarray(freq, float)
    Z = np.asarray(Z)
    order = np.argsort(freq)[::-1]
    zi = Z.imag[order]
    zr = Z.real[order]
    sign_change = np.where(np.diff(np.sign(zi)) != 0)[0]
    if len(sign_change):
        i = sign_change[0]
        t = -zi[i] / (zi[i + 1] - zi[i])
        return float(zr[i] + t * (zr[i + 1] - zr[i]))
    return float(zr[0])
