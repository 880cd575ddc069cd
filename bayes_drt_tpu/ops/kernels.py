"""Impedance kernels K(y, omega, tau) for DRT and DDT distributions.

The reference defines these as scalar closures fed to scipy quadrature
(reference: bayes_drt/matrices.py:27-117). Here they are vectorized jnp
functions evaluated on broadcast (N, K, Q) grids so the quadrature becomes a
single fused XLA contraction. Numerically-sensitive forms (sech, small-|x|
diffusion impedances) use stable rewrites/series so the kernels stay accurate
in float32 on an accelerator, not just float64.
"""

from __future__ import annotations

import jax.numpy as jnp


def _stable_sech(u):
    """sech(u) = 2 e^{-|u|} / (1 + e^{-2|u|}), overflow-free for any real u."""
    a = jnp.abs(u)
    e = jnp.exp(-a)
    return 2.0 * e / (1.0 + e * e)


def drt_real_kernel(y, s):
    """Re kernel for a series DRT: 1 / (1 + e^{2(y+s)}) with s = ln(w*tau).

    Equivalent to the reference integrand (matrices.py:48-49) but written as a
    logistic sigmoid so it never overflows.
    """
    u = y + s
    return 1.0 / (1.0 + jnp.exp(2.0 * jnp.clip(u, -40.0, 40.0)))


def drt_imag_kernel(y, s):
    """Im kernel for a series DRT: -e^{y} w tau / (1 + e^{2(y+s)}) = -sech(y+s)/2.

    The reference form (matrices.py:51-52) algebraically reduces to
    -0.5*sech(y+s); we use the stable sech.
    """
    return -0.5 * _stable_sech(y + s)


# ---------------------------------------------------------------------------
# Diffusion impedances Z_D(x), x = sqrt(tau e^y (k_ct + j w)) (or sqrt(j w tau e^y))
# (reference: matrices.py:59-94). Small-|x| forms use series in z = x^2 to avoid
# catastrophic cancellation (important for float32 evaluation).
# ---------------------------------------------------------------------------

_SMALL_Z = 0.03


def _tanh_clip(x):
    # tanh(a+bi) == 1 to machine precision for a > ~20; clipping the real part
    # avoids overflow inside the complex tanh evaluation.
    return jnp.tanh(jnp.clip(x.real, -30.0, 30.0) + 1j * x.imag)


# tanh(x)/x = sum c_k z^k, z = x^2
_TANH_COEF = (1.0, -1.0 / 3.0, 2.0 / 15.0, -17.0 / 315.0, 62.0 / 2835.0,
              -1382.0 / 155925.0, 21844.0 / 6081075.0)


def _T_series(z):
    """tanh(x)/x as a series in z = x^2 (|z| small)."""
    acc = jnp.full_like(z, _TANH_COEF[-1])
    for c in _TANH_COEF[-2::-1]:
        acc = acc * z + c
    return acc


def _S_series(z):
    """(x - tanh(x))/x = 1 - tanh(x)/x as a series in z = x^2 (|z| small)."""
    acc = jnp.full_like(z, -_TANH_COEF[-1])
    for c in _TANH_COEF[-2:0:-1]:
        acc = acc * z - c
    return acc * z


def zd_transmissive_planar(x):
    """Z_D = tanh(x)/x (reference: matrices.py:83-92)."""
    z = x * x
    small = jnp.abs(z) < _SMALL_Z
    # guard the direct branch against x == 0
    x_safe = jnp.where(small, jnp.ones_like(x), x)
    return jnp.where(small, _T_series(z), _tanh_clip(x_safe) / x_safe)


def zd_blocking_planar(x):
    """Z_D = coth(x)/x = 1/(x tanh x) (reference: matrices.py:59-70)."""
    z = x * x
    small = jnp.abs(z) < _SMALL_Z
    x_safe = jnp.where(small, jnp.ones_like(x), x)
    z_safe = jnp.where(jnp.abs(z) == 0, jnp.full_like(z, _SMALL_Z), z)
    direct = 1.0 / (x_safe * _tanh_clip(x_safe))
    series = 1.0 / (z_safe * _T_series(z_safe))
    return jnp.where(small, series, direct)


def zd_blocking_spherical(x):
    """Z_D = tanh(x)/(x - tanh(x)) (reference: matrices.py:72-80)."""
    z = x * x
    small = jnp.abs(z) < _SMALL_Z
    x_safe = jnp.where(small, jnp.ones_like(x), x)
    z_safe = jnp.where(jnp.abs(z) == 0, jnp.full_like(z, _SMALL_Z), z)
    t = _tanh_clip(x_safe)
    direct = t / (x_safe - t)
    series = _T_series(z_safe) / _S_series(z_safe)
    return jnp.where(small, series, direct)


_ZD_FUNCS = {
    ("blocking", "planar"): zd_blocking_planar,
    ("blocking", "spherical"): zd_blocking_spherical,
    ("transmissive", "planar"): zd_transmissive_planar,
}


def get_zd_func(bc: str, symmetry: str):
    try:
        return _ZD_FUNCS[(bc, symmetry)]
    except KeyError:
        raise ValueError(
            f"Invalid (bc={bc!r}, symmetry={symmetry!r}). Options: "
            "blocking/planar, blocking/spherical, transmissive/planar"
        )


def ddt_kernel(y, omega, tau, part: str, dist_type: str, symmetry: str, bc: str,
               ct: bool = False, k_ct=None):
    """DDT kernel value (without the basis function factor).

    x = sqrt(tau e^y (k_ct + j w)) when ct else sqrt(j w tau e^y); series
    distributions integrate Z_D, parallel distributions integrate Y_D = 1/Z_D
    (reference: matrices.py:97-112).
    """
    zd_func = get_zd_func(bc, symmetry)
    te_y = tau * jnp.exp(y)
    if ct:
        if k_ct is None:
            raise ValueError("k_ct must be supplied if ct==True")
        arg = te_y * (k_ct + 1j * omega)
    else:
        arg = 1j * omega * te_y
    x = jnp.sqrt(arg.astype(jnp.result_type(arg, jnp.complex64)))
    zd = zd_func(x)
    if dist_type == "parallel":
        val = 1.0 / zd
    elif dist_type == "series":
        val = zd
    else:
        raise ValueError(f"Invalid dist_type {dist_type!r}. Options are series and parallel")
    if part == "real":
        return val.real
    if part == "imag":
        return val.imag
    raise ValueError(f"Invalid part {part!r}. Options are 'real' and 'imag'")
