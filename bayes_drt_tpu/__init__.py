"""bayes_drt_tpu: batched (JAX/XLA) hierarchical Bayesian DRT/DDT inversion.

A from-scratch rebuild of the capabilities of jdhuang-csm/bayes-drt
designed for accelerators:

- RBF kernel matrices (A', A'', L, M) built as vectorized XLA quadrature
  (reference: bayes_drt/matrices.py).
- The Stan hierarchical error model (reference: bayes_drt/stan_model_files/)
  re-implemented as a pure-JAX log posterior.
- MAP fits via jitted L-BFGS (reference: pystan model.optimizing,
  inversion.py:1216) and full posteriors via a from-scratch NUTS sampler
  (reference: pystan model.sampling, inversion.py:1218) — both vmappable over
  chains and spectra for massively batched inversion.
- cvxopt's cone-QP (reference: inversion.py:1043-1067) replaced by a jitted,
  batched ADMM box-QP solver.
"""

from .inverter import Inverter
from .ops.matrices import construct_A, construct_L, construct_M, get_tau_basis
from .ops.basis import get_basis_func
from . import ecm, sim

__version__ = "0.1.0"

__all__ = [
    "Inverter",
    "construct_A",
    "construct_L",
    "construct_M",
    "get_tau_basis",
    "get_basis_func",
    "ecm",
    "sim",
    "__version__",
]
