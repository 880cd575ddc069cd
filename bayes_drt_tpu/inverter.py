"""Inverter: the user-facing API, mirroring the reference's surface
(reference: bayes_drt/inversion.py class Inverter) on top of the batched
JAX engine.

Host code (numpy) orchestrates; all numerics run through the jitted
kernels in ops/ (matrix construction), infer/ (QP, ridge, L-BFGS, NUTS), and
models/ (the hierarchical posterior).
"""

from __future__ import annotations

import warnings
from copy import deepcopy

import numpy as np

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from .ops.matrices import construct_A, construct_L, construct_M, default_epsilon, get_tau_basis
from .ops.basis import get_basis_func
from .infer.ridge import (HyperLambdaConfig, RidgeData, run_hyper_lambda,
                          run_hyper_weights, run_ordinary_ridge)
from .infer.map import newton_polish, run_lbfgs, run_lbfgs_restarts
from .infer.chees import (ChEESConfig, SHMCConfig, sample_chees,
                          sample_shmc)
from .infer.nuts import NUTSConfig, sample_nuts
from .infer import diagnostics as mcmc_diagnostics
from .models.build import build_posterior, sort_distributions, z_scale_for
from .models.posterior import (PosteriorData, constrain, init_unconstrained,
                               log_density, predict_target, sigma_tot)
from .progcache import cached_program, data_shapes
from .utils import check_equality, get_outlier_thresh, r2_score, rel_round


class Inverter:
    """EIS -> DRT/DDT inversion engine (API-compatible with the reference's
    ``Inverter``, reference: inversion.py:28-64)."""

    def __init__(self, basis_freq=None, basis="gaussian", epsilon=None,
                 fit_inductance=True, distributions=None):
        if distributions is None:
            distributions = {"DRT": {"kernel": "DRT"}}
        self._recalc_mat = True
        self.distribution_matrices = {}
        self.set_basis_freq(basis_freq)
        self.set_basis(basis)
        self.set_epsilon(epsilon)
        self.set_fit_inductance(fit_inductance)
        self.set_distributions(distributions)
        self._cached_distributions = deepcopy(self.distributions)
        self.f_train = np.array([0.0])
        self.Z_train = None
        self.t_train = None   # measurement times (drift fits only)
        self.f_pred = None
        self.prediction_matrices = {}
        self._Z_scale = 1.0
        self._init_params = {}
        self.distribution_fits = {}
        self.error_fit = {}
        self._iter_history = None
        self.fit_type = None
        self.cv_result = None
        self._sample_result = None
        self._opt_result = None
        self.sample_diagnostics = None

    # --- configuration properties (cache invalidation mirrors
    #     inversion.py:4069-4110) ---------------------------------------

    def set_basis_freq(self, basis_freq):
        self._basis_freq = None if basis_freq is None else np.asarray(basis_freq, float)
        self._recalc_mat = True
        self.f_pred = None

    def get_basis_freq(self):
        return self._basis_freq

    basis_freq = property(get_basis_freq, set_basis_freq)

    def set_basis(self, basis):
        get_basis_func(basis)  # validate
        self._basis = basis
        self._recalc_mat = True
        self.f_pred = None

    def get_basis(self):
        return self._basis

    basis = property(get_basis, set_basis)

    def set_epsilon(self, epsilon):
        self._epsilon = epsilon
        self._recalc_mat = True
        self.f_pred = None

    def get_epsilon(self):
        return self._epsilon

    epsilon = property(get_epsilon, set_epsilon)

    def set_fit_inductance(self, fit_inductance):
        self._fit_inductance = bool(fit_inductance)

    def get_fit_inductance(self):
        return self._fit_inductance

    fit_inductance = property(get_fit_inductance, set_fit_inductance)

    def set_distributions(self, distributions):
        """Validate/normalize the distributions mini-DSL
        (reference: inversion.py:66-131)."""
        distributions = deepcopy(distributions)
        for name, info in distributions.items():
            if info.get("kernel") not in ("DRT", "DDT"):
                raise ValueError(f"Invalid kernel {info.get('kernel')!r} for "
                                 f"distribution '{name}'. Options are DRT, DDT")
            if info["kernel"] == "DRT":
                if info.get("dist_type", "series") != "series":
                    warnings.warn(
                        f"dist_type for DRT kernel must be series. Overwriting "
                        f"supplied dist_type {info['dist_type']!r} for "
                        f"distribution '{name}' with 'series'")
                info["dist_type"] = "series"
                invalid = set(info) & {"symmetry", "bc", "ct", "k_ct"}
                if invalid:
                    warnings.warn(f"The following keys are invalid for "
                                  f"distribution '{name}': {sorted(invalid)}. "
                                  f"These keys will be ignored")
            else:
                if info.get("dist_type", "parallel") not in ("series", "parallel"):
                    raise ValueError(f"Invalid dist_type {info.get('dist_type')!r} "
                                     f"for distribution '{name}'")
                if info.get("symmetry", "planar") not in ("planar", "spherical"):
                    raise ValueError(f"Invalid symmetry {info.get('symmetry')!r} "
                                     f"for distribution '{name}'")
                if info.get("bc", "transmissive") not in ("transmissive", "blocking"):
                    raise ValueError(f"Invalid bc {info.get('bc')!r} for "
                                     f"distribution '{name}'")
                if info.get("ct", False) not in (True, False):
                    raise ValueError(f"Invalid ct {info.get('ct')!r} for "
                                     f"distribution '{name}'")
                if info.get("ct", False) and "k_ct" not in info:
                    raise ValueError(f"k_ct must be supplied for distribution "
                                     f"'{name}' if ct==True")
                defaults = {"dist_type": "parallel", "symmetry": "planar",
                            "bc": "blocking", "ct": False}
                defaults.update(info)
                distributions[name] = defaults
            self.distribution_matrices.setdefault(name, {})
        self._distributions = distributions
        self._recalc_mat = True
        self.f_pred = None

    def get_distributions(self):
        return self._distributions

    distributions = property(get_distributions, set_distributions)

    # --- scaling (reference: inversion.py:2411-2450) --------------------

    def _scale_Z(self, Z, fit_type):
        self._Z_scale = float(z_scale_for(self.distributions, Z, fit_type))
        return Z / self._Z_scale

    def _rescale_coef(self, coef, dist_type):
        if dist_type == "parallel":
            return coef / self._Z_scale
        return coef * self._Z_scale

    # --- weights (reference: inversion.py:2338-2395) --------------------

    def _format_weights(self, frequencies, Z, weights, part):
        if weights is None or (isinstance(weights, str) and weights == "unity"):
            weights = np.ones(len(frequencies)) * (1 + 1j)
        elif isinstance(weights, str):
            if weights == "modulus":
                weights = (1 + 1j) / np.abs(Z)
            elif weights == "Orazem":
                weights = (1 + 1j) / (np.abs(Z.real) + np.abs(Z.imag))
            elif weights == "proportional":
                weights = 1 / np.abs(Z.real) + 1j / np.abs(Z.imag)
            elif weights == "prop_adj":
                zmod2 = np.real(Z * Z.conjugate())
                q25 = np.percentile(zmod2, 25)
                weights = 1 / (np.abs(Z.real) + q25) + 1j / (np.abs(Z.imag) + q25)
            else:
                raise ValueError(
                    f"Invalid weights argument {weights!r}. String options are "
                    "'unity', 'modulus', 'Orazem', 'proportional', and 'prop_adj'")
        elif isinstance(weights, (float, int)):
            weights = np.ones(len(frequencies)) * (1 + 1j) * weights
        elif isinstance(weights, complex):
            weights = np.ones(len(frequencies)) * weights
        else:
            weights = np.asarray(weights)
            if len(weights) != len(frequencies):
                raise ValueError("Weights array must match length of data")

        weights = np.asarray(weights)
        if part == "both":
            if np.isreal(weights).all():
                weights = weights + 1j * weights
        elif part == "real":
            weights = np.real(weights) + 1j * np.ones(len(frequencies))
        elif part == "imag":
            if np.isreal(weights).all():
                weights = np.ones(len(frequencies)) + 1j * weights
        else:
            raise ValueError(f"Invalid part {part!r}. Options are 'both', "
                             "'real', or 'imag'")
        return weights

    # --- matrix preparation (reference: inversion.py:2127-2336) ---------

    def _dist_tau_epsilon(self, name, frequencies):
        info = self.distributions[name]
        basis_freq = info.get("basis_freq", self.basis_freq)
        if basis_freq is None:
            tau = get_tau_basis(frequencies)
        else:
            tau = 1.0 / (2 * np.pi * np.asarray(basis_freq, float))
        eps = info.get("epsilon", self.epsilon)
        if eps is None:
            eps = default_epsilon(tau)
        return tau, eps

    def _prep_matrices(self, frequencies, Z, part, weights, scale_Z, penalty,
                       fit_type, dZ=False):
        frequencies = np.asarray(frequencies, float)
        Z = np.asarray(Z)
        if len(frequencies) != len(Z):
            raise ValueError("Length of frequencies and Z must be equal")

        sort_idx = np.argsort(frequencies)[::-1]
        frequencies = frequencies[sort_idx]
        Z = Z[sort_idx]
        self.Z_train = Z
        self.t_train = None

        if not check_equality(self.distributions, self._cached_distributions):
            self._recalc_mat = True
            self.f_pred = None

        if not np.array_equal(rel_round(self.f_train, 10),
                              rel_round(frequencies, 10)):
            self.f_train = frequencies
            self._recalc_mat = True

        if scale_Z:
            Z_scaled = self._scale_Z(Z, fit_type)
            if isinstance(weights, (list, np.ndarray)):
                weights = np.asarray(weights) / self._Z_scale
        else:
            self._Z_scale = 1.0
            Z_scaled = Z

        w = self._format_weights(frequencies, Z_scaled, weights, part)

        dist_mat = {}
        for name, info in self.distributions.items():
            tau, eps = self._dist_tau_epsilon(name, frequencies)
            self.distributions[name]["tau"] = tau
            self.distributions[name]["epsilon"] = eps
            mats = self.distribution_matrices[name]

            if self._recalc_mat or "A_re" not in mats:
                kw = dict(tau=tau, basis=self.basis, epsilon=eps,
                          kernel=info["kernel"], dist_type=info["dist_type"],
                          symmetry=info.get("symmetry", "planar"),
                          bc=info.get("bc", "transmissive"),
                          ct=info.get("ct", False), k_ct=info.get("k_ct", None))
                mats["A_re"] = np.asarray(construct_A(frequencies, "real", **kw))
                mats["A_im"] = np.asarray(construct_A(frequencies, "imag", **kw))

            f_coll = 1.0 / (2 * np.pi * tau)
            if penalty == "integral":
                for order in (0, 1, 2):
                    mats[f"M{order}"] = np.asarray(
                        construct_M(f_coll, basis=self.basis, order=order, epsilon=eps))
            else:
                for order in (0, 1, 2):
                    mats[f"L{order}"] = np.asarray(
                        construct_L(f_coll, tau=tau, basis=self.basis,
                                    epsilon=eps, order=order))
            if penalty == "cholesky":
                import scipy.linalg
                for order in (0, 1, 2):
                    M = np.asarray(construct_M(f_coll, basis=self.basis,
                                               order=order, epsilon=eps))
                    mats[f"M{order}"] = M
                    mats[f"L{order}"] = scipy.linalg.cholesky(M)

            if dZ and info["kernel"] == "DRT" and "B" not in mats:
                # dZ'/dlntau differentiation matrix (reference: inversion.py:2273-2285)
                dlnt = np.mean(np.diff(np.log(tau)))
                b_tau = np.logspace(np.log10(np.exp(np.log(tau[0]) - dlnt / 2)),
                                    np.log10(np.exp(np.log(tau[-1]) + dlnt / 2)),
                                    len(tau) + 1)
                B_pre = np.asarray(construct_A(
                    1.0 / (2 * np.pi * b_tau), "real", tau=tau, basis=self.basis,
                    epsilon=eps, kernel=info["kernel"], dist_type=info["dist_type"],
                    symmetry=info.get("symmetry", "planar"),
                    bc=info.get("bc", "transmissive"), ct=info.get("ct", False),
                    k_ct=info.get("k_ct", None)))
                mats["B"] = B_pre[1:, :] - B_pre[:-1, :]

            dist_mat[name] = dict(mats)

        self._recalc_mat = False
        self._cached_distributions = deepcopy(self.distributions)
        return frequencies, Z_scaled, w, dist_mat

    # ===================================================================
    # Ridge fits (reference: inversion.py:142-945)
    # ===================================================================

    def ridge_fit(self, frequencies, Z, part="both", penalty="discrete",
                  reg_ord=2, L1_penalty=0, scale_Z=True, nonneg=True,
                  weights=None, preset=None,
                  hyper_lambda=True, hl_solution="analytic", hl_beta=2.5,
                  hl_fbeta=None, lambda_0=1e-2,
                  cv_lambdas=np.logspace(-10, 5, 31),
                  hyper_weights=False, hw_beta=2, hw_wbar=1,
                  xtol=1e-3, max_iter=20,
                  hyper_a=False, alpha_a=2, hl_beta_a=2, hyper_b=False, sb=1,
                  correct_phase_offset=False, IERange=None, lambda_phz=1,
                  init_phase_offset=False,
                  x0=None, dZ=False, dZ_power=0.5):
        """Ridge / hierarchical-ridge fit of a single distribution
        (reference: inversion.py:142-900)."""
        if correct_phase_offset:
            if IERange is None:
                raise ValueError("IERange must be provided if "
                                 "correct_phase_offset==True")
            return self._ridge_fit_phase_offset(
                frequencies, Z, IERange, lambda_phz, init_phase_offset,
                part=part, penalty=penalty, reg_ord=reg_ord,
                L1_penalty=L1_penalty, scale_Z=scale_Z, nonneg=nonneg,
                weights=weights, preset=preset, hyper_lambda=hyper_lambda,
                hl_beta=hl_beta, hl_fbeta=hl_fbeta, lambda_0=lambda_0,
                xtol=xtol, max_iter=max_iter, x0=x0)
        if preset is not None:
            if preset == "Ciucci":
                penalty, lambda_0, hl_fbeta = "discrete", "cv", 0.1
            elif preset == "Huang":
                penalty, hl_beta, lambda_0, weights = "integral", 2.5, 1e-2, "modulus"
            else:
                raise ValueError(f"Invalid preset {preset!r}. Options are "
                                 "['Ciucci', 'Huang']")

        if penalty in ("discrete", "cholesky"):
            if np.min(hl_beta) <= 1:
                raise ValueError("hl_beta must be greater than 1 for penalty "
                                 "'cholesky' and 'discrete'")
        elif penalty == "integral":
            if np.min(hl_beta) <= 2:
                raise ValueError("hl_beta must be greater than 2 for penalty "
                                 "'integral'")
        else:
            raise ValueError(f"Invalid penalty argument {penalty!r}. Options "
                             "are 'integral', 'discrete', and 'cholesky'")
        if hyper_lambda and hyper_weights:
            raise ValueError("hyper_lambda and hyper_weights fits cannot be "
                             "performed simultaneously")
        if len(self.distributions) > 1:
            raise ValueError("ridge_fit cannot be used to fit multiple distributions")
        if hl_solution not in ("analytic", "lm"):
            raise ValueError(f"Invalid hl_solution {hl_solution!r}")

        if isinstance(lambda_0, str) and lambda_0 == "cv":
            lambda_0 = self.ridge_ReImCV(
                frequencies, Z, lambdas=cv_lambdas, penalty=penalty,
                hyper_lambda=hyper_lambda, hl_solution="analytic",
                hl_beta=hl_beta, hl_fbeta=hl_fbeta, reg_ord=reg_ord,
                L1_penalty=L1_penalty, x0=x0, weights=weights, xtol=xtol,
                max_iter=max_iter, scale_Z=scale_Z, nonneg=nonneg, dZ=dZ,
                dZ_power=dZ_power, hyper_a=hyper_a, alpha_a=alpha_a,
                hl_beta_a=hl_beta_a, hyper_b=hyper_b, sb=sb)

        dist_name = list(self.distributions.keys())[0]
        dist_info = self.distributions[dist_name]
        if dist_info["kernel"] != "DRT" and dZ:
            warnings.warn("dZ should only be set to True for DRT recovery. "
                          "Proceeding with dZ=False")
            dZ = False

        target = np.asarray(Z) if dist_info["dist_type"] == "series" else 1.0 / np.asarray(Z)
        frequencies, target_scaled, w, dist_mat = self._prep_matrices(
            frequencies, target, part, weights, scale_Z, penalty, "ridge", dZ=dZ)
        dist_info = self.distributions[dist_name]

        if dist_info["dist_type"] == "parallel" and scale_Z:
            # rescale so that Z (not Y) is the scaled variable; avoids tiny
            # admittances being ignored in fitting (reference: inversion.py:376-382)
            Z_sorted = 1.0 / np.asarray(self.Z_train)  # Z_train holds the target (=1/Z)
            Z_scaled2 = self._scale_Z(Z_sorted, "ridge")
            target_scaled = 1.0 / Z_scaled2

        mats = dist_mat[dist_name]
        tau = dist_info["tau"]
        eps = dist_info["epsilon"]
        series = dist_info["dist_type"] == "series"
        n_fixed = 2 if series else 0
        kb = mats["A_re"].shape[1]
        k = kb + n_fixed

        A_re = np.zeros((len(frequencies), k))
        A_im = np.zeros((len(frequencies), k))
        if series:
            A_re[:, 0] = 1.0
            if self.fit_inductance:
                # inductance column scaled by 1e-4 (reference: inversion.py:415-417)
                A_im[:, 1] = 2 * np.pi * frequencies * 1e-4
        A_re[:, n_fixed:] = mats["A_re"]
        A_im[:, n_fixed:] = mats["A_im"]

        if penalty in ("integral", "cholesky"):
            L2_base = []
            for order in (0, 1, 2):
                M = np.zeros((k, k))
                M[n_fixed:, n_fixed:] = mats[f"M{order}"]
                L2_base.append(M)
            if penalty == "cholesky":
                # the discrete-form lambda updates use the Cholesky factors
                # of M as L (reference: inversion.py:2314-2317, 632-648)
                L_ops = np.array([
                    np.concatenate([np.zeros((kb, n_fixed)), mats[f"L{order}"]],
                                   axis=1)
                    for order in (0, 1, 2)])
            else:
                L_ops = np.zeros((3, kb, k))
        else:
            L_ops = []
            L2_base = []
            for order in (0, 1, 2):
                L = np.concatenate([np.zeros((kb, n_fixed)), mats[f"L{order}"]], axis=1)
                L_ops.append(L)
                L2_base.append(L.T @ L)
            L_ops = np.array(L_ops)
        L2_base = np.array(L2_base)

        if isinstance(reg_ord, (int, np.integer)):
            frac = np.zeros(3)
            frac[reg_ord] = 1.0
        else:
            frac = np.asarray(reg_ord, float)

        L1_vec = np.ones(k) * np.sqrt(np.pi) / eps * L1_penalty
        L1_vec[:n_fixed] = 0.0

        if nonneg:
            lb = np.zeros(k)
        else:
            # reference quirk: free coefficients bounded below at -10 (scaled
            # units), first two coords (R_inf, inductance) still >= 0
            # (reference: inversion.py:1058-1064)
            lb = np.full(k, -10.0)
            lb[:2] = 0.0
        ub = np.full(k, np.inf)

        w_re, w_im = np.real(w), np.imag(w)
        data = RidgeData(
            WA_re=jnp.asarray(w_re[:, None] * A_re),
            WA_im=jnp.asarray(w_im[:, None] * A_im),
            WT_re=jnp.asarray(w_re * target_scaled.real),
            WT_im=jnp.asarray(w_im * target_scaled.imag),
            L2_base=jnp.asarray(L2_base), L_ops=jnp.asarray(L_ops),
            L1_vec=jnp.asarray(L1_vec), reg_frac=jnp.asarray(frac),
            lb=jnp.asarray(lb), ub=jnp.asarray(ub))

        delta_mask = np.ones(k)
        if series and (not self.fit_inductance or part == "real"):
            delta_mask[1] = 0.0

        if hyper_lambda:
            cfg = HyperLambdaConfig(
                part=part, penalty="integral" if penalty == "integral" else "discrete",
                use_fbeta=hl_fbeta is not None,
                use_lm=(hl_solution == "lm" and penalty != "integral"),
                n_fixed=n_fixed, max_iter=max_iter, use_dZ=bool(dZ),
                use_hyper_a=hyper_a, use_hyper_b=hyper_b)
            B = None
            dZ_scale = 1.0
            if dZ:
                dlnt = np.mean(np.diff(np.log(tau)))
                B_aug = np.concatenate([np.zeros((kb, n_fixed)), mats["B"]], axis=1)
                B = jnp.asarray(B_aug)
                dZ_scale = dlnt / 0.23026
            x_init = np.full(k, 1e-6) if x0 is None else np.asarray(x0, float)
            res = run_hyper_lambda(
                cfg, data, jnp.asarray(x_init), np.broadcast_to(np.asarray(hl_beta, float), (3,)),
                float(lambda_0), hl_fbeta=float(hl_fbeta) if hl_fbeta is not None else 0.1,
                sb=np.broadcast_to(np.asarray(sb, float), (3,)),
                alpha_a=np.broadcast_to(np.asarray(alpha_a, float), (3,)),
                beta_a=np.broadcast_to(np.asarray(hl_beta_a, float), (3,)),
                B=B, dZ_scale=dZ_scale, dZ_power=dZ_power, xtol=xtol,
                delta_mask=jnp.asarray(delta_mask))
            if not bool(res.converged):
                warnings.warn(f"Hyperparametric solution did not converge within "
                              f"{max_iter} iterations")
            coef = np.array(res.coef)
            fit_info = {"coef": coef.copy(),
                        "lambda_vectors": np.asarray(res.lam_vectors),
                        "cost": float(res.cost)}
        elif hyper_weights:
            wbar = self._format_weights(frequencies, target_scaled, hw_wbar, part)
            res = run_hyper_weights(
                part, data, jnp.asarray(A_re), jnp.asarray(A_im),
                jnp.asarray(target_scaled.real), jnp.asarray(target_scaled.imag),
                float(lambda_0), float(hw_beta), jnp.asarray(np.real(wbar)),
                jnp.asarray(np.imag(wbar)), max_iter=max_iter, xtol=xtol,
                delta_mask=jnp.asarray(delta_mask))
            if not bool(res.converged):
                warnings.warn(f"Hyperparametric solution did not converge within "
                              f"{max_iter} iterations")
            coef = np.array(res.coef)
            fit_info = {"coef": coef.copy(),
                        "weights": np.asarray(res.weights_re)
                        + 1j * np.asarray(res.weights_im),
                        "cost": float(res.cost)}
        else:
            res = run_ordinary_ridge(part, data, float(lambda_0))
            coef = np.array(res.coef)
            fit_info = {"coef": coef.copy(), "cost": float(res.cost)}

        # part-specific offset recovery (reference: inversion.py:854-873)
        if series and part == "imag":
            zr_pred = A_re[:, 2:] @ coef[2:]
            coef[0] = np.mean(target_scaled.real - zr_pred)
        elif series and part == "real" and self.fit_inductance:
            zi_pred = A_im[:, 2:] @ coef[2:]
            basis_vec = 2 * np.pi * frequencies * 1e-4
            coef[1] = (basis_vec @ (target_scaled.imag - zi_pred)) / (basis_vec @ basis_vec)

        fit_info["scaled_coef"] = coef.copy()
        if scale_Z:
            coef = self._rescale_coef(coef, dist_info["dist_type"])
        if series:
            coef = np.asarray(coef, dtype=float)
            coef[1] *= 1e-4
            if not self.fit_inductance:
                coef[1] = 0.0
            self.R_inf = coef[0]
            self.inductance = coef[1]
            fit_info["coef"] = coef[2:]
        else:
            self.R_inf = 0.0
            self.inductance = 0.0
            fit_info["coef"] = np.asarray(coef, dtype=float)

        self.distribution_fits = {dist_name: fit_info}
        self.f_pred = None
        self.fit_type = "ridge"

    def _ridge_fit_phase_offset(self, frequencies, Z, IERange, lambda_phz,
                                init_phase_offset, max_iter=20, xtol=1e-3,
                                **ridge_kw):
        """Hyper-lambda ridge with hardware phase-offset correction
        (reference: inversion.py:307-341, 564-629).

        Alternates between (a) a ridge fit of the phase-adjusted data and
        (b) L1-regularized optimization of per-current-range phase offsets
        against the fitted phase. The reference interleaves the offset update
        inside its lambda iteration; alternating full passes converges to the
        same fixed point.
        """
        from scipy.optimize import minimize

        frequencies = np.asarray(frequencies, float)
        Z = np.asarray(Z)
        IERange = np.asarray(IERange)
        if len(IERange) != len(frequencies):
            raise ValueError("IERange must have same length as frequencies")

        # steps in the current range, processed low -> high frequency
        step_indices = np.where(np.diff(IERange[::-1]) != 0)[0] + 1
        step_indices = np.append(step_indices, len(frequencies))
        zphz_exp = np.angle(Z, deg=True)
        zmod = np.abs(Z)

        phase_offsets = np.zeros(len(step_indices))
        offset_vec = np.zeros(len(Z))

        if init_phase_offset:
            zphz_adj = zphz_exp.copy()[::-1]
            for i, idx in enumerate(step_indices[:-1]):
                zdiff = np.diff(zphz_adj)
                interp = (zdiff[idx - 2] + zdiff[idx]) / 2
                target = zphz_adj[idx - 1] + interp
                phase_offsets[i] = target - zphz_adj[idx]
                offset_vec[::-1][idx:step_indices[i + 1]] += phase_offsets[i]
                zphz_adj[idx:step_indices[i + 1]] += phase_offsets[i]
            zphz_cur = zphz_adj[::-1]
        else:
            zphz_cur = zphz_exp.copy()

        def apply_phase(zphz):
            return zmod * np.cos(np.radians(zphz)) + 1j * zmod * np.sin(np.radians(zphz))

        z_adj = apply_phase(zphz_cur)
        prev_offsets = phase_offsets.copy()
        for it in range(max_iter):
            self.ridge_fit(frequencies, z_adj, max_iter=max_iter,
                           xtol=xtol, **ridge_kw)
            z_pred = self.predict_Z(frequencies)
            # frequencies were sorted descending inside ridge_fit; align
            order = np.argsort(frequencies)[::-1]
            zphz_pred = np.empty(len(frequencies))
            zphz_pred[order] = np.angle(z_pred, deg=True)
            zphz_var = max(np.var(zphz_cur - zphz_pred), 1e-12)

            def cost(offsets):
                zadj = zphz_exp.copy()[::-1]
                for i, idx in enumerate(step_indices[:-1]):
                    zadj[idx:step_indices[i + 1]] += offsets[i]
                c = 0.5 * np.sum((zadj - zphz_pred[::-1]) ** 2) / zphz_var
                return c + lambda_phz * np.sum(np.abs(offsets))

            result = minimize(cost, x0=phase_offsets)
            phase_offsets = result["x"]
            zphz_new = zphz_exp.copy()[::-1]
            offset_vec = np.zeros(len(Z))
            for i, idx in enumerate(step_indices[:-1]):
                zphz_new[idx:step_indices[i + 1]] += phase_offsets[i]
                offset_vec[idx:step_indices[i + 1]] = phase_offsets[i]
            zphz_cur = zphz_new[::-1]
            offset_vec = offset_vec[::-1]
            z_adj = apply_phase(zphz_cur)
            if np.max(np.abs(phase_offsets - prev_offsets)) < xtol:
                break
            prev_offsets = phase_offsets.copy()

        # final fit on the converged adjusted data
        self.ridge_fit(frequencies, z_adj, max_iter=max_iter, xtol=xtol,
                       **ridge_kw)
        self.phase_offsets = phase_offsets
        self.phase_offset_vec = offset_vec
        self.Z_adjusted = z_adj

    def ridge_ReImCV(self, frequencies, Z, lambdas=np.logspace(-10, 5, 31), **kw):
        """Re-Im cross-validation for lambda_0 (reference: inversion.py:902-945)."""
        import pandas as pd
        recv = np.zeros(len(lambdas))
        imcv = np.zeros(len(lambdas))
        Z = np.asarray(Z)
        for i, lam in enumerate(lambdas):
            self.ridge_fit(frequencies, Z, part="real", lambda_0=float(lam), **kw)
            zi_pred = np.imag(self.predict_Z(frequencies))
            self.ridge_fit(frequencies, Z, part="imag", lambda_0=float(lam), **kw)
            zr_pred = np.real(self.predict_Z(frequencies))
            recv[i] = np.sum((Z.real - zr_pred) ** 2)
            imcv[i] = np.sum((Z.imag - zi_pred) ** 2)
        totcv = recv + imcv
        min_lam = float(lambdas[np.argmin(totcv)])
        if min_lam in (np.min(lambdas), np.max(lambdas)):
            warnings.warn(
                f"Optimal lambda_0 {min_lam} determined by Re-Im CV is at the "
                "boundary of the evaluated range. Re-run with an expanded "
                "lambda_0 range to obtain an accurate estimate.")
        self.cv_result = pd.DataFrame(
            np.array([lambdas, recv, imcv, totcv]).T,
            columns=["lambda", "recv", "imcv", "totcv"])
        return min_lam

    # ===================================================================
    # Hierarchical Bayesian fits (reference: inversion.py:1072-1289)
    # ===================================================================

    def fit(self, frequencies, Z, part="both", scale_Z=True, nonneg=False,
            outliers=False, check_outliers=True, init_from_ridge=False,
            ridge_kw=None, sigma_min=0.002, inductance_scale=1.0,
            outlier_lambda=None, mode="optimize", random_seed=1234,
            max_iter=4000, warmup=200, samples=200, chains=2,
            fitY=False, SA=False, SASY=False, n_restarts=2,
            max_tree_depth=10, adapt_delta=0.9, ncp=False,
            sampler="nuts", chees_cfg=None, shmc_cfg=None,
            add_model_data=None, log_density_fn=None, polish=True):
        """MAP (mode='optimize') or full HMC (mode='sample') fit of the
        calibrated hierarchical Bayesian model.

        ``ncp=True`` (sample mode) samples the coefficient vectors in a
        non-centered parameterization (x = ups * z with the matching
        Jacobian) — a pure change of variables targeting the SAME
        posterior, which removes the ups->x funnel and substantially
        improves mixing (lower split-Rhat) at short chain budgets.

        ``sampler`` (sample mode): 'nuts' (default, Stan-equivalent),
        'shmc' (synchronous static multinomial HMC — the fully
        batch-synchronous form, same posterior; configure via
        ``shmc_cfg``), or 'chees' (EXPERIMENTAL: adaptive jittered HMC,
        ``chees_cfg``; measured weaker than nuts/shmc on the funnel-shaped
        DRT posterior — notes in bayes_drt_tpu/experiments/__init__.py).

        Escape hatches (the reference's ``add_stan_data``/``model_str``,
        inversion.py:1143-1147):

        - ``add_model_data``: dict overriding any PosteriorData field after
          assembly (e.g. ``{"ups_alpha": 0.5, "sigma_out_lambda": 5.0}`` to
          re-tune hyperparameters, or a custom ``lik_mask``).
        - ``log_density_fn``: callable ``(cfg, data, params, jacobian) ->
          scalar`` replacing the built-in log density entirely (the
          ``model_str`` analogue: swap the probabilistic model while reusing
          matrix assembly, scaling, solvers and extraction).

        ``SA``/``SASY`` (parallel fitY only) are the reference's
        experimental row-scaling variants, marked 'for testing only' there
        (reference: inversion.py:1150-1151, 1756-1866): S = diag(1/|Y|)
        equilibrates the design-matrix rows. SA keeps the likelihood in
        unscaled admittance space (the Parallel_fitY_SA Stan model —
        algebraically identical to the plain fitY fit, a floating-point
        conditioning experiment); SASY also scales Y and fits in scaled
        space, which changes the error model (error-structure parameters
        are then in scaled-admittance units). Mutually exclusive."""
        if ridge_kw is None:
            ridge_kw = {}
        from .profiling import StageTimer
        import time as _time
        self.timings = StageTimer()

        init_values = None
        if init_from_ridge:
            if len(self.distributions) > 1:
                raise ValueError("Ridge initialization can only be performed "
                                 "for single-distribution fits")
            init_values = self._get_init_from_ridge(frequencies, Z, nonneg,
                                                    outliers, inductance_scale,
                                                    ridge_kw)
            self._init_params = init_values

        frequencies, Z_scaled, _, dist_mat = self._prep_matrices(
            frequencies, Z, part, None, scale_Z, "discrete",
            "map" if mode == "optimize" else "bayes")
        Z = self.Z_train

        if outliers == "auto":
            outlier_idx = self.check_outliers(frequencies, Z, threshold=4,
                                              use_existing_fit=init_from_ridge,
                                              **ridge_kw)
            if len(outlier_idx) > 0:
                outliers = True
                warnings.warn(
                    f"Identified likely outliers at indices "
                    f"{outlier_idx.ravel()}, f={frequencies[outlier_idx.ravel()]} "
                    "Hz. An outlier-robust error model will be used. To disable "
                    "this behavior, pass outliers=False.")
            else:
                outliers = False
            # matrices were invalidated by the internal ridge fit; rebuild
            frequencies, Z_scaled, _, dist_mat = self._prep_matrices(
                frequencies, Z, part, None, scale_Z, "discrete",
                "map" if mode == "optimize" else "bayes")

        cfg, data = build_posterior(
            self.distributions, dist_mat, frequencies, Z_scaled, mode=mode,
            part=part, nonneg=nonneg, outliers=bool(outliers), fitY=fitY,
            sigma_min=sigma_min, inductance_scale=inductance_scale,
            outlier_lambda=outlier_lambda, ncp=ncp and mode == "sample",
            SA=SA, SASY=SASY)
        if add_model_data:
            unknown = set(add_model_data) - set(PosteriorData._fields)
            if unknown:
                raise ValueError(
                    f"Unknown PosteriorData fields in add_model_data: "
                    f"{sorted(unknown)}. Valid fields: "
                    f"{list(PosteriorData._fields)}")
            dtype = data.target.dtype
            updates = {}
            for k, v in add_model_data.items():
                cur = getattr(data, k)
                if isinstance(cur, tuple):
                    if len(v) != len(cur):
                        raise ValueError(
                            f"add_model_data[{k!r}] must have "
                            f"{len(cur)} entries (one per distribution)")
                    updates[k] = tuple(jnp.asarray(vi, dtype=dtype) for vi in v)
                else:
                    updates[k] = jnp.asarray(v, dtype=dtype)
            data = data._replace(**updates)
        density = log_density if log_density_fn is None else log_density_fn
        self.stan_model_name = cfg.model_name()
        self._posterior = (cfg, data)
        if cfg.model_name().startswith("Series-Parallel") and not nonneg:
            warnings.warn("For mixed series-parallel models, it is highly "
                          "recommended to set nonneg=True")

        names = sort_distributions(self.distributions)
        key = jax.random.PRNGKey(random_seed)

        # cross-call program cache: the solver programs are cached keyed on
        # everything that shapes the trace (model config, array shapes,
        # budgets, the density function object); PosteriorData and the init
        # values are jit ARGUMENTS, so repeated fits of same-shaped spectra
        # skip Python re-tracing entirely (see progcache.cached_program)
        iv_sig = (None if init_values is None
                  else (tuple(sorted(init_values)), data_shapes(init_values)))
        prog_base = ("inverter_fit", cfg, data_shapes(data), density, iv_sig)

        if mode == "optimize":
            def build_map():
                def _finish(loss, res):
                    # Newton polish: the L-BFGS cap usually binds before
                    # Stan-grade convergence on this posterior; a damped
                    # Newton refinement on the ~110-dim problem certifies
                    # the optimum (grad-norm <= tol) in a few dozen cheap
                    # factorizations (MapResult.converged/grad_norm)
                    if not polish:
                        return res
                    pol = newton_polish(loss, res.params)
                    return pol._replace(n_iter=res.n_iter + pol.n_iter)

                if init_values is not None:
                    def run(dat, k, iv):
                        loss = lambda p: -density(cfg, dat, p, jacobian=False)
                        p0 = init_unconstrained(cfg, dat, k, init_values=iv)
                        return _finish(loss, run_lbfgs(loss, p0,
                                                       max_iter=max_iter))
                else:
                    def run(dat, k):
                        loss = lambda p: -density(cfg, dat, p, jacobian=False)
                        init_fn = lambda kk: init_unconstrained(cfg, dat, kk)
                        return _finish(loss, run_lbfgs_restarts(
                            loss, init_fn, k, n_restarts, max_iter=max_iter))
                return jax.jit(run)

            runner = cached_program(
                prog_base + ("map", max_iter, n_restarts, polish), build_map)
            iv_args = () if init_values is None else (init_values,)
            res = runner(data, key, *iv_args)
            c = jax.tree.map(np.asarray, constrain(cfg, data, res.params))
            pred = np.asarray(predict_target(cfg, data, c))
            st = np.asarray(sigma_tot(cfg, data, c, jnp.asarray(pred)))
            self._opt_result = self._stan_style_result(cfg, names, c, pred, st)
            self._opt_result["lp__"] = -float(res.value)
            self._map_result = res
            self.fit_type = "map"
        elif mode == "sample":
            logp_template = init_unconstrained(cfg, data, key)
            _, unravel = ravel_pytree(logp_template)
            nuts_cfg = NUTSConfig(max_depth=max_tree_depth, delta=adapt_delta)
            if sampler == "chees":
                alt_cfg = (chees_cfg if chees_cfg is not None
                           else ChEESConfig(delta=adapt_delta))
            elif sampler == "shmc":
                alt_cfg = (shmc_cfg if shmc_cfg is not None
                           else SHMCConfig(delta=adapt_delta))
            elif sampler == "nuts":
                alt_cfg = None
            else:
                raise ValueError(f"Unknown sampler {sampler!r}; options are "
                                 "'nuts', 'chees', 'shmc'")

            def build_sample():
                def run(dat, ks, *iv_args):
                    iv = iv_args[0] if iv_args else None
                    logp = lambda q: density(cfg, dat, unravel(q),
                                             jacobian=True)

                    def q0_for(k_init):
                        if iv is not None:
                            p0 = init_unconstrained(cfg, dat, k_init,
                                                    init_values=iv)
                        else:
                            p0 = init_unconstrained(cfg, dat, k_init)
                        return ravel_pytree(p0)[0]

                    if sampler in ("chees", "shmc"):
                        # all chains jointly: these samplers pool their
                        # adaptation across the chain axis
                        k_inits = jax.vmap(lambda k: jax.random.split(k)[0])(ks)
                        q0 = jax.vmap(q0_for)(k_inits)
                        fn = sample_chees if sampler == "chees" else sample_shmc
                        draws, info = fn(logp, q0, ks[0], warmup=warmup,
                                         samples=samples, cfg=alt_cfg)
                        info = dict(info)
                        info["step_size"] = jnp.broadcast_to(
                            info["step_size"], (chains,))
                        return draws, info

                    def one_chain(chain_key):
                        k_init, k_run = jax.random.split(chain_key)
                        return sample_nuts(logp, q0_for(k_init), k_run,
                                           warmup=warmup, samples=samples,
                                           cfg=nuts_cfg)

                    return jax.vmap(one_chain)(ks)
                return jax.jit(run)

            runner = cached_program(
                prog_base + ("sample", sampler, alt_cfg or nuts_cfg, chains,
                             warmup, samples),
                build_sample)
            iv_args = () if init_values is None else (init_values,)
            keys = jax.random.split(key, chains)
            _t_solve = _time.perf_counter()
            with self.timings.stage("sample"):
                draws, info = runner(data, keys, *iv_args)
                draws_np = np.asarray(draws)      # (chains, samples, D)
            _t_solve = _time.perf_counter() - _t_solve
            self._raw_draws = draws_np
            self._unravel = unravel

            # constrained per-draw quantities, Stan-result style (one pass)
            flat = draws_np.reshape(-1, draws_np.shape[-1])

            def per_draw(q):
                c = constrain(cfg, data, unravel(q))
                pred = predict_target(cfg, data, c)
                return c, pred, sigma_tot(cfg, data, c, pred)

            cons, preds, sts = jax.vmap(per_draw)(jnp.asarray(flat))
            cons = {k: np.asarray(v) for k, v in cons.items()}
            preds = np.asarray(preds)
            sts = np.asarray(sts)
            self._sample_result = self._stan_style_result(cfg, names, cons,
                                                          preds, sts)
            div = np.asarray(info["diverging"])
            ess = mcmc_diagnostics.ess(draws_np)
            # per-parameter rank-normalized diagnostics (Vehtari et al.
            # 2021) — what pystan's fit.summary() gave reference users
            # (reference: inversion.py:1218-1221 prints the Stan summary)
            rhat_rank = mcmc_diagnostics.rhat_rank(draws_np)
            ess_bulk = mcmc_diagnostics.ess_bulk(draws_np)
            ess_tail = mcmc_diagnostics.ess_tail(draws_np)
            self.sample_diagnostics = {
                "divergence_rate": float(div.mean()),
                "accept_prob": float(np.asarray(info["accept_prob"]).mean()),
                "step_size": np.asarray(info["step_size"]),
                "rhat_max": float(np.max(mcmc_diagnostics.rhat(draws_np))),
                "rhat_rank": rhat_rank,
                # same spelling as fit_spectra_batch diagnostics / CLI CSV
                "rank_rhat_max": float(np.max(rhat_rank)),
                "ess_bulk": ess_bulk,
                "ess_bulk_min": float(np.min(ess_bulk)),
                "ess_tail": ess_tail,
                "ess_tail_min": float(np.min(ess_tail)),
                "ess_min": float(np.min(ess)),
                "ess_mean": float(np.mean(ess)),
                "n_leapfrog": float(np.asarray(info["n_leapfrog"]).mean()),
                "wall_time_s": float(_t_solve),
                # ESS/sec: the BASELINE.json headline sampling metric
                "ess_per_sec": float(np.mean(ess) / max(_t_solve, 1e-9)),
                "e_bfmi": mcmc_diagnostics.e_bfmi(np.asarray(info["energy"])),
            }
            if self.sample_diagnostics["divergence_rate"] > 0.1:
                warnings.warn(
                    f"{100 * self.sample_diagnostics['divergence_rate']:.1f}% "
                    "of post-warmup draws diverged; posterior estimates may be "
                    "biased. Consider increasing adapt_delta.")
            self.fit_type = "bayes"
        else:
            raise ValueError(f"Invalid mode {mode!r}. Options are 'optimize', "
                             "'sample'")

        # extract coefficients & error structure (reference: inversion.py:1223-1281)
        self.distribution_fits = {}
        for i, nm in enumerate(names):
            dist_type = self.distributions[nm]["dist_type"]
            stan_key = self._get_stan_coef_name(nm)
            self.distribution_fits[nm] = {
                "coef": self._extract_parameter(stan_key, dist_type, mode)}
        if not fitY:
            self.R_inf = float(self._extract_parameter("Rinf", "series", mode))
            self.inductance = float(self._extract_parameter("induc", "series", mode))
        else:
            self.R_inf = 0.0
            self.inductance = 0.0

        self.error_fit = {"sigma_min": self._rescale_coef(sigma_min, "series")}
        for pkey in ("sigma_tot", "sigma_res"):
            self.error_fit[pkey] = self._extract_parameter(pkey, "series", mode)
        for pkey in ("alpha_prop", "alpha_re", "alpha_im"):
            self.error_fit[pkey] = self._extract_parameter(pkey, None, mode)
        if outliers:
            self.error_fit["sigma_out"] = self._extract_parameter(
                "sigma_out", "series", mode)

        self.f_pred = None

        if outliers is False and check_outliers:
            outlier_idx = self.check_outliers(frequencies, Z, threshold=3.5,
                                              use_existing_fit=True)
            if len(outlier_idx) > 0:
                warnings.warn(
                    f"Possible outliers were identified at indices "
                    f"{outlier_idx.ravel()}, f={frequencies[outlier_idx.ravel()]} "
                    "Hz. Check the residuals and consider re-running with "
                    "outliers=True")

    def drift_map_fit(self, frequencies, Z, times, drift_model="x1",
                      part="both", scale_Z=True, nonneg=False,
                      sigma_min=0.002, max_iter=4000, random_seed=1234,
                      inductance_scale=1.0, n_restarts=2,
                      min_tau_drift=200.0, max_tau_drift=10000.0,
                      polish=True):
        """MAP fit of a time-evolving spectrum (reference:
        inversion.py:1291-1564; drift models x1/x2/dx/dx-lin/RQ/RQ-lin/
        RQ-from-final/RQ-lin-from-final implemented from the documented math
        since the reference ships no compiled drift models).

        times: measurement time of each frequency point (same length as
        frequencies, seconds).
        """
        from .models.drift import (DRIFT_MODELS, DriftConfig, DriftData,
                                   constrain_drift, drift_log_density,
                                   init_drift_params, predict_drift_target)
        if drift_model not in DRIFT_MODELS:
            raise ValueError(f"Invalid drift_model {drift_model!r}. Options "
                             f"are {DRIFT_MODELS}")
        if len(self.distributions) > 1:
            raise ValueError("drift_map_fit supports a single distribution")
        times = np.asarray(times, float)
        if len(times) != len(frequencies):
            raise ValueError("times must have same length as frequencies")

        # keep measurement order aligned with times (reference passes
        # sort_desc=False for drift fits, inversion.py:1350)
        frequencies = np.asarray(frequencies, float)
        Z = np.asarray(Z)
        self.f_train = frequencies
        self.Z_train = Z
        self.t_train = times
        if scale_Z:
            Z_scaled = self._scale_Z(Z, "map")
        else:
            self._Z_scale = 1.0
            Z_scaled = Z

        dist_name = list(self.distributions.keys())[0]
        info = self.distributions[dist_name]
        tau, eps = self._dist_tau_epsilon(dist_name, frequencies)
        self.distributions[dist_name]["tau"] = tau
        self.distributions[dist_name]["epsilon"] = eps
        kw = dict(tau=tau, basis=self.basis, epsilon=eps, kernel=info["kernel"],
                  dist_type=info["dist_type"],
                  symmetry=info.get("symmetry", "planar"),
                  bc=info.get("bc", "transmissive"), ct=info.get("ct", False),
                  k_ct=info.get("k_ct", None))
        A_re = np.asarray(construct_A(frequencies, "real", **kw))
        A_im = np.asarray(construct_A(frequencies, "imag", **kw))
        self.distribution_matrices[dist_name].update(A_re=A_re, A_im=A_im)
        f_coll = 1.0 / (2 * np.pi * tau)
        L = np.stack([1.5 * s * np.asarray(construct_L(f_coll, tau=tau,
                                                       basis=self.basis,
                                                       epsilon=eps, order=o))
                      for o, s in ((0, 0.24), (1, 0.16), (2, 0.08))])

        target = Z_scaled
        cfg = DriftConfig(drift_model=drift_model, dist_type=info["dist_type"],
                          nonneg=nonneg, K=len(tau))
        data = DriftData(
            A_re=jnp.asarray(A_re), A_im=jnp.asarray(A_im), L=jnp.asarray(L),
            Z=jnp.asarray(np.concatenate([target.real, target.imag])),
            freq=jnp.asarray(frequencies), times=jnp.asarray(times),
            sigma_min=jnp.asarray(sigma_min),
            ups_alpha=jnp.asarray(0.05), ups_beta=jnp.asarray(0.1),
            induc_scale=jnp.asarray(inductance_scale),
            tau_bounds=jnp.asarray([min_tau_drift, max_tau_drift]),
            tau2_bounds=jnp.asarray([max(min_tau_drift, 500.0), max_tau_drift]),
            rq_tau_bounds=jnp.asarray([tau.min(), tau.max()]),
            k_bounds=jnp.asarray([1e-4, 1.0]),
            t_max=jnp.asarray(times.max()), t_min=jnp.asarray(times.min()))

        # ridge-initialize the static coefficient vectors (the reference's
        # recommended drift workflow, inversion.py:1411-1432): a quick static
        # hyper-lambda ridge on the whole spectrum anchors x0/x1/Rinf
        ridge_init = {}
        try:
            saved_state = (self.distribution_fits, self.fit_type, self._Z_scale)
            self.ridge_fit(frequencies, Z, penalty="integral",
                           hyper_lambda=True, lambda_0=1, hl_beta=5,
                           weights="modulus")
            x_r = self.distribution_fits[dist_name]["coef"] / saved_state[2]
            rinf_r = max(self.R_inf / saved_state[2], 1e-6)
            induc_r = max(self.inductance / saved_state[2], 1e-10)
            pos_x = nonneg or info["dist_type"] == "parallel"
            u_x = (np.log(np.clip(x_r, 1e-10, None)) if pos_x
                   else np.asarray(x_r))
            ridge_init = {"Rinf0_raw": np.log(rinf_r / 100.0),
                          "induc_raw": np.log(induc_r), "dRinf_raw": 0.0}
            for nm_v in ("x0", "x1"):
                ridge_init[nm_v] = u_x
            ridge_init["dx"] = np.full_like(x_r, 1e-3)
            ridge_init["x2"] = np.full_like(x_r, 1e-3)
            self.distribution_fits, self.fit_type, self._Z_scale = saved_state
        except Exception as exc:  # pragma: no cover - init is best-effort
            warnings.warn(f"Ridge initialization for drift fit failed: {exc}")
        # restore state overwritten by the internal ridge fit (it sorts
        # frequencies and replaces the cached matrices)
        if scale_Z:
            Z_scaled = self._scale_Z(Z, "map")
        self.f_train = frequencies
        self.Z_train = Z
        self.t_train = times
        self.distribution_matrices[dist_name].update(A_re=A_re, A_im=A_im)
        self.f_pred = None

        # cross-call program cache, same discipline as fit(): DriftData and
        # the ridge-init values ride as jit ARGUMENTS keyed on shapes, so a
        # sweep of same-schedule drift fits pays Python tracing once
        key0 = jax.random.PRNGKey(random_seed)
        iv_sig = (None if not ridge_init
                  else (tuple(sorted(ridge_init)), data_shapes(ridge_init)))

        def build_drift():
            def solve(dat, k, iv=None):
                loss = lambda p: -drift_log_density(cfg, dat, p,
                                                    jacobian=False)
                init_fn = lambda kk: init_drift_params(cfg, dat, kk)
                r_rand = run_lbfgs_restarts(loss, init_fn, k, n_restarts,
                                            max_iter=max_iter)
                # the ridge-seeded candidate — or, when ridge init failed,
                # one extra default-init candidate from key k (a key the
                # restart split does not produce), matching the pre-cache
                # candidate pool
                p0 = init_drift_params(cfg, dat, k, init_values=iv)
                r_seed = run_lbfgs(loss, p0, max_iter=max_iter)
                # NaN-aware: a diverged run never beats a finite one
                bv = jnp.where(jnp.isfinite(r_seed.value), r_seed.value,
                               jnp.inf)
                rv = jnp.where(jnp.isfinite(r_rand.value), r_rand.value,
                               jnp.inf)
                take = bv <= rv
                res = jax.tree.map(lambda a, b: jnp.where(take, a, b),
                                   r_seed, r_rand)
                if polish:
                    # certify the winning basin's optimum (grad-norm <= tol)
                    pol = newton_polish(loss, res.params)
                    res = pol._replace(n_iter=res.n_iter + pol.n_iter)
                return res
            return jax.jit(solve)

        runner = cached_program(
            ("inverter_drift", cfg, data_shapes(data), max_iter, n_restarts,
             iv_sig, polish), build_drift)
        iv_args = (ridge_init,) if ridge_init else ()
        res = runner(data, key0, *iv_args)
        c = jax.tree.map(np.asarray, constrain_drift(cfg, data, res.params))
        self._drift_result = c
        self._drift_cfg = cfg
        self.stan_model_name = f"Series_drift-{drift_model}" \
            if info["dist_type"] == "series" else f"Parallel_drift-{drift_model}"

        dist_type = info["dist_type"]
        fits = {}
        if drift_model in ("x1", "x2"):
            fits["x0"] = self._rescale_coef(c["x0"], dist_type)
            fits["x1"] = self._rescale_coef(c["x1"], dist_type)
            fits["tau_x1"] = float(c["tau_1"])
            if drift_model == "x2":
                fits["x2"] = self._rescale_coef(c["x2"], dist_type)
                fits["tau_x2"] = float(c["tau_2"])
        elif drift_model in ("dx", "dx-lin"):
            fits["x0"] = self._rescale_coef(c["x0"], dist_type)
            fits["dx"] = self._rescale_coef(c["dx"], dist_type)
            if drift_model == "dx":
                fits["tau_dx"] = float(c["tau_1"])
            else:
                fits["m_Ft"] = 1.0 / times.max()
        else:
            key = "x1" if drift_model.endswith("from-final") else "x0"
            fits[key] = self._rescale_coef(c[key], dist_type)
            fits["R_rq"] = float(self._rescale_coef(c["R_rq"], dist_type))
            fits["tau_rq"] = float(c["tau_rq"])
            fits["phi_rq"] = float(c["phi_rq"])
            if drift_model in ("RQ", "RQ-from-final"):
                fits["k_d"] = float(c["k_d"])
            elif drift_model == "RQ-lin":
                fits["m_Ft"] = 1.0 / times.max()
            else:
                fits["t_i"] = float(times.min())
                fits["t_f"] = float(times.max())
        # alias: 'coef' = static coefficient vector so predict_distribution
        # and peak fitting work on the time-zero (or final) distribution
        fits["coef"] = fits.get("x0", fits.get("x1"))
        self.distribution_fits = {dist_name: fits}

        self.drift_offsets = {
            "Rinf_0": float(self._rescale_coef(c["Rinf_0"], "series")),
            "delta_Rinf": float(self._rescale_coef(c["delta_Rinf"], "series")),
        }
        if drift_model in ("x1", "x2", "dx"):
            self.drift_offsets["tau_Rinf"] = float(c["tau_Rinf"])
        if drift_model.endswith("from-final"):
            self.drift_offsets["Rinf_1"] = self.drift_offsets.pop("Rinf_0")
        self.R_inf = self.drift_offsets.get("Rinf_0",
                                            self.drift_offsets.get("Rinf_1"))
        self.inductance = float(self._rescale_coef(c["induc"], "series"))
        pred = np.asarray(predict_drift_target(cfg, data, jax.tree.map(
            jnp.asarray, c)))
        n = len(frequencies)
        st = np.sqrt(sigma_min**2 + c["sigma_res"]**2
                     + (c["alpha_prop"] * pred)**2
                     + (c["alpha_re"] * np.tile(pred[:n], 2))**2
                     + (c["alpha_im"] * np.tile(pred[n:], 2))**2)
        self.error_fit = {
            "sigma_min": self._rescale_coef(sigma_min, "series"),
            "sigma_res": float(self._rescale_coef(c["sigma_res"], "series")),
            "sigma_tot": self._rescale_coef(st, "series"),
            "alpha_prop": float(c["alpha_prop"]),
            "alpha_re": float(c["alpha_re"]),
            "alpha_im": float(c["alpha_im"]),
        }
        self.fit_type = "map-drift"
        self.f_pred = None

    def predict_Z_drift(self, frequencies, times, distributions=None,
                        include_offsets=True):
        """Impedance prediction for a drift fit at given per-point times
        (reference: inversion.py:2746-2940)."""
        if self.fit_type != "map-drift":
            raise ValueError("predict_Z_drift requires a drift_map_fit result")
        frequencies = np.asarray(frequencies, float)
        times = np.asarray(times, float)
        if len(times) != len(frequencies):
            raise ValueError("times must have same length as frequencies")
        name = list(self.distributions.keys())[0]
        dist_type = self.distributions[name]["dist_type"]
        model = self.stan_model_name.split("drift-")[1]
        fits = self.distribution_fits[name]
        pred_mat = self._get_prediction_matrices(frequencies, [name])[name]
        A_re, A_im = pred_mat["A_re"], pred_mat["A_im"]
        omega = 2 * np.pi * frequencies

        if model in ("x1", "x2", "dx", "dx-lin"):
            if model in ("x1", "x2"):
                decay = 1 - np.exp(-times / fits["tau_x1"])
                X = fits["x0"][None, :] + (fits["x1"] - fits["x0"])[None, :] * decay[:, None]
                if model == "x2":
                    decay2 = 1 - np.exp(-times / fits["tau_x2"])
                    X = X + fits["x2"][None, :] * decay2[:, None]
            elif model == "dx":
                decay = 1 - np.exp(-times / fits["tau_dx"])
                X = fits["x0"][None, :] + fits["dx"][None, :] * decay[:, None]
            else:
                f_t = times * fits["m_Ft"]
                X = fits["x0"][None, :] + fits["dx"][None, :] * f_t[:, None]
            zr = np.sum(A_re * X, axis=1)
            zi = np.sum(A_im * X, axis=1)
            if dist_type == "parallel":
                y = zr + 1j * zi
                z = 1.0 / y
            else:
                z = zr + 1j * zi
            if model == "dx-lin":
                f_t = times * fits["m_Ft"]
                rinf = self.drift_offsets["Rinf_0"] + self.drift_offsets["delta_Rinf"] * f_t
            else:
                rinf = (self.drift_offsets["Rinf_0"]
                        + self.drift_offsets["delta_Rinf"]
                        * (1 - np.exp(-times / self.drift_offsets["tau_Rinf"])))
        else:
            x_static = fits.get("x0", fits.get("x1"))
            zr = A_re @ x_static
            zi = A_im @ x_static
            z = (1.0 / (zr + 1j * zi)) if dist_type == "parallel" else zr + 1j * zi
            if model == "RQ":
                f_t = 1 - np.exp(-fits["k_d"] * times)
            elif model == "RQ-lin":
                f_t = times * fits["m_Ft"]
            elif model == "RQ-from-final":
                f_t = -np.exp(-fits["k_d"] * times)
            else:
                f_t = (times - fits["t_f"]) / (fits["t_f"] - fits["t_i"])
            z = z + f_t * (fits["R_rq"]
                           / (1 + (1j * omega * fits["tau_rq"]) ** fits["phi_rq"]))
            rinf_base = self.drift_offsets.get("Rinf_0",
                                               self.drift_offsets.get("Rinf_1"))
            rinf = rinf_base + self.drift_offsets["delta_Rinf"] * f_t
        if include_offsets:
            z = z + rinf + 1j * omega * self.inductance
        return z

    def predict_distribution_drift(self, time, name=None, eval_tau=None):
        """gamma(tau, t) for a drift fit (reference: inversion.py:3173-3296)."""
        if self.fit_type != "map-drift":
            raise ValueError("requires a drift_map_fit result")
        if name is None:
            name = list(self.distributions.keys())[0]
        if eval_tau is None:
            eval_tau = self.distributions[name]["tau"]
        eval_tau = np.asarray(eval_tau, float)
        eps = self.distributions[name]["epsilon"]
        basis_tau = self.distributions[name]["tau"]
        phi = get_basis_func(self.basis)
        bases = np.asarray(phi(jnp.log(eval_tau[:, None] / basis_tau[None, :]),
                               eps))
        model = self.stan_model_name.split("drift-")[1]
        fits = self.distribution_fits[name]
        if model in ("x1", "x2"):
            decay = 1 - np.exp(-time / fits["tau_x1"])
            x = fits["x0"] + (fits["x1"] - fits["x0"]) * decay
            if model == "x2":
                x = x + fits["x2"] * (1 - np.exp(-time / fits["tau_x2"]))
            return bases @ x
        if model in ("dx", "dx-lin"):
            f_t = (1 - np.exp(-time / fits["tau_dx"]) if model == "dx"
                   else time * fits["m_Ft"])
            return bases @ (fits["x0"] + fits["dx"] * f_t)
        # RQ family: static distribution + time-dependent ZARC DRT
        x_static = fits.get("x0", fits.get("x1"))
        F0 = bases @ x_static
        if model == "RQ":
            f_t = 1 - np.exp(-fits["k_d"] * time)
        elif model == "RQ-lin":
            f_t = time * fits["m_Ft"]
        elif model == "RQ-from-final":
            f_t = -np.exp(-fits["k_d"] * time)
        else:
            f_t = (time - fits["t_f"]) / (fits["t_f"] - fits["t_i"])
        phi_rq = fits["phi_rq"]
        f_rq = ((1 / (2 * np.pi)) * np.sin((1 - phi_rq) * np.pi)
                / (np.cosh(phi_rq * np.log(eval_tau / fits["tau_rq"]))
                   - np.cos((1 - phi_rq) * np.pi)))
        return F0 + f_t * fits["R_rq"] * f_rq

    def _stan_style_result(self, cfg, names, cons, pred, st):
        """Package constrained draws/values under Stan-style keys
        (x/xs/xp/xp1/xp2, Rinf, induc, error params, Z_hat, sigma_tot)."""
        out = {}
        n_series = sum(1 for nm in names
                       if self.distributions[nm]["dist_type"] == "series")
        n_par = len(names) - n_series
        for i, nm in enumerate(names):
            out[self._get_stan_coef_name(nm)] = cons[f"x_{i}"]
        out["Rinf"] = cons["Rinf"]
        out["induc"] = cons["induc"]
        out["sigma_res"] = cons["sigma_res"]
        out["alpha_prop"] = cons["alpha_prop"]
        out["alpha_re"] = cons["alpha_re"]
        out["alpha_im"] = cons["alpha_im"]
        if "sigma_out" in cons:
            out["sigma_out"] = cons["sigma_out"]
        out["Z_hat"] = pred
        out["sigma_tot"] = st
        return out

    def _get_stan_coef_name(self, distribution_name):
        """Stan-result key for a distribution's coefficients
        (reference: inversion.py:2521-2545). The reference's mapping only
        covers the named model families; for the MultiDist generalization
        (which the reference's extraction cannot handle) each distribution
        gets a unique positional key."""
        names = sort_distributions(self.distributions)
        dist_type = self.distributions[distribution_name]["dist_type"]
        n_series = sum(1 for nm in names
                       if self.distributions[nm]["dist_type"] == "series")
        n_par = len(names) - n_series
        if len(names) == 1:
            return "x"
        if n_series == 1 and n_par in (1, 2):
            if dist_type == "series":
                return "xs"
            if n_par == 1:
                return "xp"
            par_names = [nm for nm in names
                         if self.distributions[nm]["dist_type"] == "parallel"]
            return f"xp{par_names.index(distribution_name) + 1}"
        return f"x_{names.index(distribution_name)}"

    def _extract_parameter(self, stan_key, dist_type, mode):
        """(reference: inversion.py:2494-2519)"""
        source = self._opt_result if mode == "optimize" else self._sample_result
        val = source[stan_key]
        if mode == "sample":
            val = np.mean(val, axis=0)
        if stan_key in ("alpha_prop", "alpha_re", "alpha_im"):
            return val
        return self._rescale_coef(val, dist_type)

    def coef_percentile(self, distribution_name, percentile):
        """(reference: inversion.py:2547-2566)"""
        if self.fit_type != "bayes":
            raise ValueError("Percentile prediction is only available for bayes_fit")
        dist_type = self.distributions[distribution_name]["dist_type"]
        coef_name = self._get_stan_coef_name(distribution_name)
        coef = np.percentile(self._sample_result[coef_name], percentile, axis=0)
        return self._rescale_coef(coef, dist_type)

    def _get_init_from_ridge(self, frequencies, Z, nonneg, outliers,
                             inductance_scale, ridge_kw):
        """Underfitted integral-penalty ridge initialization
        (reference: inversion.py:1616-1682)."""
        dist_name = list(self.distributions.keys())[0]
        dist_type = self.distributions[dist_name]["dist_type"]
        defaults = dict(penalty="integral", hyper_lambda=True, lambda_0=1,
                        hl_beta=5, weights="modulus")
        defaults.update(ridge_kw)
        self.ridge_fit(frequencies, Z, **defaults)

        coef = self.distribution_fits[dist_name]["coef"]
        if dist_type == "series":
            x_star = coef / self._Z_scale
        else:
            x_star = coef * self._Z_scale
        iv = {"x_0": x_star}
        iv["Rinf_raw"] = max(self.R_inf / self._Z_scale, 1e-10) / 100.0
        induc = self.inductance / self._Z_scale
        if induc <= 0:
            induc = 1e-10
        iv["induc_raw"] = induc / inductance_scale
        if outliers:
            outlier_idx = self.check_outliers(frequencies, Z, threshold=3,
                                              use_existing_fit=True)
            sigma_out_raw = np.zeros(len(Z)) + 0.1
            sigma_out_raw[outlier_idx.ravel()] = 1.0
            iv["sigma_out_raw"] = sigma_out_raw
        return iv

    # ===================================================================
    # Prediction (reference: inversion.py:2571-3376)
    # ===================================================================

    def _get_prediction_matrices(self, frequencies, distributions):
        """A matrices at prediction frequencies, with caching
        (reference: inversion.py:2571-2667)."""
        frequencies = np.asarray(frequencies, float)
        cached_f = self.f_pred if self.f_pred is not None else self.f_train
        cached_src = (self.prediction_matrices if self.f_pred is not None
                      else self.distribution_matrices)
        pred_mat = {}
        have_cache = all(
            len(cached_src.get(nm, {})) > 0 and "A_re" in cached_src.get(nm, {})
            for nm in distributions)
        if have_cache and np.array_equal(rel_round(cached_f, 10),
                                         rel_round(frequencies, 10)):
            for nm in distributions:
                pred_mat[nm] = {"A_re": cached_src[nm]["A_re"],
                                "A_im": cached_src[nm]["A_im"]}
            return pred_mat

        rounded_cache = rel_round(cached_f, 10) if have_cache else np.array([])
        idx = []
        subset = have_cache
        if have_cache:
            for f in rel_round(frequencies, 10):
                match = np.where(rounded_cache == f)[0]
                if len(match) == 0:
                    subset = False
                    break
                idx.append(match[0])
        if subset:
            idx = np.asarray(idx)
            for nm in distributions:
                pred_mat[nm] = {"A_re": cached_src[nm]["A_re"][idx],
                                "A_im": cached_src[nm]["A_im"][idx]}
            return pred_mat

        for nm in distributions:
            info = self.distributions[nm]
            tau = info["tau"]
            eps = info["epsilon"]
            kw = dict(tau=tau, basis=self.basis, epsilon=eps,
                      kernel=info["kernel"], dist_type=info["dist_type"],
                      symmetry=info.get("symmetry", "planar"),
                      bc=info.get("bc", "transmissive"),
                      ct=info.get("ct", False), k_ct=info.get("k_ct", None))
            pred_mat[nm] = {
                "A_re": np.asarray(construct_A(frequencies, "real", **kw)),
                "A_im": np.asarray(construct_A(frequencies, "imag", **kw))}
        self.f_pred = frequencies
        self.prediction_matrices = pred_mat
        return pred_mat

    def predict_Z(self, frequencies, distributions=None, include_offsets=True,
                  percentile=None, times=None):
        """(reference: inversion.py:2669-2961, incl. the drift path
        2746-2940: for a drift_map_fit result, ``times`` gives the
        measurement time of each frequency point)"""
        frequencies = np.asarray(frequencies, float)
        if self.fit_type == "map-drift":
            if times is None:
                raise ValueError(
                    "This is a drift fit (fit_type='map-drift'): predict_Z "
                    "requires times (one per frequency point)")
            if percentile is not None:
                raise ValueError("Percentile prediction is not available for "
                                 "drift (MAP-only) fits")
            return self.predict_Z_drift(frequencies, times,
                                        distributions=distributions,
                                        include_offsets=include_offsets)
        if times is not None:
            raise ValueError("times is only valid for drift_map_fit results "
                             f"(fit_type={self.fit_type!r})")
        if distributions is None:
            distributions = list(self.distribution_fits.keys())
        elif isinstance(distributions, str):
            distributions = [distributions]

        if percentile is not None:
            if self.fit_type != "bayes":
                raise ValueError("Percentile prediction is only available for "
                                 "bayes_fit results")
            z_mat = self.predict_Z_distribution(frequencies,
                                                distributions=distributions,
                                                include_offsets=include_offsets)
            return (np.percentile(z_mat.real, percentile, axis=0)
                    + 1j * np.percentile(z_mat.imag, percentile, axis=0))

        pred_mat = self._get_prediction_matrices(frequencies, distributions)
        z_pred = np.zeros(len(frequencies), dtype=complex)
        for nm in distributions:
            mat = pred_mat[nm]
            dist_type = self.distributions[nm]["dist_type"]
            coef = self.distribution_fits[nm]["coef"]
            if dist_type == "series":
                z_pred += mat["A_re"] @ coef + 1j * (mat["A_im"] @ coef)
            else:
                y = mat["A_re"] @ coef + 1j * (mat["A_im"] @ coef)
                z_pred += 1.0 / y
        if include_offsets:
            z_pred = z_pred + self.R_inf
            z_pred = z_pred + 1j * 2 * np.pi * frequencies * self.inductance
        return z_pred

    def predict_Z_distribution(self, frequencies, distributions=None,
                               include_offsets=True):
        """Posterior impedance sample matrix (reference: inversion.py:2963-3031)."""
        if self.fit_type != "bayes":
            raise ValueError("predict_Z_distribution is only available for "
                             "bayes_fit results")
        frequencies = np.asarray(frequencies, float)
        if distributions is None:
            distributions = list(self.distribution_fits.keys())
        elif isinstance(distributions, str):
            distributions = [distributions]
        if (len(distributions) != len(self.distributions)
                or not include_offsets):
            warnings.warn("All distributions and offsets should be included "
                          "for meaningful results")

        if (np.array_equal(rel_round(self.f_train, 10),
                           rel_round(frequencies, 10))
                and len(distributions) == len(self.distributions)
                and include_offsets):
            z_split = self._sample_result["Z_hat"] * self._Z_scale
            n = len(frequencies)
            return z_split[:, :n] + 1j * z_split[:, n:]

        pred_mat = self._get_prediction_matrices(frequencies, distributions)
        n_samples = len(self._sample_result["Rinf"])
        z_mat = np.zeros((n_samples, len(frequencies)), dtype=complex)
        for nm in distributions:
            mat = pred_mat[nm]
            dist_type = self.distributions[nm]["dist_type"]
            coef_matrix = self._rescale_coef(
                self._sample_result[self._get_stan_coef_name(nm)], dist_type)
            zr = coef_matrix @ mat["A_re"].T
            zi = coef_matrix @ mat["A_im"].T
            if dist_type == "series":
                z_mat += zr + 1j * zi
            else:
                z_mat += 1.0 / (zr + 1j * zi)
        if include_offsets:
            z_mat += self._rescale_coef(self._sample_result["Rinf"],
                                        "series")[:, None]
            z_mat += 1j * 2 * np.pi * frequencies * self._rescale_coef(
                self._sample_result["induc"], "series")[:, None]
        return z_mat

    def predict_Rp(self, distributions=None, percentile=None, time=None):
        """(reference: inversion.py:3033-3087)"""
        if distributions is None:
            distributions = list(self.distribution_fits.keys())
        elif isinstance(distributions, str):
            distributions = [distributions]

        if len(distributions) > 1:
            z_range = self.predict_Z(np.array([1e20, 1e-20]),
                                     distributions=distributions,
                                     percentile=percentile)
            return float(np.real(z_range[1] - z_range[0]))

        nm = distributions[0]
        info = self.distributions[nm]
        if info["kernel"] == "DRT" and "coef" in self.distribution_fits[nm]:
            if percentile is None:
                return float(np.sum(self.distribution_fits[nm]["coef"])
                             * np.sqrt(np.pi) / info["epsilon"])
            if self.fit_type != "bayes":
                raise ValueError("Percentile prediction is only available for "
                                 "bayes_fit results")
            coef_matrix = self._rescale_coef(
                self._sample_result[self._get_stan_coef_name(nm)], "series")
            rp = np.sum(coef_matrix, axis=1) * np.sqrt(np.pi) / info["epsilon"]
            return float(np.percentile(rp, percentile))
        if percentile is None:
            z_range = self.predict_Z(np.array([1e20, 1e-20]),
                                     distributions=distributions)
            return float(np.real(z_range[1] - z_range[0]))
        z_mat = self.predict_Z_distribution(np.array([1e20, 1e-20]),
                                            distributions=distributions)
        rp = np.real(z_mat[:, 1] - z_mat[:, 0])
        return float(np.percentile(rp, percentile))

    def predict_sigma(self, frequencies, percentile=None, times=None):
        """(reference: inversion.py:3089-3139; for drift fits, ``times``
        locates the error model at each point's measurement time)"""
        if percentile is not None and self.fit_type != "bayes":
            raise ValueError("Percentile prediction is only available for bayes_fit")
        if times is not None and self.fit_type != "map-drift":
            raise ValueError("times is only valid for drift_map_fit results "
                             f"(fit_type={self.fit_type!r})")
        frequencies = np.asarray(frequencies, float)
        n_train = len(self.f_train)
        times_match = (self.fit_type != "map-drift"
                       or (times is not None
                           and np.array_equal(np.asarray(times, float),
                                              getattr(self, "t_train", None))))
        if times_match and np.array_equal(rel_round(self.f_train, 10),
                                          rel_round(frequencies, 10)):
            if self.fit_type == "bayes" and percentile is not None:
                st = np.percentile(self._sample_result["sigma_tot"], percentile,
                                   axis=0) * self._Z_scale
            elif self.fit_type in ("bayes",) or (self.fit_type or "").startswith("map"):
                st = self.error_fit["sigma_tot"]
            else:
                raise ValueError("Error scale prediction only available for "
                                 "bayes_fit and map_fit")
            return st[:n_train].copy(), st[n_train:].copy()

        if self.fit_type == "bayes" and percentile is not None:
            sigma_res = np.percentile(self._sample_result["sigma_res"],
                                      percentile) * self._Z_scale
            alpha_prop = np.percentile(self._sample_result["alpha_prop"], percentile)
            alpha_re = np.percentile(self._sample_result["alpha_re"], percentile)
            alpha_im = np.percentile(self._sample_result["alpha_im"], percentile)
            if "sigma_out" in self._sample_result:
                sigma_out = np.percentile(self._sample_result["sigma_out"],
                                          percentile, axis=0) * self._Z_scale
            else:
                sigma_out = np.zeros(2 * n_train)
        elif self.fit_type in ("bayes",) or (self.fit_type or "").startswith("map"):
            sigma_res = self.error_fit["sigma_res"]
            alpha_prop = self.error_fit["alpha_prop"]
            alpha_re = self.error_fit["alpha_re"]
            alpha_im = self.error_fit["alpha_im"]
            sigma_out = self.error_fit.get("sigma_out", np.zeros(2 * n_train))
        else:
            raise ValueError("Error scale prediction only available for "
                             "bayes_fit and map_fit")
        sigma_min = self.error_fit["sigma_min"]
        z_pred = self.predict_Z(frequencies, percentile=percentile,
                                times=times)
        sigma_base = np.sqrt(sigma_res**2 + np.min(sigma_out)**2 + sigma_min**2)
        sigma_re = np.sqrt(sigma_base**2 + (alpha_prop * z_pred.real)**2
                           + (alpha_re * z_pred.real)**2
                           + (alpha_im * z_pred.imag)**2)
        sigma_im = np.sqrt(sigma_base**2 + (alpha_prop * z_pred.imag)**2
                           + (alpha_re * z_pred.real)**2
                           + (alpha_im * z_pred.imag)**2)
        return sigma_re, sigma_im

    def score(self, frequencies, Z, metric="chi_sq", weights=None, part="both",
              times=None):
        """(reference: inversion.py:3141-3160; ``times`` scores a drift fit
        at each point's measurement time)"""
        Z = np.asarray(Z)
        w = self._format_weights(frequencies, Z, weights, part)
        z_pred = self.predict_Z(frequencies, times=times)
        if part == "both":
            z_pred = np.concatenate([z_pred.real, z_pred.imag])
            z_data = np.concatenate([Z.real, Z.imag])
            w = np.concatenate([w.real, w.imag])
        else:
            z_pred = getattr(z_pred, part)
            z_data = getattr(Z, part)
            w = getattr(w, part)
        if metric == "chi_sq":
            return float(np.sum(((z_pred - z_data) * w) ** 2) / len(frequencies))
        if metric == "r2":
            return float(r2_score(z_data, z_pred, weights=w))
        raise ValueError(f"Invalid metric {metric}. Options are 'chi_sq', 'r2'")

    def predict_distribution(self, name=None, eval_tau=None, percentile=None,
                             time=None):
        """gamma(tau) evaluated on eval_tau (reference: inversion.py:3162-3311,
        incl. the drift path 3173-3296: for a drift_map_fit result, ``time``
        selects gamma(tau, t); with time=None the static/time-zero
        distribution is returned)."""
        if time is not None:
            if self.fit_type != "map-drift":
                raise ValueError("time is only valid for drift_map_fit "
                                 f"results (fit_type={self.fit_type!r})")
            if percentile is not None:
                raise ValueError("Percentile prediction is not available for "
                                 "drift (MAP-only) fits")
            return self.predict_distribution_drift(time, name=name,
                                                   eval_tau=eval_tau)
        if name is None:
            name = list(self.distributions.keys())[0]
        if eval_tau is None:
            eval_tau = self.distributions[name]["tau"]
        eval_tau = np.asarray(eval_tau, float)
        if percentile is not None:
            coef = self.coef_percentile(name, percentile)
        else:
            coef = self.distribution_fits[name]["coef"]
        eps = self.distributions[name]["epsilon"]
        basis_tau = self.distributions[name]["tau"]
        phi = get_basis_func(self.basis)
        bases = np.asarray(phi(
            jnp.log(eval_tau[:, None] / basis_tau[None, :]), eps))
        return bases @ coef

    def check_outliers(self, frequencies, Z, threshold=3.5,
                       use_existing_fit=False, **ridge_kw):
        """(reference: inversion.py:3313-3376)"""
        frequencies = np.asarray(frequencies, float)
        Z = np.asarray(Z)
        fit_exists = (check_equality(rel_round(frequencies, 10),
                                     rel_round(self.f_train, 10))
                      and self.Z_train is not None
                      and len(Z) == len(self.Z_train)
                      and check_equality(np.sort(Z), np.sort(self.Z_train))
                      and bool(self.distribution_fits))
        if not (use_existing_fit and fit_exists):
            self.ridge_fit(frequencies, Z, preset="Huang", **ridge_kw)

        sort_idx = np.argsort(frequencies)[::-1]
        frequencies = frequencies[sort_idx]
        Z = Z[sort_idx]
        z_err = self.predict_Z(frequencies) - Z
        if self.fit_type == "ridge":
            zmod = np.abs(Z)
            re_thresh = get_outlier_thresh(np.abs(z_err.real / zmod),
                                           iqr_factor=threshold)
            im_thresh = get_outlier_thresh(np.abs(z_err.imag / zmod),
                                           iqr_factor=threshold)
            outlier_idx = np.argwhere(
                (z_err.real / zmod) ** 2 + (z_err.imag / zmod) ** 2
                >= re_thresh**2 + im_thresh**2)
        else:
            sigma_re, sigma_im = self.predict_sigma(frequencies)
            zs_tot = np.sqrt(((z_err.real / sigma_re) ** 2
                              + (z_err.imag / sigma_im) ** 2) / 2)
            outlier_idx = np.argwhere(zs_tot > threshold)
        return outlier_idx

    # ===================================================================
    # Peak fitting (reference: inversion.py:3381-3680)
    # ===================================================================

    def _peak_eval_tau(self, distribution):
        basis_tau = self.distributions[distribution]["tau"]
        tmin = np.log10(np.min(basis_tau)) - 1
        tmax = np.log10(np.max(basis_tau)) + 1
        return np.logspace(tmin, tmax, int(10 * (tmax - tmin) + 1))

    def fit_peaks(self, distribution=None, eval_tau=None, percentile=None,
                  time=None, check_shoulders=True, weights=None,
                  prom_rthresh=0.001, R_rthresh=0.005, l1_penalty=0,
                  l2_penalty=0.01, check_chi_sq=False, chi_sq_thresh=0.5,
                  chi_sq_delta=0.3, fit_data=False, frequencies=None, Z=None,
                  Z_weights=None, lambda_x=10):
        """HN peak decomposition of a recovered distribution
        (reference: inversion.py:3381-3484)."""
        from . import peaks as pf
        if distribution is None:
            distribution = list(self.distributions.keys())[0]
        if eval_tau is None:
            eval_tau = self._peak_eval_tau(distribution)
        F = self.predict_distribution(distribution, eval_tau, percentile, time)
        nonneg = bool(np.min(F) >= 0)
        rp = self.predict_Rp()
        x = pf.fit_peaks(eval_tau, F, rp, weights=weights, nonneg=nonneg,
                         check_shoulders=check_shoulders,
                         prom_rthresh=prom_rthresh, R_rthresh=R_rthresh,
                         check_chi_sq=check_chi_sq, chi_sq_thresh=chi_sq_thresh,
                         chi_sq_delta=chi_sq_delta, l1_penalty=l1_penalty,
                         l2_penalty=l2_penalty)
        if fit_data:
            if frequencies is None or Z is None:
                raise ValueError("frequencies and Z must be provided if "
                                 "fit_data==True")
            result = pf.fit_data(x, frequencies, Z, R_inf=self.R_inf,
                                 inductance=self.inductance, weights=Z_weights,
                                 lambda_x=lambda_x)
            x = result["x"]
        # sort by time constant
        x = np.asarray(x)
        if len(x):
            order = np.argsort(np.exp(x[1::4]))
            x = x.reshape(-1, 4)[order].ravel()
        self.distribution_fits[distribution]["peak_params"] = x
        self.distribution_fits[distribution]["peak_chi_sq"] = self.score_peak_fit(
            eval_tau=eval_tau, distribution=distribution, weights=weights,
            percentile=percentile, time=time)

    def fit_peaks_constrained(self, tau0_guess, distribution=None,
                              eval_tau=None, percentile=None, time=None,
                              sigma_lntau=5, lntau_uncertainty=3, weights=None,
                              l2_penalty=0.01):
        """(reference: inversion.py:3486-3551)"""
        from . import peaks as pf
        if distribution is None:
            distribution = list(self.distributions.keys())[0]
        if eval_tau is None:
            eval_tau = self._peak_eval_tau(distribution)
        F = self.predict_distribution(distribution, eval_tau, percentile, time)
        nonneg = bool(np.min(F) >= 0)
        rp = self.predict_Rp()
        result = pf.constrained_peak_fit(eval_tau, F, tau0_guess, rp, nonneg,
                                         lntau_uncertainty, sigma_lntau,
                                         weights, l2_penalty)
        self.distribution_fits[distribution]["peak_params"] = result["x"]
        self.distribution_fits[distribution]["peak_chi_sq"] = self.score_peak_fit(
            eval_tau=eval_tau, distribution=distribution, weights=weights,
            percentile=percentile, time=time)

    def predict_peak_distribution(self, eval_tau=None, distribution=None,
                                  peak_index=None):
        """(reference: inversion.py:3553-3589)"""
        from . import peaks as pf
        if distribution is None:
            distribution = list(self.distributions.keys())[0]
        if eval_tau is None:
            eval_tau = self._peak_eval_tau(distribution)
        params = self.distribution_fits[distribution]["peak_params"]
        if peak_index is not None:
            params = params[4 * peak_index:4 * peak_index + 4]
        return np.asarray(pf.evaluate_fit_distribution(params, eval_tau))

    def predict_peak_Z(self, frequencies, distribution=None):
        """(reference: inversion.py:3591-3610)"""
        from . import peaks as pf
        if distribution is None:
            distribution = list(self.distributions.keys())[0]
        return np.asarray(pf.evaluate_fit_impedance(
            self.distribution_fits[distribution]["peak_params"], frequencies,
            self.R_inf, self.inductance))

    def extract_peak_info(self, distribution=None, sort=True):
        """(reference: inversion.py:3612-3657)"""
        if distribution is None:
            distribution = list(self.distributions.keys())[0]
        params = np.asarray(self.distribution_fits[distribution]["peak_params"])
        R = params[::4]
        t0 = np.exp(params[1::4])
        alpha = params[2::4]
        beta = params[3::4]
        if sort:
            order = np.argsort(t0)
            R, t0, alpha, beta = R[order], t0[order], alpha[order], beta[order]
        return {"num_peaks": len(params) // 4,
                "chi_sq": self.distribution_fits[distribution]["peak_chi_sq"],
                "R": R, "tau_0": t0, "alpha": alpha, "beta": beta}

    def score_peak_fit(self, eval_tau=None, distribution=None, weights=None,
                       percentile=None, time=None):
        """(reference: inversion.py:3659-3680)"""
        from . import peaks as pf
        if distribution is None:
            distribution = list(self.distributions.keys())[0]
        if eval_tau is None:
            eval_tau = self.distributions[distribution]["tau"]
        F = self.predict_distribution(distribution, eval_tau, percentile, time)
        F_fit = np.asarray(pf.evaluate_fit_distribution(
            self.distribution_fits[distribution]["peak_params"], eval_tau))
        if weights is None:
            weights = 1.0 / (F + np.percentile(F, 80))
        return float(np.sum(((F_fit - F) * weights) ** 2))

    # ===================================================================
    # Persistence (reference: inversion.py:3980-4064)
    # ===================================================================

    def get_fit_attributes(self, which="all"):
        fit_attributes = {
            "common": {
                "core": ["_distributions", "distribution_fits", "f_train",
                         "Z_train", "_Z_scale", "fit_type", "R_inf",
                         "inductance"],
                "detail": ["distribution_matrices"],
            },
            "ridge": {"core": [], "detail": ["_iter_history"]},
            "map": {"core": ["stan_model_name", "error_fit"],
                    "detail": ["_init_params", "_opt_result"]},
            "bayes": {"core": ["stan_model_name", "_sample_result",
                               "error_fit", "sample_diagnostics"],
                      # raw unconstrained draws allow checkpoint/resume of
                      # posterior analysis without refitting
                      "detail": ["_init_params", "_raw_draws"]},
            "map-drift": {"core": ["stan_model_name", "error_fit",
                                   "drift_offsets"],
                          "detail": ["_drift_result"]},
        }
        if which == "all":
            return (sum(fit_attributes["common"].values(), [])
                    + sum(fit_attributes[self.fit_type].values(), []))
        return (fit_attributes["common"][which]
                + fit_attributes[self.fit_type][which])

    def save_fit_data(self, filename=None, which="all"):
        """Save fit state to a pickle (or return as dict if filename=None)."""
        import pickle
        fit_data = {att: getattr(self, att)
                    for att in self.get_fit_attributes(which)}
        if filename is None:
            return fit_data
        with open(filename, "wb") as f:
            pickle.dump(fit_data, f)

    def load_fit_data(self, data):
        """Restore fit state from a pickle path or dict."""
        import pickle
        if isinstance(data, str):
            with open(data, "rb") as f:
                fit_data = pickle.load(f)
        else:
            fit_data = data
        f_pred_old = deepcopy(self.f_pred)
        for k, v in fit_data.items():
            setattr(self, k, v)
        self._cached_distributions = deepcopy(self._distributions)
        if "distribution_matrices" not in fit_data:
            self.f_pred = f_pred_old
            self._recalc_mat = True

    # ===================================================================
    # Plotting wrappers (reference: inversion.py:3685-3975)
    # ===================================================================

    def _train_df(self):
        from .io.file_load import construct_eis_df
        return construct_eis_df(self.f_train, self.Z_train)

    def plot_distribution(self, ax=None, distribution=None, tau_plot=None,
                          plot_bounds=True, plot_ci=True, **kw):
        from .viz.plotting import plot_distribution as _plot
        return _plot(self._train_df(), self, ax=ax, distribution=distribution,
                     tau_plot=tau_plot, plot_bounds=plot_bounds,
                     plot_ci=plot_ci, **kw)

    def plot_fit(self, axes=None, plot_type="all", bode_cols=None,
                 plot_data=True, color="k", **kw):
        from .viz.plotting import plot_fit as _plot
        return _plot(self._train_df(), self, axes=axes, plot_type=plot_type,
                     bode_cols=bode_cols, plot_data=plot_data, color=color,
                     **kw)

    def plot_residuals(self, axes=None, unit_scale="auto", plot_ci=True, **kw):
        from .viz.plotting import plot_residuals as _plot
        return _plot(self._train_df(), self, axes=axes, unit_scale=unit_scale,
                     plot_ci=plot_ci, **kw)

    def plot_full_results(self, axes=None, bode_cols=None, plot_data=True,
                          color="k", **kw):
        from .viz.plotting import plot_full_results as _plot
        return _plot(self._train_df(), self, axes=axes, bode_cols=bode_cols,
                     plot_data=plot_data, color=color, **kw)

    def plot_peak_fit(self, ax=None, distribution=None, tau_plot=None,
                      plot_bounds=False, plot_ci=False,
                      plot_individual_peaks=True, **kw):
        """Recovered distribution with the HN peak decomposition overlaid
        (reference: inversion.py:3866-3975)."""
        import matplotlib.pyplot as plt
        if distribution is None:
            distribution = list(self.distributions.keys())[0]
        if ax is None:
            _, ax = plt.subplots(figsize=(4.5, 3.2))
        if tau_plot is None:
            basis_tau = self.distributions[distribution]["tau"]
            tau_plot = np.logspace(np.log10(basis_tau.min()),
                                   np.log10(basis_tau.max()), 200)
        gamma = self.predict_distribution(distribution, eval_tau=tau_plot)
        ax.plot(tau_plot, gamma, label="distribution", **kw)
        if plot_ci and self.fit_type == "bayes":
            lo = self.predict_distribution(distribution, eval_tau=tau_plot,
                                           percentile=2.5)
            hi = self.predict_distribution(distribution, eval_tau=tau_plot,
                                           percentile=97.5)
            ax.fill_between(tau_plot, lo, hi, alpha=0.25)
        if plot_bounds:
            for fb in (np.max(self.f_train), np.min(self.f_train)):
                ax.axvline(1.0 / (2 * np.pi * fb), ls=":", c="gray", lw=1)
        g_fit = self.predict_peak_distribution(eval_tau=tau_plot,
                                               distribution=distribution)
        ax.plot(tau_plot, g_fit, ls="--", label="peak fit")
        if plot_individual_peaks:
            params = self.distribution_fits[distribution]["peak_params"]
            for i in range(len(params) // 4):
                g_i = self.predict_peak_distribution(
                    eval_tau=tau_plot, distribution=distribution, peak_index=i)
                ax.plot(tau_plot, g_i, ls=":", lw=1)
        ax.set_xscale("log")
        ax.set_xlabel(r"$\tau$ / s")
        ax.set_ylabel(r"$\gamma$ / $\Omega$")
        ax.legend()
        return ax
