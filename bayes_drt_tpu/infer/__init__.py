# Production samplers: SHMC (bench default) and NUTS (Stan-equivalent).
# Exploratory arms (ChEES, fused_draws, the flat-chain sampler) live behind
# bayes_drt_tpu.experiments with per-arm notes.
from .chees import SHMCConfig, sample_shmc
from .diagnostics import (e_bfmi, ess, ess_bulk, ess_jnp, ess_tail, rhat,
                          rhat_rank, summary)
from .map import run_lbfgs, run_lbfgs_restarts
from .nnls import solve_nnls, solve_qp_box
from .nuts import NUTSConfig, sample_nuts
from .ridge import (HyperLambdaConfig, RidgeData, run_hyper_lambda,
                    run_hyper_weights, run_ordinary_ridge)

__all__ = ["SHMCConfig", "sample_shmc",
           "e_bfmi", "ess", "ess_bulk", "ess_jnp", "ess_tail", "rhat",
           "rhat_rank", "summary",
           "run_lbfgs", "run_lbfgs_restarts", "solve_nnls", "solve_qp_box",
           "NUTSConfig", "sample_nuts", "HyperLambdaConfig", "RidgeData",
           "run_hyper_lambda", "run_hyper_weights", "run_ordinary_ridge"]
