"""Cross-call cache for jitted programs.

Rebuilding jit closures on every fit call makes jax re-trace the whole
program each time (seconds of Python tracing; only XLA compilation is
cached by jax itself). Callers key the cache on everything that shapes the
traced computation — model config, array shapes/dtypes, solver budgets,
mesh — and pass array VALUES as arguments, so one cached program serves
every call with the same structure.
"""

from __future__ import annotations

import os

# where the persistent compilation cache lives when JAX_COMPILATION_CACHE_DIR
# is not set: a fixed, git-ignored directory in the checkout root (the
# cache's key includes its path, so a directory that moves never hits)
DEFAULT_COMPILE_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")

_PROGRAM_CACHE: dict = {}
_PROGRAM_CACHE_MAX = 128


def cached_program(key, builder):
    fn = _PROGRAM_CACHE.get(key)
    if fn is None:
        if len(_PROGRAM_CACHE) >= _PROGRAM_CACHE_MAX:
            _PROGRAM_CACHE.pop(next(iter(_PROGRAM_CACHE)))
        fn = builder()
        _PROGRAM_CACHE[key] = fn
    return fn


def data_shapes(tree):
    """Shape/dtype signature of a pytree of arrays/scalars, for cache keys.

    Leaves may be jax/numpy arrays or plain Python scalars (e.g. ridge-init
    values computed with float arithmetic); np.shape/np.result_type cover
    both."""
    import jax
    import numpy as np
    return tuple((np.shape(a), str(np.result_type(a)))
                 for a in jax.tree.leaves(tree))


def enable_compile_cache(min_compile_secs: float = 5.0) -> str:
    """Turn on JAX's persistent compilation cache; return its directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and no
    other directory is set. Otherwise the cache goes to
    DEFAULT_COMPILE_CACHE_DIR. Programs that compile faster than
    ``min_compile_secs`` are not cached."""
    import jax
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_COMPILE_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return path


def precise_matmuls(fn):
    """Trace ``fn`` under full-float32 matmul precision.

    Accelerators may run f32 dot/einsum at reduced precision by default
    (NVIDIA GPUs in TF32, a 10-bit mantissa). For this library's solvers
    that is NOT harmless numerics: reduced-precision gradient noise
    destabilizes NUTS leapfrog integration (an earlier run with 8-bit
    mantissa products measured logp split-Rhat p50 24.7 -> 2.0 and
    recovered-gamma RMSE 0.0159 -> 0.0056 of Rp when forced to float32).
    Every jitted solver body is wrapped with this so accelerator results
    match CPU-quality sampling by default. No effect on float64 or CPU.
    """
    import functools

    import jax

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped
