"""
Precision, route and compile-cache configuration.

Numerical-parity workloads (matching the reference's float64 NumPy
results, see SURVEY.md §4) need 64-bit floats; throughput workloads on
the accelerator want float32.  These helpers centralize the dispatch:

* :func:`x64_enabled` — whether JAX runs with 64-bit types.
* :func:`enable_x64` — turn on 64-bit JAX globally (call before tracing).
* :func:`resolve_backend` — decide whether a float64 computation can run
  through JAX or must fall back to NumPy/LAPACK to preserve precision.
* the route policy — :func:`ensemble_inverse`,
  :func:`shift_invert_engine` and :func:`use_sparse_apply` — the one
  place where an ``"auto"`` option becomes a concrete route.  Routes
  are chosen by dtype and size only; the choices are the ones the card
  measurements made (see ``PERF.md``).
* :func:`enable_compile_cache` — the persistent compile-cache rule.
"""

from __future__ import annotations

import os

import jax
import numpy as np

__all__ = [
    "enable_x64",
    "x64_enabled",
    "resolve_backend",
    "default_dtype",
    "enable_nan_checks",
    "enable_compile_cache",
    "compile_cache_dir",
    "ensemble_inverse",
    "shift_invert_engine",
    "use_sparse_apply",
    "INVFACTOR_MAX_DIM",
    "SPARSE_APPLY_MIN_ATOMS",
]

#: The checkout's own compile-cache directory (listed in .gitignore)
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.realpath(__file__)))), ".jax_cache")


def compile_cache_dir():
    """Where the persistent compile cache lives:
    ``JAX_COMPILATION_CACHE_DIR`` when set, else ``.jax_cache/`` in the
    checkout (a fixed path, so later processes find what earlier ones
    cached)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE_DIR


def enable_compile_cache(min_compile_time_secs=1.0):
    """
    Turn on JAX's persistent compilation cache and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here.  Otherwise the cache goes to ``.jax_cache/``
    in the checkout, storing programs that took at least
    `min_compile_time_secs` to compile.
    """
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return os.environ["JAX_COMPILATION_CACHE_DIR"]
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      float(min_compile_time_secs))
    return CHECKOUT_CACHE_DIR


#: Smallest atom count at which the matrix-free operators take the
#: block-sparse kernel instead of the dense XLA pair grid: the smallest
#: size measured, where the kernel was already 1.7x faster
SPARSE_APPLY_MIN_ATOMS = 2048


def _is_f32(dtype):
    return np.dtype(dtype) == np.float32


def ensemble_inverse(dtype):
    """Covariance engine of the batched fluctuation and spectral
    pipelines for ``inverse="auto"``: ``"blocked"`` (the recursive
    inverse factor of :mod:`springcraft_tpu.ops.pallas_linalg`) for
    float32, measured 1.43x the throughput of ``"cho_solve"`` (XLA
    Cholesky + triangular solve) on the ensemble deployment; the
    unmeasured float64 case keeps ``"cho_solve"``."""
    return "blocked" if _is_f32(dtype) else "cho_solve"


#: Largest matrix for which ``engine="auto"`` builds the explicit
#: inverse factor (its O(m^3) construction outgrows the per-iteration
#: savings beyond; not measured past 5,328)
INVFACTOR_MAX_DIM = 8192


def shift_invert_engine(m, dtype):
    """Factorization engine of the dense shift-invert mode solver for
    ``engine="auto"`` on an ``(m, m)`` matrix: ``"invfactor"``
    (explicit inverse factor, matmul sweeps) for float32 up to
    :data:`INVFACTOR_MAX_DIM`, measured 2.9x faster per solve than
    ``"chol"`` (Cholesky + triangular solves each sweep) at m = 5,328;
    ``"chol"`` otherwise."""
    return ("invfactor" if _is_f32(dtype) and m <= INVFACTOR_MAX_DIM
            else "chol")


def use_sparse_apply(n, dtype, params):
    """Whether the matrix-free operators take the block-sparse kernel
    (:func:`springcraft_tpu.ops.matfree.hessian_apply_pallas_sparse`):
    float32 systems of at least :data:`SPARSE_APPLY_MIN_ATOMS` atoms
    whose force field has a cutoff.  The kernel is compiled for CUDA
    GPUs; on other devices pass ``sparse=False`` at these sizes."""
    return (_is_f32(dtype) and params.has_cutoff
            and n >= SPARSE_APPLY_MIN_ATOMS)


def enable_x64(enabled=True):
    """Enable (or disable) 64-bit types in JAX."""
    jax.config.update("jax_enable_x64", bool(enabled))


def x64_enabled():
    return bool(jax.config.jax_enable_x64)


def enable_nan_checks(enabled=True):
    """
    Toggle JAX NaN debugging: every jitted computation re-runs un-jitted
    and raises on the first NaN it produces.  Useful when the fast
    covariance/LOBPCG paths are applied to a disconnected network (extra
    zero modes make them singular — see ``utils.network.is_connected``).
    """
    jax.config.update("jax_debug_nans", bool(enabled))


def default_dtype():
    """float64 when x64 is active, else float32."""
    return np.float64 if x64_enabled() else np.float32


def resolve_backend(dtype):
    """
    Return ``"jax"`` or ``"numpy"`` for a computation requested at
    `dtype`.

    float64 results are only produced by JAX when x64 mode is active;
    otherwise JAX would silently downcast to float32 and break parity
    with the float64 reference, so NumPy is used instead.
    """
    dtype = np.dtype(dtype)
    if dtype == np.float64 and not x64_enabled():
        return "numpy"
    return "jax"
