"""
Symmetric eigensolves and Hermitian pseudo-inverse.

The reference's NMA hot spots are LAPACK calls: ``np.linalg.eigh``
(reference ``nma.py:61``) and
``np.linalg.pinv(..., hermitian=True, rcond=1e-6)`` (``anm.py:135``,
``gnm.py:128``).  Here both run through XLA (``jnp.linalg.eigh``), which
batches and shards, with the pseudo-inverse implemented via the
eigendecomposition and an eigenvalue threshold that reproduces NumPy's
``rcond`` semantics exactly:

    cutoff = rcond * max|lambda|
    pinv   = U diag(1/lambda where |lambda| > cutoff else 0) U^T

Because float64 in JAX requires x64 mode, a NumPy/LAPACK fallback is
used automatically when a float64 result is requested while JAX runs in
32-bit mode (see ``utils.config.resolve_backend``), preserving numerical
parity in all configurations.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..utils.config import resolve_backend

__all__ = ["eigh", "pinvh", "eigensystem"]


def eigh(matrix):
    """
    Eigenvalues (ascending) and eigenvectors (columns) of a symmetric
    matrix; dispatches to JAX or NumPy depending on dtype/x64 state.
    Supports leading batch dimensions on the JAX path.
    """
    matrix = _as_backend_array(matrix)
    if isinstance(matrix, np.ndarray):
        return np.linalg.eigh(matrix)
    return jnp.linalg.eigh(matrix)


def eigensystem(matrix):
    """
    Eigen decomposition in the reference's convention: eigenvalues in
    ascending order and **modes in rows** — ``eig_vectors[i]`` belongs to
    ``eig_values[i]`` (reference ``nma.py:61-63``).
    """
    vals, vecs = eigh(matrix)
    return vals, _swap_last2(vecs)


def pinvh(matrix, rcond=1e-6):
    """
    Moore-Penrose pseudo-inverse of a symmetric matrix, matching
    ``np.linalg.pinv(matrix, hermitian=True, rcond=rcond)``.
    Supports leading batch dimensions on the JAX path.
    """
    matrix = _as_backend_array(matrix)
    xp = np if isinstance(matrix, np.ndarray) else jnp
    vals, vecs = (np.linalg.eigh(matrix) if xp is np
                  else jnp.linalg.eigh(matrix))
    abs_vals = xp.abs(vals)
    cutoff = rcond * xp.max(abs_vals, axis=-1, keepdims=True)
    inv_vals = xp.where(abs_vals > cutoff, 1.0 / vals, xp.zeros_like(vals))
    if xp is np:
        # (V * s) @ V^T dispatches to BLAS gemm; np.einsum's default
        # (non-`optimize`) path does not and is several-fold slower at
        # parity sizes (5328 dims: the reconstruct alone is ~300 GFLOP)
        return (vecs * inv_vals[..., None, :]) @ _swap_last2(vecs)
    return jnp.einsum("...ik,...k,...jk->...ij", vecs, inv_vals, vecs,
                      precision="highest")


def _swap_last2(a):
    return a.swapaxes(-1, -2)


def _as_backend_array(matrix):
    """Route float64 inputs through NumPy when x64 is off (JAX would
    silently downcast them), otherwise through JAX."""
    if isinstance(matrix, np.ndarray):
        if resolve_backend(matrix.dtype) == "numpy":
            return matrix
        return jnp.asarray(matrix)
    # Already a JAX array (or tracer)
    return matrix
