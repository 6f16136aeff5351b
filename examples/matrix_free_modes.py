"""
Matrix-free modes beyond device memory
======================================

For very large assemblies the ``(3n, 3n)`` Hessian no longer fits one
device (100k residues -> 360 GB f32) — and the reference's
dense ``eigh`` path (reference ``nma.py:61``) was never an option.  The
matrix-free pipeline keeps the operator implicit:

1. atoms are Morton-sorted so 16-atom tiles are spatially compact;
2. tile-level AABB neighbor lists prune the pair plane (a tile-level
   cell list — O(n * neighbors) per product, not O(n^2));
3. a Pallas kernel (Triton route, CUDA GPUs) computes ``H @ X`` with
   one program per row tile walking its neighbour tiles; the Hessian
   never exists, even tiled, in device memory;
4. Chebyshev-filtered subspace iteration extracts the lowest modes,
   with the rigid-body null space shifted into the damped band and a
   Gershgorin degree bound as the guaranteed spectral edge.

Below ``utils.config.SPARSE_APPLY_MIN_ATOMS`` atoms (and in float64)
the solver uses the dense-grid XLA operator instead, on any device; on
a device without CUDA, pass ``sparse=False`` beyond that size.  Always
check the returned residuals — iterative mode solvers are only as good
as their convergence.

Run:  python examples/matrix_free_modes.py [n_residues]
"""

import sys
from os.path import abspath, dirname

sys.path.insert(0, dirname(dirname(abspath(__file__))))  # in-repo run

import time

import numpy as np

from springcraft_tpu.ops import ffparams, matfree

N = int(sys.argv[1]) if len(sys.argv) > 1 else 1536
K_MODES = 6

# Synthetic CA cloud: perturbed cubic lattice at protein-like density
# (connected at the 13 A cutoff).
rng = np.random.RandomState(0)
side = int(np.ceil(N ** (1 / 3)))
grid = np.stack(
    np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1
).reshape(-1, 3)[:N]
coord = (grid * 5.5 + 0.8 * rng.randn(N, 3)).astype(np.float32)

params = ffparams.invariant_params(13.0)

t0 = time.perf_counter()
vals, vecs, res = matfree.lowest_modes_matfree(
    coord, params, K_MODES, degree=64, n_outer=8)
vals = np.asarray(vals)
print(f"{K_MODES} lowest modes of the {3 * N}x{3 * N} operator in "
      f"{time.perf_counter() - t0:.2f}s (Hessian never materialized)")
print("eigenvalues:", np.array2string(vals, precision=4))
print("max relative residual:", float(np.max(np.asarray(res))))

# Independent convergence check through the XLA operator
res2 = matfree.matfree_mode_residuals(coord, params, vals, vecs)
print("independent residual check:", float(np.max(np.asarray(res2))))

# MSF contribution of the computed low modes (the physically dominant
# part of the fluctuation spectrum; reference mode_subset semantics)
u = np.asarray(vecs).reshape(K_MODES, 3, N)
msf = np.sum(np.sum(u**2, axis=1) / vals[:, None], axis=0)
print("low-mode MSF range:", float(msf.min()), "-", float(msf.max()))
