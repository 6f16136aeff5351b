"""
Mega-assembly ANM
=================

Large-system workflow: build the dense Hessian on the device (one
jitted XLA assembly), then either (a) extract only the lowest
functional modes iteratively
(Cholesky shift-invert subspace iteration with analytic rigid-body
deflation — O(k n^2) instead of O(n^3)), or (b) get all fluctuation
observables from the regularized Cholesky covariance.  Beyond the
dense regime entirely, see examples/matrix_free_modes.py.  On a
multi-device mesh, sharded_hessian builds the matrix row-sharded with
shard_map.

Run:  python examples/mega_assembly.py [n_residues]
"""

import sys
from os.path import abspath, dirname, join

sys.path.insert(0, dirname(dirname(abspath(__file__))))  # in-repo run

import time

import jax
import jax.numpy as jnp
import numpy as np

from springcraft_tpu.ops import assembly, ffparams, modes, rigid

N = int(sys.argv[1]) if len(sys.argv) > 1 else 2048
K_MODES = 20

# Synthetic CA cloud: perturbed cubic lattice at protein-like density.
# (A uniform random ball leaves isolated atoms -> extra zero modes; the
# analytic-null-space fast paths require a *connected* network — check
# with springcraft_tpu.utils.network.is_connected.)
rng = np.random.RandomState(0)
side = int(np.ceil(N ** (1 / 3)))
grid = np.stack(
    np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1
).reshape(-1, 3)[:N]
coord = (grid * 5.5 + 0.8 * rng.randn(N, 3)).astype(np.float32)

params = ffparams.invariant_params(13.0)

t0 = time.perf_counter()
hessian = jax.jit(lambda c: assembly.hessian_matrix(
    c, params, jnp, dtype=jnp.float32, layout="xyz"))(jnp.asarray(coord))
hessian.block_until_ready()
print(f"Hessian {hessian.shape} built in "
      f"{time.perf_counter() - t0:.2f}s")

# (a) lowest functional modes, iteratively
t0 = time.perf_counter()
vals, vecs = modes.lowest_modes_anm(hessian, coord, k=K_MODES + 4)
vals = np.asarray(vals)
print(f"{K_MODES}+4 lowest modes in {time.perf_counter() - t0:.2f}s; "
      f"eigenvalues {np.round(vals[:5], 5)}")

# f64 accuracy pass: Rayleigh-Ritz on streamed host panels upgrades
# the f32 eigenvalues to ~1e-9 rtol (solve k+4, report k — the
# subspace-boundary modes converge slowest)
t0 = time.perf_counter()
ref_vals, ref_vecs, ref_res = modes.refine_modes_f64(
    coord, params, np.asarray(vecs), layout="xyz")
print(f"f64 refinement in {time.perf_counter() - t0:.2f}s; raw-vs-"
      f"refined rtol {np.max(np.abs(vals[:K_MODES] - ref_vals[:K_MODES])
                             / ref_vals[:K_MODES]):.1e}, "
      f"f64 residuals max {ref_res[:K_MODES].max():.1e}")

# (b) fluctuations via the fast covariance path
t0 = time.perf_counter()
basis = rigid.rigid_modes_anm(coord, layout="xyz")
cov = rigid.covariance_cholesky(hessian, basis)
n = N
msf = np.asarray(
    jnp.einsum("aiai->i", cov.reshape(3, n, 3, n))
)
print(f"covariance + MSF in {time.perf_counter() - t0:.2f}s; "
      f"MSF mean {msf.mean():.4f}")
