"""
Ensemble NMA on the accelerator
===============================

Batched NMA over many conformers of one protein (e.g. MD snapshots),
executed as a single fused vmap pipeline — each conformer gets a
complete ANM solve (Hessian, eigensolve, observables) and the batch
is dispatched to the accelerator in one XLA program.

On a multi-device system, pass a mesh (springcraft_tpu.parallel.make_mesh)
to sharded_ensemble_anm instead to spread conformers across devices.

Run:  python examples/ensemble_nma.py
"""

import sys
from os.path import abspath, dirname, join

sys.path.insert(0, dirname(dirname(abspath(__file__))))  # in-repo run

import numpy as np

import springcraft_tpu as sc
from springcraft_tpu.parallel import ensemble_anm, ensemble_anm_fluctuations
from springcraft_tpu.structure import load_structure

N_CONFORMERS = 32

path = join(dirname(dirname(__file__)), "tests", "data", "1l2y.pdb")
atoms = load_structure(path, model=1)
ca = atoms[(atoms.atom_name == "CA") & (atoms.element == "C")]

# Synthesize an ensemble by jittering the experimental structure
rng = np.random.RandomState(0)
conformers = ca.coord[None] + 0.3 * rng.randn(
    N_CONFORMERS, ca.array_length(), 3
).astype(np.float32)

params = sc.InvariantForceField(13.0).to_params()

# Full spectral pipeline (eigensolve per conformer)
out = ensemble_anm(conformers, params)
print("eig_values:", out["eig_values"].shape)     # (B, 3n)
print("msf:       ", out["msf"].shape)            # (B, n)
print("mean MSF profile:", np.round(np.asarray(out["msf"]).mean(0)[:5], 3))

# Fast covariance-only pipeline (regularized Cholesky, no eigensolve):
# an order of magnitude faster when only fluctuation observables are
# needed.  inverse="auto" takes the covariance engine the route policy
# picks (springcraft_tpu.utils.config.ensemble_inverse); pass
# inverse="blocked" or "cho_solve" to choose one.
fluc = ensemble_anm_fluctuations(conformers, params, with_dcc=True)
print("fast-path MSF matches:",
      bool(np.allclose(fluc["msf"], out["msf"], rtol=5e-3, atol=1e-4)))

# GNM spectral ensemble: all Kirchhoff eigenvalues via the natively
# batched two-stage banded solver + covariance observables + the 3
# lowest mode shapes, no dense eigh anywhere
from springcraft_tpu.parallel import ensemble_gnm_spectral

gnm = ensemble_gnm_spectral(conformers, params, n_modes=3)
print("GNM eig_values:", gnm["eig_values"].shape)    # (B, n)
print("GNM mode_values[0]:",
      np.round(np.asarray(gnm["mode_values"][0]), 4))
