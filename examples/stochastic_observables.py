"""
Stochastic all-mode observables at mega scale
=============================================

Past ~15k residues the dense covariance no longer exists, and the
mode-sum observables computed from a truncated low-mode set are biased:
the mode-sum MSF is a lower bound, and the mode-sum effector/sensor
profiles can lose even the site *ranking* (the sensor numerators are
dominated by the high-mode tail).  The stochastic estimators close the
gap with ONE batched deflated-CG solve over Rademacher probe columns:

* ``msf_stochastic`` — unbiased all-mode MSF: the exact rank-k
  mode-sum plus a sampled residual (``E[z_r (C_rest z)_r] =
  (C_rest)_rr``), clamped below by the mode-sum;
* ``effector_sensor_stochastic`` — unbiased all-mode PRS profiles:
  the profile numerators are diagonals of covariance matrix functions
  (``fold diag(C^2)`` / ``fold diag(C W C)``), and with ``modes=`` the
  rank-k part is an EXACT control variate (``C_k C_rest = 0``), so
  only the small residual is sampled.

Every estimate carries a per-atom standard error.  This example runs a
dense-provable size so the estimates can be checked against the exact
reference-semantics profiles.

Run:  python examples/stochastic_observables.py [n_residues]
"""

import sys
from os.path import abspath, dirname

sys.path.insert(0, dirname(dirname(abspath(__file__))))  # in-repo run

# The tight tolerances of this dense-provable demo need x64.  At real
# mega scale, drop this line and use f32 tolerances (tol=1e-6).
import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

import springcraft_tpu as sc
from springcraft_tpu.ops import ffparams, matfree
from springcraft_tpu.structure.atoms import AtomArray

N = int(sys.argv[1]) if len(sys.argv) > 1 else 500
K_DEFLATE = 10
PROBES = 96
CUTOFF = 13.0

# Synthetic CA cloud (connected at the cutoff), dense-provable size
rng = np.random.RandomState(0)
side = int(np.ceil(N ** (1 / 3)))
grid = np.stack(
    np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1
).reshape(-1, 3)[:N]
coord = (grid * 5.5 + 0.8 * rng.randn(N, 3)).astype(np.float64)

atoms = AtomArray(N)
atoms.coord = coord.astype(np.float32)
atoms.atom_name[:] = "CA"
atoms.element[:] = "C"
atoms.res_id[:] = np.arange(1, N + 1)
atoms.res_name[:] = "ALA"
atoms.chain_id[:] = "A"

# Dense truth (host float64, reference semantics)
anm = sc.ANM(atoms, sc.InvariantForceField(CUTOFF))
msf_true = np.asarray(anm.mean_square_fluctuation())
prs_raw, _, _ = anm.prs_effector_sensor(norm=False)
_, eff_true, sens_true = anm.prs_effector_sensor(norm=True)
prs_diag = np.diagonal(np.asarray(prs_raw))

# Low modes = the deflation subspace (at real mega scale these come
# from lowest_modes(matrix_free=True); here the dense eigensystem
# keeps the example fast)
vals, vecs = (np.asarray(a) for a in anm.eigen())
modes = (vals[6:6 + K_DEFLATE], vecs[6:6 + K_DEFLATE])

params = ffparams.invariant_params(CUTOFF)
opts = dict(tol=1e-8, block=64, dtype=jnp.float64)


def report(name, est, sem, true):
    err = np.abs(est - true)
    cover = float(np.mean(err <= 3 * sem + 1e-15))
    print(f"{name}: median rel err "
          f"{float(np.median(err / np.abs(true))):.3f}, "
          f"3-sigma coverage {100 * cover:.0f}%")


# 1. All-mode MSF: mode-sum lower bound vs unbiased estimate
modesum = np.einsum("knd,knd,k->n",
                    modes[1].reshape(K_DEFLATE, N, 3),
                    modes[1].reshape(K_DEFLATE, N, 3),
                    1.0 / modes[0])
msf, msf_sem, n_it, _ = matfree.msf_stochastic(
    coord, params, modes, probes=PROBES, seed=1, layout="atom", **opts)
print(f"MSF ({PROBES} probes, {n_it} CG iterations): mode-sum max rel "
      f"deviation {float(np.max(np.abs(modesum - msf_true) / msf_true)):.2f}"
      f" (truncated lower bound) -> stochastic "
      f"{float(np.max(np.abs(msf - msf_true) / msf_true)):.3f}")
report("  msf", msf, msf_sem, msf_true)

# 2. All-mode effector/sensor with the exact rank-k control variate
eff, sens, eff_sem, sens_sem, _, _ = (
    matfree.effector_sensor_stochastic(
        coord, params, prs_diag, probes=PROBES, seed=2, modes=modes,
        layout="atom", **opts))
report("  effector", eff, eff_sem, np.asarray(eff_true))
report("  sensor", sens, sens_sem, np.asarray(sens_true))


def spearman(a, b):
    ra = np.argsort(np.argsort(a)).astype(float)
    rb = np.argsort(np.argsort(b)).astype(float)
    ra -= ra.mean()
    rb -= rb.mean()
    return float((ra @ rb) / np.sqrt((ra @ ra) * (rb @ rb)))


print(f"effector Spearman vs dense: {spearman(eff, eff_true):.3f}; "
      f"sensor: {spearman(sens, sens_true):.3f}")
print("(every estimate is unbiased; tighten by raising probes or the "
      "deflation rank)")
