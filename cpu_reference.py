"""
Inputs and the independent float64 reference shared by ``bench.py`` and
``chip_smoke.py``.

* :func:`make_batches` / :func:`make_ca_atoms` — seeded conformer
  ensembles and synthetic CA chains at protein-like density.
* :func:`cpu_hessian` / :func:`fluctuation_reference` — the reference
  architecture in plain float64 NumPy: a pair-list + scatter Hessian and
  ``np.linalg.pinv(hermitian=True, rcond=1e-6)`` covariance (reference
  ``anm.py:133-136``, ``nma.py:324-353``).  Nothing here imports the
  package under test's numerics, so it can judge them.
"""

import numpy as np

#: Residues per conformer and cutoff (A) of the ensemble deployment
N_RES = 300
CUTOFF = 13.0

#: CA-atom number density of the n=300 batches (atoms/A^3); larger
#: random systems are sized with it so cutoff connectivity stays
#: realistic.
CA_DENSITY = 300 / 34.0**3

_AA20 = [
    "ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU", "GLY", "HIS", "ILE",
    "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP", "TYR", "VAL",
]


def make_batches(n_batches, batch, n_res, seed=0):
    """`n_batches` float32 arrays ``(batch, n_res, 3)``: one random base
    structure plus 0.05 A Gaussian jitter per conformer."""
    rng = np.random.RandomState(seed)
    base = (rng.rand(n_res, 3) * 34.0).astype(np.float32)
    return [
        base[None] + 0.05 * rng.randn(batch, n_res, 3).astype(np.float32)
        for _ in range(n_batches)
    ]


def make_ca_atoms(n, seed=0, spread=None):
    """Synthetic all-CA AtomArray (random sequence, one chain) at
    protein-like density — input for tabulated force fields."""
    from springcraft_tpu.structure import AtomArray

    rng = np.random.RandomState(seed)
    if spread is None:
        spread = (n / CA_DENSITY) ** (1.0 / 3.0)
    atoms = AtomArray(n)
    atoms.coord = (rng.rand(n, 3) * spread).astype(np.float32)
    atoms.atom_name = np.full(n, "CA")
    atoms.element = np.full(n, "C")
    atoms.chain_id = np.full(n, "A")
    atoms.res_id = np.arange(1, n + 1)
    atoms.res_name = np.array(_AA20)[rng.randint(0, 20, n)]
    return atoms


def cpu_hessian(coord, cutoff=CUTOFF):
    """Reference-architecture ANM Hessian (invariant force field): pair
    list + scatter, float64, atom-interleaved layout."""
    coord = np.asarray(coord, dtype=np.float64)
    n = coord.shape[0]
    diff = coord[:, None, :] - coord[None, :, :]
    sq = np.einsum("ijk,ijk->ij", diff, diff)
    adj = (sq <= cutoff**2) & ~np.eye(n, dtype=bool)
    i, j = np.where(adj)
    disp = coord[j] - coord[i]
    sqd = np.einsum("kd,kd->k", disp, disp)
    blocks = np.zeros((n, n, 3, 3))
    blocks[i, j] = -(1.0 / sqd)[:, None, None] * np.einsum(
        "ka,kb->kab", disp, disp
    )
    idx = np.arange(n)
    blocks[idx, idx] = -blocks.sum(axis=0)
    return blocks.transpose(0, 2, 1, 3).reshape(3 * n, 3 * n)


def fluctuation_reference(coord, cutoff=CUTOFF):
    """MSF, B-factors and normalized DCC of one conformer from the
    float64 pseudo-inverse covariance."""
    n = np.asarray(coord).shape[0]
    hessian = cpu_hessian(coord, cutoff)
    cov = np.linalg.pinv(hessian, hermitian=True, rcond=1e-6)
    traces = np.einsum("iaja->ij", cov.reshape(n, 3, n, 3))
    msf = np.diagonal(traces)
    bfac = (8 * np.pi**2) * msf / 3
    dcc = traces / np.sqrt(msf[None, :] * msf[:, None])
    return msf, bfac, dcc
