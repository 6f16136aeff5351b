"""
Public Kirchhoff / Hessian computation.

Drop-in equivalents of reference ``interaction.py:14-111``
(``compute_kirchhoff`` / ``compute_hessian``), returning float64 NumPy
matrices plus the interacting pair list.

Two execution paths:

* **dense** (default for all built-in force fields): the force field is
  lowered to an :class:`FFParams` pytree and the matrix is assembled with
  dense masked algebra (:mod:`springcraft_tpu.ops.assembly`) — on JAX
  when x64 is active, otherwise through the NumPy backend with identical
  code.  This is the device path; it is jit/vmap-compatible and needs
  no neighbor list.
* **host** (automatic fallback for custom ``ForceField`` subclasses):
  adjacency is built from the cutoff (optionally via the native cell
  list), pairs are extracted, and the user's polymorphic
  ``force_constant`` is called once over all pairs — the reference's
  extension contract (``forcefield.py:67-94``) is fully supported.
"""

from __future__ import annotations

import numpy as np

from ..ops import assembly, ffparams
from ..structure.atoms import coord as as_coord
from ..structure.celllist import CellList
from ..utils.config import resolve_backend

__all__ = ["compute_kirchhoff", "compute_hessian"]


def _get_xp(dtype):
    if resolve_backend(dtype) == "numpy":
        return np
    import jax.numpy as jnp

    return jnp


def compute_kirchhoff(coord, force_field, use_cell_list=True,
                      return_pairs=True):
    """
    Kirchhoff matrix for the given coordinates and force field.

    Parameters
    ----------
    return_pairs : bool, optional
        If ``False``, skip building the O(n^2) interacting-pair list and
        return ``None`` in its place (the model classes do this — they
        only need the matrix).

    Returns
    -------
    kirchhoff : ndarray, shape=(n, n), dtype=float64
    pairs : ndarray, shape=(k, 2), dtype=int, or None
        Indices of interacting atom pairs.
    """
    coord = _check_coord(coord, force_field)
    params = force_field.to_params(natoms=len(coord))
    if params is None:
        return _host_kirchhoff(coord, force_field, use_cell_list)

    xp = _get_xp(coord.dtype)
    # np.array (not asarray): device outputs must become writable host
    # arrays at the public boundary
    kirchhoff = np.array(
        assembly.kirchhoff_matrix(coord, params, xp), dtype=np.float64
    )
    pairs = _pairs_from_params(coord, params) if return_pairs else None
    return kirchhoff, pairs


def compute_hessian(coord, force_field, use_cell_list=True,
                    return_pairs=True):
    """
    Hessian matrix (atom-interleaved layout
    ``[x1, y1, z1, ..., xn, yn, zn]``) for the given coordinates and
    force field.

    Parameters
    ----------
    return_pairs : bool, optional
        If ``False``, skip building the O(n^2) interacting-pair list and
        return ``None`` in its place.

    Returns
    -------
    hessian : ndarray, shape=(3n, 3n), dtype=float64
    pairs : ndarray, shape=(k, 2), dtype=int, or None
    """
    coord = _check_coord(coord, force_field)
    params = force_field.to_params(natoms=len(coord))
    if params is None:
        return _host_hessian(coord, force_field, use_cell_list)

    xp = _get_xp(coord.dtype)
    hessian = np.array(
        assembly.hessian_matrix(coord, params, xp, layout="atom"),
        dtype=np.float64,
    )
    pairs = _pairs_from_params(coord, params) if return_pairs else None
    return hessian, pairs


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------

def _check_coord(coord, force_field):
    coord = np.asarray(as_coord(coord), dtype=np.float64)
    if coord.ndim != 2 or coord.shape[1] != 3:
        raise ValueError(
            f"Expected coordinates with shape (n,3), got {coord.shape}"
        )
    if force_field.natoms is not None and len(coord) != force_field.natoms:
        raise ValueError(
            f"Got coordinates for {len(coord)} atoms, "
            f"but forcefield was built for {force_field.natoms} atoms"
        )
    return coord


def _pairs_from_params(coord, params):
    """Interacting-pair index list for the dense path (row-major order,
    matching the reference's ``np.where`` over the adjacency matrix).
    Shares the adjacency/overlay composition with the assembly kernels
    so the pair list always describes the assembled matrix."""
    disp = coord[:, None, :] - coord[None, :, :]
    sq_dist = np.einsum("ijk,ijk->ij", disp, disp)
    mask = ffparams.effective_adjacency(sq_dist, params, np)
    atom_i, atom_j = np.where(mask)
    return np.stack([atom_i, atom_j], axis=1)


# ---------------------------------------------------------------------------
# Host path (custom force fields)
# ---------------------------------------------------------------------------

def _host_adjacency(coord, force_field, use_cell_list):
    cutoff = force_field.cutoff_distance
    if cutoff is None:
        adj = ~np.eye(len(coord), dtype=bool)
        sq_dist = None
    else:
        if use_cell_list:
            adj = CellList(coord, cutoff).create_adjacency_matrix(cutoff)
            sq_dist = None
        else:
            disp = coord[:, None, :] - coord[None, :, :]
            sq_dist = np.einsum("ijk,ijk->ij", disp, disp)
            adj = sq_dist <= cutoff**2
        np.fill_diagonal(adj, False)

    # Artificial contact switching (reference interaction.py:193-213)
    shutdown = force_field.contact_shutdown
    if shutdown is not None:
        adj[shutdown, :] = False
        adj[:, shutdown] = False
    pair_off = force_field.contact_pair_off
    if pair_off is not None:
        i, j = np.asarray(pair_off).T
        adj[i, j] = False
        adj[j, i] = False
    pair_on = force_field.contact_pair_on
    if pair_on is not None:
        i, j = np.asarray(pair_on).T
        if (i == j).any():
            raise ValueError(
                "Cannot turn on interaction of an atom with itself"
            )
        adj[i, j] = True
        adj[j, i] = True
    return adj


def _host_pairs(coord, force_field, use_cell_list):
    adj = _host_adjacency(coord, force_field, use_cell_list)
    atom_i, atom_j = np.where(adj)
    pairs = np.stack([atom_i, atom_j], axis=1)
    disp = coord[atom_j] - coord[atom_i]
    sq_dist = np.einsum("ij,ij->i", disp, disp)
    return pairs, disp, sq_dist


def _host_kirchhoff(coord, force_field, use_cell_list):
    pairs, _, sq_dist = _host_pairs(coord, force_field, use_cell_list)
    constants = force_field.force_constant(pairs[:, 0], pairs[:, 1], sq_dist)
    kirchhoff = np.zeros((len(coord), len(coord)))
    kirchhoff[pairs[:, 0], pairs[:, 1]] = -np.asarray(constants)
    np.fill_diagonal(kirchhoff, -np.sum(kirchhoff, axis=0))
    return kirchhoff, pairs


def _host_hessian(coord, force_field, use_cell_list):
    pairs, disp, sq_dist = _host_pairs(coord, force_field, use_cell_list)
    constants = np.asarray(
        force_field.force_constant(pairs[:, 0], pairs[:, 1], sq_dist)
    )
    n = len(coord)
    blocks = np.zeros((n, n, 3, 3))
    blocks[pairs[:, 0], pairs[:, 1]] = (
        -(constants / sq_dist)[:, None, None]
        * np.einsum("ka,kb->kab", disp, disp)
    )
    idx = np.arange(n)
    blocks[idx, idx] = -blocks.sum(axis=0)
    return blocks.transpose(0, 2, 1, 3).reshape(3 * n, 3 * n), pairs
