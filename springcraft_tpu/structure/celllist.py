"""
Spatial cell-list neighbor search.

Mirrors the API subset of ``biotite.structure.CellList`` used by the
reference (``interaction.py:155-159`` and ``test_forcefield.py:270-272``):
construction from coordinates + cell size, and
``create_adjacency_matrix(cutoff)``.

Two backends:

* native C++ cell list (``springcraft_tpu/_native/cell_list.cpp``) —
  O(n) binning, OpenMP-parallel neighbor scan;
* numpy grid-bucket fallback with identical semantics.

Both produce exactly the brute-force adjacency
``d^2(i, j) <= cutoff^2`` (self-contacts included; callers clear the
diagonal), so results are bit-identical to the dense mask used on the
device path.
"""

from __future__ import annotations

import numpy as np

from .. import _native
from .atoms import coord as as_coord

__all__ = ["CellList"]


class CellList:
    """
    Cell list over a set of coordinates.

    Parameters
    ----------
    atoms : AtomArray or ndarray, shape=(n,3)
        The atoms or coordinates.
    cell_size : float
        Edge length of the grid cells.  Should equal the maximum
        interaction distance queried later.
    """

    def __init__(self, atoms, cell_size):
        self._coord = np.asarray(as_coord(atoms), dtype=np.float64)
        if cell_size <= 0:
            raise ValueError("Cell size must be greater than 0")
        self._cell_size = float(cell_size)

    def create_adjacency_matrix(self, threshold_distance):
        """
        Boolean ``(n, n)`` matrix marking atom pairs with
        ``distance <= threshold_distance`` (diagonal included).
        """
        if threshold_distance > self._cell_size:
            raise ValueError(
                "Threshold distance must not exceed the cell size"
            )
        native = _native.native_adjacency(self._coord, threshold_distance)
        if native is not None:
            return native
        return self._python_adjacency(threshold_distance)

    def _python_adjacency(self, cutoff):
        coord = self._coord
        n = len(coord)
        sq_cutoff = cutoff * cutoff
        if n <= 2048:
            # Brute force is faster for small systems
            diff = coord[:, None, :] - coord[None, :, :]
            return np.einsum("ijk,ijk->ij", diff, diff) <= sq_cutoff

        # Grid bucketing
        lo = coord.min(axis=0)
        cell_idx = np.floor((coord - lo) / cutoff).astype(np.int64)
        dims = cell_idx.max(axis=0) + 1
        flat = (cell_idx[:, 0] * dims[1] + cell_idx[:, 1]) * dims[2] + cell_idx[:, 2]
        order = np.argsort(flat, kind="stable")
        sorted_flat = flat[order]
        starts = np.searchsorted(sorted_flat, np.arange(dims.prod() + 1))

        adj = np.zeros((n, n), dtype=bool)
        for i in range(n):
            center = int(flat[i])
            ci = cell_idx[i]
            neighbors = []
            for dx in (-1, 0, 1):
                if not (0 <= ci[0] + dx < dims[0]):
                    continue
                for dy in (-1, 0, 1):
                    if not (0 <= ci[1] + dy < dims[1]):
                        continue
                    for dz in (-1, 0, 1):
                        if not (0 <= ci[2] + dz < dims[2]):
                            continue
                        c = center + (dx * dims[1] + dy) * dims[2] + dz
                        neighbors.append(order[starts[c]:starts[c + 1]])
            if neighbors:
                cand = np.concatenate(neighbors)
                d = coord[cand] - coord[i]
                hit = cand[np.einsum("ij,ij->i", d, d) <= sq_cutoff]
                adj[i, hit] = True
        return adj
