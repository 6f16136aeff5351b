"""
Host-side sparse pair lists and float64 pair-list operator applies.

Every f64-certified quantity (the Rayleigh-Ritz eigenvalue refinement
behind the <=1e-6 rtol accuracy clause, golden-parity checks at scale)
runs on host in float64.  Streaming *dense* Hessian row panels costs
O(n^2) work and is unusable in the matrix-free regime; this module
keeps the operator sparse end to end:

* :func:`neighbor_pairs` — O(n + pairs) cell-list pair enumeration
  (native C++ ``_native/cell_list.cpp::neighbor_pairs``, scipy cKDTree
  fallback);
* :func:`pair_force_constants` — per-pair force constants for every
  force-field family (the 1-D counterpart of
  :func:`.ffparams._base_constants`), including ``PatchedForceField``
  overlays (reference ``forcefield.py:117-261``);
* :func:`pair_list` — cutoff pairs + overlay-forced pairs with their
  final force constants;
* :func:`hessian_apply_pairs` / :func:`kirchhoff_apply_pairs` — float64
  ``H @ V`` / ``K @ V`` at O(pairs * k) cost (native C++ kernels, numpy
  scatter fallback).

Everything here is host-side numpy by design — the device-side sparse
operators live in :mod:`.matfree`.
"""

from __future__ import annotations

import numpy as np

from .. import _native

__all__ = [
    "neighbor_pairs",
    "pair_force_constants",
    "pair_list",
    "hessian_apply_pairs",
    "kirchhoff_apply_pairs",
]


def neighbor_pairs(coord, cutoff):
    """
    All atom pairs ``(i, j)`` with ``i < j`` and
    ``d(i, j) <= cutoff``, as two int64 arrays.

    Semantics match the brute-force adjacency used everywhere else
    (``d^2 <= cutoff^2`` inclusive).  Native cell-list path with a scipy
    ``cKDTree`` fallback; O(n + pairs) in both.
    """
    coord = np.ascontiguousarray(coord, dtype=np.float64)
    native = _native.native_neighbor_pairs(coord, cutoff)
    if native is not None:
        return native
    from scipy.spatial import cKDTree

    tree = cKDTree(coord)
    # cKDTree uses d <= r inclusive; matches the d^2 <= cutoff^2 rule.
    pairs = tree.query_pairs(float(cutoff), output_type="ndarray")
    if pairs.size == 0:
        empty = np.empty(0, dtype=np.int64)
        return empty, empty.copy()
    i = np.minimum(pairs[:, 0], pairs[:, 1]).astype(np.int64)
    j = np.maximum(pairs[:, 0], pairs[:, 1]).astype(np.int64)
    order = np.lexsort((j, i))
    return i[order], j[order]


def pair_force_constants(i, j, sq, params):
    """
    Final per-pair force constants including the overlay value pipeline
    (reference ``forcefield.py:188-223``) — but NOT the adjacency
    decision: callers own the pair set (see :func:`pair_list`).
    """
    from . import ffparams as fp

    k = np.asarray(fp.pair_base_constants(i, j, sq, params, np),
                   dtype=np.float64)
    for overlay in params.overlays:
        has_value = np.asarray(overlay.has_value)[i, j]
        values = np.asarray(overlay.values)[i, j]
        k = np.where(sq <= params.cutoff_sq, k, 0.0)
        k = np.where(has_value, values.astype(np.float64), k)
    return k


def pair_list(coord, params, pairs=None):
    """
    The sparse interaction set of a force field: pair indices
    ``(i, j)`` with ``i < j`` plus their float64 force constants, with
    any :class:`.ffparams.PatchOverlay` masks applied in the reference
    order (all off-switches first, then all forced-on pairs —
    ``interaction.py:193-213``).

    Requires a finite cutoff (no-cutoff families are dense by
    definition).  ``pairs`` optionally injects a precomputed cutoff
    pair set ``(i, j)``.
    """
    if not params.has_cutoff:
        raise ValueError(
            "pair_list needs a force field with a finite cutoff; "
            "no-cutoff families interact densely"
        )
    coord = np.ascontiguousarray(coord, dtype=np.float64)
    if pairs is None:
        i, j = neighbor_pairs(coord, float(np.sqrt(params.cutoff_sq)))
    else:
        i, j = (np.asarray(pairs[0], np.int64),
                np.asarray(pairs[1], np.int64))

    if params.overlays:
        # Forced-on pairs may lie outside the cutoff: union them in.
        on_any = np.zeros((len(coord), len(coord)), dtype=bool)
        off_any = np.zeros_like(on_any)
        for overlay in params.overlays:
            on_any |= np.asarray(overlay.on_mask)
            off_any |= np.asarray(overlay.off_mask)
        extra_i, extra_j = np.nonzero(np.triu(on_any, 1))
        if len(extra_i):
            cat_i = np.concatenate([i, extra_i.astype(np.int64)])
            cat_j = np.concatenate([j, extra_j.astype(np.int64)])
            key = cat_i * len(coord) + cat_j
            _, first = np.unique(key, return_index=True)
            i, j = cat_i[np.sort(first)], cat_j[np.sort(first)]
        keep = ~off_any[i, j] | on_any[i, j]
        i, j = i[keep], j[keep]

    disp = coord[i] - coord[j]
    sq = np.sum(disp * disp, axis=1)
    k = pair_force_constants(i, j, sq, params)
    return i, j, k


def hessian_apply_pairs(coord, i, j, g, v):
    """
    Float64 ANM Hessian apply from a pair list:
    ``(H v)_i = sum_j g_ij d_ij (d_ij . (v_i - v_j))`` with
    ``g = k / d^2`` per pair.  ``v``: ``(n, 3, k)``.  Native C++ kernel
    with a vectorized numpy scatter fallback.
    """
    coord = np.ascontiguousarray(coord, dtype=np.float64)
    v = np.ascontiguousarray(v, dtype=np.float64)
    out = _native.native_enm_hv(coord, i, j, g, v)
    if out is not None:
        return out
    disp = coord[i] - coord[j]                       # (P, 3)
    s = np.einsum("pd,pdk->pk", disp, v[i] - v[j])   # (P, k)
    t = g[:, None, None] * disp[:, :, None] * s[:, None, :]
    out = np.zeros_like(v)
    np.add.at(out, i, t)
    np.subtract.at(out, j, t)
    return out


def kirchhoff_apply_pairs(i, j, k_vals, n, v):
    """
    Float64 Kirchhoff apply from a pair list:
    ``(K v)_i = sum_j k_ij (v_i - v_j)``.  ``v``: ``(n, k)``.
    """
    v = np.ascontiguousarray(v, dtype=np.float64)
    out = _native.native_gnm_kv(i, j, k_vals, n, v)
    if out is not None:
        return out
    t = np.asarray(k_vals, np.float64)[:, None] * (v[i] - v[j])
    out = np.zeros_like(v)
    np.add.at(out, i, t)
    np.subtract.at(out, j, t)
    return out
