"""
Force fields as parameter pytrees for dense, jit-able evaluation.

The reference framework expresses force fields as Python classes with a
polymorphic ``force_constant(atom_i, atom_j, sq_distance)`` hot call over
*sparse pair lists* (reference ``forcefield.py:67-94``,
``interaction.py:49``).  That design is CPU-idiomatic; on the device we
evaluate force constants as a *dense masked matrix* over the full pairwise
squared-distance matrix, with static shapes and no gather/scatter of
ragged pair lists.  A single evaluation function covers all force-field
families, keyed by a small static ``kind`` tag, so the assembly stays
jit- and vmap-compatible.

Families (semantics match the reference):

* ``invariant``      — unit constant within cutoff
  (``forcefield.py:264-289``)
* ``hinsen``         — distance-dependent analytic form
  (``forcefield.py:292-330``)
* ``pfenm``          — parameter-free 1/d^2 (``forcefield.py:333-366``)
* ``table_pair``     — position-specific ``(N, N, bins)`` table, the
  direct analogue of ``TabulatedForceField.interaction_matrix``
  (``forcefield.py:475-533``)
* ``table_compact``  — memory-light tabulated form storing only
  ``(20, 20, bins)`` type tables plus per-atom type/chain/bond info;
  force constants are produced by gathers on the fly.  This is the
  scalable device representation (no O(N^2 * bins) table).

A :class:`PatchOverlay` applies artificial contact switching
(``PatchedForceField``, reference ``forcefield.py:117-261``) as dense
masks on top of any base family.

All evaluation functions are written against an array-module argument
``xp`` (``jax.numpy`` or ``numpy``) so that the float64 NumPy parity
backend and the JAX device backend share one implementation.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax
import numpy as np

__all__ = [
    "FFParams",
    "PatchOverlay",
    "invariant_params",
    "hinsen_params",
    "pfenm_params",
    "table_pair_params",
    "table_compact_params",
    "pairwise_sq_distance",
    "force_constant_matrix",
]

_INF = float("inf")


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PatchOverlay:
    """Dense form of ``PatchedForceField`` contact switching."""

    # (n, n) bool: contacts forced off (shutdown rows/cols + pair_off)
    off_mask: Any
    # (n, n) bool: contacts forced on
    on_mask: Any
    # (n, n): force-constant overrides; valid where `has_value`
    values: Any
    # (n, n) bool: positions with an override value (all `pair_on` pairs)
    has_value: Any


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FFParams:
    """Parameter pytree for one force-field family.

    The family tag, bin count, cutoff and bin edges are *static*
    (compile-time) fields: they select code paths (masking, bin
    unrolling) in both the XLA and Pallas kernels, and as plain
    floats/tuples they stay concrete under ``jit`` instead of becoming
    tracers.
    """

    # Static: family tag and bin count (shape-determining)
    kind: str = dataclasses.field(metadata=dict(static=True))
    n_bins: int = dataclasses.field(metadata=dict(static=True))

    # Squared cutoff distance (float; +inf means "no cutoff")
    cutoff_sq: float = dataclasses.field(
        default=_INF, metadata=dict(static=True)
    )

    # squared right bin edges, tuple of floats (static)
    edges_sq: Optional[tuple] = dataclasses.field(
        default=None, metadata=dict(static=True)
    )

    # table_pair: position-specific (n, n, bins) force-constant table
    pair_table: Optional[Any] = None

    # table_compact fields
    type_idx: Optional[Any] = None      # (n,) int32 amino-acid type
    chain_code: Optional[Any] = None    # (n,) int32 chain id code
    bonded_next: Optional[Any] = None   # (n,) bool, i bonded to i+1
    intra_table: Optional[Any] = None   # (20, 20, bins)
    inter_table: Optional[Any] = None   # (20, 20, bins)
    bonded_table: Optional[Any] = None  # (20, 20, bins)

    # Optional dense patch overlay (applied outermost-last)
    overlays: tuple = ()

    @property
    def has_cutoff(self):
        return self.cutoff_sq != _INF


def invariant_params(cutoff_distance):
    """Unit force constant within `cutoff_distance` (mandatory)."""
    if cutoff_distance is None:
        raise ValueError("Cutoff distance must be a float")
    return FFParams(kind="invariant", n_bins=1,
                    cutoff_sq=float(cutoff_distance) ** 2)


def hinsen_params(cutoff_distance=None):
    cutoff_sq = _INF if cutoff_distance is None else float(cutoff_distance) ** 2
    return FFParams(kind="hinsen", n_bins=1, cutoff_sq=cutoff_sq)


def pfenm_params(cutoff_distance=None):
    cutoff_sq = _INF if cutoff_distance is None else float(cutoff_distance) ** 2
    return FFParams(kind="pfenm", n_bins=1, cutoff_sq=cutoff_sq)


def table_pair_params(pair_table, edges):
    """
    Position-specific tabulated force field.

    Parameters
    ----------
    pair_table : ndarray, shape=(n, n, bins)
        Force constant per atom pair and distance bin (diagonal zero),
        identical in content to the reference's ``interaction_matrix``.
    edges : ndarray, shape=(bins,) or None
        Right bin edges (distances).  ``None`` means a single bin with no
        cutoff.
    """
    pair_table = np.asarray(pair_table)
    n_bins = pair_table.shape[-1]
    if edges is None:
        return FFParams(kind="table_pair", n_bins=n_bins, cutoff_sq=_INF,
                        pair_table=pair_table, edges_sq=None)
    edges = np.asarray(edges, dtype=np.float64)
    return FFParams(
        kind="table_pair", n_bins=n_bins,
        cutoff_sq=float(edges[-1]) ** 2,
        pair_table=pair_table,
        edges_sq=tuple(float(e) ** 2 for e in edges),
    )


def table_compact_params(type_idx, chain_code, bonded_next,
                         bonded_table, intra_table, inter_table, edges):
    """
    Compact tabulated force field: O(n) per-atom metadata plus
    ``(20, 20, bins)`` type tables — the scalable device representation.
    """
    intra_table = np.asarray(intra_table)
    n_bins = intra_table.shape[-1]
    if edges is None:
        cutoff_sq, edges_sq = _INF, None
    else:
        edges = np.asarray(edges, dtype=np.float64)
        cutoff_sq = float(edges[-1]) ** 2
        edges_sq = tuple(float(e) ** 2 for e in edges)
    return FFParams(
        kind="table_compact", n_bins=n_bins, cutoff_sq=cutoff_sq,
        edges_sq=edges_sq,
        type_idx=np.asarray(type_idx, dtype=np.int32),
        chain_code=np.asarray(chain_code, dtype=np.int32),
        bonded_next=np.asarray(bonded_next, dtype=bool),
        intra_table=intra_table,
        inter_table=np.asarray(inter_table),
        bonded_table=np.asarray(bonded_table),
    )


def with_overlay(params, off_mask, on_mask, values, has_value):
    """Return `params` with an additional (outer) patch overlay."""
    overlay = PatchOverlay(
        off_mask=np.asarray(off_mask, dtype=bool),
        on_mask=np.asarray(on_mask, dtype=bool),
        values=np.asarray(values),
        has_value=np.asarray(has_value, dtype=bool),
    )
    return dataclasses.replace(params, overlays=params.overlays + (overlay,))


def strip_overlays(params):
    """`params` without its patch overlays (the base family)."""
    return dataclasses.replace(params, overlays=())


def overlays_concrete(params):
    """Whether every overlay mask is concrete (the fused/matrix-free
    paths extract the affected pair set with ``np.nonzero`` at trace
    time, which tracers cannot support)."""
    return not any(
        isinstance(getattr(o, f), jax.core.Tracer)
        for o in params.overlays
        for f in ("off_mask", "on_mask", "values", "has_value")
    )


def overlay_candidate_pairs(params):
    """Upper-triangle pair indices ``(ii, jj)`` (concrete int32 numpy)
    of every pair any overlay could touch — the support of the sparse
    rank correction that lets the fused Pallas and matrix-free paths
    handle :class:`PatchOverlay` (reference ``forcefield.py:117-261``)
    without giving up their O(n)-parameter kernels."""
    if not params.overlays:
        return (np.empty(0, np.int32), np.empty(0, np.int32))
    if not overlays_concrete(params):
        raise ValueError(
            "patch overlays must be concrete host arrays for the "
            "fused/matrix-free paths (pass FFParams by closure, not "
            "as a jit argument)")
    n = np.asarray(params.overlays[0].off_mask).shape[0]
    union = np.zeros((n, n), dtype=bool)
    for o in params.overlays:
        union |= np.asarray(o.off_mask)
        union |= np.asarray(o.on_mask)
        union |= np.asarray(o.has_value)
    ii, jj = np.nonzero(np.triu(union, 1))
    return ii.astype(np.int32), jj.astype(np.int32)


def pair_base_constants(ii, jj, sq, params, xp, pos_i=None, pos_j=None):
    """Unmasked per-pair force constants of the *base* family for 1-D
    pair arrays — the sparse counterpart of :func:`_base_constants`.
    ``pos_i``/``pos_j`` override the positional indices used for the
    peptide-bond test of compact tables (needed when atoms have been
    reordered, e.g. Morton-sorted: pass the original positions)."""
    kind = params.kind
    if kind == "invariant":
        return xp.ones_like(sq)
    if kind == "hinsen":
        dist = xp.sqrt(sq)
        dist = xp.clip(dist, 2.9, None)
        return xp.where(dist < 4.0, dist * 8.6e2 - 2.39e3,
                        dist ** (-6) * 128e4)
    if kind == "pfenm":
        safe = xp.where(sq == 0, xp.ones_like(sq), sq)
        return 1.0 / safe
    if kind == "table_pair":
        table = xp.asarray(params.pair_table)
        bins = _pair_bin_indices(sq, params, xp)
        if bins is None:
            return table[ii, jj, 0]
        return table[ii, jj, bins]
    if kind == "table_compact":
        t = xp.asarray(params.type_idx)
        ti, tj = t[ii], t[jj]
        bins = _pair_bin_indices(sq, params, xp)
        if bins is None:
            bins = xp.zeros(sq.shape, dtype=xp.int32)
        intra = xp.asarray(params.intra_table)[ti, tj, bins]
        inter = xp.asarray(params.inter_table)[ti, tj, bins]
        chain = xp.asarray(params.chain_code)
        k = xp.where(chain[ii] == chain[jj], intra, inter)
        bonded_k = xp.asarray(params.bonded_table)[ti, tj, bins]
        bnext = xp.asarray(params.bonded_next)
        pi = ii if pos_i is None else pos_i
        pj = jj if pos_j is None else pos_j
        bonded = (((pj - pi) == 1) & bnext[ii]) | (
            ((pi - pj) == 1) & bnext[jj])
        return xp.where(bonded, bonded_k, k)
    raise ValueError(f"Unknown force-field kind '{kind}'")


def _pair_bin_indices(sq, params, xp):
    """1-D counterpart of :func:`_bin_indices`."""
    if params.edges_sq is None or params.n_bins == 1:
        return None
    idx = xp.searchsorted(xp.asarray(params.edges_sq), sq)
    return xp.clip(idx, 0, params.n_bins - 1)


def overlay_pair_delta(coord, params, xp, pos=None):
    """The sparse force-constant correction of the patch overlays:
    candidate pairs plus ``k_patched - k_base`` at each (traced where
    `coord` is traced; the pair set itself is static).

    ``pos`` optionally maps current slots to original atom positions
    (e.g. the Morton permutation of the block-sparse paths) for the
    compact-table peptide-bond test.

    Returns ``(ii, jj, delta, disp, safe_sq)`` with ``disp`` the
    ``(P, 3)`` pair displacements — everything a caller needs to
    scatter the Hessian/Kirchhoff superelement correction or apply it
    to a vector block at O(P) cost.
    """
    ii, jj = overlay_candidate_pairs(params)
    pos_i = None if pos is None else xp.asarray(pos)[ii]
    pos_j = None if pos is None else xp.asarray(pos)[jj]
    coord = xp.asarray(coord)
    disp = coord[ii] - coord[jj]
    sq = xp.sum(disp * disp, axis=-1)
    safe_sq = xp.where(sq == 0, xp.ones_like(sq), sq)

    base_adj = (sq <= params.cutoff_sq) if params.has_cutoff \
        else xp.ones(sq.shape, dtype=bool)
    k_raw = pair_base_constants(ii, jj, sq, params, xp,
                                pos_i=pos_i, pos_j=pos_j)
    zero = xp.zeros_like(k_raw)
    k_base = xp.where(base_adj, k_raw, zero)

    # Value pipeline + adjacency, in the reference order (see
    # force_constant_matrix / effective_adjacency)
    k_full = k_raw
    off_any = np.zeros(len(ii), dtype=bool)
    on_any = np.zeros(len(ii), dtype=bool)
    for o in params.overlays:
        has_value = np.asarray(o.has_value)[ii, jj]
        values = np.asarray(o.values)[ii, jj]
        k_full = xp.where(sq <= params.cutoff_sq, k_full, zero)
        k_full = xp.where(has_value, xp.asarray(values, k_raw.dtype),
                          k_full)
        off_any |= np.asarray(o.off_mask)[ii, jj]
        on_any |= np.asarray(o.on_mask)[ii, jj]
    adj = (base_adj & ~xp.asarray(off_any)) | xp.asarray(on_any)
    k_full = xp.where(adj, k_full, zero)
    return ii, jj, k_full - k_base, disp, safe_sq


# ---------------------------------------------------------------------------
# Dense evaluation
# ---------------------------------------------------------------------------

def pairwise_sq_distance(coord, xp):
    """
    Displacements and squared distances for all atom pairs.

    Uses the exact difference formulation (not the ``|x|^2 - 2 x.y``
    matmul trick) so the adjacency decision ``d^2 <= cutoff^2`` is
    bit-identical to the reference's brute-force path
    (``interaction.py:162-166``).

    Returns
    -------
    disp : ndarray, shape=(n, n, 3)
        ``coord[i] - coord[j]``.
    sq_dist : ndarray, shape=(n, n)
    """
    disp = coord[:, None, :] - coord[None, :, :]
    # Elementwise multiply + reduce, NOT einsum: an einsum contraction
    # lowers to dot_general, which at DEFAULT precision may run f32 in
    # TF32 on a GPU and corrupt distances (~1e-3) — enough to flip
    # cutoff/bin decisions and visibly bias covariance observables.
    sq_dist = xp.sum(disp * disp, axis=-1)
    return disp, sq_dist


def _adjacency(sq_dist, params, xp):
    """Boolean adjacency: within cutoff, excluding self-interactions."""
    n = sq_dist.shape[-1]
    eye = xp.eye(n, dtype=bool)
    if params.has_cutoff:
        adj = sq_dist <= params.cutoff_sq
    else:
        adj = xp.ones_like(eye)
    return adj & ~eye


def effective_adjacency(sq_dist, params, xp):
    """Final interaction set: cutoff adjacency with the concatenated
    patch overlays applied in the reference order — all shutdown/off
    patches first, then all pair_on re-enable
    (reference ``interaction.py:193-213``)."""
    adj = _adjacency(sq_dist, params, xp)
    if params.overlays:
        off_any = xp.zeros_like(adj)
        on_any = xp.zeros_like(adj)
        for overlay in params.overlays:
            off_any = off_any | xp.asarray(overlay.off_mask)
            on_any = on_any | xp.asarray(overlay.on_mask)
        adj = (adj & ~off_any) | on_any
    return adj


def _bin_indices(sq_dist, params, xp):
    """Distance-bin index per pair (clipped into range; pairs beyond the
    last edge are excluded by the adjacency mask)."""
    if params.edges_sq is None or params.n_bins == 1:
        return None
    idx = xp.searchsorted(xp.asarray(params.edges_sq), sq_dist)
    return xp.clip(idx, 0, params.n_bins - 1)


def _base_constants(sq_dist, params, xp):
    """Unmasked force constants for the base family (no adjacency yet)."""
    kind = params.kind
    if kind == "invariant":
        return xp.ones_like(sq_dist)
    if kind == "hinsen":
        # Reference forcefield.py:321-326
        dist = xp.sqrt(sq_dist)
        dist = xp.clip(dist, 2.9, None)
        return xp.where(dist < 4.0, dist * 8.6e2 - 2.39e3,
                        dist ** (-6) * 128e4)
    if kind == "pfenm":
        # Reference forcefield.py:361-362; guard the diagonal (d=0),
        # which the adjacency mask removes anyway.
        safe = xp.where(sq_dist == 0, 1.0, sq_dist)
        return 1.0 / safe
    if kind == "table_pair":
        table = xp.asarray(params.pair_table)
        bins = _bin_indices(sq_dist, params, xp)
        if bins is None:
            return table[..., 0]
        return xp.take_along_axis(table, bins[..., None], axis=-1)[..., 0]
    if kind == "table_compact":
        return _compact_constants(sq_dist, params, xp)
    raise ValueError(f"Unknown force-field kind '{kind}'")


def _compact_constants(sq_dist, params, xp):
    """Tabulated constants from (20, 20, bins) type tables via gathers —
    the device analogue of reference ``forcefield.py:475-533``."""
    t = xp.asarray(params.type_idx)
    ti = t[:, None]
    tj = t[None, :]
    bins = _bin_indices(sq_dist, params, xp)
    if bins is None:
        bins = xp.zeros_like(sq_dist, dtype=xp.int32)

    intra = xp.asarray(params.intra_table)[ti, tj, bins]
    inter = xp.asarray(params.inter_table)[ti, tj, bins]
    chain = xp.asarray(params.chain_code)
    same_chain = chain[:, None] == chain[None, :]
    k = xp.where(same_chain, intra, inter)

    # Peptide-bonded pairs (i, i+1) overwrite the non-bonded values
    # (reference forcefield.py:501-509)
    bonded_k = xp.asarray(params.bonded_table)[ti, tj, bins]
    n = sq_dist.shape[-1]
    row = xp.arange(n)
    upper = (row[None, :] - row[:, None]) == 1   # j == i + 1
    bnext = xp.asarray(params.bonded_next)
    bonded_mask = upper & bnext[:, None]
    bonded_mask = bonded_mask | bonded_mask.T
    return xp.where(bonded_mask, bonded_k, k)


def force_constant_matrix(sq_dist, params, xp, dtype=None):
    """
    Dense masked force-constant matrix ``k[i, j]`` (zero on the diagonal
    and outside the interaction set).

    This is the device-idiomatic replacement for the sparse
    ``force_field.force_constant(pairs...)`` call at reference
    ``interaction.py:49,95``.
    """
    adj = effective_adjacency(sq_dist, params, xp)
    k = _base_constants(sq_dist, params, xp)

    if params.overlays:
        # Value pipeline, innermost patch outward: pairs beyond the
        # wrapped field's cutoff contribute zero (forcefield.py:188-195)
        # and per-pair constants override wherever defined
        # (forcefield.py:197-223).
        for overlay in params.overlays:
            has_value = xp.asarray(overlay.has_value)
            values = xp.asarray(overlay.values)
            k = xp.where(sq_dist <= params.cutoff_sq, k, xp.zeros_like(k))
            k = xp.where(has_value, values.astype(k.dtype), k)

    k = xp.where(adj, k, xp.zeros_like(k))
    if dtype is not None:
        k = k.astype(dtype)
    return k
