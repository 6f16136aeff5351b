"""
Matrix-free ENM operators: ``H @ X`` without materializing the Hessian.

The dense pipelines materialize the ``(3n, 3n)`` Hessian — fine up to
the mega-assembly regime (a 30k-dim float32 Hessian is 3.6 GB),
impossible far beyond it (100k residues -> 360 GB).  The reference has
no answer at all at this scale: its dense ``np.linalg.eigh`` path
(reference ``nma.py:61``) is O(n^3) time *and* O(n^2) memory.

This module keeps the operator implicit.  An ANM Hessian-vector product
needs only the coordinates and the force-field rule:

    y_i^a = sum_j g_ij d^a_ij d^b_ij x_j^b  -  (sum_j g_ij d^a_ij d^b_ij) x_i^b

with ``d_ij = r_i - r_j`` and ``g_ij = -k_ij / |d_ij|^2`` — evaluated
tile-by-tile, O(tile * n) live memory.  Two implementations:

* :func:`hessian_apply` — row-blocked XLA (``lax.map``) over the dense
  pair grid; runs anywhere, reference implementation for tests and the
  per-shard body of the multi-chip path.
* :func:`hessian_apply_pallas_sparse` — a Pallas kernel (Triton route)
  over Morton-sorted tiles that visits only the tile pairs within the
  cutoff: O(n * neighbours) instead of O(n^2).

On top sits :func:`lowest_modes_matfree`: Chebyshev-filtered subspace
iteration (Zhou & Saad style) with the rigid-body null space shifted
into the damped band — the ``k`` lowest non-trivial modes of systems
whose Hessian cannot be stored.  All stages are matmuls / QR on an
``(m, p)`` block; nothing O(n^2) is ever resident.

Supported force-field families: ``invariant``, ``hinsen``, ``pfenm``,
``table_compact`` — the families whose parameters are O(n).  Patch
overlays (``PatchedForceField``) ride on top as a sparse O(P) rank
correction (:func:`overlay_apply_hessian` / :func:`overlay_apply_kirchhoff`)
applied after the base-family operator.  ``table_pair`` fields are
O(n^2)-parameterized by construction, so the dense path is the right
tool there.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from . import rigid
from ..utils import config

__all__ = [
    "hessian_apply",
    "hessian_apply_pallas_sparse",
    "kirchhoff_apply",
    "kirchhoff_apply_pallas_sparse",
    "overlay_apply_hessian",
    "overlay_apply_kirchhoff",
    "estimate_lambda_max",
    "hessian_degree_bound",
    "spatial_sort_permutation",
    "supports_params",
    "tile_neighbor_lists",
    "lowest_modes_matfree",
    "lowest_modes_matfree_gnm",
    "hessian_diag_blocks",
    "covariance_solve_matfree",
    "covariance_solve_matfree_gnm",
    "dcc_rows_matfree",
    "dcc_rows_matfree_gnm",
    "kirchhoff_degree",
    "prs_rows_matfree",
    "prs_diag_from_modes",
    "prs_diag_stochastic",
    "effector_sensor_matfree",
    "effector_sensor_from_modes",
    "effector_sensor_stochastic",
    "msf_stochastic",
    "msf_stochastic_gnm",
    "linear_response_matfree",
    "matfree_mode_residuals",
]

_HIGHEST = jax.lax.Precision.HIGHEST

#: Atoms per tile of the block-sparse apply (rows and columns alike).
#: 16 is the smallest Triton dot operand and was the fastest tile on
#: the card (see PERF.md)
SPARSE_TILE = 16


def supports_params(params):
    """O(n)-parameter families the matrix-free operators handle.  Patch
    overlays are supported via a sparse post-pass rank correction as
    long as their masks are concrete — the affected pair set is
    extracted host-side at trace time."""
    from . import ffparams as _fp

    return params.kind in ("invariant", "hinsen", "pfenm",
                           "table_compact") \
        and (not params.overlays or _fp.overlays_concrete(params))


def _analytic_constants(kind, sq):
    """Unmasked spring constants for the analytic families, written
    with the operations every Pallas route lowers.  Semantics match the
    reference (``forcefield.py:264-366``)."""
    if kind == "invariant":
        return jnp.ones_like(sq)
    if kind == "hinsen":
        dist = jnp.maximum(jnp.sqrt(sq), 2.9)
        return jnp.where(dist < 4.0, dist * 8.6e2 - 2.39e3,
                         (1.28e6) / (sq * sq * sq))
    if kind == "pfenm":
        return 1.0 / jnp.where(sq == 0, 1.0, sq)
    raise NotImplementedError(kind)


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def _check_params(params):
    if not supports_params(params):
        raise ValueError(
            f"matrix-free path does not support kind={params.kind!r} "
            f"(O(n^2) parameters — use the dense assembly instead); "
            "patch overlays are supported only with concrete masks "
            "(pass FFParams by closure, not as a jit argument)"
        )


def _pad_compact_meta(params, n, n_pad):
    """Padded (n_pad,) per-atom metadata plus the type tables for
    ``table_compact`` — everything array-valued the blocked evaluators
    need, passed as *arguments* (not closures) so callers can route
    them through jit/shard_map boundaries without baking constants.

    Chain padding is -1 (never a real chain code) so padded atoms are
    never same-chain; padded atoms are never bonded.  Padded pairs are
    masked by index anyway."""
    type_idx = jnp.zeros(n_pad, jnp.int32).at[:n].set(
        jnp.asarray(params.type_idx, jnp.int32))
    chain = jnp.full(n_pad, -1, jnp.int32).at[:n].set(
        jnp.asarray(params.chain_code, jnp.int32))
    bonded = jnp.zeros(n_pad, jnp.int32).at[:n].set(
        jnp.asarray(params.bonded_next).astype(jnp.int32))
    return (type_idx, chain, bonded,
            jnp.asarray(params.intra_table),
            jnp.asarray(params.inter_table),
            jnp.asarray(params.bonded_table))


def _rect_constants(sq, rows, cols, n, params, meta):
    """Masked force constants for a rectangular (R, C) index block.

    `rows` / `cols` are global atom indices; zeros outside the
    interaction set (beyond cutoff, self-pairs, padding)."""
    valid = (rows[:, None] != cols[None, :]) \
        & (rows < n)[:, None] & (cols < n)[None, :]
    if params.has_cutoff:
        valid &= sq <= params.cutoff_sq

    kind = params.kind
    if kind != "table_compact":
        k = _analytic_constants(kind, sq)
    else:
        type_idx, chain, bonded, intra_t, inter_t, bond_t = meta
        ti = type_idx[rows]
        tj = type_idx[cols]
        if params.n_bins > 1:
            edges = jnp.asarray(params.edges_sq, sq.dtype)
            bins = jnp.clip(jnp.searchsorted(edges, sq), 0,
                            params.n_bins - 1)
        else:
            bins = jnp.zeros(sq.shape, jnp.int32)
        intra = intra_t.astype(sq.dtype)[ti[:, None], tj[None, :], bins]
        inter = inter_t.astype(sq.dtype)[ti[:, None], tj[None, :], bins]
        bond = bond_t.astype(sq.dtype)[ti[:, None], tj[None, :], bins]
        same_chain = chain[rows][:, None] == chain[cols][None, :]
        delta = cols[None, :] - rows[:, None]
        is_bonded = ((delta == 1) & (bonded[rows][:, None] != 0)) \
            | ((delta == -1) & (bonded[cols][None, :] != 0))
        k = jnp.where(is_bonded, bond, jnp.where(same_chain, intra, inter))
    return jnp.where(valid, k, 0.0)


# ---------------------------------------------------------------------------
# XLA row-blocked applies
# ---------------------------------------------------------------------------

def _as_block_input(x, n, dtype):
    """Normalize x to (3, n, k) xyz-plane component layout."""
    x = jnp.asarray(x, dtype=dtype)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    if x.shape[0] != 3 * n:
        raise ValueError(
            f"x has {x.shape[0]} rows, expected 3n = {3 * n}")
    return x.reshape(3, n, -1), squeeze


def _make_row_block(coord_p, x_p, params, meta, n, block):
    """Closure computing one (3, block, k) output row block of
    ``H @ x`` at atom-row offset ``r0``; `coord_p` / `x_p` may be
    padded, `n` is the true atom count."""
    cols = jnp.arange(coord_p.shape[0])
    k_vec = x_p.shape[-1]
    dtype = x_p.dtype

    def one_block(r0):
        rows = r0 + jnp.arange(block)
        cr = jax.lax.dynamic_slice(coord_p, (r0, 0), (block, 3))
        d = cr[:, None, :] - coord_p[None, :, :]        # (B, n_pad, 3)
        sq = jnp.sum(d * d, axis=-1)
        kmat = _rect_constants(sq, rows, cols, n, params, meta)
        g = -kmat / jnp.where(sq == 0, 1.0, sq)
        xr = jax.lax.dynamic_slice(x_p, (0, r0, 0), (3, block, k_vec))
        y = jnp.zeros((3, block, k_vec), dtype)
        for a in range(3):
            acc = jnp.zeros((block, k_vec), dtype)
            for b in range(3):
                plane = g * d[..., a] * d[..., b]       # (B, n_pad)
                acc = acc + jnp.matmul(plane, x_p[b],
                                       precision=_HIGHEST)
                acc = acc - jnp.sum(plane, axis=1)[:, None] * xr[b]
            y = y.at[a].set(acc)
        return y

    return one_block


def overlay_apply_hessian(coord, x, params, *, dtype=jnp.float32,
                          pos=None):
    """``(Delta H) @ x`` for the patch-overlay sparse correction in xyz
    layout — O(P * k) gathers/scatters for P affected pairs, letting
    every matrix-free operator support ``PatchedForceField`` without
    touching its O(n)-parameter kernel.  ``pos`` maps slots to original
    atom positions for reordered (Morton-sorted) layouts."""
    from . import ffparams as _ffp

    coord = jnp.asarray(coord, dtype=dtype)
    n = coord.shape[0]
    xb, squeeze = _as_block_input(x, n, dtype)
    ii, jj, delta, disp, safe_sq = _ffp.overlay_pair_delta(
        coord, params, jnp, pos=pos)
    k_vec = xb.shape[-1]
    if len(ii) == 0:
        z = jnp.zeros((3 * n, k_vec), dtype)
        return z[:, 0] if squeeze else z
    g = (delta / safe_sq).astype(dtype)
    disp = disp.astype(dtype)
    diff = xb[:, ii, :] - xb[:, jj, :]                  # (3, P, k)
    s = g[:, None] * sum(disp[:, a][:, None] * diff[a]
                         for a in range(3))             # (P, k)
    y = jnp.zeros((3, n, k_vec), dtype)
    for a in range(3):
        contrib = disp[:, a][:, None] * s
        y = y.at[a, ii].add(contrib).at[a, jj].add(-contrib)
    y = y.reshape(3 * n, k_vec)
    return y[:, 0] if squeeze else y


def overlay_apply_kirchhoff(coord, x, params, *, dtype=jnp.float32,
                            pos=None):
    """``(Delta K) @ x`` — GNM counterpart of
    :func:`overlay_apply_hessian` (``x``: ``(n, k)`` or ``(n,)``)."""
    from . import ffparams as _ffp

    coord = jnp.asarray(coord, dtype=dtype)
    n = coord.shape[0]
    x = jnp.asarray(x, dtype=dtype)
    squeeze = x.ndim == 1
    xb = x[:, None] if squeeze else x
    ii, jj, delta, _, _ = _ffp.overlay_pair_delta(coord, params, jnp,
                                                  pos=pos)
    if len(ii) == 0:
        z = jnp.zeros_like(xb)
        return z[:, 0] if squeeze else z
    t = delta.astype(dtype)[:, None] * (xb[ii] - xb[jj])
    y = jnp.zeros_like(xb).at[ii].add(t).at[jj].add(-t)
    return y[:, 0] if squeeze else y


def _strip(params):
    from . import ffparams as _ffp

    return _ffp.strip_overlays(params)


def hessian_apply(coord, x, params, *, block=512, dtype=jnp.float32):
    """
    ``H @ x`` for the xyz-layout ANM Hessian, without materializing it.

    Row-blocked XLA implementation: O(block * n) live memory.  Exactly
    matches ``assembly.hessian_matrix(coord, params, layout="xyz") @ x``
    (reference semantics: ``interaction.py:57-111``).  Patch overlays
    are applied as a sparse O(P * k) correction on top of the base
    family (:func:`overlay_apply_hessian`).

    Parameters
    ----------
    coord : ndarray, shape=(n, 3)
    x : ndarray, shape=(3n, k) or (3n,)
        Block of vectors in xyz plane layout.
    params : FFParams
        Must have O(n) base parameters (see :func:`supports_params`).

    Returns
    -------
    y : ndarray, same shape as `x`
    """
    if params.overlays:
        _check_params(params)
        return (_hessian_apply_base(coord, x, _strip(params),
                                    block=block, dtype=dtype)
                + overlay_apply_hessian(coord, x, params, dtype=dtype))
    return _hessian_apply_base(coord, x, params, block=block,
                               dtype=dtype)


@functools.partial(jax.jit, static_argnames=("block", "dtype"))
def _hessian_apply_base(coord, x, params, *, block=512,
                        dtype=jnp.float32):
    _check_params(params)
    coord = jnp.asarray(coord, dtype=dtype)
    n = coord.shape[0]
    xb, squeeze = _as_block_input(x, n, dtype)
    k_vec = xb.shape[-1]

    n_pad = _round_up(n, block)
    coord_p = jnp.zeros((n_pad, 3), dtype).at[:n].set(coord)
    x_p = jnp.zeros((3, n_pad, k_vec), dtype).at[:, :n].set(xb)
    meta = (_pad_compact_meta(params, n, n_pad)
            if params.kind == "table_compact" else None)

    one_block = _make_row_block(coord_p, x_p, params, meta, n, block)
    starts = jnp.arange(n_pad // block) * block
    blocks = jax.lax.map(one_block, starts)             # (nb, 3, B, k)
    y = jnp.moveaxis(blocks, 1, 0).reshape(3, n_pad, k_vec)[:, :n]
    y = y.reshape(3 * n, k_vec)
    return y[:, 0] if squeeze else y


def kirchhoff_apply(coord, x, params, *, block=512, dtype=jnp.float32):
    """
    ``K @ x`` for the GNM Kirchhoff matrix, without materializing it
    (reference semantics: ``interaction.py:14-54``).  Patch overlays
    are applied as a sparse correction (:func:`overlay_apply_kirchhoff`).

    `x` is ``(n, k)`` or ``(n,)``.
    """
    if params.overlays:
        _check_params(params)
        return (_kirchhoff_apply_base(coord, x, _strip(params),
                                      block=block, dtype=dtype)
                + overlay_apply_kirchhoff(coord, x, params,
                                          dtype=dtype))
    return _kirchhoff_apply_base(coord, x, params, block=block,
                                 dtype=dtype)


@functools.partial(jax.jit, static_argnames=("block", "dtype"))
def _kirchhoff_apply_base(coord, x, params, *, block=512,
                          dtype=jnp.float32):
    _check_params(params)
    coord = jnp.asarray(coord, dtype=dtype)
    n = coord.shape[0]
    x = jnp.asarray(x, dtype=dtype)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    k_vec = x.shape[-1]

    n_pad = _round_up(n, block)
    coord_p = jnp.zeros((n_pad, 3), dtype).at[:n].set(coord)
    x_p = jnp.zeros((n_pad, k_vec), dtype).at[:n].set(x)
    meta = (_pad_compact_meta(params, n, n_pad)
            if params.kind == "table_compact" else None)
    cols = jnp.arange(n_pad)

    def one_block(r0):
        rows = r0 + jnp.arange(block)
        cr = jax.lax.dynamic_slice(coord_p, (r0, 0), (block, 3))
        d = cr[:, None, :] - coord_p[None, :, :]
        sq = jnp.sum(d * d, axis=-1)
        kmat = _rect_constants(sq, rows, cols, n, params, meta)
        xr = jax.lax.dynamic_slice(x_p, (r0, 0), (block, k_vec))
        return (-jnp.matmul(kmat, x_p, precision=_HIGHEST)
                + jnp.sum(kmat, axis=1)[:, None] * xr)

    starts = jnp.arange(n_pad // block) * block
    y = jax.lax.map(one_block, starts).reshape(n_pad, k_vec)[:n]
    return y[:, 0] if squeeze else y


# ---------------------------------------------------------------------------
# Block-sparse apply: spatial sort + tile neighbour lists + one Pallas
# kernel on the Triton route.  This is the successor of the reference's
# CellList (reference interaction.py:154-159): instead of per-atom
# neighbour lists, atoms are ordered along a Morton curve so that each
# fixed-size tile is spatially compact, and each program of the kernel
# walks only the column tiles whose bounding boxes lie within the cutoff
# of its row tile — O(n * neighbours) work instead of the O(n^2) pair
# grid of :func:`hessian_apply`.
# ---------------------------------------------------------------------------


def _part1by2(v):
    """Spread the lower 21 bits of `v` so consecutive bits are 3 apart
    (uint64 Morton helper)."""
    v = v.astype(np.uint64) & np.uint64(0x1FFFFF)
    v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
    return v


def spatial_sort_permutation(coord, cell=8.0):
    """
    Permutation ordering atoms along a Morton (Z-order) curve over
    `cell`-sized grid cells, so that consecutive atoms — and hence the
    kernel's fixed-size tiles — are spatially compact.  Host-side
    (NumPy); applied once per structure.
    """
    coord = np.asarray(coord, dtype=np.float64)
    q = np.floor((coord - coord.min(axis=0)) / float(cell))
    q = np.clip(q, 0, 2**21 - 1).astype(np.uint64)
    key = (_part1by2(q[:, 0])
           | (_part1by2(q[:, 1]) << np.uint64(1))
           | (_part1by2(q[:, 2]) << np.uint64(2)))
    return np.argsort(key, kind="stable")


def tile_neighbor_lists(coord, cutoff, tile=SPARSE_TILE):
    """
    Tile-level neighbor lists: for each row tile, the column tiles whose
    axis-aligned bounding boxes are within `cutoff` — a conservative
    superset of the interacting pairs (the kernel still applies the
    exact per-pair cutoff).  Effective only if atoms are spatially
    ordered first (:func:`spatial_sort_permutation`).

    Returns
    -------
    nbr : ndarray, shape=(sum(counts),), int32
        Neighbor tile indices of all row tiles, row after row (no
        padding: a few row tiles that straddle a jump of the Morton
        curve have many times the mean count).
    counts : ndarray, shape=(n_tiles,), int32
        Number of entries per row tile.
    """
    coord = np.asarray(coord, dtype=np.float64)
    n = coord.shape[0]
    n_tiles = _round_up(n, tile) // tile
    mins = np.empty((n_tiles, 3))
    maxs = np.empty((n_tiles, 3))
    for t in range(n_tiles):
        blk = coord[t * tile:min((t + 1) * tile, n)]
        mins[t] = blk.min(axis=0)
        maxs[t] = blk.max(axis=0)
    # AABB pair gaps per axis: max(0, min_i - max_j, min_j - max_i),
    # one row tile at a time so memory stays O(n_tiles)
    cut2 = float(cutoff) ** 2
    rows = []
    for t in range(n_tiles):
        gap = np.maximum(np.maximum(mins[t] - maxs, mins - maxs[t]), 0.0)
        adj = np.sum(gap * gap, axis=-1) <= cut2
        adj[t] = True
        rows.append(np.nonzero(adj)[0].astype(np.int32))
    counts = np.array([len(r) for r in rows], dtype=np.int32)
    return np.concatenate(rows), counts


def _compact_tile_constants(sq, row_ids, col_ids, params, meta):
    """Tabulated constants for one tile pair, gathered from the flat
    ``(3, 20, 20, n_bins)`` table (intra-chain, inter-chain, bonded)
    at ``((relation * 20 + type_i) * 20 + type_j) * n_bins + bin``."""
    type_rows, type_cols, chain_rows, chain_cols, bonded_rows, \
        bonded_cols, table_ref = meta
    n_bins = params.n_bins
    bins = jnp.zeros(sq.shape, jnp.int32)
    if n_bins > 1:
        # searchsorted(side='left'): the number of edges strictly below
        for edge_sq in np.asarray(params.edges_sq, dtype=np.float32):
            bins = bins + (sq > edge_sq).astype(jnp.int32)
        bins = jnp.minimum(bins, n_bins - 1)
    delta = col_ids[None, :] - row_ids[:, None]
    bonded = (((delta == 1) & (bonded_rows[:, None] != 0))
              | ((delta == -1) & (bonded_cols[None, :] != 0)))
    relation = jnp.where(
        bonded, 2, jnp.where(chain_rows[:, None] == chain_cols[None, :],
                             0, 1))
    pair_type = (relation * 20 + type_rows[:, None]) * 20 \
        + type_cols[None, :]
    return table_ref[pair_type * n_bins + bins]


def _compact_device_inputs(params, n, n_pad, dtype):
    """Padded per-atom metadata of the compact tabulated family for the
    sparse kernel — type indices, chain codes and bonded flags
    ``(n_pad,)`` — and the flattened ``(3 * 20 * 20 * n_bins,)`` table
    stack (intra, inter, bonded).  Chain padding is -1, never a real
    chain code; padded atoms are masked by id anyway."""
    type_idx, chain, bonded, intra, inter, bond = _pad_compact_meta(
        params, n, n_pad)
    table = jnp.stack([intra, inter, bond]).astype(dtype).reshape(-1)
    return type_idx, chain, bonded, table


#: Unique (a, b) component pairs of the symmetric 3x3 superelements
_SYM_PAIRS = ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))


def _sparse_kernel(params, n, tile, vec3, *refs):
    """Program ``i``: row tile ``i`` of ``H @ X`` (``vec3``) or
    ``K @ X``.  The program loads its own neighbour-tile list, loops
    over those column tiles only, keeps the row block's sums in
    registers, and writes the row block once — no state crosses
    programs, so they run in any order.  The Hessian superelements are
    symmetric, so six component planes serve all nine products."""
    compact = params.kind == "table_compact"
    (nbr_ref, starts_ref, counts_ref, cx_ref, cy_ref, cz_ref,
     ids_ref) = refs[:7]
    if compact:
        type_ref, chain_ref, bonded_ref, table_ref = refs[7:11]
        x_ref, out_ref = refs[11:13]
    else:
        x_ref, out_ref = refs[7:9]

    i = pl.program_id(0)
    start = starts_ref[i]
    rows = pl.ds(i * tile, tile)
    rx, ry, rz = cx_ref[rows], cy_ref[rows], cz_ref[rows]
    rid = ids_ref[rows]
    if compact:
        row_meta = (type_ref[rows], chain_ref[rows], bonded_ref[rows])

    def constants(cols):
        dx = rx[:, None] - cx_ref[cols][None, :]
        dy = ry[:, None] - cy_ref[cols][None, :]
        dz = rz[:, None] - cz_ref[cols][None, :]
        sq = dx * dx + dy * dy + dz * dz
        cid = ids_ref[cols]
        valid = ((rid[:, None] != cid[None, :]) & (rid < n)[:, None]
                 & (cid < n)[None, :])
        if params.has_cutoff:
            valid &= sq <= np.float32(params.cutoff_sq)
        if compact:
            meta = (row_meta[0], type_ref[cols], row_meta[1],
                    chain_ref[cols], row_meta[2], bonded_ref[cols],
                    table_ref)
            k = _compact_tile_constants(sq, rid, cid, params, meta)
        else:
            k = _analytic_constants(params.kind, sq)
        return jnp.where(valid, k, 0.0), sq, (dx, dy, dz)

    k_cols = x_ref.shape[-1]
    if vec3:
        def body(j, carry):
            acc, dsum = carry
            cols = pl.ds(nbr_ref[start + j] * tile, tile)
            k, sq, disp = constants(cols)
            g = -k / jnp.where(sq == 0, 1.0, sq)
            xc = [x_ref[b, cols, :] for b in range(3)]
            acc, dsum = list(acc), list(dsum)
            for p, (a, b) in enumerate(_SYM_PAIRS):
                plane = g * disp[a] * disp[b]
                acc[a] = acc[a] + jnp.dot(plane, xc[b], precision=_HIGHEST)
                if a != b:
                    acc[b] = acc[b] + jnp.dot(plane, xc[a],
                                              precision=_HIGHEST)
                dsum[p] = dsum[p] + jnp.sum(plane, axis=1)
            return tuple(acc), tuple(dsum)

        zero_acc = jnp.zeros((tile, k_cols), x_ref.dtype)
        zero_sum = jnp.zeros((tile,), x_ref.dtype)
        acc, dsum = jax.lax.fori_loop(
            0, counts_ref[i], body,
            ((zero_acc,) * 3, (zero_sum,) * len(_SYM_PAIRS)))
        xr = [x_ref[b, rows, :] for b in range(3)]
        acc = list(acc)
        for p, (a, b) in enumerate(_SYM_PAIRS):
            acc[a] = acc[a] - dsum[p][:, None] * xr[b]
            if a != b:
                acc[b] = acc[b] - dsum[p][:, None] * xr[a]
        for a in range(3):
            out_ref[a, rows, :] = acc[a]
    else:
        def body(j, carry):
            acc, deg = carry
            cols = pl.ds(nbr_ref[start + j] * tile, tile)
            k, _, _ = constants(cols)
            acc = acc - jnp.dot(k, x_ref[cols, :], precision=_HIGHEST)
            return acc, deg + jnp.sum(k, axis=1)

        acc, deg = jax.lax.fori_loop(
            0, counts_ref[i], body,
            (jnp.zeros((tile, k_cols), x_ref.dtype),
             jnp.zeros((tile,), x_ref.dtype)))
        out_ref[rows, :] = acc + deg[:, None] * x_ref[rows, :]


def _launch_sparse(params, coord, x_p, nbr, counts, orig_ids, tile, vec3,
                   interpret):
    """Pad the per-atom inputs to whole tiles and run
    :func:`_sparse_kernel` with one program per row tile.  ``x_p`` is
    already padded to ``(3, n_pad, k_pad)`` (``vec3``) or
    ``(n_pad, k_pad)``."""
    if tile < 16 or tile & (tile - 1):
        raise ValueError(f"tile must be a power of two >= 16, got {tile}")
    n = coord.shape[0]
    n_pad = _round_up(n, tile)
    n_tiles = n_pad // tile
    counts = jnp.asarray(counts, jnp.int32)
    if counts.shape[0] != n_tiles:
        raise ValueError(
            f"counts has {counts.shape[0]} rows for {n_tiles} tiles — "
            "rebuild with tile_neighbor_lists(coord, cutoff, tile)")
    dtype = x_p.dtype
    cpad = jnp.zeros((n_pad, 3), dtype).at[:n].set(coord)
    if orig_ids is None:
        orig_ids = jnp.arange(n, dtype=jnp.int32)
    # Padding slots get id n, which masks them out of every pair
    ids = jnp.full(n_pad, n, jnp.int32).at[:n].set(
        jnp.asarray(orig_ids, jnp.int32))
    starts = jnp.cumsum(counts, dtype=jnp.int32) - counts
    inputs = [jnp.asarray(nbr, jnp.int32), starts, counts,
              cpad[:, 0], cpad[:, 1], cpad[:, 2], ids]
    if params.kind == "table_compact":
        inputs += list(_compact_device_inputs(params, n, n_pad, dtype))
    return pl.pallas_call(
        functools.partial(_sparse_kernel, params, n, tile, vec3),
        grid=(n_tiles,),
        out_shape=jax.ShapeDtypeStruct(x_p.shape, dtype),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="sparse_hessian_apply" if vec3 else "sparse_kirchhoff_apply",
    )(*inputs, x_p)


def _vector_block_width(k):
    # Triton blocks are powers of two, and a dot operand needs >= 16
    return max(16, 1 << (int(k) - 1).bit_length())


def hessian_apply_pallas_sparse(coord, x, params, nbr, counts,
                                orig_ids=None, tile=SPARSE_TILE,
                                dtype=jnp.float32, interpret=False):
    """
    Block-sparse matrix-free ``H @ x``: one Pallas program (Triton
    route) per row tile walks that tile's neighbour-tile list (from
    :func:`tile_neighbor_lists`), so work and memory traffic are both
    O(n * neighbour tiles) — the GPU analogue of the reference's
    cell-list pair pruning.  The lists are unpadded, so a jitted solver
    that closes over them embeds only the tile pairs that exist.

    The kernel is compiled for CUDA GPUs; elsewhere it runs only with
    ``interpret=True`` (the Pallas interpreter, for tests).  All plane
    contractions run at ``HIGHEST`` precision: float32 operands
    in TF32 would put ~1e-3 relative noise on the operator, which the
    soft modes cannot tolerate.

    Parameters
    ----------
    coord : ndarray, shape=(n, 3)
        Atom coordinates, ideally spatially sorted
        (:func:`spatial_sort_permutation`) so tiles are compact.
    orig_ids : ndarray, shape=(n,), int32, optional
        Original atom index per (sorted) slot — keeps self-pair masking
        and ``table_compact`` peptide bonds exact under reordering.
        Defaults to ``arange(n)`` (unsorted layout).
    tile : int
        Atoms per tile, a power of two >= 16; must match the tile the
        neighbour lists were built with.
    """
    _check_params(params)
    if params.overlays:
        # Overlay masks must arrive in the SAME (sorted) order as
        # `coord` (see _sparse_setup); orig_ids supplies the original
        # positions for the compact-table peptide-bond test.
        return (hessian_apply_pallas_sparse(
                    coord, x, _strip(params), nbr, counts,
                    orig_ids=orig_ids, tile=tile, dtype=dtype,
                    interpret=interpret)
                + overlay_apply_hessian(coord, x, params, dtype=dtype,
                                        pos=orig_ids))
    coord = jnp.asarray(coord, dtype=dtype)
    n = coord.shape[0]
    xb, squeeze = _as_block_input(x, n, dtype)
    k_vec = xb.shape[-1]
    k_pad = _vector_block_width(k_vec)
    n_pad = _round_up(n, tile)
    x_p = jnp.zeros((3, n_pad, k_pad), dtype).at[:, :n, :k_vec].set(xb)
    out = _launch_sparse(params, coord, x_p, nbr, counts, orig_ids, tile,
                         True, interpret)
    y = out[:, :n, :k_vec].reshape(3 * n, k_vec)
    return y[:, 0] if squeeze else y


def kirchhoff_apply_pallas_sparse(coord, x, params, nbr, counts,
                                  orig_ids=None, tile=SPARSE_TILE,
                                  dtype=jnp.float32, interpret=False):
    """
    Block-sparse matrix-free ``K @ x`` for the GNM Kirchhoff operator
    (see :func:`hessian_apply_pallas_sparse`; `x` is ``(n, k)`` or
    ``(n,)``).
    """
    _check_params(params)
    if params.overlays:
        return (kirchhoff_apply_pallas_sparse(
                    coord, x, _strip(params), nbr, counts,
                    orig_ids=orig_ids, tile=tile, dtype=dtype,
                    interpret=interpret)
                + overlay_apply_kirchhoff(coord, x, params,
                                          dtype=dtype, pos=orig_ids))
    coord = jnp.asarray(coord, dtype=dtype)
    n = coord.shape[0]
    x = jnp.asarray(x, dtype=dtype)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    k_vec = x.shape[-1]
    k_pad = _vector_block_width(k_vec)
    n_pad = _round_up(n, tile)
    x_p = jnp.zeros((n_pad, k_pad), dtype).at[:n, :k_vec].set(x)
    out = _launch_sparse(params, coord, x_p, nbr, counts, orig_ids, tile,
                         False, interpret)
    y = out[:n, :k_vec]
    return y[:, 0] if squeeze else y


# ---------------------------------------------------------------------------
# Chebyshev-filtered subspace iteration
# ---------------------------------------------------------------------------

def estimate_lambda_max(matvec, m, n_iter=50, safety=1.1, seed=0,
                        dtype=jnp.float32):
    """
    Upper bound on the largest eigenvalue of a PSD operator by power
    iteration (`n_iter` applies of a single vector) with a `safety`
    factor.  The Chebyshev filter needs ``b >= lambda_max``; modest
    overshoot only widens the damped band slightly.
    """
    v = jnp.cos(jnp.arange(m, dtype=dtype) * 0.7 + seed) + 1e-3
    v = v / jnp.linalg.norm(v)

    def step(_, v):
        w = matvec(v)
        return w / jnp.linalg.norm(w)

    v = jax.lax.fori_loop(0, n_iter, step, v)
    w = matvec(v)
    # ||H v|| >= rayleigh(v); still a lower bound on lambda_max, hence
    # the safety factor.
    return safety * jnp.linalg.norm(w)


def hessian_degree_bound(coord, params, *, masses=None, block=512,
                         dtype=jnp.float32):
    """
    Guaranteed upper bound on the largest eigenvalue of the (optionally
    mass-weighted) ANM Hessian, by block-row Gershgorin:

        lambda_max <= max_i w_i * (sum_j k_ij w_j + w_i sum_j k_ij)

    (each 3x3 superelement has spectral norm ``k_ij``; the diagonal
    block is the negated row sum).  With unit weights this is
    ``2 * max_i degree_i``.  One blocked matrix-free pass, O(block * n)
    memory.  Unlike power iteration this can never under-estimate, so
    it is safe as the Chebyshev filter's upper edge.  Patch overlays
    add ``max_i w_i (sum_j |delta_ij| w_j + w_i sum_j |delta_ij|)`` —
    still an upper bound (triangle inequality on the perturbed
    constants), possibly looser.
    """
    if params.overlays:
        from . import ffparams as _ffp

        base = _hessian_degree_bound_base(
            coord, _strip(params), masses=masses, block=block,
            dtype=dtype)
        coord = jnp.asarray(coord, dtype=dtype)
        n = coord.shape[0]
        ii, jj, delta, _, _ = _ffp.overlay_pair_delta(coord, params,
                                                      jnp)
        if len(ii) == 0:
            return base
        w = (jnp.ones(n, dtype) if masses is None
             else 1.0 / jnp.sqrt(jnp.asarray(masses, dtype)))
        ad = jnp.abs(delta).astype(dtype)
        wsum = (jnp.zeros(n, dtype).at[ii].add(ad * w[jj])
                .at[jj].add(ad * w[ii]))
        rsum = jnp.zeros(n, dtype).at[ii].add(ad).at[jj].add(ad)
        return base + jnp.max(w * (wsum + w * rsum))
    return _hessian_degree_bound_base(coord, params, masses=masses,
                                      block=block, dtype=dtype)


@functools.partial(jax.jit, static_argnames=("block", "dtype"))
def _hessian_degree_bound_base(coord, params, *, masses=None, block=512,
                               dtype=jnp.float32):
    _check_params(params)
    coord = jnp.asarray(coord, dtype=dtype)
    n = coord.shape[0]
    if masses is None:
        w = jnp.ones(n, dtype)
    else:
        w = 1.0 / jnp.sqrt(jnp.asarray(masses, dtype))

    n_pad = _round_up(n, block)
    coord_p = jnp.zeros((n_pad, 3), dtype).at[:n].set(coord)
    w_p = jnp.zeros(n_pad, dtype).at[:n].set(w)
    meta = (_pad_compact_meta(params, n, n_pad)
            if params.kind == "table_compact" else None)
    cols = jnp.arange(n_pad)

    def one_block(r0):
        rows = r0 + jnp.arange(block)
        cr = jax.lax.dynamic_slice(coord_p, (r0, 0), (block, 3))
        d = cr[:, None, :] - coord_p[None, :, :]
        sq = jnp.sum(d * d, axis=-1)
        kmat = _rect_constants(sq, rows, cols, n, params, meta)
        wr = jax.lax.dynamic_slice(w_p, (r0,), (block,))
        r = wr * (jnp.matmul(kmat, w_p, precision=_HIGHEST)
                  + wr * jnp.sum(kmat, axis=1))
        return jnp.max(r)

    starts = jnp.arange(n_pad // block) * block
    return jnp.max(jax.lax.map(one_block, starts))


def _chebyshev_filter(matvec, x, degree, a, b, a0=0.0):
    """Scaled Chebyshev filter (Zhou & Saad): amplifies eigencomponents
    in ``[a0, a]`` relative to the damped band ``[a, b]``."""
    e = (b - a) / 2.0
    c = (b + a) / 2.0
    sigma1 = e / (a0 - c)
    y = (matvec(x) - c * x) * (sigma1 / e)

    def step(_, carry):
        x_prev, x_cur, sigma = carry
        sigma_new = 1.0 / (2.0 / sigma1 - sigma)
        x_new = (2.0 * sigma_new / e) * (matvec(x_cur) - c * x_cur) \
            - (sigma * sigma_new) * x_prev
        return x_cur, x_new, sigma_new

    _, y, _ = jax.lax.fori_loop(0, degree - 1, step, (x, y, sigma1))
    return y


def _deflate(t, x):
    return x - jnp.matmul(
        t, jnp.matmul(t.T, x, precision=_HIGHEST),
        precision=_HIGHEST)


@functools.partial(
    jax.jit, static_argnames=("m", "p", "seed", "dtype"))
def _chebfsi_init(t, m, *, p, seed, dtype):
    key = jnp.arange(m * p, dtype=dtype).reshape(m, p)
    x = jnp.cos(key * 0.7 + seed) + 1e-3
    x, _ = jnp.linalg.qr(_deflate(t, x))
    return x


@functools.partial(
    jax.jit, static_argnames=("matvec", "degree", "k"))
def _chebfsi_outer(matvec, t, x, a, b, *, degree, k):
    """One filter + Rayleigh-Ritz pass; returns the rotated block, the
    next filter cutoff, the Ritz values, and the wanted-mode residuals.
    Runs as its own program execution so long solves are split into
    bounded device calls (and the host can stop early on `tol`)."""
    p = x.shape[1]
    shift = 0.5 * b  # rigid modes land mid-band -> damped by the filter

    def shifted_matvec(v):
        return matvec(v) + shift * jnp.matmul(
            t, jnp.matmul(t.T, v, precision=_HIGHEST),
            precision=_HIGHEST)

    y = _chebyshev_filter(shifted_matvec, x, degree, a, b)
    y, _ = jnp.linalg.qr(_deflate(t, y))
    hy = matvec(y)
    s = jnp.matmul(y.T, hy, precision=_HIGHEST)
    theta, w = jnp.linalg.eigh((s + s.T) / 2)
    x = jnp.matmul(y, w, precision=_HIGHEST)
    hx = jnp.matmul(hy, w[:, :k], precision=_HIGHEST)
    res = jnp.linalg.norm(hx - x[:, :k] * theta[None, :k], axis=0) \
        / jnp.maximum(jnp.abs(theta[:k]), 1e-30)
    # Next filter cutoff: just above the largest kept Ritz value,
    # clamped inside the spectrum
    a = jnp.clip(1.05 * theta[p - 1], b * 1e-4, 0.5 * b)
    return x, a, theta, res


def _chebfsi(matvec, t, m, lam_max, *, k, oversample, degree, n_outer,
             seed, dtype, tol=None, checkpoint=None, retries=0):
    if n_outer < 1:
        raise ValueError(f"n_outer must be >= 1, got {n_outer}")
    p = k + oversample
    b = jnp.asarray(lam_max, dtype)
    x = _chebfsi_init(t, m, p=p, seed=seed, dtype=dtype)
    a = b / 10.0
    theta = None
    if checkpoint is None and not retries:
        for _ in range(n_outer):
            x, a, theta, res = _chebfsi_outer(matvec, t, x, a, b,
                                              degree=degree, k=k)
            if tol is not None and float(jnp.max(res)) < tol:
                break
        return theta[:k], x[:, :k].T, res

    # Elastic path (utils.elastic): each outer iteration is one device
    # program, so it is the natural retry/snapshot boundary.  Resume
    # assumes the same (coord, params, k, seed, ...) call — the
    # snapshot holds only the loop carry, not the operator.
    from ..utils import elastic

    def step(_, st):
        xi = jnp.asarray(st["x"], dtype)
        ai = jnp.asarray(st["a"], dtype)
        xi, ai, th, rs = _chebfsi_outer(matvec, t, xi, ai, b,
                                        degree=degree, k=k)
        return {"x": xi, "a": ai, "theta": th, "res": rs}

    def stop(st):
        return tol is not None and float(np.max(np.asarray(st["res"]))) < tol

    state = {"x": x, "a": a, "theta": np.zeros((k,), np.float32),
             "res": np.full((k,), np.inf, np.float32)}
    state, _ = elastic.resumable_loop(step, state, n_outer,
                                      checkpoint=checkpoint, stop=stop,
                                      retries=retries)
    theta = jnp.asarray(state["theta"], dtype)
    x = jnp.asarray(state["x"], dtype)
    res = jnp.asarray(state["res"], dtype)
    return theta[:k], x[:, :k].T, res


def _sparse_setup(coord, params, masses, tile, dtype, concrete):
    """Host-side setup shared by the sparse mode solvers: Morton sort,
    tile neighbor lists, and permutation of the per-atom parameter /
    mass arrays.  Returns (sorted coord, permuted params, permuted
    masses, nbr, counts, perm)."""
    if not concrete:
        raise ValueError(
            "sparse=True needs concrete coordinates (the spatial "
            "sort and tile neighbor lists are built host-side)")
    host_coord = np.asarray(coord, dtype=np.float64)
    perm = spatial_sort_permutation(host_coord)
    cutoff = float(np.sqrt(params.cutoff_sq))
    sorted_host = host_coord[perm]
    nbr, counts = tile_neighbor_lists(sorted_host, cutoff, tile)
    coord = jnp.asarray(sorted_host, dtype=dtype)
    if params.kind == "table_compact":
        import dataclasses

        params = dataclasses.replace(
            params,
            type_idx=np.asarray(params.type_idx)[perm],
            chain_code=np.asarray(params.chain_code)[perm],
            bonded_next=np.asarray(params.bonded_next)[perm],
        )
    if params.overlays:
        # Overlay masks live in original atom order; the kernels (and
        # the sparse correction) see the sorted order.
        import dataclasses

        from . import ffparams as _ffp

        params = dataclasses.replace(params, overlays=tuple(
            _ffp.PatchOverlay(
                off_mask=np.asarray(o.off_mask)[perm][:, perm],
                on_mask=np.asarray(o.on_mask)[perm][:, perm],
                values=np.asarray(o.values)[perm][:, perm],
                has_value=np.asarray(o.has_value)[perm][:, perm],
            ) for o in params.overlays))
    if masses is not None:
        masses = np.asarray(masses)[perm]
    return coord, params, masses, nbr, counts, perm


def _oversample(k, oversample, sparse):
    """Extra subspace vectors: ``max(k, 8)`` by default, widened on the
    sparse path to fill the power-of-two vector block its kernel pads
    to anyway (a larger buffer widens the wanted-vs-excluded eigenvalue
    gap and speeds convergence)."""
    if oversample is not None:
        return int(oversample)
    q = max(k, 8)
    return _vector_block_width(k + q) - k if sparse else q


def lowest_modes_matfree(coord, params, k, *, masses=None, oversample=None,
                         degree=96, n_outer=10, tile=SPARSE_TILE,
                         block=512, sparse=None,
                         dtype=jnp.float32, lambda_max=None, seed=0,
                         matvec=None, tol=None,
                         checkpoint=None, retries=0):
    """
    The `k` lowest non-trivial ANM modes **without materializing the
    Hessian** — Chebyshev-filtered subspace iteration over the
    matrix-free operator.

    This is the mega-scale path beyond the dense regime: at 20k+
    residues the ``(3n, 3n)`` Hessian no longer fits one chip, but the
    operator itself is O(n) parameters.  The filter amplifies the
    ``[0, a]`` end of the spectrum; the six rigid-body modes are shifted
    into the damped band (``+ shift * T T^t``) so they cannot surface.
    Requires a *connected* network (the rigid modes are assumed to be
    the entire null space — check ``utils.network.is_connected`` when
    in doubt).  Convergence is gap-dependent — **always check the
    returned residuals** (the same discipline as :func:`ops.modes.lowest_modes`).

    Parameters
    ----------
    coord : ndarray, shape=(n, 3)
    params : FFParams
        O(n)-parameter family (see :func:`supports_params`).
    k : int
        Number of modes.
    masses : ndarray, shape=(n,), optional
        Mass weighting: operates on ``W H W`` with
        ``W = diag(1/sqrt(m))`` (reference ``anm.py:89-96``).
    oversample : int, optional
        Extra subspace vectors (default ``max(k, 8)``).
    degree : int
        Chebyshev filter degree per outer iteration.
    n_outer : int
        Outer (filter + Rayleigh-Ritz) iterations.
    sparse : bool, optional
        Use the block-sparse operator (:func:`hessian_apply_pallas_sparse`,
        a CUDA GPU kernel): atoms are Morton-sorted, tile neighbor lists
        built host-side, and each kernel program visits only its
        interacting tile pairs — O(n * neighbors) per apply.  Default:
        :func:`springcraft_tpu.utils.config.use_sparse_apply` (by size
        and dtype; needs a cutoff and concrete `coord`).  Results are
        returned in the original atom order.
    lambda_max : float, optional
        Known spectral upper bound; skips the Gershgorin degree-bound
        pass (:func:`hessian_degree_bound`).
    tol : float, optional
        Early exit: stop outer iterations once the max wanted-mode
        relative residual falls below `tol` (checked host-side between
        the per-iteration device programs).
    matvec : callable, optional
        Override the operator: ``matvec(x)`` with ``x`` of shape
        ``(3n, p)`` must return ``H @ x`` (e.g. the mesh-sharded
        :func:`springcraft_tpu.parallel.sharded_hessian_apply`).  Mass
        weighting still wraps it.
    checkpoint : str or utils.elastic.LoopCheckpoint, optional
        Snapshot the outer-iteration state to this ``.npz`` path and
        resume from an existing snapshot — recovery for hour-scale
        solves (the snapshot assumes an identical call; see
        :mod:`springcraft_tpu.utils.elastic`).
    retries : int
        In-process retries per outer iteration on *device* failures;
        0 disables the elastic wrapper.

    Returns
    -------
    eig_values : ndarray, shape=(k,), ascending
    eig_vectors : ndarray, shape=(k, 3n), xyz layout, modes in rows
    residuals : ndarray, shape=(k,)
        Relative eigenpair residuals ``|H u - lambda u| / lambda``.
    """
    concrete = not isinstance(coord, jax.core.Tracer)
    coord = jnp.asarray(coord, dtype=dtype)
    n = coord.shape[0]
    m = 3 * n
    if sparse is None:
        sparse = (matvec is None and concrete
                  and config.use_sparse_apply(n, dtype, params))
    q = _oversample(k, oversample, sparse)

    if lambda_max is None:
        # Guaranteed upper bound (the filter requires b >= lambda_max;
        # power iteration only approaches it from below).  Computed on
        # the ORIGINAL ordering: lambda_max is permutation-invariant,
        # but hessian_degree_bound's bonded test is positional — on
        # Morton-permuted tabulated params it would classify the wrong
        # pairs as peptide bonds and could under-estimate.
        lam_max = hessian_degree_bound(coord, params, masses=masses,
                                       block=block, dtype=dtype)
    else:
        lam_max = jnp.asarray(lambda_max, dtype)

    perm = None
    if matvec is not None:
        base = matvec
    elif sparse:
        coord, params, masses, nbr, counts, perm = _sparse_setup(
            coord, params, masses, tile, dtype, concrete)
        base = functools.partial(
            hessian_apply_pallas_sparse, coord, params=params,
            nbr=jnp.asarray(nbr), counts=jnp.asarray(counts),
            orig_ids=jnp.asarray(perm, jnp.int32), tile=tile,
            dtype=dtype)
    else:
        base = functools.partial(hessian_apply, coord, params=params,
                                 block=block, dtype=dtype)

    if masses is not None:
        w = 1.0 / jnp.sqrt(jnp.asarray(masses, dtype))
        w3 = jnp.tile(w, 3)  # xyz layout: per-component planes

        def matvec(x):
            wx = x * (w3[:, None] if x.ndim == 2 else w3)
            y = base(wx)
            return y * (w3[:, None] if y.ndim == 2 else w3)
    else:
        matvec = base

    t = rigid.rigid_modes_anm(coord, masses=masses, layout="xyz")
    t = jnp.asarray(t, dtype)

    vals, vecs, res = _chebfsi(
        matvec, t, m, lam_max, k=k, oversample=q, degree=degree,
        n_outer=n_outer, seed=seed, dtype=dtype, tol=tol,
        checkpoint=checkpoint, retries=retries)
    if perm is not None:
        # Back to the original atom order: sorted slot i is atom perm[i]
        inv = np.argsort(perm)
        cols = np.concatenate([a * n + inv for a in range(3)])
        vecs = vecs[:, cols]
    return vals, vecs, res


def lowest_modes_matfree_gnm(coord, params, k, *, masses=None,
                             oversample=None, degree=96, n_outer=10,
                             tile=SPARSE_TILE, block=512,
                             sparse=None, dtype=jnp.float32,
                             lambda_max=None, seed=0, matvec=None,
                             tol=None, checkpoint=None, retries=0):
    """
    The `k` lowest non-trivial GNM modes without materializing the
    Kirchhoff matrix — the GNM counterpart of
    :func:`lowest_modes_matfree` (same Chebyshev machinery over the
    matrix-free Kirchhoff operator, with the constant vector as the
    deflated null space).

    Returns ``(eig_values (k,), eig_vectors (k, n), residuals (k,))``
    in the original atom order.
    """
    concrete = not isinstance(coord, jax.core.Tracer)
    coord = jnp.asarray(coord, dtype=dtype)
    n = coord.shape[0]
    if sparse is None:
        sparse = (matvec is None and concrete
                  and config.use_sparse_apply(n, dtype, params))
    q = _oversample(k, oversample, sparse)

    if lambda_max is None:
        # Identical block-row Gershgorin bound (the Hessian's 3x3
        # superelements have spectral norm k_ij, the Kirchhoff entries
        # are k_ij — the formula coincides).  Computed on the ORIGINAL
        # ordering (see lowest_modes_matfree).
        lam_max = hessian_degree_bound(coord, params, masses=masses,
                                       block=block, dtype=dtype)
    else:
        lam_max = jnp.asarray(lambda_max, dtype)

    perm = None
    if matvec is not None:
        base = matvec
    elif sparse:
        coord, params, masses, nbr, counts, perm = _sparse_setup(
            coord, params, masses, tile, dtype, concrete)
        base = functools.partial(
            kirchhoff_apply_pallas_sparse, coord, params=params,
            nbr=nbr, counts=counts,
            orig_ids=jnp.asarray(perm, jnp.int32), tile=tile,
            dtype=dtype)
    else:
        base = functools.partial(kirchhoff_apply, coord, params=params,
                                 block=block, dtype=dtype)

    if masses is not None:
        w = 1.0 / jnp.sqrt(jnp.asarray(masses, dtype))

        def matvec_fn(x):
            wx = x * (w[:, None] if x.ndim == 2 else w)
            y = base(wx)
            return y * (w[:, None] if y.ndim == 2 else w)
    else:
        matvec_fn = base

    t = rigid.null_mode_gnm(n, masses=masses, dtype=dtype)

    vals, vecs, res = _chebfsi(
        matvec_fn, t, n, lam_max, k=k, oversample=q, degree=degree,
        n_outer=n_outer, seed=seed, dtype=dtype, tol=tol,
        checkpoint=checkpoint, retries=retries)
    if perm is not None:
        vecs = vecs[:, np.argsort(perm)]
    return vals, vecs, res


def hessian_diag_blocks(coord, params, *, block=512, dtype=jnp.float32):
    """
    The ``(n, 3, 3)`` diagonal superblocks of the ANM Hessian
    (``sum_j k_ij / d^2 * d d^T``) in one blocked matrix-free pass —
    the block-Jacobi preconditioner for :func:`covariance_solve_matfree`.
    Patch overlays scatter their exact contribution in at O(P).
    """
    if params.overlays:
        from . import ffparams as _ffp

        base = _hessian_diag_blocks_base(coord, _strip(params),
                                         block=block, dtype=dtype)
        coord = jnp.asarray(coord, dtype=dtype)
        ii, jj, delta, disp, safe_sq = _ffp.overlay_pair_delta(
            coord, params, jnp)
        if len(ii) == 0:
            return base
        g = (delta / safe_sq).astype(dtype)
        disp = disp.astype(dtype)
        dd = g[:, None, None] * disp[:, :, None] * disp[:, None, :]
        return base.at[ii].add(dd).at[jj].add(dd)
    return _hessian_diag_blocks_base(coord, params, block=block,
                                     dtype=dtype)


@functools.partial(jax.jit, static_argnames=("block", "dtype"))
def _hessian_diag_blocks_base(coord, params, *, block=512,
                              dtype=jnp.float32):
    _check_params(params)
    coord = jnp.asarray(coord, dtype=dtype)
    n = coord.shape[0]
    n_pad = _round_up(n, block)
    coord_p = jnp.zeros((n_pad, 3), dtype).at[:n].set(coord)
    meta = (_pad_compact_meta(params, n, n_pad)
            if params.kind == "table_compact" else None)
    cols = jnp.arange(n_pad)

    def one_block(r0):
        rows = r0 + jnp.arange(block)
        cr = jax.lax.dynamic_slice(coord_p, (r0, 0), (block, 3))
        d = cr[:, None, :] - coord_p[None, :, :]
        sq = jnp.sum(d * d, axis=-1)
        kmat = _rect_constants(sq, rows, cols, n, params, meta)
        g = kmat / jnp.where(sq == 0, 1.0, sq)
        # sum_j g_ij d_ij d_ij^T per row — broadcast multiply + reduce
        return jnp.einsum("ij,ija,ijb->iab", g, d, d,
                          precision=_HIGHEST)

    starts = jnp.arange(n_pad // block) * block
    blocks = jax.lax.map(one_block, starts).reshape(n_pad, 3, 3)
    return blocks[:n]


def covariance_solve_matfree(coord, params, rhs, *, masses=None,
                             tol=1e-6, max_iter=1000, tile=SPARSE_TILE,
                             block=512, sparse=None,
                             dtype=jnp.float32, matvec=None):
    """
    ``pinv(H) @ rhs`` without materializing the Hessian or its
    covariance: deflated, block-Jacobi-preconditioned conjugate
    gradients on the implicit operator.

    This is the mega-scale route to every covariance *application* —
    linear response displacements (reference ``nma.py:422-473``),
    selected covariance columns (PRS rows for chosen perturbation
    sites) — at system sizes where the dense ``(3n, 3n)`` covariance
    cannot exist.  Like all analytic-null-space paths it requires a
    *connected* network (``utils.network.is_connected``); disconnected
    systems have extra null modes outside the deflated basis.  The
    rigid-body null space is projected out of the right-hand side,
    every matvec, and the preconditioner output, so CG runs on the
    positive-definite complement; each column gets its own step sizes
    (vectorized single-column CG).

    Parameters
    ----------
    coord : ndarray, shape=(n, 3)
    rhs : ndarray, shape=(3n, k) or (3n,)
        Right-hand sides in xyz plane layout.
    tol : float
        Relative residual target per column.
    max_iter : int
        CG iteration cap (the loop exits early when all columns pass
        `tol`).

    Returns
    -------
    x : ndarray, same shape as `rhs`
        ``pinv(H) @ rhs`` (null-space component removed, matching the
        reference's pseudo-inverse semantics).  NOTE: each call traces
        and compiles its own CG program (the operator closure is a jit
        static) — batch right-hand sides into ONE call rather than
        looping.
    n_iter : int
        CG iterations taken.
    residuals : ndarray, shape=(k,)
        Final relative residuals ``|H x - P rhs| / |P rhs|``.
    """
    concrete = not isinstance(coord, jax.core.Tracer)
    coord = jnp.asarray(coord, dtype=dtype)
    n = coord.shape[0]
    if sparse is None:
        sparse = (matvec is None and concrete
                  and config.use_sparse_apply(n, dtype, params))

    rhs = jnp.asarray(rhs, dtype=dtype)
    squeeze = rhs.ndim == 1
    if squeeze:
        rhs = rhs[:, None]

    # Block-Jacobi preconditioner from the ORIGINAL ordering
    diag_blocks = hessian_diag_blocks(coord, params, block=block,
                                      dtype=dtype)
    if masses is not None:
        w = 1.0 / jnp.sqrt(jnp.asarray(masses, dtype))
        diag_blocks = diag_blocks * (w**2)[:, None, None]
    # Regularized 3x3 inverses (isolated atoms would be singular)
    eye3 = jnp.eye(3, dtype=dtype)
    trace = jnp.trace(diag_blocks, axis1=1, axis2=2)
    reg = 1e-6 * jnp.maximum(trace, 1e-30)[:, None, None] * eye3
    inv_blocks = jnp.linalg.inv(diag_blocks + reg)      # (n, 3, 3)

    perm = None
    if matvec is not None:
        base = matvec
    elif sparse:
        coord_s, params_s, masses_s, nbr, counts, perm = _sparse_setup(
            coord, params, masses, tile, dtype, concrete)
        base = functools.partial(
            hessian_apply_pallas_sparse, coord_s, params=params_s,
            nbr=nbr, counts=counts,
            orig_ids=jnp.asarray(perm, jnp.int32), tile=tile,
            dtype=dtype)
        coord = coord_s
        masses = masses_s
        inv_blocks = inv_blocks[perm]
        cols = np.concatenate([a * n + perm for a in range(3)])
        rhs = rhs[cols]
    else:
        base = functools.partial(hessian_apply, coord, params=params,
                                 block=block, dtype=dtype)

    if masses is not None:
        w3 = jnp.tile(1.0 / jnp.sqrt(jnp.asarray(masses, dtype)), 3)

        def op(x):
            return w3[:, None] * base(w3[:, None] * x)
    else:
        op = base

    t = jnp.asarray(
        rigid.rigid_modes_anm(coord, masses=masses, layout="xyz"),
        dtype)

    x, n_it, res = _deflated_pcg(op, t, inv_blocks, rhs, n, tol=tol,
                                 max_iter=max_iter)
    if perm is not None:
        inv = np.argsort(perm)
        cols = np.concatenate([a * n + inv for a in range(3)])
        x = x[cols]
    return (x[:, 0], n_it, res) if squeeze else (x, n_it, res)


@functools.partial(jax.jit,
                   static_argnames=("op", "n", "tol", "max_iter"))
def _deflated_pcg(op, t, inv_blocks, rhs, n, *, tol, max_iter):
    """Preconditioned CG on ``range(I - T T^t)`` with per-column step
    sizes; the loop exits once every column's relative residual passes
    `tol`."""
    def deflate(x):
        return x - jnp.matmul(
            t, jnp.matmul(t.T, x, precision=_HIGHEST),
            precision=_HIGHEST)

    def precond(r):
        # per-atom 3x3 apply in xyz plane layout, then re-deflate
        rr = r.reshape(3, n, -1).transpose(1, 0, 2)    # (n, 3, k)
        out = jnp.einsum("iab,ibk->iak", inv_blocks, rr,
                         precision=_HIGHEST)
        return deflate(out.transpose(1, 0, 2).reshape(3 * n, -1))

    b = deflate(rhs)
    b_norm = jnp.maximum(jnp.linalg.norm(b, axis=0), 1e-30)
    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = precond(r0)
    rz0 = jnp.sum(r0 * z0, axis=0)
    active0 = jnp.linalg.norm(r0, axis=0) / b_norm > tol

    def cond(state):
        i, _, _, _, _, _, active = state
        return (i < max_iter) & jnp.any(active)

    def body(state):
        # Per-column freezing: converged columns stop, and columns
        # whose curvature/rz degenerate (CG pushed past the precision
        # floor) freeze at their last finite iterate instead of
        # overflowing to NaN.
        i, x, r, z, p, rz, active = state
        hp = deflate(op(p))
        denom = jnp.sum(p * hp, axis=0)
        ok = active & jnp.isfinite(denom) & (denom > 0) & (rz > 0)
        alpha = jnp.where(ok, rz / jnp.where(ok, denom, 1.0), 0.0)
        x = x + p * alpha[None, :]
        r = r - hp * alpha[None, :]
        z = precond(r)
        rz_new = jnp.sum(r * z, axis=0)
        beta = jnp.where(ok, rz_new / jnp.where(ok, rz, 1.0), 0.0)
        p = jnp.where(ok[None, :], z + p * beta[None, :], p)
        rel = jnp.linalg.norm(r, axis=0) / b_norm
        return i + 1, x, r, z, p, rz_new, ok & (rel > tol)

    state = (jnp.asarray(0), x0, r0, z0, z0, rz0, active0)
    i, x, r, _, _, _, _ = jax.lax.while_loop(cond, body, state)
    res = jnp.linalg.norm(r, axis=0) / b_norm
    return deflate(x), i, res


def linear_response_matfree(coord, params, force, **options):
    """
    Linear response displacements ``pinv(H) @ force`` without the
    Hessian or covariance (reference semantics: ``nma.py:422-473``) —
    `force` is ``(n, 3)`` or ``(3n,)`` (atom-major flat, like the
    reference) or a batch ``(n, 3, k)``; returns displacements in the
    same shape plus the CG iteration count and residuals.
    """
    coord = np.asarray(coord) if not isinstance(coord, jnp.ndarray) \
        else coord
    n = coord.shape[0]
    force = jnp.asarray(force)
    if force.ndim == 1:
        if force.shape[0] != 3 * n:
            raise ValueError(
                f"force has {force.shape[0]} entries, expected {3 * n}")
        vec = force.reshape(n, 3).T.reshape(3 * n)     # -> xyz layout
        x, n_it, res = covariance_solve_matfree(coord, params, vec,
                                                **options)
        return x.reshape(3, n).T.reshape(3 * n), n_it, res
    if force.shape[:2] != (n, 3):
        raise ValueError(
            f"force has shape {force.shape}, expected ({n}, 3[, k])")
    batched = force.ndim == 3
    f = force if batched else force[:, :, None]
    vec = jnp.transpose(f, (1, 0, 2)).reshape(3 * n, -1)
    x, n_it, res = covariance_solve_matfree(coord, params, vec,
                                            **options)
    disp = jnp.transpose(x.reshape(3, n, -1), (1, 0, 2))
    return (disp if batched else disp[:, :, 0]), n_it, res


def prs_rows_matfree(coord, params, sites, *, norm=True, masses=None,
                     dtype=jnp.float32, **options):
    """
    Perturbation-response-scanning rows for selected perturbation
    sites, without the covariance: three covariance columns per site by
    the deflated CG (:func:`covariance_solve_matfree`), squared and
    folded (reference ``nma.py:476-524``).  The full ``(n, n)`` PRS
    matrix needs the entire covariance (impossible at mega scale); the
    usual workflow — scan candidate effector sites — only needs rows.

    Parameters
    ----------
    sites : sequence of int
        Perturbation-site atom indices (PRS row indices).
    norm : bool
        Row-normalize by the diagonal (reference ``nma.py:520-523``).

    Returns
    -------
    prs_rows : ndarray, shape=(len(sites), n)
    n_iter : int
        CG iterations.
    residuals : ndarray, shape=(3 * len(sites),)
        CG relative residuals of the underlying solves.
    """
    coord = jnp.asarray(coord, dtype=dtype)
    n = coord.shape[0]
    sites = np.asarray(sites, dtype=np.int64)
    if sites.ndim != 1 or np.any(sites < 0) or np.any(sites >= n):
        raise IndexError(f"sites must be flat indices in [0, {n})")
    n_sites = sites.shape[0]

    # Unit perturbations e_(site, a) in xyz layout, site-major columns
    rhs = np.zeros((3 * n, 3 * n_sites), dtype=np.float64)
    for s, site in enumerate(sites):
        for a in range(3):
            rhs[a * n + site, 3 * s + a] = 1.0

    x, n_it, res = covariance_solve_matfree(
        coord, params, rhs, masses=masses, dtype=dtype, **options)
    cols = jnp.reshape(x, (3, n, n_sites, 3))   # [b, j, s, a]
    prs = jnp.transpose(jnp.sum(cols**2, axis=(0, 3)), (1, 0))
    if norm:
        diag = prs[jnp.arange(n_sites), jnp.asarray(sites)]
        prs = prs / diag[:, None]
    return prs, n_it, res


def prs_diag_from_modes(eig_values, eig_vectors, *, layout="xyz"):
    """
    The folded-PRS diagonal ``P_ii = ||C_ii||_F^2`` (squared Frobenius
    norm of each atom's diagonal 3x3 covariance block) from a truncated
    mode set — the normalizer of the reference's row-normalized PRS
    matrix (``nma.py:520-523``).  At mega scale the full covariance
    diagonal blocks are unreachable; the mode-sum converges fast (each
    mode enters as ``1/lambda^2``), the same regime argument as the
    mode-sum MSF used by ``dcc(matrix_free=True)``.

    ``eig_vectors``: ``(k, 3n)`` modes in rows; returns ``(n,)``.
    """
    vals = np.asarray(eig_values, np.float64)
    vecs = np.asarray(eig_vectors, np.float64)
    k = vecs.shape[0]
    n = vecs.shape[1] // 3
    if layout == "xyz":
        planes = vecs.reshape(k, 3, n)
    elif layout == "atom":
        planes = vecs.reshape(k, n, 3).transpose(0, 2, 1)
    else:
        raise ValueError(f"Unknown layout '{layout}'")
    # C_ii[a, b] = sum_k v[k, a, i] v[k, b, i] / lambda_k
    blocks = np.einsum("kai,kbi->abi", planes / vals[:, None, None],
                       planes, optimize=True)
    return np.sum(blocks**2, axis=(0, 1))


def effector_sensor_from_modes(eig_values, eig_vectors, *, norm=True,
                               layout="xyz"):
    """
    Effector and sensor profiles over **all** atoms from a truncated
    mode set — O(n k^2) flops, no covariance matrix and no CG sweep.

    The reference computes the profiles as diagonal-excluded row /
    column means of the (row-normalized) folded PRS matrix
    (``nma.py:527-569``), which needs the full ``(3n, 3n)`` covariance.
    With a k-mode spectral expansion ``C = sum_k v_k v_k^T / lambda_k``
    the folded PRS factorizes: writing the per-atom 3-vectors of the
    1/sqrt(lambda)-scaled modes as planes ``R_a (k, n)``,

        P_ij = sum_{kl} S_kl(i) S_kl(j),
        S_kl(i) = sum_a R_a[k, i] R_a[l, i],

    so every profile is a quadratic form in the k x k mode-overlap
    space:

    * row sums:      ``sum_j P_ij = sum_a colsum(R_a * (T @ R_a))``
      with ``T = sum_b R_b @ R_b^T`` — the effector numerators;
    * weighted column sums with ``D_j = 1 / P_jj``:
      same contraction with ``U = sum_b (R_b * D) @ R_b^T`` — the
      sensor numerators of the row-normalized PRS;
    * the diagonal ``P_ii`` is :func:`prs_diag_from_modes`.

    Three ``(k, n)`` matmuls each — at 30k atoms and k=50 modes this is
    ~0.2 GFLOP of host float64, versus the O(n) CG solves a
    column-by-column covariance sweep would need.

    Truncation semantics: the result is the **exact** effector/sensor
    profile of the rank-k (mode-truncated) covariance — the standard
    mode-truncated PRS.  With the complete non-trivial mode set that
    equals ``pinv`` and the profiles match the dense path to float64
    accuracy.  Under truncation the values are those of the *low-mode
    subspace*, which can deviate substantially from the all-mode
    profiles — the sensor especially, whose numerators are dominated
    by the unrepresented high-mode tail (measured: k=10 at n=30,000
    loses even the site *ranking*; bench matfree section).  For
    unbiased all-mode profiles over all atoms use
    :func:`effector_sensor_stochastic`; for exact all-mode values at
    selected sites use :func:`effector_sensor_matfree`; use this
    function when the low-mode subspace itself is the object of
    study.

    Parameters
    ----------
    eig_values, eig_vectors : ndarray, shapes ``(k,)`` / ``(k, 3n)``
        Non-trivial modes in rows (``lowest_modes`` output; trivial
        modes must be excluded).
    norm : bool
        Row-normalize by the diagonal before averaging (the reference's
        standard normalization, ``nma.py:520-523``).
    layout : {"xyz", "atom"}
        Eigenvector component layout ("atom" for ``lowest_modes`` /
        ``eigen`` output).

    Returns
    -------
    effector : ndarray, shape=(n,)
    sensor : ndarray, shape=(n,)
    """
    vals = np.asarray(eig_values, np.float64)
    vecs = np.asarray(eig_vectors, np.float64)
    if vals.ndim != 1 or vecs.ndim != 2 or vecs.shape[0] != vals.shape[0]:
        raise ValueError(
            f"expected (k,) values and (k, 3n) modes in rows, got "
            f"{vals.shape} and {vecs.shape}")
    k = vecs.shape[0]
    n = vecs.shape[1] // 3
    if layout == "xyz":
        planes = vecs.reshape(k, 3, n)
    elif layout == "atom":
        planes = vecs.reshape(k, n, 3).transpose(0, 2, 1)
    else:
        raise ValueError(f"Unknown layout '{layout}'")
    r = planes / np.sqrt(vals)[:, None, None]           # (k, 3, n)

    # diagonal P_ii = ||C_ii||_F^2 from the 3x3 blocks (O(n k))
    blocks = np.einsum("kai,kbi->abi", planes / vals[:, None, None],
                       planes, optimize=True)
    diag = np.sum(blocks**2, axis=(0, 1))

    t = np.einsum("kai,lai->kl", r, r, optimize=True)
    rowsum = np.einsum("kl,kai,lai->i", t, r, r, optimize=True)
    if norm:
        u = np.einsum("kai,i,lai->kl", r, 1.0 / diag, r, optimize=True)
        wcolsum = np.einsum("kl,kai,lai->i", u, r, r, optimize=True)
        effector = (rowsum - diag) / ((n - 1) * diag)
        # P_ii / P_ii == 1 is the excluded diagonal term
        sensor = (wcolsum - 1.0) / (n - 1)
    else:
        # the folded PRS is symmetric: raw column means == row means
        effector = (rowsum - diag) / (n - 1)
        sensor = effector.copy()
    return effector, sensor


def effector_sensor_matfree(coord, params, sites, *, prs_diag=None,
                            norm=True, masses=None, dtype=jnp.float32,
                            return_diag=False, **options):
    """
    Effector and sensor profile values at selected sites without the
    covariance matrix — the mega-scale route to the reference's
    ``effector_sensor`` (``nma.py:527-569``), which averages the
    row-normalized PRS matrix over rows (effector) and columns
    (sensor).

    Three covariance columns per site are solved by the deflated CG
    (:func:`covariance_solve_matfree`, one batched call).  Because the
    covariance is symmetric, the *unnormalized* folded PRS is too —
    so a site's solves yield both its PRS row (effector numerators)
    and its PRS column (sensor numerators).  The row normalization
    ``P_ij / P_ii`` makes the sensor average at site ``j`` need
    ``P_ii`` for *all* perturbing atoms ``i``: pass `prs_diag`
    (shape ``(n,)``, from :func:`prs_diag_from_modes` at scale —
    the same pass-the-mode-sum contract as
    ``ANM.dcc(matrix_free=True, msf=...)``).  With ``norm=False``
    the averages use the raw folded PRS and `prs_diag` is not needed.

    Returns
    -------
    effector : ndarray, shape=(len(sites),)
        ``mean_{j != i} P_ij / P_ii`` at each site ``i``.
    sensor : ndarray, shape=(len(sites),)
        ``mean_{i != j} P_ij / P_ii`` at each site ``j``.
    n_iter : int
        CG iterations of the underlying batched solve.
    residuals : ndarray, shape=(3 * len(sites),)
        CG relative residuals.
    self_diag : ndarray, shape=(len(sites),)
        Only with ``return_diag=True``: the EXACT all-mode folded-PRS
        diagonal ``P_ss`` at the sites (a free by-product of the site
        columns) — e.g. to quantify the truncation error of a
        mode-sum `prs_diag` at mega scale.
    """
    coord = jnp.asarray(coord, dtype=dtype)
    n = coord.shape[0]
    sites = np.asarray(sites, dtype=np.int64)
    if sites.ndim != 1 or np.any(sites < 0) or np.any(sites >= n):
        raise IndexError(f"sites must be flat indices in [0, {n})")
    if norm and prs_diag is None:
        raise ValueError(
            "effector_sensor_matfree(norm=True) needs prs_diag=<(n,) "
            "folded-PRS diagonal>: the sensor column average divides "
            "each perturbing row i by its self-response P_ii, which "
            "the site columns alone cannot produce — compute it from "
            "a truncated mode set via prs_diag_from_modes")
    n_sites = sites.shape[0]

    rhs = np.zeros((3 * n, 3 * n_sites), dtype=np.float64)
    for s, site in enumerate(sites):
        for a in range(3):
            rhs[a * n + site, 3 * s + a] = 1.0

    x, n_it, res = covariance_solve_matfree(
        coord, params, rhs, masses=masses, dtype=dtype, **options)
    cols = jnp.reshape(x, (3, n, n_sites, 3))       # [b, i, s, a]
    p_col = np.asarray(jnp.sum(cols**2, axis=(0, 3)),
                       np.float64)                  # (n, s): P[i, site]
    self_p = p_col[sites, np.arange(n_sites)]       # P_ss
    col_sums = p_col.sum(axis=0) - self_p           # sum_{i != s}

    if norm:
        prs_diag = np.asarray(prs_diag, np.float64)
        if prs_diag.shape != (n,):
            raise ValueError(
                f"prs_diag has shape {prs_diag.shape}, expected ({n},)")
        effector = col_sums / ((n - 1) * self_p)
        weighted = p_col / prs_diag[:, None]
        sensor = (weighted.sum(axis=0)
                  - weighted[sites, np.arange(n_sites)]) / (n - 1)
    else:
        effector = col_sums / (n - 1)
        sensor = col_sums / (n - 1)
    if return_diag:
        return effector, sensor, n_it, res, self_p
    return effector, sensor, n_it, res


def prs_diag_stochastic(coord, params, modes, *, probes=64, seed=0,
                        layout="xyz", masses=None, dtype=jnp.float32,
                        **options):
    """
    Unbiased **all-mode** folded-PRS diagonal ``P_ii = ||C_ii||_F^2``
    over all atoms — the normalizer of the reference's row-normalized
    PRS (``nma.py:520-523``) at a scale where the covariance diagonal
    blocks are unreachable.

    The rank-k mode-sum (:func:`prs_diag_from_modes`) can be
    arbitrarily wrong for atoms the low modes barely move (measured:
    up to ~100% low at k=10, n=30,000 — bench matfree section).  This
    estimator is unbiased for the all-mode value at every atom:

    * probe the *deflated* covariance ``C_rest = C - C_k`` (``C_k`` =
      exact rank-k from `modes`) with Rademacher columns ``z`` through
      one batched deflated-CG solve — ``E[z_ib (C_rest z)_ia] =
      (C_rest)_ii[a, b]`` estimates each atom's residual 3x3 block;
    * split the probes into two independent halves A/B and form the
      product estimator ``P_ii = <C_k,ii + B_A, C_k,ii + B_B>_F`` —
      unbiased for ``||C_ii||_F^2`` (no squared-noise bias);
    * clamp from below by the rank-k diagonal: both ``C_k,ii`` and
      ``(C_rest)_ii`` are PSD, and for PSD ``A, B``
      ``||A + B||_F^2 >= ||A||_F^2`` (``<A, B>_F >= 0``) — the
      mode-sum is a true lower bound.

    Measured accuracy (n=800 dense-provable, k=10 deflation): median
    relative error ~13%/10%/7% at 32/64/128 probes with worst atoms
    ~2-5x the median — versus up-to-100% for the rank-10 mode-sum.
    Deflation depth helps: k=30 cuts the error ~30% further.

    Parameters
    ----------
    coord : ndarray, shape=(n, 3)
    params : FFParams
    modes : (eig_values, eig_vectors)
        Non-trivial modes in rows, ``(k,)`` / ``(k, 3n)`` — the
        deflation subspace and exact low-mode blocks
        (``lowest_modes_matfree`` output).
    probes : int
        Rademacher probe columns (one batched CG solve).
    layout : {"xyz", "atom"}
        Eigenvector component layout.

    Returns
    -------
    diag : ndarray, shape=(n,)
        Estimated ``P_ii``, clamped from below by the rank-k
        mode-sum.
    stderr : ndarray, shape=(n,)
        First-order propagated standard error per atom (where the
        clamp is active the returned value is a certain lower bound;
        the truth may still sit up to ~stderr above it).
    n_iter : int
    residuals : ndarray, shape=(probes,)
    """
    coord_np = np.asarray(coord)
    n = coord_np.shape[0]
    if probes < 4:
        raise ValueError("probes must be >= 4 (two independent "
                         "halves, each with a sample variance)")
    vals, planes, v_xyz = _rank_k_planes(modes, n, layout)
    # exact rank-k diagonal blocks
    blk_k = np.einsum("kai,kbi->iab", planes / vals[:, None, None],
                      planes, optimize=True)                # (n, 3, 3)

    rng = np.random.RandomState(seed)
    z = rng.randint(0, 2, size=(3 * n, probes)).astype(
        np.float64) * 2.0 - 1.0
    x, n_it, res = covariance_solve_matfree(
        coord, params, z, masses=masses, dtype=dtype, **options)
    # Deflate: subtract the exact rank-k response C_k z
    x = (np.asarray(x, np.float64)
         - v_xyz.T @ ((v_xyz @ z) / vals[:, None]))
    zp = z.reshape(3, n, probes)
    xp = x.reshape(3, n, probes)

    h = probes // 2
    halves = []
    variances = []
    for sl in (slice(0, h), slice(h, probes)):
        t = np.einsum("bip,aip->iabp", zp[:, :, sl], xp[:, :, sl],
                      optimize=True)
        t = 0.5 * (t + t.transpose(0, 2, 1, 3))
        m = sl.stop - sl.start
        b = t.mean(axis=-1)
        halves.append(blk_k + b)
        variances.append(t.var(axis=-1, ddof=1) / m)        # (n, 3, 3)
    m_a, m_b = halves
    raw = np.sum(m_a * m_b, axis=(1, 2))
    # First-order stderr of <M_A, M_B> around M = (M_A + M_B) / 2
    m_mid = 0.5 * (m_a + m_b)
    var = np.sum(m_mid**2 * (variances[0] + variances[1]),
                 axis=(1, 2))
    stderr = np.sqrt(np.maximum(var, 0.0))
    floor = np.sum(blk_k**2, axis=(1, 2))
    diag = np.maximum(raw, floor)
    return diag, stderr, n_it, res


def _rank_k_planes(modes, n, layout):
    """Non-trivial mode set ``(values, vectors)`` -> f64
    ``(vals, planes (k, 3, n), v_xyz (k, 3n))`` in xyz plane layout."""
    vals = np.asarray(modes[0], np.float64)
    vecs = np.asarray(modes[1], np.float64)
    k = vecs.shape[0]
    if layout == "xyz":
        planes = vecs.reshape(k, 3, n)
    elif layout == "atom":
        planes = vecs.reshape(k, n, 3).transpose(0, 2, 1)
    else:
        raise ValueError(f"Unknown layout '{layout}'")
    return vals, planes, planes.reshape(k, 3 * n)


def msf_stochastic(coord, params, modes, *, probes=64, seed=0,
                   layout="xyz", masses=None, dtype=jnp.float32,
                   **options):
    """
    Unbiased **all-mode** mean-square fluctuation over all atoms
    without the covariance matrix: deflated Hutchinson diagonal
    estimation of ``tr C_ii`` (the reference's all-mode MSF,
    ``nma.py:108-184``, at a scale where the covariance cannot exist).

    The mode-sum MSF (the current mega-scale default) is a *truncated*
    quantity — a true lower bound that can sit well below the all-mode
    value for atoms the low modes barely move.  This estimator is
    unbiased at every atom: probe the deflated covariance ``C_rest =
    C - C_k`` with Rademacher columns ``z`` through one batched
    deflated-CG solve (``E[z_r (C_rest z)_r] = (C_rest)_rr``), fold
    the three Cartesian components per atom, add the exact rank-k
    mode-sum back, and clamp from below by it (``(C_rest)_ii >= 0``
    — the diagonal of a PSD matrix).  Deflation makes the noise
    proportional to the *residual* spectrum (``~1/lambda_(k+1)``
    instead of ``~1/lambda_1``), so modest probe counts give small
    per-atom standard errors (returned).

    Parameters
    ----------
    coord : ndarray, shape=(n, 3)
    params : FFParams
    modes : (eig_values, eig_vectors)
        Non-trivial modes in rows, ``(k,)`` / ``(k, 3n)`` — the
        deflation subspace (``lowest_modes_matfree`` output).
    probes : int
        Rademacher probe columns (one batched CG solve).
    layout : {"xyz", "atom"}
        Eigenvector component layout.
    options
        Forwarded to :func:`covariance_solve_matfree` (`tol`,
        `max_iter`, `sparse`, `block`, ...).

    Returns
    -------
    msf : ndarray, shape=(n,)
        Estimated all-mode MSF, clamped from below by the rank-k
        mode-sum.
    stderr : ndarray, shape=(n,)
        Per-atom standard error (sample std over probes /
        sqrt(probes)); where the clamp is active the returned value is
        a certain lower bound.
    n_iter : int
    residuals : ndarray, shape=(probes,)
    """
    n = np.asarray(coord).shape[0]
    if probes < 2:
        raise ValueError("probes must be >= 2 (stderr needs a sample "
                         "variance)")
    vals, planes, v_xyz = _rank_k_planes(modes, n, layout)
    msf_k = np.einsum("kai,kai->i", planes / vals[:, None, None],
                      planes, optimize=True)

    rng = np.random.RandomState(seed)
    z = rng.randint(0, 2, size=(3 * n, probes)).astype(
        np.float64) * 2.0 - 1.0
    x, n_it, res = covariance_solve_matfree(
        coord, params, z, masses=masses, dtype=dtype, **options)
    x = (np.asarray(x, np.float64)
         - v_xyz.T @ ((v_xyz @ z) / vals[:, None]))
    # fold the three components per atom, per probe
    samples = np.sum(z.reshape(3, n, probes) * x.reshape(3, n, probes),
                     axis=0)                                # (n, probes)
    rest = samples.mean(axis=1)
    stderr = samples.std(axis=1, ddof=1) / np.sqrt(probes)
    msf = msf_k + np.maximum(rest, 0.0)
    return msf, stderr, int(n_it), res


def msf_stochastic_gnm(coord, params, modes, *, probes=64, seed=0,
                       masses=None, dtype=jnp.float32, **options):
    """GNM counterpart of :func:`msf_stochastic`: unbiased all-mode
    ``diag(pinv(K))`` (the reference GNM MSF) by deflated Hutchinson
    probes through :func:`covariance_solve_matfree_gnm`.  Same
    contract; mode vectors are ``(k, n)``."""
    n = np.asarray(coord).shape[0]
    if probes < 2:
        raise ValueError("probes must be >= 2 (stderr needs a sample "
                         "variance)")
    vals = np.asarray(modes[0], np.float64)
    vecs = np.asarray(modes[1], np.float64)
    msf_k = np.einsum("ki,ki->i", vecs / vals[:, None], vecs,
                      optimize=True)

    rng = np.random.RandomState(seed)
    z = rng.randint(0, 2, size=(n, probes)).astype(np.float64) * 2.0 - 1.0
    x, n_it, res = covariance_solve_matfree_gnm(
        coord, params, z, masses=masses, dtype=dtype, **options)
    x = np.asarray(x, np.float64) - vecs.T @ ((vecs @ z) / vals[:, None])
    samples = z * x                                         # (n, probes)
    rest = samples.mean(axis=1)
    stderr = samples.std(axis=1, ddof=1) / np.sqrt(probes)
    msf = msf_k + np.maximum(rest, 0.0)
    return msf, stderr, int(n_it), res


def effector_sensor_stochastic(coord, params, prs_diag, *, probes=64,
                               norm=True, masses=None, seed=0,
                               modes=None, layout="xyz",
                               dtype=jnp.float32, **options):
    """
    **All-mode** effector/sensor profiles over **all** atoms without
    the covariance matrix: Hutchinson stochastic diagonal estimation
    on matrix functions of the implicit covariance.

    Both profile numerators of the reference's ``effector_sensor``
    (``nma.py:527-569``) are diagonals of covariance matrix functions:
    the folded-PRS row sums are ``sum_j P_ij = fold_i diag(C^2)`` and
    the diagonal-weighted column sums are ``sum_i P_ij / P_ii =
    fold_j diag(C W C)`` with ``W = diag(repeat(1 / P_ii, 3))`` (fold =
    sum the three Cartesian components of an atom).  For Rademacher
    probes ``z`` (entries +-1), ``E[(C z)_r^2] = (C^2)_rr`` and
    ``E[(C W^(1/2) z)_r^2] = (C W C)_rr`` — so ONE batched deflated-CG
    solve (:func:`covariance_solve_matfree`) over ``2 * probes``
    Rademacher columns estimates BOTH full-atom profiles with
    ``~sqrt(2 / probes)`` relative standard error, independent of
    system size.  The probe columns are batched the same way the site
    solves are.

    This complements the two existing mega-scale routes: exact
    all-mode values at selected *sites* (:func:`effector_sensor_
    matfree`, O(sites) CG columns) and exact *rank-k* full profiles
    (:func:`effector_sensor_from_modes`, O(n k^2) host flops, biased
    by mode truncation).  Here the estimate is unbiased for the
    all-mode profile at every atom; only sampling noise remains, and
    it is returned as a per-atom standard error.

    Parameters
    ----------
    coord : ndarray, shape=(n, 3)
    params : FFParams
    prs_diag : ndarray, shape=(n,)
        The folded-PRS diagonal ``P_ii = ||C_ii||_F^2`` — the excluded
        self term and (with `norm`) the row normalizer.  Use
        :func:`prs_diag_from_modes` over ``lowest_modes`` output (the
        diagonal's mode-sum converges as ``1 / lambda^2``).
    probes : int
        Rademacher probes per profile (the CG solve carries
        ``2 * probes`` columns).
    norm : bool
        Reference-standard row normalization ``P_ij / P_ii``.
    seed : int
        Probe RNG seed — fixed seed, fixed result.
    modes : (eig_values, eig_vectors), optional
        Non-trivial modes for an **exact rank-k control variate** —
        the dominant variance killer.  The deflated covariance
        ``C_rest = C - C_k`` satisfies ``C_k C_rest = 0`` (orthogonal
        eigenspaces), so ``diag(C^2) = diag(C_k^2) + diag(C_rest^2)``:
        the ``C_k^2`` part (which carries almost the whole profile for
        atoms the low modes move) is computed EXACTLY on host and only
        the small residual second moment is estimated — per-atom noise
        drops from ``~(C^2)_rr`` to ``~(C_rest^2)_rr`` order.  The
        sensor's ``W`` weights break the eigenspace orthogonality, so
        its ``2 diag(C_k W C_rest)`` cross term does NOT vanish — it
        is computed exactly instead, by appending the ``k`` columns
        ``W v_k`` to the same batched solve (``C_rest W v_k`` then
        closes the diagonal in closed form); only the residual second
        moment is sampled for both profiles.  Pass the
        ``lowest_modes`` output already in hand.  Exactness caveat:
        the effector decomposition assumes `modes` are orthonormal
        eigenpairs — with iteratively converged modes at residual
        ``r`` the dropped ``2 diag(C_k C_rest)`` cross term is
        ``O(r)`` relative (~1e-4 for the f32 Chebyshev sets, far
        below the sampling noise).
    layout : {"xyz", "atom"}
        `modes` eigenvector component layout.
    options
        Forwarded to :func:`covariance_solve_matfree` (`tol`,
        `max_iter`, `sparse`, `block`, ...).

    Returns
    -------
    effector, sensor : ndarray, shape=(n,)
    effector_stderr, sensor_stderr : ndarray, shape=(n,)
        Per-atom standard error of the estimates (sample std over
        probes / sqrt(probes)), in profile units.
    n_iter : int
    residuals : ndarray, shape=(2 * probes [+ k],) or (probes,)
        CG relative residuals per solve column (`norm=False` skips
        the sensor probes — the raw folded PRS is symmetric; with
        `modes` and `norm` the last ``k`` columns are the exact
        sensor-cross solves ``C W v_k``).
    """
    coord_np = np.asarray(coord)
    n = coord_np.shape[0]
    if prs_diag is None:
        raise ValueError(
            "effector_sensor_stochastic needs prs_diag=<(n,) "
            "folded-PRS diagonal>: the excluded self term P_ii "
            "cannot be estimated from probe solves — compute it from "
            "a truncated mode set via prs_diag_from_modes")
    prs_diag = np.asarray(prs_diag, np.float64)
    if prs_diag.shape != (n,):
        raise ValueError(
            f"prs_diag has shape {prs_diag.shape}, expected ({n},)")
    if probes < 2:
        raise ValueError("probes must be >= 2 (stderr needs a sample "
                         "variance)")
    rng = np.random.RandomState(seed)
    if modes is not None:
        vals_k, planes_k, v_xyz = _rank_k_planes(modes, n, layout)
        k_defl = v_xyz.shape[0]
    n_cols = 2 * probes if norm else probes
    # With deflation + norm, append k extra columns W v_k to the SAME
    # batched solve: they make the sensor's C_k W C_rest cross
    # diagonal EXACT (see below) instead of sampled.
    n_extra = (k_defl if (modes is not None and norm) else 0)
    z = rng.randint(0, 2, size=(3 * n, n_cols + n_extra)).astype(
        np.float64) * 2.0 - 1.0
    if norm:
        # Sensor probes: scale by W^(1/2) in xyz plane layout
        # (component (a, i) sits at row a*n + i)
        w_half = np.tile(1.0 / np.sqrt(prs_diag), 3)
        z[:, probes:n_cols] *= w_half[:, None]
    if n_extra:
        w_full = np.tile(1.0 / prs_diag, 3)
        z[:, n_cols:] = (w_full[:, None] * v_xyz.T)

    x, n_it, res = covariance_solve_matfree(
        coord, params, z, masses=masses, dtype=dtype, **options)
    x = np.asarray(x, np.float64)

    if modes is not None:
        zp = z[:, :n_cols]
        # exact rank-k response per probe and its removal
        u = v_xyz.T @ ((v_xyz @ zp) / vals_k[:, None])
        v = (x[:, :n_cols] - u).reshape(3, n, n_cols)
        # exact fold diag(C_k^2) per atom
        e_k2 = np.einsum("kai,kai,k->i", planes_k, planes_k,
                         1.0 / vals_k**2, optimize=True)
        # effector: C_k C_rest == 0 exactly, so the cross diagonal
        # vanishes and only the residual second moment is sampled
        se = np.sum(v[:, :, :probes]**2, axis=0)     # (n, probes)
        e_num = e_k2 + se.mean(axis=1)
        e_sem = se.std(axis=1, ddof=1) / np.sqrt(probes)
        if norm:
            # exact fold diag(C_k W C_k): S = L^-1 (V W V^T) L^-1
            s_mat = ((v_xyz * w_full[None, :]) @ v_xyz.T
                     / np.outer(vals_k, vals_k))
            a_rows = s_mat @ v_xyz                   # (k, 3n)
            s_k2 = np.sum(v_xyz * a_rows, axis=0)
            # W breaks the eigenspace orthogonality, but the cross
            # diagonal needs only C_rest applied to the k vectors
            # W v_k — the extra solve columns: 2 diag(C_k W C_rest)_r
            # = 2 sum_k (v_k,r / lambda_k) (C W v_k - C_k W v_k)_r,
            # exact to CG tolerance.  Only the residual second moment
            # v'^2 is sampled.
            y_rest = (x[:, n_cols:]
                      - v_xyz.T @ ((v_xyz @ z[:, n_cols:])
                                   / vals_k[:, None]))   # C_rest W v_k
            s_cross = 2.0 * np.sum(
                (v_xyz.T / vals_k[None, :]) * y_rest, axis=1)
            ss = np.sum(v[:, :, probes:]**2, axis=0)
            s_num = ((s_k2 + s_cross).reshape(3, n).sum(axis=0)
                     + ss.mean(axis=1))
            s_sem = ss.std(axis=1, ddof=1) / np.sqrt(probes)
    else:
        x = x.reshape(3, n, n_cols)
        # Per-probe per-atom samples: fold the three components
        samples = np.sum(x**2, axis=0)              # (n, cols)
        e_num = samples[:, :probes].mean(axis=1)    # E -> rowsum P_i
        e_sem = samples[:, :probes].std(axis=1, ddof=1) / np.sqrt(
            probes)
        if norm:
            s_num = samples[:, probes:].mean(axis=1)  # -> sum_i w_i P_ij
            s_sem = samples[:, probes:].std(axis=1, ddof=1) / np.sqrt(
                probes)

    if norm:
        effector = (e_num - prs_diag) / ((n - 1) * prs_diag)
        sensor = (s_num - 1.0) / (n - 1)
        effector_stderr = e_sem / ((n - 1) * prs_diag)
        sensor_stderr = s_sem / (n - 1)
    else:
        # Raw folded PRS is symmetric: both profiles are the
        # diagonal-excluded row means (reference nma.py:562-568 with
        # norm=False input)
        effector = (e_num - prs_diag) / (n - 1)
        sensor = effector.copy()
        effector_stderr = e_sem / (n - 1)
        sensor_stderr = effector_stderr.copy()
    return (effector, sensor, effector_stderr, sensor_stderr, n_it,
            res)


def kirchhoff_degree(coord, params, *, block=512, dtype=jnp.float32):
    """Per-atom Kirchhoff diagonal (the degree, ``sum_j k_ij``) by a
    blocked matrix-free pass — the GNM Jacobi preconditioner.  O(block
    * n) memory; O(n^2) work (fine to ~100k atoms; beyond that pass
    ``precond=False`` to the GNM CG instead).  Patch overlays scatter
    their exact delta in at O(P)."""
    if params.overlays:
        from . import ffparams as _ffp

        base = _kirchhoff_degree_base(coord, _strip(params),
                                      block=block, dtype=dtype)
        coord = jnp.asarray(coord, dtype=dtype)
        ii, jj, delta, _, _ = _ffp.overlay_pair_delta(coord, params,
                                                      jnp)
        if len(ii) == 0:
            return base
        d = delta.astype(dtype)
        return base.at[ii].add(d).at[jj].add(d)
    return _kirchhoff_degree_base(coord, params, block=block,
                                  dtype=dtype)


@functools.partial(jax.jit, static_argnames=("block", "dtype"))
def _kirchhoff_degree_base(coord, params, *, block=512,
                           dtype=jnp.float32):
    _check_params(params)
    coord = jnp.asarray(coord, dtype=dtype)
    n = coord.shape[0]
    n_pad = _round_up(n, block)
    coord_p = jnp.zeros((n_pad, 3), dtype).at[:n].set(coord)
    meta = (_pad_compact_meta(params, n, n_pad)
            if params.kind == "table_compact" else None)
    cols = jnp.arange(n_pad)

    def one_block(r0):
        rows = r0 + jnp.arange(block)
        cr = jax.lax.dynamic_slice(coord_p, (r0, 0), (block, 3))
        d = cr[:, None, :] - coord_p[None, :, :]
        sq = jnp.sum(d * d, axis=-1)
        kmat = _rect_constants(sq, rows, cols, n, params, meta)
        return jnp.sum(kmat, axis=1)

    starts = jnp.arange(n_pad // block) * block
    deg = jax.lax.map(one_block, starts).reshape(n_pad)
    return deg[:n]


@functools.partial(jax.jit,
                   static_argnames=("op", "n", "tol", "max_iter"))
def _deflated_pcg_gnm(op, t, inv_diag, rhs, n, *, tol, max_iter):
    """GNM counterpart of :func:`_deflated_pcg`: vectors are ``(n, k)``
    and the preconditioner is the inverse degree diagonal."""
    def deflate(x):
        return x - jnp.matmul(
            t, jnp.matmul(t.T, x, precision=_HIGHEST),
            precision=_HIGHEST)

    def precond(r):
        return deflate(inv_diag[:, None] * r)

    b = deflate(rhs)
    b_norm = jnp.maximum(jnp.linalg.norm(b, axis=0), 1e-30)
    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = precond(r0)
    rz0 = jnp.sum(r0 * z0, axis=0)
    active0 = jnp.linalg.norm(r0, axis=0) / b_norm > tol

    def cond(state):
        i, _, _, _, _, _, active = state
        return (i < max_iter) & jnp.any(active)

    def body(state):
        i, x, r, z, p, rz, active = state
        hp = deflate(op(p))
        denom = jnp.sum(p * hp, axis=0)
        ok = active & jnp.isfinite(denom) & (denom > 0) & (rz > 0)
        alpha = jnp.where(ok, rz / jnp.where(ok, denom, 1.0), 0.0)
        x = x + p * alpha[None, :]
        r = r - hp * alpha[None, :]
        z = precond(r)
        rz_new = jnp.sum(r * z, axis=0)
        beta = jnp.where(ok, rz_new / jnp.where(ok, rz, 1.0), 0.0)
        p = jnp.where(ok[None, :], z + p * beta[None, :], p)
        rel = jnp.linalg.norm(r, axis=0) / b_norm
        return i + 1, x, r, z, p, rz_new, ok & (rel > tol)

    state = (jnp.asarray(0), x0, r0, z0, z0, rz0, active0)
    i, x, r, _, _, _, _ = jax.lax.while_loop(cond, body, state)
    res = jnp.linalg.norm(r, axis=0) / b_norm
    return deflate(x), i, res


def covariance_solve_matfree_gnm(coord, params, rhs, *, masses=None,
                                 tol=1e-6, max_iter=1000,
                                 tile=SPARSE_TILE, block=512,
                                 sparse=None, dtype=jnp.float32,
                                 precond=True):
    """
    ``pinv(K) @ rhs`` for the GNM Kirchhoff matrix without
    materializing it — the GNM counterpart of
    :func:`covariance_solve_matfree` (constant-mode deflation, degree
    Jacobi preconditioner, per-column CG step sizes).  `rhs` is
    ``(n, k)`` or ``(n,)``.  ``precond=False`` skips the O(n^2)
    degree pass (identity preconditioner — use beyond ~100k atoms).
    Requires a *connected* network.

    Returns ``(x, n_iter, residuals)`` like the ANM version.
    """
    concrete = not isinstance(coord, jax.core.Tracer)
    coord = jnp.asarray(coord, dtype=dtype)
    n = coord.shape[0]
    if sparse is None:
        sparse = concrete and config.use_sparse_apply(n, dtype, params)

    rhs = jnp.asarray(rhs, dtype=dtype)
    squeeze = rhs.ndim == 1
    if squeeze:
        rhs = rhs[:, None]

    if precond:
        deg = kirchhoff_degree(coord, params, block=block, dtype=dtype)
        if masses is not None:
            w2 = 1.0 / jnp.asarray(masses, dtype)
            deg = deg * w2
        inv_diag = 1.0 / jnp.maximum(deg, 1e-30)
    else:
        inv_diag = jnp.ones(n, dtype)

    perm = None
    if sparse:
        coord_s, params_s, masses_s, nbr, counts, perm = _sparse_setup(
            coord, params, masses, tile, dtype, concrete)
        base = functools.partial(
            kirchhoff_apply_pallas_sparse, coord_s, params=params_s,
            nbr=nbr, counts=counts,
            orig_ids=jnp.asarray(perm, jnp.int32), tile=tile,
            dtype=dtype)
        coord = coord_s
        masses = masses_s
        inv_diag = inv_diag[perm]
        rhs = rhs[perm]
    else:
        base = functools.partial(kirchhoff_apply, coord, params=params,
                                 block=block, dtype=dtype)

    if masses is not None:
        w = 1.0 / jnp.sqrt(jnp.asarray(masses, dtype))

        def op(x):
            return w[:, None] * base(w[:, None] * x)
    else:
        op = base

    null = (jnp.sqrt(jnp.asarray(masses, dtype))
            if masses is not None else jnp.ones(n, dtype))
    t = (null / jnp.linalg.norm(null))[:, None]

    x, n_it, res = _deflated_pcg_gnm(op, t, inv_diag, rhs, n, tol=tol,
                                     max_iter=max_iter)
    if perm is not None:
        x = x[np.argsort(perm)]
    return (x[:, 0], n_it, res) if squeeze else (x, n_it, res)


def dcc_rows_matfree_gnm(coord, params, sites, *, norm=True, msf=None,
                         masses=None, dtype=jnp.float32, **options):
    """
    GNM DCC rows without the covariance: the all-mode GNM DCC *is* the
    covariance (reference ``nma.py:324-325``), so each requested row is
    one ``pinv(K) @ e_site`` solve (:func:`covariance_solve_matfree_gnm`).
    `msf` (the covariance diagonal) is required for ``norm=True`` —
    at mega scale use the mode-sum MSF from
    :func:`lowest_modes_matfree_gnm`.

    Returns ``(dcc_rows (len(sites), n), n_iter, residuals)``.
    """
    coord = jnp.asarray(coord, dtype=dtype)
    n = coord.shape[0]
    sites = np.asarray(sites, dtype=np.int64)
    if sites.ndim != 1 or np.any(sites < 0) or np.any(sites >= n):
        raise IndexError(f"sites must be flat indices in [0, {n})")
    if norm and msf is None:
        raise ValueError(
            "norm=True needs the covariance diagonal: pass msf=(all-"
            "mode GNM MSF; at mega scale the mode-sum MSF from "
            "lowest_modes_matfree_gnm), or use norm=False")

    rhs = np.zeros((n, len(sites)), dtype=np.float64)
    rhs[sites, np.arange(len(sites))] = 1.0
    x, n_it, res = covariance_solve_matfree_gnm(
        coord, params, rhs, masses=masses, dtype=dtype, **options)
    rows = jnp.transpose(x, (1, 0))
    if norm:
        diag = jnp.asarray(msf, dtype=rows.dtype)
        rows = rows / jnp.sqrt(diag[None, :] * diag[sites][:, None])
    return rows, n_it, res


def dcc_rows_matfree(coord, params, sites, *, norm=True, msf=None,
                     masses=None, dtype=jnp.float32, **options):
    """
    Dynamic cross-correlation rows for selected sites, without the
    covariance matrix (the reference DCC capability, ``nma.py:233-359``,
    extended past dense scale).  For each site the three covariance
    columns ``pinv(H) @ e_(site, a)`` are solved by deflated CG
    (:func:`covariance_solve_matfree`); the 3x3 superelement traces of
    those columns are exactly the all-mode DCC row
    ``DCC[site, j] = tr C(site, j)``.

    Parameters
    ----------
    sites : sequence of int
        Atom indices whose DCC rows to compute.
    norm : bool
        Normalize ``DCC_ij / sqrt(DCC_ii DCC_jj)`` (reference
        ``nma.py:350-353``).  The full diagonal ``DCC_jj`` (the per-atom
        covariance traces, i.e. the all-mode MSF) cannot be recovered
        from the site columns alone — pass it as `msf`.
    msf : ndarray, shape=(n,), optional
        Per-atom covariance traces for normalization.  At mega scale
        use :func:`msf_stochastic` (unbiased all-mode estimate) or the
        mode-sum MSF from :func:`lowest_modes_matfree` (a truncated
        lower bound); exact traces give exact reference parity.
        Required when ``norm=True``.

    Returns
    -------
    dcc_rows : ndarray, shape=(len(sites), n)
    n_iter : int
        CG iterations of the underlying solves.
    residuals : ndarray, shape=(3 * len(sites),)
        CG relative residuals — check convergence.
    """
    coord = jnp.asarray(coord, dtype=dtype)
    n = coord.shape[0]
    sites = np.asarray(sites, dtype=np.int64)
    if sites.ndim != 1 or np.any(sites < 0) or np.any(sites >= n):
        raise IndexError(f"sites must be flat indices in [0, {n})")
    if norm and msf is None:
        raise ValueError(
            "norm=True needs the per-atom covariance traces for the "
            "DCC denominator: pass msf=(all-mode MSF; at mega scale "
            "the mode-sum MSF from lowest_modes_matfree), or use "
            "norm=False")
    n_sites = sites.shape[0]

    # Unit perturbations e_(site, a) in xyz layout, site-major columns
    rhs = np.zeros((3 * n, 3 * n_sites), dtype=np.float64)
    for s, site in enumerate(sites):
        for a in range(3):
            rhs[a * n + site, 3 * s + a] = 1.0

    x, n_it, res = covariance_solve_matfree(
        coord, params, rhs, masses=masses, dtype=dtype, **options)
    cols = jnp.reshape(x, (3, n, n_sites, 3))   # [b, j, s, a]
    # superelement trace: sum over the b == a diagonal
    rows = jnp.transpose(
        sum(cols[a, :, :, a] for a in range(3)), (1, 0))
    if norm:
        diag = jnp.asarray(msf, dtype=rows.dtype)
        rows = rows / jnp.sqrt(diag[None, :] * diag[sites][:, None])
    return rows, n_it, res


def matfree_mode_residuals(coord, params, eig_values, eig_vectors, *,
                           masses=None, block=512, dtype=jnp.float32):
    """Relative eigenpair residuals via the matrix-free operator —
    post-hoc convergence check without the dense Hessian."""
    coord = jnp.asarray(coord, dtype=dtype)
    u = jnp.asarray(eig_vectors, dtype).T  # (m, k)
    if masses is not None:
        w3 = jnp.tile(1.0 / jnp.sqrt(jnp.asarray(masses, dtype)), 3)
        hu = w3[:, None] * hessian_apply(
            coord, w3[:, None] * u, params, block=block, dtype=dtype)
    else:
        hu = hessian_apply(coord, u, params, block=block, dtype=dtype)
    lam = jnp.asarray(eig_values, dtype)
    r = hu - u * lam[None, :]
    return jnp.linalg.norm(r, axis=0) / jnp.maximum(jnp.abs(lam), 1e-30)
