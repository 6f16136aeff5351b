"""
Dense Kirchhoff / Hessian assembly as pure array functions.

Accelerator-first re-design of reference ``interaction.py:14-111``:

* The reference builds a sparse pair list (``np.where`` over an adjacency
  matrix, ``interaction.py:177-178``) and scatters per-pair values.  Here
  the interaction matrices are assembled with *dense masked algebra* over
  the full (tiled) pairwise plane: static shapes, no scatter, fully
  jit/vmap-compatible, and fusable by XLA.
* Two Hessian layouts are supported:
  - ``"atom"``  — ``[x1, y1, z1, ..., xn, yn, zn]`` (reference layout,
    ``interaction.py:80-81``), used for parity.
  - ``"xyz"``   — ``[x1..xn, y1..yn, z1..zn]``: nine contiguous
    ``(n, n)`` component planes.  This is the device layout — each
    plane is a contiguous block, and the two layouts
    are related by a permutation similarity (identical eigenvalues).
* ``hessian_rows`` computes a row-block of the Hessian without
  materializing the full ``(n, n, 3, 3)`` tensor, enabling blocked /
  sharded assembly for large systems.

All functions take an array-module argument ``xp`` (``jax.numpy`` or
``numpy``) so the float64 parity backend and the device backend share one
implementation.
"""

from __future__ import annotations

import numpy as np

from .ffparams import force_constant_matrix, pairwise_sq_distance

__all__ = [
    "kirchhoff_matrix",
    "kirchhoff_rows",
    "hessian_matrix",
    "hessian_rows",
    "atom_to_xyz_permutation",
    "mass_weights",
]


def kirchhoff_matrix(coord, params, xp, dtype=None):
    """
    Dense Kirchhoff matrix.

    Matches reference ``compute_kirchhoff`` (``interaction.py:14-54``):
    off-diagonal ``-k_ij`` for interacting pairs, diagonal equal to the
    negated column sums.
    """
    coord = xp.asarray(coord)
    if dtype is not None:
        coord = coord.astype(dtype)
    _, sq_dist = pairwise_sq_distance(coord, xp)
    k = force_constant_matrix(sq_dist, params, xp, dtype=coord.dtype)
    # K = diag(col-sums of k) - k
    return xp.diag(xp.sum(k, axis=0)) - k


def kirchhoff_rows(coord, params, row_start, block, xp, dtype=None):
    """
    One row-block of the Kirchhoff matrix without materializing the
    full ``(n, n)`` plane — the GNM counterpart of
    :func:`hessian_rows`.  Returns shape ``(block, n)`` covering rows
    ``[row_start, row_start + block)``.  The diagonal of row ``i``
    equals the row sum of force constants (column sum by symmetry,
    reference ``interaction.py:50-52``), so each block is computable
    locally.
    """
    coord = xp.asarray(coord)
    if dtype is not None:
        coord = coord.astype(dtype)
    n = coord.shape[0]
    rows = xp.asarray(coord)[row_start:row_start + block] \
        if isinstance(row_start, int) else None
    if rows is None:
        import jax.lax as lax
        rows = lax.dynamic_slice_in_dim(coord, row_start, block, axis=0)

    disp = rows[:, None, :] - coord[None, :, :]
    sq_dist = xp.sum(disp * disp, axis=-1)
    k = _row_force_constants(sq_dist, params, row_start, block, xp,
                             rows.dtype)
    diag = xp.sum(k, axis=1)
    row_ids = _arange(block, xp) + row_start
    col_ids = _arange(n, xp)
    eye = row_ids[:, None] == col_ids[None, :]
    return xp.where(eye, diag[:, None], -k)


def _hessian_blocks(coord, params, xp, dtype):
    """Off-diagonal 3x3 superelements and the force-constant matrix.

    Returns ``off`` with shape (n, n, 3, 3) where ``off[i, j]`` is
    ``-k_ij / d^2 * disp disp^T`` for ``i != j`` and zero on the diagonal
    (reference ``interaction.py:96-101``)."""
    coord = xp.asarray(coord)
    if dtype is not None:
        coord = coord.astype(dtype)
    disp, sq_dist = pairwise_sq_distance(coord, xp)
    k = force_constant_matrix(sq_dist, params, xp, dtype=coord.dtype)
    safe_sq = xp.where(sq_dist == 0, xp.ones_like(sq_dist), sq_dist)
    g = -k / safe_sq
    # Explicit broadcast product, NOT einsum: under jit an einsum (even
    # contraction-free) lowers to dot_general at DEFAULT precision,
    # which may round f32 operands to TF32 on a GPU (~1e-3 error).
    off = (g[:, :, None, None] * disp[:, :, :, None]
           * disp[:, :, None, :])
    return off


def hessian_matrix(coord, params, xp, dtype=None, layout="atom"):
    """
    Dense ``(3n, 3n)`` Hessian.

    Matches reference ``compute_hessian`` (``interaction.py:57-111``):
    off-diagonal superelements ``-k/d^2 * disp disp^T``, diagonal
    superelements equal to the negated column-sum of superelements.

    Parameters
    ----------
    layout : {"atom", "xyz"}
        ``"atom"`` interleaves components per atom (reference layout);
        ``"xyz"`` groups by component (device plane layout).
    """
    off = _hessian_blocks(coord, params, xp, dtype)
    n = off.shape[0]
    # Diagonal superelement: -sum over first axis (interaction.py:103-104)
    diag = -xp.sum(off, axis=0)
    eye = xp.eye(n, dtype=bool)[:, :, None, None]
    full = xp.where(eye, diag[:, None, :, :], off)
    if layout == "atom":
        return xp.transpose(full, (0, 2, 1, 3)).reshape(3 * n, 3 * n)
    elif layout == "xyz":
        return xp.transpose(full, (2, 0, 3, 1)).reshape(3 * n, 3 * n)
    raise ValueError(f"Unknown layout '{layout}'")


def hessian_rows(coord, params, row_start, block, xp, dtype=None):
    """
    One row-block of the atom-layout Hessian, without materializing the
    full ``(n, n, 3, 3)`` tensor — building block for scan-blocked and
    mesh-sharded assembly of very large systems.

    Returns shape ``(3 * block, 3 * n)`` covering atom rows
    ``[row_start, row_start + block)``.

    Notes
    -----
    The diagonal superelement of row ``i`` equals the negated sum of
    *column* ``i`` superelements (reference ``interaction.py:103-104``);
    by symmetry of ``disp disp^T`` this equals the row sum, so each row
    block is computable locally from its own rows — no cross-block
    reduction (and on a mesh: no collective) is required.
    """
    coord = xp.asarray(coord)
    if dtype is not None:
        coord = coord.astype(dtype)
    n = coord.shape[0]
    rows = xp.asarray(coord)[row_start:row_start + block] \
        if isinstance(row_start, int) else None
    if rows is None:
        import jax.lax as lax
        rows = lax.dynamic_slice_in_dim(coord, row_start, block, axis=0)

    disp = rows[:, None, :] - coord[None, :, :]
    sq_dist = xp.sum(disp * disp, axis=-1)  # not einsum: see ffparams
    k = _row_force_constants(sq_dist, params, row_start, block, xp,
                             rows.dtype)
    safe_sq = xp.where(sq_dist == 0, xp.ones_like(sq_dist), sq_dist)
    g = -k / safe_sq
    off = (g[:, :, None, None] * disp[:, :, :, None]
           * disp[:, :, None, :])  # not einsum: see _hessian_blocks

    # Row-local diagonal superelements
    diag = -xp.sum(off, axis=1)
    row_ids = _arange(block, xp) + row_start
    col_ids = _arange(n, xp)
    eye = (row_ids[:, None] == col_ids[None, :])[:, :, None, None]
    full = xp.where(eye, diag[:, None, :, :], off)
    return xp.transpose(full, (0, 2, 1, 3)).reshape(3 * block, 3 * n)


def _arange(n, xp):
    return xp.arange(n)


def _row_force_constants(sq_dist, params, row_start, block, xp, dtype):
    """Force constants for a row block.  Supports the analytic families
    and compact tables (the scalable representations); the O(n^2)
    ``table_pair``/overlay representations go through the full-matrix
    path instead."""
    from . import ffparams as fp

    if params.overlays:
        raise NotImplementedError(
            "Blocked assembly does not support patch overlays; "
            "use the dense path"
        )
    if params.kind == "table_pair":
        table = xp.asarray(params.pair_table)
        if isinstance(row_start, int):
            table = table[row_start:row_start + block]
        else:
            import jax.lax as lax
            table = lax.dynamic_slice_in_dim(table, row_start, block, axis=0)
        bins = fp._bin_indices(sq_dist, params, xp)
        if bins is None:
            k = table[..., 0]
        else:
            k = xp.take_along_axis(table, bins[..., None], axis=-1)[..., 0]
    elif params.kind == "table_compact":
        k = _compact_row_constants(sq_dist, params, row_start, block, xp)
    else:
        k = fp._base_constants(sq_dist, params, xp)

    n = sq_dist.shape[-1]
    row_ids = _arange(block, xp) + row_start
    col_ids = _arange(n, xp)
    not_self = row_ids[:, None] != col_ids[None, :]
    if params.has_cutoff:
        adj = (sq_dist <= params.cutoff_sq) & not_self
    else:
        adj = not_self
    return xp.where(adj, k, xp.zeros_like(k)).astype(dtype)


def _compact_row_constants(sq_dist, params, row_start, block, xp):
    from . import ffparams as fp

    t = xp.asarray(params.type_idx)
    chain = xp.asarray(params.chain_code)
    bnext = xp.asarray(params.bonded_next)
    if isinstance(row_start, int):
        t_rows = t[row_start:row_start + block]
        chain_rows = chain[row_start:row_start + block]
        bnext_rows = bnext[row_start:row_start + block]
    else:
        import jax.lax as lax
        t_rows = lax.dynamic_slice_in_dim(t, row_start, block)
        chain_rows = lax.dynamic_slice_in_dim(chain, row_start, block)
        bnext_rows = lax.dynamic_slice_in_dim(bnext, row_start, block)

    ti = t_rows[:, None]
    tj = t[None, :]
    bins = fp._bin_indices(sq_dist, params, xp)
    if bins is None:
        bins = xp.zeros_like(sq_dist, dtype=xp.int32)
    intra = xp.asarray(params.intra_table)[ti, tj, bins]
    inter = xp.asarray(params.inter_table)[ti, tj, bins]
    same_chain = chain_rows[:, None] == chain[None, :]
    k = xp.where(same_chain, intra, inter)

    bonded_k = xp.asarray(params.bonded_table)[ti, tj, bins]
    n = sq_dist.shape[-1]
    row_ids = _arange(block, xp) + row_start
    col_ids = _arange(n, xp)
    delta = col_ids[None, :] - row_ids[:, None]
    # j == i + 1 bonded via bonded_next[i]; j == i - 1 via bonded_next[j]
    bonded_mask = ((delta == 1) & bnext_rows[:, None]) | (
        (delta == -1) & bnext[None, :]
    )
    return xp.where(bonded_mask, bonded_k, k)


def overlay_correction_hessian_xyz(hessian, coord, params, xp):
    """Add the patch-overlay correction to a base-family xyz-layout
    Hessian as a sparse scatter of 3x3 superelements — O(P) for P
    affected pairs, so the fused Pallas kernels keep their O(n)
    parameterization while supporting ``PatchedForceField``
    (reference ``forcefield.py:117-261``)."""
    from . import ffparams as fp

    ii, jj, delta, disp, safe_sq = fp.overlay_pair_delta(
        coord, params, xp)
    if len(ii) == 0:
        return hessian
    n = coord.shape[0]
    g = (delta / safe_sq).astype(hessian.dtype)
    disp = disp.astype(hessian.dtype)
    for a in range(3):
        for b in range(3):
            v = g * disp[:, a] * disp[:, b]
            # off-diagonal superelements carry -g d d^T on both
            # triangles (d_ji d_ji^T == d_ij d_ij^T); the diagonal
            # compensation adds +g d d^T at (i, i) and (j, j)
            hessian = hessian.at[a * n + ii, b * n + jj].add(-v)
            hessian = hessian.at[a * n + jj, b * n + ii].add(-v)
            hessian = hessian.at[a * n + ii, b * n + ii].add(v)
            hessian = hessian.at[a * n + jj, b * n + jj].add(v)
    return hessian


def overlay_correction_kirchhoff(kirchhoff, coord, params, xp):
    """GNM counterpart of :func:`overlay_correction_hessian_xyz`:
    sparse Kirchhoff correction for patch overlays."""
    from . import ffparams as fp

    ii, jj, delta, _, _ = fp.overlay_pair_delta(coord, params, xp)
    if len(ii) == 0:
        return kirchhoff
    d = delta.astype(kirchhoff.dtype)
    kirchhoff = kirchhoff.at[ii, jj].add(-d)
    kirchhoff = kirchhoff.at[jj, ii].add(-d)
    kirchhoff = kirchhoff.at[ii, ii].add(d)
    kirchhoff = kirchhoff.at[jj, jj].add(d)
    return kirchhoff


def atom_to_xyz_permutation(n):
    """Permutation ``p`` with ``H_xyz = H_atom[p][:, p]``: index ``(a, i)``
    in xyz layout maps to ``3 * i + a`` in atom layout."""
    return (np.arange(3)[:, None] + 3 * np.arange(n)[None, :]).reshape(-1)


def mass_weights(masses, xp, repeat3=False):
    """
    Mass-weight matrix ``outer(1/sqrt(m), 1/sqrt(m))``, with each weight
    repeated three times for Hessians (reference ``anm.py:89-96``,
    ``gnm.py:85-89``).
    """
    w = 1.0 / xp.sqrt(xp.asarray(masses))
    if repeat3:
        w = xp.repeat(w, 3)
    return xp.outer(w, w)
