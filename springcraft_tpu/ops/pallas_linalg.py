"""
Batched dense symmetric-positive-definite inverse by recursive blocking.

The ensemble fluctuation pipelines need ``A^-1`` (or its Gram factor)
for a whole batch of SPD matrices.  XLA's batched ``cholesky`` +
``cho_solve`` against the identity is one route (``inverse="cho_solve"``
in ``ops.rigid``); this module is the other:

* a divide-and-conquer inverse factor (`_recursive_inverse_factor`):
  four *square* half-size batched matmuls per node on 128-aligned
  splits, plus the final Gram product ``A^-1 = G^T G`` — matmul-rich
  XLA with no large ``triangular_solve``;
* leaves of at most ``block`` (64) rows, factored by XLA's batched
  ``cholesky`` and inverted by a batched ``triangular_solve`` against
  the identity (`panel_cholesky_batched`, `panel_inverse_batched`).

Which of the two routes ``inverse="auto"`` takes is decided by
measurement on the card (:func:`springcraft_tpu.utils.config.
ensemble_inverse`).  Every contraction runs at ``precision="highest"``:
a float32 matmul left at the default may run in TF32.

Reference semantics served: ``np.linalg.pinv(hermitian=True)``
covariance at `/root/reference/src/springcraft/anm.py:133-136` via
`ops.rigid.covariance_cholesky` (which regularizes + equilibrates and
calls :func:`spd_inverse_factor` on its batched fast path).
"""

import jax
import jax.numpy as jnp

__all__ = ["panel_cholesky_batched", "panel_inverse_batched",
           "spd_inverse_blocked", "spd_inverse_factor",
           "spd_inverse_factor_parts"]

_HIGH = jax.lax.Precision.HIGHEST


def _round_up(x, m):
    return -(-x // m) * m


def _check_panels(panels):
    if panels.ndim != 3 or panels.shape[1] != panels.shape[2]:
        raise ValueError(f"panels must be (b, pb, pb), got {panels.shape}")


def _lower_inverse(l):
    eye = jnp.broadcast_to(jnp.eye(l.shape[-1], dtype=l.dtype), l.shape)
    return jax.lax.linalg.triangular_solve(l, eye, left_side=True,
                                           lower=True)


def panel_cholesky_batched(panels):
    """
    Cholesky factor and its inverse for a batch of small SPD panels.

    Parameters
    ----------
    panels : ndarray, shape=(b, pb, pb)
        SPD diagonal panels.

    Returns
    -------
    l : ndarray, shape=(b, pb, pb)
        Lower Cholesky factors (strict upper zero).
    w : ndarray, shape=(b, pb, pb)
        ``L^-1`` (lower triangular).

    A panel that is not SPD (e.g. a null space beyond the caller's
    regularization) surfaces as non-finite values, never as silent
    finite garbage.
    """
    panels = jnp.asarray(panels)
    _check_panels(panels)
    l = jax.lax.linalg.cholesky(panels)
    return l, _lower_inverse(l)


def panel_inverse_batched(panels):
    """
    ``L^-1`` of a batch of small SPD panels (``L`` their lower Cholesky
    factor) — the leaf operation of :func:`spd_inverse_factor`.  Same
    contract as :func:`panel_cholesky_batched`, returning only the
    lower-triangular inverse factor.
    """
    panels = jnp.asarray(panels)
    _check_panels(panels)
    return _lower_inverse(jax.lax.linalg.cholesky(panels))


def spd_inverse_blocked(a, block=64, precision=None):
    """
    Dense inverse of a batch of SPD matrices via the recursive blocked
    inverse factor: ``A^-1 = G^T G`` with ``G = L^-1`` from
    :func:`_recursive_inverse_factor` (square half-size batched matmuls
    at every node, XLA Cholesky leaves of at most `block` rows).  All
    contractions run at ``precision='highest'``.

    Parameters
    ----------
    a : ndarray, shape=(..., m, m)
        SPD batch (use Jacobi equilibration upstream for
        ill-conditioned inputs — see ``ops.rigid.covariance_cholesky``).
    block : int
        Leaf-panel cap (multiple of 8, <= 128).

    Returns
    -------
    inv : ndarray, shape=(..., m, m)
    """
    a = jnp.asarray(a)
    if a.ndim < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"expected (..., m, m), got {a.shape}")
    batch_shape = a.shape[:-2]
    m = a.shape[-1]
    a = a.reshape((-1, m, m))
    prec = _HIGH if precision is None else precision
    g = _padded_inverse_factor(a, m, block, prec)
    inv = jnp.einsum("bki,bkj->bij", g, g, precision=prec)
    if inv.shape[-1] != m:
        inv = inv[:, :m, :m]
    return inv.reshape(batch_shape + (m, m))


def spd_inverse_factor(a, block=64, precision=None):
    """
    Inverse Gram factor of an SPD batch: returns ``G`` of shape
    ``(..., mp, mp)`` — the padded factorization's ``L^-1``, with
    ``mp`` the recursion-friendly padded size (:func:`padded_size`) —
    such that ``A^-1 = (G^T @ G)[:m, :m]``.  G stays at the padded
    size; callers that post-scale the inverse (e.g. the Jacobi
    un-scaling in ``ops.rigid.covariance_cholesky``) fold the scaling
    into G's columns (zero-padded past ``m``) and save full elementwise
    passes over the inverse.
    """
    a = jnp.asarray(a)
    if a.ndim < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"expected (..., m, m), got {a.shape}")
    batch_shape = a.shape[:-2]
    m = a.shape[-1]
    a = a.reshape((-1, m, m))
    prec = _HIGH if precision is None else precision
    g = _padded_inverse_factor(a, m, block, prec)
    return g.reshape(batch_shape + g.shape[-2:])


def spd_inverse_factor_parts(a, block=64, precision=None):
    """
    Top-split form of :func:`spd_inverse_factor`: the blocks
    ``(g11, g21, g22)`` with ``G = [[g11, 0], [g21, g22]]`` at the
    padded size (``g21 is None`` when the padded problem fits a single
    leaf and ``g11`` is the whole factor).

    Consumers that contract ``G`` blockwise — the fluctuation
    pipeline's plane-trace Grams (``ops.rigid``) — skip the factor's
    final materializing concat this way.
    """
    a = jnp.asarray(a)
    if a.ndim < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"expected (..., m, m), got {a.shape}")
    batch_shape = a.shape[:-2]
    m = a.shape[-1]
    a = a.reshape((-1, m, m))
    prec = _HIGH if precision is None else precision
    base = max(8, min(128, block))
    mp = _choose_padding(m, base)
    if mp != m:
        pad = mp - m
        a = jnp.pad(a, ((0, 0), (0, pad), (0, pad)))
        diag = jnp.arange(m, mp)
        a = a.at[:, diag, diag].set(1.0)
    g11, g21, g22 = _top_inverse_factor_parts(a, base, prec)
    if g21 is None:
        return g11.reshape(batch_shape + g11.shape[-2:]), None, None
    return (g11.reshape(batch_shape + g11.shape[-2:]),
            g21.reshape(batch_shape + g21.shape[-2:]),
            g22.reshape(batch_shape + g22.shape[-2:]))


def _top_inverse_factor_parts(a, base, precision):
    """One node of the divide-and-conquer inverse factor with the
    final concat left to the caller: ``(g11, g21, g22)``, or
    ``(g, None, None)`` when ``a`` fits a single leaf."""
    s = a.shape[-1]
    if s <= base:
        return panel_inverse_batched(a), None, None
    h = _round_up(s // 2, 128)
    if h >= s:
        h = s // 2
    g11 = _recursive_inverse_factor(a[:, :h, :h], base, precision)
    l21, s22 = _schur_lower(a, h, g11, precision)
    g22 = _recursive_inverse_factor(s22, base, precision)
    g21 = -_tri_left_mm(g22, _tri_right_mm(l21, g11, precision),
                        precision)
    return g11, g21, g22


def padded_size(m, block=64):
    """Public probe of the recursion's padded size: callers that can
    emit the SPD input already identity-padded to this size (e.g.
    ``rigid._regularize_equilibrated(pad_to=...)``) save the factor's
    own O(m^2) pad pass."""
    return _choose_padding(m, max(8, min(128, block)))


def _choose_padding(m, base_max):
    """Padded size for the recursive inverse factor: the next multiple
    of 128, so every recursion level splits on a 128-aligned boundary,
    or the next multiple of 8 (64 up to 256) for small inputs."""
    if m <= max(8, min(128, base_max)):
        return _round_up(m, 8)
    if m <= 256:
        return _round_up(m, 64)
    return _round_up(m, 128)


def _padded_inverse_factor(a, m, block, precision=_HIGH):
    """(b, m, m) SPD -> (b, mp, mp) inverse factor of the
    identity-padded problem (exact: padding decouples)."""
    mp = _choose_padding(m, block)
    if mp != m:
        pad = mp - m
        a = jnp.pad(a, ((0, 0), (0, pad), (0, pad)))
        # identity on the padding diagonal keeps the factorization exact
        diag = jnp.arange(m, mp)
        a = a.at[:, diag, diag].set(1.0)
    return _recursive_inverse_factor(a, max(8, min(128, block)),
                                     precision)


def _recursive_inverse_factor(a, base, precision=_HIGH):
    """``G = L^-1`` of batched SPD ``(b, s, s)`` by divide-and-conquer:

        A = [[A11,   .], [A21, A22]]
        G11 = invfactor(A11);  L21 = A21 @ G11^T
        G22 = invfactor(A22 - L21 @ L21^T)
        G21 = -G22 @ (L21 @ G11)

    Every node is four *square-ish* half-size batched matmuls.  The
    split point rounds up to a multiple of 128 so every sub-block stays
    aligned; the sequential elimination only runs in the leaves (size
    <= ``base``).
    """
    s = a.shape[-1]
    g11, g21, g22 = _top_inverse_factor_parts(a, base, precision)
    if g21 is None:
        return g11
    h = g11.shape[-1]
    top = jnp.concatenate(
        [g11, jnp.zeros(a.shape[:-2] + (h, s - h), a.dtype)], axis=2)
    bot = jnp.concatenate([g21, g22], axis=2)
    return jnp.concatenate([top, bot], axis=1)


def _tri_split(h):
    """128-aligned split point for exploiting a sub-factor's
    lower-triangular block structure, or 0 when ``h`` is too small to
    split (the dense form is then used)."""
    q = _round_up(h // 2, 128)
    return q if 0 < q < h else 0


def _schur_lower(a, h, g11, precision):
    """``L21 = A21 G11^T`` and ``S22 = A22 - L21 L21^T`` with the
    sub-factor's zero blocks skipped.

    G11 is lower-triangular with EXACT zero top-right blocks at every
    recursion split (the concatenated zeros above), so with
    ``G11 = [[T1, 0], [X, T2]]`` the product columns ``[:q]`` contract
    only ``q`` terms.  S22's strict upper-right quadrant is zero-FILLED
    rather than computed: the recursion consuming it only ever reads
    diagonal blocks and lower-left blocks (inductively down to the leaf
    panels, which receive full true diagonal blocks), so those values
    are never used.  Together ~1/4 of the node's Schur/stitch flops are
    skipped; results are bit-identical up to f32 summation of the
    dropped exact-zero terms (measured 6e-8 relative vs the dense forms
    at (128, 1024)).
    """
    a21 = a[:, h:, :h]
    q = _tri_split(h)
    if not q:
        l21 = jnp.einsum("bij,bkj->bik", a21, g11, precision=precision)
        s22 = a[:, h:, h:] - jnp.einsum("bik,bjk->bij", l21, l21,
                                        precision=precision)
        return l21, s22
    l21 = jnp.concatenate([
        jnp.einsum("bij,bkj->bik", a21[:, :, :q], g11[:, :q, :q],
                   precision=precision),
        jnp.einsum("bij,bkj->bik", a21, g11[:, q:, :],
                   precision=precision),
    ], axis=2)
    w = a.shape[-1] - h
    qq = _tri_split(w)
    if not qq:
        s22 = a[:, h:, h:] - jnp.einsum("bik,bjk->bij", l21, l21,
                                        precision=precision)
        return l21, s22
    s22_l = a[:, h:, h:h + qq] - jnp.einsum(
        "bik,bjk->bij", l21, l21[:, :qq, :], precision=precision)
    s22_br = a[:, h + qq:, h + qq:] - jnp.einsum(
        "bik,bjk->bij", l21[:, qq:, :], l21[:, qq:, :],
        precision=precision)
    s22 = jnp.concatenate([
        jnp.concatenate(
            [s22_l[:, :qq, :],
             jnp.zeros(a.shape[:-2] + (qq, w - qq), a.dtype)], axis=2),
        jnp.concatenate([s22_l[:, qq:, :], s22_br], axis=2),
    ], axis=1)
    return l21, s22


def _tri_right_mm(x, g, precision):
    """``X @ G`` for a sub-factor ``G`` with exact zero top-right
    blocks: output columns ``[q:]`` contract only ``G``'s bottom
    rows."""
    h = g.shape[-1]
    q = _tri_split(h)
    if not q:
        return jnp.einsum("bij,bjk->bik", x, g, precision=precision)
    return jnp.concatenate([
        jnp.einsum("bij,bjk->bik", x, g[:, :, :q], precision=precision),
        jnp.einsum("bij,bjk->bik", x[:, :, q:], g[:, q:, q:],
                   precision=precision),
    ], axis=2)


def _tri_left_mm(g, x, precision):
    """``G @ X`` for a sub-factor ``G`` with exact zero top-right
    blocks: output rows ``[:q]`` contract only ``G``'s leading
    columns."""
    h = g.shape[-2]
    q = _tri_split(h)
    if not q:
        return jnp.einsum("bij,bjk->bik", g, x, precision=precision)
    return jnp.concatenate([
        jnp.einsum("bij,bjk->bik", g[:, :q, :q], x[:, :q, :],
                   precision=precision),
        jnp.einsum("bij,bjk->bik", g[:, q:, :], x, precision=precision),
    ], axis=1)


