"""
Analytic null-space handling: rigid-body modes and fast pseudo-inverse.

The reference obtains the ENM covariance as
``np.linalg.pinv(hessian, hermitian=True, rcond=1e-6)`` — an O(n^3)
eigendecomposition (reference ``anm.py:135``, ``gnm.py:128``).  A
Cholesky factorization costs a fraction of a symmetric
eigendecomposition.  For a *connected* elastic network the null space
is known analytically:

* ANM: the six rigid-body modes (three translations, three rotations
  about the centroid);
* GNM: the constant vector.

With an orthonormal null basis ``T`` and any ``sigma > 0``,

    pinv(H) = (H + sigma * T T^t)^{-1} - (1/sigma) * T T^t

because ``H`` and ``T T^t`` act on orthogonal complements.  The
regularized matrix is positive definite, so the inverse comes from a
Cholesky solve.  This path yields every covariance-derived observable (MSF,
B-factors, DCC, PRS, linear response); only mode frequencies/shapes
still need the eigensolve.

Caveat: if the network is disconnected (or has collinear degeneracies),
extra null modes exist outside ``T`` and this fast path is invalid —
use the eigh-based :func:`springcraft_tpu.ops.linalg.pinvh` instead.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl

__all__ = [
    "rigid_modes_anm",
    "null_mode_gnm",
    "covariance_cholesky",
    "covariance_plane_traces",
    "pinv_diagonal",
]


def rigid_modes_anm(coord, masses=None, layout="xyz"):
    """
    Orthonormal basis of the six rigid-body modes of an ANM Hessian.

    Parameters
    ----------
    coord : ndarray, shape=(n, 3)
    masses : ndarray, shape=(n,), optional
        For a mass-weighted Hessian ``W H W`` (``W = diag(1/sqrt(m))``)
        the null vectors are the rigid modes scaled by ``sqrt(m)``.
    layout : {"xyz", "atom"}
        Component layout of the ``(3n,)`` mode vectors.

    Returns
    -------
    basis : ndarray, shape=(3n, 6)
        Orthonormal columns spanning translations + rotations.
    """
    coord = jnp.asarray(coord)
    n = coord.shape[0]
    centered = coord - coord.mean(axis=0)
    x, y, z = centered[:, 0], centered[:, 1], centered[:, 2]
    zero = jnp.zeros(n, dtype=coord.dtype)
    one = jnp.ones(n, dtype=coord.dtype)

    # Columns of (3, n) per mode: translations then rotations r x e_a
    modes = jnp.stack(
        [
            jnp.stack([one, zero, zero]),    # Tx
            jnp.stack([zero, one, zero]),    # Ty
            jnp.stack([zero, zero, one]),    # Tz
            jnp.stack([zero, -z, y]),        # Rx
            jnp.stack([z, zero, -x]),        # Ry
            jnp.stack([-y, x, zero]),        # Rz
        ],
        axis=-1,
    )  # (3, n, 6)

    if masses is not None:
        modes = modes * jnp.sqrt(jnp.asarray(masses))[None, :, None]

    if layout == "xyz":
        flat = modes.reshape(3 * n, 6)
    else:
        flat = modes.transpose(1, 0, 2).reshape(3 * n, 6)
    q, _ = jnp.linalg.qr(flat)
    return q


def null_mode_gnm(n, masses=None, dtype=jnp.float32):
    """
    Orthonormal null vector of a (connected) GNM Kirchhoff matrix:
    the constant vector, mass-scaled when the matrix is mass-weighted.
    """
    v = jnp.ones((n, 1), dtype=dtype)
    if masses is not None:
        v = v * jnp.sqrt(jnp.asarray(masses, dtype=dtype))[:, None]
    return v / jnp.linalg.norm(v)


def _regularize_equilibrated(matrix, t, sigma, pad_to=None):
    """Null-space-regularized, Jacobi-equilibrated matrix in one
    bandwidth-lean pass:

        reg = S (M + sigma T T^t) S,   S = diag(reg_unscaled)^-1/2

    The equilibration diagonal is computed *analytically*
    (``diag(M) + sigma ||t_row||^2``) instead of from a materialized
    ``T @ T^t``, and ``sqrt(sigma) S`` folds into T's rows before the
    matmul — so the only O(m^2) traffic is one read of `matrix` and one
    write of the result (the naive form costs two extra full passes plus
    a materialized ``(m, m)`` ``T T^t``).

    Returns ``(reg, scale, sigma)`` with ``scale`` shaped ``(..., m)``
    and ``sigma`` shaped ``(..., 1, 1)``.

    ``pad_to``: emit ``reg`` identity-padded to ``(pad_to, pad_to)``
    (exact: the padding block decouples) in the SAME fused pass — the
    pad/iota-mask fuses into the matmul epilogue, where a separate
    ``jnp.pad`` + ``.at[diag].set`` inside the factor costs an extra
    O(m^2) read+write.
    ``scale`` is returned UNPADDED either way.
    """
    m = matrix.shape[-1]
    diag_m = jnp.diagonal(matrix, axis1=-2, axis2=-1)
    if sigma is None:
        sigma = jnp.mean(diag_m, axis=-1)[..., None, None]
    else:
        sigma = jnp.asarray(sigma, dtype=matrix.dtype)
        sigma = sigma[..., None, None] if sigma.ndim else sigma[None, None]
    tn2 = jnp.sum(t * t, axis=-1)
    scale = jax.lax.rsqrt(diag_m + sigma[..., 0] * tn2)
    ts = t * (scale * jnp.sqrt(sigma[..., 0]))[..., None]
    if pad_to is not None and pad_to != m:
        pad = pad_to - m
        nb = matrix.ndim - 2
        matrix = jnp.pad(matrix, ((0, 0),) * nb + ((0, pad), (0, pad)))
        sc_p = jnp.pad(scale, ((0, 0),) * nb + ((0, pad),),
                       constant_values=1.0)
        ts = jnp.pad(ts, ((0, 0),) * nb + ((0, pad), (0, 0)))
        idx = jnp.arange(pad_to)
        eye_pad = ((idx[:, None] == idx[None, :])
                   & (idx[:, None] >= m)).astype(matrix.dtype)
        reg = (matrix * sc_p[..., :, None] * sc_p[..., None, :]
               + jnp.matmul(ts, jnp.swapaxes(ts, -1, -2),
                            precision='highest') + eye_pad)
    else:
        reg = (matrix * scale[..., :, None] * scale[..., None, :]
               + jnp.matmul(ts, jnp.swapaxes(ts, -1, -2),
                            precision='highest'))
    return reg, scale, sigma


def covariance_cholesky(matrix, null_basis, sigma=None, block_size=None,
                        inverse="cho_solve"):
    """
    Pseudo-inverse of a PSD interaction matrix with known (orthonormal)
    null basis via a regularized Cholesky solve.

    Supports leading batch dimensions on `matrix` (and on `null_basis`,
    e.g. per-conformer rigid bases over an ensemble).

    Parameters
    ----------
    matrix : ndarray, shape=(..., m, m)
        Hessian/Kirchhoff matrix (PSD, null space spanned by
        `null_basis`).
    null_basis : ndarray, shape=(..., m, k)
        Orthonormal null-space basis (6 rigid modes for ANM, 1 constant
        mode for GNM); leading dims broadcast against `matrix`'s.
    sigma : float, optional
        Regularization weight placed on the null space; defaults to the
        mean diagonal of `matrix` (a well-conditioned choice).
    block_size : int, optional
        Solve the identity right-hand side in column blocks of this
        size (unbatched input only) — bounds peak memory to
        ``O(m^2 + m * block_size)`` for mega-assemblies instead of
        holding a full dense identity.
    inverse : {"cho_solve", "blocked"}
        Inverse engine: XLA Cholesky + ``cho_solve``, or the recursive
        blocked inverse factor (:func:`ops.pallas_linalg.
        spd_inverse_factor`) for *batched* ensemble covariance.

    Returns
    -------
    covariance : ndarray, shape=(..., m, m)
    """
    matrix = jnp.asarray(matrix)
    t = jnp.asarray(null_basis, dtype=matrix.dtype)
    m = matrix.shape[-1]
    if inverse == "blocked":
        if block_size is not None:
            raise ValueError(
                "block_size (column-blocked identity solves, the "
                "memory-lean cho_solve path) is incompatible with "
                "inverse='blocked', which materializes dense (m, m) "
                "factor/inverse temporaries")
        from . import pallas_linalg

        reg, scale, sigma = _regularize_equilibrated(
            matrix, t, sigma, pad_to=pallas_linalg.padded_size(m))
    else:
        reg, scale, sigma = _regularize_equilibrated(matrix, t, sigma)
    if inverse == "blocked":
        # Fold the equilibration un-scaling into the inverse Gram
        # factor's columns (see _w_from_reg_blocked) — saves full
        # elementwise passes over the (m, m) inverse.
        w = _w_from_reg_blocked(reg, scale, m)
        inv = _gram_lower(w)[..., :m, :m]
        return inv - jnp.matmul(t, jnp.swapaxes(t, -1, -2),
                                precision='highest') / sigma
    elif inverse != "cho_solve":
        raise ValueError(f"unknown inverse engine {inverse!r}")
    chol = jnp.linalg.cholesky(reg)
    if block_size is None or matrix.ndim > 2:
        eye = jnp.broadcast_to(jnp.eye(m, dtype=matrix.dtype),
                               matrix.shape)
        inv = jsl.cho_solve((chol, True), eye)
    else:
        import jax

        if m % block_size != 0:
            raise ValueError(
                f"block_size={block_size} must divide m={m}"
            )
        col_ids = jnp.arange(m)

        def solve_block(start):
            rhs = (col_ids[:, None]
                   == (start + jnp.arange(block_size))[None, :]
                   ).astype(matrix.dtype)
            return jsl.cho_solve((chol, True), rhs)

        blocks = jax.lax.map(
            solve_block, jnp.arange(0, m, block_size)
        )  # (m // B, m, B): block b holds inverse columns [bB, (b+1)B)
        inv = jnp.concatenate(list(blocks), axis=1)
    inv = inv * scale[..., :, None] * scale[..., None, :]
    return inv - jnp.matmul(t, jnp.swapaxes(t, -1, -2),
                            precision='highest') / sigma


def covariance_plane_traces(matrix, null_basis, sigma=None,
                            inverse="cho_solve"):
    """
    Sum of the diagonal component-plane blocks of the pseudo-inverse of
    an xyz-layout ANM Hessian:
    ``traces[i, j] = sum_a pinv(H)[a*n + i, a*n + j]`` — the 3x3
    superelement traces of the covariance, which is everything the
    fluctuation observables consume (MSF = its diagonal, B-factors,
    normalized DCC; reference ``nma.py:326-336`` computes the same
    traces *from* the full covariance).

    Skipping the full covariance changes the dominant cost: the Gram
    contraction shrinks from ``(m, m) x (m, m)`` (``2 m^3`` flops) to a
    single ``(n, 3m) x (3m, n)`` product (``2 m^3 / 9``), roughly
    halving the whole fluctuation pipeline.  Use
    :func:`covariance_cholesky` when the covariance itself is needed
    (PRS, linear response, covariance export).

    Parameters
    ----------
    matrix : ndarray, shape=(..., 3n, 3n)
        ANM Hessian in xyz layout (PSD, null space = `null_basis`).
    null_basis : ndarray, shape=(..., 3n, k)
        Orthonormal null basis (the six rigid modes), xyz layout.
    sigma : float, optional
        Null-space regularization weight (default: mean diagonal).
    inverse : {"cho_solve", "blocked"}
        ``"blocked"`` routes through the recursive blocked inverse
        factor; ``"cho_solve"`` uses XLA Cholesky + a triangular solve.

    Returns
    -------
    traces : ndarray, shape=(..., n, n)
    """
    matrix = jnp.asarray(matrix)
    m = matrix.shape[-1]
    if m % 3:
        raise ValueError(
            f"xyz-layout ANM matrix dimension must be divisible by 3, "
            f"got {m}")
    n = m // 3
    t = jnp.asarray(null_basis, dtype=matrix.dtype)

    # W with pinv(reg_unscaled) = W^T W: fold the equilibration
    # un-scaling into W's columns (S G^T G S = (G S)^T (G S)).
    if inverse == "blocked":
        from . import pallas_linalg

        # reg comes back already identity-padded to the recursion's
        # size — the pad fuses into the prep pass (see
        # _regularize_equilibrated) instead of costing the factor a
        # separate O(m^2) pad program.
        reg, scale, sigma = _regularize_equilibrated(
            matrix, t, sigma, pad_to=pallas_linalg.padded_size(m))
        parts = _w_parts_from_reg_blocked(reg, scale, m)
        return _plane_traces_from_w_parts(parts, t, sigma, n)
    elif inverse == "cho_solve":
        reg, scale, sigma = _regularize_equilibrated(matrix, t, sigma)
        chol = jnp.linalg.cholesky(reg)
        eye = jnp.broadcast_to(jnp.eye(m, dtype=matrix.dtype),
                               matrix.shape)
        w = jsl.solve_triangular(chol, eye, lower=True)
        w = w * scale[..., None, :]
    else:
        raise ValueError(f"unknown inverse engine {inverse!r}")
    return _plane_traces_from_w(w, t, sigma, n)


def _w_from_reg_blocked(reg, scale, m):
    """Unscaled inverse factor ``W`` (with ``pinv(reg_unscaled) =
    W^T W``) from the identity-padded regularized matrix: the blocked
    inverse factor with the equilibration un-scaling folded into its
    columns (``S G^T G S = (G S)^T (G S)``)."""
    from . import pallas_linalg

    g = pallas_linalg.spd_inverse_factor(reg)
    mp = g.shape[-1]
    if mp != m:
        scale_p = jnp.zeros(scale.shape[:-1] + (mp,), scale.dtype)
        scale_p = scale_p.at[..., :m].set(scale)
    else:
        scale_p = scale
    # Padding rows of G carry zeros in the first m columns (the
    # identity-padded factorization decouples), so contracting over
    # the full padded row range downstream stays exact.
    return g * scale_p[..., None, :]


def _w_parts_from_reg_blocked(reg, scale, m):
    """Top-split form of :func:`_w_from_reg_blocked`: the factor's
    top-level blocks ``(w11, w21, w22)`` (``W = [[w11, 0], [w21,
    w22]]``, column-scaled; ``w21 is None`` for single-leaf sizes) —
    feeding the plane-trace Grams blockwise skips the factor's final
    materializing concat."""
    from . import pallas_linalg

    g11, g21, g22 = pallas_linalg.spd_inverse_factor_parts(reg)
    h = g11.shape[-1]
    mp = h if g21 is None else h + g22.shape[-1]
    if mp != m:
        scale_p = jnp.zeros(scale.shape[:-1] + (mp,), scale.dtype)
        scale_p = scale_p.at[..., :m].set(scale)
    else:
        scale_p = scale
    # Padding rows carry zeros in the first m columns (the
    # identity-padded factorization decouples) — contracting over the
    # full padded row range downstream stays exact.
    if g21 is None:
        return g11 * scale_p[..., None, :], None, None
    return (g11 * scale_p[..., None, :h],
            g21 * scale_p[..., None, :h],
            g22 * scale_p[..., None, h:])


def _plane_traces_from_w_parts(parts, t, sigma, n):
    """:func:`_plane_traces_from_w` on the factor's top-level blocks:
    each plane Gram splits over the row blocks — ``G_a = top_a^T top_a
    + bot_a^T bot_a`` with ``top = [w11 | 0]`` and ``bot = [w21 |
    w22]`` — so the dense ``W`` never materializes.  The top term only
    exists where both plane columns fall left of the split (columns
    ``>= h`` are exactly zero in the top rows), and keeps the
    lower-triangular row-range skipping; the bottom term stitches its
    plane column slice from ``w21``/``w22`` (a ``(mp - h, <=n)``
    concat — two orders smaller than the factor concat it replaces)."""
    w11, w21, w22 = parts
    if w21 is None:
        return _plane_traces_from_w(w11, t, sigma, n)
    h = w11.shape[-1]
    traces = None
    for a in range(3):
        c0, c1 = a * n, (a + 1) * n
        ga = None
        if c0 < h:
            t1 = min(c1, h)
            # rows k < c0 of these columns are exactly zero (column-
            # scaled lower-triangular factor) — contract from the
            # 128-aligned floor down, as the dense path does
            k0 = c0 // 128 * 128
            wa = w11[..., k0:, c0:t1]
            g_top = jnp.einsum("...kn,...km->...nm", wa, wa,
                               precision='highest')
            nb = wa.ndim - 2
            ga = jnp.pad(g_top, ((0, 0),) * nb
                         + ((0, c1 - t1), (0, c1 - t1)))
        cols = []
        if c0 < h:
            cols.append(w21[..., :, c0:min(c1, h)])
        if c1 > h:
            cols.append(w22[..., :, max(c0, h) - h:c1 - h])
        wb = cols[0] if len(cols) == 1 else jnp.concatenate(cols,
                                                            axis=-1)
        g_bot = jnp.einsum("...kn,...km->...nm", wb, wb,
                           precision='highest')
        ga = g_bot if ga is None else ga + g_bot
        traces = ga if traces is None else traces + ga
    tp = t.reshape(t.shape[:-2] + (3, n, t.shape[-1]))
    corr = jnp.einsum("...anp,...amp->...nm", tp, tp,
                      precision='highest')
    return traces - corr / sigma


def _gram_lower(w):
    """``W^T W`` for a column-scaled lower-triangular ``W``, skipping
    the exact-zero upper region: rows are split at a 128-aligned
    midpoint ``h`` — the top block's columns ``>= h`` are zero, so its
    Gram fills only the leading ``(h, h)`` output block.  Bit-identical
    to the single contraction (only exact-zero terms are dropped) at
    ~62% of its flops; the zero-padded top Gram fuses into the add."""
    mp = w.shape[-2]
    h = (mp // 2) // 128 * 128
    if h < 128:
        return jnp.einsum("...ki,...kj->...ij", w, w,
                          precision='highest')
    top = w[..., :h, :h]
    g_top = jnp.einsum("...ki,...kj->...ij", top, top,
                       precision='highest')
    g_bot = jnp.einsum("...ki,...kj->...ij", w[..., h:, :],
                       w[..., h:, :], precision='highest')
    nb = w.ndim - 2
    return g_bot + jnp.pad(g_top,
                           ((0, 0),) * nb + ((0, mp - h), (0, mp - h)))


def _plane_traces_from_w(w, t, sigma, n):
    # traces = sum_a (W_a)^T W_a, one sliced Gram per plane.  W is the
    # column-scaled lower-triangular inverse factor,
    # so rows k < a*n of plane slice a are EXACTLY zero — each Gram
    # contracts only rows from the 128-aligned floor of a*n down
    # (bit-identical: the skipped terms are exact zeros; skips ~25% of
    # the contraction flops at (mp=1024, n=300)).
    traces = None
    for a in range(3):
        k0 = (a * n) // 128 * 128
        wa = w[..., k0:, a * n:(a + 1) * n]
        ga = jnp.einsum("...kn,...km->...nm", wa, wa,
                        precision='highest')
        traces = ga if traces is None else traces + ga
    # Null-space correction, plane-traced: sum_a T_a T_a^T / sigma
    tp = t.reshape(t.shape[:-2] + (3, n, t.shape[-1]))
    corr = jnp.einsum("...anp,...amp->...nm", tp, tp,
                      precision='highest')
    return traces - corr / sigma


def pinv_diagonal(matrix, null_basis, sigma=None, block_size=1024,
                  donate=False):
    """
    Diagonal of the pseudo-inverse of a PSD matrix with known null
    basis, without materializing the inverse — the memory-lean path for
    mega-assembly MSF/B-factor profiles (for an xyz-layout ANM Hessian,
    ``msf_i = sum_a diag[a * n + i]``).

    Peak memory is ``O(m^2)`` for the Cholesky factor plus
    ``O(m * block_size)`` per solve block (vs ``O(m^2)`` x several for
    the full covariance).

    With ``donate=True`` the device buffer of `matrix` is donated
    (consumed) to stay within memory at mega-assembly sizes — the input
    array is invalidated and must not be reused afterwards.
    """
    matrix = jnp.asarray(matrix)
    if matrix.ndim != 2:
        raise ValueError("pinv_diagonal expects an unbatched matrix")
    t = jnp.asarray(null_basis, dtype=matrix.dtype)
    m = matrix.shape[-1]
    if m % block_size != 0:
        raise ValueError(f"block_size={block_size} must divide m={m}")

    if sigma is None:
        sigma = jnp.mean(jnp.diagonal(matrix))
    sigma = jnp.asarray(sigma, matrix.dtype)

    # Staged module-level jits (stable cache across calls — per-call jit
    # wrappers would recompile the O(m^2) programs every invocation)
    # with donated buffers so at most two m x m arrays are ever live:
    # matrix -> regularized -> Cholesky factor.
    regularize = _regularize_donated if donate else _regularize_plain
    reg, scale = regularize(matrix, t, sigma)
    del matrix
    chol = _chol_donated(reg)
    del reg
    return _diag_from_chol(chol, t, sigma, scale, block_size)


def _regularize_impl(mat, t, sigma):
    # Jacobi equilibration (see _regularize_equilibrated: analytic
    # diagonal + scale folded into T's rows — one read/one write of the
    # O(m^2) buffer instead of three passes plus a dense T T^t)
    reg, scale, _ = _regularize_equilibrated(mat, t, sigma)
    return reg, scale


def _make_staged_jits():
    import jax

    regularize_donated = jax.jit(_regularize_impl, donate_argnums=(0,))
    regularize_plain = jax.jit(_regularize_impl)
    chol_donated = jax.jit(jnp.linalg.cholesky, donate_argnums=(0,))

    @functools.partial(jax.jit, static_argnames=("block",))
    def diag_from_chol(chol, t, sigma, scale, block):
        m = chol.shape[0]
        col_ids = jnp.arange(m)

        def block_diag(start):
            rhs = (col_ids[:, None]
                   == (start + jnp.arange(block))[None, :]
                   ).astype(chol.dtype)
            sol = jsl.cho_solve((chol, True), rhs)  # (m, B)
            rows = jax.lax.dynamic_slice_in_dim(sol, start, block, axis=0)
            return jnp.diagonal(rows)

        diag = jax.lax.map(block_diag, jnp.arange(0, m, block)).reshape(m)
        return diag * scale * scale - jnp.sum(t * t, axis=1) / sigma

    return regularize_donated, regularize_plain, chol_donated, \
        diag_from_chol


(_regularize_donated, _regularize_plain, _chol_donated,
 _diag_from_chol) = _make_staged_jits()
