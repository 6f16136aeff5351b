"""
Partial-spectrum solvers: lowest non-trivial normal modes without a full
eigendecomposition.

The reference always runs a dense ``eigh`` (O(n^3), full spectrum) even
when only the handful of low-frequency functional modes is wanted
(reference ``nma.py:61``).  For mega-assemblies (10k+ residues) the
scientifically relevant output is exactly those lowest modes, so this
module provides an iterative LOBPCG path:

1. the known rigid-body null space is *deflated* by shifting it to high
   eigenvalues (``H + sigma T T^t``),
2. the spectrum is reflected (``c I - H``) so the smallest eigenvalues
   become the largest,
3. ``jax.experimental.sparse.linalg.lobpcg_standard`` extracts the top
   block — all matvecs are dense matmuls.

Cost: O(iters * k * n^2) instead of O(n^3) — for ``k << n`` this is the
difference between seconds and minutes at n = 30k.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental.sparse.linalg import lobpcg_standard

from . import rigid
from ..utils import config

__all__ = [
    "lowest_modes",
    "lowest_modes_anm",
    "lowest_modes_shift_invert",
    "lowest_modes_shift_invert_staged",
    "shift_invert_from_chol",
    "modes_from_covariance",
    "mode_residuals",
    "refine_modes_f64",
    "refine_modes_f64_gnm",
]


def lowest_modes(matrix, k, null_basis=None, n_iter=200, seed=0):
    """
    The `k` smallest non-trivial eigenpairs of a PSD interaction matrix.

    Parameters
    ----------
    matrix : ndarray, shape=(m, m)
        Hessian or Kirchhoff matrix.
    k : int
        Number of non-trivial modes to compute.
    null_basis : ndarray, shape=(m, t), optional
        Orthonormal basis of the known null space (rigid-body modes);
        deflated out of the search space.
    n_iter : int
        LOBPCG iteration count.  Convergence is not guaranteed for
        large ill-conditioned systems — **always** check residuals with
        :func:`mode_residuals` (the solver's internal stopping test is
        disabled here because the spectrum reflection makes it
        trivially true); prefer :func:`lowest_modes_shift_invert` at
        mega-assembly scale.

    Returns
    -------
    eig_values : ndarray, shape=(k,)
        Smallest non-trivial eigenvalues, ascending.
    eig_vectors : ndarray, shape=(k, m)
        Corresponding modes (rows).
    """
    matrix = jnp.asarray(matrix)
    m = matrix.shape[0]

    if 5 * k >= m:
        # LOBPCG needs search dim * 5 < matrix dim; small systems just
        # use the dense solver
        return _dense_lowest(matrix, k, null_basis)

    t = (jnp.asarray(null_basis, dtype=matrix.dtype)
         if null_basis is not None else None)
    return _lobpcg_smallest(matrix, t, k=k, n_iter=n_iter, seed=seed)


@functools.partial(jax.jit, static_argnames=("k", "n_iter", "seed"))
def _lobpcg_smallest(matrix, t, *, k, n_iter, seed):
    # Jitted with the matrix as an *argument* — a closure capture would
    # bake the O(m^2) matrix into the program as a constant.
    m = matrix.shape[0]

    # Gershgorin upper bound on the spectrum
    upper = jnp.max(jnp.sum(jnp.abs(matrix), axis=1))
    c = 2.0 * upper

    def reflected_matvec(x):
        # (c I - H - upper * T T^t) @ x without materializing any
        # additional (m, m) array — null space shifted to `upper` so it
        # cannot surface, spectrum reflected so the smallest eigenvalues
        # become the largest.
        y = c * x - jnp.matmul(matrix, x, precision='highest')
        if t is not None:
            y = y - upper * jnp.matmul(
                t, jnp.matmul(t.T, x, precision='highest'),
                precision='highest')
        return y

    # Deterministic start block (iteration-friendly, full rank)
    key = jnp.arange(m * k, dtype=matrix.dtype).reshape(m, k)
    x0 = jnp.cos(key * 0.7 + seed) + 1e-3
    if t is not None:
        x0 = x0 - jnp.matmul(
            t, jnp.matmul(t.T, x0, precision='highest'),
            precision='highest')
    x0, _ = jnp.linalg.qr(x0)

    # tol=0 forces the full iteration budget: the library's relative
    # residual test is evaluated against the *reflected* eigenvalues
    # (mu ~ c, enormous), so any nonzero tolerance reports convergence
    # immediately while the true pairs are still O(1) wrong.
    mu, vecs, _ = lobpcg_standard(reflected_matvec, x0, m=n_iter, tol=0.0)
    vals = c - mu
    order = jnp.argsort(vals)
    return vals[order], vecs[:, order].T


def lowest_modes_shift_invert(matrix, t, *, k, n_iter=24, oversample=None,
                              seed=0, engine="auto", **staged_options):
    """
    The `k` smallest non-null eigenpairs by Cholesky shift-invert
    subspace iteration.

    The regularized matrix ``H + sigma T T^t`` is factored once
    (Cholesky with Jacobi equilibration — the same kernel as the fast
    covariance path), then an oversampled block is driven through
    ``inv(reg)`` with the null space projected out each step; a final
    Rayleigh-Ritz on the *original* matrix yields the eigenpairs.

    Unlike the reflected-spectrum LOBPCG (:func:`lowest_modes`), whose
    internal relative-residual test is meaningless after the spectrum
    shift (``mu ~ c >> lambda`` makes every residual look converged —
    at 30k dims it exits immediately with O(1) relative residuals),
    this converges at the inverse-power rate ``(lambda_k /
    lambda_{k+q})^s`` and is residual-checkable on the true pairs.
    All heavy ops are matmuls / triangular solves.

    Parameters
    ----------
    matrix : ndarray, shape=(m, m)
        PSD interaction matrix.
    t : ndarray, shape=(m, n_null)
        Orthonormal null-space basis.
    k : int
        Number of modes.
    n_iter : int
        Inverse-iteration steps (each = one preconditioned solve + QR).
    oversample : int, optional
        Extra subspace vectors (default ``max(k, 8)``).
    engine : {"auto", "chol", "invfactor", "staged"}
        Preconditioner engine.  ``"chol"`` factors with XLA Cholesky
        and runs two sequential triangular solves per iteration.
        ``"invfactor"`` builds the explicit inverse Gram factor once
        (:func:`ops.pallas_linalg.spd_inverse_factor`) so every
        iteration's solve is two matmuls; the O(m^3) inverse
        construction overtakes the per-iteration savings at large
        ``m``.  ``"auto"`` takes :func:`springcraft_tpu.utils.config.
        shift_invert_engine` (by size and dtype).  ``"staged"`` runs the
        ``"chol"`` math as three SMALL device programs (factor /
        iterate / finish) with a host loop — see
        :func:`lowest_modes_shift_invert_staged` (extra keyword
        options such as ``checkpoint=`` / ``retries=`` pass through).

    Returns
    -------
    eig_values : ndarray, shape=(k,), ascending
    eig_vectors : ndarray, shape=(k, m), modes in rows
    """
    if engine == "staged":
        return lowest_modes_shift_invert_staged(
            matrix, t, k=k, n_iter=n_iter, oversample=oversample,
            seed=seed, **staged_options)
    if staged_options:
        raise TypeError(
            f"options {sorted(staged_options)} are only valid with "
            f"engine='staged'")
    return _lowest_modes_shift_invert_fused(
        matrix, t, k=k, n_iter=n_iter, oversample=oversample, seed=seed,
        engine=engine)


@functools.partial(jax.jit,
                   static_argnames=("k", "n_iter", "oversample", "seed",
                                    "engine"))
def _lowest_modes_shift_invert_fused(matrix, t, *, k, n_iter, oversample,
                                     seed, engine):
    """One fused device program (see the public dispatcher's docstring
    for the math); ``engine="staged"`` splits it into small per-stage
    programs with a host loop."""
    matrix = jnp.asarray(matrix)
    t = jnp.asarray(t, dtype=matrix.dtype)
    m = matrix.shape[0]

    sigma = jnp.mean(jnp.diagonal(matrix))
    reg = matrix + sigma * jnp.matmul(t, t.T, precision="highest")
    scale = 1.0 / jnp.sqrt(jnp.diagonal(reg))
    reg = reg * scale[:, None] * scale[None, :]
    if engine == "auto":
        engine = config.shift_invert_engine(m, matrix.dtype)
    if engine == "invfactor":
        from . import pallas_linalg

        g = pallas_linalg.spd_inverse_factor(reg[None])[0]
        mp = g.shape[-1]
        # Fold the equilibration un-scaling into the factor columns
        # (zero past m): inv(reg_unscaled) = W^T W with W = G S.
        scale_p = jnp.zeros((mp,), scale.dtype).at[:m].set(scale)
        w = g * scale_p[None, :]

        def inv_apply(x):
            xp = jnp.pad(x, ((0, mp - m), (0, 0)))
            y = jnp.matmul(w, xp, precision="highest")
            return jnp.matmul(w.T, y, precision="highest")[:m]

        return _shift_invert_iterate(matrix, inv_apply, t, k=k,
                                     n_iter=n_iter, oversample=oversample,
                                     seed=seed)
    elif engine != "chol":
        raise ValueError(f"unknown engine {engine!r}")
    chol = jnp.linalg.cholesky(reg)
    return shift_invert_from_chol(matrix, chol, scale, t, k=k,
                                  n_iter=n_iter, oversample=oversample,
                                  seed=seed)


def shift_invert_from_chol(matrix, chol, scale, t, *, k, n_iter=24,
                           oversample=None, seed=0):
    """
    Shift-invert subspace iteration reusing an existing regularized
    (equilibrated) Cholesky factor — lets one factorization serve both
    the covariance observables and mode extraction in fused pipelines.
    """
    import jax.scipy.linalg as jsl

    def inv_apply(x):
        y = jsl.cho_solve((chol, True), scale[:, None] * x)
        return scale[:, None] * y

    return _shift_invert_iterate(jnp.asarray(matrix), inv_apply, t, k=k,
                                 n_iter=n_iter, oversample=oversample,
                                 seed=seed)


def _shift_invert_iterate(matrix, inv_apply, t, *, k, n_iter, oversample,
                          seed):
    """Deflated subspace iteration through a preconditioned solve
    closure + final Rayleigh-Ritz on the original matrix."""
    m = matrix.shape[0]
    q = max(k, 8) if oversample is None else oversample
    p = k + q

    def deflate(x):
        return x - jnp.matmul(
            t, jnp.matmul(t.T, x, precision="highest"),
            precision="highest")

    key = jnp.arange(m * p, dtype=matrix.dtype).reshape(m, p)
    x = jnp.cos(key * 0.7 + seed) + 1e-3
    x, _ = jnp.linalg.qr(deflate(x))

    def step(_, x):
        y = deflate(inv_apply(x))
        x, _ = jnp.linalg.qr(y)
        return x

    x = jax.lax.fori_loop(0, n_iter, step, x)

    # Rayleigh-Ritz on the original matrix
    hx = jnp.matmul(matrix, x, precision="highest")
    s = jnp.matmul(x.T, hx, precision="highest")
    vals, w = jnp.linalg.eigh((s + s.T) / 2)
    vecs = jnp.matmul(x, w[:, :k], precision="highest")
    return vals[:k], vecs.T


# ---------------------------------------------------------------------------
# Staged shift-invert: small device programs + a resumable host loop
# ---------------------------------------------------------------------------

@jax.jit
def _si_factor_program(matrix, t):
    """Regularize + Jacobi-equilibrate + Cholesky (one program)."""
    sigma = jnp.mean(jnp.diagonal(matrix))
    reg = matrix + sigma * jnp.matmul(t, t.T, precision="highest")
    scale = 1.0 / jnp.sqrt(jnp.diagonal(reg))
    reg = reg * scale[:, None] * scale[None, :]
    return jnp.linalg.cholesky(reg), scale


@jax.jit
def _si_step_program(chol, scale, t, x):
    """One inverse-power step: solve, deflate, re-orthonormalize."""
    import jax.scipy.linalg as jsl

    y = jsl.cho_solve((chol, True), scale[:, None] * x)
    y = scale[:, None] * y
    y = y - jnp.matmul(t, jnp.matmul(t.T, y, precision="highest"),
                       precision="highest")
    q, _ = jnp.linalg.qr(y)
    return q


@functools.partial(jax.jit, static_argnames=("k",))
def _si_finish_program(matrix, x, *, k):
    """Rayleigh-Ritz on the original matrix."""
    hx = jnp.matmul(matrix, x, precision="highest")
    s = jnp.matmul(x.T, hx, precision="highest")
    vals, w = jnp.linalg.eigh((s + s.T) / 2)
    vecs = jnp.matmul(x, w[:, :k], precision="highest")
    return vals[:k], vecs.T


def lowest_modes_shift_invert_staged(matrix, t, *, k, n_iter=24,
                                     oversample=None, seed=0,
                                     checkpoint=None, retries=2,
                                     wait=5.0):
    """
    :func:`lowest_modes_shift_invert` (``engine="chol"`` math) split
    into three SMALL device programs — factor, per-iteration step,
    Rayleigh-Ritz finish — driven by a host loop.

    Trade-offs vs the fused single program at mega-assembly scale:

    * compile: three small programs instead of one large one;
    * run: ~``n_iter`` extra program dispatches;
    * resilience: each iteration is an
      :func:`utils.elastic.resumable_loop` unit — ``checkpoint=path``
      snapshots the subspace so a killed process resumes mid-solve
      (the same contract as ``matfree.lowest_modes_matfree``), and
      transient device faults retry per step instead of restarting the
      whole solve.

    Numerics: identical iteration to the fused ``engine="chol"`` path
    up to the start-block QR (computed on host here); both converge to
    the same eigenpairs and are residual-checked downstream.
    """
    import numpy as np

    from ..utils import elastic

    matrix = jnp.asarray(matrix)
    t = jnp.asarray(t, matrix.dtype)
    m = matrix.shape[0]
    q = max(k, 8) if oversample is None else oversample
    p = k + q

    chol, scale = elastic.retry_on_failure(
        _si_factor_program, matrix, t, retries=retries, wait=wait)

    # Deterministic start block (same formula as the fused path), QR'd
    # on host — cheap at (m, p) and keeps the step program the only
    # per-iteration compile.
    tn = np.asarray(t, np.float64)
    key = np.arange(m * p, dtype=np.float64).reshape(m, p)
    x0 = np.cos(key * 0.7 + seed) + 1e-3
    x0 -= tn @ (tn.T @ x0)
    x0, _ = np.linalg.qr(x0)
    dtype = np.dtype(matrix.dtype)

    def step(_, state):
        # no-op for the device array carried between steps; device_put
        # only on the first step and on checkpoint resume
        x = jnp.asarray(state["x"])
        return {"x": _si_step_program(chol, scale, t, x)}

    state, _ = elastic.resumable_loop(
        step, {"x": x0.astype(dtype)}, n_iter, checkpoint=checkpoint,
        retries=retries, wait=wait)
    return elastic.retry_on_failure(
        functools.partial(_si_finish_program, k=k), matrix,
        jnp.asarray(state["x"]), retries=retries, wait=wait)


def modes_from_covariance(cov, matrix, t, *, k, n_iter=16,
                          oversample=None, seed=0):
    """
    The `k` smallest non-null eigenpairs of `matrix`, extracted by
    subspace iteration on its (already-computed) pseudo-inverse
    covariance — the dominant eigenvectors of ``cov`` *are* the lowest
    non-trivial modes, so when a pipeline has the covariance in hand
    the modes cost only ``n_iter`` batched matmuls plus one final
    Rayleigh-Ritz on `matrix` (no extra factorization, no per-step QR:
    a single orthonormalization at the end suffices because power
    iterates stay in the leading invariant subspace).

    Parameters
    ----------
    cov : ndarray, shape=(m, m)
        Pseudo-inverse covariance of `matrix` (null space removed).
    matrix : ndarray, shape=(m, m)
    t : ndarray, shape=(m, n_null)
        Orthonormal null-space basis (deflation + exclusion from
        Rayleigh-Ritz).
    """
    cov = jnp.asarray(cov)
    matrix = jnp.asarray(matrix)
    m = cov.shape[0]
    q = max(k, 8) if oversample is None else oversample
    p = k + q

    def deflate(x):
        return x - jnp.matmul(
            t, jnp.matmul(t.T, x, precision="highest"),
            precision="highest")

    key = jnp.arange(m * p, dtype=cov.dtype).reshape(m, p)
    x = jnp.cos(key * 0.7 + seed) + 1e-3
    x, _ = jnp.linalg.qr(deflate(x))

    def step(i, x):
        y = deflate(jnp.matmul(cov, x, precision="highest"))
        # Renormalize columns (cheap) to avoid over/underflow; full QR
        # only every few steps to restore independence
        y = y / jnp.linalg.norm(y, axis=0, keepdims=True)
        return jax.lax.cond(
            (i % 4) == 3,
            lambda v: jnp.linalg.qr(v)[0],
            lambda v: v,
            y,
        )

    x = jax.lax.fori_loop(0, n_iter, step, x)
    x, _ = jnp.linalg.qr(x)

    hx = jnp.matmul(matrix, x, precision="highest")
    s = jnp.matmul(x.T, hx, precision="highest")
    vals, w = jnp.linalg.eigh((s + s.T) / 2)
    vecs = jnp.matmul(x, w[:, :k], precision="highest")
    return vals[:k], vecs.T


def mode_residuals(matrix, eig_values, eig_vectors):
    """
    Relative eigenpair residuals ``|H u - lambda u| / |lambda|`` —
    convergence check for :func:`lowest_modes` results.
    """
    matrix = jnp.asarray(matrix)
    u = jnp.asarray(eig_vectors).T  # (m, k)
    r = jnp.matmul(matrix, u, precision="highest") \
        - u * jnp.asarray(eig_values)[None, :]
    return jnp.linalg.norm(r, axis=0) / jnp.abs(jnp.asarray(eig_values))


def _dense_lowest(matrix, k, null_basis):
    n_null = 0 if null_basis is None else null_basis.shape[1]
    vals, vecs = jnp.linalg.eigh(matrix)
    sel = jnp.arange(n_null, n_null + k)
    return vals[sel], vecs[:, sel].T


def _rigid_basis_np(coord, masses=None):
    """Float64 NumPy rigid-body basis (atom-interleaved layout) — the
    host-side counterpart of :func:`rigid.rigid_modes_anm` for the f64
    refinement pass (JAX only produces f64 under x64)."""
    import numpy as np

    coord = np.asarray(coord, dtype=np.float64)
    n = coord.shape[0]
    centered = coord - coord.mean(axis=0)
    x, y, z = centered[:, 0], centered[:, 1], centered[:, 2]
    zero = np.zeros(n)
    one = np.ones(n)
    modes = np.stack(
        [
            np.stack([one, zero, zero]),
            np.stack([zero, one, zero]),
            np.stack([zero, zero, one]),
            np.stack([zero, -z, y]),
            np.stack([z, zero, -x]),
            np.stack([-y, x, zero]),
        ],
        axis=-1,
    )  # (3, n, 6)
    if masses is not None:
        modes = modes * np.sqrt(np.asarray(masses, np.float64))[None, :,
                                                                None]
    flat = modes.transpose(1, 0, 2).reshape(3 * n, 6)  # atom layout
    q, _ = np.linalg.qr(flat)
    return q


def refine_modes_f64(coord, params, eig_vectors, *, masses=None,
                     layout="xyz", block=256, augment=False,
                     method="auto"):
    """
    Float64 Rayleigh-Ritz refinement of approximate ANM modes.

    The mega-assembly solvers run in float32 on the device; their
    eigenvalues carry O(1e-3) relative error from the single-precision
    subspace.  This pass recovers float64-accurate eigenvalues
    *without* a resident f64 Hessian.  For force fields with a finite
    cutoff the operator is applied sparsely from a host pair list
    (:mod:`.pairs` — native C++ kernels, O(pairs * k) work: milliseconds
    at 30k dims and viable through the matrix-free regime); no-cutoff
    families stream dense f64 Hessian row panels
    (:func:`..assembly.hessian_rows`, O(k n^2)).  ``H V`` feeds a k-dim
    Rayleigh-Ritz problem ``(Q^T H Q) y = theta y`` on the
    f64-orthonormalized subspace, yielding refined eigenvalues, rotated
    eigenvectors, and true f64 residuals.

    Because the exact eigenvectors lie O(eps_f32) from the f32
    subspace, the Rayleigh-Ritz values land O(eps_f32^2) ~ 1e-7 off
    the true eigenvalues — past the 1e-6 rtol north-star clause
    (BASELINE.json) that raw f32 residuals cannot certify.

    Parameters
    ----------
    coord : ndarray, shape=(n, 3)
    params : FFParams
        Device force-field parameterization (analytic families and
        compact tables — the scalable representations).
    eig_vectors : ndarray, shape=(k, 3n)
        Approximate modes in rows (e.g. from
        :func:`lowest_modes_shift_invert`), any precision.
    masses : ndarray, shape=(n,), optional
        Mass weighting (``W H W``); the rigid null space is adjusted
        accordingly.
    layout : {"xyz", "atom"}
        Component layout of the input (and output) mode vectors.
    block : int
        Atom rows per streamed Hessian panel on the dense path (peak
        host memory ``~ 72 * block * n`` bytes); unused on the sparse
        path.
    method : {"auto", "sparse", "dense"}
        ``"sparse"`` applies the operator from a cell-list pair list
        (requires a finite cutoff); ``"dense"`` streams f64 row panels.
        ``"auto"`` picks sparse whenever the family has a cutoff.
    augment : bool
        Augment the Rayleigh-Ritz basis with the residual block
        ``H Q - Q (Q^T H Q)`` (one extra panel sweep, 2x cost).
        Rarely needed: the *last* input mode (subspace boundary) always
        converges slowest, and the effective fix is passing a few
        buffer modes beyond the ones you need and slicing — measured at
        n=1000 (sdENM), a 4-mode buffer takes the worst refined rtol
        from 1.4e-6 to 7e-10, while augmentation alone does not move it
        (the raw residual is dominated by high-frequency components,
        ``lambda_max/lambda_k ~ 3e3``).  :meth:`ANM.lowest_modes`
        with ``refine=True`` applies the buffer automatically.

    Returns
    -------
    eig_values : ndarray, shape=(k,), float64, ascending
    eig_vectors : ndarray, shape=(k, 3n), float64
        Refined modes in rows, same layout as the input.
    residuals : ndarray, shape=(k,), float64
        True relative residuals ``|H v - theta v| / theta``.
    """
    import numpy as np

    from . import assembly, pairs

    coord = np.asarray(coord, dtype=np.float64)
    n = coord.shape[0]
    m = 3 * n
    u = np.asarray(eig_vectors, dtype=np.float64).T  # (m, k)
    if u.shape[0] != m:
        raise ValueError(
            f"eig_vectors have dimension {u.shape[0]}, expected {m}")
    k = u.shape[1]

    if layout == "xyz":
        # xyz plane layout -> atom-interleaved
        perm = (np.arange(n)[:, None]
                + n * np.arange(3)[None, :]).reshape(-1)
        u = u[perm]
    elif layout != "atom":
        raise ValueError(f"Unknown layout '{layout}'")

    w3 = (np.repeat(1.0 / np.sqrt(np.asarray(masses, np.float64)), 3)
          if masses is not None else None)

    if method == "auto":
        method = "sparse" if params.has_cutoff else "dense"
    if method == "sparse":
        pi, pj, kvals = pairs.pair_list(coord, params)
        disp = coord[pi] - coord[pj]
        sq = np.sum(disp * disp, axis=1)
        g = kvals / np.where(sq == 0, 1.0, sq)

        def stream_apply(x):
            xw = (w3[:, None] * x) if w3 is not None else x
            hx = pairs.hessian_apply_pairs(
                coord, pi, pj, g, xw.reshape(n, 3, -1)).reshape(m, -1)
            return (w3[:, None] * hx) if w3 is not None else hx
    elif method == "dense":
        def stream_apply(x):
            hx = np.empty((m, x.shape[1]), dtype=np.float64)
            for rs in range(0, n, block):
                b = min(block, n - rs)
                panel = np.asarray(
                    assembly.hessian_rows(coord, params, rs, b, np,
                                          dtype=np.float64),
                    dtype=np.float64)
                if w3 is not None:
                    panel = (w3[3 * rs:3 * (rs + b), None] * panel
                             ) * w3[None, :]
                hx[3 * rs:3 * (rs + b)] = panel @ x
            return hx
    else:
        raise ValueError(f"Unknown method '{method}'")

    t = _rigid_basis_np(coord, masses=masses)
    theta, vecs, res = _rayleigh_ritz_f64(stream_apply, t, u,
                                          augment=augment)
    if layout == "xyz":
        vecs = vecs[np.argsort(perm)]
    return theta, vecs.T, res


def _rayleigh_ritz_f64(stream_apply, t, u, *, augment=False):
    """Shared f64 Rayleigh-Ritz core: orthonormalize `u` against the
    null basis `t`, project the operator, optionally augment with the
    residual block, and return (theta, vectors-as-columns, residuals)."""
    import numpy as np

    m, k = u.shape
    u = u - t @ (t.T @ u)
    q, _ = np.linalg.qr(u)
    hq = stream_apply(q)

    if augment and 2 * k + t.shape[1] < m:
        w = hq - q @ (q.T @ hq)          # residual block, already _|_ q
        w = w - t @ (t.T @ w)
        q2, _ = np.linalg.qr(w)
        basis = np.concatenate([q, q2], axis=1)
        hb = np.concatenate([hq, stream_apply(q2)], axis=1)
    else:
        basis, hb = q, hq

    s = basis.T @ hb
    theta_all, y = np.linalg.eigh((s + s.T) / 2)
    theta = theta_all[:k]
    vecs = basis @ y[:, :k]
    r = hb @ y[:, :k] - vecs * theta[None, :]
    res = np.linalg.norm(r, axis=0) / np.abs(theta)
    return theta, vecs, res


def refine_modes_f64_gnm(coord, params, eig_vectors, *, masses=None,
                         block=2048, augment=False, method="auto"):
    """
    Float64 Rayleigh-Ritz refinement of approximate GNM modes — the
    Kirchhoff counterpart of :func:`refine_modes_f64`: the ``(n, n)``
    Kirchhoff operator is applied in f64 on host (sparse pair list for
    cutoff families via :mod:`.pairs`, streamed dense row panels via
    :func:`..assembly.kirchhoff_rows` otherwise), the null space (the
    constant mode; ``sqrt(m)``-scaled under mass weighting) is
    deflated, and a k-dim Rayleigh-Ritz projection returns refined
    eigenvalues with true f64 residuals.  Pass a few buffer modes
    beyond the ones you report (see ``augment`` notes on
    :func:`refine_modes_f64`).

    Returns ``(eig_values (k,), eig_vectors (k, n), residuals (k,))``,
    all float64.
    """
    import numpy as np

    from . import assembly, pairs

    coord = np.asarray(coord, dtype=np.float64)
    n = coord.shape[0]
    u = np.asarray(eig_vectors, dtype=np.float64).T  # (n, k)
    if u.shape[0] != n:
        raise ValueError(
            f"eig_vectors have dimension {u.shape[0]}, expected {n}")

    w = (1.0 / np.sqrt(np.asarray(masses, np.float64))
         if masses is not None else None)

    if method == "auto":
        method = "sparse" if params.has_cutoff else "dense"
    if method == "sparse":
        pi, pj, kvals = pairs.pair_list(coord, params)

        def stream_apply(x):
            xw = (w[:, None] * x) if w is not None else x
            kx = pairs.kirchhoff_apply_pairs(pi, pj, kvals, n, xw)
            return (w[:, None] * kx) if w is not None else kx
    elif method == "dense":
        def stream_apply(x):
            kx = np.empty((n, x.shape[1]), dtype=np.float64)
            for rs in range(0, n, block):
                b = min(block, n - rs)
                panel = np.asarray(
                    assembly.kirchhoff_rows(coord, params, rs, b, np,
                                            dtype=np.float64),
                    dtype=np.float64)
                if w is not None:
                    panel = (w[rs:rs + b, None] * panel) * w[None, :]
                kx[rs:rs + b] = panel @ x
            return kx
    else:
        raise ValueError(f"Unknown method '{method}'")

    null = (np.sqrt(np.asarray(masses, np.float64))
            if masses is not None else np.ones(n))
    t = (null / np.linalg.norm(null))[:, None]
    theta, vecs, res = _rayleigh_ritz_f64(stream_apply, t, u,
                                          augment=augment)
    return theta, vecs.T, res


def lowest_modes_anm(hessian_xyz, coord, k, masses=None, n_iter=24,
                     method="shift_invert", engine="auto",
                     **solver_options):
    """
    The `k` lowest non-trivial ANM modes of an xyz-layout Hessian, with
    the six rigid-body modes deflated analytically.

    `method` is ``"shift_invert"`` (default — Cholesky-preconditioned
    subspace iteration, reliable at mega-assembly scale; `n_iter` ~ 24)
    or ``"lobpcg"`` (the reflected-spectrum LOBPCG; only trustworthy
    with a residual check, `n_iter` ~ 200).  `engine` selects the
    shift-invert solve engine (see
    :func:`lowest_modes_shift_invert`).
    """
    basis = rigid.rigid_modes_anm(coord, masses=masses, layout="xyz")
    if method == "shift_invert":
        matrix = jnp.asarray(hessian_xyz)
        if 2 * max(k, 8) + 2 * k >= matrix.shape[0]:
            return _dense_lowest(matrix, k, basis)
        return lowest_modes_shift_invert(
            matrix, jnp.asarray(basis, matrix.dtype), k=k, n_iter=n_iter,
            engine=engine, **solver_options
        )
    if solver_options:
        raise TypeError(f"options {sorted(solver_options)} are only "
                        f"valid with method='shift_invert'")
    return lowest_modes(hessian_xyz, k, null_basis=basis, n_iter=n_iter)
