"""
Fused, jit-compiled NMA pipelines.

These are the device throughput paths: one traced function goes from
coordinates to observables (assembly -> eigh -> MSF/B-factors/
frequencies/DCC) with static shapes throughout, so XLA fuses the
elementwise work into the assembly and the whole pipeline is
``vmap``-able over conformer ensembles and shardable over device meshes.

Unlike the user-facing model classes (which mirror the reference's lazy
OO API), everything here is purely functional: force fields enter as
:class:`FFParams` pytrees, observables leave as a flat dict of arrays.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..ops import assembly, nma_core, rigid
from ..utils import config

__all__ = [
    "anm_observables",
    "anm_spectral",
    "gnm_spectral",
    "gnm_observables",
    "anm_fluctuations",
    "gnm_fluctuations",
    "ensemble_anm",
    "ensemble_anm_spectral",
    "ensemble_gnm_spectral",
    "ensemble_gnm",
    "ensemble_anm_fluctuations",
    "ensemble_gnm_fluctuations",
]


def _mass_weight(matrix, masses, repeat3):
    if masses is None:
        return matrix
    w = 1.0 / jnp.sqrt(masses)
    if repeat3:
        w = jnp.repeat(w, 3)
    return matrix * jnp.outer(w, w)


def _build_hessian_xyz(coord, params, dtype):
    """Dense (3n, 3n) xyz-layout Hessian (XLA fuses the pairwise pass
    and the row sums)."""
    return assembly.hessian_matrix(coord, params, jnp, dtype=dtype,
                                   layout="xyz")


@functools.partial(
    jax.jit,
    static_argnames=("with_dcc", "with_covariance", "n_modes", "dtype"),
)
def anm_observables(coord, params, masses=None, *, with_dcc=False,
                    with_covariance=False, n_modes=None, dtype=jnp.float32,
                    tem=None, tem_factors=nma_core.K_B):
    """
    Full ANM NMA for one structure: Hessian (xyz plane layout), batched
    eigensolve, and the standard observables with the six trivial modes
    excluded.

    Parameters
    ----------
    coord : ndarray, shape=(n, 3)
    params : FFParams
    masses : ndarray, shape=(n,), optional
        Mass-weights the Hessian like the reference (``anm.py:89-96``).
    with_dcc : bool
        Also return the normalized ``(n, n)`` DCC matrix.
    with_covariance : bool
        Also return the pseudo-inverse covariance (xyz layout).
    n_modes : int, optional
        If given, restrict observables to the `n_modes` lowest
        non-trivial modes.

    Returns
    -------
    dict with ``eig_values``, ``eig_vectors`` (modes in rows, xyz
    layout), ``frequencies``, ``msf``, ``bfactor`` and optionally
    ``dcc`` / ``covariance``.
    """
    coord = jnp.asarray(coord, dtype=dtype)
    n = coord.shape[0]
    hessian = _build_hessian_xyz(coord, params, dtype)
    if masses is not None:
        hessian = _mass_weight_xyz(hessian, masses)

    vals, vecs = jnp.linalg.eigh(hessian)
    vecs = vecs.T  # modes in rows
    return _anm_observables_from_eigensystem(
        vals, vecs, n, with_dcc=with_dcc,
        with_covariance=with_covariance, n_modes=n_modes, tem=tem,
        tem_factors=tem_factors)


def _anm_observables_from_eigensystem(vals, vecs, n, *, with_dcc,
                                      with_covariance, n_modes, tem,
                                      tem_factors):
    n_trivial = 6
    if n_modes is not None and not (
        0 < n_modes <= 3 * n - n_trivial
    ):
        raise ValueError(
            f"n_modes={n_modes} must be in [1, {3 * n - n_trivial}]"
        )
    stop = 3 * n if n_modes is None else n_trivial + n_modes
    mode_indices = jnp.arange(n_trivial, stop)

    out = {
        "eig_values": vals,
        "eig_vectors": vecs,
        "frequencies": nma_core.frequencies_from_eigenvalues(
            vals, n_trivial, jnp
        ),
        "msf": nma_core.mean_square_fluctuation(
            vals, vecs, mode_indices, jnp, num_dim=3, layout="xyz",
            tem=tem, tem_factors=tem_factors,
        ),
    }
    out["bfactor"] = nma_core.bfactor_from_msf(out["msf"])

    if with_dcc:
        dcc = nma_core.dcc_from_modes(vals, vecs, mode_indices, jnp,
                                      num_dim=3, layout="xyz")
        out["dcc"] = nma_core.normalize_dcc(dcc, jnp)
    if with_covariance:
        inv_vals = jnp.zeros_like(vals).at[mode_indices].set(
            1.0 / vals[mode_indices]
        )
        out["covariance"] = jnp.einsum(
            "ki,k,kj->ij", vecs, inv_vals, vecs, precision="highest"
        )
    return out


@functools.partial(
    jax.jit,
    static_argnames=("with_dcc", "with_covariance", "n_modes", "dtype",
                     "bandwidth", "n_iter_bisect"),
)
def ensemble_anm_banded(coords, params, masses=None, *, with_dcc=False,
                        with_covariance=False, n_modes=None,
                        dtype=jnp.float32, bandwidth=8, n_iter_bisect=40,
                        tem=None, tem_factors=nma_core.K_B):
    """
    Ensemble ANM with the **full eigensystem from the two-stage banded
    solver** (``ops.spectrum.eigh_banded`` — no O(n^3) dense eigh):
    Hessians assembled per conformer
    via vmap, one natively batched two-stage eigensolve (batch x shifts
    vectorized inside the solver — do NOT vmap it), observables via
    vmap.

    Same outputs as :func:`ensemble_anm`; f32 accuracy is
    iterative-solver level (~1e-5 relative residuals after the built-in
    polish + windowed Rayleigh-Ritz refinement).
    """
    from ..ops import spectrum

    params = _resolve_params(params)
    coords = jnp.asarray(coords, dtype=dtype)
    n = coords.shape[-2]

    hessians = _build_hessians_batched(coords, params, masses, dtype)
    vals, vecs = spectrum.eigh_banded(hessians, bandwidth=bandwidth,
                                      n_iter=n_iter_bisect)
    return jax.vmap(
        lambda v, u: _anm_observables_from_eigensystem(
            v, u, n, with_dcc=with_dcc, with_covariance=with_covariance,
            n_modes=n_modes, tem=tem, tem_factors=tem_factors)
    )(vals, vecs)


def _mass_weight_xyz(hessian, masses):
    """Mass weighting in xyz plane layout: the weight vector is tiled
    (not repeated) over the three component blocks."""
    w = 1.0 / jnp.sqrt(masses)
    w3 = jnp.tile(w, 3)
    return hessian * jnp.outer(w3, w3)


def _build_kirchhoff(coord, params, dtype):
    return assembly.kirchhoff_matrix(coord, params, jnp, dtype=dtype)


def _build_hessians_batched(coords, params, masses, dtype):
    """Ensemble Hessian stack ``(B, 3n, 3n)``: the single-structure
    build vmapped over conformers."""

    def build(coord):
        h = _build_hessian_xyz(coord, params, dtype)
        if masses is not None:
            h = _mass_weight_xyz(h, masses)
        return h

    return jax.vmap(build)(coords)


def _build_kirchhoffs_batched(coords, params, masses, dtype):
    """Ensemble Kirchhoff stack ``(B, n, n)`` (see
    :func:`_build_hessians_batched`)."""

    def build(coord):
        kirchhoff = _build_kirchhoff(coord, params, dtype)
        return _mass_weight(kirchhoff, masses, repeat3=False)

    return jax.vmap(build)(coords)


@functools.partial(
    jax.jit,
    static_argnames=("with_dcc", "n_modes", "dtype"),
)
def gnm_observables(coord, params, masses=None, *, with_dcc=False,
                    n_modes=None, dtype=jnp.float32,
                    tem=None, tem_factors=nma_core.K_B):
    """GNM analogue of :func:`anm_observables` over the Kirchhoff
    matrix (one trivial mode)."""
    coord = jnp.asarray(coord, dtype=dtype)
    n = coord.shape[0]
    kirchhoff = _build_kirchhoff(coord, params, dtype)
    kirchhoff = _mass_weight(kirchhoff, masses, repeat3=False)

    vals, vecs = jnp.linalg.eigh(kirchhoff)
    vecs = vecs.T
    return _gnm_observables_from_eigensystem(
        vals, vecs, n, with_dcc=with_dcc, n_modes=n_modes, tem=tem,
        tem_factors=tem_factors)


def _gnm_observables_from_eigensystem(vals, vecs, n, *, with_dcc,
                                      n_modes, tem, tem_factors):
    n_trivial = 1
    if n_modes is not None and not (0 < n_modes <= n - n_trivial):
        raise ValueError(
            f"n_modes={n_modes} must be in [1, {n - n_trivial}]"
        )
    stop = n if n_modes is None else n_trivial + n_modes
    mode_indices = jnp.arange(n_trivial, stop)

    out = {
        "eig_values": vals,
        "eig_vectors": vecs,
        "frequencies": nma_core.frequencies_from_eigenvalues(
            vals, n_trivial, jnp
        ),
        "msf": nma_core.mean_square_fluctuation(
            vals, vecs, mode_indices, jnp, num_dim=1,
            tem=tem, tem_factors=tem_factors,
        ),
    }
    out["bfactor"] = nma_core.bfactor_from_msf(out["msf"])
    if with_dcc:
        dcc = nma_core.dcc_from_modes(vals, vecs, mode_indices, jnp,
                                      num_dim=1)
        out["dcc"] = nma_core.normalize_dcc(dcc, jnp)
    return out


@functools.partial(
    jax.jit,
    static_argnames=("with_dcc", "n_modes", "dtype",
                     "bandwidth", "n_iter_bisect"),
)
def ensemble_gnm_banded(coords, params, masses=None, *, with_dcc=False,
                        n_modes=None, dtype=jnp.float32,
                        bandwidth=8, n_iter_bisect=40,
                        tem=None, tem_factors=nma_core.K_B):
    """GNM analogue of :func:`ensemble_anm_banded`: full eigensystems
    of the Kirchhoff ensemble from the natively batched two-stage
    banded solver (no O(n^3) dense eigh)."""
    from ..ops import spectrum

    params = _resolve_params(params)
    coords = jnp.asarray(coords, dtype=dtype)
    n = coords.shape[-2]

    matrices = _build_kirchhoffs_batched(coords, params, masses, dtype)
    vals, vecs = spectrum.eigh_banded(matrices, bandwidth=bandwidth,
                                      n_iter=n_iter_bisect)
    return jax.vmap(
        lambda v, u: _gnm_observables_from_eigensystem(
            v, u, n, with_dcc=with_dcc, n_modes=n_modes, tem=tem,
            tem_factors=tem_factors)
    )(vals, vecs)


@functools.partial(
    jax.jit,
    static_argnames=("n_modes", "with_dcc", "dtype",
                     "bandwidth", "n_iter_bisect", "n_iter_modes"),
)
def anm_spectral(coord, params, masses=None, *, n_modes=None,
                 with_dcc=True, dtype=jnp.float32, bandwidth=8,
                 n_iter_bisect=40, n_iter_modes=24):
    """
    Full spectral ANM NMA **without a dense eigh** — a matmul-rich
    route to the same observables:

    * all eigenvalues / frequencies via the blocked two-stage banded
      solver (:func:`springcraft_tpu.ops.spectrum.eigvalsh_banded`);
    * all-mode MSF / B-factors / DCC via the regularized Cholesky
      covariance;
    * optionally the `n_modes` lowest mode *shapes* by subspace
      iteration **on the covariance already in hand**
      (:func:`springcraft_tpu.ops.modes.modes_from_covariance`).

    One regularized Cholesky solve serves both the covariance
    observables and the mode extraction, and every heavy op is a
    matmul or triangular solve.  Output keys match :func:`anm_observables` (plus
    ``covariance``), except the full modal matrix ``eig_vectors`` is
    replaced by the ``n_modes`` requested rows (``mode_vectors`` /
    ``mode_values``).  Requires a *connected* network (analytic rigid
    null space), like :func:`anm_fluctuations`.
    """
    from ..ops import modes as modes_mod
    from ..ops import spectrum

    coord = jnp.asarray(coord, dtype=dtype)
    n = coord.shape[0]
    hessian = _build_hessian_xyz(coord, params, dtype)
    if masses is not None:
        hessian = _mass_weight_xyz(hessian, masses)
    basis = rigid.rigid_modes_anm(coord, masses=masses, layout="xyz")
    basis = jnp.asarray(basis, dtype=dtype)

    # One regularized, equilibrated Cholesky pseudo-inverse (shared
    # implementation with the fluctuation pipelines)
    cov = rigid.covariance_cholesky(hessian, basis)

    planes = cov.reshape(3, n, 3, n)
    traces = sum(planes[a, :, a, :] for a in range(3))
    vals = spectrum.eigvalsh_banded(hessian, bandwidth=bandwidth,
                                    n_iter=n_iter_bisect)
    out = {
        "covariance": cov,
        "eig_values": vals,
        "frequencies": nma_core.frequencies_from_eigenvalues(vals, 6,
                                                             jnp),
        "msf": jnp.diagonal(traces),
    }
    out["bfactor"] = nma_core.bfactor_from_msf(out["msf"])
    if with_dcc:
        out["dcc"] = nma_core.normalize_dcc(traces, jnp)
    if n_modes is not None:
        # Subspace iteration on the covariance already in hand — modes
        # cost only batched matmuls (no extra factorization, no
        # per-conformer QR chain)
        mode_vals, mode_vecs = modes_mod.modes_from_covariance(
            cov, hessian, basis, k=n_modes, n_iter=n_iter_modes
        )
        out["mode_values"] = mode_vals
        out["mode_vectors"] = mode_vecs
    return out


@functools.partial(
    jax.jit,
    static_argnames=("n_modes", "with_dcc", "dtype",
                     "bandwidth", "n_iter_bisect", "n_iter_modes",
                     "inverse"),
)
def _ensemble_anm_spectral_impl(coords, params, masses, *, n_modes,
                                with_dcc, dtype, bandwidth,
                                n_iter_bisect, n_iter_modes,
                                inverse="cho_solve"):
    from ..ops import modes as modes_mod
    from ..ops import spectrum


    coords = jnp.asarray(coords, dtype=dtype)
    n = coords.shape[1]

    hessians = _build_hessians_batched(coords, params, masses,
                                       dtype)              # (B, 3n, 3n)
    bases = jax.vmap(
        lambda c: jnp.asarray(
            rigid.rigid_modes_anm(c, masses=masses, layout="xyz"),
            dtype=dtype)
    )(coords)
    covs = rigid.covariance_cholesky(hessians, bases, inverse=inverse)

    planes = covs.reshape(-1, 3, n, 3, n)
    traces = sum(planes[:, a, :, a, :] for a in range(3))
    # Native batch through the two-stage solver: the bisection
    # vectorizes batch x shifts internally
    vals = spectrum.eigvalsh_banded(hessians, bandwidth=bandwidth,
                                    n_iter=n_iter_bisect)
    out = {
        "covariance": covs,
        "eig_values": vals,
        "frequencies": jax.vmap(
            lambda v: nma_core.frequencies_from_eigenvalues(v, 6, jnp)
        )(vals),
        "msf": jnp.diagonal(traces, axis1=1, axis2=2),
    }
    out["bfactor"] = nma_core.bfactor_from_msf(out["msf"])
    if with_dcc:
        out["dcc"] = jax.vmap(
            lambda t: nma_core.normalize_dcc(t, jnp))(traces)
    if n_modes is not None:
        mode_vals, mode_vecs = jax.vmap(
            lambda c, h, t: modes_mod.modes_from_covariance(
                c, h, t, k=n_modes, n_iter=n_iter_modes)
        )(covs, hessians, bases)
        out["mode_values"] = mode_vals
        out["mode_vectors"] = mode_vecs
    return out


def ensemble_anm_spectral(coords, params, masses=None, *, n_modes=None,
                          with_dcc=True, dtype=jnp.float32,
                          bandwidth=8,
                          n_iter_bisect=40, n_iter_modes=16,
                          inverse="auto"):
    """
    Batched :func:`anm_spectral` over a conformer ensemble.

    Not a plain ``vmap`` of the single-structure pipeline: the
    eigenvalue stage flows through :func:`ops.spectrum.eigvalsh_banded`
    as a native batch (the bisection vectorizes batch x shifts), and
    the shared covariance solve takes the batched covariance engine
    (``inverse`` — see
    :func:`ensemble_anm_fluctuations`).
    """
    params = _resolve_params(params)
    inverse = _resolve_inverse(inverse, dtype)
    return _ensemble_anm_spectral_impl(
        jnp.asarray(coords), params, masses, n_modes=n_modes,
        with_dcc=with_dcc, dtype=dtype,
        bandwidth=bandwidth, n_iter_bisect=n_iter_bisect,
        n_iter_modes=n_iter_modes, inverse=inverse)


@functools.partial(
    jax.jit,
    static_argnames=("with_dcc", "dtype", "bandwidth",
                     "n_iter_bisect"),
)
def gnm_spectral(coord, params, masses=None, *, with_dcc=True,
                 dtype=jnp.float32, bandwidth=8,
                 n_iter_bisect=40):
    """
    GNM analogue of :func:`anm_spectral`: all Kirchhoff eigenvalues /
    frequencies via the blocked two-stage banded solver, all-mode MSF /
    B-factors / DCC via the regularized Cholesky covariance (one
    trivial constant mode) — no dense eigh.  Requires a connected
    network.
    """
    from ..ops import spectrum


    coord = jnp.asarray(coord, dtype=dtype)
    n = coord.shape[0]
    kirchhoff = _build_kirchhoff(coord, params, dtype)
    kirchhoff = _mass_weight(kirchhoff, masses, repeat3=False)
    basis = rigid.null_mode_gnm(n, masses=masses, dtype=dtype)
    cov = rigid.covariance_cholesky(kirchhoff, basis)

    vals = spectrum.eigvalsh_banded(kirchhoff, bandwidth=bandwidth,
                                    n_iter=n_iter_bisect)
    out = {
        "covariance": cov,
        "eig_values": vals,
        "frequencies": nma_core.frequencies_from_eigenvalues(vals, 1,
                                                             jnp),
        "msf": jnp.diagonal(cov),
    }
    out["bfactor"] = nma_core.bfactor_from_msf(out["msf"])
    if with_dcc:
        out["dcc"] = nma_core.normalize_dcc(cov, jnp)
    return out


@functools.partial(
    jax.jit,
    static_argnames=("n_modes", "with_dcc", "dtype",
                     "bandwidth", "n_iter_bisect", "n_iter_modes",
                     "inverse"),
)
def _ensemble_gnm_spectral_impl(coords, params, masses, *, n_modes,
                                with_dcc, dtype, bandwidth,
                                n_iter_bisect, n_iter_modes,
                                inverse="cho_solve"):
    from ..ops import modes as modes_mod
    from ..ops import spectrum

    coords = jnp.asarray(coords, dtype=dtype)
    n = coords.shape[1]

    kirchhoffs = _build_kirchhoffs_batched(coords, params, masses, dtype)
    basis = rigid.null_mode_gnm(n, masses=masses, dtype=dtype)
    covs = rigid.covariance_cholesky(kirchhoffs, basis, inverse=inverse)
    vals = spectrum.eigvalsh_banded(kirchhoffs, bandwidth=bandwidth,
                                    n_iter=n_iter_bisect)
    out = {
        "covariance": covs,
        "eig_values": vals,
        "frequencies": jax.vmap(
            lambda v: nma_core.frequencies_from_eigenvalues(v, 1, jnp)
        )(vals),
        "msf": jnp.diagonal(covs, axis1=1, axis2=2),
    }
    out["bfactor"] = nma_core.bfactor_from_msf(out["msf"])
    if with_dcc:
        out["dcc"] = jax.vmap(
            lambda c: nma_core.normalize_dcc(c, jnp))(covs)
    if n_modes is not None:
        mode_vals, mode_vecs = jax.vmap(
            lambda c, m: modes_mod.modes_from_covariance(
                c, m, basis, k=n_modes, n_iter=n_iter_modes)
        )(covs, kirchhoffs)
        out["mode_values"] = mode_vals
        out["mode_vectors"] = mode_vecs
    return out


def ensemble_gnm_spectral(coords, params, masses=None, *, n_modes=None,
                          with_dcc=True, dtype=jnp.float32,
                          bandwidth=8,
                          n_iter_bisect=40, n_iter_modes=16,
                          inverse="auto"):
    """
    Batched :func:`gnm_spectral` over a conformer ensemble — the GNM
    analogue of :func:`ensemble_anm_spectral`: all Kirchhoff
    eigenvalues through the natively batched two-stage banded solver,
    all-mode covariance observables through the shared (optionally
    blocked) Cholesky engine, and optionally the ``n_modes``
    lowest mode shapes by subspace iteration on the covariance.
    """
    params = _resolve_params(params)
    inverse = _resolve_inverse(inverse, dtype)
    return _ensemble_gnm_spectral_impl(
        jnp.asarray(coords), params, masses, n_modes=n_modes,
        with_dcc=with_dcc, dtype=dtype,
        bandwidth=bandwidth, n_iter_bisect=n_iter_bisect,
        n_iter_modes=n_iter_modes, inverse=inverse)


@functools.partial(
    jax.jit, static_argnames=("with_dcc", "with_prs", "with_covariance",
                              "dtype")
)
def anm_fluctuations(coord, params, masses=None, *, with_dcc=True,
                     with_prs=False, with_covariance=True,
                     dtype=jnp.float32):
    """
    Covariance-derived ANM observables via the fast Cholesky path —
    no eigendecomposition.

    The six rigid-body modes of a connected network are known
    analytically, so the pseudo-inverse covariance is obtained from a
    regularized Cholesky solve (see
    :func:`springcraft_tpu.ops.rigid.covariance_cholesky`) instead of
    an eigendecomposition.  Produces every
    all-mode observable: MSF, B-factors, normalized DCC and optionally
    PRS + effector/sensor profiles.  (Results match the eigh path; for
    disconnected networks fall back to :func:`anm_observables`.)

    With ``with_covariance=False`` the full ``(3n, 3n)`` covariance is
    never formed: the pipeline computes only the ``(n, n)`` plane-trace
    matrix (:func:`springcraft_tpu.ops.rigid.covariance_plane_traces`)
    that MSF/B-factors/DCC consume — identical observables at roughly
    half the cost (the ``covariance`` output is then omitted, and PRS
    is unavailable since it needs all nine plane blocks).
    """
    coord = jnp.asarray(coord, dtype=dtype)
    hessian = _build_hessian_xyz(coord, params, dtype)
    if masses is not None:
        hessian = _mass_weight_xyz(hessian, masses)
    basis = rigid.rigid_modes_anm(coord, masses=masses, layout="xyz")
    if not with_covariance:
        if with_prs:
            raise ValueError(
                "with_prs=True requires with_covariance=True — PRS "
                "consumes all nine covariance plane blocks, not just "
                "the traces")
        traces = rigid.covariance_plane_traces(hessian, basis)
        return _anm_trace_observables(traces, with_dcc)
    cov = rigid.covariance_cholesky(hessian, basis)
    return _anm_cov_observables(cov, coord.shape[0], with_dcc, with_prs)


def _anm_trace_observables(traces, with_dcc):
    # `traces` is the (n, n) plane-trace matrix of the covariance —
    # see ops.rigid.covariance_plane_traces
    out = {"msf": jnp.diagonal(traces)}
    out["bfactor"] = nma_core.bfactor_from_msf(out["msf"])
    if with_dcc:
        out["dcc"] = nma_core.normalize_dcc(traces, jnp)
    return out


def _anm_cov_observables(cov, n, with_dcc, with_prs):
    # In xyz layout the 3x3 superelement trace over components a is
    # sum_a cov[a*n + i, a*n + j]
    planes = cov.reshape(3, n, 3, n)
    traces = sum(planes[a, :, a, :] for a in range(3))
    out = {
        "covariance": cov,
        "msf": jnp.diagonal(traces),
    }
    out["bfactor"] = nma_core.bfactor_from_msf(out["msf"])
    if with_dcc:
        out["dcc"] = nma_core.normalize_dcc(traces, jnp)
    if with_prs:
        sq = jnp.square(planes).sum(axis=(0, 2))
        prs = sq / jnp.diagonal(sq)[:, None]
        out["prs"] = prs
        eff, sens = nma_core.effector_sensor_profiles(prs, jnp)
        out["effector"] = eff
        out["sensor"] = sens
    return out


@functools.partial(
    jax.jit, static_argnames=("with_dcc", "dtype")
)
def gnm_fluctuations(coord, params, masses=None, *, with_dcc=True,
                     dtype=jnp.float32):
    """GNM analogue of :func:`anm_fluctuations`: covariance via the
    regularized Cholesky solve with the analytic constant null mode."""
    coord = jnp.asarray(coord, dtype=dtype)
    n = coord.shape[0]
    kirchhoff = _build_kirchhoff(coord, params, dtype)
    kirchhoff = _mass_weight(kirchhoff, masses, repeat3=False)
    basis = rigid.null_mode_gnm(n, masses=masses, dtype=dtype)
    cov = rigid.covariance_cholesky(kirchhoff, basis)
    return _gnm_cov_observables(cov, with_dcc)


def _gnm_cov_observables(cov, with_dcc):
    out = {
        "covariance": cov,
        "msf": jnp.diagonal(cov),
    }
    out["bfactor"] = nma_core.bfactor_from_msf(out["msf"])
    if with_dcc:
        out["dcc"] = nma_core.normalize_dcc(cov, jnp)
    return out


def ensemble_anm_fluctuations(coords, params, masses=None, *,
                              inverse="auto", **options):
    """Batched fast-covariance ANM over a conformer ensemble.

    ``inverse`` selects the covariance engine: ``"cho_solve"`` vmaps
    the per-conformer XLA Cholesky path; ``"blocked"`` runs the whole
    ensemble through the recursive blocked inverse factor
    (:func:`springcraft_tpu.ops.pallas_linalg.spd_inverse_factor`);
    ``"auto"`` takes :func:`springcraft_tpu.utils.config.ensemble_inverse`.

    Pass ``with_covariance=False`` when only MSF/B-factors/DCC are
    needed: the pipeline then computes the ``(n, n)`` covariance
    plane-trace matrix directly and never materializes the ``(3n, 3n)``
    covariance — identical observables at roughly half the cost (see
    :func:`anm_fluctuations`).

    ``chunk`` (int, blocked engine only): process a megabatch as ONE
    device program that maps over ``chunk``-conformer chunks, bounding
    the working set of the factor to one chunk.  The batch must divide
    by ``chunk``.
    """
    params = _resolve_params(params)
    coords = jnp.asarray(coords)
    chunk = options.pop("chunk", None)
    inverse = _resolve_inverse(inverse, options.get("dtype", jnp.float32))
    if inverse == "blocked":
        if chunk is not None and coords.shape[0] > chunk:
            return _anm_fluctuations_megabatch(
                coords, params, masses, chunk, _freeze_options(options))
        return _ensemble_anm_fluctuations_blocked(
            coords, params, masses, **options)
    fn = functools.partial(anm_fluctuations, params=params, masses=masses,
                           **options)
    return jax.vmap(lambda c: fn(c))(coords)


def _freeze_options(options):
    return tuple(sorted(options.items()))


def _reshape_chunks(coords, chunk):
    batch = coords.shape[0]
    if batch % chunk:
        raise ValueError(
            f"megabatch of {batch} conformers must divide into chunks "
            f"of {chunk}")
    return coords.reshape(batch // chunk, chunk, *coords.shape[1:])


@functools.partial(jax.jit, static_argnames=("chunk", "frozen_options"))
def _anm_fluctuations_megabatch(coords, params, masses, chunk,
                                frozen_options):
    """One device program over a conformer megabatch: ``lax.map`` of the
    blocked pipeline over fixed-size chunks, so the factor's working
    set is one chunk's while the whole megabatch is one dispatch."""
    chunks = _reshape_chunks(coords, chunk)
    out = jax.lax.map(
        lambda c: _ensemble_anm_fluctuations_blocked(
            c, params, masses, **dict(frozen_options)),
        chunks)
    return jax.tree_util.tree_map(
        lambda x: x.reshape(coords.shape[0], *x.shape[2:]), out)


def _resolve_inverse(inverse, dtype):
    if inverse == "auto":
        return config.ensemble_inverse(dtype)
    return inverse


def ensemble_gnm_fluctuations(coords, params, masses=None, *,
                              inverse="auto", with_dcc=True,
                              dtype=jnp.float32, chunk=None):
    """GNM analogue of :func:`ensemble_anm_fluctuations` (same
    ``inverse`` engine selection and ``chunk`` megabatch option)."""
    params = _resolve_params(params)
    coords = jnp.asarray(coords)
    inverse = _resolve_inverse(inverse, dtype)
    if inverse == "blocked":
        if chunk is not None and coords.shape[0] > chunk:
            return _gnm_fluctuations_megabatch(
                coords, params, masses, chunk,
                _freeze_options(dict(with_dcc=with_dcc, dtype=dtype)))
        return _ensemble_gnm_fluctuations_blocked(
            coords, params, masses, with_dcc=with_dcc, dtype=dtype)
    fn = functools.partial(gnm_fluctuations, params=params, masses=masses,
                           with_dcc=with_dcc, dtype=dtype)
    return jax.vmap(lambda c: fn(c))(coords)


@functools.partial(jax.jit, static_argnames=("chunk", "frozen_options"))
def _gnm_fluctuations_megabatch(coords, params, masses, chunk,
                                frozen_options):
    """GNM analogue of :func:`_anm_fluctuations_megabatch`."""
    chunks = _reshape_chunks(coords, chunk)
    out = jax.lax.map(
        lambda c: _ensemble_gnm_fluctuations_blocked(
            c, params, masses, **dict(frozen_options)),
        chunks)
    return jax.tree_util.tree_map(
        lambda x: x.reshape(coords.shape[0], *x.shape[2:]), out)


@functools.partial(
    jax.jit, static_argnames=("with_dcc", "dtype")
)
def _ensemble_gnm_fluctuations_blocked(coords, params, masses=None,
                                       with_dcc=True, dtype=jnp.float32):
    coords = jnp.asarray(coords, dtype=dtype)
    n = coords.shape[1]

    kirchhoffs = _build_kirchhoffs_batched(coords, params, masses, dtype)
    basis = rigid.null_mode_gnm(n, masses=masses, dtype=dtype)
    cov = rigid.covariance_cholesky(kirchhoffs, basis, inverse="blocked")
    return jax.vmap(lambda c: _gnm_cov_observables(c, with_dcc))(cov)


@functools.partial(
    jax.jit, static_argnames=("with_dcc", "with_prs", "with_covariance",
                              "dtype")
)
def _ensemble_anm_fluctuations_blocked(coords, params, masses=None,
                                       with_dcc=True, with_prs=False,
                                       with_covariance=True,
                                       dtype=jnp.float32):
    coords = jnp.asarray(coords, dtype=dtype)
    n = coords.shape[1]
    if with_prs and not with_covariance:
        raise ValueError(
            "with_prs=True requires with_covariance=True — PRS "
            "consumes all nine covariance plane blocks, not just "
            "the traces")

    bases = jax.vmap(
        lambda c: rigid.rigid_modes_anm(c, masses=masses, layout="xyz")
    )(coords)

    hessians = _build_hessians_batched(coords, params, masses, dtype)
    if not with_covariance:
        traces = rigid.covariance_plane_traces(hessians, bases,
                                               inverse="blocked")
        return jax.vmap(
            lambda t: _anm_trace_observables(t, with_dcc)
        )(traces)
    cov = rigid.covariance_cholesky(hessians, bases, inverse="blocked")
    return jax.vmap(
        lambda c: _anm_cov_observables(c, n, with_dcc, with_prs)
    )(cov)


def _resolve_params(params):
    """Accept either an FFParams pytree or a ForceField object (lowered
    to its compact device form when available)."""
    to_compact = getattr(params, "to_compact_params", None)
    if to_compact is not None:
        return to_compact()
    to_params = getattr(params, "to_params", None)
    if to_params is not None and not hasattr(params, "kind"):
        lowered = to_params()
        if lowered is None:
            raise ValueError(
                "This force field has no device parameterization; use "
                "the host API (compute_kirchhoff/compute_hessian)"
            )
        return lowered
    return params


def ensemble_anm(coords, params, masses=None, **options):
    """
    Batched ANM NMA over an ensemble of conformers.

    Parameters
    ----------
    coords : ndarray, shape=(b, n, 3)
        Conformer batch (e.g. MD snapshots of one protein).
    params : FFParams or ForceField
        Shared force-field parameterization (per-structure tables are
        valid across conformers of the same sequence).
    masses : ndarray, shape=(n,), optional

    Returns
    -------
    dict of batched observables (leading axis = conformer).
    """
    params = _resolve_params(params)
    fn = functools.partial(anm_observables, params=params, masses=masses,
                           **options)
    return jax.vmap(lambda c: fn(c))(jnp.asarray(coords))


def ensemble_gnm(coords, params, masses=None, **options):
    """Batched GNM NMA over an ensemble of conformers
    (see :func:`ensemble_anm`)."""
    params = _resolve_params(params)
    fn = functools.partial(gnm_observables, params=params, masses=masses,
                           **options)
    return jax.vmap(lambda c: fn(c))(jnp.asarray(coords))
