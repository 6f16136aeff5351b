"""
Fast-covariance path tests: analytic rigid-body null modes and the
regularized Cholesky pseudo-inverse must reproduce the eigh-based
reference results.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import springcraft_tpu as sc
from springcraft_tpu.ops import assembly, ffparams, rigid
from springcraft_tpu.parallel import anm_fluctuations, gnm_fluctuations


def test_rigid_modes_span_nullspace(ca_1l2y):
    params = ffparams.invariant_params(13.0)
    coord = ca_1l2y.coord.astype(np.float64)
    h = np.asarray(assembly.hessian_matrix(coord, params, jnp,
                                           layout="xyz"))
    basis = np.asarray(rigid.rigid_modes_anm(coord, layout="xyz"))

    assert basis.shape == (3 * len(coord), 6)
    # Orthonormal
    assert np.allclose(basis.T @ basis, np.eye(6), atol=1e-10)
    # Annihilated by the Hessian
    assert np.max(np.abs(h @ basis)) < 1e-8


def test_rigid_modes_mass_weighted(ca_1l2y):
    params = ffparams.hinsen_params()
    coord = ca_1l2y.coord.astype(np.float64)
    masses = np.linspace(60.0, 180.0, len(coord))

    h = np.asarray(assembly.hessian_matrix(coord, params, jnp,
                                           layout="xyz"))
    w3 = np.tile(1.0 / np.sqrt(masses), 3)
    h_mw = h * np.outer(w3, w3)
    basis = np.asarray(
        rigid.rigid_modes_anm(coord, masses=jnp.asarray(masses),
                              layout="xyz")
    )
    assert np.max(np.abs(h_mw @ basis)) < 1e-8


def test_covariance_cholesky_matches_pinv(ca_1l2y):
    params = ffparams.invariant_params(13.0)
    coord = ca_1l2y.coord.astype(np.float64)
    h = np.asarray(assembly.hessian_matrix(coord, params, jnp,
                                           layout="xyz"))
    basis = rigid.rigid_modes_anm(coord, layout="xyz")

    fast = np.asarray(rigid.covariance_cholesky(jnp.asarray(h), basis))
    ref = np.linalg.pinv(h, hermitian=True, rcond=1e-6)
    assert np.allclose(fast, ref, atol=1e-8)


def test_gnm_null_mode_and_covariance(ca_1l2y):
    params = ffparams.invariant_params(7.0)
    coord = ca_1l2y.coord.astype(np.float64)
    k = np.asarray(assembly.kirchhoff_matrix(coord, params, jnp))

    basis = rigid.null_mode_gnm(len(coord), dtype=jnp.float64)
    assert np.max(np.abs(k @ np.asarray(basis))) < 1e-10

    fast = np.asarray(rigid.covariance_cholesky(jnp.asarray(k), basis))
    ref = np.linalg.pinv(k, hermitian=True, rcond=1e-6)
    assert np.allclose(fast, ref, atol=1e-9)


def test_anm_fluctuations_match_model(ca_1l2y):
    ff = sc.InvariantForceField(13.0)
    out = anm_fluctuations(
        ca_1l2y.coord.astype(np.float64), ff.to_params(),
        with_dcc=True, with_prs=True, dtype=jnp.float64,
    )
    anm = sc.ANM(ca_1l2y, ff)
    assert np.allclose(out["msf"], anm.mean_square_fluctuation(),
                       atol=1e-8)
    assert np.allclose(out["bfactor"], anm.bfactor(), atol=1e-7)
    assert np.allclose(out["dcc"], anm.dcc(), atol=1e-8)

    prs_ref, eff_ref, sens_ref = anm.prs_effector_sensor()
    assert np.allclose(out["prs"], prs_ref, atol=1e-8)
    assert np.allclose(out["effector"], eff_ref, atol=1e-8)
    assert np.allclose(out["sensor"], sens_ref, atol=1e-8)


def test_anm_fluctuations_mass_weighted(ca_1l2y):
    ff = sc.HinsenForceField()
    masses = np.linspace(60.0, 180.0, len(ca_1l2y))
    out = anm_fluctuations(
        ca_1l2y.coord.astype(np.float64), ff.to_params(),
        masses=jnp.asarray(masses), dtype=jnp.float64,
    )
    anm = sc.ANM(ca_1l2y, ff, masses=masses)
    assert np.allclose(out["msf"], anm.mean_square_fluctuation(),
                       atol=1e-8)


def test_gnm_fluctuations_match_model(ca_1l2y):
    ff = sc.InvariantForceField(7.0)
    out = gnm_fluctuations(
        ca_1l2y.coord.astype(np.float64), ff.to_params(),
        dtype=jnp.float64,
    )
    gnm = sc.GNM(ca_1l2y, ff)
    assert np.allclose(out["msf"], gnm.mean_square_fluctuation(),
                       atol=1e-9)
    assert np.allclose(out["dcc"], gnm.dcc(), atol=1e-9)


def test_covariance_cholesky_blocked(ca_1l2y):
    """The blocked right-hand-side variant must equal the full solve."""
    params = ffparams.invariant_params(13.0)
    coord = ca_1l2y.coord.astype(np.float64)
    h = np.asarray(assembly.hessian_matrix(coord, params, jnp,
                                           layout="xyz"))
    basis = rigid.rigid_modes_anm(coord, layout="xyz")

    full = np.asarray(rigid.covariance_cholesky(jnp.asarray(h), basis))
    blocked = np.asarray(
        rigid.covariance_cholesky(jnp.asarray(h), basis, block_size=12)
    )
    assert np.allclose(full, blocked, atol=1e-10)

    with pytest.raises(ValueError):
        rigid.covariance_cholesky(jnp.asarray(h), basis, block_size=7)


def test_covariance_plane_traces_matches_full(ca_1l2y):
    """Trace-only engine == plane traces of the full pseudo-inverse,
    both inverse engines, unbatched and batched."""
    params = ffparams.invariant_params(13.0)
    coord = ca_1l2y.coord.astype(np.float64)
    n = len(coord)
    h = np.asarray(assembly.hessian_matrix(coord, params, jnp,
                                           layout="xyz"))
    basis = rigid.rigid_modes_anm(coord, layout="xyz")

    cov = np.linalg.pinv(h, hermitian=True, rcond=1e-6)
    planes = cov.reshape(3, n, 3, n)
    ref = sum(planes[a, :, a, :] for a in range(3))

    traces = np.asarray(
        rigid.covariance_plane_traces(jnp.asarray(h), basis)
    )
    assert traces.shape == (n, n)
    assert np.allclose(traces, ref, atol=1e-8)

    # Blocked inverse-factor engine, float32
    traces32 = np.asarray(
        rigid.covariance_plane_traces(
            jnp.asarray(h, jnp.float32),
            jnp.asarray(np.asarray(basis), jnp.float32),
            inverse="blocked")
    )
    scale = np.max(np.abs(ref))
    assert np.max(np.abs(traces32 - ref)) / scale < 5e-4

    # Batched: three perturbed conformers through both paths
    rng = np.random.RandomState(0)
    coords = coord[None] + 0.05 * rng.randn(3, n, 3)
    hs = jnp.stack([
        assembly.hessian_matrix(c, params, jnp, layout="xyz")
        for c in coords
    ])
    bases = jnp.stack([
        rigid.rigid_modes_anm(c, layout="xyz") for c in coords
    ])
    batched = np.asarray(rigid.covariance_plane_traces(hs, bases))
    full = np.asarray(rigid.covariance_cholesky(hs, bases))
    full_planes = full.reshape(3, 3, n, 3, n)
    ref_b = full_planes[:, 0, :, 0, :] + full_planes[:, 1, :, 1, :] \
        + full_planes[:, 2, :, 2, :]
    assert np.allclose(batched, ref_b, atol=1e-8)

    with pytest.raises(ValueError):
        rigid.covariance_plane_traces(jnp.asarray(h), basis,
                                      inverse="nope")


def test_anm_fluctuations_trace_only(ca_1l2y):
    """with_covariance=False must reproduce the full-path observables
    without materializing the covariance."""
    ff = sc.InvariantForceField(13.0)
    full = anm_fluctuations(
        ca_1l2y.coord.astype(np.float64), ff.to_params(),
        with_dcc=True, dtype=jnp.float64,
    )
    lean = anm_fluctuations(
        ca_1l2y.coord.astype(np.float64), ff.to_params(),
        with_dcc=True, with_covariance=False, dtype=jnp.float64,
    )
    assert "covariance" not in lean
    assert np.allclose(lean["msf"], full["msf"], atol=1e-9)
    assert np.allclose(lean["bfactor"], full["bfactor"], atol=1e-8)
    assert np.allclose(lean["dcc"], full["dcc"], atol=1e-9)

    with pytest.raises(ValueError):
        anm_fluctuations(
            ca_1l2y.coord.astype(np.float64), ff.to_params(),
            with_prs=True, with_covariance=False, dtype=jnp.float64,
        )


def test_ensemble_anm_fluctuations_trace_only(ca_1l2y):
    """Blocked ensemble trace-only path == full blocked path."""
    from springcraft_tpu.parallel import ensemble_anm_fluctuations

    rng = np.random.RandomState(1)
    coords = (ca_1l2y.coord[None]
              + 0.05 * rng.randn(4, len(ca_1l2y), 3)).astype(np.float32)
    params = ffparams.invariant_params(13.0)
    full = ensemble_anm_fluctuations(
        coords, params, with_dcc=True, inverse="blocked")
    lean = ensemble_anm_fluctuations(
        coords, params, with_dcc=True, with_covariance=False,
        inverse="blocked")
    assert "covariance" not in lean
    for key in ("msf", "bfactor", "dcc"):
        scale = np.max(np.abs(np.asarray(full[key])))
        assert np.max(
            np.abs(np.asarray(lean[key]) - np.asarray(full[key]))
        ) / scale < 5e-4


def test_pinv_diagonal(ca_1l2y):
    params = ffparams.invariant_params(13.0)
    coord = ca_1l2y.coord.astype(np.float64)
    h = np.asarray(assembly.hessian_matrix(coord, params, jnp,
                                           layout="xyz"))
    basis = rigid.rigid_modes_anm(coord, layout="xyz")

    diag = np.asarray(
        rigid.pinv_diagonal(jnp.asarray(h), basis, block_size=12)
    )
    ref = np.diagonal(np.linalg.pinv(h, hermitian=True, rcond=1e-6))
    assert np.allclose(diag, ref, atol=1e-8)


def test_plane_traces_from_w_parts_matches_dense():
    """The blockwise plane-trace Grams over the factor's top-level
    blocks (the concat-free headline path) must match the dense-W
    contraction."""
    import jax.numpy as jnp

    from springcraft_tpu.ops import rigid

    rng = np.random.RandomState(11)
    # h=256, n=100: plane 2 (cols 200:300) starts above 128, so the
    # top-block row-range skip (k0=128) is exercised, and plane 2's
    # columns cross the h split
    b, mp, h, n = 3, 384, 256, 100  # m = 3n = 300 < mp
    m = 3 * n
    w = np.tril(rng.randn(b, mp, mp)).astype(np.float32)
    w[:, :, m:] = 0.0               # zero-scaled padding columns
    t = np.linalg.qr(rng.randn(b, m, 6))[0].astype(np.float32)
    sigma = jnp.float32(1.7)

    dense = rigid._plane_traces_from_w(jnp.asarray(w), jnp.asarray(t),
                                       sigma, n)
    parts = (jnp.asarray(w[:, :h, :h]), jnp.asarray(w[:, h:, :h]),
             jnp.asarray(w[:, h:, h:]))
    got = rigid._plane_traces_from_w_parts(parts, jnp.asarray(t),
                                           sigma, n)
    scale = float(jnp.max(jnp.abs(dense)))
    assert float(jnp.max(jnp.abs(got - dense))) / scale < 1e-6

    # single-leaf passthrough
    got1 = rigid._plane_traces_from_w_parts(
        (jnp.asarray(w), None, None), jnp.asarray(t), sigma, n)
    assert float(jnp.max(jnp.abs(got1 - dense))) == 0.0
