"""
Batched and multi-chip pipeline tests, run on a virtual 8-device CPU
mesh (see conftest).  Checks: fused pipeline results equal the
model-class reference path; sharded execution equals unsharded; the
row-sharded Hessian equals the dense one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import springcraft_tpu as sc
from springcraft_tpu.ops import assembly, ffparams
from springcraft_tpu.parallel import (
    anm_observables,
    ensemble_anm,
    ensemble_gnm,
    ensemble_mean_msf,
    gnm_observables,
    make_mesh,
    sharded_anm_pipeline,
    sharded_ensemble_anm,
    sharded_hessian,
)

from .util import random_coord


def _conformers(n_batch, n_atoms, seed=0, jitter=0.05):
    # Dense enough that a ~9 A cutoff keeps the network connected
    # (disconnected networks have extra zero modes -> undefined MSF)
    rng = np.random.RandomState(seed)
    base = rng.rand(n_atoms, 3) * 10
    return base[None] + jitter * rng.randn(n_batch, n_atoms, 3)


def test_anm_pipeline_matches_model_class(ca_1l2y):
    ff = sc.InvariantForceField(13.0)
    params = ff.to_params()
    coord = ca_1l2y.coord.astype(np.float64)

    out = anm_observables(coord, params, dtype=jnp.float64, with_dcc=True)

    anm = sc.ANM(ca_1l2y, ff)
    vals_ref, _ = anm.eigen()
    assert np.allclose(out["eig_values"], vals_ref, atol=1e-9)
    assert np.allclose(out["msf"], anm.mean_square_fluctuation(),
                       atol=1e-9)
    assert np.allclose(out["bfactor"], anm.bfactor(), atol=1e-9)
    assert np.allclose(out["frequencies"][6:], anm.frequencies()[6:],
                       atol=1e-9)
    assert np.allclose(out["dcc"], anm.dcc(), atol=1e-7)


def test_gnm_pipeline_matches_model_class(ca_1l2y):
    ff = sc.InvariantForceField(7.0)
    params = ff.to_params()
    coord = ca_1l2y.coord.astype(np.float64)

    out = gnm_observables(coord, params, dtype=jnp.float64, with_dcc=True)

    gnm = sc.GNM(ca_1l2y, ff)
    vals_ref, _ = gnm.eigen()
    assert np.allclose(out["eig_values"], vals_ref, atol=1e-9)
    assert np.allclose(out["msf"], gnm.mean_square_fluctuation(),
                       atol=1e-9)
    assert np.allclose(out["dcc"], gnm.dcc(), atol=1e-7)


def test_anm_pipeline_mass_weighting(ca_1l2y):
    ff = sc.HinsenForceField()
    masses = np.linspace(60.0, 180.0, len(ca_1l2y))
    out = anm_observables(
        ca_1l2y.coord.astype(np.float64), ff.to_params(),
        masses=jnp.asarray(masses), dtype=jnp.float64,
    )
    anm = sc.ANM(ca_1l2y, ff, masses=masses)
    vals_ref, _ = anm.eigen()
    assert np.allclose(out["eig_values"], vals_ref, atol=1e-9)


def test_ensemble_matches_loop():
    params = ffparams.invariant_params(9.0)
    coords = _conformers(6, 30)

    batched = ensemble_anm(coords, params, dtype=jnp.float64)
    for i in range(6):
        single = anm_observables(coords[i], params, dtype=jnp.float64)
        assert np.allclose(batched["eig_values"][i], single["eig_values"],
                           atol=1e-9)
        assert np.allclose(batched["msf"][i], single["msf"], atol=1e-9)


def test_ensemble_gnm_shapes():
    params = ffparams.pfenm_params()
    coords = _conformers(4, 25)
    out = ensemble_gnm(coords, params, n_modes=10)
    assert out["eig_values"].shape == (4, 25)
    assert out["msf"].shape == (4, 25)


@pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 devices")
def test_sharded_ensemble_matches_unsharded():
    mesh = make_mesh(8, row_axis=2)
    params = ffparams.invariant_params(9.0)
    coords = _conformers(16, 24)

    sharded = sharded_ensemble_anm(coords, params, mesh,
                                   dtype=jnp.float64)
    plain = ensemble_anm(coords, params, dtype=jnp.float64)
    assert np.allclose(np.asarray(sharded["msf"]),
                       np.asarray(plain["msf"]), atol=1e-9)

    mean = ensemble_mean_msf(coords, params, mesh)
    assert np.allclose(
        np.asarray(mean),
        np.asarray(plain["msf"]).astype(np.float32).mean(axis=0),
        atol=1e-4,
    )


@pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 devices")
@pytest.mark.parametrize("kind", ["invariant", "hinsen", "compact"])
def test_sharded_hessian_matches_dense(kind, two_chain_ca):
    mesh = make_mesh(8, row_axis=4)
    if kind == "compact":
        ff = sc.TabulatedForceField.s_enm_10(two_chain_ca)
        params = ff.to_compact_params()
        coord = two_chain_ca.coord.astype(np.float64)
    else:
        params = (ffparams.invariant_params(10.0) if kind == "invariant"
                  else ffparams.hinsen_params())
        coord = random_coord(5, 40)

    sharded = np.asarray(
        sharded_hessian(coord, params, mesh, dtype=jnp.float64)
    )
    dense = np.asarray(
        assembly.hessian_matrix(coord, params, jnp, dtype=np.float64)
    )
    assert np.allclose(sharded, dense, atol=1e-12)


@pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 devices")
def test_sharded_anm_pipeline():
    mesh = make_mesh(8, row_axis=4)
    params = ffparams.invariant_params(10.0)
    coord = _conformers(1, 40, seed=6)[0]

    out = sharded_anm_pipeline(coord, params, mesh, dtype=jnp.float64)
    ref = anm_observables(coord, params, dtype=jnp.float64)
    assert np.allclose(np.asarray(out["eig_values"]),
                       np.asarray(ref["eig_values"]), atol=1e-9)
    assert np.allclose(np.asarray(out["msf"]), np.asarray(ref["msf"]),
                       atol=1e-9)


def test_n_modes_validation(ca_1l2y):
    ff = sc.InvariantForceField(13.0)
    with pytest.raises(ValueError):
        anm_observables(ca_1l2y.coord.astype(np.float32), ff.to_params(),
                        n_modes=10_000)
    with pytest.raises(ValueError):
        gnm_observables(ca_1l2y.coord.astype(np.float32), ff.to_params(),
                        n_modes=10_000)


@pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 devices")
def test_sharded_lowest_modes():
    from springcraft_tpu.parallel import sharded_lowest_modes

    mesh = make_mesh(8, row_axis=4)
    params = ffparams.invariant_params(10.0)
    coord = _conformers(1, 40, seed=6)[0].astype(np.float64)

    vals, vecs = sharded_lowest_modes(coord, params, mesh, k=6,
                                      dtype=jnp.float64, n_iter=300)
    from springcraft_tpu.ops import assembly

    h = np.asarray(assembly.hessian_matrix(coord, params, jnp,
                                           layout="atom"))
    ref = np.linalg.eigvalsh(h)
    assert np.allclose(np.asarray(vals), ref[6:12], rtol=1e-6)


@pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 devices")
def test_sharded_covariance():
    from springcraft_tpu.parallel import sharded_covariance

    mesh = make_mesh(8, row_axis=2)
    params = ffparams.invariant_params(10.0)
    coord = _conformers(1, 40, seed=6)[0].astype(np.float64)

    cov = np.asarray(
        sharded_covariance(coord, params, mesh, dtype=jnp.float64)
    )
    from springcraft_tpu.ops import assembly

    h = np.asarray(assembly.hessian_matrix(coord, params, jnp,
                                           layout="atom"))
    ref = np.linalg.pinv(h, hermitian=True, rcond=1e-6)
    assert np.allclose(cov, ref, atol=1e-8)


def test_tem_scaling_dynamic(ca_1l2y):
    """tem is a dynamic argument: scaling matches the model API and
    different temperatures reuse one compilation."""
    ff = sc.InvariantForceField(13.0)
    coord = ca_1l2y.coord.astype(np.float64)
    base = anm_observables(coord, ff.to_params(), dtype=jnp.float64)
    scaled = anm_observables(coord, ff.to_params(), dtype=jnp.float64,
                             tem=300.0, tem_factors=2.0)
    assert np.allclose(np.asarray(scaled["msf"]),
                       np.asarray(base["msf"]) * 600.0, rtol=1e-12)

    with pytest.raises(ValueError):
        anm_observables(coord, ff.to_params(), n_modes=0)


def test_blocked_cholesky_and_solves():
    from springcraft_tpu.parallel.blocked import (
        blocked_cholesky,
        blocked_solve_lower,
        blocked_solve_lower_t,
    )

    rng = np.random.RandomState(7)
    n, block = 48, 12
    a = rng.randn(n, n)
    a = a @ a.T + n * np.eye(n)  # SPD
    l = np.asarray(blocked_cholesky(jnp.asarray(a), block))
    assert np.allclose(l @ l.T, a, atol=1e-9)
    assert np.allclose(l, np.tril(l))

    rhs = rng.randn(n, 5)
    y = np.asarray(blocked_solve_lower(jnp.asarray(l), jnp.asarray(rhs),
                                       block))
    assert np.allclose(l @ y, rhs, atol=1e-9)
    x = np.asarray(blocked_solve_lower_t(jnp.asarray(l), jnp.asarray(rhs),
                                         block))
    assert np.allclose(l.T @ x, rhs, atol=1e-9)


@pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 devices")
def test_blocked_covariance_and_msf_match_pinvh():
    """Distributed blocked Cholesky + triangular solves: full covariance
    and the one-solve MSF path both reproduce the reference
    ``pinv(hessian, hermitian=True, rcond=1e-6)`` semantics
    (reference ``anm.py:133-136``) on the 8-device mesh."""
    from springcraft_tpu.parallel.blocked import (
        sharded_all_mode_msf,
        sharded_covariance_blocked,
    )

    mesh = make_mesh(8, row_axis=2)
    params = ffparams.invariant_params(10.0)
    coord = _conformers(1, 48, seed=6)[0].astype(np.float64)

    h = np.asarray(assembly.hessian_matrix(coord, params, jnp,
                                           layout="atom"))
    ref_cov = np.linalg.pinv(h, hermitian=True, rcond=1e-6)

    cov = np.asarray(
        sharded_covariance_blocked(coord, params, mesh, block=16,
                                   dtype=jnp.float64)
    )
    assert np.allclose(cov, ref_cov, atol=1e-8)

    out = sharded_all_mode_msf(coord, params, mesh, block=16,
                               dtype=jnp.float64)
    n = coord.shape[0]
    ref_msf = np.einsum("iaia->i", ref_cov.reshape(n, 3, n, 3))
    assert np.allclose(np.asarray(out["msf"]), ref_msf, atol=1e-8)
    assert np.allclose(np.asarray(out["bfactor"]),
                       8 * np.pi**2 / 3 * ref_msf, atol=1e-7)


def test_anm_spectral_matches_eigh_pipeline(ca_1l2y):
    """The eigh-free spectral pipeline (banded eigenvalues + Cholesky
    covariance + shift-invert modes off one factorization) reproduces
    the dense-eigh pipeline's observables."""
    from springcraft_tpu.parallel import anm_spectral

    ff = sc.InvariantForceField(13.0)
    params = ff.to_params()
    coord = ca_1l2y.coord.astype(np.float64)

    ref = anm_observables(coord, params, dtype=jnp.float64, with_dcc=True)
    out = anm_spectral(coord, params, dtype=jnp.float64, with_dcc=True,
                       n_modes=4, n_iter_bisect=60)

    assert np.allclose(out["eig_values"], ref["eig_values"], atol=1e-9)
    assert np.allclose(out["frequencies"][6:], ref["frequencies"][6:],
                       rtol=1e-8)
    assert np.allclose(out["msf"], ref["msf"], atol=1e-9)
    assert np.allclose(out["bfactor"], ref["bfactor"], atol=1e-8)
    assert np.allclose(out["dcc"], ref["dcc"], atol=1e-8)
    # Mode shapes: compare |<u_got, u_ref>| ~ 1 per mode (sign-free)
    assert np.allclose(out["mode_values"],
                       np.asarray(ref["eig_values"])[6:10], rtol=1e-9)
    ref_vecs = np.asarray(ref["eig_vectors"])[6:10]
    got_vecs = np.asarray(out["mode_vectors"])
    overlap = np.abs(np.sum(got_vecs * ref_vecs, axis=1))
    assert np.all(overlap > 1 - 1e-8)


def test_ensemble_anm_spectral_shapes():
    from springcraft_tpu.parallel import ensemble_anm_spectral

    params = ffparams.invariant_params(9.0)
    coords = _conformers(3, 24, seed=8)
    out = ensemble_anm_spectral(coords, params, dtype=jnp.float64,
                                n_modes=2)
    assert out["eig_values"].shape == (3, 72)
    assert out["msf"].shape == (3, 24)
    assert out["mode_vectors"].shape == (3, 2, 72)


def test_ensemble_anm_spectral_matches_single():
    from springcraft_tpu.parallel import anm_spectral, ensemble_anm_spectral

    params = ffparams.invariant_params(9.0)
    coords = _conformers(3, 24, seed=9)
    out = ensemble_anm_spectral(coords, params, dtype=jnp.float64,
                                n_modes=3, n_iter_bisect=60)
    for i in range(3):
        one = anm_spectral(coords[i], params, dtype=jnp.float64,
                           n_modes=3, n_iter_bisect=60)
        assert np.allclose(out["eig_values"][i], one["eig_values"],
                           atol=1e-10)
        assert np.allclose(out["msf"][i], one["msf"], atol=1e-10)
        assert np.allclose(out["dcc"][i], one["dcc"], atol=1e-9)
        assert np.allclose(out["mode_values"][i], one["mode_values"],
                           rtol=1e-9)


def test_gnm_spectral_matches_eigh_pipeline(ca_1l2y):
    from springcraft_tpu.parallel import gnm_spectral

    ff = sc.InvariantForceField(7.0)
    params = ff.to_params()
    coord = ca_1l2y.coord.astype(np.float64)

    ref = gnm_observables(coord, params, dtype=jnp.float64, with_dcc=True)
    out = gnm_spectral(coord, params, dtype=jnp.float64, with_dcc=True,
                       n_iter_bisect=60)
    assert np.allclose(out["eig_values"], ref["eig_values"], atol=1e-9)
    assert np.allclose(out["frequencies"][1:], ref["frequencies"][1:],
                       rtol=1e-8)
    assert np.allclose(out["msf"], ref["msf"], atol=1e-9)
    assert np.allclose(out["dcc"], ref["dcc"], atol=1e-8)
