"""
Matrix-free operator tests: ``hessian_apply`` / ``kirchhoff_apply`` /
the block-sparse Pallas apply must match the dense assembly exactly, and
the Chebyshev-filtered mode solver must reproduce the dense
eigensolver's lowest non-trivial modes.

The block-sparse kernel is compiled for CUDA GPUs only; here it runs in
the Pallas interpreter (``interpret=True`` or the ``sparse_interpret``
fixture).  Its compiled form is checked by the chip-marked tests in
``tests/test_chip.py``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

import springcraft_tpu as sc
from springcraft_tpu.ops import assembly, ffparams, matfree, rigid

from .util import random_coord


@pytest.fixture
def sparse_interpret(monkeypatch):
    """Route the solvers' block-sparse applies through the Pallas
    interpreter."""
    for name in ("hessian_apply_pallas_sparse",
                 "kirchhoff_apply_pallas_sparse"):
        monkeypatch.setattr(matfree, name, functools.partial(
            getattr(matfree, name), interpret=True))


def _params_for(kind, two_chain_ca=None, n=None):
    if kind == "invariant":
        return ffparams.invariant_params(13.0)
    if kind == "hinsen":
        return ffparams.hinsen_params(14.0)
    if kind == "pfenm":
        return ffparams.pfenm_params(None)
    if kind == "table_compact":
        return sc.TabulatedForceField.sd_enm(two_chain_ca)\
            .to_compact_params()
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["invariant", "hinsen", "pfenm"])
def test_hessian_apply_matches_dense(kind):
    coord = random_coord(3, 90, box=40.0)
    params = _params_for(kind)
    dense = assembly.hessian_matrix(coord, params, jnp,
                                    dtype=jnp.float64, layout="xyz")
    rng = np.random.RandomState(0)
    x = rng.randn(dense.shape[0], 5)
    # block smaller than n and not dividing it: exercises padding
    y = matfree.hessian_apply(coord, x, params, block=32,
                              dtype=jnp.float64)
    assert np.allclose(np.asarray(y), np.asarray(dense) @ x,
                       rtol=1e-10, atol=1e-10)


def test_hessian_apply_tabulated(two_chain_ca):
    ff = sc.TabulatedForceField.sd_enm(two_chain_ca)
    params = ff.to_compact_params()
    coord = np.asarray(two_chain_ca.coord, dtype=np.float64)
    dense = assembly.hessian_matrix(coord, params, jnp,
                                    dtype=jnp.float64, layout="xyz")
    rng = np.random.RandomState(1)
    x = rng.randn(dense.shape[0], 3)
    y = matfree.hessian_apply(coord, x, params, block=16,
                              dtype=jnp.float64)
    assert np.allclose(np.asarray(y), np.asarray(dense) @ x,
                       rtol=1e-9, atol=1e-9)


def test_hessian_apply_single_vector_shape():
    coord = random_coord(5, 40, box=30.0)
    params = ffparams.invariant_params(12.0)
    x = np.random.RandomState(2).randn(120)
    y = matfree.hessian_apply(coord, x, params, block=16,
                              dtype=jnp.float64)
    assert y.shape == (120,)
    dense = assembly.hessian_matrix(coord, params, jnp,
                                    dtype=jnp.float64, layout="xyz")
    assert np.allclose(np.asarray(y), np.asarray(dense) @ x, atol=1e-10)


def test_kirchhoff_apply_matches_dense():
    coord = random_coord(7, 70, box=35.0)
    params = ffparams.invariant_params(11.0)
    dense = assembly.kirchhoff_matrix(coord, params, jnp,
                                      dtype=jnp.float64)
    x = np.random.RandomState(3).randn(70, 4)
    y = matfree.kirchhoff_apply(coord, x, params, block=32,
                                dtype=jnp.float64)
    assert np.allclose(np.asarray(y), np.asarray(dense) @ x, atol=1e-10)


def test_spatial_sort_is_permutation():
    coord = random_coord(31, 333, box=60.0)
    perm = matfree.spatial_sort_permutation(coord)
    assert sorted(perm) == list(range(333))
    # sorted layout is more compact: mean distance between consecutive
    # atoms shrinks
    def mean_step(c):
        return np.linalg.norm(np.diff(c, axis=0), axis=1).mean()
    assert mean_step(coord[perm]) < mean_step(coord)


def test_tile_neighbor_lists_conservative():
    coord = random_coord(37, 200, box=50.0)
    perm = matfree.spatial_sort_permutation(coord)
    sc_coord = coord[perm]
    cutoff = 11.0
    tile = 16
    nbr, counts = matfree.tile_neighbor_lists(sc_coord, cutoff, tile)
    assert nbr.shape == (counts.sum(),)
    rows = np.repeat(np.arange(counts.shape[0]), counts)
    listed = set(zip(rows.tolist(), nbr.tolist()))
    d = np.linalg.norm(sc_coord[:, None] - sc_coord[None, :], axis=-1)
    ii, jj = np.where((d <= cutoff) & (d > 0))
    for i, j in zip(ii, jj):
        assert (i // tile, j // tile) in listed


@pytest.mark.parametrize("kind", ["invariant", "table_compact"])
def test_hessian_apply_pallas_sparse_matches_dense(kind, two_chain_ca):
    if kind == "table_compact":
        params = sc.TabulatedForceField.sd_enm(two_chain_ca)\
            .to_compact_params()
        coord = np.asarray(two_chain_ca.coord, dtype=np.float64)
    else:
        params = ffparams.invariant_params(9.0)
        coord = random_coord(41, 120, box=36.0)
    n = coord.shape[0]
    dense = np.asarray(assembly.hessian_matrix(
        coord, params, jnp, dtype=jnp.float64, layout="xyz"))
    x = np.random.RandomState(9).randn(3 * n, 5)

    # spatially sorted layout with original-id bookkeeping
    perm = matfree.spatial_sort_permutation(coord)
    sc_coord = coord[perm]
    cutoff = float(np.sqrt(params.cutoff_sq))
    tile = 16
    nbr, counts = matfree.tile_neighbor_lists(sc_coord, cutoff, tile)
    if kind == "table_compact":
        import dataclasses

        params_s = dataclasses.replace(
            params,
            type_idx=np.asarray(params.type_idx)[perm],
            chain_code=np.asarray(params.chain_code)[perm],
            bonded_next=np.asarray(params.bonded_next)[perm],
        )
    else:
        params_s = params
    x_sorted = x.reshape(3, n, -1)[:, perm].reshape(3 * n, -1)
    y = matfree.hessian_apply_pallas_sparse(
        sc_coord, x_sorted, params_s, nbr, counts,
        orig_ids=perm.astype(np.int32), tile=tile, dtype=jnp.float64,
        interpret=True)
    y_ref = (dense @ x).reshape(3, n, -1)[:, perm].reshape(3 * n, -1)
    scale = np.max(np.abs(y_ref)) or 1.0
    assert np.max(np.abs(np.asarray(y) - y_ref)) / scale < 1e-10


def test_lowest_modes_matfree_sparse_path(sparse_interpret):
    coord = random_coord(13, 120, box=30.0)  # connected (verified above)
    params = ffparams.invariant_params(12.0)
    dense = np.asarray(assembly.hessian_matrix(
        coord, params, jnp, dtype=jnp.float64, layout="xyz"))
    ref_vals, ref_vecs = np.linalg.eigh(dense)

    vals, vecs, res = matfree.lowest_modes_matfree(
        coord, params, 4, degree=40, n_outer=12, tile=16,
        sparse=True, dtype=jnp.float64, tol=5e-7)
    assert np.max(np.asarray(res)) < 1e-6
    assert np.allclose(np.asarray(vals), ref_vals[6:10], rtol=1e-6)
    # modes come back in the ORIGINAL atom order
    u = np.asarray(vecs).T
    v = ref_vecs[:, 6:10]
    overlap = np.linalg.norm(u.T @ v, ord=2)
    assert overlap > 1 - 1e-6


def test_kirchhoff_apply_pallas_sparse_matches_dense(two_chain_ca):
    params = sc.TabulatedForceField.sd_enm(two_chain_ca)\
        .to_compact_params()
    coord = np.asarray(two_chain_ca.coord, dtype=np.float64)
    n = coord.shape[0]
    dense = np.asarray(assembly.kirchhoff_matrix(
        coord, params, jnp, dtype=jnp.float64))
    x = np.random.RandomState(10).randn(n, 4)

    perm = matfree.spatial_sort_permutation(coord)
    sc_coord = coord[perm]
    cutoff = float(np.sqrt(params.cutoff_sq))
    tile = 16
    nbr, counts = matfree.tile_neighbor_lists(sc_coord, cutoff, tile)
    import dataclasses

    params_s = dataclasses.replace(
        params,
        type_idx=np.asarray(params.type_idx)[perm],
        chain_code=np.asarray(params.chain_code)[perm],
        bonded_next=np.asarray(params.bonded_next)[perm],
    )
    y = matfree.kirchhoff_apply_pallas_sparse(
        sc_coord, x[perm], params_s, nbr, counts,
        orig_ids=perm.astype(np.int32), tile=tile, dtype=jnp.float64,
        interpret=True)
    y_ref = (dense @ x)[perm]
    scale = np.max(np.abs(y_ref)) or 1.0
    assert np.max(np.abs(np.asarray(y) - y_ref)) / scale < 1e-10


@pytest.mark.parametrize("sparse", [False, True])
def test_lowest_modes_matfree_gnm(sparse, sparse_interpret):
    coord = random_coord(13, 120, box=30.0)
    params = ffparams.invariant_params(12.0)
    dense = np.asarray(assembly.kirchhoff_matrix(
        coord, params, jnp, dtype=jnp.float64))
    ref_vals = np.linalg.eigvalsh(dense)
    assert ref_vals[0] < 1e-8 < ref_vals[1]  # connected: one null mode

    vals, vecs, res = matfree.lowest_modes_matfree_gnm(
        coord, params, 4, degree=40, n_outer=12, tol=5e-7, tile=16, block=64,
        sparse=sparse, dtype=jnp.float64)
    assert np.max(np.asarray(res)) < 1e-6
    assert np.allclose(np.asarray(vals), ref_vals[1:5], rtol=1e-6)


def test_gnm_model_lowest_modes(ca_1l2y):
    gnm = sc.GNM(ca_1l2y, sc.InvariantForceField(7.0), masses=True)
    ref_vals, ref_vecs = gnm.eigen()
    for matrix_free in (False, True):
        options = (dict(degree=40, n_outer=12, tol=5e-6, dtype=jnp.float64)
                   if matrix_free else dict(dtype=jnp.float64))
        vals, vecs, res = gnm.lowest_modes(3, matrix_free=matrix_free,
                                           **options)
        assert np.max(np.asarray(res)) < 1e-5
        assert np.allclose(np.asarray(vals), np.asarray(ref_vals[1:4]),
                           rtol=1e-5)


def test_lowest_modes_matfree_sparse_tabulated(two_chain_ca,
                                              sparse_interpret):
    """Sparse path with a tabulated FF: the spectral bound must be
    taken on the ORIGINAL ordering (a Morton-permuted bonded test
    misclassifies peptide bonds and can under-estimate lambda_max,
    which the Chebyshev filter cannot tolerate)."""
    ff = sc.TabulatedForceField.sd_enm(two_chain_ca)
    params = ff.to_compact_params()
    coord = np.asarray(two_chain_ca.coord, dtype=np.float64)
    dense = np.asarray(assembly.hessian_matrix(
        coord, params, jnp, dtype=jnp.float64, layout="xyz"))
    ref_vals = np.linalg.eigvalsh(dense)
    assert ref_vals[5] < 1e-6 < ref_vals[6]  # connected

    bound = float(matfree.hessian_degree_bound(coord, params,
                                               dtype=jnp.float64))
    assert ref_vals[-1] <= bound

    vals, vecs, res = matfree.lowest_modes_matfree(
        coord, params, 3, degree=40, n_outer=14, tile=16,
        sparse=True, dtype=jnp.float64)
    assert np.max(np.asarray(res)) < 1e-5
    assert np.allclose(np.asarray(vals), ref_vals[6:9], rtol=1e-5)


def test_matfree_rejects_dense_families(two_chain_ca):
    ff = sc.TabulatedForceField.sd_enm(two_chain_ca)
    pair_params = ff.to_params()  # table_pair: O(n^2) parameters
    coord = np.asarray(two_chain_ca.coord)
    x = np.zeros(3 * coord.shape[0])
    with pytest.raises(ValueError, match="matrix-free"):
        matfree.hessian_apply(coord, x, pair_params)


def test_lowest_modes_matfree_matches_dense():
    coord = random_coord(13, 120, box=30.0)  # dense enough to be connected
    params = ffparams.invariant_params(12.0)
    dense = assembly.hessian_matrix(coord, params, jnp,
                                    dtype=jnp.float64, layout="xyz")
    ref_vals, ref_vecs = np.linalg.eigh(np.asarray(dense))
    assert ref_vals[5] < 1e-8 < ref_vals[6]  # connected: exactly 6 nulls

    k = 5
    vals, vecs, res = matfree.lowest_modes_matfree(
        coord, params, k, degree=40, n_outer=12, tol=5e-7, block=64,
        dtype=jnp.float64)
    vals = np.asarray(vals)
    assert np.max(np.asarray(res)) < 1e-6
    assert np.allclose(vals, ref_vals[6:6 + k], rtol=1e-6)
    # Mode subspace agreement (sign/rotation free): projector overlap
    u = np.asarray(vecs).T
    v = ref_vecs[:, 6:6 + k]
    overlap = np.linalg.norm(u.T @ v, ord=2)
    assert overlap > 1 - 1e-6


def test_lowest_modes_matfree_mass_weighted():
    coord = random_coord(17, 100, box=28.0)
    params = ffparams.invariant_params(12.0)
    rng = np.random.RandomState(5)
    masses = 50.0 + 100.0 * rng.rand(100)

    dense = np.asarray(assembly.hessian_matrix(
        coord, params, jnp, dtype=jnp.float64, layout="xyz"))
    w = 1.0 / np.sqrt(np.repeat(masses[None, :], 3, axis=0).ravel())
    wh = dense * np.outer(w, w)
    ref_vals = np.linalg.eigvalsh(wh)

    vals, vecs, res = matfree.lowest_modes_matfree(
        coord, params, 4, masses=masses, degree=40, n_outer=12, tol=5e-7,
        block=64, dtype=jnp.float64)
    assert np.max(np.asarray(res)) < 1e-6
    assert np.allclose(np.asarray(vals), ref_vals[6:10], rtol=1e-6)

    # residual checker reproduces the in-solver residuals
    res2 = matfree.matfree_mode_residuals(
        coord, params, vals, vecs, masses=masses, block=64,
        dtype=jnp.float64)
    assert np.max(np.asarray(res2)) < 1e-6


def test_sharded_hessian_apply_matches_dense(two_chain_ca):
    from springcraft_tpu.parallel import make_mesh
    from springcraft_tpu.parallel.sharded import sharded_hessian_apply

    mesh = make_mesh(8)
    # n divisible by the mesh size; tabulated family exercises the
    # metadata plumbing through shard_map
    ff = sc.TabulatedForceField.sd_enm(two_chain_ca[:40])
    params = ff.to_compact_params()
    coord = np.asarray(two_chain_ca.coord[:40], dtype=np.float64)
    dense = assembly.hessian_matrix(coord, params, jnp,
                                    dtype=jnp.float64, layout="xyz")
    x = np.random.RandomState(6).randn(120, 4)
    y = sharded_hessian_apply(coord, x, params, mesh, block=5,
                              dtype=jnp.float64)
    assert np.allclose(np.asarray(y), np.asarray(dense) @ x, atol=1e-9)


def test_sharded_lowest_modes_matfree(two_chain_ca):
    from springcraft_tpu.parallel import make_mesh
    from springcraft_tpu.parallel.sharded import (
        sharded_lowest_modes_matfree,
    )

    mesh = make_mesh(8, row_axis=2)
    # same configuration as test_lowest_modes_matfree_matches_dense,
    # verified there to be a connected network (exactly 6 null modes)
    coord = random_coord(13, 120, box=30.0)
    params = ffparams.invariant_params(12.0)
    dense = np.asarray(assembly.hessian_matrix(
        coord, params, jnp, dtype=jnp.float64, layout="xyz"))
    ref_vals = np.linalg.eigvalsh(dense)

    vals, vecs, res = sharded_lowest_modes_matfree(
        coord, params, mesh, 4, degree=40, n_outer=12, tol=5e-7, block=12,
        dtype=jnp.float64)
    assert np.max(np.asarray(res)) < 1e-6
    assert np.allclose(np.asarray(vals), ref_vals[6:10], rtol=1e-6)


@pytest.mark.parametrize("matrix_free", [False, True])
@pytest.mark.parametrize("masses", [None, True])
def test_anm_lowest_modes_matches_eigen(ca_1l2y, matrix_free, masses):
    anm = sc.ANM(ca_1l2y, sc.InvariantForceField(13.0), masses=masses)
    ref_vals, ref_vecs = anm.eigen()
    k = 3
    options = (dict(degree=40, n_outer=12, tol=5e-6, dtype=jnp.float64)
               if matrix_free else dict(dtype=jnp.float64))
    vals, vecs, res = anm.lowest_modes(k, matrix_free=matrix_free,
                                       **options)
    assert np.max(np.asarray(res)) < 1e-5
    assert np.allclose(np.asarray(vals), np.asarray(ref_vals[6:6 + k]),
                       rtol=1e-5)
    u = np.asarray(vecs).T
    v = np.asarray(ref_vecs[6:6 + k]).T
    overlap = np.linalg.norm(u.T @ v, ord=2)
    assert overlap > 1 - 1e-5


@pytest.mark.parametrize("masses", [None, True])
def test_anm_lowest_modes_refine_f64(ca_1l2y, masses):
    """f32 device solve + refine=True must hit the north-star 1e-6
    eigenvalue rtol vs the f64 eigensystem."""
    anm = sc.ANM(ca_1l2y, sc.InvariantForceField(13.0), masses=masses)
    ref_vals, _ = anm.eigen()   # host f64 (NumPy backend)
    k = 3
    vals, vecs, res = anm.lowest_modes(k, refine=True, refine_block=7)
    truth = np.asarray(ref_vals[6:6 + k], dtype=np.float64)
    assert vals.dtype == np.float64
    assert np.max(np.abs(vals - truth) / truth) <= 1e-6
    assert np.all(np.asarray(res) < 1e-4)
    assert vecs.shape == (k, 3 * ca_1l2y.array_length())


def test_kirchhoff_degree_matches_diagonal(ca_1l2y):
    coord = np.asarray(ca_1l2y.coord, np.float64)
    params = ffparams.invariant_params(9.0)
    k64 = np.asarray(assembly.kirchhoff_matrix(coord, params, np,
                                               dtype=np.float64))
    deg = matfree.kirchhoff_degree(jnp.asarray(coord), params, block=8,
                                   dtype=jnp.float64)
    assert np.allclose(np.asarray(deg), np.diagonal(k64), atol=1e-10)


@pytest.mark.parametrize("precond", [True, False])
def test_gnm_dcc_rows_matfree_match_dense(ca_1l2y, precond):
    gnm = sc.GNM(ca_1l2y, sc.InvariantForceField(7.0))
    dcc_norm = np.asarray(gnm.dcc(norm=True))
    dcc_raw = np.asarray(gnm.dcc(norm=False))
    msf = np.asarray(gnm.mean_square_fluctuation())

    coord = np.asarray(ca_1l2y.coord, dtype=np.float64)
    params = ffparams.invariant_params(7.0)
    sites = [0, 9, 19]
    rows_raw, n_it, res = matfree.dcc_rows_matfree_gnm(
        coord, params, sites, norm=False, tol=1e-11, block=16,
        dtype=jnp.float64, precond=precond)
    assert np.max(np.asarray(res)) < 1e-9
    assert np.allclose(np.asarray(rows_raw), dcc_raw[sites],
                       rtol=1e-6, atol=1e-10)

    rows_norm, _, _ = matfree.dcc_rows_matfree_gnm(
        coord, params, sites, norm=True, msf=msf, tol=1e-11, block=16,
        dtype=jnp.float64, precond=precond)
    assert np.allclose(np.asarray(rows_norm), dcc_norm[sites],
                       rtol=1e-6, atol=1e-9)


def test_gnm_dcc_matrix_free_surface(ca_1l2y):
    gnm = sc.GNM(ca_1l2y, sc.InvariantForceField(7.0))
    dense = np.asarray(gnm.dcc(norm=True))
    msf = np.asarray(gnm.mean_square_fluctuation())
    sites = [3, 14]
    rows = gnm.dcc(matrix_free=True, sites=sites, msf=msf, tol=1e-10,
                   block=16, dtype=jnp.float64)
    assert rows.shape == (2, ca_1l2y.array_length())
    assert np.allclose(rows, dense[sites], rtol=1e-5, atol=1e-8)

    with pytest.raises(ValueError, match="sites"):
        gnm.dcc(matrix_free=True)
    with pytest.raises(ValueError, match="msf"):
        matfree.dcc_rows_matfree_gnm(
            np.asarray(ca_1l2y.coord), ffparams.invariant_params(7.0),
            sites, norm=True)


def test_gnm_lowest_modes_refine_f64(ca_1l2y):
    gnm = sc.GNM(ca_1l2y, sc.InvariantForceField(7.0))
    ref_vals, _ = gnm.eigen()   # host f64 (NumPy backend)
    k = 3
    vals, vecs, res = gnm.lowest_modes(k, refine=True, refine_block=9)
    truth = np.asarray(ref_vals[1:1 + k], dtype=np.float64)
    assert vals.dtype == np.float64
    assert np.max(np.abs(vals - truth) / truth) <= 1e-6
    assert vecs.shape == (k, ca_1l2y.array_length())
    assert np.all(np.asarray(res) < 1e-4)


def test_estimate_lambda_max_bounds_spectrum():
    coord = random_coord(19, 80, box=30.0)
    params = ffparams.invariant_params(12.0)
    dense = np.asarray(assembly.hessian_matrix(
        coord, params, jnp, dtype=jnp.float64, layout="xyz"))
    lam_true = np.linalg.eigvalsh(dense)[-1]

    def matvec(x):
        return matfree.hessian_apply(coord, x, params, block=64,
                                     dtype=jnp.float64)

    est = float(matfree.estimate_lambda_max(matvec, dense.shape[0],
                                            dtype=jnp.float64))
    assert lam_true <= est <= 1.5 * lam_true


@pytest.mark.parametrize("weighted", [False, True])
def test_hessian_degree_bound(weighted):
    coord = random_coord(29, 80, box=30.0)
    params = ffparams.invariant_params(12.0)
    masses = (50.0 + 100.0 * np.random.RandomState(8).rand(80)
              if weighted else None)
    dense = np.asarray(assembly.hessian_matrix(
        coord, params, jnp, dtype=jnp.float64, layout="xyz"))
    if weighted:
        w = 1.0 / np.sqrt(np.repeat(masses[None, :], 3, axis=0).ravel())
        dense = dense * np.outer(w, w)
    lam_true = np.linalg.eigvalsh(dense)[-1]
    bound = float(matfree.hessian_degree_bound(
        coord, params, masses=masses, block=32, dtype=jnp.float64))
    # a true upper bound, and not absurdly loose
    assert lam_true <= bound <= 4.0 * lam_true


def test_ensemble_anm_banded_matches_eigh_pipeline():
    from springcraft_tpu.parallel import ensemble_anm, ensemble_anm_banded

    rng = np.random.RandomState(21)
    base = rng.rand(40, 3) * 18.0
    coords = base[None] + 0.05 * rng.randn(6, 40, 3)
    params = ffparams.invariant_params(12.0)

    ref = ensemble_anm(coords, params, dtype=jnp.float64, with_dcc=True)
    got = ensemble_anm_banded(coords, params, dtype=jnp.float64,
                              with_dcc=True, bandwidth=4)
    assert np.allclose(np.asarray(got["eig_values"]),
                       np.asarray(ref["eig_values"]), atol=1e-8)
    for key in ("msf", "bfactor", "dcc", "frequencies"):
        assert np.allclose(np.asarray(got[key]), np.asarray(ref[key]),
                           rtol=1e-6, atol=1e-8), key


def test_ensemble_gnm_banded_matches_eigh_pipeline():
    from springcraft_tpu.parallel import ensemble_gnm, ensemble_gnm_banded

    rng = np.random.RandomState(22)
    base = rng.rand(50, 3) * 20.0
    coords = base[None] + 0.05 * rng.randn(5, 50, 3)
    params = ffparams.invariant_params(11.0)
    masses = 50.0 + 100.0 * rng.rand(50)

    ref = ensemble_gnm(coords, params, masses=masses,
                       dtype=jnp.float64, with_dcc=True)
    got = ensemble_gnm_banded(coords, params, masses=masses,
                              dtype=jnp.float64, with_dcc=True,
                              bandwidth=4)
    assert np.allclose(np.asarray(got["eig_values"]),
                       np.asarray(ref["eig_values"]), atol=1e-8)
    for key in ("msf", "bfactor", "dcc", "frequencies"):
        assert np.allclose(np.asarray(got[key]), np.asarray(ref[key]),
                           rtol=1e-6, atol=1e-8), key


def test_sparse_apply_unsorted_layout(two_chain_ca):
    """Without a spatial sort (default ``orig_ids``) the block-sparse
    applies still match the dense operators: the neighbour lists are
    conservative in any atom order."""
    params = sc.TabulatedForceField.sd_enm(two_chain_ca)\
        .to_compact_params()
    coord = np.asarray(two_chain_ca.coord, dtype=np.float64)
    n = coord.shape[0]
    dense = np.asarray(assembly.hessian_matrix(
        coord, params, jnp, dtype=jnp.float64, layout="xyz"))
    kdense = np.asarray(assembly.kirchhoff_matrix(
        coord, params, jnp, dtype=jnp.float64))
    x = np.random.RandomState(12).randn(3 * n, 4)
    xk = np.random.RandomState(13).randn(n, 4)

    tile = 16
    nbr, counts = matfree.tile_neighbor_lists(
        coord, float(np.sqrt(params.cutoff_sq)), tile)
    y = matfree.hessian_apply_pallas_sparse(
        coord, x, params, nbr, counts, tile=tile, dtype=jnp.float64,
        interpret=True)
    assert np.allclose(np.asarray(y), dense @ x, atol=1e-10)

    yk = matfree.kirchhoff_apply_pallas_sparse(
        coord, xk, params, nbr, counts, tile=tile, dtype=jnp.float64,
        interpret=True)
    assert np.allclose(np.asarray(yk), kdense @ xk, atol=1e-10)


@pytest.mark.parametrize("tile", [8, 24, 48])
def test_sparse_apply_rejects_bad_tile(tile):
    """Tiles must be powers of two >= 16 (Triton block shapes and the
    16-wide minimum of a dot operand)."""
    coord = random_coord(3, 40, box=20.0)
    params = ffparams.invariant_params(9.0)
    nbr, counts = matfree.tile_neighbor_lists(coord, 9.0, tile)
    with pytest.raises(ValueError, match="power of two"):
        matfree.hessian_apply_pallas_sparse(
            coord, np.ones((120, 2)), params, nbr, counts, tile=tile,
            interpret=True)


def test_sparse_apply_rejects_mismatched_lists():
    coord = random_coord(3, 40, box=20.0)
    params = ffparams.invariant_params(9.0)
    nbr, counts = matfree.tile_neighbor_lists(coord, 9.0, 32)
    with pytest.raises(ValueError, match="tile_neighbor_lists"):
        matfree.hessian_apply_pallas_sparse(
            coord, np.ones((120, 2)), params, nbr, counts, tile=16,
            interpret=True)


def test_vector_block_width():
    """The sparse kernel pads the vector block to a power of two of at
    least 16 columns, and the solvers' default oversampling fills it."""
    assert [matfree._vector_block_width(k) for k in (1, 16, 17, 28, 33)] \
        == [16, 16, 32, 32, 64]
    assert matfree._oversample(14, None, sparse=True) == 18
    assert matfree._oversample(14, None, sparse=False) == 14
    assert matfree._oversample(14, 3, sparse=True) == 3


def test_hessian_diag_blocks_match_dense(two_chain_ca):
    params = sc.TabulatedForceField.sd_enm(two_chain_ca)\
        .to_compact_params()
    coord = np.asarray(two_chain_ca.coord, dtype=np.float64)
    n = coord.shape[0]
    dense = np.asarray(assembly.hessian_matrix(
        coord, params, jnp, dtype=jnp.float64, layout="xyz"))
    blocks = np.asarray(matfree.hessian_diag_blocks(
        coord, params, block=16, dtype=jnp.float64))
    for i in range(0, n, 7):
        ref = np.array([[dense[a * n + i, b * n + i] for b in range(3)]
                        for a in range(3)])
        assert np.allclose(blocks[i], ref, atol=1e-10), i


@pytest.mark.parametrize("sparse", [False, True])
def test_covariance_solve_matfree(sparse, sparse_interpret):
    coord = random_coord(13, 120, box=30.0)  # connected
    params = ffparams.invariant_params(12.0)
    dense = np.asarray(assembly.hessian_matrix(
        coord, params, jnp, dtype=jnp.float64, layout="xyz"))
    from springcraft_tpu.ops import linalg

    cov = np.asarray(linalg.pinvh(jnp.asarray(dense)))
    rhs = np.random.RandomState(14).randn(360, 3)

    x, n_it, res = matfree.covariance_solve_matfree(
        coord, params, rhs, tol=1e-10, tile=16, block=64,
        sparse=sparse, dtype=jnp.float64)
    assert np.max(np.asarray(res)) < 1e-9
    assert int(n_it) < 1000
    assert np.allclose(np.asarray(x), cov @ rhs, rtol=1e-6, atol=1e-8)


def test_linear_response_matfree_matches_model(ca_1l2y):
    anm = sc.ANM(ca_1l2y, sc.InvariantForceField(13.0))
    n = ca_1l2y.array_length()
    force = np.zeros((n, 3))
    force[3, 1] = 8.0
    force[11, 0] = -4.0
    ref = np.asarray(anm.linear_response(force))

    coord = np.asarray(ca_1l2y.coord, dtype=np.float64)
    params = ffparams.invariant_params(13.0)
    disp, n_it, res = matfree.linear_response_matfree(
        coord, params, force, tol=1e-10, block=32,
        dtype=jnp.float64)
    assert np.max(np.asarray(res)) < 1e-9
    assert np.allclose(np.asarray(disp), ref, rtol=1e-6, atol=1e-9)

    # flat (3n,) input matches too (reference accepts both layouts)
    disp_flat, _, _ = matfree.linear_response_matfree(
        coord, params, force.ravel(), tol=1e-10, block=32, dtype=jnp.float64)
    assert np.allclose(np.asarray(disp_flat), ref.ravel(), rtol=1e-6,
                       atol=1e-9)


def test_anm_linear_response_matrix_free(ca_1l2y):
    anm = sc.ANM(ca_1l2y, sc.InvariantForceField(13.0), masses=True)
    n = ca_1l2y.array_length()
    force = np.zeros((n, 3))
    force[5, 2] = 3.0
    ref = np.asarray(anm.linear_response(force))
    got = anm.linear_response(force, matrix_free=True, tol=1e-10,
                              block=32,
                              dtype=jnp.float64)
    assert np.allclose(np.asarray(got), ref, rtol=1e-6, atol=1e-9)

    flat = anm.linear_response(force.ravel(), matrix_free=True,
                               tol=1e-10, block=32,
                               dtype=jnp.float64)
    assert np.allclose(np.asarray(flat), ref, rtol=1e-6, atol=1e-9)


def test_prs_rows_matfree_match_dense(ca_1l2y):
    anm = sc.ANM(ca_1l2y, sc.InvariantForceField(13.0))
    prs_full, _, _ = anm.prs_effector_sensor(norm=True)
    prs_full = np.asarray(prs_full)

    coord = np.asarray(ca_1l2y.coord, dtype=np.float64)
    params = ffparams.invariant_params(13.0)
    sites = [0, 7, 19]
    rows, n_it, res = matfree.prs_rows_matfree(
        coord, params, sites, tol=1e-11, block=32,
        dtype=jnp.float64)
    assert np.max(np.asarray(res)) < 1e-9
    assert np.allclose(np.asarray(rows), prs_full[sites], rtol=1e-5,
                       atol=1e-9)

    rows_raw, _, _ = matfree.prs_rows_matfree(
        coord, params, sites, norm=False, tol=1e-11, block=32,
        dtype=jnp.float64)
    prs_raw, _, _ = anm.prs_effector_sensor(norm=False)
    assert np.allclose(np.asarray(rows_raw), np.asarray(prs_raw)[sites],
                       rtol=1e-5, atol=1e-12)


def test_dcc_rows_matfree_match_dense(ca_1l2y):
    anm = sc.ANM(ca_1l2y, sc.InvariantForceField(13.0))
    dcc_norm = np.asarray(anm.dcc(norm=True))
    dcc_raw = np.asarray(anm.dcc(norm=False))
    msf = np.asarray(anm.mean_square_fluctuation())

    coord = np.asarray(ca_1l2y.coord, dtype=np.float64)
    params = ffparams.invariant_params(13.0)
    sites = [0, 7, 19]
    rows_raw, n_it, res = matfree.dcc_rows_matfree(
        coord, params, sites, norm=False, tol=1e-11, block=32,
        dtype=jnp.float64)
    assert np.max(np.asarray(res)) < 1e-9
    assert np.allclose(np.asarray(rows_raw), dcc_raw[sites],
                       rtol=1e-6, atol=1e-10)

    rows_norm, _, _ = matfree.dcc_rows_matfree(
        coord, params, sites, norm=True, msf=msf, tol=1e-11, block=32,
        dtype=jnp.float64)
    assert np.allclose(np.asarray(rows_norm), dcc_norm[sites],
                       rtol=1e-6, atol=1e-9)

    with pytest.raises(ValueError, match="msf"):
        matfree.dcc_rows_matfree(coord, params, sites, norm=True)


def test_anm_dcc_matrix_free_surface(ca_1l2y):
    anm = sc.ANM(ca_1l2y, sc.InvariantForceField(13.0))
    dense = np.asarray(anm.dcc(norm=True))
    msf = np.asarray(anm.mean_square_fluctuation())
    sites = [2, 11]
    rows = anm.dcc(matrix_free=True, sites=sites, msf=msf, tol=1e-10,
                   block=32, dtype=jnp.float64)
    assert rows.shape == (2, ca_1l2y.array_length())
    assert np.allclose(rows, dense[sites], rtol=1e-5, atol=1e-8)

    with pytest.raises(ValueError, match="sites"):
        anm.dcc(matrix_free=True)
    with pytest.raises(ValueError, match="mode_subset"):
        anm.dcc(matrix_free=True, sites=sites, msf=msf,
                mode_subset=np.arange(6, 12))


def test_device_solvers_refuse_user_assigned_matrices(ca_1l2y):
    anm = sc.ANM(ca_1l2y, sc.InvariantForceField(13.0))
    n = ca_1l2y.array_length()
    anm.hessian = np.eye(3 * n)
    with pytest.raises(ValueError, match="rebuilds the interaction"):
        anm.lowest_modes(2)
    with pytest.raises(ValueError, match="rebuilds the interaction"):
        anm.linear_response(np.zeros((n, 3)), matrix_free=True)

    gnm = sc.GNM(ca_1l2y, sc.InvariantForceField(7.0))
    gnm.covariance = np.eye(n)
    with pytest.raises(ValueError, match="rebuilds the interaction"):
        gnm.lowest_modes(2)


def test_linear_response_matrix_free_unconverged_raises(ca_1l2y):
    anm = sc.ANM(ca_1l2y, sc.InvariantForceField(13.0))
    n = ca_1l2y.array_length()
    force = np.zeros((n, 3))
    force[0, 0] = 1.0
    with pytest.raises(ValueError, match="did not converge"):
        anm.linear_response(force, matrix_free=True, tol=1e-12,
                            max_iter=2, block=32,
                            dtype=jnp.float64)


def test_linear_response_matfree_bad_shapes_raise_valueerror():
    coord = random_coord(43, 30, box=20.0)
    params = ffparams.invariant_params(12.0)
    with pytest.raises(ValueError, match="entries"):
        matfree.linear_response_matfree(coord, params, np.zeros(17))
    with pytest.raises(ValueError, match="shape"):
        matfree.linear_response_matfree(coord, params,
                                        np.zeros((30, 2)))


def test_covariance_solve_with_sharded_matvec():
    from springcraft_tpu.parallel import make_mesh
    from springcraft_tpu.parallel.sharded import sharded_hessian_apply
    import functools

    mesh = make_mesh(8)
    coord = random_coord(13, 120, box=30.0)  # connected
    params = ffparams.invariant_params(12.0)
    dense = np.asarray(assembly.hessian_matrix(
        coord, params, jnp, dtype=jnp.float64, layout="xyz"))
    from springcraft_tpu.ops import linalg

    cov = np.asarray(linalg.pinvh(jnp.asarray(dense)))
    rhs = np.random.RandomState(15).randn(360, 2)

    matvec = functools.partial(sharded_hessian_apply, coord,
                               params=params, mesh=mesh, block=15,
                               dtype=jnp.float64)
    x, n_it, res = matfree.covariance_solve_matfree(
        coord, params, rhs, tol=1e-10, dtype=jnp.float64,
        matvec=matvec)
    assert np.max(np.asarray(res)) < 1e-9
    assert np.allclose(np.asarray(x), cov @ rhs, rtol=1e-6, atol=1e-8)


def test_covariance_solve_stays_finite_past_precision_floor():
    """CG pushed beyond the f32 floor must freeze stagnated columns at
    their last finite iterate, never overflow to NaN."""
    coord = random_coord(13, 120, box=30.0)
    params = ffparams.invariant_params(12.0)
    rhs = np.random.RandomState(16).randn(360, 3).astype(np.float32)
    x, n_it, res = matfree.covariance_solve_matfree(
        coord, params, rhs, tol=1e-12, max_iter=400, block=64,
        dtype=jnp.float32)
    assert np.all(np.isfinite(np.asarray(x)))
    assert np.all(np.isfinite(np.asarray(res)))
    # still a decent f32 solution
    from springcraft_tpu.ops import linalg

    dense = np.asarray(assembly.hessian_matrix(
        coord, params, jnp, dtype=jnp.float64, layout="xyz"))
    cov = np.asarray(linalg.pinvh(jnp.asarray(dense)))
    ref = cov @ rhs
    rel = np.linalg.norm(np.asarray(x) - ref) / np.linalg.norm(ref)
    assert rel < 1e-3


def test_effector_sensor_matfree_match_dense(ca_1l2y):
    """Site effector/sensor values by batched CG columns must match the
    reference-semantics dense profiles (rows of the row-normalized PRS
    averaged over columns / columns averaged over rows)."""
    anm = sc.ANM(ca_1l2y, sc.InvariantForceField(13.0))
    prs_raw, _, _ = anm.prs_effector_sensor(norm=False)
    _, eff_full, sens_full = anm.prs_effector_sensor(norm=True)

    coord = np.asarray(ca_1l2y.coord, dtype=np.float64)
    params = ffparams.invariant_params(13.0)
    sites = [0, 5, 19]
    prs_diag = np.diagonal(np.asarray(prs_raw))

    eff, sens, n_it, res = matfree.effector_sensor_matfree(
        coord, params, sites, prs_diag=prs_diag, tol=1e-11, block=32,
        dtype=jnp.float64)
    assert np.max(np.asarray(res)) < 1e-9
    assert np.allclose(eff, np.asarray(eff_full)[sites], rtol=1e-6)
    assert np.allclose(sens, np.asarray(sens_full)[sites], rtol=1e-6)

    # return_diag exposes the exact all-mode P_ss at the sites (a
    # free by-product of the site columns)
    eff_d, sens_d, _, _, self_p = matfree.effector_sensor_matfree(
        coord, params, sites, prs_diag=prs_diag, return_diag=True,
        tol=1e-11, block=32, dtype=jnp.float64)
    assert np.array_equal(eff_d, eff)
    assert np.allclose(self_p, prs_diag[sites], rtol=1e-8)

    # norm=False needs no prs_diag; both profiles equal the raw
    # averages of the (symmetric) unnormalized folded PRS
    eff_raw, sens_raw, _, _ = matfree.effector_sensor_matfree(
        coord, params, sites, norm=False, tol=1e-11, block=32,
        dtype=jnp.float64)
    n = len(coord)
    raw = np.asarray(prs_raw)
    want = (raw[sites].sum(axis=1) - np.diagonal(raw)[sites]) / (n - 1)
    assert np.allclose(eff_raw, want, rtol=1e-6)
    assert np.allclose(sens_raw, want, rtol=1e-6)

    with pytest.raises(ValueError, match="prs_diag"):
        matfree.effector_sensor_matfree(coord, params, sites)


def test_prs_diag_from_modes_matches_dense(ca_1l2y):
    """With the complete non-trivial mode set the mode-sum folded-PRS
    diagonal equals the dense covariance diagonal exactly; a truncated
    low-mode set converges to ~1% (each mode enters as 1/lambda^2)."""
    anm = sc.ANM(ca_1l2y, sc.InvariantForceField(13.0))
    prs_raw, _, _ = anm.prs_effector_sensor(norm=False)
    exact = np.diagonal(np.asarray(prs_raw))

    vals, vecs = (np.asarray(a) for a in anm.eigen())
    full = matfree.prs_diag_from_modes(vals[6:], vecs[6:],
                                       layout="atom")
    assert np.allclose(full, exact, rtol=1e-8)

    # Truncation converges monotonically (1/lambda^2 weighting); on
    # this 20-atom toy there is little scale separation, so only the
    # trend and the 40-mode point are asserted — at mega scale the
    # low-mode dominance is far stronger.
    errs = [np.max(np.abs(matfree.prs_diag_from_modes(
        vals[6:6 + k], vecs[6:6 + k], layout="atom") - exact) / exact)
        for k in (10, 25, 40)]
    assert errs[0] > errs[1] > errs[2]
    assert errs[2] < 0.15


def test_anm_prs_effector_sensor_matrix_free(ca_1l2y):
    anm = sc.ANM(ca_1l2y, sc.InvariantForceField(13.0))
    prs_raw, eff_full, sens_full = anm.prs_effector_sensor(norm=False)
    _, eff_n, sens_n = anm.prs_effector_sensor(norm=True)
    prs_diag = np.diagonal(np.asarray(
        anm.prs_effector_sensor(norm=False)[0]))

    sites = [2, 11]
    none_mat, eff, sens = anm.prs_effector_sensor(
        matrix_free=True, sites=sites, prs_diag=prs_diag, tol=1e-11,
        block=32, dtype=jnp.float64)
    assert none_mat is None
    assert np.allclose(eff, np.asarray(eff_n)[sites], rtol=1e-6)
    assert np.allclose(sens, np.asarray(sens_n)[sites], rtol=1e-6)

    with pytest.raises(ValueError, match="sites"):
        anm.prs_effector_sensor(matrix_free=True)


def test_effector_sensor_from_modes_matches_dense(ca_1l2y):
    """With the complete non-trivial mode set the O(n k^2) mode-sum
    effector/sensor profiles equal the dense covariance path exactly
    (the spectral expansion is pinv); truncation converges."""
    anm = sc.ANM(ca_1l2y, sc.InvariantForceField(13.0))
    prs_raw, eff_raw, sens_raw = anm.prs_effector_sensor(norm=False)
    _, eff_n, sens_n = anm.prs_effector_sensor(norm=True)
    vals, vecs = (np.asarray(a) for a in anm.eigen())

    eff, sens = matfree.effector_sensor_from_modes(
        vals[6:], vecs[6:], norm=True, layout="atom")
    assert np.allclose(eff, np.asarray(eff_n), rtol=1e-8)
    assert np.allclose(sens, np.asarray(sens_n), rtol=1e-8)

    eff0, sens0 = matfree.effector_sensor_from_modes(
        vals[6:], vecs[6:], norm=False, layout="atom")
    assert np.allclose(eff0, np.asarray(eff_raw), rtol=1e-8)
    # raw folded PRS is symmetric: both profiles coincide
    assert np.allclose(sens0, eff0)
    assert np.allclose(sens0, np.asarray(sens_raw), rtol=1e-8)

    # truncation error decreases with the mode count (1/lambda^2
    # weighting; little scale separation on this 20-atom toy, so only
    # the trend and the 40-mode point are asserted)
    errs = [np.max(np.abs(matfree.effector_sensor_from_modes(
        vals[6:6 + k], vecs[6:6 + k], layout="atom")[1]
        - np.asarray(sens_n)) / np.asarray(sens_n))
        for k in (10, 25, 40)]
    assert errs[0] > errs[2]
    assert errs[2] < 0.25

    with pytest.raises(ValueError, match="layout"):
        matfree.effector_sensor_from_modes(vals[6:], vecs[6:],
                                           layout="plane")
    with pytest.raises(ValueError, match="modes in rows"):
        matfree.effector_sensor_from_modes(vals[6:], vecs[6:].T)


def test_effector_sensor_from_modes_is_rank_k_prs(ca_1l2y):
    """Under truncation the mode-sum profiles are the EXACT profiles of
    the rank-k covariance (the standard mode-truncated PRS) — verified
    against the explicitly built truncated covariance."""
    from springcraft_tpu.ops import nma_core

    anm = sc.ANM(ca_1l2y, sc.InvariantForceField(13.0))
    vals, vecs = (np.asarray(a) for a in anm.eigen())
    k = 14
    vk, uk = vals[6:6 + k], vecs[6:6 + k]
    cov_k = (uk.T / vk) @ uk                   # rank-k covariance
    prs_k = nma_core.prs_matrix(cov_k, np, norm=True)
    eff_ref, sens_ref = nma_core.effector_sensor_profiles(prs_k, np)

    eff, sens = matfree.effector_sensor_from_modes(vk, uk,
                                                   layout="atom")
    assert np.allclose(eff, eff_ref, rtol=1e-10)
    assert np.allclose(sens, sens_ref, rtol=1e-10)

    prs_raw = nma_core.prs_matrix(cov_k, np, norm=False)
    eff0_ref, _ = nma_core.effector_sensor_profiles(prs_raw, np)
    eff0, sens0 = matfree.effector_sensor_from_modes(
        vk, uk, norm=False, layout="atom")
    assert np.allclose(eff0, eff0_ref, rtol=1e-10)
    assert np.allclose(sens0, eff0_ref, rtol=1e-10)


def test_effector_sensor_stochastic_matches_dense(ca_1l2y):
    """Hutchinson stochastic profiles are unbiased for the ALL-MODE
    effector/sensor at every atom: with enough Rademacher probes the
    full-atom estimates converge on the dense reference-semantics
    profiles, and the returned standard errors bound the deviations."""
    anm = sc.ANM(ca_1l2y, sc.InvariantForceField(13.0))
    prs_raw, _, _ = anm.prs_effector_sensor(norm=False)
    _, eff_n, sens_n = anm.prs_effector_sensor(norm=True)
    eff_n, sens_n = np.asarray(eff_n), np.asarray(sens_n)
    prs_diag = np.diagonal(np.asarray(prs_raw))

    coord = np.asarray(ca_1l2y.coord, dtype=np.float64)
    params = ffparams.invariant_params(13.0)
    eff, sens, eff_sem, sens_sem, n_it, res = (
        matfree.effector_sensor_stochastic(
            coord, params, prs_diag, probes=512, seed=3, tol=1e-10,
            block=32, dtype=jnp.float64))
    assert np.max(np.asarray(res)) < 1e-8
    # The estimates are unbiased with ~sqrt(2/512) stderr on the
    # NUMERATORS; the effector's P_ii subtraction amplifies that
    # where the profile is small, so the statistically meaningful
    # check is the returned stderr envelope plus rank agreement.
    assert np.all(np.abs(eff - eff_n) < 6 * eff_sem + 1e-12)
    assert np.all(np.abs(sens - sens_n) < 6 * sens_sem + 1e-12)

    def _spearman(a, b):
        ra = np.argsort(np.argsort(a)).astype(np.float64)
        rb = np.argsort(np.argsort(b)).astype(np.float64)
        ra -= ra.mean()
        rb -= rb.mean()
        return float((ra @ rb) / np.sqrt((ra @ ra) * (rb @ rb)))

    assert _spearman(eff, eff_n) > 0.9
    assert _spearman(sens, sens_n) > 0.9

    # fixed seed, fixed probes -> identical result
    eff2, sens2, _, _, _, _ = matfree.effector_sensor_stochastic(
        coord, params, prs_diag, probes=512, seed=3, tol=1e-10,
        block=32, dtype=jnp.float64)
    assert np.array_equal(np.asarray(eff), np.asarray(eff2))
    assert np.array_equal(np.asarray(sens), np.asarray(sens2))

    # rank-k control variate (modes=): still unbiased (inside the
    # stderr envelope of the dense truth) with FAR tighter error bars
    # at the same probe count — the dominant rank-k part of both
    # profiles is computed exactly and only the residual is sampled
    vals_m, vecs_m = (np.asarray(a) for a in anm.eigen())
    modes10 = (vals_m[6:16], vecs_m[6:16])
    eff_d, sens_d, effd_sem, sensd_sem, _, _ = (
        matfree.effector_sensor_stochastic(
            coord, params, prs_diag, probes=512, seed=3, tol=1e-10,
            modes=modes10, layout="atom", block=32,
            dtype=jnp.float64))
    assert np.all(np.abs(eff_d - eff_n) < 6 * effd_sem + 1e-12)
    assert np.all(np.abs(sens_d - sens_n) < 6 * sensd_sem + 1e-12)
    assert np.median(effd_sem / eff_sem) < 0.2
    # the sensor's C_k W C_rest cross diagonal is computed exactly
    # from k extra solve columns, so only the residual second moment
    # is sampled (measured ratio ~0.15 at this size/k)
    assert np.median(sensd_sem / sens_sem) < 0.3
    assert _spearman(eff_d, eff_n) > 0.95
    assert _spearman(sens_d, sens_n) > 0.95

    # complete non-trivial deflation set: the residual is exactly
    # zero, the profiles are exact regardless of probe count
    full_m = (vals_m[6:], vecs_m[6:])
    eff_f, sens_f, efff_sem, sensf_sem, _, _ = (
        matfree.effector_sensor_stochastic(
            coord, params, prs_diag, probes=2, seed=3, tol=1e-10,
            modes=full_m, layout="atom", block=32,
            dtype=jnp.float64))
    assert np.allclose(eff_f, eff_n, rtol=1e-6, atol=1e-12)
    assert np.allclose(sens_f, sens_n, rtol=1e-6, atol=1e-12)
    assert np.max(np.abs(efff_sem)) < 1e-8
    assert np.max(np.abs(sensf_sem)) < 1e-8

    # norm=False: both profiles are the diagonal-excluded raw row
    # means (the raw folded PRS is symmetric), half the probe columns
    raw = np.asarray(prs_raw)
    n = len(coord)
    want = (raw.sum(axis=1) - prs_diag) / (n - 1)
    eff0, sens0, sem0, _, _, res0 = matfree.effector_sensor_stochastic(
        coord, params, prs_diag, probes=512, seed=3, norm=False,
        tol=1e-10, block=32, dtype=jnp.float64)
    assert np.asarray(res0).shape == (512,)
    assert np.array_equal(eff0, sens0)
    assert np.all(np.abs(eff0 - want) < 6 * sem0 + 1e-12)
    assert _spearman(eff0, want) > 0.9

    with pytest.raises(ValueError, match="prs_diag"):
        matfree.effector_sensor_stochastic(coord, params, None)
    with pytest.raises(ValueError, match="probes"):
        matfree.effector_sensor_stochastic(coord, params, prs_diag,
                                           probes=1)


def test_prs_diag_stochastic_matches_dense(ca_1l2y):
    """The deflated split-probe product estimator is unbiased for the
    ALL-MODE folded-PRS diagonal: with enough probes every atom lands
    inside the stderr envelope of the dense truth, and the rank-k
    mode-sum is honored as a lower-bound clamp."""
    anm = sc.ANM(ca_1l2y, sc.InvariantForceField(13.0))
    prs_raw, _, _ = anm.prs_effector_sensor(norm=False)
    exact = np.diagonal(np.asarray(prs_raw))
    vals, vecs = (np.asarray(a) for a in anm.eigen())
    modes = (vals[6:16], vecs[6:16])        # k=10 deflation

    coord = np.asarray(ca_1l2y.coord, dtype=np.float64)
    params = ffparams.invariant_params(13.0)
    diag, sem, n_it, res = matfree.prs_diag_stochastic(
        coord, params, modes, probes=512, seed=4, layout="atom",
        tol=1e-10, block=32, dtype=jnp.float64)
    assert np.max(np.asarray(res)) < 1e-8
    floor = matfree.prs_diag_from_modes(modes[0], modes[1],
                                        layout="atom")
    assert np.all(diag >= floor - 1e-12)
    # clamp-active atoms are certain lower bounds, not point estimates
    active = diag <= floor + 1e-12
    ok = np.abs(diag - exact) < 6 * sem + 1e-12
    assert np.all(ok | active)
    assert np.median(np.abs(diag - exact) / exact) < 0.15

    # complete non-trivial deflation set: C_rest == 0, so the
    # estimate is exact regardless of probes
    full = (vals[6:], vecs[6:])
    diag_f, sem_f, _, _ = matfree.prs_diag_stochastic(
        coord, params, full, probes=8, seed=4, layout="atom",
        tol=1e-10, block=32, dtype=jnp.float64)
    assert np.allclose(diag_f, exact, rtol=1e-6)
    assert np.max(sem_f / exact) < 1e-6

    # determinism
    diag2, _, _, _ = matfree.prs_diag_stochastic(
        coord, params, modes, probes=512, seed=4, layout="atom",
        tol=1e-10, block=32, dtype=jnp.float64)
    assert np.array_equal(diag, diag2)

    with pytest.raises(ValueError, match="probes"):
        matfree.prs_diag_stochastic(coord, params, modes, probes=2)
    with pytest.raises(ValueError, match="layout"):
        matfree.prs_diag_stochastic(coord, params, modes,
                                    layout="plane")


def test_anm_prs_effector_sensor_stochastic_surface(ca_1l2y):
    """`ANM.prs_effector_sensor(matrix_free=True, probes=...)` returns
    stochastic all-mode full-atom profiles near the dense values."""
    anm = sc.ANM(ca_1l2y, sc.InvariantForceField(13.0))
    prs_raw, _, _ = anm.prs_effector_sensor(norm=False)
    _, eff_n, sens_n = anm.prs_effector_sensor(norm=True)
    prs_diag = np.diagonal(np.asarray(prs_raw))

    none_mat, eff, sens = anm.prs_effector_sensor(
        matrix_free=True, probes=256, prs_diag=prs_diag, seed=5,
        tol=1e-10, block=32, dtype=jnp.float64)
    assert none_mat is None

    # Deterministic: the surface forwards to the op (same seed ->
    # identical probes -> identical values)
    coord = np.asarray(ca_1l2y.coord, dtype=np.float64)
    params = ffparams.invariant_params(13.0)
    eff_op, sens_op, eff_sem, sens_sem, _, _ = (
        matfree.effector_sensor_stochastic(
            coord, params, prs_diag, probes=256, seed=5, tol=1e-10,
            block=32, dtype=jnp.float64))
    assert np.array_equal(np.asarray(eff), np.asarray(eff_op))
    assert np.array_equal(np.asarray(sens), np.asarray(sens_op))
    assert np.all(np.abs(eff - np.asarray(eff_n))
                  < 6 * eff_sem + 1e-12)
    assert np.all(np.abs(sens - np.asarray(sens_n))
                  < 6 * sens_sem + 1e-12)

    with pytest.raises(ValueError, match="prs_diag"):
        anm.prs_effector_sensor(matrix_free=True, probes=256)


def test_msf_stochastic_matches_dense(ca_1l2y):
    """The deflated Hutchinson MSF estimator is unbiased for the
    ALL-MODE per-atom covariance traces: every atom lands inside the
    stderr envelope of the dense truth (or on the exact rank-k clamp),
    and the complete deflation set gives the exact values."""
    anm = sc.ANM(ca_1l2y, sc.InvariantForceField(13.0))
    exact = np.asarray(anm.mean_square_fluctuation())
    vals, vecs = (np.asarray(a) for a in anm.eigen())
    modes = (vals[6:16], vecs[6:16])        # k=10 deflation
    n = ca_1l2y.array_length()
    floor = np.einsum(
        "knd,knd,k->n", vecs[6:16].reshape(10, n, 3),
        vecs[6:16].reshape(10, n, 3), 1.0 / vals[6:16])

    coord = np.asarray(ca_1l2y.coord, dtype=np.float64)
    params = ffparams.invariant_params(13.0)
    msf, sem, n_it, res = matfree.msf_stochastic(
        coord, params, modes, probes=512, seed=2, layout="atom",
        tol=1e-10, block=32, dtype=jnp.float64)
    assert np.max(np.asarray(res)) < 1e-8
    assert np.all(msf >= floor - 1e-12)
    clamped = msf <= floor + 1e-12
    assert np.all((np.abs(msf - exact) < 6 * sem + 1e-12) | clamped)
    assert np.median(np.abs(msf - exact) / exact) < 0.15

    # complete non-trivial deflation set: C_rest == 0 -> exact
    full = (vals[6:], vecs[6:])
    msf_f, sem_f, _, _ = matfree.msf_stochastic(
        coord, params, full, probes=4, seed=2, layout="atom",
        tol=1e-10, block=32, dtype=jnp.float64)
    assert np.allclose(msf_f, exact, rtol=1e-6)
    assert np.max(sem_f / exact) < 1e-6

    # determinism + input validation
    msf2, _, _, _ = matfree.msf_stochastic(
        coord, params, modes, probes=512, seed=2, layout="atom",
        tol=1e-10, block=32, dtype=jnp.float64)
    assert np.array_equal(msf, msf2)
    with pytest.raises(ValueError, match="probes"):
        matfree.msf_stochastic(coord, params, modes, probes=1)
    with pytest.raises(ValueError, match="layout"):
        matfree.msf_stochastic(coord, params, modes, layout="plane")


def test_msf_stochastic_gnm_matches_dense(ca_1l2y):
    """GNM counterpart: unbiased all-mode diag(pinv(K))."""
    gnm = sc.GNM(ca_1l2y, sc.InvariantForceField(7.0))
    exact = np.asarray(gnm.mean_square_fluctuation())
    vals, vecs = (np.asarray(a) for a in gnm.eigen())
    modes = (vals[1:6], vecs[1:6])          # k=5 deflation
    floor = np.einsum("kn,kn,k->n", vecs[1:6], vecs[1:6],
                      1.0 / vals[1:6])

    coord = np.asarray(ca_1l2y.coord, dtype=np.float64)
    params = ffparams.invariant_params(7.0)
    msf, sem, n_it, res = matfree.msf_stochastic_gnm(
        coord, params, modes, probes=512, seed=3, tol=1e-11,
        block=16, dtype=jnp.float64)
    assert np.max(np.asarray(res)) < 1e-9
    assert np.all(msf >= floor - 1e-12)
    clamped = msf <= floor + 1e-12
    assert np.all((np.abs(msf - exact) < 6 * sem + 1e-12) | clamped)
    assert np.median(np.abs(msf - exact) / exact) < 0.15

    full = (vals[1:], vecs[1:])
    msf_f, sem_f, _, _ = matfree.msf_stochastic_gnm(
        coord, params, full, probes=4, seed=3, tol=1e-11,
        block=16, dtype=jnp.float64)
    assert np.allclose(msf_f, exact, rtol=1e-6)
    assert np.max(sem_f / exact) < 1e-6


def test_anm_msf_stochastic_surface(ca_1l2y):
    """`ANM.mean_square_fluctuation(matrix_free=True, modes=...)`
    returns (msf, stderr) near the dense all-mode values, applies
    temperature scaling, and validates its inputs."""
    anm = sc.ANM(ca_1l2y, sc.InvariantForceField(13.0))
    exact = np.asarray(anm.mean_square_fluctuation())
    vals, vecs = (np.asarray(a) for a in anm.eigen())
    modes = (vals[6:16], vecs[6:16])
    n = ca_1l2y.array_length()
    floor = np.einsum(
        "knd,knd,k->n", vecs[6:16].reshape(10, n, 3),
        vecs[6:16].reshape(10, n, 3), 1.0 / vals[6:16])

    msf, sem = anm.mean_square_fluctuation(
        matrix_free=True, modes=modes, probes=256, seed=7,
        layout="atom", tol=1e-10, block=32,
        dtype=jnp.float64)
    clamped = msf <= floor + 1e-12
    assert np.all((np.abs(msf - exact) < 6 * sem + 1e-12) | clamped)

    # temperature scaling matches the dense path's semantics
    msf_t, sem_t = anm.mean_square_fluctuation(
        matrix_free=True, modes=modes, probes=256, seed=7,
        layout="atom", tem=300.0, tol=1e-10, block=32, dtype=jnp.float64)
    from springcraft_tpu.ops import nma_core
    scale = nma_core.temperature_scaling(300.0, nma_core.K_B)
    assert np.allclose(msf_t, msf * scale, rtol=1e-12)
    assert np.allclose(sem_t, sem * scale, rtol=1e-12)

    # bfactor is the scaled MSF; same estimator, same seed -> exact
    bf, bf_sem = anm.bfactor(
        matrix_free=True, modes=modes, probes=256, seed=7,
        layout="atom", tol=1e-10, block=32,
        dtype=jnp.float64)
    scale_b = 8 * np.pi**2 / 3
    assert np.allclose(bf, msf * scale_b, rtol=1e-12)
    assert np.allclose(bf_sem, sem * scale_b, rtol=1e-12)

    with pytest.raises(ValueError, match="mode_subset"):
        anm.mean_square_fluctuation(matrix_free=True, modes=modes,
                                    mode_subset=[6, 7])
    with pytest.raises(ValueError, match="modes"):
        anm.mean_square_fluctuation(matrix_free=True)


def test_anm_stochastic_int_modes_layout(ca_1l2y):
    """modes=<int> resolves through ANM.lowest_modes, which returns
    ATOM-interleaved vectors: the surfaces must feed the ops with
    layout="atom" (regression — the op default is xyz, and a scrambled
    layout destroys the rank-k floor and control variate)."""
    anm = sc.ANM(ca_1l2y, sc.InvariantForceField(13.0))
    exact = np.asarray(anm.mean_square_fluctuation())
    msf, sem = anm.mean_square_fluctuation(
        matrix_free=True, modes=6, probes=256, seed=11,
        tol=1e-8, block=32, dtype=jnp.float64)
    assert np.all(np.abs(msf - exact) < 6 * sem + 1e-9)
    assert np.median(np.abs(msf - exact) / exact) < 0.2

    def _spearman(a, b):
        ra = np.argsort(np.argsort(a)).astype(np.float64)
        rb = np.argsort(np.argsort(b)).astype(np.float64)
        ra -= ra.mean()
        rb -= rb.mean()
        return float((ra @ rb) / np.sqrt((ra @ ra) * (rb @ rb)))

    assert _spearman(msf, exact) > 0.9

    prs_raw, _, _ = anm.prs_effector_sensor(norm=False)
    _, eff_d, sens_d = anm.prs_effector_sensor(norm=True)
    prs_diag = np.diagonal(np.asarray(prs_raw))
    none_mat, eff, sens = anm.prs_effector_sensor(
        matrix_free=True, probes=256, prs_diag=prs_diag, modes=6,
        seed=12, tol=1e-8, block=32,
        dtype=jnp.float64)
    assert none_mat is None
    assert _spearman(eff, np.asarray(eff_d)) > 0.9
    assert _spearman(sens, np.asarray(sens_d)) > 0.9


def test_gnm_msf_stochastic_surface(ca_1l2y):
    gnm = sc.GNM(ca_1l2y, sc.InvariantForceField(7.0))
    exact = np.asarray(gnm.mean_square_fluctuation())
    vals, vecs = (np.asarray(a) for a in gnm.eigen())
    modes = (vals[1:6], vecs[1:6])
    floor = np.einsum("kn,kn,k->n", vecs[1:6], vecs[1:6],
                      1.0 / vals[1:6])

    msf, sem = gnm.mean_square_fluctuation(
        matrix_free=True, modes=modes, probes=256, seed=9, tol=1e-11,
        block=16, dtype=jnp.float64)
    clamped = msf <= floor + 1e-12
    assert np.all((np.abs(msf - exact) < 6 * sem + 1e-12) | clamped)

    with pytest.raises(ValueError, match="modes"):
        gnm.mean_square_fluctuation(matrix_free=True)


def test_anm_prs_effector_sensor_modes_surface(ca_1l2y):
    """`ANM.prs_effector_sensor(matrix_free=True, modes=...)` returns
    full-atom mode-sum profiles: exact with the complete set, and the
    integer form solves the modes itself."""
    anm = sc.ANM(ca_1l2y, sc.InvariantForceField(13.0))
    _, eff_n, sens_n = anm.prs_effector_sensor(norm=True)
    vals, vecs = (np.asarray(a) for a in anm.eigen())

    none_mat, eff, sens = anm.prs_effector_sensor(
        matrix_free=True, modes=(vals[6:], vecs[6:]))
    assert none_mat is None
    assert np.allclose(eff, np.asarray(eff_n), rtol=1e-8)
    assert np.allclose(sens, np.asarray(sens_n), rtol=1e-8)

    # integer form: solves k lowest modes matrix-free, then mode-sums;
    # compare against the dense-eigh truncation at the same k
    k = 10
    eff_k, sens_k = matfree.effector_sensor_from_modes(
        vals[6:6 + k], vecs[6:6 + k], layout="atom")
    _, eff_i, sens_i = anm.prs_effector_sensor(
        matrix_free=True, modes=k, tol=1e-10)
    assert np.allclose(eff_i, eff_k, rtol=1e-4)
    assert np.allclose(sens_i, sens_k, rtol=1e-4)

    with pytest.raises(ValueError, match="modes"):
        anm.prs_effector_sensor(matrix_free=True)


def test_matfree_applies_support_overlays(sparse_interpret):
    """Patch overlays apply as a sparse correction on every matrix-free
    operator path — parity vs the dense assembly, including the
    Morton-sorted block-sparse kernel end-to-end (overlay masks are
    permuted alongside the atoms) and the preconditioner/degree/bound
    helpers."""
    rng = np.random.RandomState(2)
    coord = (rng.rand(130, 3) * 22).astype(np.float64)
    n = len(coord)
    base = ffparams.invariant_params(9.0)
    d2 = np.sum((coord[:, None] - coord[None, :]) ** 2, axis=-1)
    off = np.zeros((n, n), bool)
    on = np.zeros((n, n), bool)
    values = np.zeros((n, n))
    ci, cj = np.nonzero(np.triu(d2 <= 81.0, 1))
    for t in range(4):
        off[ci[t], cj[t]] = off[cj[t], ci[t]] = True
    far = np.unravel_index(np.argmax(d2), d2.shape)
    on[far] = on[far[::-1]] = True
    values[far] = values[far[::-1]] = 2.0
    params = ffparams.with_overlay(base, off, on, values, on.copy())

    h_ref = np.asarray(assembly.hessian_matrix(
        coord, params, np, dtype=np.float64, layout="xyz"))
    k_ref = np.asarray(assembly.kirchhoff_matrix(
        coord, params, np, dtype=np.float64))

    x = rng.randn(3 * n, 4)
    y = np.asarray(matfree.hessian_apply(coord, x, params, block=64,
                                         dtype=jnp.float64))
    assert np.allclose(y, h_ref @ x, atol=1e-10)
    nbr, counts = matfree.tile_neighbor_lists(coord, 9.0, 64)
    y2 = np.asarray(matfree.hessian_apply_pallas_sparse(
        jnp.asarray(coord), jnp.asarray(x), params, nbr, counts, tile=64,
        dtype=jnp.float64, interpret=True))
    assert np.allclose(y2, h_ref @ x, atol=1e-10)

    xg = rng.randn(n, 4)
    yg = np.asarray(matfree.kirchhoff_apply(coord, xg, params, block=64,
                                            dtype=jnp.float64))
    assert np.allclose(yg, k_ref @ xg, atol=1e-10)

    # end-to-end through the sorted block-sparse kernel
    vals, vecs, res = matfree.lowest_modes_matfree(
        coord, params, 5, sparse=True,
        dtype=jnp.float64, n_outer=12, degree=64, tol=1e-8)
    truth = np.linalg.eigvalsh(h_ref)[6:11]
    assert np.max(np.abs(np.asarray(vals) - truth) / truth) < 1e-7

    # preconditioner / degree / Gershgorin bound stay exact / safe
    db = np.asarray(matfree.hessian_diag_blocks(coord, params, block=64,
                                                dtype=jnp.float64))
    ref_db = np.stack([[[h_ref[a * n + i, b * n + i] for b in range(3)]
                        for a in range(3)] for i in range(n)])
    assert np.allclose(db, ref_db, atol=1e-10)
    kd = np.asarray(matfree.kirchhoff_degree(coord, params, block=64,
                                             dtype=jnp.float64))
    assert np.allclose(kd, np.diagonal(k_ref), atol=1e-10)
    bound = float(matfree.hessian_degree_bound(coord, params, block=64,
                                               dtype=jnp.float64))
    assert bound >= np.linalg.eigvalsh(h_ref)[-1]


def test_model_surface_argument_guards(ca_1l2y):
    """Matrix-free-only arguments fail fast on the dense observable
    paths (instead of being silently swallowed and changing the return
    shape), conflicting path selectors raise, and an int ``modes=``
    deflation request guards the eigenpair residuals it resolves."""
    n = ca_1l2y.array_length()
    anm = sc.ANM(ca_1l2y, sc.InvariantForceField(13.0))
    gnm = sc.GNM(ca_1l2y, sc.InvariantForceField(7.0))

    with pytest.raises(ValueError, match="matrix_free=True"):
        anm.mean_square_fluctuation(modes=10)
    with pytest.raises(ValueError, match="matrix_free=True"):
        anm.mean_square_fluctuation(probes=64)
    with pytest.raises(ValueError, match="matrix_free=True"):
        gnm.mean_square_fluctuation(tol=1e-8)
    with pytest.raises(ValueError, match="matrix_free=True"):
        anm.dcc(sites=[0, 1])
    with pytest.raises(ValueError, match="matrix_free=True"):
        gnm.dcc(msf=np.ones(n))
    with pytest.raises(ValueError, match="matrix_free=True"):
        anm.bfactor(probes=32)
    with pytest.raises(ValueError, match="matrix_free=True"):
        anm.linear_response(np.zeros((n, 3)), tol=1e-8)
    with pytest.raises(ValueError, match="matrix_free=True"):
        anm.prs_effector_sensor(sites=[0])

    # the exact-site CG path is exclusive with the stochastic estimator
    with pytest.raises(ValueError, match="exclusive"):
        anm.prs_effector_sensor(matrix_free=True, sites=[0],
                                probes=64, prs_diag=np.ones(n))
    # modes= with sites= serves only the auto prs_diag normalizer —
    # alongside an explicit prs_diag (or with norm=False) it would be
    # silently ignored
    with pytest.raises(ValueError, match="ignored"):
        anm.prs_effector_sensor(matrix_free=True, sites=[0], modes=4,
                                prs_diag=np.ones(n))
    with pytest.raises(ValueError, match="ignored"):
        anm.prs_effector_sensor(matrix_free=True, sites=[0], modes=4,
                                norm=False)

    # int modes= runs lowest_modes(matrix_free=True) whose residuals
    # are guarded: an impossible tolerance must raise, not silently
    # bias the rank-k control variate
    with pytest.raises(ValueError, match="deflation modes"):
        anm.mean_square_fluctuation(matrix_free=True, modes=4,
                                    mode_residual_tol=0.0)
    with pytest.raises(ValueError, match="deflation modes"):
        gnm.mean_square_fluctuation(matrix_free=True, modes=4,
                                    mode_residual_tol=0.0)


def test_anm_dcc_auto_msf_normalizer(ca_1l2y):
    """`ANM.dcc(matrix_free=True, norm=True)` without msf= estimates
    the normalizer in place from modes=: with the
    complete non-trivial deflation set the stochastic MSF is exact, so
    the auto-normalized rows must match the dense DCC."""
    anm = sc.ANM(ca_1l2y, sc.InvariantForceField(13.0))
    dcc_full = np.asarray(anm.dcc(norm=True))
    vals, vecs = (np.asarray(a) for a in anm.eigen())
    sites = [1, 7, 15]

    rows = anm.dcc(matrix_free=True, sites=sites, norm=True,
                   modes=(vals[6:], vecs[6:]), probes=4, tol=1e-11,
                   block=32, dtype=jnp.float64)
    assert rows.shape == (len(sites), ca_1l2y.array_length())
    assert np.allclose(rows, dcc_full[sites], rtol=1e-6, atol=1e-8)

    # estimator-only keys (seed, layout) must not leak into the row
    # solve
    rows2 = anm.dcc(matrix_free=True, sites=sites, norm=True,
                    modes=(vals[6:], vecs[6:]), probes=4, seed=3,
                    layout="atom", tol=1e-11, block=32, dtype=jnp.float64)
    assert np.allclose(rows2, dcc_full[sites], rtol=1e-6, atol=1e-8)

    # guards: no normalizer source at all; redundant selectors
    with pytest.raises(ValueError, match="normalizer"):
        anm.dcc(matrix_free=True, sites=sites, norm=True)
    with pytest.raises(ValueError, match="ignored"):
        anm.dcc(matrix_free=True, sites=sites, norm=True,
                msf=np.ones(ca_1l2y.array_length()), modes=4)
    with pytest.raises(ValueError, match="ignored"):
        anm.dcc(matrix_free=True, sites=sites, norm=False, probes=8)


def test_gnm_dcc_auto_msf_normalizer(ca_1l2y):
    """GNM counterpart: dcc(matrix_free=True) with modes= estimates the
    GNM MSF normalizer via msf_stochastic_gnm (exact for the complete
    deflation set)."""
    gnm = sc.GNM(ca_1l2y, sc.InvariantForceField(7.0))
    dcc_full = np.asarray(gnm.dcc(norm=True))
    vals, vecs = (np.asarray(a) for a in gnm.eigen())
    sites = [0, 9]

    rows = gnm.dcc(matrix_free=True, sites=sites, norm=True,
                   modes=(vals[1:], vecs[1:]), probes=4, tol=1e-11,
                   dtype=jnp.float64)
    assert np.allclose(rows, dcc_full[sites], rtol=1e-6, atol=1e-8)
    with pytest.raises(ValueError, match="normalizer"):
        gnm.dcc(matrix_free=True, sites=sites, norm=True)


def test_anm_prs_probes_auto_prs_diag(ca_1l2y):
    """`prs_effector_sensor(matrix_free=True, probes=, modes=)` without
    prs_diag= estimates the folded-PRS diagonal in place via the
    unbiased prs_diag_stochastic: with the complete
    deflation set both the normalizer and the profiles are exact."""
    anm = sc.ANM(ca_1l2y, sc.InvariantForceField(13.0))
    _, eff_n, sens_n = anm.prs_effector_sensor(norm=True)
    vals, vecs = (np.asarray(a) for a in anm.eigen())

    none_mat, eff, sens = anm.prs_effector_sensor(
        matrix_free=True, probes=8, modes=(vals[6:], vecs[6:]),
        tol=1e-11, block=32, dtype=jnp.float64)
    assert none_mat is None
    assert np.allclose(eff, np.asarray(eff_n), rtol=1e-6)
    assert np.allclose(sens, np.asarray(sens_n), rtol=1e-6)

    # without modes= there is nothing to deflate the normalizer
    # estimate with — fail fast, naming both remedies
    with pytest.raises(ValueError, match="prs_diag"):
        anm.prs_effector_sensor(matrix_free=True, probes=8)


def test_anm_prs_sites_modes_normalizer(ca_1l2y):
    """sites= + modes= builds the prs_diag normalizer from the rank-k
    mode-sum (exact for the complete set) — one-call ergonomics for
    the exact-site path."""
    anm = sc.ANM(ca_1l2y, sc.InvariantForceField(13.0))
    _, eff_n, sens_n = anm.prs_effector_sensor(norm=True)
    vals, vecs = (np.asarray(a) for a in anm.eigen())
    sites = [2, 11]

    _, eff, sens = anm.prs_effector_sensor(
        matrix_free=True, sites=sites, modes=(vals[6:], vecs[6:]),
        tol=1e-11, block=32, dtype=jnp.float64)
    assert np.allclose(eff, np.asarray(eff_n)[sites], rtol=1e-6)
    assert np.allclose(sens, np.asarray(sens_n)[sites], rtol=1e-6)


def test_prs_modes_only_path_guards(ca_1l2y):
    """ADVICE r4: the modes-only PRS path must fail fast on a
    user-passed prs_diag (it computes its own diagonal) and honor —
    or reject — layout=."""
    anm = sc.ANM(ca_1l2y, sc.InvariantForceField(13.0))
    n = ca_1l2y.array_length()
    vals, vecs = (np.asarray(a) for a in anm.eigen())
    _, eff_n, sens_n = anm.prs_effector_sensor(norm=True)

    with pytest.raises(ValueError, match="prs_diag"):
        anm.prs_effector_sensor(matrix_free=True,
                                modes=(vals[6:], vecs[6:]),
                                prs_diag=np.ones(n))

    # layout= is honored for explicit (values, vectors): xyz plane
    # vectors give the same profiles as their atom-interleaved form
    vecs_xyz = (vecs[6:].reshape(-1, n, 3).transpose(0, 2, 1)
                .reshape(-1, 3 * n))
    _, eff_x, sens_x = anm.prs_effector_sensor(
        matrix_free=True, modes=(vals[6:], vecs_xyz), layout="xyz")
    assert np.allclose(eff_x, np.asarray(eff_n), rtol=1e-8)
    assert np.allclose(sens_x, np.asarray(sens_n), rtol=1e-8)

    # ...but rejected for modes=<k>: lowest_modes output is always
    # atom-interleaved
    with pytest.raises(ValueError, match="layout"):
        anm.prs_effector_sensor(matrix_free=True, modes=4,
                                layout="xyz")


def test_resolve_deflation_modes_guards(ca_1l2y):
    """ADVICE r4: modes=True must not be treated as k=1, and
    mode_residual_tol with pre-converged modes must raise instead of
    being silently discarded."""
    anm = sc.ANM(ca_1l2y, sc.InvariantForceField(13.0))
    vals, vecs = (np.asarray(a) for a in anm.eigen())

    with pytest.raises(TypeError, match="matrix_free"):
        anm.mean_square_fluctuation(matrix_free=True, modes=True)
    with pytest.raises(ValueError, match="mode_residual_tol"):
        anm.mean_square_fluctuation(
            matrix_free=True, modes=(vals[6:16], vecs[6:16]),
            mode_residual_tol=1e-3)


def test_sparse_apply_compiled_raises_off_gpu():
    """No silent interpreter: the compiled kernel exists only for CUDA
    GPUs, and a compiled call on the CPU backend raises."""
    coord = random_coord(3, 40, box=20.0).astype(np.float32)
    params = ffparams.invariant_params(9.0)
    nbr, counts = matfree.tile_neighbor_lists(coord, 9.0, 16)
    with pytest.raises(ValueError, match="interpret"):
        matfree.hessian_apply_pallas_sparse(
            coord, np.ones((120, 2), np.float32), params, nbr, counts,
            tile=16)
