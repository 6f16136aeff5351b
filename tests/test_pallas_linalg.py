"""
Batched blocked SPD inverse (`ops.pallas_linalg`): leaf-panel
correctness, blocked inverse vs `np.linalg.inv`, and equivalence of the
`inverse="blocked"` covariance engine with the `cho_solve` path in
`ops.rigid.covariance_cholesky` / the ensemble fluctuation pipelines.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from springcraft_tpu.ops import ffparams, pallas_linalg, rigid
from springcraft_tpu.parallel import pipeline


def _random_spd(b, m, seed=0, dtype=np.float32):
    rng = np.random.RandomState(seed)
    a = rng.randn(b, m, m).astype(dtype)
    return a @ a.transpose(0, 2, 1) / m + 3.0 * np.eye(m, dtype=dtype)


def _random_coords(b, n, seed=0):
    rng = np.random.RandomState(seed)
    base = (rng.rand(n, 3) * 12.0).astype(np.float32)
    return base[None] + 0.05 * rng.randn(b, n, 3).astype(np.float32)


_TOL = {np.float32: 2e-5, np.float64: 1e-12}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("pb", [16, 64])
def test_panel_cholesky_matches_numpy(pb, dtype):
    d = _random_spd(5, pb, seed=1, dtype=dtype)
    l, w = pallas_linalg.panel_cholesky_batched(jnp.asarray(d))
    l, w = np.asarray(l), np.asarray(w)
    assert l.dtype == dtype and w.dtype == dtype
    ref = np.linalg.cholesky(d.astype(np.float64))
    assert np.allclose(l, ref, atol=_TOL[dtype] * np.max(np.abs(ref)))
    # W = L^-1
    assert np.allclose(w @ ref, np.eye(pb)[None], atol=_TOL[dtype])
    # strict upper triangles are exactly zero
    iu = np.triu_indices(pb, k=1)
    assert np.all(l[:, iu[0], iu[1]] == 0)
    assert np.all(w[:, iu[0], iu[1]] == 0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("pb", [16, 64])
def test_panel_inverse_augmented_matches_numpy(pb, dtype):
    d = _random_spd(5, pb, seed=4, dtype=dtype)
    w = np.asarray(pallas_linalg.panel_inverse_batched(jnp.asarray(d)))
    ref = np.linalg.cholesky(d.astype(np.float64))
    assert np.allclose(w @ ref, np.eye(pb)[None], atol=_TOL[dtype])
    iu = np.triu_indices(pb, k=1)
    assert np.all(w[:, iu[0], iu[1]] == 0)


def test_panel_inverse_batch_padding():
    d = _random_spd(3, 16, seed=5)
    w = np.asarray(pallas_linalg.panel_inverse_batched(jnp.asarray(d)))
    ref = np.linalg.inv(np.linalg.cholesky(d.astype(np.float64)))
    assert w.shape == (3, 16, 16)
    assert np.allclose(w, ref, atol=2e-5)


def test_panel_cholesky_batch_padding():
    # an odd batch: every member is factored on its own
    d = _random_spd(3, 16, seed=2)
    l, w = pallas_linalg.panel_cholesky_batched(jnp.asarray(d))
    assert np.allclose(np.asarray(l), np.linalg.cholesky(d), atol=1e-5)
    assert l.shape == (3, 16, 16)


@pytest.mark.parametrize("m,block", [(60, 32), (150, 32), (96, 96)])
def test_spd_inverse_blocked_matches_inv(m, block):
    a = _random_spd(4, m, seed=3)
    inv = np.asarray(pallas_linalg.spd_inverse_blocked(
        jnp.asarray(a), block=block))
    ref = np.linalg.inv(a.astype(np.float64))
    assert np.max(np.abs(inv - ref)) / np.max(np.abs(ref)) < 1e-5


def test_spd_inverse_blocked_unbatched_and_f64():
    a = _random_spd(1, 70, seed=4)[0].astype(np.float64)
    inv = np.asarray(pallas_linalg.spd_inverse_blocked(
        jnp.asarray(a), block=32))
    assert inv.shape == (70, 70)
    assert np.allclose(inv @ a, np.eye(70), atol=1e-10)


def test_covariance_cholesky_blocked_engine_matches():
    coords = _random_coords(3, 40, seed=5)
    params = ffparams.invariant_params(7.0)
    from springcraft_tpu.ops import assembly

    hessians = jnp.stack([
        assembly.hessian_matrix(jnp.asarray(c), params, jnp,
                                dtype=jnp.float32, layout="xyz")
        for c in coords
    ])
    bases = jnp.stack([
        rigid.rigid_modes_anm(jnp.asarray(c), layout="xyz")
        for c in coords
    ])
    ref = rigid.covariance_cholesky(hessians, bases)
    got = rigid.covariance_cholesky(hessians, bases, inverse="blocked")
    scale = float(jnp.max(jnp.abs(ref)))
    assert float(jnp.max(jnp.abs(got - ref))) / scale < 1e-4


def test_blocked_breakdown_is_detectable():
    # A matrix that is not SPD (rank-deficient beyond the caller's
    # regularization) must surface as non-finite output — matching XLA
    # cholesky's detectable NaN — never silent finite garbage.
    a = _random_spd(2, 32, seed=9)
    u = np.random.RandomState(9).randn(2, 32, 1).astype(np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    deficient = a - (a @ u) @ np.swapaxes(a @ u, 1, 2) / np.einsum(
        "bif,bif->b", u, a @ u)[:, None, None]
    inv = np.asarray(pallas_linalg.spd_inverse_blocked(
        jnp.asarray(deficient), block=16))
    assert not np.isfinite(inv).all()


def test_covariance_cholesky_blocked_rejects_block_size():
    a = jnp.asarray(_random_spd(1, 12)[0])
    basis = jnp.ones((12, 1)) / np.sqrt(12)
    with pytest.raises(ValueError, match="incompatible"):
        rigid.covariance_cholesky(a, basis, block_size=4,
                                  inverse="blocked")


def test_covariance_cholesky_rejects_unknown_engine():
    a = jnp.asarray(_random_spd(1, 12)[0])
    with pytest.raises(ValueError, match="inverse engine"):
        rigid.covariance_cholesky(a, jnp.ones((12, 1)) / np.sqrt(12),
                                  inverse="qr")


@pytest.mark.parametrize("with_prs", [False, True])
def test_ensemble_anm_fluctuations_blocked_matches_vmap(with_prs):
    coords = _random_coords(4, 30, seed=6)
    params = ffparams.invariant_params(7.0)
    ref = pipeline.ensemble_anm_fluctuations(
        coords, params, inverse="cho_solve", with_prs=with_prs)
    got = pipeline.ensemble_anm_fluctuations(
        coords, params, inverse="blocked", with_prs=with_prs)
    assert set(got) == set(ref)
    for key in ref:
        scale = float(jnp.max(jnp.abs(ref[key]))) or 1.0
        err = float(jnp.max(jnp.abs(got[key] - ref[key]))) / scale
        assert err < 2e-4, (key, err)


def test_ensemble_gnm_fluctuations_blocked_matches_vmap():
    coords = _random_coords(4, 30, seed=7)
    params = ffparams.invariant_params(7.0)
    ref = pipeline.ensemble_gnm_fluctuations(
        coords, params, inverse="cho_solve")
    got = pipeline.ensemble_gnm_fluctuations(
        coords, params, inverse="blocked")
    for key in ref:
        scale = float(jnp.max(jnp.abs(ref[key]))) or 1.0
        assert float(jnp.max(jnp.abs(got[key] - ref[key]))) / scale < 2e-4


def test_ensemble_spectral_blocked_matches_cho_solve():
    coords = _random_coords(3, 24, seed=10)
    params = ffparams.invariant_params(7.0)
    ref = pipeline.ensemble_anm_spectral(
        coords, params, n_modes=4, inverse="cho_solve")
    got = pipeline.ensemble_anm_spectral(
        coords, params, n_modes=4, inverse="blocked")
    for key in ("covariance", "msf", "dcc", "eig_values",
                "mode_values"):
        scale = float(jnp.max(jnp.abs(ref[key]))) or 1.0
        err = float(jnp.max(jnp.abs(got[key] - ref[key]))) / scale
        assert err < 5e-4, (key, err)


def test_ensemble_gnm_spectral_matches_single():
    coords = _random_coords(3, 24, seed=11)
    params = ffparams.invariant_params(7.0)
    ens = pipeline.ensemble_gnm_spectral(
        coords, params, n_modes=3, inverse="cho_solve")
    for i in range(3):
        one = pipeline.gnm_spectral(jnp.asarray(coords[i]), params)
        for key in ("covariance", "msf", "eig_values", "dcc"):
            scale = float(jnp.max(jnp.abs(one[key]))) or 1.0
            err = float(jnp.max(jnp.abs(ens[key][i] - one[key]))) / scale
            assert err < 5e-4, (key, err)
    # blocked engine agrees
    blk = pipeline.ensemble_gnm_spectral(
        coords, params, n_modes=3, inverse="blocked")
    for key in ("covariance", "msf", "eig_values", "mode_values"):
        scale = float(jnp.max(jnp.abs(ens[key]))) or 1.0
        assert float(jnp.max(jnp.abs(blk[key] - ens[key]))) / scale < 5e-4


def test_ensemble_fluctuations_blocked_masses():
    coords = _random_coords(3, 25, seed=8)
    params = ffparams.invariant_params(7.0)
    masses = np.linspace(1.0, 3.0, 25).astype(np.float32)
    ref = pipeline.ensemble_anm_fluctuations(
        coords, params, masses=jnp.asarray(masses), inverse="cho_solve")
    got = pipeline.ensemble_anm_fluctuations(
        coords, params, masses=jnp.asarray(masses), inverse="blocked")
    for key in ref:
        scale = float(jnp.max(jnp.abs(ref[key]))) or 1.0
        assert float(jnp.max(jnp.abs(got[key] - ref[key]))) / scale < 2e-4


def test_ensemble_fluctuations_megabatch_chunked():
    """chunk= must produce identical results to the unchunked blocked
    pipeline (one lax.map program vs one call), ANM and GNM."""
    coords = _random_coords(6, 30, seed=6)
    params = ffparams.invariant_params(7.0)
    ref = pipeline.ensemble_anm_fluctuations(
        coords, params, inverse="blocked")
    got = pipeline.ensemble_anm_fluctuations(
        coords, params, inverse="blocked", chunk=2)
    for key in ref:
        scale = float(jnp.max(jnp.abs(ref[key]))) or 1.0
        assert float(jnp.max(jnp.abs(got[key] - ref[key]))) / scale < 1e-6

    gref = pipeline.ensemble_gnm_fluctuations(
        coords, params, inverse="blocked")
    ggot = pipeline.ensemble_gnm_fluctuations(
        coords, params, inverse="blocked", chunk=3)
    for key in gref:
        scale = float(jnp.max(jnp.abs(gref[key]))) or 1.0
        assert float(jnp.max(jnp.abs(ggot[key] - gref[key]))) / scale < 1e-6

    # chunk >= batch is a no-op; non-divisible batches are rejected
    same = pipeline.ensemble_anm_fluctuations(
        coords, params, inverse="blocked", chunk=6)
    assert set(same) == set(ref)
    with pytest.raises(ValueError, match="divide"):
        pipeline.ensemble_anm_fluctuations(
            coords, params, inverse="blocked", chunk=4)


# ---------------------------------------------------------------------------
# Triangular zero-skipping (`_tri_split`-active) paths.  They only engage
# at 128-aligned sub-blocks >= 256, so the split arithmetic is covered
# here directly against the dense contractions, plus one full-recursion
# run with the leaf swapped for a NumPy leaf.


def _tril_factor(b, m, seed, dtype=np.float32):
    """Random lower-triangular factor with a well-scaled diagonal and an
    EXACTLY zero strict upper triangle (the recursion's invariant)."""
    rng = np.random.RandomState(seed)
    w = np.tril(0.1 * rng.randn(b, m, m)).astype(dtype)
    idx = np.arange(m)
    w[:, idx, idx] = (1.0 + rng.rand(b, m)).astype(dtype)
    return w


def test_tri_split_points():
    assert pallas_linalg._tri_split(64) == 0
    assert pallas_linalg._tri_split(128) == 0
    assert pallas_linalg._tri_split(256) == 128
    assert pallas_linalg._tri_split(384) == 256
    assert pallas_linalg._tri_split(512) == 256


def test_tri_mm_helpers_match_dense():
    h = 384  # _tri_split(384) = 256 -> zero-skipping branch active
    g = jnp.asarray(_tril_factor(2, h, seed=21))
    x = jnp.asarray(np.random.RandomState(22)
                    .randn(2, 192, h).astype(np.float32))
    got = pallas_linalg._tri_right_mm(x, g, "highest")
    ref = jnp.einsum("bij,bjk->bik", x, g, precision="highest")
    scale = float(jnp.max(jnp.abs(ref)))
    assert float(jnp.max(jnp.abs(got - ref))) / scale < 1e-6

    y = jnp.asarray(np.random.RandomState(23)
                    .randn(2, h, 160).astype(np.float32))
    got = pallas_linalg._tri_left_mm(g, y, "highest")
    ref = jnp.einsum("bij,bjk->bik", g, y, precision="highest")
    scale = float(jnp.max(jnp.abs(ref)))
    assert float(jnp.max(jnp.abs(got - ref))) / scale < 1e-6


def test_schur_lower_matches_dense():
    s, h = 640, 384  # both split points active (q=256, qq=128)
    a = jnp.asarray(_random_spd(2, s, seed=24))
    g11 = jnp.asarray(_tril_factor(2, h, seed=25))
    l21, s22 = pallas_linalg._schur_lower(a, h, g11, "highest")

    ref_l21 = jnp.einsum("bij,bkj->bik", a[:, h:, :h], g11,
                         precision="highest")
    scale = float(jnp.max(jnp.abs(ref_l21)))
    assert float(jnp.max(jnp.abs(l21 - ref_l21))) / scale < 1e-6

    ref_s22 = a[:, h:, h:] - jnp.einsum("bik,bjk->bij", ref_l21, ref_l21,
                                        precision="highest")
    w = s - h
    qq = pallas_linalg._tri_split(w)
    assert qq == 128
    # the strict upper-right quadrant is zero-FILLED by contract (the
    # consuming recursion never reads it) ...
    assert float(jnp.max(jnp.abs(s22[:, :qq, qq:]))) == 0.0
    # ... and everything the recursion does read matches the dense form
    mask = np.ones((w, w), bool)
    mask[:qq, qq:] = False
    diff = jnp.abs(s22 - ref_s22) * jnp.asarray(mask, a.dtype)
    scale = float(jnp.max(jnp.abs(ref_s22)))
    assert float(jnp.max(diff)) / scale < 1e-6


def test_gram_lower_split_matches_dense():
    from springcraft_tpu.ops import rigid as rigid_mod

    w = jnp.asarray(_tril_factor(2, 512, seed=26))
    got = rigid_mod._gram_lower(w)
    ref = jnp.einsum("bki,bkj->bij", w, w, precision="highest")
    scale = float(jnp.max(jnp.abs(ref)))
    assert float(jnp.max(jnp.abs(got - ref))) / scale < 1e-6


def test_plane_traces_row_ranges_match_dense():
    # n large enough that the per-plane row floors differ (k0 = 0, 128,
    # 256 for n = 150) and mp > 3n exercises the padded columns
    from springcraft_tpu.ops import rigid as rigid_mod

    n = 150
    mp = pallas_linalg.padded_size(3 * n)
    assert mp == 512
    w = jnp.asarray(_tril_factor(2, mp, seed=27))
    rng = np.random.RandomState(28)
    t = jnp.asarray(np.linalg.qr(rng.randn(2, 3 * n, 6))[0]
                    .astype(np.float32))
    sigma = jnp.asarray(np.float32(2.5))
    got = rigid_mod._plane_traces_from_w(w, t, sigma, n)
    full = [jnp.einsum("bkn,bkm->bnm", w[:, :, a * n:(a + 1) * n],
                       w[:, :, a * n:(a + 1) * n], precision="highest")
            for a in range(3)]
    tp = t.reshape(2, 3, n, 6)
    corr = jnp.einsum("banp,bamp->bnm", tp, tp, precision="highest")
    ref = full[0] + full[1] + full[2] - corr / sigma
    scale = float(jnp.max(jnp.abs(ref)))
    assert float(jnp.max(jnp.abs(got - ref))) / scale < 1e-6


def test_recursion_tri_splits_numpy_leaf(monkeypatch):
    # Full recursion at mp=640 (two active _tri_split levels) with the
    # leaf replaced by a NumPy Cholesky leaf: exercises the split/stitch
    # arithmetic end-to-end independently of the XLA leaves.
    def np_leaf(panels):
        p = np.asarray(panels).astype(np.float64)
        w = np.linalg.inv(np.linalg.cholesky(p))
        return jnp.asarray(np.tril(w).astype(np.asarray(panels).dtype))

    monkeypatch.setattr(pallas_linalg, "panel_inverse_batched", np_leaf)
    m = 540
    a = _random_spd(2, m, seed=29)
    g = np.asarray(pallas_linalg.spd_inverse_factor(jnp.asarray(a)))
    assert g.shape == (2, 640, 640)
    iu = np.triu_indices(640, k=1)
    assert np.abs(g[:, iu[0], iu[1]]).max() == 0.0
    l = np.linalg.cholesky(a.astype(np.float64))
    resid = np.abs(g[:, :m, :m] @ l - np.eye(m)[None]).max()
    assert resid < 5e-6
    # A^-1 = (G^T G)[:m, :m]
    inv = (g.transpose(0, 2, 1) @ g)[:, :m, :m]
    ref = np.linalg.inv(a.astype(np.float64))
    rel = np.abs(inv - ref).max() / np.abs(ref).max()
    assert rel < 1e-5


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_recursion_tri_splits_xla_leaf(dtype):
    # The same mp=640 recursion with the real XLA Cholesky leaves
    m = 540
    a = _random_spd(2, m, seed=29, dtype=dtype)
    g = np.asarray(pallas_linalg.spd_inverse_factor(jnp.asarray(a)))
    assert g.shape == (2, 640, 640) and g.dtype == dtype
    inv = (g.transpose(0, 2, 1) @ g)[:, :m, :m]
    ref = np.linalg.inv(a.astype(np.float64))
    rel = np.abs(inv - ref).max() / np.abs(ref).max()
    assert rel < (1e-5 if dtype == np.float32 else 1e-12)
