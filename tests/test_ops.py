"""
Functional-core tests: layout equivalence, blocked assembly, pinv
semantics, and vmap/jit consistency of the dense pipeline.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import springcraft_tpu as sc
from springcraft_tpu.ops import assembly, ffparams, linalg

from .util import random_coord


def test_pinvh_matches_numpy():
    rng = np.random.RandomState(0)
    a = rng.rand(30, 30)
    a = a + a.T
    # Make it singular (rank deficient) to exercise the rcond path
    a[-1] = a[0]
    a[:, -1] = a[:, 0]

    ref = np.linalg.pinv(a, hermitian=True, rcond=1e-6)
    test = np.asarray(linalg.pinvh(a, rcond=1e-6))
    # Rank-deficient pseudo-inverses agree only up to eigensolver rounding
    assert np.allclose(test, ref, rtol=1e-5, atol=1e-8)


def test_pinvh_batched():
    rng = np.random.RandomState(1)
    batch = rng.rand(4, 16, 16)
    batch = batch + batch.swapaxes(-1, -2)

    batched = np.asarray(linalg.pinvh(jnp.asarray(batch)))
    for i in range(4):
        ref = np.linalg.pinv(batch[i], hermitian=True, rcond=1e-6)
        assert np.allclose(batched[i], ref, atol=1e-8)


def test_xyz_layout_permutation_equivalence():
    coord = random_coord(0, 60)
    params = ffparams.invariant_params(12.0)

    atom = np.asarray(assembly.hessian_matrix(coord, params, jnp,
                                              layout="atom"))
    xyz = np.asarray(assembly.hessian_matrix(coord, params, jnp,
                                             layout="xyz"))
    perm = assembly.atom_to_xyz_permutation(60)
    assert np.allclose(xyz, atom[np.ix_(perm, perm)])

    # Permutation similarity: identical eigenvalues
    ev_atom = np.linalg.eigvalsh(atom)
    ev_xyz = np.linalg.eigvalsh(xyz)
    assert np.allclose(ev_atom, ev_xyz, atol=1e-9)


@pytest.mark.parametrize("kind", ["invariant", "hinsen", "pfenm"])
def test_hessian_rows_match_full(kind):
    coord = random_coord(1, 64)
    params = {
        "invariant": ffparams.invariant_params(10.0),
        "hinsen": ffparams.hinsen_params(),
        "pfenm": ffparams.pfenm_params(),
    }[kind]

    full = np.asarray(assembly.hessian_matrix(coord, params, jnp,
                                              layout="atom"))
    block = 16
    rows = [
        np.asarray(assembly.hessian_rows(coord, params, start, block, jnp))
        for start in range(0, 64, block)
    ]
    assert np.allclose(np.concatenate(rows, axis=0), full, atol=1e-12)


def test_hessian_rows_tabulated_compact(two_chain_ca):
    ff = sc.TabulatedForceField.sd_enm(two_chain_ca)
    params = ff.to_compact_params()
    coord = two_chain_ca.coord.astype(np.float64)
    n = len(coord)

    full = np.asarray(assembly.hessian_matrix(coord, params, jnp))
    rows = [
        np.asarray(assembly.hessian_rows(coord, params, start, 10, jnp))
        for start in range(0, n, 10)
    ]
    assert np.allclose(np.concatenate(rows, axis=0), full, atol=1e-12)


def test_kirchhoff_jit_and_vmap_consistency():
    """vmapped batched assembly must equal a loop of unbatched calls."""
    params = ffparams.invariant_params(9.0)
    coords = np.stack([random_coord(s, 40) for s in range(5)])

    single = jax.jit(
        lambda c: assembly.kirchhoff_matrix(c, params, jnp)
    )
    batched = jax.jit(
        jax.vmap(lambda c: assembly.kirchhoff_matrix(c, params, jnp))
    )

    loop = np.stack([np.asarray(single(c)) for c in coords])
    vect = np.asarray(batched(coords))
    assert np.allclose(loop, vect, atol=1e-12)


def test_hessian_vmap_consistency():
    params = ffparams.hinsen_params()
    coords = np.stack([random_coord(s + 10, 24) for s in range(3)])

    batched = jax.jit(
        jax.vmap(lambda c: assembly.hessian_matrix(c, params, jnp))
    )
    vect = np.asarray(batched(coords))
    for i, c in enumerate(coords):
        ref = np.asarray(assembly.hessian_matrix(c, params, jnp))
        assert np.allclose(vect[i], ref, atol=1e-12)


def test_force_constant_matrix_symmetry(two_chain_ca):
    for ff in (
        sc.InvariantForceField(8.0),
        sc.HinsenForceField(),
        sc.TabulatedForceField.e_anm(two_chain_ca),
        sc.TabulatedForceField.sd_enm(two_chain_ca),
    ):
        params = ff.to_params(natoms=len(two_chain_ca))
        coord = two_chain_ca.coord.astype(np.float64)
        _, sq = ffparams.pairwise_sq_distance(coord, np)
        k = ffparams.force_constant_matrix(sq, params, np)
        assert np.allclose(k, k.T)
        assert np.all(np.diagonal(k) == 0)


def test_eigensystem_convention():
    rng = np.random.RandomState(2)
    a = rng.rand(12, 12)
    a = a + a.T
    vals, vecs = linalg.eigensystem(a)
    # Modes in rows, ascending eigenvalues
    assert np.all(np.diff(vals) >= -1e-12)
    for i in range(12):
        assert np.allclose(a @ vecs[i], vals[i] * vecs[i], atol=1e-9)


def test_numpy_fallback_when_x64_off(ca_1l2y):
    """With x64 disabled, float64 parity work must route through NumPy
    instead of being silently downcast by JAX."""
    import jax

    from springcraft_tpu.utils.config import resolve_backend

    try:
        jax.config.update("jax_enable_x64", False)
        assert resolve_backend(np.float64) == "numpy"

        a = np.random.RandomState(0).rand(12, 12)
        a = a + a.T
        vals, vecs = linalg.eigh(a)
        assert vals.dtype == np.float64
        assert isinstance(vals, np.ndarray)

        pinv = linalg.pinvh(a)
        assert pinv.dtype == np.float64
        assert np.allclose(pinv, np.linalg.pinv(a, hermitian=True,
                                                rcond=1e-6), atol=1e-10)

        # Full model path stays float64
        import springcraft_tpu as sc

        gnm = sc.GNM(ca_1l2y, sc.InvariantForceField(7.0))
        assert gnm.kirchhoff.dtype == np.float64
        vals, _ = gnm.eigen()
        assert vals.dtype == np.float64
    finally:
        jax.config.update("jax_enable_x64", True)


def test_eigvalsh_sturm_matches_eigh():
    from springcraft_tpu.ops import spectrum

    rng = np.random.RandomState(0)
    a = rng.rand(40, 40)
    a = a + a.T
    vals = np.asarray(spectrum.eigvalsh_sturm(jnp.asarray(a), n_iter=60))
    ref = np.linalg.eigvalsh(a)
    assert np.allclose(vals, ref, atol=1e-10)

    # Batched
    batch = rng.rand(3, 24, 24)
    batch = batch + batch.swapaxes(-1, -2)
    vals_b = np.asarray(spectrum.eigvalsh_sturm(jnp.asarray(batch),
                                                n_iter=60))
    for i in range(3):
        assert np.allclose(vals_b[i], np.linalg.eigvalsh(batch[i]),
                           atol=1e-10)


def test_tridiagonalize_preserves_spectrum():
    from springcraft_tpu.ops import spectrum

    rng = np.random.RandomState(1)
    a = rng.rand(30, 30)
    a = a + a.T
    d, e = spectrum.tridiagonalize(jnp.asarray(a))
    t = (np.diag(np.asarray(d)) + np.diag(np.asarray(e), 1)
         + np.diag(np.asarray(e), -1))
    assert np.allclose(np.linalg.eigvalsh(t), np.linalg.eigvalsh(a),
                       atol=1e-10)


@pytest.mark.parametrize("bandwidth", [1, 2, 4, 8])
def test_band_reduce_preserves_spectrum(bandwidth):
    from springcraft_tpu.ops import spectrum

    rng = np.random.RandomState(2)
    n = 50
    a = rng.rand(n, n)
    a = a + a.T
    diags = np.asarray(spectrum.band_reduce(jnp.asarray(a), bandwidth))
    assert diags.shape == (bandwidth + 1, n)
    band = np.zeros((n, n))
    for d in range(bandwidth + 1):
        idx = np.arange(n - d)
        band[idx, idx + d] = diags[d][: n - d]
        band[idx + d, idx] = diags[d][: n - d]
    assert np.allclose(np.linalg.eigvalsh(band), np.linalg.eigvalsh(a),
                       atol=1e-10)


@pytest.mark.parametrize("bandwidth", [1, 2, 4, 8])
def test_eigvalsh_banded_matches_eigh(bandwidth):
    from springcraft_tpu.ops import spectrum

    rng = np.random.RandomState(3)
    for n in (13, 40, 100):  # non-divisible and divisible by bandwidth
        a = rng.randn(n, n)
        a = (a + a.T) / 2
        vals = np.asarray(
            spectrum.eigvalsh_banded(jnp.asarray(a), bandwidth=bandwidth,
                                     n_iter=60)
        )
        assert np.allclose(vals, np.linalg.eigvalsh(a), atol=1e-10)


def test_eigvalsh_banded_batched_and_hessian():
    from springcraft_tpu.ops import assembly, ffparams, spectrum

    rng = np.random.RandomState(4)
    batch = rng.randn(3, 30, 30)
    batch = (batch + batch.swapaxes(-1, -2)) / 2
    vals = np.asarray(spectrum.eigvalsh_banded(jnp.asarray(batch),
                                               bandwidth=4, n_iter=60))
    for i in range(3):
        assert np.allclose(vals[i], np.linalg.eigvalsh(batch[i]),
                           atol=1e-10)

    # Semi-definite ENM Hessian: six zero modes must come out ~0 and the
    # nontrivial spectrum must match eigh
    coord = jnp.asarray(rng.rand(60, 3) * 19)
    h = assembly.hessian_matrix(coord, ffparams.invariant_params(8.0),
                                jnp, dtype=jnp.float64, layout="xyz")
    vals = np.asarray(spectrum.eigvalsh_banded(h, bandwidth=8, n_iter=60))
    ref = np.linalg.eigvalsh(np.asarray(h))
    assert np.allclose(vals, ref, atol=1e-9)
    assert np.all(np.abs(vals[:6]) < 1e-9)


def test_eigvalsh_banded_degenerate_spectra():
    from springcraft_tpu.ops import spectrum

    d = np.diag([3.0, 3, 3, 1, 1, 5, 5, 5, 2, 0, 0, 7])
    got = np.asarray(spectrum.eigvalsh_banded(jnp.asarray(d),
                                              bandwidth=3, n_iter=60))
    assert np.allclose(got, np.sort(np.diagonal(d)), atol=1e-12)

    assert np.allclose(
        spectrum.eigvalsh_banded(jnp.asarray(np.zeros((10, 10))),
                                 bandwidth=2, n_iter=60), 0.0)

    rng = np.random.RandomState(1)
    a = rng.randn(6, 6)
    a = a + a.T
    k = np.kron(np.eye(3), a)  # exactly triple-degenerate spectrum
    got = np.asarray(spectrum.eigvalsh_banded(jnp.asarray(k),
                                              bandwidth=4, n_iter=60))
    assert np.allclose(got, np.linalg.eigvalsh(k), atol=1e-9)


def test_shift_invert_matches_dense():
    from springcraft_tpu.ops import assembly, ffparams, modes
    from springcraft_tpu.utils.network import is_connected

    rng = np.random.RandomState(5)
    coord = jnp.asarray(rng.rand(120, 3) * 18)  # dense -> connected
    assert is_connected(np.asarray(coord), 9.0)
    h = assembly.hessian_matrix(coord, ffparams.invariant_params(9.0),
                                jnp, dtype=jnp.float64, layout="xyz")
    vals, vecs = modes.lowest_modes_anm(h, coord, k=10)
    ref = np.linalg.eigvalsh(np.asarray(h))
    assert np.allclose(np.asarray(vals), ref[6:16], rtol=1e-8)
    # The last requested modes (nearest the oversampling boundary)
    # converge slowest — inverse-power rate (lambda_k / lambda_{k+q})^s
    res = np.asarray(modes.mode_residuals(h, vals, vecs))
    assert np.all(res < 1e-5)


def test_shift_invert_invfactor_engine_matches_dense():
    """The explicit-inverse-factor engine (two matmuls per
    iteration instead of two sequential triangular solves) must agree
    with the chol engine and the dense truth at f32 accuracy."""
    from springcraft_tpu.ops import assembly, ffparams, modes

    rng = np.random.RandomState(5)
    coord = jnp.asarray((rng.rand(150, 3) * 19).astype(np.float32))
    h = assembly.hessian_matrix(coord, ffparams.invariant_params(9.0),
                                jnp, dtype=jnp.float32, layout="xyz")
    vals, vecs = modes.lowest_modes_anm(h, coord, k=10,
                                        engine="invfactor")
    truth = np.linalg.eigvalsh(np.asarray(h, np.float64))[6:16]
    assert np.max(np.abs(np.asarray(vals, np.float64) - truth)
                  / truth) < 1e-4
    res = np.asarray(modes.mode_residuals(h, vals, vecs))
    assert np.all(res < 5e-3)


def test_shift_invert_staged_engine_matches_dense(tmp_path):
    """engine='staged' (three small device programs + resumable host
    loop — the low-compile-cost mega-scale route) must agree with the
    dense truth, resume from a mid-solve snapshot, and clear it."""
    from springcraft_tpu.ops import assembly, ffparams, modes, rigid
    from springcraft_tpu.utils.elastic import LoopCheckpoint

    rng = np.random.RandomState(5)
    coord = jnp.asarray(rng.rand(120, 3) * 18)
    h = assembly.hessian_matrix(coord, ffparams.invariant_params(9.0),
                                jnp, dtype=jnp.float64, layout="xyz")
    ckpt = tmp_path / "si_staged.npz"
    vals, vecs = modes.lowest_modes_anm(h, coord, k=10, engine="staged",
                                        checkpoint=str(ckpt))
    truth = np.linalg.eigvalsh(np.asarray(h))[6:16]
    assert np.allclose(np.asarray(vals), truth, rtol=1e-8)
    res = np.asarray(modes.mode_residuals(h, vals, vecs))
    assert np.all(res < 1e-5)
    assert not ckpt.exists()  # completed solves clear their snapshot

    # resume path: seed the snapshot with a half-way subspace and check
    # the continued solve still lands on the truth
    basis = jnp.asarray(rigid.rigid_modes_anm(coord, layout="xyz"),
                        h.dtype)
    half = modes.lowest_modes_shift_invert  # fused, for the subspace
    _, half_vecs = half(h, basis, k=18, n_iter=12)
    LoopCheckpoint(str(ckpt)).save(
        12, {"x": np.asarray(half_vecs).T})
    vals2, _ = modes.lowest_modes_shift_invert_staged(
        h, basis, k=10, n_iter=24, checkpoint=str(ckpt))
    assert np.allclose(np.asarray(vals2), truth, rtol=1e-8)

    # stray staged-only options on other engines are a TypeError
    with pytest.raises(TypeError, match="staged"):
        modes.lowest_modes_shift_invert(h, basis, k=4,
                                        checkpoint="x.npz")


@pytest.mark.parametrize("kind", ["invariant", "hinsen"])
def test_kirchhoff_rows_match_full(kind):
    from springcraft_tpu.ops import assembly, ffparams

    rng = np.random.RandomState(3)
    coord = rng.rand(50, 3) * 20
    params = (ffparams.invariant_params(9.0) if kind == "invariant"
              else ffparams.hinsen_params(11.0))
    full = np.asarray(assembly.kirchhoff_matrix(coord, params, np,
                                                dtype=np.float64))
    for start, block in ((0, 13), (13, 20), (33, 17)):
        rows = np.asarray(assembly.kirchhoff_rows(
            coord, params, start, block, np, dtype=np.float64))
        assert np.allclose(rows, full[start:start + block], atol=1e-12)


def test_refine_modes_f64_gnm_matches_truth():
    from springcraft_tpu.ops import assembly, ffparams, modes

    rng = np.random.RandomState(9)
    n, k = 120, 6
    coord = rng.rand(n, 3) * 18
    params = ffparams.invariant_params(9.0)
    k64 = np.asarray(assembly.kirchhoff_matrix(coord, params, np,
                                               dtype=np.float64))
    truth_vals, truth_vecs = np.linalg.eigh(k64)

    noise = rng.randn(k, n)
    noise *= 1e-4 / np.linalg.norm(noise, axis=1, keepdims=True)
    approx = (truth_vecs[:, 1:1 + k].T + noise).astype(np.float32)
    vals, vecs, res = modes.refine_modes_f64_gnm(coord, params, approx,
                                                 block=37)
    assert np.max(np.abs(vals - truth_vals[1:1 + k])
                  / truth_vals[1:1 + k]) <= 1e-6
    r = k64 @ vecs.T - vecs.T * vals[None, :]
    assert np.max(np.linalg.norm(r, axis=0) / vals) < 5e-3


def test_refine_modes_f64_hits_north_star_rtol():
    """f32 shift-invert modes carry O(1e-4) eigenvalue error; the f64
    Rayleigh-Ritz refinement must recover <=1e-6 rtol vs f64 eigh truth
    (BASELINE.json north-star accuracy clause)."""
    from springcraft_tpu.ops import assembly, ffparams, modes

    rng = np.random.RandomState(5)
    coord = rng.rand(150, 3) * 19
    params = ffparams.invariant_params(9.0)
    k = 10

    h32 = assembly.hessian_matrix(
        jnp.asarray(coord, jnp.float32), params, jnp,
        dtype=jnp.float32, layout="xyz")
    vals32, vecs32 = modes.lowest_modes_anm(
        h32, jnp.asarray(coord, jnp.float32), k=k)

    h64 = assembly.hessian_matrix(coord, params, np, dtype=np.float64,
                                  layout="xyz")
    truth = np.linalg.eigvalsh(h64)[6:6 + k]

    raw_rtol = np.max(np.abs(np.asarray(vals32, np.float64) - truth)
                      / truth)
    vals, vecs, res = modes.refine_modes_f64(coord, params, vecs32,
                                             layout="xyz", block=64)
    ref_rtol = np.max(np.abs(vals - truth) / truth)
    assert ref_rtol <= 1e-6, (raw_rtol, ref_rtol)
    assert ref_rtol < raw_rtol
    # Vectors stay O(f32-subspace) accurate — Rayleigh-Ritz squares the
    # subspace error only for the eigenVALUES
    assert np.all(res < 1e-4)
    r = h64 @ vecs.T - vecs.T * vals[None, :]
    assert np.max(np.linalg.norm(r, axis=0) / vals) < 1e-4


def test_refine_modes_f64_mass_weighted_and_atom_layout():
    from springcraft_tpu.ops import assembly, ffparams, modes

    rng = np.random.RandomState(11)
    n, k = 100, 6
    coord = rng.rand(n, 3) * 16
    masses = 1.0 + rng.rand(n)
    params = ffparams.invariant_params(9.0)

    h64 = assembly.hessian_matrix(coord, params, np, dtype=np.float64,
                                  layout="atom")
    w3 = np.repeat(1.0 / np.sqrt(masses), 3)
    hw = h64 * w3[:, None] * w3[None, :]
    truth_vals, truth_vecs = np.linalg.eigh(hw)

    # perturbed f32-quality starting vectors in atom layout (vector
    # 2-norm error ~1e-4 — Rayleigh-Ritz recovers eigenvalues to
    # O(error^2))
    noise = rng.randn(k, 3 * n)
    noise *= 1e-4 / np.linalg.norm(noise, axis=1, keepdims=True)
    approx = (truth_vecs[:, 6:6 + k].T + noise).astype(np.float32)
    vals, vecs, res = modes.refine_modes_f64(
        coord, params, approx, masses=masses, layout="atom", block=32)
    assert np.max(np.abs(vals - truth_vals[6:6 + k])
                  / truth_vals[6:6 + k]) <= 1e-6
    # residuals are first-order in the injected 1e-4 vector error,
    # amplified by ||H||/theta — only the eigenvalues are squared back
    assert np.all(res < 5e-3)


# ---------------------------------------------------------------------------
# Two-stage full eigensystem (eigh_banded)
# ---------------------------------------------------------------------------


def _eigh_banded_checks(a, vals, vecs, atol_res, atol_orth):
    n = a.shape[-1]
    vals = np.asarray(vals)
    vecs = np.asarray(vecs)
    assert np.all(np.diff(vals) >= -atol_res)
    res = np.linalg.norm(a @ vecs.T - vecs.T * vals[None, :], axis=0)
    assert res.max() < atol_res, res.max()
    gram = vecs @ vecs.T
    assert np.max(np.abs(gram - np.eye(n))) < atol_orth


@pytest.mark.parametrize("bandwidth", [1, 4, 8])
def test_eigh_banded_matches_eigh(bandwidth):
    from springcraft_tpu.ops import spectrum

    rng = np.random.RandomState(7)
    a = rng.randn(90, 90)
    a = (a + a.T) / 2
    vals, vecs = spectrum.eigh_banded(jnp.asarray(a),
                                      bandwidth=bandwidth)
    assert np.allclose(np.asarray(vals), np.linalg.eigvalsh(a),
                       atol=1e-9)
    _eigh_banded_checks(a, vals, vecs, 1e-8, 1e-9)


def test_eigh_banded_staged_matches_eigh():
    """Staged (four separate device programs) == fused eigh_banded."""
    from springcraft_tpu.ops import spectrum

    rng = np.random.RandomState(13)
    a = rng.randn(70, 70)
    a = (a + a.T) / 2
    vals, vecs = spectrum.eigh_banded_staged(jnp.asarray(a),
                                             bandwidth=4)
    assert np.allclose(np.asarray(vals), np.linalg.eigvalsh(a),
                       atol=1e-9)
    _eigh_banded_checks(a, vals, vecs, 1e-8, 1e-9)

    with pytest.raises(ValueError, match="single"):
        spectrum.eigh_banded_staged(jnp.zeros((2, 8, 8)))


def test_eigh_banded_batched():
    from springcraft_tpu.ops import spectrum

    rng = np.random.RandomState(8)
    batch = rng.randn(3, 70, 70)
    batch = (batch + np.swapaxes(batch, 1, 2)) / 2
    vals, vecs = spectrum.eigh_banded(jnp.asarray(batch), bandwidth=4)
    for i in range(3):
        assert np.allclose(np.asarray(vals[i]),
                           np.linalg.eigvalsh(batch[i]), atol=1e-9)
        _eigh_banded_checks(batch[i], vals[i], vecs[i], 1e-8, 1e-9)


def test_eigh_banded_degenerate_clusters():
    from springcraft_tpu.ops import spectrum

    rng = np.random.RandomState(9)
    q, _ = np.linalg.qr(rng.randn(80, 80))
    lam = np.sort(np.concatenate(
        [np.full(10, 2.0), np.full(5, 2.0 + 1e-9), rng.rand(65) * 10]))
    a = (q * lam) @ q.T
    a = (a + a.T) / 2
    vals, vecs = spectrum.eigh_banded(jnp.asarray(a), bandwidth=4,
                                      window=16)
    assert np.allclose(np.asarray(vals), lam, atol=1e-9)
    _eigh_banded_checks(a, vals, vecs, 1e-7, 1e-7)


def test_eigh_banded_anm_hessian_zero_cluster():
    from springcraft_tpu.ops import ffparams, spectrum
    from springcraft_tpu.ops import assembly as asm

    coord = random_coord(13, 50, box=22.0)
    params = ffparams.invariant_params(12.0)
    h = np.asarray(asm.hessian_matrix(coord, params, jnp,
                                      dtype=jnp.float64, layout="xyz"))
    vals, vecs = spectrum.eigh_banded(jnp.asarray(h), bandwidth=4)
    assert np.allclose(np.asarray(vals), np.linalg.eigvalsh(h),
                       atol=1e-9)
    _eigh_banded_checks(h, vals, vecs, 1e-8, 1e-9)


def test_eigh_banded_float32():
    from springcraft_tpu.ops import spectrum

    rng = np.random.RandomState(11)
    a = rng.randn(96, 96).astype(np.float32)
    a = (a + a.T) / 2
    vals, vecs = spectrum.eigh_banded(jnp.asarray(a), bandwidth=4)
    scale = np.linalg.norm(a, 2)
    res = np.linalg.norm(a @ np.asarray(vecs).T
                         - np.asarray(vecs).T * np.asarray(vals)[None],
                         axis=0)
    assert res.max() / scale < 5e-4
    gram = np.asarray(vecs) @ np.asarray(vecs).T
    assert np.max(np.abs(gram - np.eye(96))) < 1e-3


@pytest.mark.parametrize("bandwidth", [2, 4])
def test_banded_eigenvectors_band_residuals(bandwidth):
    """Factored inverse iteration yields eigenvectors of the band
    matrices themselves (band-space residuals; signs and cluster
    rotations are free)."""
    from springcraft_tpu.ops import spectrum

    rng = np.random.RandomState(13)
    batch = rng.randn(2, 150, 150).astype(np.float32)
    batch = (batch + np.swapaxes(batch, 1, 2)) / 2
    diags = jax.vmap(lambda m: spectrum.band_reduce(m, bandwidth))(
        jnp.asarray(batch))
    vals = spectrum.banded_eigenvalues(diags, n_iter=40)
    u = np.asarray(spectrum.banded_eigenvectors(diags, vals))
    for i in range(2):
        d = np.asarray(diags[i])
        band = np.zeros((150, 150))
        for k in range(bandwidth + 1):
            idx = np.arange(150 - k)
            band[idx, idx + k] = d[k, :150 - k]
            band[idx + k, idx] = d[k, :150 - k]
        res = np.linalg.norm(
            band @ u[i] - u[i] * np.asarray(vals[i])[None, :], axis=0)
        # un-refined inverse-iteration quality (the eigh_banded
        # pipeline polishes further)
        assert np.median(res) < 1e-3, i
