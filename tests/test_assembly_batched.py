"""
Float32 batched assembly on the device path (XLA): the ensemble
Hessian and Kirchhoff stacks of ``parallel.pipeline`` must match the
float64 reference assembly for every supported force-field family,
at padded and unpadded sizes, with patch overlays and mass weights.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import springcraft_tpu as sc
from springcraft_tpu.ops import assembly, ffparams, matfree
from springcraft_tpu.parallel import pipeline


def _rel_err(test, ref):
    scale = max(float(np.max(np.abs(ref))), 1e-12)
    return float(np.max(np.abs(np.asarray(test) - ref))) / scale


def _jiggle(coord, n_conf, scale=0.3, seed=7):
    rng = np.random.RandomState(seed)
    return (coord[None] + scale * rng.randn(n_conf, *coord.shape)
            ).astype(np.float32)


def _ref_hessians(coords, params, masses=None):
    out = []
    for c in coords:
        h = np.asarray(assembly.hessian_matrix(
            c.astype(np.float64), params, jnp, layout="xyz"))
        if masses is not None:
            w = np.tile(1.0 / np.sqrt(masses), 3)
            h = h * w[:, None] * w[None, :]
        out.append(h)
    return np.stack(out)


def _ref_kirchhoffs(coords, params):
    return np.stack([np.asarray(assembly.kirchhoff_matrix(
        c.astype(np.float64), params, jnp)) for c in coords])


def _hessians32(coords, params, masses=None):
    return pipeline._build_hessians_batched(
        jnp.asarray(coords), params, masses, jnp.float32)


def _kirchhoffs32(coords, params, masses=None):
    return pipeline._build_kirchhoffs_batched(
        jnp.asarray(coords), params, masses, jnp.float32)


@pytest.fixture(scope="module")
def coords():
    rng = np.random.RandomState(0)
    return (rng.rand(100, 3) * 12).astype(np.float32)


@pytest.fixture(scope="module")
def shifted_two_chain(ca_1l2y):
    first = ca_1l2y.copy()
    second = ca_1l2y.copy()
    first.chain_id[:] = "A"
    second.chain_id[:] = "B"
    second.coord = second.coord + np.float32(8.0)
    return first + second


_ANALYTIC = {
    "invariant": lambda: ffparams.invariant_params(8.0),
    "hinsen": lambda: ffparams.hinsen_params(),
    "pfenm": lambda: ffparams.pfenm_params(),
    "hinsen_cutoff": lambda: ffparams.hinsen_params(9.0),
}


@pytest.mark.parametrize("family", sorted(_ANALYTIC))
@pytest.mark.parametrize("n", [100, 70])
def test_hessian_analytic(coords, family, n):
    params = _ANALYTIC[family]()
    batch = _jiggle(coords[:n], 2)
    test = _hessians32(batch, params)
    assert test.shape == (2, 3 * n, 3 * n) and test.dtype == jnp.float32
    assert _rel_err(test, _ref_hessians(batch, params)) < 1e-6


@pytest.mark.parametrize("family", ["invariant", "pfenm"])
def test_kirchhoff_analytic(coords, family):
    params = _ANALYTIC[family]()
    batch = _jiggle(coords, 2)
    test = _kirchhoffs32(batch, params)
    assert _rel_err(test, _ref_kirchhoffs(batch, params)) < 1e-6


@pytest.mark.parametrize("maker", ["e_anm", "sd_enm", "s_enm_10"])
def test_tabulated_compact(shifted_two_chain, maker):
    ff = getattr(sc.TabulatedForceField, maker)(shifted_two_chain)
    params = ff.to_compact_params()
    batch = _jiggle(shifted_two_chain.coord, 3)
    assert _rel_err(_hessians32(batch, params),
                    _ref_hessians(batch, params)) < 1e-5
    assert _rel_err(_kirchhoffs32(batch, params),
                    _ref_kirchhoffs(batch, params)) < 1e-5


@pytest.mark.parametrize("maker", ["e_anm", "sd_enm"])
def test_compact_matches_pair_table(shifted_two_chain, maker):
    """The O(n) compact tables and the O(n^2) pair table of one force
    field assemble the same float32 Hessian."""
    ff = getattr(sc.TabulatedForceField, maker)(shifted_two_chain)
    batch = _jiggle(shifted_two_chain.coord, 2)
    compact = _hessians32(batch, ff.to_compact_params())
    pair = _hessians32(batch, ff.to_params())
    assert _rel_err(compact, np.asarray(pair, np.float64)) < 1e-6


def test_compact_constants_select_tables(shifted_two_chain):
    """Bonded neighbours read the bonded table, same-chain pairs the
    intra table, cross-chain pairs the inter table."""
    ff = sc.TabulatedForceField.sd_enm(shifted_two_chain)
    params = ff.to_compact_params()
    n = len(shifted_two_chain)
    n_half = n // 2  # two equal chains appended
    ti = np.asarray(params.type_idx)
    for b in (0, params.n_bins // 2, params.n_bins - 1):
        edges = np.asarray(params.edges_sq)
        sq = float(edges[b]) - 1e-3 if b < len(edges) else 1e9
        sq_mat = np.full((n, n), sq)
        k = np.asarray(ffparams._compact_constants(sq_mat, params, np))
        assert k[0, 1] == pytest.approx(
            float(np.asarray(params.bonded_table)[ti[0], ti[1], b]))
        assert k[0, 2] == pytest.approx(
            float(np.asarray(params.intra_table)[ti[0], ti[2], b]))
        assert k[0, n_half + 2] == pytest.approx(float(np.asarray(
            params.inter_table)[ti[0], ti[n_half + 2], b]))
        # chain boundary: last of A / first of B are not bonded
        assert k[n_half - 1, n_half] == pytest.approx(float(np.asarray(
            params.inter_table)[ti[n_half - 1], ti[n_half], b]))


def test_table_pair_not_matrix_free(coords):
    """O(n^2)-parameter families take the dense path only."""
    params = ffparams.table_pair_params(np.ones((100, 100, 1)), None)
    assert not matfree.supports_params(params)
    batch = _jiggle(coords, 1)
    assert _rel_err(_hessians32(batch, params),
                    _ref_hessians(batch, params)) < 1e-6


def test_mass_weighted_batch(coords):
    params = ffparams.invariant_params(8.0)
    masses = np.linspace(1.0, 3.0, 100)
    batch = _jiggle(coords, 2)
    test = _hessians32(batch, params, jnp.asarray(masses, jnp.float32))
    assert _rel_err(test, _ref_hessians(batch, params, masses)) < 1e-6


def _overlay_params(coord, base):
    """An overlay that switches off real contacts and forces on a
    distant pair with an override value."""
    n = len(coord)
    d2 = np.sum((coord[:, None] - coord[None, :]) ** 2, axis=-1)
    off = np.zeros((n, n), bool)
    on = np.zeros((n, n), bool)
    values = np.zeros((n, n))
    ci, cj = np.nonzero(np.triu(d2 <= 36.0, 1))
    for t in range(min(3, len(ci))):
        off[ci[t], cj[t]] = off[cj[t], ci[t]] = True
    far = np.unravel_index(np.argmax(d2), d2.shape)
    on[far] = on[far[::-1]] = True
    values[far] = values[far[::-1]] = 2.5
    return ffparams.with_overlay(base, off, on, values, on.copy())


def test_hessian_overlays(coords):
    params = _overlay_params(coords, ffparams.invariant_params(8.0))
    batch = _jiggle(coords, 2, scale=0.02, seed=5)
    assert _rel_err(_hessians32(batch, params),
                    _ref_hessians(batch, params)) < 1e-6


def test_kirchhoff_overlays(coords):
    params = _overlay_params(coords, ffparams.invariant_params(8.0))
    batch = _jiggle(coords, 2, scale=0.02, seed=5)
    assert _rel_err(_kirchhoffs32(batch, params),
                    _ref_kirchhoffs(batch, params)) < 1e-6


def test_patched_force_field(two_chain_ca):
    """A model-level PatchedForceField (reference forcefield.py:117-261)
    lowers to params the batched assembly accepts directly."""
    inner = sc.InvariantForceField(8.0)
    ff = sc.PatchedForceField(inner, contact_pair_on=[(0, 30)],
                              force_constants=[4.0])
    params = ff.to_params(two_chain_ca.array_length())
    assert matfree.supports_params(params)
    batch = _jiggle(np.asarray(two_chain_ca.coord, np.float32), 2,
                    scale=0.05)
    assert _rel_err(_hessians32(batch, params),
                    _ref_hessians(batch, params)) < 1e-6
