"""
Tests that need a CUDA GPU: the compiled block-sparse Pallas kernel
against XLA's dense-grid apply, and the float32 precision (TF32) gate.
They skip elsewhere; run them on the card with

    SPRINGCRAFT_TEST_GPU=1 python -m pytest -m chip
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cpu_reference
import springcraft_tpu as sc
from springcraft_tpu.ops import ffparams, matfree

pytestmark = pytest.mark.chip


@pytest.fixture
def gpu():
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip("needs a CUDA GPU (SPRINGCRAFT_TEST_GPU=1 "
                    "python -m pytest -m chip)")
    return device


@pytest.mark.parametrize("family", ["invariant", "sdENM"])
def test_sparse_apply_compiled_matches_xla(gpu, family):
    atoms = cpu_reference.make_ca_atoms(5000, seed=3)
    if family == "invariant":
        params = ffparams.invariant_params(13.0)
    else:
        params = sc.TabulatedForceField.sd_enm(atoms).to_compact_params()
    coord = np.asarray(atoms.coord, np.float32)
    n = coord.shape[0]
    nbr, counts = matfree.tile_neighbor_lists(
        coord, float(np.sqrt(params.cutoff_sq)))
    rng = np.random.RandomState(5)
    x = jnp.asarray(rng.randn(3 * n, 20), jnp.float32)
    y = matfree.hessian_apply_pallas_sparse(coord, x, params, nbr, counts)
    y_ref = matfree.hessian_apply(coord, x, params, dtype=jnp.float32)
    scale = float(jnp.max(jnp.abs(y_ref)))
    assert float(jnp.max(jnp.abs(y - y_ref))) / scale < 1e-5

    xk = jnp.asarray(rng.randn(n, 20), jnp.float32)
    yk = matfree.kirchhoff_apply_pallas_sparse(coord, xk, params, nbr,
                                               counts)
    yk_ref = matfree.kirchhoff_apply(coord, xk, params, dtype=jnp.float32)
    scale = float(jnp.max(jnp.abs(yk_ref)))
    assert float(jnp.max(jnp.abs(yk - yk_ref))) / scale < 1e-5


def test_tf32_gate_7cal(gpu, ca_7cal):
    """Float32 MSF on the card tracks the host float64 MSF to ~1e-5; a
    reading near 1e-3..1e-2 means a float32 contraction ran in TF32."""
    from springcraft_tpu.parallel import pipeline

    ff = sc.TabulatedForceField.e_anm(ca_7cal)
    msf64 = np.asarray(sc.ANM(ca_7cal, ff).mean_square_fluctuation(),
                       np.float64)
    out = pipeline.anm_fluctuations(
        jnp.asarray(ca_7cal.coord, jnp.float32), ff.to_compact_params(),
        with_dcc=False)
    msf32 = np.asarray(out["msf"], np.float64)
    rel_rmse = np.sqrt(np.mean((msf32 - msf64) ** 2) / np.mean(msf64**2))
    assert rel_rmse < 1e-3
