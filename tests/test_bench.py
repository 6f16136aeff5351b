"""Guards on the benchmark harness (``bench.py``) and the float64
reference it shares with ``chip_smoke.py`` (``cpu_reference.py``).

The bench measures a CUDA GPU only, but its host-side pieces — the CPU
reference baseline, the batch generators, the section table — are pure
NumPy and must not bit-rot: the headline ``vs_baseline`` figure is only
meaningful if the CPU baseline computes the *same observables* as the
device pipeline (reference semantics:
``/root/reference/src/springcraft/anm.py:133-136``, ``nma.py:324-353``).
"""

import importlib.util
import os

import numpy as np
import pytest

import cpu_reference

_REPO = os.path.dirname(os.path.dirname(os.path.realpath(__file__)))


@pytest.fixture(scope="module")
def bench():
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(_REPO, "bench.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_bench_surface(bench):
    for name in ("main", "bench_headline", "bench_mega", "run_section",
                 "bench_cpu_baselines", "device_tag", "report",
                 "_load_cpu_baseline"):
        assert callable(getattr(bench, name)), name


def test_section_dispatch_names(bench):
    """Every advertised section has a runner; unknown names raise."""
    assert set(bench.SECTIONS) == set(bench._RUNNERS)
    with pytest.raises(ValueError, match="unknown bench section"):
        bench.run_section("no-such-section")


def test_main_refuses_cpu(bench):
    """A device metric never falls back to the CPU."""
    with pytest.raises(SystemExit, match="CUDA GPU"):
        bench.main(["--section", "cpu-baseline"])


def test_committed_cpu_baseline_loads(bench):
    """BASELINE_CPU.json (the headline JSON's denominator) is
    committed, loads, and carries plausible idle-host rates."""
    base = bench._load_cpu_baseline()
    assert base is not None, "BASELINE_CPU.json missing or unreadable"
    assert 0.1 < base["fluct_solves_per_s"] < 1000
    assert 0.1 < base["spectral_solves_per_s"] < 1000
    assert base["n_res"] == bench.N_RES


def test_cpu_baseline_hessian_matches_library():
    """cpu_reference.cpu_hessian == the library's reference-parity
    assembly."""
    from springcraft_tpu import InvariantForceField
    from springcraft_tpu.models.interaction import compute_hessian

    ref = cpu_reference
    coord = ref.make_batches(1, 1, ref.N_RES, seed=3)[0][0]
    coord = np.asarray(coord, dtype=np.float64)
    baseline = ref.cpu_hessian(coord)
    lib, _ = compute_hessian(
        coord, InvariantForceField(ref.CUTOFF), return_pairs=False)
    np.testing.assert_allclose(baseline, np.asarray(lib),
                               rtol=1e-10, atol=1e-10)


def test_cpu_baseline_observables():
    """The reference solve returns finite MSF/B-factor/DCC with the
    reference's shapes and the DCC unit diagonal."""
    ref = cpu_reference
    coord = np.asarray(ref.make_batches(1, 1, ref.N_RES, seed=4)[0][0],
                       dtype=np.float64)
    msf, bfac, dcc = ref.fluctuation_reference(coord)
    assert msf.shape == (ref.N_RES,)
    assert np.all(msf > 0)
    np.testing.assert_allclose(bfac, 8 * np.pi**2 * msf / 3)
    np.testing.assert_allclose(np.diagonal(dcc), 1.0, atol=1e-12)
    assert np.all(np.isfinite(dcc))


def test_cpu_reference_matches_device_pipeline():
    """The float64 reference and the library's fluctuation pipeline (in
    float64 here) agree — the comparison ``chip_smoke.py`` makes on the
    card in float32."""
    import jax.numpy as jnp

    from springcraft_tpu.ops import ffparams
    from springcraft_tpu.parallel import pipeline

    ref = cpu_reference
    coords = ref.make_batches(1, 2, ref.N_RES, seed=5)[0]
    out = pipeline.ensemble_anm_fluctuations(
        coords.astype(np.float64), ffparams.invariant_params(ref.CUTOFF),
        with_dcc=True, with_covariance=False, dtype=jnp.float64)
    for i in range(2):
        msf, _, dcc = ref.fluctuation_reference(coords[i])
        np.testing.assert_allclose(np.asarray(out["msf"][i]), msf,
                                   rtol=1e-8)
        np.testing.assert_allclose(np.asarray(out["dcc"][i]), dcc,
                                   atol=1e-8)


def test_golden_mega_msf_artifact_and_generator_formula(bench):
    """The committed 20,736-dim f64 all-mode MSF golden must (a) load
    with consistent metadata and (b) be produced by a sound formula:
    the generator's shift-trick (``diag(pinv(H)) = diag((H + sigma
    T T^t)^-1) - diag(T T^t)/sigma``) is re-derived here at small scale
    against ``pinvh``."""
    path = os.path.join(_REPO, "tests", "data",
                        "golden_mega_msf_20736.npz")
    golden = np.load(path)
    assert int(golden["n_res"]) == 6912
    msf = np.asarray(golden["msf"])
    assert msf.shape == (6912,)
    assert np.all(np.isfinite(msf)) and np.all(msf > 0)

    # formula check at n=120 vs exact pinvh
    import jax.numpy as jnp
    from scipy.linalg import cholesky, lapack

    from springcraft_tpu.ops import assembly, ffparams, linalg, modes

    from springcraft_tpu.utils import network

    rng = np.random.RandomState(3)
    coord = rng.rand(120, 3) * 14.0
    params = ffparams.invariant_params(9.0)
    # the shift trick assumes the six rigid modes are the WHOLE null
    # space — guaranteed only on a connected network (same assert as
    # the generator)
    assert network.is_connected(coord, 9.0)
    h = np.asarray(assembly.hessian_matrix(coord, params, np,
                                           dtype=np.float64,
                                           layout="xyz"))
    t = modes._rigid_basis_np(coord)[
        assembly.atom_to_xyz_permutation(120)]
    sigma = float(np.mean(np.diagonal(h)))
    a = h + sigma * (t @ t.T)
    chol = cholesky(a, lower=True)
    linv, info = lapack.dtrtri(chol, lower=1)
    assert info == 0
    diag = np.einsum("ki,ki->i", linv, linv) \
        - np.sum(t * t, axis=1) / sigma
    exact = np.diagonal(np.asarray(linalg.pinvh(jnp.asarray(h))))
    assert np.allclose(diag, exact, rtol=1e-8, atol=1e-10)
