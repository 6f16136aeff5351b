"""
Smoke run of the ENM main paths on one CUDA GPU, at deployment sizes.

    python chip_smoke.py               # phases 0-4 on one card
    python chip_smoke.py --four-cards  # only the sharded paths, 4 cards

Phases, in one process (nothing is caught: a failed check exits
non-zero and prints no result line):

0. ``pytest -m chip`` in a child process, before this process touches
   the card (one process holds the card at a time).
1. Device report: platform, device kind and count, ``nvidia-smi`` name
   and power limit, JAX version, ``XLA_FLAGS``, compile-cache directory.
2. Ensemble fluctuation NMA, 1,024 conformers x 300 CA, float32, default
   routing, invariant 13 A and sdENM force fields, against independent
   float64 references on 8 conformers.
3. 7cal (1,776 CA, eANM): f32 device MSF against host float64 (the TF32
   gate) and ``ANM.lowest_modes(20)`` against float64 ``eigh``.
4. Matrix-free at 30,000 atoms: the compiled block-sparse ``H @ X``
   against XLA's ``hessian_apply``, and ``lowest_modes_matfree(k=10)``.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.realpath(__file__))

#: Phase 2: conformers, residues, conformers checked against float64
ENSEMBLE = (1024, 300, 8)
#: Phase 4: atoms, H @ X columns, modes
MATFREE = (30_000, 20, 10)
#: Four-card option: conformers of the sharded ensemble
FOUR_CARD_ENSEMBLE = 4096


def log(msg):
    print(msg, flush=True)


def check(name, value, limit):
    """Print one comparison and stop the run if it fails."""
    ok = bool(value <= limit)
    log(f"  {name}: {value:.3e} (limit {limit:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"chip_smoke: {name} = {value:.3e} > {limit:.0e}")


def probe_platform():
    """JAX's platform, from a child process, so this one stays off the
    card until the chip-marked tests have run."""
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices()[0].platform)"],
        capture_output=True, text=True, cwd=ROOT)
    lines = out.stdout.strip().splitlines()
    return lines[-1] if out.returncode == 0 and lines else None


def phase_chip_tests():
    env = dict(os.environ, SPRINGCRAFT_TEST_GPU="1")
    t0 = time.perf_counter()
    rc = subprocess.run(
        [sys.executable, "-m", "pytest", "-m", "chip", "-q",
         "-p", "no:cacheprovider", "tests"], env=env, cwd=ROOT).returncode
    log(f"phase 0: pytest -m chip rc={rc} "
        f"({time.perf_counter() - t0:.1f} s)")
    if rc != 0:
        raise SystemExit("chip_smoke: chip-marked tests failed")


def card_report():
    """``name, power.limit`` of every card, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    if out.returncode != 0:
        raise SystemExit(f"chip_smoke: nvidia-smi failed: {out.stderr}")
    return out.stdout.strip()


def phase_device_report(jax):
    from springcraft_tpu.utils import config

    devices = jax.devices()
    log(f"phase 1: platform={devices[0].platform} "
        f"device_kind={devices[0].device_kind} count={len(devices)}")
    log(f"  jax {jax.__version__}; XLA_FLAGS="
        f"{os.environ.get('XLA_FLAGS', '')!r}; compile cache "
        f"{config.compile_cache_dir()}")
    log(f"  nvidia-smi: {card_report()}")


def _max_rel(got, ref):
    import numpy as np

    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _timed_twice(fn, *args):
    """(compile + first run seconds, steady-state seconds, output)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return first, time.perf_counter() - t0, out


def phase_ensemble(n_conf, n_res, n_check, seed=0):
    """Batched fluctuation NMA with default routing, invariant and
    sdENM force fields.  Returns ``{name: (value, limit)}`` plus the
    two timings per force field."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import cpu_reference as ref
    import springcraft_tpu as sc
    from springcraft_tpu import parallel
    from springcraft_tpu.ops import ffparams

    coords = ref.make_batches(1, n_conf, n_res, seed=seed)[0]
    coords_d = jax.device_put(jnp.asarray(coords))
    atoms = ref.make_ca_atoms(n_res)
    sd_ff = sc.TabulatedForceField.sd_enm(atoms)
    fields = {
        "invariant": ffparams.invariant_params(ref.CUTOFF),
        "sdENM": sd_ff.to_compact_params(),
    }
    results, timings = {}, {}
    for name, params in fields.items():
        fn = jax.jit(lambda c, p=params: parallel.ensemble_anm_fluctuations(
            c, p, with_dcc=True, with_covariance=False, dtype=jnp.float32))
        first, steady, out = _timed_twice(fn, coords_d)
        timings[name] = (first, steady)
        msf = np.asarray(out["msf"], np.float64)
        dcc = np.asarray(out["dcc"], np.float64)
        if not (np.isfinite(msf).all() and np.isfinite(dcc).all()):
            raise SystemExit(f"chip_smoke: non-finite {name} ensemble output")
        msf_err = dcc_err = 0.0
        for i in range(n_check):
            if name == "invariant":
                msf_ref, _, dcc_ref = ref.fluctuation_reference(coords[i])
            else:
                conformer = atoms.copy()
                conformer.coord = coords[i]
                anm = sc.ANM(conformer, sd_ff)
                msf_ref = np.asarray(anm.mean_square_fluctuation())
                dcc_ref = np.asarray(anm.dcc(norm=True))
            msf_err = max(msf_err, float(np.max(
                np.abs(msf[i] - msf_ref) / np.abs(msf_ref))))
            dcc_err = max(dcc_err, float(np.max(np.abs(dcc[i] - dcc_ref))))
        results[f"{name} MSF max rel err"] = (msf_err, 1e-3)
        results[f"{name} DCC max abs err"] = (dcc_err, 1e-3)
    return results, timings


def load_7cal_ca():
    from springcraft_tpu.structure import load_structure

    atoms = load_structure(os.path.join(ROOT, "tests", "data", "7cal.pdb"),
                           model=1)
    return atoms[(atoms.atom_name == "CA") & (atoms.element == "C")]


def phase_single(ca, k=20):
    """f32 device MSF and lowest modes of one structure (eANM) against
    the host float64 path."""
    import jax.numpy as jnp
    import numpy as np

    import springcraft_tpu as sc
    from springcraft_tpu.parallel import pipeline

    ff = sc.TabulatedForceField.e_anm(ca)
    host = sc.ANM(ca, ff)                       # float64 NumPy backend
    msf64 = np.asarray(host.mean_square_fluctuation(), np.float64)
    t0 = time.perf_counter()
    out = pipeline.anm_fluctuations(jnp.asarray(ca.coord, jnp.float32),
                                    ff.to_compact_params(), with_dcc=False)
    msf32 = np.asarray(out["msf"], np.float64)
    msf_s = time.perf_counter() - t0
    rel_rmse = float(np.sqrt(np.mean((msf32 - msf64) ** 2)
                             / np.mean(msf64 ** 2)))
    truth = np.asarray(host.eigen()[0], np.float64)[6:6 + k]

    t0 = time.perf_counter()
    vals, _, res = host.lowest_modes(k)
    modes_s = time.perf_counter() - t0
    raw = float(np.max(np.abs(np.asarray(vals, np.float64) - truth)
                       / truth))
    vals_r, _, _ = host.lowest_modes(k, refine=True)
    refined = float(np.max(np.abs(np.asarray(vals_r) - truth) / truth))
    results = {
        "MSF rel RMSE vs float64 (TF32 gate)": (rel_rmse, 1e-3),
        f"lowest {k} eigenvalues max rtol": (raw, 1e-3),
        f"lowest {k} refined eigenvalues max rtol": (refined, 1e-6),
    }
    return results, {"msf first call": msf_s, "lowest modes": modes_s}


def phase_matfree(n_atoms, k_cols, k_modes, interpret=False):
    """Compiled block-sparse ``H @ X`` against XLA's dense-grid apply,
    and the Chebyshev lowest modes through the sparse kernel."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import cpu_reference as ref
    from springcraft_tpu.ops import ffparams, matfree

    coord = ref.make_ca_atoms(n_atoms).coord.astype(np.float32)
    params = ffparams.invariant_params(ref.CUTOFF)
    perm = matfree.spatial_sort_permutation(coord)
    sorted_c = jnp.asarray(coord[perm])
    nbr, counts = matfree.tile_neighbor_lists(coord[perm], ref.CUTOFF)
    x = jnp.asarray(np.random.RandomState(4).randn(3 * n_atoms, k_cols),
                    jnp.float32)
    ids = jnp.asarray(perm, jnp.int32)
    sparse_fn = jax.jit(lambda c, v: matfree.hessian_apply_pallas_sparse(
        c, v, params, nbr, counts, orig_ids=ids, interpret=interpret))
    dense_fn = jax.jit(lambda c, v: matfree.hessian_apply(c, v, params))
    s_first, s_steady, y_sparse = _timed_twice(sparse_fn, sorted_c, x)
    d_first, d_steady, y_dense = _timed_twice(dense_fn, sorted_c, x)
    apply_err = _max_rel(np.asarray(y_sparse, np.float64),
                         np.asarray(y_dense, np.float64))

    sparse = not interpret
    t0 = time.perf_counter()
    vals, vecs, res = matfree.lowest_modes_matfree(
        coord, params, k_modes, tol=1e-4, sparse=sparse)
    res = np.asarray(res)
    modes_s = time.perf_counter() - t0
    if not np.isfinite(np.asarray(vals)).all():
        raise SystemExit("chip_smoke: non-finite matrix-free eigenvalues")
    results = {
        "sparse H@X vs XLA hessian_apply max rel err": (apply_err, 1e-5),
        f"lowest_modes_matfree(k={k_modes}) max residual":
            (float(np.max(res)), 1e-3),
    }
    timings = {"sparse H@X": s_steady, "XLA H@X": d_steady,
               "sparse compile+first": s_first, "modes": modes_s,
               "mean neighbour tiles": float(np.mean(counts))}
    return results, timings


def phase_four_cards(n_conf, n_res, ca, block=444):
    """The sharded paths on 4 cards: the sharded ensemble against the
    same conformers on one card, and the distributed Cholesky MSF of
    `ca` (eANM) against the host float64 MSF.  `block` is the
    distributed Cholesky's panel width (it must divide ``3 * len(ca)``
    into a multiple of 4 panels).  The one-card float32 Cholesky MSF is
    printed beside it for information: on the card it carries ~2e-4 of
    float32 rounding itself (phase 3), so it is no reference at 1e-4."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import cpu_reference as ref
    import springcraft_tpu as sc
    from springcraft_tpu import parallel
    from springcraft_tpu.ops import assembly, ffparams, rigid
    from springcraft_tpu.parallel import make_mesh

    params = ffparams.invariant_params(ref.CUTOFF)
    coords = ref.make_batches(1, n_conf, n_res, seed=1)[0]
    mesh = make_mesh(4)
    t0 = time.perf_counter()
    sharded = jax.block_until_ready(parallel.sharded_ensemble_anm_fluctuations(
        coords, params, mesh, with_dcc=True, with_covariance=False,
        dtype=jnp.float32))
    sharded_s = time.perf_counter() - t0
    one = jax.devices()[0]
    fn = jax.jit(lambda c: parallel.ensemble_anm_fluctuations(
        c, params, with_dcc=True, with_covariance=False, dtype=jnp.float32))
    chunk = n_conf // 4
    single = {k: [] for k in ("msf", "dcc")}
    for s in range(0, n_conf, chunk):
        out = fn(jax.device_put(jnp.asarray(coords[s:s + chunk]), one))
        for k in single:
            single[k].append(np.asarray(out[k]))
    results = {}
    for k in single:
        results[f"sharded ensemble {k} rel err"] = (_max_rel(
            np.asarray(sharded[k], np.float64),
            np.concatenate(single[k]).astype(np.float64)), 1e-5)

    ff = sc.TabulatedForceField.e_anm(ca)
    cparams = ff.to_compact_params()
    coord = jnp.asarray(ca.coord, jnp.float32)
    n = coord.shape[0]
    msf64 = np.asarray(sc.ANM(ca, ff).mean_square_fluctuation(), np.float64)
    t0 = time.perf_counter()
    msf4 = np.asarray(parallel.sharded_all_mode_msf(
        coord, cparams, make_mesh(4, row_axis=4), block=block)["msf"],
        np.float64)
    blocked_s = time.perf_counter() - t0
    with jax.default_device(one):
        h = assembly.hessian_matrix(coord, cparams, jnp, dtype=jnp.float32,
                                    layout="xyz")
        t = rigid.rigid_modes_anm(coord, layout="xyz")
        diag = np.asarray(rigid.pinv_diagonal(h, t, block_size=3 * n // 4),
                          np.float64)
    msf1 = diag[:n] + diag[n:2 * n] + diag[2 * n:]
    log(f"  one-card float32 Cholesky MSF rel err vs float64: "
        f"{_max_rel(msf1, msf64):.3e}; distributed vs one card: "
        f"{_max_rel(msf4, msf1):.3e}")
    results["distributed Cholesky 7cal MSF rel err vs float64"] = (
        _max_rel(msf4, msf64), 1e-4)
    return results, {"sharded ensemble first call": sharded_s,
                      "distributed Cholesky first call": blocked_s}


def main(argv):
    four = "--four-cards" in argv
    if not os.path.isdir(os.path.join(ROOT, "springcraft_tpu")):
        raise SystemExit("chip_smoke: run from a checkout of the repository")
    platform = probe_platform()
    if platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a CUDA GPU, JAX found "
                         f"{platform!r}")
    if not four:
        phase_chip_tests()

    sys.path.insert(0, ROOT)
    import jax

    from springcraft_tpu.utils import config

    config.enable_compile_cache()
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit("chip_smoke: needs a CUDA GPU")
    phase_device_report(jax)
    card = card_report().splitlines()[0]

    def report(title, results, timings):
        log(title)
        for name, (value, limit) in results.items():
            check(name, value, limit)
        for name, seconds in timings.items():
            log(f"  {name}: {seconds:.4f} [{card}]")

    if four:
        if len(devices) != 4:
            raise SystemExit(f"chip_smoke: --four-cards needs 4 GPUs, "
                             f"found {len(devices)}")
        report("four cards: sharded ensemble + distributed Cholesky",
               *phase_four_cards(FOUR_CARD_ENSEMBLE, ENSEMBLE[1],
                                 load_7cal_ca()))
    else:
        results, timings = phase_ensemble(*ENSEMBLE)
        flat = {f"{k} compile+first s": v[0] for k, v in timings.items()}
        flat.update({f"{k} steady s": v[1] for k, v in timings.items()})
        report(f"phase 2: ensemble {ENSEMBLE[0]} x N={ENSEMBLE[1]}",
               results, flat)
        report("phase 3: 7cal single structure",
               *phase_single(load_7cal_ca()))
        report(f"phase 4: matrix-free n={MATFREE[0]}",
               *phase_matfree(*MATFREE))

    log(card_report())
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
