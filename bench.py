"""
Benchmark harness: the ENM deployments on one CUDA GPU, in one process.

Headline (cf. BASELINE.json "NMA solves/sec batched"): complete
fluctuation-NMA solves per second — Hessian assembly + all-mode
covariance + MSF + B-factors + normalized DCC for a 300-residue protein,
batched over a 1,024-conformer ensemble, default routing.  The
denominator is the committed single-thread float64 NumPy reference
architecture (``BASELINE_CPU.json``; re-measured by the
``cpu-baseline`` section from ``cpu_reference.py``).

Sections (``python bench.py --section NAME [NAME ...]``; all of them in
order when none is named):

* ``assembly`` — the dense XLA Hessian builds alone: the 1,024 x N=300
  ensemble (invariant and sdENM) and 7cal;
* ``fluctuation`` — the covariance engines at the headline shape:
  ``inverse="cho_solve"`` (XLA Cholesky) vs ``"blocked"`` (recursive
  inverse factor), per call and chunked;
* ``spectral`` — banded k=20 and two-stage full eigensystems vs XLA
  ``eigh``;
* ``tabulated`` — the headline configuration with sdENM type tables;
* ``single-structure`` — 7cal (5,328 dims): shift-invert lowest modes
  with both engines, full ``eigh``, and an N=2,000 ensemble point;
* ``mega-assembly`` — 10k-residue sdENM: dense build, 20(+4) modes,
  float64 refinement;
* ``matrix-free`` — 30k atoms: block-sparse vs dense-grid ``H @ X``,
  and the Chebyshev mode solver through each;
* ``matrix-free-xl`` — 100k-atom ANM and 1M-atom GNM;
* ``cpu-baseline`` — the float64 NumPy reference rates on this host.

Timing: every measured call ends in ``jax.block_until_ready``; the first
call of each program is reported as compile + first run.  Every result
line names the device it ran on; a run that finds no GPU stops.  The
last line of standard output is one JSON object with the headline rate.
"""

import functools
import json
import os
import sys
import time

import numpy as np

from cpu_reference import (
    CA_DENSITY,
    CUTOFF,
    N_RES,
    cpu_hessian,
    fluctuation_reference,
    make_batches,
    make_ca_atoms,
)

#: Conformers per headline call
MEGABATCH = 1024
#: Measured calls after the compile call
ITERS = 3
CPU_ITERS = 3

SECTIONS = ("assembly", "fluctuation", "spectral", "tabulated",
            "single-structure", "mega-assembly", "matrix-free",
            "matrix-free-xl", "cpu-baseline")

_ROOT = os.path.dirname(os.path.realpath(__file__))
_BASELINE_CPU_PATH = os.path.join(_ROOT, "BASELINE_CPU.json")


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def device_tag():
    """``platform device_kind xcount`` of the devices JAX runs on."""
    import jax

    devices = jax.devices()
    return (f"{devices[0].platform} {devices[0].device_kind} "
            f"x{len(devices)}")


def report(msg):
    log(f"[{device_tag()}] {msg}")


def _load_cpu_baseline():
    """The committed single-thread f64 NumPy baseline measurement."""
    try:
        with open(_BASELINE_CPU_PATH) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


def _timed(fn, inputs):
    """Compile + run on inputs[0], then time the rest.  Returns
    ``(first_s, steady_s, last_output)``."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(inputs[0]))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for x in inputs[1:]:
        out = jax.block_until_ready(fn(x))
    return first, time.perf_counter() - t0, out


def _timed_once(fn, *args):
    """(first_s, steady_s, output) for one argument tuple."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return first, time.perf_counter() - t0, out


def _device_batches(n_batches, batch, n_res, seed):
    import jax
    import jax.numpy as jnp

    return [jax.device_put(jnp.asarray(b))
            for b in make_batches(n_batches, batch, n_res, seed=seed)]


def _fluct_fn(params, **options):
    import jax
    import jax.numpy as jnp

    from springcraft_tpu.parallel import pipeline

    return jax.jit(lambda b: pipeline.ensemble_anm_fluctuations(
        b, params, with_dcc=True, with_covariance=False,
        dtype=jnp.float32, **options))


def bench_headline():
    """Ensemble fluctuation NMA, 1,024 x N=300, invariant 13 A, float32,
    default routing."""
    from springcraft_tpu.ops import ffparams

    params = ffparams.invariant_params(CUTOFF)
    batches = _device_batches(ITERS + 1, MEGABATCH, N_RES, seed=3)
    first, elapsed, _ = _timed(_fluct_fn(params), batches)
    rate = ITERS * MEGABATCH / elapsed
    report(f"headline fluctuation pipeline ({MEGABATCH} x N={N_RES}, "
           f"default routing): compile+first {first:.2f}s; "
           f"{ITERS * MEGABATCH} solves in {elapsed:.4f}s -> "
           f"{rate:.1f} solves/s")
    return rate


def bench_assembly():
    """The dense Hessian builds alone (XLA fuses the pairwise pass and
    the row sums): the headline ensemble with each force field, and
    7cal (eANM, 5,328 dims)."""
    import jax
    import jax.numpy as jnp

    import springcraft_tpu as sc
    from springcraft_tpu.ops import assembly, ffparams
    from springcraft_tpu.structure import load_structure

    def build_fn(params):
        return jax.jit(jax.vmap(functools.partial(
            assembly.hessian_matrix, params=params, xp=jnp,
            dtype=jnp.float32, layout="xyz")))

    batches = _device_batches(ITERS + 1, MEGABATCH, N_RES, seed=3)
    fields = (("invariant", ffparams.invariant_params(CUTOFF)),
              ("sdENM", sc.TabulatedForceField.sd_enm(
                  make_ca_atoms(N_RES)).to_compact_params()))
    for label, params in fields:
        first, elapsed, _ = _timed(build_fn(params), batches)
        report(f"ensemble Hessian build [{label}] ({MEGABATCH} x "
               f"N={N_RES}): compile+first {first:.2f}s; "
               f"{elapsed / ITERS * 1e3:.3f} ms per batch")

    atoms = load_structure(os.path.join(_ROOT, "tests", "data",
                                        "7cal.pdb"), model=1)
    ca = atoms[(atoms.atom_name == "CA") & (atoms.element == "C")]
    params = sc.TabulatedForceField.e_anm(ca).to_compact_params()
    coord = jax.device_put(jnp.asarray(ca.coord, jnp.float32)[None])
    first, steady, _ = _timed_once(build_fn(params), coord)
    report(f"7cal Hessian build (dim={3 * ca.array_length()}): "
           f"{steady * 1e3:.3f} ms (compile+first {first:.2f}s)")


def bench_fluct_variants():
    """The two covariance engines at the headline shape — the
    measurement behind ``utils.config.ensemble_inverse``."""
    from springcraft_tpu.ops import ffparams

    params = ffparams.invariant_params(CUTOFF)
    batches = _device_batches(ITERS + 1, MEGABATCH, N_RES, seed=3)
    for label, options in (("cho_solve", {"inverse": "cho_solve"}),
                           ("blocked", {"inverse": "blocked"}),
                           ("blocked chunk=128", {"inverse": "blocked",
                                                  "chunk": 128})):
        first, elapsed, _ = _timed(_fluct_fn(params, **options), batches)
        report(f"fluctuation engine [{label}] ({MEGABATCH} x N={N_RES}): "
               f"compile+first {first:.2f}s; "
               f"{ITERS * MEGABATCH / elapsed:.1f} solves/s")


def bench_spectral(batch=128):
    """Spectral pipelines: banded two-stage (k=20 modes and full
    eigensystem) and the XLA ``eigh`` pipeline."""
    import jax
    import jax.numpy as jnp

    from springcraft_tpu.ops import ffparams
    from springcraft_tpu.parallel import pipeline

    params = ffparams.invariant_params(CUTOFF)
    batches = _device_batches(ITERS + 1, batch, N_RES, seed=0)
    variants = (
        ("banded k=20", lambda b: pipeline.ensemble_anm_spectral(
            b, params, dtype=jnp.float32, n_modes=20, n_iter_bisect=32)),
        ("two-stage full", lambda b: pipeline.ensemble_anm_banded(
            b, params, dtype=jnp.float32)),
        ("eigh", jax.vmap(functools.partial(
            pipeline.anm_observables, params=params, dtype=jnp.float32))),
    )
    for label, fn in variants:
        first, elapsed, _ = _timed(jax.jit(fn), batches)
        report(f"spectral pipeline [{label}] ({batch} x N={N_RES}): "
               f"compile+first {first:.2f}s; "
               f"{ITERS * batch / elapsed:.1f} solves/s")


def bench_tabulated():
    """The headline configuration with sdENM type tables."""
    from springcraft_tpu.models import TabulatedForceField

    params = TabulatedForceField.sd_enm(
        make_ca_atoms(N_RES)).to_compact_params()
    batches = _device_batches(ITERS + 1, MEGABATCH, N_RES, seed=3)
    first, elapsed, _ = _timed(_fluct_fn(params), batches)
    report(f"tabulated sdENM fluctuation pipeline ({MEGABATCH} x "
           f"N={N_RES}, default routing): compile+first {first:.2f}s; "
           f"{ITERS * MEGABATCH / elapsed:.1f} solves/s")


def bench_single_structure(k_modes=20):
    """7cal (1,776 CA, eANM): shift-invert lowest modes with each
    engine (the measurement behind ``utils.config.shift_invert_engine``)
    and full ``eigh``; plus an N=2,000 x 8 ensemble point."""
    import jax
    import jax.numpy as jnp

    import springcraft_tpu as sc
    from springcraft_tpu.ops import assembly, ffparams, modes
    from springcraft_tpu.structure import load_structure

    atoms = load_structure(os.path.join(_ROOT, "tests", "data",
                                        "7cal.pdb"), model=1)
    ca = atoms[(atoms.atom_name == "CA") & (atoms.element == "C")]
    n = ca.array_length()
    params = sc.TabulatedForceField.e_anm(ca).to_compact_params()
    coord = jax.device_put(jnp.asarray(ca.coord, jnp.float32))
    build = functools.partial(assembly.hessian_matrix, params=params,
                              xp=jnp, dtype=jnp.float32, layout="xyz")

    for engine in ("chol", "invfactor"):
        def lowk(c, engine=engine):
            h = build(c)
            vals, vecs = modes.lowest_modes_anm(h, c, k=k_modes,
                                                engine=engine)
            return vals, modes.mode_residuals(h, vals, vecs)

        first, steady, out = _timed_once(jax.jit(lowk), coord)
        report(f"7cal (dim={3 * n}) {k_modes} lowest modes [shift-invert "
               f"{engine}]: {steady:.4f}s (compile+first {first:.2f}s, "
               f"max rel residual {float(jnp.max(out[1])):.1e})")

    first, steady, _ = _timed_once(
        jax.jit(lambda c: jnp.linalg.eigh(build(c))), coord)
    report(f"7cal (dim={3 * n}) full eigh: {steady:.4f}s "
           f"(compile+first {first:.2f}s)")

    n2, b2 = 2000, 8
    rng = np.random.RandomState(6)
    spread = (n2 / CA_DENSITY) ** (1.0 / 3.0)
    base = (rng.rand(n2, 3) * spread).astype(np.float32)
    batches = [jax.device_put(jnp.asarray(
        base[None] + 0.05 * rng.randn(b2, n2, 3).astype(np.float32)))
        for _ in range(ITERS + 1)]
    first, elapsed, _ = _timed(
        _fluct_fn(ffparams.invariant_params(CUTOFF)), batches)
    report(f"ensemble point (N={n2}, batch {b2}, default routing): "
           f"compile+first {first:.2f}s; "
           f"{ITERS * b2 / elapsed:.2f} solves/s")


def bench_mega(n_res=10_000, k_modes=20):
    """10k-residue sdENM: 30k-dim Hessian build + 20(+4) lowest modes
    (shift-invert) + float64 Rayleigh-Ritz refinement on host."""
    import jax
    import jax.numpy as jnp

    from springcraft_tpu.models import TabulatedForceField
    from springcraft_tpu.ops import assembly, modes

    atoms = make_ca_atoms(n_res, seed=2)
    params = TabulatedForceField.sd_enm(atoms).to_compact_params()
    coord = jax.device_put(jnp.asarray(atoms.coord))
    build = jax.jit(functools.partial(
        assembly.hessian_matrix, params=params, xp=jnp, dtype=jnp.float32,
        layout="xyz"))
    build_first, build_s, hessian = _timed_once(build, coord)
    k_buf = k_modes + 4

    def modes_checked(h, c):
        vals, vecs = modes.lowest_modes_anm(h, c, k=k_buf)
        return vals, vecs, modes.mode_residuals(h, vals, vecs)

    modes_first, modes_s, out = _timed_once(jax.jit(modes_checked),
                                            hessian, coord)
    max_res = float(np.max(np.asarray(out[2])[:k_modes]))
    del hessian
    t0 = time.perf_counter()
    ref_vals, _, ref_res = modes.refine_modes_f64(
        np.asarray(coord), params, np.asarray(out[1]), layout="xyz")
    refine_s = time.perf_counter() - t0
    raw_vs_ref = float(np.max(
        np.abs(np.asarray(out[0], np.float64)[:k_modes]
               - ref_vals[:k_modes]) / ref_vals[:k_modes]))
    report(f"mega-assembly (n={n_res}, dim={3 * n_res}): build "
           f"{build_s:.3f}s (compile+first {build_first:.1f}s) + "
           f"{k_modes}(+4) modes {modes_s:.3f}s (compile+first "
           f"{modes_first:.1f}s, max rel residual {max_res:.1e}) + f64 "
           f"refinement {refine_s:.2f}s (host) = "
           f"{build_s + modes_s + refine_s:.2f}s; raw f32 vs refined "
           f"rtol {raw_vs_ref:.1e}, refined residuals max "
           f"{float(np.max(ref_res[:k_modes])):.1e}")


def bench_matfree(n_atoms=30_000, k_modes=10, k_cols=20):
    """30k atoms: block-sparse vs dense-grid ``H @ X`` and the
    Chebyshev mode solver through each — the measurement behind keeping
    the sparse kernel — plus the crossover sizes behind
    ``utils.config.SPARSE_APPLY_MIN_ATOMS``."""
    import jax
    import jax.numpy as jnp

    from springcraft_tpu.ops import ffparams, matfree

    params = ffparams.invariant_params(CUTOFF)
    for n in (2048, 4096, 8192, 16384, n_atoms):
        coord = make_ca_atoms(n, seed=4).coord.astype(np.float32)
        perm = matfree.spatial_sort_permutation(coord)
        sorted_c = jax.device_put(jnp.asarray(coord[perm]))
        nbr, counts = matfree.tile_neighbor_lists(coord[perm], CUTOFF)
        ids = jnp.asarray(perm, jnp.int32)
        x = jax.device_put(jnp.asarray(
            np.random.RandomState(4).randn(3 * n, k_cols), jnp.float32))
        sparse = jax.jit(lambda c, v, nbr=nbr, counts=counts, ids=ids:
                         matfree.hessian_apply_pallas_sparse(
                             c, v, params, nbr, counts, orig_ids=ids))
        dense = jax.jit(lambda c, v: matfree.hessian_apply(c, v, params))
        _, s_s, _ = _timed_once(sparse, sorted_c, x)
        _, d_s, _ = _timed_once(dense, sorted_c, x)
        report(f"matrix-free H@X({k_cols}) n={n}: block-sparse "
               f"{s_s * 1e3:.3f} ms ({counts.mean():.1f} mean neighbour "
               f"tiles) vs dense-grid XLA {d_s * 1e3:.3f} ms")

    for sparse_route in (True, False):
        label = "block-sparse" if sparse_route else "dense-grid XLA"
        t0 = time.perf_counter()
        vals, vecs, res = matfree.lowest_modes_matfree(
            coord, params, k_modes, tol=1e-4, sparse=sparse_route)
        jax.block_until_ready(vals)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        vals, vecs, res = matfree.lowest_modes_matfree(
            coord, params, k_modes, tol=1e-4, sparse=sparse_route)
        jax.block_until_ready(vals)
        steady = time.perf_counter() - t0
        report(f"matrix-free Chebyshev modes n={n_atoms} k={k_modes} "
               f"[{label}]: {steady:.3f}s (first {first:.2f}s), max rel "
               f"residual {float(jnp.max(res)):.1e}")


def bench_matfree_xl():
    """100k-atom ANM and 1M-atom GNM through the block-sparse kernel,
    with float64-refined eigenvalues."""
    import jax.numpy as jnp

    from springcraft_tpu.ops import ffparams, matfree, modes

    rng = np.random.RandomState(7)
    params = ffparams.invariant_params(CUTOFF)
    for n, k, gnm in ((100_000, 10, False), (1_000_000, 6, True)):
        spread = (n / CA_DENSITY) ** (1.0 / 3.0)
        coord = (rng.rand(n, 3) * spread).astype(np.float32)
        solve = (matfree.lowest_modes_matfree_gnm if gnm
                 else matfree.lowest_modes_matfree)
        t0 = time.perf_counter()
        vals, vecs, res = solve(coord, params, k + 4, n_outer=8, tol=5e-4)
        float(jnp.sum(vals))
        solve_s = time.perf_counter() - t0
        refine = modes.refine_modes_f64_gnm if gnm else functools.partial(
            modes.refine_modes_f64, layout="xyz")
        t0 = time.perf_counter()
        ref_vals, _, ref_res = refine(coord, params, np.asarray(vecs))
        refine_s = time.perf_counter() - t0
        report(f"matrix-free XL {'GNM' if gnm else 'ANM'} (n={n}): "
               f"{k}(+4) modes {solve_s:.1f}s (max f32 rel residual "
               f"{float(jnp.max(res[:k])):.1e}) + f64 refinement "
               f"{refine_s:.1f}s (host); refined residuals max "
               f"{float(np.max(ref_res[:k])):.1e}")


def bench_cpu_baselines():
    """Reference-equivalent CPU paths, float64 NumPy, single structure
    at a time: fluctuation (pinv covariance) and spectral (eigh)."""
    coords = [b[0].astype(np.float64) for b in
              make_batches(CPU_ITERS, 1, N_RES, seed=1)]

    def spectral_solve(coord):
        hessian = cpu_hessian(coord)
        vals, vecs = np.linalg.eigh(hessian)
        sq_vecs = np.square(vecs.T[6:]).reshape(3 * N_RES - 6, N_RES, 3)
        return vals, (sq_vecs.sum(-1) / vals[6:, None]).sum(0)

    def median_rate(solve):
        times = []
        for _ in range(2):
            for c in coords:
                t0 = time.perf_counter()
                solve(c)
                times.append(time.perf_counter() - t0)
        times.sort()
        return 1.0 / times[len(times) // 2]

    fluct = median_rate(fluctuation_reference)
    spectral = median_rate(spectral_solve)
    base = _load_cpu_baseline() or {}
    log(f"[host cpu] fluctuation baseline {fluct:.3f} solves/s, spectral "
        f"{spectral:.3f} solves/s (committed: "
        f"{base.get('fluct_solves_per_s')} / "
        f"{base.get('spectral_solves_per_s')})")
    return fluct, spectral


_RUNNERS = {
    "assembly": bench_assembly,
    "fluctuation": bench_fluct_variants,
    "spectral": bench_spectral,
    "tabulated": bench_tabulated,
    "single-structure": bench_single_structure,
    "mega-assembly": bench_mega,
    "matrix-free": bench_matfree,
    "matrix-free-xl": bench_matfree_xl,
    "cpu-baseline": bench_cpu_baselines,
}


def run_section(name):
    if name not in _RUNNERS:
        raise ValueError(f"unknown bench section: {name}")
    _RUNNERS[name]()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    sys.path.insert(0, _ROOT)
    import jax

    from springcraft_tpu.utils import config

    config.enable_compile_cache()
    device = jax.devices()[0]
    if device.platform != "gpu":
        raise SystemExit(f"bench.py measures a CUDA GPU; JAX found "
                         f"{device.platform!r}")
    if "--section" in argv:
        for name in argv[argv.index("--section") + 1:]:
            run_section(name)
        return
    rate = bench_headline()
    for name in SECTIONS:
        run_section(name)
    base = _load_cpu_baseline()
    print(json.dumps({
        "metric": f"anm_fluctuation_nma_solves_per_sec_batched_n{N_RES}",
        "value": round(rate, 2),
        "unit": "solves/s",
        "vs_baseline": (round(rate / base["fluct_solves_per_s"], 2)
                        if base else None),
        "platform": device.platform,
        "device_kind": device.device_kind,
        "device_count": len(jax.devices()),
    }), flush=True)


if __name__ == "__main__":
    main()
