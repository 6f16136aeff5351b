"""
Mesh-sharded execution: data-parallel ensemble NMA and row-sharded
mega-assembly Hessians.

Design notes (green-field; the reference has no distributed layer):

* **Ensemble NMA** is embarrassingly parallel over conformers: the batch
  axis is sharded over the whole mesh via ``NamedSharding`` and the
  vmapped pipeline runs under ``jit`` — XLA keeps every solve local to
  its device; cross-device collectives appear only for ensemble
  reductions (e.g. mean MSF).
* **Sharded Hessian assembly** uses ``shard_map`` over row blocks: each
  device holds the full ``(n, 3)`` coordinate array (tiny) and computes
  its block of Hessian rows with
  :func:`springcraft_tpu.ops.assembly.hessian_rows`.  Because each
  atom's diagonal superelement is the negated sum over its own row, the
  computation is fully local — the 30k x 30k matrix is *born sharded*
  with zero communication.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from jax import shard_map

from ..ops import assembly
from . import pipeline

__all__ = [
    "sharded_ensemble_anm",
    "sharded_ensemble_gnm",
    "sharded_ensemble_anm_banded",
    "sharded_ensemble_anm_fluctuations",
    "sharded_ensemble_gnm_banded",
    "sharded_hessian",
    "sharded_hessian_apply",
    "sharded_lowest_modes",
    "sharded_lowest_modes_matfree",
    "sharded_covariance",
    "ensemble_mean_msf",
]


def _shard_batch(coords, mesh):
    sharding = NamedSharding(mesh, P(("ens", "row")))
    return jax.device_put(jnp.asarray(coords), sharding)


def sharded_ensemble_anm(coords, params, mesh, masses=None, **options):
    """
    Data-parallel ensemble ANM over `mesh`: the conformer batch is
    sharded across all devices and each device runs complete NMA solves
    for its shard.

    `coords` has shape ``(b, n, 3)`` with ``b`` divisible by the mesh
    size.
    """
    coords = _shard_batch(coords, mesh)
    return pipeline.ensemble_anm(coords, params, masses=masses, **options)


def sharded_ensemble_gnm(coords, params, mesh, masses=None, **options):
    """Data-parallel ensemble GNM (see :func:`sharded_ensemble_anm`)."""
    coords = _shard_batch(coords, mesh)
    return pipeline.ensemble_gnm(coords, params, masses=masses, **options)


def _shard_map_ensemble(fn, coords, mesh):
    """Run a batched ensemble pipeline with the conformer axis sharded
    over the whole mesh via ``shard_map`` — manual SPMD for pipelines
    whose Pallas kernels GSPMD cannot partition over a sharded batch
    axis (each device runs the full kernel on its local shard)."""
    spec = P(("ens", "row"))
    # check_vma=False: the pipelines carry unvarying scan/loop constants
    # that JAX's varying-axes check would reject; replication analysis
    # is unnecessary here (purely data-parallel, no collectives).
    mapped = shard_map(fn, mesh=mesh, in_specs=(spec,), out_specs=spec,
                       check_vma=False)
    return mapped(jnp.asarray(coords))


def sharded_ensemble_anm_fluctuations(coords, params, mesh, masses=None,
                                      **options):
    """Data-parallel fast-covariance ensemble ANM over `mesh`
    (see :func:`sharded_ensemble_anm`).

    Defaults to the ``cho_solve`` covariance engine under GSPMD.
    ``inverse="blocked"`` routes through ``shard_map`` instead, which
    keeps each device's recursive factor local to its conformer
    shard."""
    options.setdefault("inverse", "cho_solve")
    if options.get("inverse") == "blocked":
        def run(c):
            return pipeline.ensemble_anm_fluctuations(
                c, params, masses=masses, **options)
        return _shard_map_ensemble(run, coords, mesh)
    coords = _shard_batch(coords, mesh)
    return pipeline.ensemble_anm_fluctuations(coords, params,
                                              masses=masses, **options)


def sharded_ensemble_anm_banded(coords, params, mesh, masses=None,
                                **options):
    """Banded full-eigensystem ensemble ANM
    (:func:`..parallel.pipeline.ensemble_anm_banded`) with the
    conformer batch sharded over the whole mesh via ``shard_map`` —
    each device runs the two-stage banded solver (band reduction,
    bisection, factored inverse iteration) on its local shard; the
    solver's batch vectorization stays device-local."""
    def run(c):
        return pipeline.ensemble_anm_banded(c, params, masses=masses,
                                            **options)
    return _shard_map_ensemble(run, coords, mesh)


def sharded_ensemble_gnm_banded(coords, params, mesh, masses=None,
                                **options):
    """GNM counterpart of :func:`sharded_ensemble_anm_banded`."""
    def run(c):
        return pipeline.ensemble_gnm_banded(c, params, masses=masses,
                                            **options)
    return _shard_map_ensemble(run, coords, mesh)


@functools.lru_cache(maxsize=None)
def _mean_msf_fn(kind):
    run = pipeline.ensemble_anm if kind == "anm" else pipeline.ensemble_gnm

    @jax.jit
    def mean_msf(c, params):
        return run(c, params)["msf"].mean(axis=0)

    return mean_msf


def ensemble_mean_msf(coords, params, mesh, kind="anm"):
    """
    Mean MSF profile over a sharded conformer ensemble.

    The per-conformer solves stay device-local; the final mean over the
    sharded batch axis lowers to an XLA ``AllReduce`` over ICI.
    """
    coords = _shard_batch(coords, mesh)
    return _mean_msf_fn(kind)(coords, params)


def sharded_hessian(coord, params, mesh, dtype=jnp.float32):
    """
    Row-sharded ``(3n, 3n)`` Hessian (atom layout) built with
    ``shard_map`` over the ``"row"`` mesh axis: device ``r`` computes
    atom rows ``[r * n/R, (r+1) * n/R)`` locally; no collectives are
    needed (see module docstring).

    ``n`` must be divisible by the size of the ``"row"`` axis.  The
    result is a global array sharded along its row axis.
    """
    coord = jnp.asarray(coord, dtype=dtype)
    n = coord.shape[0]
    n_row = mesh.shape["row"]
    if n % n_row != 0:
        raise ValueError(
            f"n={n} must be divisible by the row axis size {n_row}"
        )
    block = n // n_row

    def row_block(local_coord):
        # local_coord is the full coordinate array (replicated)
        r = jax.lax.axis_index("row")
        return assembly.hessian_rows(
            local_coord, params, r * block, block, jnp, dtype=dtype
        )

    fn = shard_map(
        row_block,
        mesh=mesh,
        in_specs=P(),
        out_specs=P("row", None),
    )
    return jax.jit(fn)(coord)


@functools.lru_cache(maxsize=None)
def _matfree_shard_fn(mesh, params_key, n, k_vec, block, dtype):
    """shard_map program computing row shards of the matrix-free
    ``H @ x``, cached per (mesh, static force-field key, shapes) — the
    parameter *arrays* flow through as jit arguments (rebuilding the
    jit wrapper per call would recompile every time).  `params_key`
    carries only the static fields (kind, cutoff, bin edges)."""
    from ..ops import ffparams, matfree

    kind, cutoff_sq, edges_sq, n_bins = params_key
    params = ffparams.FFParams(kind=kind, n_bins=n_bins,
                               cutoff_sq=cutoff_sq, edges_sq=edges_sq)
    n_dev = mesh.size
    n_local = n // n_dev
    block_eff = min(block, n_local)
    while n_local % block_eff:
        block_eff -= 1
    has_meta = kind == "table_compact"

    def body(coord_f, x_f, *meta):
        r = jax.lax.axis_index("ens") * mesh.shape["row"] \
            + jax.lax.axis_index("row")
        one_block = matfree._make_row_block(
            coord_f, x_f, params, meta if has_meta else None, n,
            block_eff)
        starts = r * n_local \
            + jnp.arange(n_local // block_eff) * block_eff
        blocks = jax.lax.map(one_block, starts)   # (nb, 3, B, k)
        return jnp.moveaxis(blocks, 1, 0).reshape(3, n_local, k_vec)

    n_meta = 6 if has_meta else 0
    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(P(),) * (2 + n_meta),
        out_specs=P(None, ("ens", "row"), None),
    )
    return jax.jit(lambda c, x, *m: fn(c, x, *m).reshape(3 * n, k_vec))


def sharded_hessian_apply(coord, x, params, mesh, *, block=512,
                          dtype=jnp.float32):
    """
    Matrix-free ``H @ x`` with the atom rows sharded over the whole
    mesh: each device computes its row block against the replicated
    coordinates/vectors — zero collectives in the product itself (the
    output is born row-sharded and gathered only on use).

    This is the multi-chip mega-scale operator: memory per device is
    O(block * n) workspace, never O(n^2).  ``n`` must be divisible by
    the mesh size.
    """
    from ..ops import matfree

    matfree._check_params(params)
    coord = jnp.asarray(coord, dtype=dtype)
    n = coord.shape[0]
    if n % mesh.size != 0:
        raise ValueError(
            f"n={n} must be divisible by the mesh size {mesh.size}")
    xb, squeeze = matfree._as_block_input(x, n, dtype)
    k_vec = xb.shape[-1]

    meta = (matfree._pad_compact_meta(params, n, n)
            if params.kind == "table_compact" else ())
    params_key = (params.kind, params.cutoff_sq, params.edges_sq,
                  params.n_bins)
    fn = _matfree_shard_fn(mesh, params_key, n, k_vec, block, dtype)
    y = fn(coord, xb, *meta)
    return y[:, 0] if squeeze else y


def sharded_lowest_modes_matfree(coord, params, mesh, k, *, masses=None,
                                 block=512, dtype=jnp.float32, **options):
    """
    Lowest non-trivial ANM modes of a system whose Hessian fits *no*
    single chip: Chebyshev-filtered subspace iteration over the
    mesh-sharded matrix-free operator (see
    :func:`springcraft_tpu.ops.matfree.lowest_modes_matfree` for the
    algorithm and options; returns ``(values, modes, residuals)``).
    """
    from ..ops import matfree

    coord = jnp.asarray(coord, dtype=dtype)
    matvec = functools.partial(sharded_hessian_apply, coord,
                               params=params, mesh=mesh, block=block,
                               dtype=dtype)
    return matfree.lowest_modes_matfree(
        coord, params, k, masses=masses, dtype=dtype, matvec=matvec,
        **options)


def sharded_lowest_modes(coord, params, mesh, k, dtype=jnp.float32,
                         n_iter=200):
    """
    Lowest non-trivial ANM modes of a mega-assembly on a mesh: the
    Hessian is built row-sharded (zero communication) and stays sharded
    through the LOBPCG iteration — XLA partitions the ``H @ X`` matvecs
    across the ``"row"`` axis and inserts the reduce/all-gather
    collectives for the small block operations.
    """
    from ..ops import modes

    hessian = sharded_hessian(coord, params, mesh, dtype=dtype)
    coord = jnp.asarray(coord, dtype=dtype)
    # Convert atom-layout rigid modes: sharded_hessian is atom layout
    from ..ops import rigid

    basis = rigid.rigid_modes_anm(coord, layout="atom")
    return modes.lowest_modes(hessian, k, null_basis=basis, n_iter=n_iter)


def sharded_covariance(coord, params, mesh, dtype=jnp.float32,
                       sigma=None):
    """
    Mega-assembly pseudo-inverse covariance on a mesh: the Cholesky
    factor is computed once (replicated) and the identity right-hand
    side is solved in column shards — each device back-substitutes its
    own column block, producing the covariance column-sharded across
    the mesh.
    """
    from ..ops import rigid

    coord = jnp.asarray(coord, dtype=dtype)
    n3 = 3 * coord.shape[0]
    n_dev = mesh.size
    if n3 % n_dev != 0:
        raise ValueError(f"3n={n3} must be divisible by the mesh size "
                         f"{n_dev}")

    hessian = sharded_hessian(coord, params, mesh, dtype=dtype)
    basis = rigid.rigid_modes_anm(coord, layout="atom")
    sig = (jnp.mean(jnp.diagonal(hessian)) if sigma is None
           else jnp.asarray(sigma, hessian.dtype))
    return _sharded_cov_fn(mesh)(hessian, basis, sig)


@functools.lru_cache(maxsize=None)
def _sharded_cov_fn(mesh):
    @jax.jit
    def solve(h, t, sig):
        n3 = h.shape[0]
        n_dev = mesh.size
        block = n3 // n_dev
        reg = h + sig * jnp.matmul(t, t.T, precision="highest")
        scale = 1.0 / jnp.sqrt(jnp.diagonal(reg))
        reg = reg * scale[:, None] * scale[None, :]
        chol = jnp.linalg.cholesky(reg)

        def col_block(chol_local, t_local, scale_local, sig_local):
            d = jax.lax.axis_index("ens") * mesh.shape["row"] \
                + jax.lax.axis_index("row")
            cols = d * block + jnp.arange(block)
            rhs = (jnp.arange(n3)[:, None] == cols[None, :]).astype(
                chol_local.dtype
            )
            import jax.scipy.linalg as jsl

            sol = jsl.cho_solve((chol_local, True), rhs)
            sol = sol * scale_local[:, None]
            sol = sol * jax.lax.dynamic_slice_in_dim(
                scale_local, d * block, block
            )[None, :]
            ttt_cols = jnp.matmul(
                t_local,
                jax.lax.dynamic_slice_in_dim(
                    t_local, d * block, block, axis=0
                ).T,
                precision="highest",
            )
            return sol - ttt_cols / sig_local

        fn = shard_map(
            col_block,
            mesh=mesh,
            in_specs=(P(), P(), P(), P()),
            out_specs=P(None, ("ens", "row")),
        )
        return fn(chol, t, scale, sig)

    return solve


def sharded_anm_pipeline(coord, params, mesh, dtype=jnp.float32,
                         n_modes=None):
    """
    Mega-assembly ANM: build the Hessian row-sharded across the mesh,
    then eigensolve and reduce to observables.  The eigensolve input is
    resharded by XLA as needed (gathered over ICI for the dense solver).
    """
    hessian = sharded_hessian(coord, params, mesh, dtype=dtype)

    @functools.partial(jax.jit, static_argnames=("n_modes",))
    def solve(h, n_modes=None):
        vals, vecs = jnp.linalg.eigh(h)
        vecs = vecs.T
        if n_modes is not None and not (0 < n_modes <= h.shape[0] - 6):
            raise ValueError(
                f"n_modes={n_modes} must be in [1, {h.shape[0] - 6}]"
            )
        stop = h.shape[0] if n_modes is None else 6 + n_modes
        modes = jnp.arange(6, stop)
        from ..ops import nma_core

        msf = nma_core.mean_square_fluctuation(
            vals, vecs, modes, jnp, num_dim=3, layout="atom"
        )
        return {"eig_values": vals, "msf": msf,
                "bfactor": nma_core.bfactor_from_msf(msf)}

    return solve(hessian, n_modes=n_modes)
