"""
Shared machinery for the GNM/ANM model classes: coordinate/mass intake,
lazily computed interaction-matrix / covariance duals with setters that
invalidate each other, and a cached eigensystem.

The dual-cache contract mirrors the reference (``anm.py:98-148``,
``gnm.py:91-143``); the eigensystem cache is an addition — the reference
re-runs ``eigh`` inside every observable (``nma.py:145``), here it is
computed once per matrix state.
"""

from __future__ import annotations

import numpy as np

from ..ops import assembly, linalg
from ..structure import info as struc_info
from ..structure.atoms import coord as as_coord

__all__ = ["ElasticNetworkModel"]


class ElasticNetworkModel:
    """Common base for :class:`GNM` and :class:`ANM`."""

    #: dimensions per atom in the interaction matrix (1 = GNM, 3 = ANM)
    _num_dim = 1

    def __init__(self, atoms, force_field, masses=None, use_cell_list=True):
        self._coord = as_coord(atoms)
        self._ff = force_field
        self._use_cell_list = use_cell_list
        self._masses = self._resolve_masses(atoms, masses)

        if self._masses is not None:
            self._mass_weight_matrix = assembly.mass_weights(
                self._masses, np, repeat3=(self._num_dim == 3)
            )
        else:
            self._mass_weight_matrix = None

        self._matrix = None
        self._covariance = None
        self._eigen_cache = None
        #: True once the user assigns hessian/kirchhoff/covariance —
        #: device solvers that rebuild from the force field must refuse
        self._matrix_user_set = False

    @staticmethod
    def _resolve_masses(atoms, masses):
        if masses is None or masses is False:
            return None
        if masses is True:
            # Duck-typed: anything exposing res_name (our AtomArray, a
            # biotite AtomArray, ...) supports automatic mass inference.
            res_name = getattr(atoms, "res_name", None)
            if res_name is None:
                raise TypeError(
                    "An AtomArray is required to automatically infer masses"
                )
            return struc_info.residue_masses(np.asarray(res_name))
        masses = np.asarray(masses, dtype=float)
        n = atoms.array_length() if hasattr(atoms, "array_length") \
            else len(as_coord(atoms))
        if len(masses) != n:
            raise IndexError(f"{len(masses)} masses for {n} atoms given")
        if np.any(masses == 0):
            raise ValueError("Masses must not be 0")
        return masses

    # -- subclass hooks ------------------------------------------------------

    def _compute_matrix(self):
        raise NotImplementedError

    @property
    def _matrix_dim(self):
        return len(self._coord) * self._num_dim

    # -- lazy dual caches ----------------------------------------------------

    # NOTE on in-place mutation: like the reference ("This is not a
    # copy: Create a copy before modifying this matrix"), the matrix/
    # covariance properties return live arrays that must not be mutated
    # in place.  Here that contract matters doubly: the eigensystem is
    # cached, so undetectable in-place writes would also leave cached
    # observables stale.  Assign through the setters instead.
    def _require_force_field_matrix(self, what):
        """Guard for device solvers that rebuild the interaction matrix
        from the force field: a user-assigned matrix/covariance would be
        silently ignored."""
        if self._matrix_user_set:
            raise ValueError(
                f"{what} rebuilds the interaction matrix from the force "
                "field and would ignore the explicitly assigned "
                "hessian/kirchhoff/covariance — use the dense API "
                "instead")

    def _get_matrix(self):
        if self._matrix is None:
            if self._covariance is None:
                matrix = self._compute_matrix()
                if self._mass_weight_matrix is not None:
                    matrix = matrix * self._mass_weight_matrix
                self._matrix = matrix
            else:
                self._matrix = np.array(
                    linalg.pinvh(self._covariance, rcond=1e-6)
                )
        return self._matrix

    def _set_matrix(self, value, error_cls=IndexError):
        dim = self._matrix_dim
        if value.shape != (dim, dim):
            raise error_cls(
                f"Expected shape {(dim, dim)}, got {value.shape}"
            )
        self._matrix = value
        self._covariance = None
        self._eigen_cache = None
        self._matrix_user_set = True

    @property
    def covariance(self):
        """Pseudo-inverse of the interaction matrix
        (``rcond=1e-6``, Hermitian)."""
        if self._covariance is None:
            self._covariance = np.array(
                linalg.pinvh(self._get_matrix(), rcond=1e-6)
            )
        return self._covariance

    @covariance.setter
    def covariance(self, value):
        dim = self._matrix_dim
        if value.shape != (dim, dim):
            raise IndexError(
                f"Expected shape {(dim, dim)}, got {value.shape}"
            )
        self._covariance = value
        self._matrix = None
        self._eigen_cache = None
        self._matrix_user_set = True

    @property
    def masses(self):
        return self._masses

    def eigen(self):
        """
        Eigenvalues (ascending) and eigenvectors (modes in rows) of the
        interaction matrix; cached until the matrix changes.

        Each call returns fresh, mutable arrays (the reference contract)
        backed by the cache — mutating a returned array does not corrupt
        subsequent calls.
        """
        vals, vecs = self._eigen()
        return vals.copy(), vecs.copy()

    def _eigen(self):
        """Cached eigensystem without defensive copies — internal use
        only (callers must not mutate)."""
        if self._eigen_cache is None:
            vals, vecs = linalg.eigensystem(self._get_matrix())
            self._eigen_cache = (np.array(vals), np.array(vecs))
        return self._eigen_cache

    @staticmethod
    def _dense_path_rejects(method, options, **kwargs):
        """Fail fast when matrix-free-only arguments reach a dense
        (``matrix_free=False``) observable path: silently swallowing
        them would return a differently-shaped result than the
        stochastic surfaces document (e.g. ``(n,)`` instead of
        ``(msf, stderr)``) with no hint which path ran."""
        bad = sorted([name for name, val in kwargs.items()
                      if val is not None] + list(options))
        if bad:
            raise ValueError(
                f"{method}: argument(s) {', '.join(bad)} apply only to "
                f"matrix_free=True; the dense path computes from the "
                f"covariance directly (pass matrix_free=True, or drop "
                f"them)")

    def _resolve_deflation_modes(self, modes, options, atom_layout,
                                 forward_all=False):
        """Resolve a ``modes=`` deflation-subspace argument for the
        stochastic matrix-free surfaces: an integer ``k`` runs
        :meth:`lowest_modes(k, matrix_free=True) <lowest_modes>` (with
        solver options forwarded — only ``tile``/``sparse`` unless
        `forward_all`, the rest belong to the downstream CG) and guards
        the returned mode residuals against ``mode_residual_tol``
        (popped from `options`, default 1e-2): a spuriously small
        unconverged eigenvalue would silently bias the rank-k control
        variate while the CG residual guard still passes.  Defaults the
        op-level ``layout`` to ``"atom"`` when `atom_layout` (what
        :meth:`lowest_modes`/:meth:`eigen` return; GNM vectors carry no
        component layout).  Returns the ``(values, vectors)`` pair (or
        ``None`` untouched)."""
        import numpy as np

        mode_rtol = options.pop("mode_residual_tol", None)
        if isinstance(modes, bool):
            # bool is an int subclass: modes=True would silently run
            # lowest_modes(1) — a likely typo for a matrix_free flag on
            # these keyword-heavy surfaces
            raise TypeError(
                "modes must be an integer mode count or a (values, "
                f"vectors) pair, got {modes!r} — did you mean "
                "matrix_free=True?")
        if mode_rtol is not None and not isinstance(modes,
                                                    (int, np.integer)):
            # fail fast instead of discarding: the tolerance guards the
            # internal lowest_modes solve, which only runs for modes=<k>
            raise ValueError(
                "mode_residual_tol applies only to modes=<k> (it guards "
                "the internal lowest_modes solve); pre-converged "
                "modes=(values, vectors) carry their own residuals")
        if mode_rtol is None:
            mode_rtol = 1e-2
        if isinstance(modes, (int, np.integer)):
            fwd = (dict(options) if forward_all else
                   {k: v for k, v in options.items()
                    if k in ("tile", "sparse")})
            vals, vecs, res = self.lowest_modes(
                int(modes), matrix_free=True, **fwd)
            res = np.asarray(res)
            max_res = float(np.max(res)) if res.size else 0.0
            if not np.isfinite(max_res) or max_res > mode_rtol:
                raise ValueError(
                    f"deflation modes did not converge: max relative "
                    f"eigenpair residual {max_res:.2e} (tol "
                    f"{mode_rtol:.0e}) from lowest_modes(matrix_free="
                    f"True) — raise the solver budget (e.g. degree/"
                    f"n_iter), pass pre-converged modes=(values, "
                    f"vectors), or loosen mode_residual_tol")
            modes = (vals, vecs)
            if atom_layout:
                # lowest_modes returns atom-interleaved vectors
                options["layout"] = "atom"
        elif modes is not None and atom_layout:
            # model-level default: atom-interleaved (what lowest_modes/
            # eigen return); pass layout="xyz" for ops-level
            # lowest_modes_matfree output
            options.setdefault("layout", "atom")
        return modes

    def _matfree_dcc(self, mode_subset, norm, tem, tem_factors, sites,
                     msf, modes, probes, options, *, rows_op_name,
                     msf_op_name, atom_layout):
        """Shared matrix-free DCC implementation for ANM/GNM
        (``dcc(matrix_free=True)``): all-mode DCC rows for `sites` by
        deflated CG (``ops.matfree.dcc_rows_matfree[_gnm]``).

        With ``norm=True`` and `msf` omitted, the normalizer is
        estimated in place: ``modes=<k | (values,
        vectors)>`` (optionally ``probes=``) runs the unbiased
        stochastic all-mode MSF first — one extra batched CG solve.
        Error propagation: the estimate's per-atom standard error
        ``sem`` enters each normalized row ``ij`` as a relative error
        of ``~(sem_i / msf_i + sem_j / msf_j) / 2`` (first-order in
        the inverse square roots), i.e. ``~sqrt(2 / probes)`` of the
        post-deflation covariance residual — tighten with more probes
        or a larger deflation rank.
        """
        import numpy as np

        from ..ops import matfree
        from ..parallel.pipeline import _resolve_params

        if sites is None:
            raise ValueError(
                "dcc(matrix_free=True) needs sites=<atom indices>: the "
                "full (n, n) DCC requires the dense covariance")
        if mode_subset is not None:
            raise ValueError(
                "dcc(matrix_free=True) is an all-mode quantity; "
                "mode_subset is not supported")
        self._require_force_field_matrix("dcc(matrix_free=True)")
        params = _resolve_params(self._ff)
        if norm and msf is None:
            if modes is None:
                raise ValueError(
                    "dcc(matrix_free=True, norm=True) needs the "
                    "all-mode MSF normalizer: pass msf=<(n,) values> "
                    "(e.g. mean_square_fluctuation(matrix_free=True)), "
                    "or modes=<k | (values, vectors)> (optionally "
                    "probes=<p>) to estimate it in place via the "
                    "stochastic MSF")
            # the copy keeps estimator-internal keys (layout, seed)
            # out of the row solve below; CG options (tol, max_iter)
            # are shared
            est_options = dict(options)
            options.pop("layout", None)
            options.pop("seed", None)
            msf, _stderr = self._stochastic_msf(
                msf_op_name, None, None, tem_factors, modes, probes,
                est_options, atom_layout)
        elif modes is not None or probes is not None:
            raise ValueError(
                "dcc(matrix_free=True): modes=/probes= serve only to "
                "estimate the msf normalizer; with msf= given (or "
                "norm=False) they would be silently ignored")
        tol = options.setdefault("tol", 1e-6)
        rows_op = getattr(matfree, rows_op_name)
        rows, n_it, res = rows_op(
            self._coord, params, sites, norm=norm, msf=msf,
            masses=self._masses, **options)
        rows = np.asarray(rows)
        max_res = float(np.max(np.asarray(res)))
        if not np.all(np.isfinite(rows)) or max_res > 10 * tol:
            raise ValueError(
                f"matrix-free DCC did not converge: max relative "
                f"residual {max_res:.2e} after {int(n_it)} CG "
                f"iterations (tol {tol:.0e}) — raise max_iter, or "
                "check network connectivity")
        if tem is not None:
            rows = rows * tem * tem_factors
        return rows

    def _stochastic_msf(self, op_name, mode_subset, tem, tem_factors,
                        modes, probes, options, atom_layout):
        """Shared matrix-free MSF implementation for ANM/GNM
        (``mean_square_fluctuation(matrix_free=True)``): resolve the
        deflation modes, run the deflated Hutchinson estimator
        (``ops.matfree.msf_stochastic[_gnm]``), guard convergence, and
        apply the reference temperature scaling.  Returns
        ``(msf, stderr)``.

        `atom_layout`: the model's :meth:`lowest_modes` returns
        atom-interleaved vectors, so the ANM path defaults the op's
        ``layout`` to ``"atom"`` (pass ``layout="xyz"`` explicitly for
        ops-level ``lowest_modes_matfree`` output); GNM vectors carry
        no component layout.
        """
        import numpy as np

        from ..ops import matfree, nma_core
        from ..parallel.pipeline import _resolve_params

        if mode_subset is not None:
            raise ValueError(
                "mean_square_fluctuation(matrix_free=True) is an "
                "all-mode quantity; mode_subset is not supported")
        if modes is None:
            raise ValueError(
                "mean_square_fluctuation(matrix_free=True) needs "
                "modes=<k | (values, vectors)> as the deflation "
                "subspace (e.g. k=10 runs lowest_modes(10, "
                "matrix_free=True) first)")
        self._require_force_field_matrix(
            "mean_square_fluctuation(matrix_free=True)")
        params = _resolve_params(self._ff)
        modes = self._resolve_deflation_modes(modes, options, atom_layout)
        probes = 64 if probes is None else probes
        tol = options.setdefault("tol", 1e-6)
        op = getattr(matfree, op_name)
        msf, stderr, n_it, res = op(
            self._coord, params, modes, probes=probes,
            masses=self._masses, **options)
        max_res = float(np.max(np.asarray(res)))
        if not np.all(np.isfinite(msf)) or max_res > 10 * tol:
            raise ValueError(
                f"stochastic MSF did not converge: max relative "
                f"residual {max_res:.2e} after {int(n_it)} CG "
                f"iterations (tol {tol:.0e}) — raise max_iter, or "
                "check network connectivity")
        scale = nma_core.temperature_scaling(tem, tem_factors)
        return msf * scale, stderr * scale
