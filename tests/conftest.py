"""
Test configuration.

* Forces JAX onto CPU with 8 virtual devices so multi-device sharding
  tests run on any host (must happen before JAX initializes).  With
  ``SPRINGCRAFT_TEST_GPU=1`` the suite runs on the GPU instead — the
  card run of the ``chip``-marked tests
  (``SPRINGCRAFT_TEST_GPU=1 python -m pytest -m chip``).
* Enables x64 so the JAX backend reproduces the reference's float64
  results for the golden-data parity tests.
* Keeps compiled programs in the persistent compile cache
  (``springcraft_tpu.utils.config.enable_compile_cache``).
"""

import os

ON_GPU = os.environ.get("SPRINGCRAFT_TEST_GPU") == "1"

if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        _flags = (_flags
                  + " --xla_force_host_platform_device_count=8").strip()
    # The suite is XLA-CPU *compile* bound (hundreds of distinct solver
    # programs; execution is small-n).  Backend optimization level 0 +
    # skipping expensive LLVM passes roughly halves cold-compile time
    # and does not change semantics (fast-math stays off; LAPACK custom
    # calls are unaffected) — execution slowdown is noise at test sizes.
    if "xla_backend_optimization_level" not in _flags:
        _flags += (" --xla_backend_optimization_level=0"
                   " --xla_llvm_disable_expensive_passes=true")
    os.environ["XLA_FLAGS"] = _flags

os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")

import jax  # noqa: E402

if not ON_GPU:
    # JAX_PLATFORMS may have been read before this file ran; the config
    # update forces CPU regardless.
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from springcraft_tpu.utils.config import enable_compile_cache  # noqa: E402

enable_compile_cache(min_compile_time_secs=0.5)

from os.path import dirname, join, realpath  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def data_dir():
    return join(dirname(realpath(__file__)), "data")


# ---------------------------------------------------------------------------
# Session + disk memoization of large host-f64 eigendecompositions.
#
# The 7cal parity corpus runs several 5,328-dim float64 ``np.linalg.eigh``
# calls (distinct force fields), and the covariance path (``pinvh``)
# repeats the decomposition of byte-identical matrices the eigensystem
# cache already solved.  numpy's eigh is deterministic and none of OUR
# code is skipped — the cache key is a SHA1 of the exact matrix bytes,
# so any assembly change invalidates it.  Cuts repeat suite runs by
# minutes; first run per machine pays full price.
# ---------------------------------------------------------------------------
_EIGH_CACHE_DIR = join(dirname(realpath(__file__)), ".eigh_cache")
_EIGH_MIN_DIM = 3000
_orig_eigh = np.linalg.eigh


def _memo_eigh(arr, compute):
    """SHA1-of-bytes disk memo around a concrete f64 eigh call."""
    import hashlib

    key = hashlib.sha1(arr.tobytes()).hexdigest()
    path = join(_EIGH_CACHE_DIR, f"{key}.npz")
    if os.path.exists(path):
        with np.load(path) as f:
            return f["vals"], f["vecs"]
    vals, vecs = compute()
    os.makedirs(_EIGH_CACHE_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"  # savez appends .npz otherwise
    np.savez(tmp, vals=np.asarray(vals), vecs=np.asarray(vecs))
    os.replace(tmp, path)
    return vals, vecs


def _memoizable(arr):
    return (arr.ndim == 2 and arr.dtype == np.float64
            and arr.shape[0] >= _EIGH_MIN_DIM
            and arr.shape[0] == arr.shape[1])


def _cached_eigh(a, *args, **kwargs):
    arr = np.asarray(a)
    if args or kwargs or not _memoizable(arr):
        return _orig_eigh(a, *args, **kwargs)
    return _memo_eigh(arr, lambda: _orig_eigh(arr))


np.linalg.eigh = _cached_eigh

# With x64 enabled (this suite), `ops.linalg` routes float64 host
# matrices through the *JAX* CPU eigh, so the NumPy patch above never
# sees the heavy 7cal decompositions — wrap the eager jnp path too.
# Tracers (jit/vmap) bypass the memo untouched.
import jax.numpy as _jnp  # noqa: E402

_orig_jnp_eigh = _jnp.linalg.eigh


def _cached_jnp_eigh(a, *args, **kwargs):
    from jax.core import Tracer

    if args or kwargs or isinstance(a, Tracer):
        return _orig_jnp_eigh(a, *args, **kwargs)
    arr = np.asarray(a)
    if not _memoizable(arr):
        return _orig_jnp_eigh(a, *args, **kwargs)
    vals, vecs = _memo_eigh(arr, lambda: _orig_jnp_eigh(a))
    return _jnp.asarray(vals), _jnp.asarray(vecs)


_jnp.linalg.eigh = _cached_jnp_eigh


def load_csv(name, skip_header=0):
    return np.genfromtxt(
        join(data_dir(), name), delimiter=",", skip_header=skip_header
    )


@pytest.fixture(scope="session")
def ca_1l2y():
    from springcraft_tpu.structure import load_structure

    atoms = load_structure(join(data_dir(), "1l2y.pdb"), model=1)
    return atoms[(atoms.atom_name == "CA") & (atoms.element == "C")]


@pytest.fixture(scope="session")
def ca_7cal():
    from springcraft_tpu.structure import load_structure

    atoms = load_structure(join(data_dir(), "7cal.pdb"), model=1)
    return atoms[(atoms.atom_name == "CA") & (atoms.element == "C")]


@pytest.fixture(scope="session")
def ca_by_name(ca_1l2y, ca_7cal):
    return {"1l2y": ca_1l2y, "7cal": ca_7cal}


@pytest.fixture
def two_chain_ca(ca_1l2y):
    """Two perfectly overlapping copies of the 1l2y CA trace with
    distinct chain IDs — exercises intra-/inter-chain and bonded table
    selection (cf. reference test fixture)."""
    first = ca_1l2y.copy()
    second = ca_1l2y.copy()
    first.chain_id[:] = "A"
    second.chain_id[:] = "B"
    return first + second
