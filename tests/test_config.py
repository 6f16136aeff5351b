"""
The route policy and the compile-cache rule of ``utils.config``.
"""

import subprocess
import sys

import jax
import numpy as np
import pytest

from springcraft_tpu.ops import ffparams
from springcraft_tpu.utils import config

_CUT = ffparams.invariant_params(13.0)
_NO_CUT = ffparams.pfenm_params(None)
_BIG = config.SPARSE_APPLY_MIN_ATOMS


@pytest.mark.parametrize("route, args, expected", [
    ("sparse", (_BIG, np.float32, _CUT), True),
    ("sparse", (30_000, np.float32, _CUT), True),
    ("sparse", (_BIG - 1, np.float32, _CUT), False),
    ("sparse", (30_000, np.float64, _CUT), False),
    ("sparse", (30_000, np.float32, _NO_CUT), False),
    ("inverse", (np.float32,), "blocked"),
    ("inverse", (np.float64,), "cho_solve"),
    ("engine", (5328, np.float32), "invfactor"),
    ("engine", (config.INVFACTOR_MAX_DIM, np.float32), "invfactor"),
    ("engine", (config.INVFACTOR_MAX_DIM + 1, np.float32), "chol"),
    ("engine", (30_000, np.float32), "chol"),
    ("engine", (5328, np.float64), "chol"),
])
def test_route_policy(route, args, expected):
    """Routes depend on dtype and size only — the same answer on every
    backend."""
    fn = {"sparse": config.use_sparse_apply,
          "inverse": config.ensemble_inverse,
          "engine": config.shift_invert_engine}[route]
    assert fn(*args) == expected


def _cache_dir_in_child(tmp_path, env_dir):
    """jax's cache directory after ``enable_compile_cache`` in a fresh
    process (the env var is read at JAX import)."""
    code = ("from springcraft_tpu.utils import config; import jax; "
            "d = config.enable_compile_cache(); "
            "print(d); print(jax.config.jax_compilation_cache_dir)")
    env = {"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": ":".join(sys.path)}
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_dir)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, cwd=tmp_path,
                         check=True)
    returned, in_jax = out.stdout.strip().splitlines()[-2:]
    return returned, in_jax


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(tmp_path, env_set):
    env_dir = tmp_path / "from_env" if env_set else None
    returned, in_jax = _cache_dir_in_child(tmp_path, env_dir)
    expected = str(env_dir) if env_set else config.CHECKOUT_CACHE_DIR
    assert returned == expected
    assert in_jax == expected
    assert config.CHECKOUT_CACHE_DIR.endswith(".jax_cache")


def test_compile_cache_env_var_not_overridden(monkeypatch, tmp_path):
    """With the env var set, nothing is written to jax's config."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert config.enable_compile_cache() == str(tmp_path)
    assert config.compile_cache_dir() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before
