"""
``chip_smoke.py`` off the card: its phase functions at tiny sizes on the
CPU (the sparse kernel in the Pallas interpreter), and its refusal to
run without a CUDA GPU or outside a checkout.
"""

import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke

_ROOT = os.path.dirname(os.path.dirname(os.path.realpath(__file__)))


def _assert_within(results):
    for name, (value, limit) in results.items():
        assert value <= limit, (name, value, limit)


def test_phase_ensemble_small():
    results, timings = chip_smoke.phase_ensemble(4, 300, 2)
    assert len(results) == 4 and set(timings) == {"invariant", "sdENM"}
    _assert_within(results)


def test_phase_single_small(ca_7cal):
    results, _ = chip_smoke.phase_single(ca_7cal[:150], k=5)
    _assert_within(results)


def test_phase_matfree_small():
    results, timings = chip_smoke.phase_matfree(300, 20, 3, interpret=True)
    _assert_within(results)
    assert timings["mean neighbour tiles"] >= 1


def test_check_raises_past_limit(capsys):
    chip_smoke.check("x", 1e-6, 1e-5)
    with pytest.raises(SystemExit):
        chip_smoke.check("x", 1e-4, 1e-5)
    assert "FAIL" in capsys.readouterr().out


def _run(script_dir, env_extra):
    env = dict(os.environ, **env_extra)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=script_dir,
                          env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_refuses_without_gpu(tmp_path, where):
    """No CUDA GPU (or no checkout around the script): non-zero exit and
    no result line."""
    if where == "alone":
        shutil.copy(os.path.join(_ROOT, "chip_smoke.py"), tmp_path)
        script_dir = tmp_path
    else:
        script_dir = _ROOT
    out = _run(script_dir, {"JAX_PLATFORMS": "cpu"})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_phase_four_cards_small(ca_7cal):
    """The four-card phase on 4 of the suite's virtual CPU devices: a
    small sharded ensemble, and the distributed Cholesky on 7cal,
    against one device."""
    results, _ = chip_smoke.phase_four_cards(8, 300, ca_7cal)
    assert len(results) == 3
    _assert_within(results)
