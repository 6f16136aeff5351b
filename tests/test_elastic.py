"""
Failure detection / elastic recovery (`utils.elastic`) — the recovery
layer for long device loops on a failable remote accelerator.

Covers: exception classification, the liveness probe, in-process retry
semantics (transient vs persistent vs non-device failures), atomic
checkpoint round-trips, resumable-loop resume-from-snapshot (the
cross-process recovery mode), and the `lowest_modes_matfree(...,
checkpoint=/retries=)` integration (elastic result == plain result).
"""

import numpy as np
import pytest

from springcraft_tpu.ops import ffparams, matfree
from springcraft_tpu.utils import elastic


class _FakeXlaRuntimeError(Exception):
    pass


_FakeXlaRuntimeError.__name__ = "XlaRuntimeError"


def test_is_device_failure_classification():
    assert elastic.is_device_failure(_FakeXlaRuntimeError("boom"))
    assert elastic.is_device_failure(RuntimeError("rpc UNAVAILABLE: x"))
    assert elastic.is_device_failure(RuntimeError("socket closed"))
    assert elastic.is_device_failure(
        elastic.DeviceProbeTimeout("probe timed out"))
    # ordinary bugs never classify as device failures
    assert not elastic.is_device_failure(ValueError("bad shape"))
    assert not elastic.is_device_failure(TypeError("UNAVAILABLE"))
    assert not elastic.is_device_failure(AssertionError("UNAVAILABLE"))
    assert not elastic.is_device_failure(KeyError("INTERNAL"))


def test_probe_device_passes_on_live_backend():
    elastic.probe_device(timeout=120.0)


def test_retry_recovers_from_transient_failure():
    calls = {"n": 0}
    retried = []

    def flaky():
        calls["n"] += 1
        if calls["n"] == 1:
            raise _FakeXlaRuntimeError("connection reset")
        return 42

    out = elastic.retry_on_failure(
        flaky, retries=2, wait=0.0, probe=False,
        on_retry=lambda attempt, exc: retried.append(attempt))
    assert out == 42
    assert calls["n"] == 2
    assert retried == [1]


def test_retry_gives_up_after_budget():
    def dead():
        raise _FakeXlaRuntimeError("still down")

    with pytest.raises(_FakeXlaRuntimeError):
        elastic.retry_on_failure(dead, retries=2, wait=0.0, probe=False)


def test_retry_does_not_mask_real_bugs():
    calls = {"n": 0}

    def buggy():
        calls["n"] += 1
        raise ValueError("a real bug")

    with pytest.raises(ValueError):
        elastic.retry_on_failure(buggy, retries=5, wait=0.0, probe=False)
    assert calls["n"] == 1


def test_loop_checkpoint_roundtrip(tmp_path):
    path = tmp_path / "state.npz"
    ckpt = elastic.LoopCheckpoint(path, every=2)
    assert ckpt.load() is None
    state = {"x": np.arange(6.0).reshape(2, 3), "a": np.float32(0.25)}
    ckpt.save(3, state)
    iteration, loaded = ckpt.load()
    assert iteration == 3
    np.testing.assert_array_equal(loaded["x"], state["x"])
    assert loaded["a"] == np.float32(0.25)
    ckpt.clear()
    assert ckpt.load() is None
    with pytest.raises(ValueError):
        ckpt.save(0, {"__iteration__": np.zeros(1)})
    with pytest.raises(ValueError):
        elastic.LoopCheckpoint(path, every=0)


def _counting_step(log):
    def step(i, state):
        log.append(i)
        return {"acc": state["acc"] + (i + 1)}
    return step


def test_resumable_loop_plain():
    log = []
    state, done = elastic.resumable_loop(
        _counting_step(log), {"acc": np.float64(0.0)}, 5, probe=False)
    assert done == 5
    assert float(state["acc"]) == 15.0
    assert log == [0, 1, 2, 3, 4]


def test_resumable_loop_early_stop():
    log = []
    state, done = elastic.resumable_loop(
        _counting_step(log), {"acc": np.float64(0.0)}, 100,
        stop=lambda st: float(st["acc"]) >= 6.0, probe=False)
    assert done == 3
    assert log == [0, 1, 2]


def test_resumable_loop_resumes_from_snapshot(tmp_path):
    path = str(tmp_path / "loop.npz")

    # First run dies (simulated) at iteration 3 after snapshotting 2
    log1 = []

    def dying_step(i, state):
        if i == 3:
            raise KeyboardInterrupt  # simulated hard crash
        log1.append(i)
        return {"acc": state["acc"] + (i + 1)}

    with pytest.raises(KeyboardInterrupt):
        elastic.resumable_loop(
            dying_step, {"acc": np.float64(0.0)}, 6,
            checkpoint=elastic.LoopCheckpoint(path, every=1), probe=False)
    assert log1 == [0, 1, 2]

    # Second run resumes at 3 — iterations 0-2 are never re-executed
    log2 = []
    state, done = elastic.resumable_loop(
        _counting_step(log2), {"acc": np.float64(0.0)}, 6,
        checkpoint=elastic.LoopCheckpoint(path, every=1), probe=False)
    assert log2 == [3, 4, 5]
    assert done == 6
    assert float(state["acc"]) == 21.0  # 1+2+3 resumed + 4+5+6
    # snapshot cleared after completion
    assert elastic.LoopCheckpoint(path).load() is None


def test_resumable_loop_retries_device_failure():
    fails = {"armed": True}

    def step(i, state):
        if i == 2 and fails["armed"]:
            fails["armed"] = False
            raise _FakeXlaRuntimeError("transient")
        return {"acc": state["acc"] + 1.0}

    state, done = elastic.resumable_loop(
        step, {"acc": np.float64(0.0)}, 4, retries=1, wait=0.0,
        probe=False)
    assert done == 4
    assert float(state["acc"]) == 4.0


@pytest.fixture(scope="module")
def small_cloud():
    rng = np.random.RandomState(11)
    return (rng.rand(90, 3) * 12.0).astype(np.float64)


def test_lowest_modes_checkpoint_matches_plain(small_cloud, tmp_path):
    params = ffparams.invariant_params(8.0)
    kwargs = dict(k=4, degree=24, n_outer=4,
                  sparse=False, seed=3)
    vals, vecs, res = matfree.lowest_modes_matfree(small_cloud, params,
                                                   **kwargs)
    path = str(tmp_path / "modes.npz")
    vals_e, vecs_e, res_e = matfree.lowest_modes_matfree(
        small_cloud, params, checkpoint=path, retries=1, **kwargs)
    np.testing.assert_allclose(np.asarray(vals_e), np.asarray(vals),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(np.abs(np.asarray(vecs_e)),
                               np.abs(np.asarray(vecs)),
                               rtol=1e-4, atol=1e-5)


def test_lowest_modes_gnm_elastic_path(small_cloud, tmp_path):
    params = ffparams.invariant_params(8.0)
    kwargs = dict(k=3, degree=24, n_outer=3,
                  sparse=False, seed=5)
    vals, vecs, res = matfree.lowest_modes_matfree_gnm(
        small_cloud, params, **kwargs)
    vals_e, vecs_e, res_e = matfree.lowest_modes_matfree_gnm(
        small_cloud, params, retries=2, **kwargs)
    np.testing.assert_allclose(np.asarray(vals_e), np.asarray(vals),
                               rtol=1e-6, atol=1e-9)
