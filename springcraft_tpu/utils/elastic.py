"""
Failure detection and elastic recovery for long-running device loops.

The reference is a short-lived single-process NumPy library with no
failure handling (SURVEY §5 — absent).  This framework runs hour-scale
iterative solves whose outer iterations are separate device programs;
those program boundaries are natural recovery points, and this module
turns them into a recovery story:

* :func:`is_device_failure` — classify an exception as a device/runtime
  failure (XLA runtime errors, dead-client RPC errors) vs an ordinary
  bug, by exception type name and message fingerprints.
* :func:`probe_device` — liveness check: run a trivial program on the
  default backend with a wall-clock budget in a worker thread.
* :func:`retry_on_failure` — in-process retry for *transient* faults:
  clear JAX's live caches, wait, probe, re-invoke.
* :class:`LoopCheckpoint` — atomic ``.npz`` snapshots of a loop-carry
  pytree every *k* iterations.
* :func:`resumable_loop` — the composition: a generic outer-iteration
  loop with snapshot-on-step and resume-from-disk.  When the device
  runtime dies hard (the in-process client cannot be resurrected),
  rerunning the same script resumes from the last snapshot instead of
  recomputing — *cross-process* elasticity.

``lowest_modes_matfree(..., checkpoint=path)`` and the GNM counterpart
thread their Chebyshev outer loops through :func:`resumable_loop`.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time

import numpy as np

__all__ = [
    "is_device_failure",
    "probe_device",
    "retry_on_failure",
    "LoopCheckpoint",
    "resumable_loop",
    "DeviceProbeTimeout",
]

# Exception type names that indicate the device / runtime layer failed
# (matched by name so this works across jax/jaxlib versions without
# importing private modules).
_FAILURE_TYPE_NAMES = frozenset({
    "XlaRuntimeError",
    "JaxRuntimeError",
    "PjRtError",
})

# Message fingerprints of device-layer faults that can surface through
# generic RuntimeError/ValueError wrappers.
_FAILURE_FINGERPRINTS = (
    "DEADLINE_EXCEEDED",
    "UNAVAILABLE",
    "INTERNAL",
    "ABORTED",
    "socket closed",
    "connection reset",
    "worker crashed",
    "device or resource busy",
    "failed to execute",
)


class DeviceProbeTimeout(RuntimeError):
    """The device liveness probe did not complete within its budget."""


def is_device_failure(exc):
    """True if ``exc`` looks like a device/runtime failure rather than an
    ordinary Python bug.  Deliberately conservative: assertion/type/
    index errors and friends are never classified as device failures,
    so retries cannot mask real bugs."""
    if isinstance(exc, DeviceProbeTimeout):
        return True
    if isinstance(exc, (AssertionError, TypeError, IndexError, KeyError,
                        AttributeError, NameError)):
        return False
    for klass in type(exc).__mro__:
        if klass.__name__ in _FAILURE_TYPE_NAMES:
            return True
    msg = str(exc)
    return any(f.lower() in msg.lower() for f in _FAILURE_FINGERPRINTS)


def probe_device(timeout=30.0):
    """Liveness check of the default JAX backend: run a tiny program
    and fetch its result, in a worker thread so a hung device cannot
    hang the caller.  Raises :class:`DeviceProbeTimeout` on budget
    exhaustion; re-raises whatever the probe program raised."""
    import jax
    import jax.numpy as jnp

    result = {}

    def _probe():
        try:
            result["value"] = float(jnp.sum(jnp.arange(8.0)))
        except Exception as exc:  # noqa: BLE001 — reported to caller
            result["error"] = exc

    t = threading.Thread(target=_probe, daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        raise DeviceProbeTimeout(
            f"device probe did not return within {timeout:.0f}s")
    if "error" in result:
        raise result["error"]
    if result.get("value") != 28.0:
        raise RuntimeError(
            f"device probe computed {result.get('value')!r}, expected 28.0")


def retry_on_failure(fn, *args, retries=2, wait=5.0, probe=True,
                     probe_timeout=30.0, on_retry=None, **kwargs):
    """Call ``fn(*args, **kwargs)``; on a *device* failure
    (:func:`is_device_failure`) clear JAX's live executable caches,
    wait ``wait`` seconds, optionally probe the backend, and re-invoke
    — up to ``retries`` times.  Non-device exceptions propagate
    immediately.  ``on_retry(attempt, exc)`` is called before each
    retry (for logging)."""
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except Exception as exc:  # noqa: BLE001 — filtered below
            if not is_device_failure(exc) or attempt >= retries:
                raise
            attempt += 1
            if on_retry is not None:
                on_retry(attempt, exc)
            try:
                import jax

                jax.clear_caches()
            except Exception:  # noqa: BLE001 — cache clear is advisory
                pass
            if wait:
                time.sleep(wait)
            if probe:
                probe_device(probe_timeout)  # raises if still dead


class LoopCheckpoint:
    """Atomic ``.npz`` snapshots of a flat loop-carry state.

    The state is a dict of arrays/scalars (device arrays are fetched to
    host on save and restored as NumPy — the consuming step re-places
    them).  Writes go through a temp file + ``os.replace`` so a crash
    mid-write can never leave a truncated snapshot.
    """

    def __init__(self, path, every=1):
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        self.path = str(path)
        self.every = int(every)

    def save(self, iteration, state):
        payload = {"__iteration__": np.asarray(int(iteration))}
        for key, value in state.items():
            if key.startswith("__"):
                raise ValueError(f"state key {key!r} is reserved")
            payload[key] = np.asarray(value)
        directory = os.path.dirname(os.path.abspath(self.path))
        fd, tmp = tempfile.mkstemp(dir=directory, suffix=".npz.tmp")
        try:
            with os.fdopen(fd, "wb") as fh:
                np.savez(fh, **payload)
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def load(self):
        """``(iteration, state)`` of the snapshot, or ``None``."""
        if not os.path.exists(self.path):
            return None
        with np.load(self.path) as data:
            iteration = int(data["__iteration__"])
            state = {k: data[k] for k in data.files
                     if k != "__iteration__"}
        return iteration, state

    def clear(self):
        if os.path.exists(self.path):
            os.unlink(self.path)


def resumable_loop(step, state, n_steps, *, checkpoint=None, stop=None,
                   retries=2, wait=5.0, probe=True, on_retry=None):
    """Run ``state = step(i, state)`` for ``i in range(n_steps)`` with
    elastic recovery.

    ``state`` is a dict of arrays/scalars.  Each step is wrapped in
    :func:`retry_on_failure`; if ``checkpoint`` (a path or a
    :class:`LoopCheckpoint`) is given, the state is snapshotted every
    ``checkpoint.every`` completed iterations AND an existing snapshot
    is resumed from — so a process killed at iteration *j* restarts at
    *j*, not 0.  ``stop(state) -> bool`` ends the loop early.  The
    snapshot is cleared once the loop returns — either way the caller
    has its result; a snapshot only outlives a *crashed* run.

    Returns ``(state, completed_iterations)``.
    """
    ckpt = None
    if checkpoint is not None:
        ckpt = (checkpoint if isinstance(checkpoint, LoopCheckpoint)
                else LoopCheckpoint(checkpoint))
    start = 0
    if ckpt is not None:
        snapshot = ckpt.load()
        if snapshot is not None:
            start, state = snapshot
    completed = start
    for i in range(start, n_steps):
        state = retry_on_failure(step, i, state, retries=retries,
                                 wait=wait, probe=probe,
                                 on_retry=on_retry)
        completed = i + 1
        if stop is not None and stop(state):
            break
        if (ckpt is not None and completed % ckpt.every == 0
                and completed < n_steps):
            ckpt.save(completed, state)
    if ckpt is not None:
        ckpt.clear()
    return state, completed
