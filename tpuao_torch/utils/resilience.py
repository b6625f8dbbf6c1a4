"""Retry of transient runtime faults.

Counterpart of ``tpuao/utils/resilience.py``.  A frame render is a pure
function of its inputs, so recovering from a transient fault is calling
it again.  ``retry_transient`` does that for the faults a CUDA process can
come back from, and re-raises everything else at once.

The transient set (``TRANSIENT_MARKERS``, matched in the exception text):

* ``CUDA error: the launch timed out`` and ``unspecified launch timeout``:
  a watchdog cut a kernel on a card that also drives a display; the
  context stays usable;
* ``CUDA driver is busy`` / ``cudaErrorDevicesUnavailable`` /
  ``all CUDA-capable devices are busy or unavailable``: the card is held
  by another process in exclusive mode, for now.

Never transient:

* out of memory (``CUDA out of memory``, ``cudaErrorMemoryAllocation``):
  the same request would fail the same way, as in the JAX package;
* the sticky errors -- an illegal or misaligned address, an illegal
  instruction, a launch failure, an ECC or hardware fault: they poison the
  CUDA context, so every later call in the process fails too, and a retry
  only delays the restart the process needs.  A message that names one of
  these is never retried, whatever else it says.
"""

from __future__ import annotations

import functools
import time

TRANSIENT_MARKERS = (
    "the launch timed out",
    "unspecified launch timeout",
    "CUDA driver is busy",
    "cudaErrorDevicesUnavailable",
    "busy or unavailable",
)

# the context is poisoned after these: a retry cannot succeed
STICKY_MARKERS = (
    "illegal memory access",
    "an illegal instruction",
    "misaligned address",
    "unspecified launch failure",
    "cudaErrorLaunchFailure",
    "cudaErrorIllegalAddress",
    "cudaErrorMisalignedAddress",
    "uncorrectable ECC error",
    "hardware stack error",
)

OOM_MARKERS = ("out of memory", "cudaErrorMemoryAllocation")


def is_transient(exc: Exception) -> bool:
    """True when ``exc`` is a fault that a second attempt may clear."""
    msg = str(exc)
    if any(m in msg for m in STICKY_MARKERS + OOM_MARKERS):
        return False
    return any(m in msg for m in TRANSIENT_MARKERS)


def retry_transient(fn=None, *, retries: int = 2, backoff_s: float = 2.0):
    """Decorator/wrapper: re-invoke ``fn`` on transient runtime faults.

    Safe for pure frame renders (same inputs -> same outputs)::

        render = retry_transient(render_frame)
        ao = render(depth, camera, params)
    """

    def wrap(f):
        @functools.wraps(f)
        def run(*args, **kwargs):
            attempt = 0
            while True:
                try:
                    return f(*args, **kwargs)
                except Exception as e:  # noqa: BLE001 - filtered below
                    if attempt >= retries or not is_transient(e):
                        raise
                    attempt += 1
                    time.sleep(backoff_s * attempt)

        return run

    return wrap(fn) if fn is not None else wrap
