"""Dynamic micro-batching for AO serving.

Counterpart of ``tpuao/utils/batching.py``.  A serving process receives
single frames from many clients, and the card renders a batch of frames in
one launch per kernel (the batch is the kernels' ``blockIdx.z``).
``MicroBatcher`` bridges the two: requests queue per frame shape, a worker
flushes a queue when it reaches ``batch_size`` frames or the oldest request
has waited ``max_delay_ms``, and every flush pads the batch up to the
smallest rung of a small **batch-shape ladder** (default ``{1, 4,
batch_size}``) that fits it.  The JAX package compiles one program per
rung; here a rung is only a batch size, and the ladder keeps what it gives
there: few batch shapes per frame shape, and at low occupancy a flush of
one frame renders one frame, not ``batch_size``.  Results come back
through per-request futures.

    batcher = MicroBatcher(lambda d: render_frame(d, cam, params),
                           batch_size=4)
    fut = batcher.submit(depth)          # from any thread
    ao = fut.result()

The render function receives a stacked ``(rung, H, W)`` NumPy array and
returns a leading-batch result, a NumPy array or a tensor on any device
(it comes back to the host here).  Requests may carry ``normals``/``color``
extras: they batch only with requests of the same buffer combination and
shapes, and the render function receives the stacked extras as keywords
-- so a render function that serves multi-buffer traffic must accept
``normals=None, color=None``.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict, deque
from concurrent.futures import Future

import numpy as np
import torch


def to_host(out) -> np.ndarray:
    """A render result as a host NumPy array: a tensor on any device comes
    back to the host (bfloat16, which NumPy lacks, widened to float32)."""
    if isinstance(out, torch.Tensor):
        if out.dtype == torch.bfloat16:
            out = out.float()
        return out.detach().cpu().numpy()
    return np.asarray(out)


class MicroBatcher:
    def __init__(self, render_fn, batch_size: int = 4,
                 max_delay_ms: float = 5.0,
                 ladder: tuple[int, ...] | None = None):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self._render = render_fn
        self.batch_size = self._bs = batch_size  # batch_size is public
        if ladder is None:
            ladder = tuple(r for r in (1, 4) if r < batch_size)
        self.ladder = tuple(sorted({int(r) for r in ladder if r >= 1}
                                   | {batch_size}))
        if self.ladder[-1] > batch_size:
            raise ValueError(f"ladder {ladder} exceeds "
                             f"batch_size={batch_size}")
        self._delay = max_delay_ms / 1e3
        self._lock = threading.Condition()
        self._queues: dict[tuple, deque] = defaultdict(deque)
        self._closed = False
        self._stats = {"flushes": 0, "frames": 0, "padded": 0,
                       "rung_flushes": {r: 0 for r in self.ladder}}
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def stats(self) -> dict:
        """Flush counters (observability): a high ``padded``/``frames``
        ratio means even the ladder's lowest rungs exceed the real
        concurrency; ``rung_flushes`` shows which batch shapes traffic
        actually rides."""
        with self._lock:
            out = dict(self._stats)
            out["rung_flushes"] = dict(out["rung_flushes"])
            return out

    def warm(self, depth, normals=None, color=None) -> list[int]:
        """Render one synthetic padded batch of every ladder rung for one
        frame shape, directly (deterministic -- submitting through the
        queue cannot guarantee which rung a flush lands on): the kernels'
        library is built and each batch size has run once.  Returns the
        rung sizes warmed."""
        depth = np.asarray(depth, dtype=np.float32)
        for rung in self.ladder:
            kw = {}
            if normals is not None:
                kw["normals"] = np.stack([np.asarray(normals,
                                                     np.float32)] * rung)
            if color is not None:
                kw["color"] = np.stack([np.asarray(color,
                                                   np.float32)] * rung)
            to_host(self._render(np.stack([depth] * rung), **kw))
        return list(self.ladder)

    # -- client side -------------------------------------------------------
    def submit(self, depth, normals=None, color=None) -> Future:
        """Queue one (H, W) frame; returns a Future for its result.

        Optional per-frame ``normals`` (H, W, 3) and ``color`` buffers
        ride the same queueing: requests batch only with requests
        carrying the SAME buffer combination and shapes (the queue key),
        so every flush is homogeneous.  The render function receives the
        stacked
        extras as ``normals=``/``color=`` keywords."""
        depth = np.asarray(depth, dtype=np.float32)
        if depth.ndim != 2:
            raise ValueError(f"submit takes one (H, W) frame, "
                             f"got {depth.shape}")
        if normals is not None:
            normals = np.asarray(normals, dtype=np.float32)
            if normals.shape != depth.shape + (3,):
                raise ValueError(f"normals must be {depth.shape + (3,)} "
                                 f"matching depth, got {normals.shape}")
        if color is not None:
            color = np.asarray(color, dtype=np.float32)
            if color.shape[:2] != depth.shape:
                raise ValueError(f"color shape {color.shape} does not "
                                 f"match depth {depth.shape}")
        key = (depth.shape,
               None if normals is None else normals.shape,
               None if color is None else color.shape)
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self._queues[key].append(
                ((depth, normals, color), fut, time.monotonic()))
            self._lock.notify()
        return fut

    # -- worker ------------------------------------------------------------
    def _take_ready(self):
        """Under the lock: pop the due flush with the OLDEST head request.

        Oldest-first matters: taking the first ready queue in dict order
        would let one continuously saturated frame shape starve other
        shapes past max_delay_ms indefinitely."""
        now = time.monotonic()
        soonest = None
        best = None
        for shape, q in self._queues.items():
            if not q:
                continue
            if len(q) >= self._bs or now - q[0][2] >= self._delay:
                if best is None or q[0][2] < self._queues[best][0][2]:
                    best = shape
            else:
                soonest = min(soonest or 1e9, self._delay - (now - q[0][2]))
        if best is not None:
            q = self._queues[best]
            items = [q.popleft() for _ in range(min(len(q), self._bs))]
            return (best, items), None
        return None, soonest

    def _run(self):
        while True:
            with self._lock:
                ready, wait = self._take_ready()
                while ready is None and not self._closed:
                    self._lock.wait(timeout=wait)
                    ready, wait = self._take_ready()
                if ready is None:  # closed and drained
                    return
            _, items = ready
            tups = [it[0] for it in items]
            # smallest ladder rung that fits this flush: few batch shapes,
            # minimal junk frames at low occupancy
            rung = next(r for r in self.ladder if r >= len(tups))
            pad = rung - len(tups)
            tups = tups + [tups[-1]] * pad
            batch = np.stack([t[0] for t in tups])
            kw = {}
            if tups[0][1] is not None:
                kw["normals"] = np.stack([t[1] for t in tups])
            if tups[0][2] is not None:
                kw["color"] = np.stack([t[2] for t in tups])
            with self._lock:
                self._stats["flushes"] += 1
                self._stats["frames"] += len(items)
                self._stats["padded"] += pad
                self._stats["rung_flushes"][rung] += 1
            try:
                out = to_host(self._render(batch, **kw))
                for i, (_, fut, _) in enumerate(items):
                    # own the frame's memory: a view into `out` would pin
                    # the whole (batch, H, W) block (pad frames included)
                    # for as long as any one client holds its result
                    fut.set_result(out[i].copy())
            except Exception as e:  # pragma: no cover - render errors
                for (_, fut, _) in items:
                    if not fut.done():
                        fut.set_exception(e)

    # -- lifecycle ---------------------------------------------------------
    def close(self, timeout: float = 10.0):
        """Flush remaining requests and stop the worker (idempotent)."""
        with self._lock:
            self._closed = True
            self._delay = 0.0  # drain immediately
            self._lock.notify_all()
        self._worker.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
