"""Per-step structured telemetry: a bounded ring buffer, flushed as JSONL.

Port of ``harp_tpu/telemetry/step_log.py``, event for event. The models call
:func:`record_chunk` ONLY at host chunk boundaries where the per-step losses
are ALREADY on the host (the fetch each fit does anyway). No call here
touches a tensor, so telemetry adds no synchronization with the card, and
when it is off (the default) the whole layer is one module-level ``None``
check a boundary.

Events are one JSON object per training step::

    {"v": 1, "model": "kmeans", "rank": 0, "step": 17, "loss": 81.2,
     "step_s": 0.0031, "chunk_steps": 4, "chunk_wall_s": 0.0124,
     "phase": "fit", "ts": 1723456789.2, ...}

``step_s`` is the chunk's wall amortized over its steps when the chunk ran
several iterations between two fetches; a one-step chunk's ``step_s`` is a
real per-step time. Events land in a bounded ring (oldest dropped first,
drops counted) and flush as JSONL to ``<dir>/rank<r>/steps.jsonl`` at the
boundary cadence, never inside a step. The rank is ``HARP_PROCESS_ID``, as
the launcher (``parallel/launch.py``) sets it.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

EVENT_VERSION = 1
DEFAULT_CAPACITY = 4096        # ring slots (events), not bytes
DEFAULT_INTERVAL = 16          # chunk boundaries between flushes/hook runs

ENV_DIR = "HARP_TELEMETRY_DIR"
ENV_INTERVAL = "HARP_TELEMETRY_INTERVAL"


def _rank() -> int:
    return int(os.environ.get("HARP_PROCESS_ID", "0"))


class StepLog:
    """Bounded per-rank step-event buffer with JSONL persistence.

    ``interval`` is counted in chunk BOUNDARIES, not seconds: every rank of
    a gang runs the same host loop, so a count keeps the boundary hooks
    (the gang snapshot exchange, a collective host call) aligned across
    ranks, where a wall-clock cadence would not.
    """

    def __init__(self, directory: str, *, capacity: int = DEFAULT_CAPACITY,
                 interval: int = DEFAULT_INTERVAL,
                 rank: Optional[int] = None, metrics=None):
        if metrics is None:
            from harp_tpu_torch.utils.metrics import DEFAULT as metrics
        self.directory = directory
        self.rank = _rank() if rank is None else rank
        self.interval = max(1, int(interval))
        self.metrics = metrics
        self.capacity = capacity
        self.dropped = 0
        self.boundaries = 0
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        # the flush's drain and file append are atomic under the lock (a
        # recorder on another thread may flush); emit needs none
        # (deque.append is atomic under the interpreter lock)
        self._flush_lock = threading.Lock()
        self._hooks: List[Callable[[int, "StepLog"], None]] = []
        self._rank_dir = os.path.join(directory, f"rank{self.rank}")
        os.makedirs(self._rank_dir, exist_ok=True)
        self.path = os.path.join(self._rank_dir, "steps.jsonl")

    # -- ring ---------------------------------------------------------------
    def emit(self, event: Dict) -> None:
        if len(self._ring) == self.capacity:
            # deque(maxlen) evicts silently: count the loss
            self.dropped += 1
            self.metrics.count("telemetry.events_dropped")
        self._ring.append(event)

    def flush(self) -> int:
        """Drain the ring to the per-rank JSONL file; returns the events
        written. Thread-safe."""
        with self._flush_lock:
            if not self._ring:
                return 0
            n = 0
            with open(self.path, "a") as f:
                while self._ring:
                    f.write(json.dumps(self._ring.popleft()) + "\n")
                    n += 1
        self.metrics.count("telemetry.events_flushed", n)
        return n

    # -- boundary hooks (gang aggregation, profiler windows) ---------------
    def add_boundary_hook(self, fn: Callable[[int, "StepLog"], None]) -> None:
        """Register ``fn(boundary_index, log)`` to run at EVERY chunk
        boundary (hooks gate themselves on cadence: the profiler window
        ticks each boundary, the gang gather every ``interval``)."""
        self._hooks.append(fn)

    def boundary(self) -> None:
        """One chunk boundary: run hooks, flush on the interval cadence."""
        self.boundaries += 1
        for fn in list(self._hooks):
            fn(self.boundaries, self)
        if self.boundaries % self.interval == 0 \
                or len(self._ring) >= self.capacity:
            self.flush()

    def close(self) -> None:
        """Close the boundary hooks that hold resources (a profiler window
        still open at the last boundary must stop, or its trace is never
        written: ``XprofController.close``), then flush."""
        for fn in self._hooks:
            closer = getattr(fn, "close", None)
            if closer is not None:
                closer()
        self.flush()


# -- module-level active log (the models' single None-check fast path) -------

_active: Optional[StepLog] = None
_env_checked = False
_atexit_installed = False


def _flush_at_exit() -> None:
    # the last chunk usually lands below the flush cadence: an exiting
    # process must not lose the tail of its log or an open profiler window
    if _active is not None:
        _active.close()


def configure(directory: Optional[str] = None, *,
              interval: Optional[int] = None,
              capacity: int = DEFAULT_CAPACITY,
              rank: Optional[int] = None, metrics=None) -> Optional[StepLog]:
    """Install the process StepLog. ``directory=None`` reads
    ``HARP_TELEMETRY_DIR`` (unset: telemetry stays off). Returns the active
    log (or None). Reconfiguring closes the old log first."""
    global _active, _env_checked
    _env_checked = True
    if directory is None:
        directory = os.environ.get(ENV_DIR) or None
    if interval is None:
        interval = int(os.environ.get(ENV_INTERVAL, DEFAULT_INTERVAL))
    if _active is not None:
        _active.close()
        _active = None
    if directory:
        _active = StepLog(directory, capacity=capacity, interval=interval,
                          rank=rank, metrics=metrics)
        global _atexit_installed
        if not _atexit_installed:
            atexit.register(_flush_at_exit)
            _atexit_installed = True
    return _active


def disable() -> None:
    """Flush and turn telemetry off (also ignores the environment variable
    until the next explicit :func:`configure`)."""
    global _active, _env_checked
    if _active is not None:
        _active.close()
    _active = None
    _env_checked = True


def active() -> Optional[StepLog]:
    """The process StepLog, configured from the environment on first use
    (gang members inherit HARP_TELEMETRY_DIR from the launcher)."""
    global _env_checked
    if _active is None and not _env_checked:
        if os.environ.get(ENV_DIR):
            return configure()
        _env_checked = True
    return _active


# -- the one call the models make --------------------------------------------

def record_chunk(model: str, *, start: int,
                 losses: Optional[Sequence[float]] = None,
                 steps: Optional[int] = None,
                 wall_s: Optional[float] = None,
                 ledger=None, phase: str = "fit",
                 extra: Optional[Dict] = None) -> None:
    """Record one host chunk boundary: ``steps`` training steps beginning at
    0-based ``start``, with per-step ``losses`` ALREADY on the host (host
    floats, never tensors: convert at an existing fetch or pass None), the
    chunk's measured ``wall_s``, and an optional
    :class:`~harp_tpu_torch.telemetry.comm_ledger.CommLedger` to advance.

    A no-op (one None check) when telemetry is off.
    """
    log = active()
    if log is None:
        return
    n = steps if steps is not None else (len(losses) if losses is not None
                                         else 1)
    if n <= 0:
        return
    step_s = (wall_s / n) if wall_s is not None else None
    if step_s is not None:
        # the straggler detector's signal: one sample per step, so p50
        # weighs steps, not chunks of different lengths
        for _ in range(n):
            log.metrics.observe(f"telemetry.step.{model}", step_s)
    if ledger is not None:
        ledger.on_steps(n, wall_s=wall_s)
    ts = time.time()
    base = {"v": EVENT_VERSION, "model": model, "rank": log.rank,
            "phase": phase, "ts": round(ts, 3)}
    if extra:
        base.update(extra)
    if ledger is not None and ledger.bytes_per_step is not None:
        base["wire_bytes_per_step"] = ledger.bytes_per_step
        # "scaled": the model computed its payload ratio to the traced
        # shape; "traced_shape": the fixed reference row (comm_ledger)
        base["wire_pricing"] = ("scaled" if getattr(ledger, "exact", False)
                                else "traced_shape")
    for i in range(n):
        ev = dict(base)
        ev["step"] = start + i
        ev["chunk_steps"] = n
        if wall_s is not None:
            ev["step_s"] = round(step_s, 9)
            ev["chunk_wall_s"] = round(wall_s, 6)
        if losses is not None and i < len(losses):
            ev["loss"] = float(losses[i])
        log.emit(ev)
    log.metrics.count(f"telemetry.steps.{model}", n)
    log.boundary()


def record_timing(name: str, *, timer: Optional[str] = None,
                  metrics=None, extra: Optional[Dict] = None) -> None:
    """Write a timer's percentile snapshot into ``steps.jsonl``: one event,
    ``kind: "timing"``, whose latency fields are EXACTLY
    ``utils.metrics.Metrics.timing()`` (count/total_s/mean_s/last_s/p50_s/
    p90_s/p99_s), the schema of the straggler report's rows. ``timer``
    names the reservoir (default: ``name``); ``metrics`` overrides the
    registry. A no-op when telemetry is off or the timer has no samples.
    """
    log = active()
    if log is None:
        return
    reg = metrics if metrics is not None else log.metrics
    t = reg.timing(timer or name)
    if not t:
        return
    ev = {"v": EVENT_VERSION, "kind": "timing", "name": name,
          "rank": log.rank, "ts": round(time.time(), 3)}
    ev.update(t)
    if extra:
        ev.update(extra)
    log.emit(ev)
    log.boundary()


@contextlib.contextmanager
def phase(name: str):
    """Host phase timer (checkpoint save, data load, gang gather): records
    into the bounded ``telemetry.phase.<name>`` timer when telemetry is on;
    a plain no-op otherwise."""
    log = active()
    if log is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        log.metrics.observe(f"telemetry.phase.{name}",
                            time.perf_counter() - t0)
