"""Metrics and phase timing: counters, gauges and bounded timers.

Port of ``harp_tpu/utils/metrics.py``. Reference parity (SURVEY §5): Harp
logged wall-clock per phase with log4j (KMeansCollectiveMapper.java:190-195)
and JVM memory through ``logMemUsage``:686. Here: a process-local registry
of counters, gauges and timers with the same phase-timing idiom, and the
CUDA caching allocator's counters in place of the JVM calls
(:func:`log_device_mem_usage`). Timers keep a bounded reservoir of samples
(exact count, total and last; percentiles over a uniform subsample), so a
long job cannot grow memory through its timers. Pure Python: the registry
and its percentiles are the JAX package's, value for value.
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import os
import random
import threading
import time
from collections import defaultdict
from typing import Dict, Optional

log = logging.getLogger("harp_tpu_torch")

# Bounded timer storage: enough samples that p99 over a uniform reservoir is
# stable, small enough that thousands of timers stay in the low tens of MB.
RESERVOIR_CAP = 2048


class TimerReservoir:
    """Bounded sample store for one timer.

    ``count``/``total``/``last`` are EXACT over every observation; the sample
    buffer holds at most ``cap`` values maintained as a uniform random
    reservoir (Vitter's algorithm R), so percentiles stay representative of
    the whole stream after the cap is reached. The RNG is seeded per
    reservoir: snapshots are reproducible for a deterministic observation
    stream.

    Thread-safe: ``add``/``merge``/``percentiles`` serialize on ``lock``
    (``count += 1`` and the eviction slot write are read-modify-writes —
    concurrent unsynchronized adders lose observations).
    Pass an existing lock to share one lock across a registry (``Metrics``
    does); standalone reservoirs get their own.
    """

    __slots__ = ("count", "total", "last", "samples", "_cap", "_rng",
                 "_lock")

    def __init__(self, cap: int = RESERVOIR_CAP, seed: int = 0,
                 lock: Optional[threading.RLock] = None):
        self.count = 0
        self.total = 0.0
        self.last = 0.0
        self.samples = []
        self._cap = cap
        self._rng = random.Random(seed)
        self._lock = lock if lock is not None else threading.RLock()

    def add(self, value: float) -> None:
        with self._lock:
            self.count += 1
            self.total += value
            self.last = value
            if len(self.samples) < self._cap:
                self.samples.append(value)
            else:
                j = self._rng.randrange(self.count)
                if j < self._cap:
                    self.samples[j] = value

    def merge(self, other: "TimerReservoir") -> None:
        """Fold another reservoir in: count/total stay EXACT (plain sums),
        the sample buffer concatenates and uniformly subsamples back to
        the cap. ``other`` should be quiescent (the serial join step for
        per-thread/per-mix reservoirs after their writers stop); this
        reservoir may keep serving concurrent adds."""
        with self._lock:
            self.count += other.count
            self.total += other.total
            if other.count:
                self.last = other.last
            combined = self.samples + list(other.samples)
            if len(combined) > self._cap:
                combined = self._rng.sample(combined, self._cap)
            self.samples = combined

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile over the reservoir (q in [0, 1])."""
        return self.percentiles([q])[0]

    def percentiles(self, qs) -> list:
        """Several nearest-rank percentiles off ONE sort of the reservoir
        (timing() asks for three; snapshot() calls timing() per timer at
        every gang publish — re-sorting 2048 samples per quantile would
        triple that cost for nothing). The lock covers only the sample
        COPY; the sort runs outside it so a hot adder never blocks on a
        reader's O(n log n)."""
        with self._lock:
            samples = list(self.samples)
        return _nearest_rank(samples, qs)


def _nearest_rank(samples: list, qs) -> list:
    """Nearest-rank percentiles over an (unsorted) sample copy — pure, no
    lock: callers copy under their lock and compute out here."""
    if not samples:
        return [float("nan")] * len(qs)
    ordered = sorted(samples)
    n = len(ordered)
    return [ordered[min(n - 1, max(0, math.ceil(q * n) - 1))]
            for q in qs]


class Metrics:
    """Process-local metric registry (counters, gauges, timers).

    Thread-safe under ONE registry lock: the serving plane feeds a shared
    registry from the router receive thread, every micro-batcher thread,
    and the exporter's scrape threads at once — ``counters[name] += v``
    is a read-modify-write that silently loses increments unsynchronized
    and an unlocked ``snapshot()`` iterating the timers
    dict mid-insert raises. The per-timer reservoirs share the same
    (reentrant) lock, so one acquisition covers a whole
    ``observe``/``timing`` and lock order is trivially consistent.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self.counters: Dict[str, float] = defaultdict(float)
        self.gauges: Dict[str, float] = {}
        self.timers: Dict[str, TimerReservoir] = defaultdict(
            lambda: TimerReservoir(lock=self._lock))

    def count(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[name] += value

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = value

    def observe(self, name: str, seconds: float) -> None:
        """Record one timer sample directly (for durations measured by the
        caller — e.g. the telemetry layer's amortized per-step times)."""
        with self._lock:
            self.timers[name].add(seconds)

    @contextlib.contextmanager
    def timer(self, name: str):
        """Phase timer (Harp's per-iteration ms logging idiom)::

            with metrics.timer("iteration"):
                ...
        """
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - t0)

    def merge(self, other: "Metrics") -> None:
        """Fold another registry in (counters summed, gauges taken from
        ``other``, timers reservoir-merged) — the serial join step for
        per-thread registries (``other`` quiescent; this registry may stay
        live)."""
        with self._lock:
            for name, v in other.counters.items():
                self.counters[name] += v
            self.gauges.update(other.gauges)
            for name, r in other.timers.items():
                self.timers[name].merge(r)

    @staticmethod
    def _timing_from_state(count, total, last, samples) -> Dict[str, float]:
        if not count:
            return {}
        p50, p90, p99 = _nearest_rank(samples, [0.50, 0.90, 0.99])
        return {"count": count, "total_s": total, "mean_s": total / count,
                "last_s": last, "p50_s": p50, "p90_s": p90, "p99_s": p99}

    def timing(self, name: str) -> Dict[str, float]:
        with self._lock:
            r = self.timers.get(name)
            if r is None or not r.count:
                return {}
            state = (r.count, r.total, r.last, list(r.samples))
        return self._timing_from_state(*state)

    def snapshot(self) -> Dict[str, object]:
        """A consistent point-in-time view: ONE lock hold copies raw state
        (a scrape never sees the timers dict mid-insert or a counter
        between the load and the store of its increment), and the
        per-timer percentile sorts run OUTSIDE the lock — an exporter
        scrape must never stall the serving hot path for O(n log n) per
        reservoir."""
        with self._lock:
            counters = dict(self.counters)
            gauges = dict(self.gauges)
            states = {k: (r.count, r.total, r.last, list(r.samples))
                      for k, r in self.timers.items()}
        return {
            "counters": counters,
            "gauges": gauges,
            "timers": {k: self._timing_from_state(*s)
                       for k, s in states.items()},
        }

    def dump(self, path: str) -> None:
        """Persist a snapshot as JSON (the supervisor drops one next to its
        restart journal so recovery counters survive the process)."""
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2, sort_keys=True)

    def log_summary(self) -> None:
        # one consistent copy, then log OUTSIDE the lock (log.info does
        # I/O — holding the registry lock across it would stall every
        # serving thread for the duration of a handler flush)
        snap = self.snapshot()
        for name in sorted(snap["timers"]):
            s = snap["timers"][name]
            if not s:
                continue
            log.info("timer %-24s n=%d total=%.3fs mean=%.4fs p50=%.4fs "
                     "p99=%.4fs", name, s["count"], s["total_s"], s["mean_s"],
                     s["p50_s"], s["p99_s"])
        for name, v in sorted(snap["counters"].items()):
            log.info("counter %-22s %.0f", name, v)


DEFAULT = Metrics()


def log_device_mem_usage(metrics: Optional[Metrics] = None
                         ) -> Dict[str, Dict[str, int]]:
    """Device-memory introspection (replaces CollectiveMapper.logMemUsage:686
    / logGCTime:696): ``{device: {"bytes_in_use", "peak_bytes_in_use"}}``
    from ``torch.cuda.memory_stats`` of every visible card, gauged per card
    when a ``metrics`` registry is passed. Without CUDA there are no device
    counters: the result is empty and the log says so (the JAX package
    reads its devices' memory stats, which its CPU backend lacks too)."""
    import torch

    out: Dict[str, Dict[str, int]] = {}
    if not torch.cuda.is_available():
        log.info("no CUDA device: no device memory counters")
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        row = {"bytes_in_use": int(stats.get("allocated_bytes.all.current",
                                             0)),
               "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                                  0))}
        name = f"cuda:{i}"
        out[name] = row
        if metrics is not None:
            metrics.gauge(f"device.{i}.bytes_in_use", row["bytes_in_use"])
            metrics.gauge(f"device.{i}.peak_bytes_in_use",
                          row["peak_bytes_in_use"])
        log.info("device %s: %d bytes in use (peak %d)", name,
                 row["bytes_in_use"], row["peak_bytes_in_use"])
    return out
