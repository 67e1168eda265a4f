"""Gang aggregation and straggler detection over the events control plane.

Port of ``harp_tpu/telemetry/gang.py``. A straggling but live rank (a card
held back by its power limit, a noisy neighbour on its host) stretches
every bulk-synchronous step to the slowest member's pace. This module
exchanges every rank's ``Metrics.snapshot()`` (per-step p50/p90/p99 from the
bounded timer reservoirs) over the session's event plane
(``HarpSession.send_event``, collective events on the gloo group) and
writes a straggler report: suspect = sustained p50 step time > ``k`` x the
gang median. The report is JSON next to the telemetry JSONL, readable
without joining the gang.

The exchange functions are COLLECTIVE host calls: every rank calls them at
the same chunk boundary (the count-based telemetry interval keeps the
cadence aligned). The process count and rank come from
``parallel/distributed.py``; a single process degrades to its local
snapshot.
"""

from __future__ import annotations

import json
import os
import statistics
import threading
import time
from typing import Dict, List, Optional

SNAPSHOT_TAG = "harp.telemetry.snapshot"
REPORT_NAME = "straggler_report.json"
REPORT_VERSION = 1

# suspect threshold: sustained p50 step time > k x gang median
DEFAULT_K = 2.0
# a rank must have this many step samples before its p50 is trusted: a
# single cold-start step must not flag a healthy rank
DEFAULT_MIN_SAMPLES = 3
# ... and must exceed the median by an absolute floor too: 2 us against a
# 1 us median clears any ratio k but drags nothing
DEFAULT_MIN_GAP_S = 1e-3


def gather_snapshots(session, metrics=None) -> Dict[int, dict]:
    """Exchange per-rank metric snapshots; every rank returns the full map.

    COLLECTIVE: all processes call together. One small broadcast per source
    rank on the host control plane. Unrelated events already queued are put
    back, not lost.
    """
    from harp_tpu_torch.parallel import distributed

    if metrics is None:
        from harp_tpu_torch.utils.metrics import DEFAULT as metrics
    local = metrics.snapshot()
    n = distributed.process_count()
    if n == 1:
        return {int(os.environ.get("HARP_PROCESS_ID", "0")): local}
    for src in range(n):
        session.send_event((SNAPSHOT_TAG, src, local), source=src)
    snaps: Dict[int, dict] = {}
    requeue = []
    while len(snaps) < n:
        ev = session.get_event()
        if ev is None:
            break               # queue drained early: report what arrived
        payload = ev.payload
        if (isinstance(payload, tuple) and len(payload) == 3
                and payload[0] == SNAPSHOT_TAG):
            snaps[int(payload[1])] = payload[2]
        else:
            requeue.append(ev)
    queue = session.open_events()[0]
    for ev in requeue:
        queue.put(ev)
    return snaps


def _step_timing(snapshot: dict, timer_prefix: str) -> Optional[dict]:
    """The rank's step timer: the ``timer_prefix`` timer with the most
    samples (a rank running several models reports its busiest loop)."""
    timers = snapshot.get("timers", {})
    best = None
    for name, t in timers.items():
        if name.startswith(timer_prefix) and t.get("count", 0):
            if best is None or t["count"] > best["count"]:
                best = t
    return best


def straggler_report(per_rank: Dict[int, dict], *,
                     timer_prefix: str = "telemetry.step",
                     k: float = DEFAULT_K,
                     min_samples: int = DEFAULT_MIN_SAMPLES,
                     min_gap_s: float = DEFAULT_MIN_GAP_S) -> dict:
    """Detection over exchanged snapshots (a pure function).

    Two signals, because one straggler leaves opposite signatures in the
    timers depending on the loop:

    * ``suspects``: p50 > k x gang median, a SELF-PACED loop (each rank
      times its own work, no collective inside the timed region), where
      the straggler's own timer inflates.
    * ``bsp_suspects``: p50 x k < gang median, a BULK-SYNCHRONOUS fit loop
      (the timed chunk's first collective makes every healthy rank wait),
      where the drag lands in the victims' timers and the straggler is the
      one rank NOT waiting.

    Ranks with fewer than ``min_samples`` step samples are listed but kept
    out of the median and both suspect lists (cold ranks are unknown, not
    slow). With fewer than 2 measurable ranks there is no median and no
    suspect. Both signals keep the ``min_gap_s`` absolute floor.
    """
    ranks: Dict[int, dict] = {}
    p50s: List[float] = []
    for rank, snap in sorted(per_rank.items()):
        t = _step_timing(snap, timer_prefix)
        row = {"count": int(t["count"]) if t else 0,
               "p50_s": t.get("p50_s") if t else None,
               "p99_s": t.get("p99_s") if t else None,
               "measurable": bool(t) and t.get("count", 0) >= min_samples}
        ranks[rank] = row
        if row["measurable"]:
            p50s.append(row["p50_s"])
    median = statistics.median(p50s) if len(p50s) >= 2 else None
    suspects, bsp_suspects = [], []
    if median is not None:
        suspects = [r for r, row in ranks.items()
                    if row["measurable"] and row["p50_s"] > k * median
                    and row["p50_s"] - median >= min_gap_s]
        bsp_suspects = [r for r, row in ranks.items()
                        if row["measurable"] and row["p50_s"] * k < median
                        and median - row["p50_s"] >= min_gap_s]
    return {"v": REPORT_VERSION, "ts": round(time.time(), 3), "k": k,
            "min_samples": min_samples, "min_gap_s": min_gap_s,
            "num_ranks": len(per_rank),
            "gang_median_p50_s": median, "ranks": ranks,
            "suspects": suspects, "bsp_suspects": bsp_suspects}


def write_straggler_report(directory: str, report: dict) -> str:
    """Write one report as ``<dir>/straggler_report.json`` (atomic rename:
    a reader may look mid-publish)."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, REPORT_NAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(report, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


def publish_straggler_report(session, directory: str, *, metrics=None,
                             k: float = DEFAULT_K,
                             min_samples: int = DEFAULT_MIN_SAMPLES,
                             min_gap_s: float = DEFAULT_MIN_GAP_S,
                             snapshots: Optional[Dict[int, dict]] = None
                             ) -> dict:
    """Gather, detect and write. COLLECTIVE (all ranks call) unless
    ``snapshots`` passes an exchange already gathered (GangCollector does);
    every rank returns the same report, and only rank 0 writes
    ``<dir>/straggler_report.json``."""
    from harp_tpu_torch.parallel import distributed

    snaps = (gather_snapshots(session, metrics=metrics)
             if snapshots is None else snapshots)
    report = straggler_report(snaps, k=k, min_samples=min_samples,
                              min_gap_s=min_gap_s)
    if metrics is None:
        from harp_tpu_torch.utils.metrics import DEFAULT as metrics
    metrics.gauge("telemetry.straggler_suspects", len(report["suspects"]))
    if distributed.process_index() == 0:
        write_straggler_report(directory, report)
    return report


def read_straggler_report(directory: Optional[str]) -> Optional[dict]:
    """The newest report under a telemetry directory, or None (a missing
    or torn file means no signal)."""
    if not directory:
        return None
    path = os.path.join(directory, REPORT_NAME)
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


class GangCollector:
    """Boundary hook: publish the straggler report every ``every`` x the
    log's interval chunk boundaries (a count, so all ranks broadcast at the
    same boundary; install it only where every rank runs the same host
    loop, as ``run.py`` in a gang does)."""

    def __init__(self, session, directory: str, *, every: int = 1,
                 k: float = DEFAULT_K,
                 min_samples: int = DEFAULT_MIN_SAMPLES,
                 min_gap_s: float = DEFAULT_MIN_GAP_S):
        self.session = session
        self.directory = directory
        self.every = max(1, every)
        self.k = k
        self.min_samples = min_samples
        self.min_gap_s = min_gap_s
        # the newest exchange and report: written by the training thread,
        # read by the exporter's scrape threads (``gang=collector.
        # snapshots``); the lock makes each publish atomic, and
        # last_exchange() reads the pair from one publish
        self._publish_lock = threading.Lock()
        self._last_report: Optional[dict] = None
        self._last_snapshots: Optional[Dict[int, dict]] = None

    @property
    def last_report(self) -> Optional[dict]:
        with self._publish_lock:
            return self._last_report

    @property
    def last_snapshots(self) -> Optional[Dict[int, dict]]:
        with self._publish_lock:
            return self._last_snapshots

    def last_exchange(self):
        """``(snapshots, report)`` from ONE publish, under one lock hold."""
        with self._publish_lock:
            return self._last_snapshots, self._last_report

    def snapshots(self) -> Optional[Dict[int, dict]]:
        """The exporter's ``gang=`` source."""
        return self.last_snapshots

    def __call__(self, boundary_index: int, log) -> None:
        if boundary_index % (self.every * log.interval) != 0:
            return
        from harp_tpu_torch.telemetry.step_log import phase

        with phase("gang.straggler_publish"):
            snaps = gather_snapshots(self.session, metrics=log.metrics)
            report = publish_straggler_report(
                self.session, self.directory, metrics=log.metrics,
                k=self.k, min_samples=self.min_samples,
                min_gap_s=self.min_gap_s, snapshots=snaps)
            with self._publish_lock:
                self._last_snapshots = snaps
                self._last_report = report
