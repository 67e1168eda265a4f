"""Live metrics export: a per-process pull endpoint over ``utils/metrics``.

Port of ``harp_tpu/telemetry/exporter.py``. :class:`MetricsExporter` is a
stdlib ``http.server`` thread bound to loopback (``127.0.0.1``) serving

* ``GET /metrics``: Prometheus text exposition. Every counter as a
  ``counter``, every gauge as a ``gauge``, every bounded timer as a
  ``summary`` (``{quantile="0.5|0.9|0.99"}`` from the reservoir, exact
  ``_count``/``_sum``). Names are sanitized
  (``comm.kmeans_regroupallgather.cumulative_gb`` ->
  ``harp_comm_kmeans_regroupallgather_cumulative_gb``).
* ``GET /snapshot``: the raw ``Metrics.snapshot()`` JSON plus
  ``{rank, ts}`` (the dict the straggler exchange broadcasts).
* ``GET /gang``: the gang view when a source is wired (``gang=`` callable
  returning ``{rank: snapshot}``; ``run.py`` passes the
  :class:`~harp_tpu_torch.telemetry.gang.GangCollector`'s last exchange; 404
  without one): per-rank snapshots and an :func:`aggregate_snapshots`
  roll-up (counters summed, timer counts and totals summed, worst-rank
  percentiles, since percentiles do not merge).

``Metrics.snapshot()`` is consistent under the registry's lock, so a scrape
sees one point in time while the fit writes. The exporter binds port 0
(ephemeral) unless told otherwise, serves from a daemon thread, and closes
at exit.
"""

from __future__ import annotations

import atexit
import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")
PREFIX = "harp_"
QUANTILES = ((0.5, "0.5"), (0.9, "0.9"), (0.99, "0.99"))


def _sanitize(name: str) -> str:
    return PREFIX + _NAME_RE.sub("_", name)


def prometheus_text(snapshot: Dict) -> str:
    """Render one ``Metrics.snapshot()`` dict as Prometheus text
    exposition (pure function — the schema test and the handler share
    it)."""
    lines = []
    for name in sorted(snapshot.get("counters", {})):
        mname = _sanitize(name)
        lines.append(f"# TYPE {mname} counter")
        lines.append(f"{mname} {snapshot['counters'][name]:g}")
    for name in sorted(snapshot.get("gauges", {})):
        mname = _sanitize(name)
        lines.append(f"# TYPE {mname} gauge")
        lines.append(f"{mname} {snapshot['gauges'][name]:g}")
    for name in sorted(snapshot.get("timers", {})):
        t = snapshot["timers"][name]
        if not t:
            continue
        mname = _sanitize(name) + "_seconds"
        lines.append(f"# TYPE {mname} summary")
        for q, label in QUANTILES:
            key = f"p{int(q * 100)}_s"
            if key in t:
                lines.append(
                    f'{mname}{{quantile="{label}"}} {t[key]:g}')
        lines.append(f"{mname}_count {t.get('count', 0):g}")
        lines.append(f"{mname}_sum {t.get('total_s', 0.0):g}")
    return "\n".join(lines) + "\n"


def aggregate_snapshots(per_rank: Dict[int, dict]) -> Dict:
    """Roll ``{rank: snapshot}`` up into one gang view: counters summed,
    timers summed where sums are exact (count/total) and WORST-rank where
    they are not (p50/p99 — reservoir percentiles do not merge; the gang's
    slowest rank is the honest aggregate for an SLO eye). Gauges keep only
    a per-rank map (a summed gauge is meaningless)."""
    counters: Dict[str, float] = {}
    timers: Dict[str, dict] = {}
    for _rank, snap in sorted(per_rank.items()):
        for name, v in snap.get("counters", {}).items():
            counters[name] = counters.get(name, 0.0) + v
        for name, t in snap.get("timers", {}).items():
            if not t:
                continue
            row = timers.setdefault(name, {"count": 0, "total_s": 0.0,
                                           "worst_p50_s": 0.0,
                                           "worst_p99_s": 0.0})
            row["count"] += t.get("count", 0)
            row["total_s"] += t.get("total_s", 0.0)
            row["worst_p50_s"] = max(row["worst_p50_s"],
                                     t.get("p50_s") or 0.0)
            row["worst_p99_s"] = max(row["worst_p99_s"],
                                     t.get("p99_s") or 0.0)
    for row in timers.values():
        if row["count"]:
            row["mean_s"] = row["total_s"] / row["count"]
    return {"num_ranks": len(per_rank), "counters": counters,
            "timers": timers,
            "gauges_by_rank": {r: s.get("gauges", {})
                               for r, s in sorted(per_rank.items())}}


class MetricsExporter:
    """Pull exporter for one process's metrics registry (module
    docstring). ``port=0`` binds an ephemeral port (read it back from
    ``self.port``); ``gang`` optionally supplies the ``/gang`` view."""

    def __init__(self, metrics=None, *, host: str = "127.0.0.1",
                 port: int = 0, rank: Optional[int] = None,
                 gang: Optional[Callable[[], Optional[Dict[int, dict]]]]
                 = None):
        if metrics is None:
            from harp_tpu_torch.utils.metrics import DEFAULT as metrics
        import os

        self.metrics = metrics
        self.rank = (int(os.environ.get("HARP_PROCESS_ID", "0"))
                     if rank is None else rank)
        self.gang = gang
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):        # scrapes must not spam stderr
                pass

            def do_GET(self):
                try:
                    body, ctype = exporter._render(self.path)
                except (KeyError, TypeError, ValueError,
                        RuntimeError) as e:
                    # a malformed registry entry or gang= source costs
                    # one scrape a 500, never the serving thread
                    self.send_error(500, str(e))
                    return
                if body is None:
                    self.send_error(404, "unknown path (serve /metrics, "
                                         "/snapshot, /gang)")
                    return
                data = body.encode()
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.host, self.port = self._server.server_address[:2]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name=f"harp-metrics-exporter-{self.port}")
        self._thread.start()
        # close() may race itself (atexit on the main thread, an owner on
        # another): the lock makes shutdown() run exactly once
        self._close_lock = threading.Lock()
        self._closed = False
        atexit.register(self.close)

    @property
    def address(self):
        return (self.host, self.port)

    def _render(self, path: str):
        path = path.split("?", 1)[0]
        if path == "/metrics":
            return prometheus_text(self.metrics.snapshot()), \
                "text/plain; version=0.0.4"
        if path == "/snapshot":
            snap = self.metrics.snapshot()
            snap["rank"] = self.rank
            snap["ts"] = round(time.time(), 3)
            return json.dumps(snap), "application/json"
        if path == "/gang":
            per_rank = self.gang() if self.gang is not None else None
            if not per_rank:
                return None, ""
            return json.dumps(
                {"aggregated": aggregate_snapshots(per_rank),
                 "ranks": {str(r): s for r, s in sorted(per_rank.items())},
                 "ts": round(time.time(), 3)}), "application/json"
        return None, ""

    def close(self) -> None:
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(5.0)
        atexit.unregister(self.close)

    def __enter__(self) -> "MetricsExporter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
