"""Gang telemetry: per-step structured events, comm-volume accounting,
straggler detection, on-demand profiler windows and a pull exporter.

Port of ``harp_tpu/telemetry``. One rule holds throughout: telemetry adds no
work on the card and no synchronization with it. Every hook sits at a host
chunk boundary where the fits ALREADY fetch their losses to the host, and
takes host floats only.

* :mod:`~harp_tpu_torch.telemetry.step_log`: per-step events in a bounded
  ring, flushed as JSONL to ``<dir>/rank<r>/steps.jsonl``.
  ``record_chunk`` is the one call the models make; it is one ``None``
  check when telemetry is off.
* :mod:`~harp_tpu_torch.telemetry.comm_ledger`: the collective volume of a
  step, priced from the port's copy of the JAX package's per-step table
  (the reference volume at the traced shapes, not bytes the port moved):
  bytes a step, cumulative GB and busbw as gauges.
* :mod:`~harp_tpu_torch.telemetry.gang`: the ranks' ``Metrics.snapshot()``
  exchanged over the session's event plane, and a straggler report.
* :mod:`~harp_tpu_torch.telemetry.xprof`: a collective event or a trigger
  file opens a ``torch.profiler`` window over the next N chunk boundaries,
  into a directory a rank.
* :mod:`~harp_tpu_torch.telemetry.exporter`: ``/metrics`` (Prometheus
  text), ``/snapshot`` and ``/gang`` over stdlib HTTP on 127.0.0.1.

Not ported yet: ``telemetry/watchdog.py`` (the SLO watchdog, the CLI's
``--slo-*`` flags) and ``telemetry/spans.py`` (request spans of the serving
path); ROADMAP.md queue 1 lists them.

Enable with ``python -m harp_tpu_torch.run ... --telemetry-dir DIR
[--telemetry-interval N] [--metrics-port P]`` or with :func:`configure`; the
``HARP_TELEMETRY_DIR`` and ``HARP_TELEMETRY_INTERVAL`` environment
variables do the same for embedded callers (gang members inherit them from
the launcher).
"""

from __future__ import annotations

from harp_tpu_torch.telemetry.comm_ledger import (CommLedger, ledger_for,
                                                  load_manifest,
                                                  manifest_target)
from harp_tpu_torch.telemetry.exporter import (MetricsExporter,
                                               aggregate_snapshots,
                                               prometheus_text)
from harp_tpu_torch.telemetry.gang import (GangCollector, gather_snapshots,
                                           publish_straggler_report,
                                           read_straggler_report,
                                           straggler_report,
                                           write_straggler_report)
from harp_tpu_torch.telemetry.step_log import (StepLog, active, configure,
                                               disable, phase, record_chunk,
                                               record_timing)
from harp_tpu_torch.telemetry.xprof import XprofController, request_xprof

__all__ = [
    "CommLedger", "GangCollector", "MetricsExporter", "StepLog",
    "XprofController", "active", "aggregate_snapshots", "configure",
    "disable", "gather_snapshots", "ledger_for", "load_manifest",
    "manifest_target", "phase", "prometheus_text",
    "publish_straggler_report", "read_straggler_report", "record_chunk",
    "record_timing", "request_xprof", "straggler_report",
    "write_straggler_report",
]
