"""Comm-volume accounting, priced from a table of per-step collective bytes.

Port of ``harp_tpu/telemetry/comm_ledger.py``. The JAX package prices steps
from its pinned collective-budget manifest (``tools/collective_budget.json``,
the collectives of each traced step program, their kinds and operand bytes).
The port keeps its own copy of the rows :func:`manifest_target` can resolve,
``collective_budget.json`` beside this module, so it prices the same steps
at the same figures without the JAX package's tools: the K-means variants
and their quantized twins, ``lda_cgs``, ``lda_cgs_subblock128``,
``sgd_mf_dense``, ``sgd_mf_dense_int8``, ``als_explicit``, ``nn_mlp`` and
``pagerank``.

What the figures mean on the port: each row is the program's REFERENCE
collective volume at the JAX package's traced shapes (K-means rescaled to
the job's table by ``KMeans.comm_scale``), not bytes the port's transport
moved. On one card the stacked worker group moves nothing between devices,
and in a process group the gloo and CUDA IPC paths move what they move;
neither is measured here.

The rows are traced at small shapes; a job at other shapes passes ``scale``
= (its per-step collective payload elements) / (the traced shape's). For
K-means that ratio is exact for the dominant payload (the padded stat
table, ``KMeans.comm_scale``). Models that compute no scale (lda, sgd_mf,
als, nn) get TRACED-SHAPE pricing: a fixed per-step reference volume. The
distinction is machine-readable: ``exact=False`` ledgers publish
``comm.<target>.pricing_exact = 0`` and every step event carries
``wire_pricing: "traced_shape"``.

Gauges published into the metrics registry::

    comm.<target>.pricing_exact          1 scaled, 0 traced-shape pricing
    comm.<target>.wire_bytes_per_step    priced bytes per step
    comm.<target>.cumulative_gb          bytes_per_step x steps / 1e9
    comm.<target>.busbw_gbps             priced bytes / wall seconds (when the
                                         boundary passes wall_s)
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

MANIFEST_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "collective_budget.json")

_manifest_cache: Dict[str, dict] = {}


def load_manifest(path: Optional[str] = None) -> dict:
    """The price table (cached per path); ``{}`` targets when the file is
    absent or unreadable: the ledger then prices nothing rather than stop
    a training run."""
    p = path or MANIFEST_PATH
    if p not in _manifest_cache:
        try:
            with open(p) as f:
                _manifest_cache[p] = json.load(f)
        except (OSError, json.JSONDecodeError):
            _manifest_cache[p] = {"targets": {}}
    return _manifest_cache[p]


def manifest_target(model: str, *, comm: Optional[str] = None,
                    quant: Optional[str] = None,
                    sub_block: bool = False,
                    manifest_path: Optional[str] = None) -> Optional[str]:
    """Resolve a model config to its price row's name.

    A quantized path resolves to its quantized twin where the table has one
    (``kmeans_allreduce_int8``), and else to the float32 row (the counts
    still hold; the byte price is then an upper bound). None when no row
    matches: the ledger stays inert.
    """
    targets = load_manifest(manifest_path).get("targets", {})
    base = {
        "kmeans": f"kmeans_{comm}" if comm else None,
        "lda": "lda_cgs_subblock128" if sub_block else "lda_cgs",
        "sgd_mf": "sgd_mf_dense",
        "als": "als_explicit",
        "nn": "nn_mlp",
        "pagerank": "pagerank",
    }.get(model)
    if base is None:
        return None
    if quant:
        suffixed = f"{base}_{quant}"
        if suffixed in targets:
            return suffixed
    return base if base in targets else None


class CommLedger:
    """Step counter joined with one price row."""

    def __init__(self, target: Optional[str], *, scale: float = 1.0,
                 exact: bool = False,
                 manifest_path: Optional[str] = None, metrics=None):
        if metrics is None:
            from harp_tpu_torch.utils.metrics import DEFAULT as metrics
        self.metrics = metrics
        self.target = target
        self.steps = 0
        self.wall_s = 0.0
        self.scale = scale
        # exact=True ONLY when the caller computed a real payload scale for
        # its shapes (KMeans.comm_scale at the traced worker count)
        self.exact = exact
        row = (load_manifest(manifest_path).get("targets", {}).get(target)
               if target else None)
        self.bytes_per_step: Optional[float] = (
            row["bytes_per_step"] * scale
            if row and "bytes_per_step" in row else None)
        self.bytes_by_kind: Dict[str, float] = (
            {k: v * scale for k, v in row.get("bytes_by_kind", {}).items()}
            if row else {})

    @property
    def cumulative_bytes(self) -> float:
        return (self.bytes_per_step or 0.0) * self.steps

    def on_steps(self, n: int, wall_s: Optional[float] = None) -> None:
        """Advance the counter by ``n`` steps (``wall_s``: the chunk's wall,
        for the busbw gauge). Inert when no row matched."""
        if self.bytes_per_step is None or n <= 0:
            return
        self.steps += n
        if wall_s:
            self.wall_s += wall_s
        pfx = f"comm.{self.target}"
        self.metrics.gauge(f"{pfx}.pricing_exact", 1.0 if self.exact else 0.0)
        self.metrics.gauge(f"{pfx}.wire_bytes_per_step", self.bytes_per_step)
        self.metrics.gauge(f"{pfx}.cumulative_gb",
                           self.cumulative_bytes / 1e9)
        if self.wall_s > 0:
            self.metrics.gauge(f"{pfx}.busbw_gbps",
                               self.cumulative_bytes / self.wall_s / 1e9)

    def snapshot(self) -> dict:
        return {"target": self.target, "steps": self.steps,
                "scale": self.scale, "exact": self.exact,
                "bytes_per_step": self.bytes_per_step,
                "cumulative_bytes": self.cumulative_bytes,
                "bytes_by_kind": self.bytes_by_kind}


def ledger_for(model: str, *, comm: Optional[str] = None,
               quant: Optional[str] = None, sub_block: bool = False,
               scale: Optional[float] = None, exact: Optional[bool] = None,
               metrics=None) -> Optional[CommLedger]:
    """A ledger for the model's row, or None when telemetry is off (the
    models' fast path stays one check) or no row matches. ``scale=None``:
    the caller computed no payload scale, so the row is traced-shape
    pricing. A scale claims exact pricing unless ``exact=False`` overrides
    (K-means away from the traced worker count passes its element ratio
    with ``exact=False``: the sharded variants' operands also depend on
    the worker count)."""
    from harp_tpu_torch.telemetry import step_log

    log = step_log.active()
    if log is None:
        return None
    target = manifest_target(model, comm=comm, quant=quant,
                             sub_block=sub_block)
    if target is None:
        return None
    if exact is None:
        exact = scale is not None
    return CommLedger(target, scale=1.0 if scale is None else scale,
                      exact=exact,
                      metrics=metrics if metrics is not None else log.metrics)
