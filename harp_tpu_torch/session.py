"""HarpSession — the primary user entry point.

Port of ``harp_tpu/session.py``. A session owns a stacked worker group on one
device. The user writes a plain SPMD function that calls the collective API,
and ``session.spmd`` returns a callable that binds the group and calls the
function eagerly (no tracing, no compilation): sharded arguments arrive as
stacked ``(W, rows/W, ...)`` views, replicated ones as they are.

The session runs on CUDA unless the caller passes ``device="cpu"``; with no
device named and no CUDA present it raises rather than carry on on the CPU.

``HarpSession(num_workers=W, distributed=True)`` binds a process group
(``parallel/distributed.py``; every process of the gang builds the same
session): each of the P processes holds ``W / P`` workers stacked, sharded
arguments arrive as this process's rows ``(W/P, rows/W, ...)``, sharded
results are this process's piece of the global layout, and the collectives
reach the other processes. Several processes may share one card.

The event API (``open_events``, ``get_event``, ``wait_event``,
``send_event``, ``close_events``; ``parallel/events.py``) is the host
control plane, addressed by process rank. Across processes a point-to-point
``send_event(dest=...)`` waits for the P2P transport (ROADMAP.md queue 1
item 5) and raises; collective events work in every mode.

Typical usage::

    sess = HarpSession(num_workers=4)

    def step(points, centroids):             # points: (W, N/W, D)
        local = Table.local(partial_stats(points, centroids),
                            num_workers=sess.num_workers)
        return table_ops.aggregate(local).trim()   # regroup + allgather

    new_cen = sess.spmd(step, in_specs=(sess.shard(), sess.replicate()),
                        out_specs=sess.replicate())(points, centroids)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from harp_tpu_torch.parallel import mesh as mesh_lib


@dataclasses.dataclass(frozen=True)
class Shard:
    """Spec: split over the workers along ``axis`` (stacked inside spmd)."""

    axis: int = 0


@dataclasses.dataclass(frozen=True)
class Replicate:
    """Spec: one value every worker holds (passed through as it is)."""


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another; with none named, a missing CUDA is an error."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run on the CPU "
            "explicitly")
    return device


class HarpSession:
    """Owns the stacked worker group and runs SPMD map-collective functions."""

    def __init__(self, num_workers: int = 1, device=None, name: str = "harp",
                 distributed: bool = False):
        self.name = name
        nproc, rank = 1, 0
        if distributed:
            from harp_tpu_torch.parallel import distributed as dist_lib

            dist_lib.initialize()           # joins from the gang environment
            if not dist_lib.is_initialized():
                raise RuntimeError(
                    "distributed=True needs a process group: call "
                    "parallel.distributed.initialize() or run under "
                    "python -m harp_tpu_torch.parallel.launch")
            nproc, rank = dist_lib.process_count(), dist_lib.process_index()
        self.workers = mesh_lib.WorkerGroup(
            num_workers, resolve_device(device), nproc, rank)

    @property
    def num_workers(self) -> int:
        return self.workers.num_workers

    @property
    def master_id(self) -> int:
        return self.workers.master_id

    @property
    def device(self) -> torch.device:
        return self.workers.device

    @property
    def workers_per_process(self) -> int:
        return self.workers.workers_per_process

    # -- specs -------------------------------------------------------------
    def shard(self, axis: int = 0) -> Shard:
        return Shard(axis)

    def replicate(self) -> Replicate:
        return Replicate()

    # -- data placement ----------------------------------------------------
    def _put(self, array, dtype=None) -> torch.Tensor:
        if isinstance(array, np.ndarray):
            array = torch.from_numpy(np.ascontiguousarray(array))
        array = torch.as_tensor(array)
        # from pinned host memory the copy is asynchronous on the current
        # stream (io/pipeline.DevicePrefetcher waits for it); from pageable
        # memory non_blocking changes nothing
        return array.to(device=self.device, dtype=dtype,
                        non_blocking=array.is_pinned())

    def scatter(self, array, axis: int = 0, dtype=None) -> torch.Tensor:
        """Place a host array on the device for sharding along ``axis`` (its
        global layout; ``spmd`` views it stacked). The axis must divide
        evenly over the workers. In a process group only this process's
        rows are placed."""
        n = array.shape[axis]
        if n % self.num_workers:
            raise ValueError(
                f"axis {axis} of length {n} must divide over "
                f"{self.num_workers} workers (pad first)")
        g = self.workers
        if g.process_group:
            per = n // self.num_workers
            idx = [slice(None)] * array.ndim
            idx[axis] = slice(g.first_worker * per,
                              (g.first_worker + g.workers_per_process) * per)
            array = array[tuple(idx)]
        return self._put(array, dtype).contiguous()

    def replicate_put(self, array, dtype=None) -> torch.Tensor:
        return self._put(array, dtype)

    # -- SPMD --------------------------------------------------------------
    def _stack(self, x: torch.Tensor, spec) -> torch.Tensor:
        if isinstance(spec, Replicate):
            return x
        w = self.workers_per_process
        if x.shape[spec.axis] % w:
            raise ValueError(
                f"sharded argument axis {spec.axis} of length "
                f"{x.shape[spec.axis]} does not divide over {w} workers")
        return x.unflatten(spec.axis, (w, -1)).movedim(spec.axis, 0)

    def _unstack(self, y: torch.Tensor, spec) -> torch.Tensor:
        if isinstance(spec, Replicate):
            return y
        if y.shape[0] != self.workers_per_process:
            raise ValueError(
                f"a sharded output must be stacked over "
                f"{self.workers_per_process} workers, got shape "
                f"{tuple(y.shape)}")
        return y.movedim(0, spec.axis).flatten(spec.axis, spec.axis + 1)

    def spmd(self, fn: Callable, *, in_specs: Any, out_specs: Any) -> Callable:
        """Wrap ``fn`` as an SPMD program over the stacked worker group.

        ``in_specs`` holds one spec per positional argument; ``out_specs``
        is one spec or a tuple matching a tuple result. Sharded arguments
        are viewed stacked ``(W, rows/W, ...)``; sharded results are
        un-stacked back to their global layout."""
        in_specs = tuple(in_specs)

        def call(*args):
            if len(args) != len(in_specs):
                raise TypeError(f"expected {len(in_specs)} arguments, got "
                                f"{len(args)}")
            stacked = [self._stack(a, s) for a, s in zip(args, in_specs)]
            with mesh_lib.bind(self.workers):
                out = fn(*stacked)
            if isinstance(out_specs, (tuple, list)):
                return tuple(self._unstack(o, s)
                             for o, s in zip(out, out_specs))
            return self._unstack(out, out_specs)

        return call

    def run(self, fn: Callable, *args, in_specs: Any, out_specs: Any):
        """One-shot: wrap and invoke."""
        return self.spmd(fn, in_specs=in_specs, out_specs=out_specs)(*args)

    def barrier(self) -> None:
        """Wait for the device, and in a process group for every process
        (a gloo barrier after the device sync)."""
        self.workers.barrier()

    # -- events (Harp: CollectiveMapper.getEvent:623/waitEvent:632/sendEvent:645)
    # Addressed by PROCESS rank (distributed.process_index), the host control
    # plane, not by worker row.

    def open_events(self):
        """Bring up the event plane (idempotent): ``(queue, client,
        transport)``. The port has no P2P transport yet, so ``transport``
        is None. Each open after :meth:`close_events` is a new generation:
        a fresh queue."""
        if not hasattr(self, "_events"):
            from harp_tpu_torch.parallel import distributed
            from harp_tpu_torch.parallel import events as ev

            queue = ev.EventQueue()
            self._events = (queue, ev.EventClient(
                queue, worker_id=distributed.process_index()), None)
        return self._events

    def get_event(self):
        """Non-blocking event poll (CollectiveMapper.getEvent:623). Returns
        None when the plane has not been opened."""
        if not hasattr(self, "_events"):
            return None
        return self._events[0].get()

    def wait_event(self, timeout: Optional[float] = None):
        """Blocking event wait (CollectiveMapper.waitEvent:632); opens the
        event plane."""
        return self.open_events()[0].wait(timeout)

    def send_event(self, payload, dest: Optional[int] = None,
                   source: Optional[int] = None) -> None:
        """CollectiveMapper.sendEvent:645: ``dest=None`` delivers to every
        process (COLLECTIVE: all processes must call, with the same
        ``source``); a concrete ``dest`` is a point-to-point MESSAGE to that
        process rank. With one process it is delivered iff ``dest`` is 0.

        Across processes the JAX package sends a MESSAGE by its P2P
        transport, a call the sender makes alone. The port has no such
        transport yet (ROADMAP.md queue 1 item 5, ``parallel/p2p.py``), and
        the transportless fallback is a collective call with another
        calling convention, so ``dest=`` raises NotImplementedError there.

        Ordering: all events share one queue; match on ``Event.type`` and
        ``source`` rather than on arrival order."""
        from harp_tpu_torch.parallel import distributed

        nproc = distributed.process_count()
        if dest is not None and not (0 <= dest < nproc):
            raise ValueError(
                f"dest must be a process rank in [0, {nproc}) "
                f"— events are the host control plane, addressed per "
                f"PROCESS, not per device-level worker; got {dest}")
        if dest is not None and nproc > 1:
            raise NotImplementedError(
                "send_event(dest=...) across processes needs the P2P "
                "transport (parallel/p2p.py), not ported yet: ROADMAP.md "
                "queue 1 item 5. Use dest=None (a collective event) or "
                "EventClient.send_message, a collective call")
        client = self.open_events()[1]
        if dest is None:
            client.send_collective(payload, source=source)
        else:
            client.send_message(dest, payload, source=source)

    def close_events(self) -> None:
        """Tear down the event plane (CollectiveMapper teardown :783-788).
        A later open_events/send_event/wait_event starts a new generation."""
        if hasattr(self, "_events"):
            del self._events
