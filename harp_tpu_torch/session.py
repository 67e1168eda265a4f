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
from typing import Any, Callable

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
        return torch.as_tensor(array).to(device=self.device, dtype=dtype)

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
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self.workers.process_group:
            import torch.distributed as dist

            dist.barrier()
