"""Worker group — the stacked replacement for Harp's worker membership layer.

Port of ``harp_tpu/parallel/mesh.py`` (``WorkerGroup``, ``fetch``). Reference
parity: ``worker/Workers`` (worker/Workers.java:33) derived selfID, masterID
(= min ID) and the ring neighbour from a ``nodes`` file.

Here the W workers of a group live on ONE device as a *stacked* group: a
sharded array is one tensor with a leading worker axis ``(W, rows/W, ...)``
and a replicated array is held once. Collectives are exact tensor ops over
that axis (``collectives/lax_ops.py``). ``HarpSession.spmd`` binds the group
for the duration of a call, so ``lax_ops.worker_id``/``num_workers`` can read
it the way the JAX package reads its mesh axis.

A *process group* (the JAX package's gang of P processes, each with
``devices_per_process`` devices) splits the W workers over P processes
(``parallel/distributed.py``): each process holds a stacked group of its
``workers_per_process`` workers, worker ``rank * workers_per_process + r``
in row r, and the collectives reach the other processes' rows.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional

import numpy as np
import torch

WORKERS = "workers"  # the Harp worker axis: partitions distribute over it

_BOUND: contextvars.ContextVar = contextvars.ContextVar(
    "harp_tpu_torch_worker_group", default=None)


@dataclasses.dataclass(frozen=True)
class WorkerGroup:
    """Static membership of a worker group — Harp's ``Workers``: W workers,
    this process's ``workers_per_process`` of them stacked on ``device``."""

    num_workers: int
    device: torch.device
    num_processes: int = 1
    rank: int = 0

    def __post_init__(self):
        if self.num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {self.num_workers}")
        if self.num_processes < 1 or self.num_workers % self.num_processes:
            raise ValueError(
                f"{self.num_workers} workers do not divide over "
                f"{self.num_processes} processes")
        if not 0 <= self.rank < self.num_processes:
            raise ValueError(f"rank {self.rank} outside 0.."
                             f"{self.num_processes - 1}")

    @property
    def master_id(self) -> int:
        return 0  # Harp: min worker ID is master (Workers.java)

    @property
    def process_group(self) -> bool:
        """True when the workers span several processes."""
        return self.num_processes > 1

    @property
    def workers_per_process(self) -> int:
        return self.num_workers // self.num_processes

    @property
    def first_worker(self) -> int:
        """Global ID of this process's row 0."""
        return self.rank * self.workers_per_process

    def global_shape(self, x) -> tuple:
        """The global shape of ``x``, sharded along axis 0 over the workers
        (in a process group ``x`` is this process's piece)."""
        return ((x.shape[0] * self.num_workers // self.workers_per_process,)
                + tuple(x.shape[1:]))

    def barrier(self) -> None:
        """Wait for the device; in a process group also for every process
        (``distributed.barrier``: a gloo barrier after the device sync)."""
        if self.process_group:
            from harp_tpu_torch.parallel import distributed

            distributed.barrier(self.device)
        elif self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


@contextlib.contextmanager
def bind(group: WorkerGroup):
    """Make ``group`` the current worker group inside the ``with`` block."""
    token = _BOUND.set(group)
    try:
        yield group
    finally:
        _BOUND.reset(token)


def current_group() -> WorkerGroup:
    """The worker group bound by the enclosing ``HarpSession.spmd`` call."""
    group = _BOUND.get()
    if group is None:
        raise RuntimeError(
            "no worker group is bound: collectives run inside a function "
            "called through HarpSession.spmd / HarpSession.run")
    return group


def stacked_rows(num_workers: int) -> int:
    """Rows of a stacked per-worker tensor of a ``num_workers`` group in
    this process: its ``workers_per_process`` inside a bound process group
    of that size, else ``num_workers``."""
    group = _BOUND.get()
    if group is not None and group.num_workers == num_workers:
        return group.workers_per_process
    return num_workers


def fetch(x, group: Optional[WorkerGroup] = None) -> np.ndarray:
    """Copy a tensor to a host ndarray (bf16 comes back as float32, numpy
    has no bf16). With a process ``group``, ``x`` is this process's piece of
    an array sharded along axis 0, and the pieces of every process are
    gathered along it (the JAX package's ``process_allgather``)."""
    if isinstance(x, np.ndarray):
        return x
    x = x.detach()
    if group is not None and group.process_group:
        from harp_tpu_torch.parallel import distributed

        x = distributed.gather_rows(x)
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.cpu().numpy()
