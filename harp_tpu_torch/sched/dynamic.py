"""DynamicScheduler: intra-worker task parallelism on the host.

Port of ``harp_tpu/sched/dynamic.py``. Reference parity:
``schdynamic/DynamicScheduler`` (schdynamic/DynamicScheduler.java:33): one
shared input deque, N task-monitor threads pulling work, an output queue,
and pause/start/stop semantics. Harp used it for multithreaded CPU compute
(e.g. K-means CenCalcTask) and multithreaded HDFS reads.

* **Device compute** needs no thread pool: what Harp split across Xeon
  threads is a batched call over a leading axis. :func:`device_map` gives
  that mapping for API parity (``torch.func.vmap`` or a stacked loop).
* **Host work** (file reads, parsing, feeding the card) still wants real
  threads: :class:`DynamicScheduler` keeps Harp's submit/start/pause/stop
  contract so input pipelines overlap with device steps. ctypes releases
  the interpreter lock during a foreign call, so native parses on the pool
  run at once.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Generic, Iterable, List, Optional, TypeVar

import torch

I = TypeVar("I")
O = TypeVar("O")


class _TaskError:
    """Envelope carrying a worker-thread exception to the consumer."""

    def __init__(self, error: BaseException):
        self.error = error


class Task(Generic[I, O]):
    """Harp's Task interface (schdynamic/Task.java:22: ``O run(I)``)."""

    def run(self, item: I) -> O:
        raise NotImplementedError


class DynamicScheduler(Generic[I, O]):
    """Shared-queue thread pool with Harp's lifecycle semantics.

    Each of the ``tasks`` (one per worker thread: in Harp each thread owned
    a Task instance with private scratch state) pulls from one shared input
    queue; results land in an output queue read by :meth:`wait_for_output`.

    ``out_capacity`` bounds the OUTPUT queue (0 = unbounded, the classic
    Harp contract). A bounded output queue is the backpressure seam of the
    streaming pipeline (io/pipeline.py): worker threads block in their
    result publish once ``out_capacity`` results wait, so a slow consumer
    caps parsed-but-unconsumed data at ``out_capacity`` items plus the one
    in-flight item per thread. With a bounded queue, :meth:`stop` and
    :meth:`pause` may discard unclaimed results (they must, to unblock
    workers stuck publishing into a full queue); streaming consumers stop
    only once the stream is drained.
    """

    def __init__(self, tasks: List[Task[I, O]], out_capacity: int = 0):
        self._tasks = tasks
        self._in: "queue.Queue[Optional[I]]" = queue.Queue()
        self._out: "queue.Queue[O]" = queue.Queue(maxsize=max(0, out_capacity))
        self._threads: List[threading.Thread] = []
        self._running = False
        self._submitted = 0

    # Harp: submit:86 -------------------------------------------------------
    def submit(self, item: I) -> None:
        self._submitted += 1
        self._in.put(item)

    def submit_all(self, items: Iterable[I]) -> None:
        for it in items:
            self.submit(it)

    # Harp: start:137 -------------------------------------------------------
    def start(self) -> None:
        if self._running:
            return
        self._running = True
        for t in self._tasks:
            th = threading.Thread(target=self._monitor, args=(t,), daemon=True)
            th.start()
            self._threads.append(th)

    def _monitor(self, task: Task[I, O]) -> None:
        while True:
            item = self._in.get()
            if item is None:  # poison pill = Harp's stop signal
                return
            try:
                out = task.run(item)
            except BaseException as e:          # noqa: BLE001
                # a failing task must still produce an output slot, or every
                # consumer counting on _submitted results blocks forever in
                # wait_for_output; the error is re-raised on the CALLER's
                # thread when its slot is claimed
                out = _TaskError(e)
            self._out.put(out)

    def has_output(self) -> bool:
        return self._submitted > 0

    def wait_for_output(self) -> O:
        """Block for one result (Harp: waitForOutput). Re-raises the task's
        exception if the claimed slot failed."""
        self._submitted -= 1
        out = self._out.get()
        if isinstance(out, _TaskError):
            raise out.error
        return out

    def drain(self) -> List[O]:
        return [self.wait_for_output() for _ in range(self._submitted)]

    def pause(self) -> None:
        """Stop workers after their current items; queued items stay (Harp
        pause). Pending items are moved to a holding list before the poison
        pills go in, so the pills reach the workers at once instead of
        behind the backlog; the backlog is then restored for the next
        start()."""
        held = self._drain_input()
        self._stop_threads()
        for item in held:
            self._in.put(item)

    def stop(self) -> None:
        """Stop workers and DISCARD queued items (Harp stop)."""
        self._drain_input()
        self._stop_threads()
        self._drain_input()
        # discarded items never produce output; completed-but-unclaimed
        # results remain claimable
        self._submitted = self._out.qsize()

    def _drain_input(self) -> List[I]:
        held: List[I] = []
        while True:
            try:
                item = self._in.get_nowait()
            except queue.Empty:
                return held
            if item is not None:
                held.append(item)

    def _stop_threads(self) -> None:
        if not self._running:
            return
        for _ in self._threads:
            self._in.put(None)
        bounded = self._out.maxsize > 0
        for th in self._threads:
            if not bounded:
                th.join()
                continue
            while True:
                th.join(timeout=0.05)
                if not th.is_alive():
                    break
                # bounded output: the worker may be blocked PUBLISHING a
                # result nobody will claim (stop/pause discard unclaimed
                # results in bounded mode by contract): make room so the
                # poison pill can reach it. Each discarded result releases
                # one submitted slot the consumer will never claim.
                try:
                    self._out.get_nowait()
                    self._submitted -= 1
                except queue.Empty:
                    pass
        self._threads.clear()
        self._running = False


def device_map(fn: Callable, items: torch.Tensor, *, batched: bool = True
               ) -> torch.Tensor:
    """The on-device successor of DynamicScheduler for compute tasks.

    Harp sliced work across Xeon threads; here the slicing is a leading
    batch axis of ``items``, mapped with ``torch.func.vmap`` (one batched
    call) or, with ``batched=False``, one call an item stacked along axis 0
    (the JAX package's ``lax.map``: sequential, for memory-bound bodies)."""
    if batched:
        return torch.func.vmap(fn)(items)
    return torch.stack([fn(x) for x in items])


class AsyncPipeline:
    """Single-producer helper: run host work (IO, preprocessing) ahead of
    the device loop, as Harp overlapped MTReader threads with compute."""

    def __init__(self, max_workers: int = 2):
        self._pool = ThreadPoolExecutor(max_workers=max_workers)

    def prefetch(self, fn: Callable[[], O]) -> Future:
        return self._pool.submit(fn)

    def close(self) -> None:
        self._pool.shutdown(wait=True)
