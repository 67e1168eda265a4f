"""StaticScheduler: per-task private queues (pinned work).

Port of ``harp_tpu/sched/static.py``. Reference parity:
``schstatic/StaticScheduler`` (schstatic/StaticScheduler.java:29): unlike
DynamicScheduler's shared deque, each task thread owns a private input
queue, and a submission names its task. Harp used it where work had to stay
on one thread, most importantly the dymoro ``Rotator``
(dymoro/Rotator.java:30), whose background thread owned the rotate
communication. Here it is for pinned host work, e.g. one IO thread per data
shard writing into a fixed staging buffer.
"""

from __future__ import annotations

import queue
import threading
from typing import Generic, List, Optional, TypeVar

from harp_tpu_torch.sched.dynamic import Task

I = TypeVar("I")
O = TypeVar("O")


class StaticScheduler(Generic[I, O]):
    def __init__(self, tasks: List[Task[I, O]]):
        self._tasks = tasks
        self._ins: List["queue.Queue[Optional[I]]"] = [queue.Queue() for _ in tasks]
        self._outs: List["queue.Queue[O]"] = [queue.Queue() for _ in tasks]
        self._threads: List[threading.Thread] = []
        self._running = False

    def start(self) -> None:
        if self._running:
            return
        self._running = True
        for i, t in enumerate(self._tasks):
            th = threading.Thread(target=self._monitor, args=(i, t), daemon=True)
            th.start()
            self._threads.append(th)

    def _monitor(self, idx: int, task: Task[I, O]) -> None:
        while True:
            item = self._ins[idx].get()
            if item is None:
                return
            self._outs[idx].put(task.run(item))

    def submit(self, task_id: int, item: I) -> None:
        """Submit to a SPECIFIC task (Harp: Submitter targets task i)."""
        self._ins[task_id].put(item)

    def wait_for_output(self, task_id: int) -> O:
        return self._outs[task_id].get()

    def stop(self) -> None:
        if not self._running:
            return
        for q in self._ins:
            q.put(None)
        for th in self._threads:
            th.join()
        self._threads.clear()
        self._running = False
