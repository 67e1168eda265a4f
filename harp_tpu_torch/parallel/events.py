"""Event queue: Harp's asynchronous event API, on the host.

Port of ``harp_tpu/parallel/events.py``. Reference parity: ``Event``/
``EventQueue``/``SyncClient`` (client/Event.java, io/EventQueue.java:28,
client/SyncClient.java:33; CollectiveMapper getEvent:623, waitEvent:632,
sendEvent:645) with the event types LOCAL, MESSAGE and COLLECTIVE.

Events are a host control plane: the device work is bulk-synchronous, so
LOCAL events are an in-process queue, and COLLECTIVE events between
processes ride a broadcast on the gang's gloo group
(``parallel/distributed.py``) at iteration boundaries (a single process
delivers them locally). MESSAGE events are point-to-point when a transport
(an object with ``send(dest, payload)``) is wired into the
:class:`EventClient`; the port has none yet (the P2P transport is a later
port item), so without one a message between processes takes the broadcast
path, a collective call. Device-side point-to-point data movement is
``collectives.lax_ops.send_recv``.
"""

from __future__ import annotations

import dataclasses
import enum
import pickle
import queue
import time
from typing import Any, Optional


class EventType(enum.Enum):
    LOCAL = "local"
    MESSAGE = "message"          # point-to-point, host control plane
    COLLECTIVE = "collective"    # delivered to every worker


@dataclasses.dataclass
class Event:
    type: EventType
    source: int
    payload: Any
    timestamp: float = dataclasses.field(default_factory=time.time)


class EventQueue:
    """Per-process event rendezvous (io/EventQueue.java:28 semantics)."""

    def __init__(self):
        self._q: "queue.Queue[Event]" = queue.Queue()

    def put(self, event: Event) -> None:
        self._q.put(event)

    def get(self) -> Optional[Event]:
        """Non-blocking poll (CollectiveMapper.getEvent:623)."""
        try:
            return self._q.get_nowait()
        except queue.Empty:
            return None

    def wait(self, timeout: Optional[float] = None) -> Optional[Event]:
        """Blocking wait (CollectiveMapper.waitEvent:632; Harp's default wait
        was DATA_MAX_WAIT_TIME=1800 s, Constant.java:36)."""
        try:
            return self._q.get(timeout=timeout if timeout is not None else 1800.0)
        except queue.Empty:
            return None

    def __len__(self) -> int:
        return self._q.qsize()


def _broadcast_payload(payload: Any, source: int) -> Any:
    """Broadcast a picklable payload from process ``source`` to every
    process of the gloo group: the length first, then the pickled bytes as
    a uint8 tensor (the wire role of Harp's Writable encode/decode,
    resource/Writable.java:30). Every process must call it."""
    import torch
    import torch.distributed as dist

    is_source = dist.get_rank() == source
    data = (torch.frombuffer(bytearray(pickle.dumps(payload)), dtype=torch.uint8)
            if is_source else torch.zeros(0, dtype=torch.uint8))
    n = torch.tensor([data.numel()], dtype=torch.int64)
    dist.broadcast(n, src=source)
    buf = data if is_source else torch.empty(int(n[0]), dtype=torch.uint8)
    dist.broadcast(buf, src=source)
    return pickle.loads(buf.numpy().tobytes())


class EventClient:
    """Send side (SyncClient.java:33). In a single process events go
    straight to the local queue; across processes they are broadcast on the
    gloo group, or, with a ``transport``, sent point to point by it."""

    def __init__(self, event_queue: EventQueue, worker_id: int = 0,
                 transport=None):
        self.queue = event_queue
        self.worker_id = worker_id
        self.transport = transport

    def send_local(self, payload: Any) -> None:
        self.queue.put(Event(EventType.LOCAL, self.worker_id, payload))

    def send_collective(self, payload: Any, source: Optional[int] = None
                        ) -> None:
        """CollectiveMapper.sendEvent:645 with COLLECTIVE type.

        Across processes this is a collective call: EVERY process must call
        it (with the same ``source``, default 0) or the broadcast
        deadlocks; only the source's payload is delivered. In a single
        process the local payload is enqueued, with this worker as source.
        """
        from harp_tpu_torch.parallel import distributed

        src = 0 if source is None else source
        if distributed.process_count() > 1:
            payload = _broadcast_payload(payload, src)
        else:
            src = self.worker_id
        self.queue.put(Event(EventType.COLLECTIVE, src, payload))

    def send_message(self, dest: int, payload: Any,
                     source: Optional[int] = None) -> None:
        """Point-to-point host message, delivered only on ``dest``.

        With a ``transport``: only the sender transmits (``source=None``
        means this process; a gang-wide call passes ``source=`` and the
        other callers return), and delivery into ``dest``'s queue is the
        transport's.

        Without one, across processes the send is collective like
        :meth:`send_collective` (every process calls with the same
        ``source``; processes other than ``dest`` drop the payload): a
        whole-gang sync per message. In a single process it is delivered
        iff ``dest`` is this worker.
        """
        if self.transport is not None:
            if source is not None and source != self.worker_id:
                return               # gang-wide call pattern: not us
            self.transport.send(dest, payload)
            return
        from harp_tpu_torch.parallel import distributed

        src = 0 if source is None else source
        if distributed.process_count() > 1:
            payload = _broadcast_payload(payload, src)
            if distributed.process_index() != dest:
                return
        else:
            src = self.worker_id
            if dest != self.worker_id:
                return
        self.queue.put(Event(EventType.MESSAGE, src, payload))
