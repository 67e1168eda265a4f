"""The port's host event plane against the JAX package's, on the CPU.

The same script of ``send_local``, ``send_collective`` and ``send_message``
goes through ``harp_tpu.parallel.events`` and ``harp_tpu_torch.parallel.
events`` and must deliver the same (type, source, payload) sequence; the
session API (``open_events``, ``get_event``, ``wait_event``, ``send_event``,
``close_events``) must behave as the JAX session's in one process, and
refuse a point-to-point ``send_event`` across processes until the P2P
transport is ported. The gloo broadcast of a payload runs here in a
one-process group; across processes it runs in the gangs of
``tests/test_torch_ring_dma.py`` (``parallel/mp_smoke.py``,
``event_telemetry_checks``).
"""

import datetime
import queue as queue_lib
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from harp_tpu.parallel import events as jev
from harp_tpu.session import HarpSession as JaxSession
from harp_tpu_torch.parallel import distributed as tdist
from harp_tpu_torch.parallel import events as tev
from harp_tpu_torch.session import HarpSession as TorchSession


def _script(mod, worker_id):
    """One script of sends; returns what the queue delivers, in order."""
    q = mod.EventQueue()
    client = mod.EventClient(q, worker_id=worker_id)
    client.send_local({"x": 1})
    client.send_collective("sync-point")
    client.send_collective(("from", 3), source=3)
    client.send_message(worker_id, "to-self")
    client.send_message(worker_id + 1, "dropped")   # not this worker
    client.send_message(worker_id, [1, 2], source=5)
    client.send_local(np.arange(3))
    n = len(q)
    out = []
    while True:
        ev = q.get()
        if ev is None:
            break
        payload = ev.payload
        if isinstance(payload, np.ndarray):
            payload = payload.tolist()
        out.append((ev.type.value, ev.source, payload))
    return n, out


@pytest.mark.parametrize("worker_id", [0, 2])
def test_send_script_delivers_what_jax_delivers(worker_id):
    assert _script(tev, worker_id) == _script(jev, worker_id)
    n, out = _script(tev, worker_id)
    assert n == 6 and [o[0] for o in out] == [
        "local", "collective", "collective", "message", "message", "local"]


def test_event_types_and_fields_match_jax():
    assert [t.value for t in tev.EventType] == [t.value for t in jev.EventType]
    tf = [f.name for f in tev.Event.__dataclass_fields__.values()]
    jf = [f.name for f in jev.Event.__dataclass_fields__.values()]
    assert tf == jf


@pytest.mark.parametrize("mod", [jev, tev], ids=["jax", "torch"])
def test_queue_wait_defaults_to_1800_s_and_times_out(mod, monkeypatch):
    q = mod.EventQueue()
    assert q.wait(timeout=0.01) is None and q.get() is None and len(q) == 0
    seen = []

    def get(self, block=True, timeout=None):
        seen.append(timeout)
        raise queue_lib.Empty

    monkeypatch.setattr(queue_lib.Queue, "get", get)
    assert q.wait() is None
    assert seen == [1800.0]


class _Transport:
    def __init__(self):
        self.sent = []

    def send(self, dest, payload):
        self.sent.append((dest, payload))


@pytest.mark.parametrize("source", [None, 1, 2])
def test_send_message_through_a_transport_matches_jax(source):
    got = []
    for mod in (jev, tev):
        t = _Transport()
        q = mod.EventQueue()
        mod.EventClient(q, worker_id=1, transport=t).send_message(
            3, "hello", source=source)
        got.append((t.sent, len(q)))
    assert got[0] == got[1]
    assert got[1][0] == ([] if source == 2 else [(3, "hello")])


# --------------------------------------------------------------------------- #
# The session API
# --------------------------------------------------------------------------- #

def _session_script(sess, mod_events):
    out = [sess.get_event()]                    # before open: a pure peek
    sess.send_event({"k": 1})                   # collective -> local queue
    ev = sess.get_event()
    out.append((ev.type.value, ev.source, ev.payload))
    sess.send_event("mine", dest=0)             # dest == this process
    ev = sess.wait_event(timeout=5.0)
    out.append((ev.type.value, ev.source, ev.payload))
    sess.send_event("again", source=4)          # one process: source is us
    ev = sess.get_event()
    out.append((ev.type.value, ev.source, ev.payload))
    with pytest.raises(ValueError, match="process rank") as e:
        sess.send_event("not-mine", dest=3)     # rank out of range: loud
    out.append(str(e.value))
    q = sess.open_events()[0]
    assert sess.open_events()[0] is q           # idempotent
    sess.send_event("left behind")
    sess.close_events()
    out.append(sess.get_event())                # closed plane: a pure peek
    out.append(sess.wait_event(timeout=0.01))   # a new generation: empty
    assert sess.open_events()[0] is not q
    sess.close_events()
    out.append(sess.get_event())
    return out


def test_session_events_single_process_match_jax():
    got = _session_script(TorchSession(num_workers=4, device="cpu"), tev)
    want = _session_script(JaxSession(num_workers=4), jev)
    assert got == want
    assert got[1] == ("collective", 0, {"k": 1})
    assert got[2] == ("message", 0, "mine")


def test_session_open_events_has_no_transport_yet():
    sess = TorchSession(device="cpu")
    q, client, transport = sess.open_events()
    assert isinstance(q, tev.EventQueue) and transport is None
    assert client.worker_id == 0 and client.queue is q
    sess.close_events()


def test_session_dest_across_processes_raises_until_p2p(monkeypatch):
    """With more than one process a point-to-point send_event would need
    the P2P transport: it raises, naming the queue item, and never takes
    the collective fallback (no broadcast is attempted)."""
    sess = TorchSession(device="cpu")
    monkeypatch.setattr(tdist, "process_count", lambda: 4)
    monkeypatch.setattr(tev, "_broadcast_payload", lambda *a: pytest.fail(
        "the collective fallback was taken"))
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        sess.send_event("hi", dest=1)
    with pytest.raises(ValueError, match=r"process rank in \[0, 4\)"):
        sess.send_event("hi", dest=4)
    assert sess.get_event() is None
    sess.close_events()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture()
def one_process_group():
    assert not dist.is_initialized()
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{_free_port()}", world_size=1,
        rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_broadcast_payload_round_trips_on_gloo(one_process_group):
    payload = {"tag": "x", "arr": np.arange(5.0), "t": (1, "two"),
               "big": bytes(range(256)) * 300}
    got = tev._broadcast_payload(payload, 0)
    assert got["tag"] == "x" and got["t"] == (1, "two")
    assert got["big"] == payload["big"]
    np.testing.assert_array_equal(got["arr"], payload["arr"])
    assert tev._broadcast_payload(torch.arange(4), 0).tolist() == [0, 1, 2, 3]
