"""On-demand profiler windows: profile a slow gang without restarting it.

Port of ``harp_tpu/telemetry/xprof.py``. A control-plane event
(``events.send_collective``; Harp's CollectiveMapper.sendEvent:645) arms
every rank to capture a profiler trace over the next N chunk boundaries
into a per-rank directory. The window is ``utils/tracing.start_trace``/
``stop_trace``: a ``torch.profiler`` Chrome trace with the card's kernels
when CUDA is there. Start and stop happen only at chunk boundaries; the
profiler observes the fit and changes none of its work.

Two trigger paths:

* **embedded**: ranks call :func:`request_xprof` at a boundary. The request
  is a COLLECTIVE host event: every rank calls it together, only the
  source's payload is delivered.
* **operator**: the controller also polls a trigger FILE at every boundary,
  ``<telemetry-dir>/xprof_request.json`` holding ``{"steps": N}`` (and
  optionally ``"dir"``). Write the file while the job runs and every rank
  opens a window at its next boundary. A window's start and stop are local
  (no collective), so ranks that see the file one boundary apart simply
  open their windows one boundary apart. Each rank consumes a file content
  once (mtime and size); rewrite the file to re-arm. A file already there
  when the controller starts is ignored, and a malformed file is reported
  on stderr, never fatal.

The training side installs an :class:`XprofController` as a StepLog
boundary hook (``run.py`` does when telemetry is on).
"""

from __future__ import annotations

import json
import os
import sys
from typing import Optional

XPROF_TAG = "harp.telemetry.xprof"


def request_xprof(session, steps: int, directory: str, *,
                  source: int = 0) -> None:
    """Arm an N-boundary profiler window on every rank (COLLECTIVE: all
    ranks call together; the ``source`` rank's payload wins). The window
    opens at each rank's next chunk boundary."""
    session.send_event({"tag": XPROF_TAG, "steps": int(steps),
                        "dir": directory}, source=source)


class XprofController:
    """Boundary hook driving the per-rank profiler window.

    Polls the session's event queue at every boundary; on a request, starts
    the profiler into ``<dir>/rank<r>/`` and stops it after the requested
    number of boundaries. Other events go back on the queue untouched. One
    window at a time: a request arriving mid-window is dropped with a note
    (re-arm after the window closes).
    """

    def __init__(self, session, rank: Optional[int] = None,
                 trigger_path: Optional[str] = None,
                 default_dir: Optional[str] = None):
        self.session = session
        self.rank = (int(os.environ.get("HARP_PROCESS_ID", "0"))
                     if rank is None else rank)
        self.remaining = 0
        self.trace_dir: Optional[str] = None
        self.trace_path: Optional[str] = None
        self.trigger_path = trigger_path
        self.default_dir = default_dir
        self._consumed_token = None
        if trigger_path:
            # a trigger file left by an earlier run must not open a window
            # at boundary 1 of this one: only writes after startup arm
            try:
                st = os.stat(trigger_path)
                self._consumed_token = (st.st_mtime_ns, st.st_size)
            except OSError:
                pass

    def _poll_request(self) -> Optional[dict]:
        requeue = []
        found = None
        while True:
            ev = self.session.get_event()
            if ev is None:
                break
            payload = ev.payload
            if (isinstance(payload, dict)
                    and payload.get("tag") == XPROF_TAG and found is None):
                found = payload
            else:
                requeue.append(ev)
        if requeue:
            queue = self.session.open_events()[0]
            for ev in requeue:
                queue.put(ev)
        if found is None:
            found = self._poll_trigger_file()
        return found

    def _poll_trigger_file(self) -> Optional[dict]:
        """The operator path (module docstring). Malformed content is
        reported once per write, never fatal."""
        if not self.trigger_path:
            return None
        try:
            st = os.stat(self.trigger_path)
        except OSError:
            return None
        token = (st.st_mtime_ns, st.st_size)
        if token == self._consumed_token:
            return None
        self._consumed_token = token
        try:
            with open(self.trigger_path) as f:
                req = json.load(f)
            steps = int(req["steps"])
        except (OSError, ValueError, KeyError, TypeError) as e:
            print(f"harp_tpu_torch.telemetry: bad xprof trigger file "
                  f"{self.trigger_path}: {e}", file=sys.stderr, flush=True)
            return None
        out = req.get("dir") or self.default_dir
        if not out:
            print("harp_tpu_torch.telemetry: xprof trigger file has no "
                  "'dir' and no default directory is configured",
                  file=sys.stderr, flush=True)
            return None
        return {"tag": XPROF_TAG, "steps": steps, "dir": out}

    def _start(self, req: dict) -> None:
        from harp_tpu_torch.utils import tracing

        self.trace_dir = os.path.join(req["dir"], f"rank{self.rank}")
        os.makedirs(self.trace_dir, exist_ok=True)
        tracing.start_trace(self.trace_dir)
        self.remaining = max(1, int(req["steps"]))
        print(f"harp_tpu_torch.telemetry: xprof window open (rank "
              f"{self.rank}, {self.remaining} boundaries) -> "
              f"{self.trace_dir}", file=sys.stderr, flush=True)

    def _stop(self) -> None:
        from harp_tpu_torch.utils import tracing

        self.trace_path = tracing.stop_trace()
        print(f"harp_tpu_torch.telemetry: xprof window closed (rank "
              f"{self.rank}) -> {self.trace_path}", file=sys.stderr,
              flush=True)
        self.remaining = 0

    @property
    def tracing(self) -> bool:
        return self.remaining > 0

    def __call__(self, boundary_index: int, log=None) -> None:
        """Tick one chunk boundary (StepLog boundary-hook signature)."""
        if self.tracing:
            self.remaining -= 1
            if self.remaining == 0:
                self._stop()
        req = self._poll_request()
        if req is not None:
            if self.tracing:
                print("harp_tpu_torch.telemetry: xprof request ignored — a "
                      "window is already open (re-arm after it closes)",
                      file=sys.stderr, flush=True)
            else:
                self._start(req)

    def close(self) -> None:
        """End of job: a window left open past the last boundary is closed
        so its trace is written."""
        if self.tracing:
            self._stop()
