"""Local gang launcher: P processes of one command on this host.

Port of ``harp_tpu/parallel/launch.py`` (``launch``, ``main``), the
reference's ``depl/`` + ``Driver`` surface (one JVM a worker;
collective/Driver.java:93 startAllWorkers:203). Here::

    python -m harp_tpu_torch.parallel.launch --nproc P \
        [--workers-per-process W_local] [--timeout S] -- <command...>

starts the command P times with the gang environment of the JAX launcher
(``gang_env``): ``HARP_COORDINATOR=localhost:<port>``,
``HARP_NUM_PROCESSES=P``, ``HARP_PROCESS_ID=<i>``, plus
``HARP_WORKERS_PER_PROCESS``. The command joins through
``parallel.distributed.initialize()`` (``HarpSession(distributed=True)``
does it). The children are fresh processes (``subprocess``, fork then
exec), so none inherits a CUDA context. Their output is drained on threads
and printed per process at the end.

Fail-stop, as in the reference: the moment one process exits non-zero, the
others are killed, and the launcher exits non-zero. The nodes-file and ssh
part of the JAX launcher is not ported yet (one host only).
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import threading
import time
from typing import List, Optional, Tuple


class GangResult(list):
    """Per-process ``(returncode, combined output)`` in rank order, plus the
    process seen failing first (``(rank, returncode)`` or None)."""

    def __init__(self, items, first_failure: Optional[Tuple[int, int]] = None):
        super().__init__(items)
        self.first_failure = first_failure

    @property
    def ok(self) -> bool:
        return all(rc == 0 for rc, _ in self)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def gang_env(nproc: int, process_id: int, port: int,
             workers_per_process: int = 1) -> dict:
    return {
        "HARP_COORDINATOR": f"localhost:{port}",
        "HARP_NUM_PROCESSES": str(nproc),
        "HARP_PROCESS_ID": str(process_id),
        "HARP_WORKERS_PER_PROCESS": str(workers_per_process),
    }


def _drain(proc: subprocess.Popen, sink: List[str]) -> None:
    # a thread a process, so a chatty member never blocks on a full pipe
    for line in proc.stdout:
        sink.append(line)
    proc.stdout.close()


def launch(nproc: int, command: List[str], workers_per_process: int = 1,
           timeout: Optional[float] = 1800.0, cwd: Optional[str] = None,
           extra_env: Optional[dict] = None) -> GangResult:
    """Run ``command`` ``nproc`` times with the gang environment and wait
    for all. Fail-stop: when a process exits non-zero the rest are killed.
    On timeout every process is killed and ``subprocess.TimeoutExpired``
    carries the partial output."""
    if nproc < 1:
        raise ValueError(f"nproc must be >= 1, got {nproc}")
    port = _free_port()
    procs = [subprocess.Popen(
        command, cwd=cwd, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        env={**os.environ, **gang_env(nproc, i, port, workers_per_process),
             **(extra_env or {})})
        for i in range(nproc)]
    sinks: List[List[str]] = [[] for _ in procs]
    drains = [threading.Thread(target=_drain, args=(p, s), daemon=True)
              for p, s in zip(procs, sinks)]
    for t in drains:
        t.start()
    deadline = None if timeout is None else time.monotonic() + timeout
    first_failure = None
    try:
        pending = set(range(nproc))
        while pending:
            for i in sorted(pending):
                rc = procs[i].poll()
                if rc is None:
                    continue
                pending.discard(i)
                if rc != 0:
                    if first_failure is None:
                        first_failure = (i, rc)
                    for j in pending:
                        procs[j].kill()
            if (pending and deadline is not None
                    and time.monotonic() > deadline):
                for j in pending:
                    procs[j].kill()
                for t in drains:
                    t.join(timeout=10.0)
                raise subprocess.TimeoutExpired(
                    command, timeout, output="".join(
                        f"--- process {i} (partial) ---\n{''.join(s)}"
                        for i, s in enumerate(sinks)))
            if pending:
                time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for t in drains:
            t.join(timeout=10.0)
    return GangResult([(p.returncode, "".join(s))
                       for p, s in zip(procs, sinks)], first_failure)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m harp_tpu_torch.parallel.launch",
        description="Run a command as a gang of processes on this host.")
    p.add_argument("--nproc", type=int, required=True)
    p.add_argument("--workers-per-process", type=int, default=1)
    p.add_argument("--timeout", type=float, default=1800.0)
    p.add_argument("command", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    command = args.command[1:] if args.command[:1] == ["--"] else args.command
    if not command:
        p.error("no command given (use -- <command...>)")
    results = launch(args.nproc, command, args.workers_per_process,
                     timeout=args.timeout)
    for i, (rc, out) in enumerate(results):
        print(f"--- process {i} rc={rc} ---")
        print(out, end="" if out.endswith("\n") else "\n")
    if results.first_failure is not None:
        print(f"process {results.first_failure[0]} failed first (exit "
              f"{results.first_failure[1]})", file=sys.stderr)
    return 0 if results.ok else 1


if __name__ == "__main__":
    sys.exit(main())
