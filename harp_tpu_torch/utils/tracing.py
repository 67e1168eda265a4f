"""Profiler integration: ``torch.profiler`` traces in place of xprof.

Port of ``harp_tpu/utils/tracing.py``. ``trace(log_dir)`` captures a
``torch.profiler`` trace of the enclosed block (host activity, and the card's
kernels when CUDA is there) and writes it into ``log_dir`` as a Chrome trace
(``trace_<pid>_<n>.json``, viewable in Perfetto or TensorBoard);
``annotate(name)`` marks a named span on that timeline, as a context manager
or a decorator; ``device_memory_profile(path)`` writes the CUDA caching
allocator's snapshot.
"""

from __future__ import annotations

import contextlib
import os
import pickle
from typing import Optional

import torch

_ACTIVE: dict = {}
_COUNT = [0]


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a profiler trace of the enclosed block into ``log_dir``; the
    capture is closed and written also when the block raises."""
    start_trace(log_dir)
    try:
        yield
    finally:
        stop_trace()


def start_trace(log_dir: str) -> None:
    """Open a trace capture (the split form of :func:`trace`, for windows
    that span host loop boundaries). One capture at a time."""
    if _ACTIVE:
        raise RuntimeError(f"a trace into {_ACTIVE['dir']!r} is already open")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _ACTIVE.update(dir=log_dir, prof=prof)


def stop_trace() -> Optional[str]:
    """Close the capture opened by :func:`start_trace`; returns the path of
    the trace file written."""
    if not _ACTIVE:
        raise RuntimeError("no trace is open")
    prof, log_dir = _ACTIVE.pop("prof"), _ACTIVE.pop("dir")
    prof.stop()
    _COUNT[0] += 1
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{_COUNT[0]}.json")
    prof.export_chrome_trace(path)
    return path


def annotate(name: str):
    """Named span on the profiler timeline (usable as decorator/context)."""
    return torch.profiler.record_function(name)


def device_memory_profile(path: str) -> None:
    """Write the CUDA caching allocator's snapshot (a pickle of
    ``torch.cuda.memory._snapshot()``, readable by PyTorch's memory
    visualiser) to ``path``. Without CUDA there is no device allocator to
    profile, and it raises."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "device_memory_profile needs a CUDA device: the CPU has no "
            "device allocator to snapshot")
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(torch.cuda.memory._snapshot(), f)
