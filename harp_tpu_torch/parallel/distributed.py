"""Process-group bootstrap and the host transport between processes.

Port of ``harp_tpu/parallel/distributed.py``. Reference parity: Harp's YARN
gang allocation and HDFS rendezvous files; the JAX package joins a
``jax.distributed`` coordinator. Here every process of the gang calls
:func:`initialize`, which joins a ``torch.distributed`` process group with
the **gloo** backend at ``tcp://HARP_COORDINATOR`` and blocks until the gang
is complete. The gang environment is the one ``parallel/launch.py`` writes,
with the JAX launcher's names: ``HARP_COORDINATOR`` (host:port of process
0), ``HARP_NUM_PROCESSES`` and ``HARP_PROCESS_ID``.

Fail-stop semantics match the reference: a missing process keeps
initialization blocked until the timeout, and a process that dies takes the
gang down (a collective with a dead peer raises, and the launcher kills the
survivors when any process exits non-zero).

Gloo is the control plane and the plain transport: :func:`gather_rows`,
:func:`rotate_rows` and :func:`permute_rows` move a process's stacked rows
to the others, and :func:`barrier` waits for every process. They run on CPU
tensors; a CUDA tensor is staged through the host (copied to the CPU,
moved, copied back). NCCL is not used: it refuses several ranks on one
device. The device path between processes is the ring-DMA kernels
(``ops/ring_dma.py``).
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

log = logging.getLogger("harp_tpu_torch.distributed")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               initialization_timeout_s: float = 1800.0) -> None:
    """Join the gang. A no-op for a single process (nothing given, no gang
    environment) and when this process has already joined.

    The 1800 s default timeout mirrors Harp's DATA_MAX_WAIT_TIME
    (io/Constant.java:36); it also bounds every later gloo operation."""
    if dist.is_initialized():
        return
    coordinator_address = (coordinator_address
                           or os.environ.get("HARP_COORDINATOR"))
    if num_processes is None and "HARP_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["HARP_NUM_PROCESSES"])
    if process_id is None and "HARP_PROCESS_ID" in os.environ:
        process_id = int(os.environ["HARP_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError(
            f"joining a gang needs the coordinator address, the process "
            f"count and this process's id (got {coordinator_address!r}, "
            f"{num_processes!r}, {process_id!r})")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=initialization_timeout_s))
    log.info("joined gang at %s: process %d/%d", coordinator_address,
             process_id, num_processes)


def shutdown() -> None:
    """Leave the gang (CollectiveMapper teardown :783-788): close the
    ring-DMA workspace (every process closes the peers' mappings before any
    owner frees its region), then destroy the process group."""
    if not dist.is_initialized():
        return
    from harp_tpu_torch.ops import ring_dma

    ring_dma.close_workspace()
    dist.barrier()
    dist.destroy_process_group()


def is_initialized() -> bool:
    return dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


# --------------------------------------------------------------------------- #
# Host transport (gloo)
# --------------------------------------------------------------------------- #

def _row_bytes(x: torch.Tensor) -> torch.Tensor:
    """``x`` (rows, ...) as a CPU uint8 tensor (rows, bytes a row)."""
    x = x.detach().contiguous()
    return x.reshape(x.shape[0], -1).view(torch.uint8).cpu()


def _from_row_bytes(b: torch.Tensor, like: torch.Tensor,
                    rows: int) -> torch.Tensor:
    return b.view(like.dtype).reshape((rows,) + tuple(like.shape[1:])).to(
        like.device)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every process's ``x`` (same shape everywhere), concatenated along
    axis 0 in process order, on ``x``'s device: a gloo all-gather of the
    raw bytes, so any dtype comes back bitwise."""
    n = dist.get_world_size()
    xb = _row_bytes(x)
    parts = [torch.empty_like(xb) for _ in range(n)]
    dist.all_gather(parts, xb)
    return _from_row_bytes(torch.cat(parts), x, n * x.shape[0])


def rotate_rows(x: torch.Tensor, steps: int, group) -> torch.Tensor:
    """Ring shift of a process group's stacked rows: row r (worker g =
    first_worker + r) receives the row of worker (g - steps) mod W."""
    w = group.num_workers
    return permute_rows(x, [(g, (g + steps) % w) for g in range(w)], group)


def permute_rows(x: torch.Tensor, pairs, group) -> torch.Tensor:
    """Move a process group's stacked rows along (source, dest) worker
    pairs: the row of worker ``dest`` receives the row of worker
    ``source``; a worker that is no pair's dest gets zeros. Every process
    passes the same pairs, each source and dest at most once. Rows whose
    partner is in this process are copied; the others go through one gloo
    ``batch_isend_irecv`` (tag: the receiving worker's id)."""
    wl, base = group.workers_per_process, group.first_worker
    xb = _row_bytes(x)
    out = torch.zeros_like(xb)
    ops = []
    for src, dst in pairs:
        mine_src, mine_dst = base <= src < base + wl, base <= dst < base + wl
        if mine_src and mine_dst:
            out[dst - base] = xb[src - base]
        elif mine_src:
            ops.append(dist.P2POp(dist.isend, xb[src - base], dst // wl,
                                  tag=dst))
        elif mine_dst:
            ops.append(dist.P2POp(dist.irecv, out[dst - base], src // wl,
                                  tag=dst))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return _from_row_bytes(out, x, wl)


def barrier(device=None) -> None:
    """Wait for ``device`` (a CUDA sync), then for every process of the
    gang (a gloo barrier)."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    dist.barrier()
