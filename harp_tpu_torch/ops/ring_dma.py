"""Fused ring DMA — one copy engine behind every fused ring schedule.

Port of ``harp_tpu/ops/ring_dma.py``. On the TPU a worker is a chip and the
engine issues the neighbour copy from inside a kernel
(``make_async_remote_copy``) after a credit-exact receiver-ready handshake.
Here a worker is a row of a process's stacked group (``parallel/mesh.py``):

* :func:`hop` — one whole-payload ring hop: the block of worker
  ``(id - shift) mod W``, bitwise for every dtype (exactly
  ``lax_ops.rotate``); :func:`hop_tree` hops every leaf of a tree;
* :func:`ring_allgather` — every worker's block, tiled in worker order
  (bitwise ``lax_ops.allgather``), by the ring relay.

On a CUDA tensor each launches its hand-written kernel (``csrc/ring_dma.cu``
on the device functions of ``csrc/ring_dma.cuh``): on a stacked group one
launch copies every row to its neighbour's row, stream order standing in for
the handshake; on a process group (several processes on one card) the
kernel writes a block owned by another process straight into that process's
*symmetric workspace*, mapped here through CUDA IPC, after the handshake,
and the receiver copies it out of its receive slot. On a CPU tensor each
runs its plain version (:func:`hop_plain`, :func:`ring_allgather_plain`):
the unfused ``lax_ops.rotate`` and ``lax_ops.allgather`` (``torch.roll`` and a
copy on a stacked group, gloo between processes). There is no fallback from
the kernel to the plain version and no switch that turns the kernel off.

The workspace (:class:`_Workspace`): each process ``cudaMalloc``s one region
(not from PyTorch's caching allocator: an IPC handle names the base of a
``cudaMalloc``) holding a header of 64-bit counters for each collective id
(ready credits and arrivals a row, the allgather's arrivals a step) and a
data area (a hop's receive slots, an allgather's chunk slots). The processes
swap handles with gloo ``all_gather_object`` and each opens every peer's
region once. It grows, on every process at the same call (SPMD order gives
every process the same sizes), while all devices are idle; the counters carry
over. :func:`close_workspace` (called by ``distributed.shutdown``) closes
the peers' mappings on every process before any owner frees its region.

Collective ids: every distinct fused collective has its own counters.
``COLLECTIVE_IDS`` holds the static ones (the allgather's; the JAX package's
ids of the in-kernel ring hops join it with those hops); each :func:`hop` call draws a
fresh id (:func:`_next_hop_id`), the same on every process because every
process makes the same calls in the same order. The host counts the calls
and arrivals of each id, so the kernel knows what count each wait expects.

A kernel whose peer never comes gives up after about 10 s and writes an
error word; :func:`check_errors` syncs the device, reads it and raises.
``launches`` counts kernel launches: each wrapper adds one where it launches
its kernel and nowhere else.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Dict, Optional

import torch

from harp_tpu_torch.collectives import lax_ops
from harp_tpu_torch.parallel import mesh as mesh_lib

launches: Dict[str, int] = {"ring_dma_hop": 0, "ring_allgather": 0}

# Static collective-ID registry (the JAX package's ids): each logical fused
# collective gets a stable id, the same on every worker.
COLLECTIVE_IDS = {"allgather": 2}

# Dynamic ids for hop() calls, clear of the static registry; more than 240
# hops in flight at once would alias, far beyond any schedule.
_HOP_ID_BASE = 16
_HOP_ID_SPAN = 240
_hop_id_counter = [0]

# counter fields of one collective id in a workspace header (ring_dma.cuh)
_MAX_ROWS = 8
_MAX_STEPS = 32
_READY, _ARRIVE, _AG = 0, _MAX_ROWS, 2 * _MAX_ROWS
_ALIGN = 256


def _next_hop_id() -> int:
    hid = _HOP_ID_BASE + (_hop_id_counter[0] % _HOP_ID_SPAN)
    _hop_id_counter[0] += 1
    return hid


def use_ring_dma(device) -> bool:
    """Whether the ring-DMA kernels serve tensors on ``device``: a CUDA
    device. There is no opt-out."""
    return torch.device(device).type == "cuda"


def _round_up(n: int, k: int) -> int:
    return -(-n // k) * k


# --------------------------------------------------------------------------- #
# Plain versions
# --------------------------------------------------------------------------- #

def hop_plain(x: torch.Tensor, shift: int = 1,
              group: Optional[mesh_lib.WorkerGroup] = None) -> torch.Tensor:
    """The hop in plain PyTorch: ``lax_ops.rotate`` on ``group`` (by
    default the bound one)."""
    with mesh_lib.bind(group or mesh_lib.current_group()):
        return lax_ops.rotate(x, shift)


def ring_allgather_plain(x: torch.Tensor,
                         group: Optional[mesh_lib.WorkerGroup] = None
                         ) -> torch.Tensor:
    """The allgather in plain PyTorch: the unfused ``lax_ops.allgather``
    on ``group`` (by default the bound one)."""
    with mesh_lib.bind(group or mesh_lib.current_group()):
        return lax_ops.allgather(x)


# --------------------------------------------------------------------------- #
# The kernels' library and the symmetric workspace
# --------------------------------------------------------------------------- #

_vp = ctypes.c_void_p


class _HopPlan(ctypes.Structure):
    _fields_ = [(name, _vp * _MAX_ROWS) for name in (
        "credit_to", "arrive_to", "my_ready", "my_arrive", "remote_dst",
        "my_slot")]


class _AgPlan(ctypes.Structure):
    _fields_ = [(name, _vp) for name in (
        "my_region", "right_region", "credit_to", "my_ready", "right_arrive",
        "my_arrive")]


_LIB: Dict[str, ctypes.CDLL] = {}


def _lib() -> ctypes.CDLL:
    lib = _LIB.get("ring_dma")
    if lib is None:
        from harp_tpu_torch.ops import _cuda_build

        lib = _cuda_build.library("ring_dma")
        i, ll, ull = ctypes.c_int, ctypes.c_longlong, ctypes.c_ulonglong
        pp = ctypes.POINTER(_vp)
        for name, args in {
                "ring_dma_grid": [i, ll, i, i],
                "ring_dma_alloc": [i, ll, pp, _vp],
                "ring_dma_open": [i, _vp, pp],
                "ring_dma_close": [i, _vp],
                "ring_dma_free": [i, _vp],
                "ring_dma_copy_header": [i, _vp, _vp],
                "ring_dma_error_word": [i, pp, pp],
                "ring_dma_free_error_word": [i, _vp],
                "ring_dma_hop_launch": [_vp, _vp, ll, i, i, i, i, i, _vp, i,
                                        ull, ull, _vp, i, _vp],
                "ring_dma_allgather_launch": [_vp, _vp, ll, ll, i, i, i, _vp,
                                              ull, ull, _vp, i, _vp]}.items():
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = i
        layout = (lib.ring_dma_max_rows(), lib.ring_dma_max_steps(),
                  lib.ring_dma_plan_bytes())
        if layout != (_MAX_ROWS, _MAX_STEPS, ctypes.sizeof(_HopPlan)):
            raise RuntimeError(f"ring_dma library layout {layout} does not "
                               f"match this module's")
        _LIB["ring_dma"] = lib
    return lib


def _ok(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"ring_dma: {what} failed: CUDA error {err}")


def _grid(lib, device: torch.device, nbytes: int, rows: int,
          group: mesh_lib.WorkerGroup) -> int:
    """Blocks a row of a launch: its share of what the card holds at once,
    split over the rows and over the processes sharing the card."""
    g = lib.ring_dma_grid(device.index or 0, nbytes, rows,
                          group.num_processes)
    if g < 1:
        raise RuntimeError(f"ring_dma grid query failed: CUDA error {-g}")
    return g


class _Workspace:
    """The symmetric workspace of a process group on one card."""

    def __init__(self, group: mesh_lib.WorkerGroup, device: torch.device):
        self.lib = _lib()
        self.dev = device.index or 0
        self.group = group
        self.header = self.lib.ring_dma_header_bytes()
        self.cpi = self.lib.ring_dma_counters_per_id()
        self.bases: Dict[int, int] = {}     # process -> region base here
        self.data_bytes = 0
        self.calls = collections.Counter()     # collective id -> calls
        self.arrivals = collections.Counter()  # collective id -> arrivals
        host, dev = _vp(), _vp()
        _ok(self.lib.ring_dma_error_word(self.dev, ctypes.byref(host),
                                         ctypes.byref(dev)), "error word")
        self.err_host, self.err_dev = host.value, dev.value

    def ensure(self, data_bytes: int) -> None:
        """Grow every process's region to hold ``data_bytes`` of data (a
        collective call: every process makes it with the same size)."""
        if data_bytes <= self.data_bytes:
            return
        size = _round_up(max(data_bytes, 2 * self.data_bytes), 1 << 21)
        import torch.distributed as dist

        torch.cuda.synchronize(self.dev)
        dist.barrier()          # no kernel touches an old region any more
        old = self.bases.get(self.group.rank)
        self._close_peers()
        dist.barrier()          # every old mapping is closed before a free
        base, handle = _vp(), ctypes.create_string_buffer(64)
        _ok(self.lib.ring_dma_alloc(self.dev, size, ctypes.byref(base),
                                    handle), "workspace cudaMalloc")
        if old is not None:
            _ok(self.lib.ring_dma_copy_header(self.dev, base.value, old),
                "workspace header copy")
            _ok(self.lib.ring_dma_free(self.dev, old), "workspace free")
        self.bases = {self.group.rank: base.value}
        handles = [None] * self.group.num_processes
        dist.all_gather_object(handles, handle.raw)
        for p, h in enumerate(handles):
            if p != self.group.rank:
                peer = _vp()
                _ok(self.lib.ring_dma_open(self.dev, h, ctypes.byref(peer)),
                    f"cudaIpcOpenMemHandle of process {p}'s workspace")
                self.bases[p] = peer.value
        self.data_bytes = size
        dist.barrier()          # every mapping is open before any kernel

    def _close_peers(self) -> None:
        for p, base in self.bases.items():
            if p != self.group.rank:
                _ok(self.lib.ring_dma_close(self.dev, base),
                    "cudaIpcCloseMemHandle")
        self.bases = {p: b for p, b in self.bases.items()
                      if p == self.group.rank}

    def close(self) -> None:
        import torch.distributed as dist

        torch.cuda.synchronize(self.dev)
        dist.barrier()
        self._close_peers()
        dist.barrier()          # every mapping is closed before any free
        for base in self.bases.values():
            _ok(self.lib.ring_dma_free(self.dev, base), "workspace free")
        _ok(self.lib.ring_dma_free_error_word(self.dev, self.err_host),
            "error word free")
        self.bases = {}
        self.data_bytes = 0

    def counter(self, proc: int, cid: int, field: int, idx: int) -> int:
        return self.bases[proc] + 8 * (cid * self.cpi + field + idx)

    def data(self, proc: int) -> int:
        return self.bases[proc] + self.header


_WS: Dict[str, _Workspace] = {}


def _workspace(group: mesh_lib.WorkerGroup, device: torch.device
               ) -> _Workspace:
    ws = _WS.get("ws")
    if ws is None:
        ws = _WS["ws"] = _Workspace(group, device)
    elif ws.group != group:
        # the host's per-id counts assume every call covers the same rows
        raise RuntimeError(f"ring_dma: the workspace serves {ws.group}; "
                           f"close it before a process uses another group")
    return ws


def close_workspace() -> None:
    """Close and free this process's workspace (a collective call)."""
    ws = _WS.pop("ws", None)
    if ws is not None:
        ws.close()


def check_errors() -> None:
    """Sync the device and raise if a ring-DMA kernel gave up waiting for a
    peer (the error word its timeout wrote)."""
    ws = _WS.get("ws")
    if ws is None:
        return
    torch.cuda.synchronize(ws.dev)
    word = ctypes.c_uint.from_address(ws.err_host).value
    if word:
        what = {1: "the receiver never entered the call (credit)",
                2: "the sender's payload never arrived"}.get(
                    word // 1000, "unknown")
        raise RuntimeError(f"ring_dma kernel timed out: {what}, collective "
                           f"id {word % 1000}")


# --------------------------------------------------------------------------- #
# The wrappers
# --------------------------------------------------------------------------- #

def _check(x: torch.Tensor, group: mesh_lib.WorkerGroup, op: str) -> None:
    rows = group.workers_per_process
    if x.dim() < 1 or x.shape[0] != rows:
        raise ValueError(f"{op} expects a stacked (rows={rows}, ...) "
                         f"per-worker tensor, got shape {tuple(x.shape)}")


def hop_cuda(x: torch.Tensor, shift: int = 1,
             group: Optional[mesh_lib.WorkerGroup] = None) -> torch.Tensor:
    """One ring hop on the card: one launch for all of this process's
    rows; on a process group, with the credit handshake and the receive
    slots of the symmetric workspace."""
    group = group or mesh_lib.current_group()
    _check(x, group, "hop")
    if not x.is_cuda:
        raise ValueError(f"hop_cuda needs a CUDA tensor, got {x.device}")
    lib = _lib()
    x = x.contiguous()
    out = torch.empty_like(x)
    rows = x.shape[0]
    nb = x.numel() // rows * x.element_size()
    if nb == 0:
        return out
    grid = _grid(lib, x.device, nb, rows, group)
    plan, remote, ready, arrive, err, cid = None, 0, 0, 0, None, 0
    if group.process_group:
        if rows > _MAX_ROWS:
            raise ValueError(f"a process holds at most {_MAX_ROWS} workers "
                             f"for the ring-DMA kernels, got {rows}")
        ws = _workspace(group, x.device)
        stride = _round_up(nb, _ALIGN)
        ws.ensure(rows * stride)
        cid = _next_hop_id()
        ws.calls[cid] += 1
        ws.arrivals[cid] += grid
        p = _HopPlan()
        base, w, me = group.first_worker, group.num_workers, group.rank
        for r in range(rows):
            g = base + r
            dp, dr = divmod((g + shift) % w, rows)
            sp, sr = divmod((g - shift) % w, rows)
            p.credit_to[r] = ws.counter(sp, cid, _READY, sr)
            p.arrive_to[r] = ws.counter(dp, cid, _ARRIVE, dr)
            p.my_ready[r] = ws.counter(me, cid, _READY, r)
            p.my_arrive[r] = ws.counter(me, cid, _ARRIVE, r)
            p.remote_dst[r] = ws.data(dp) + dr * stride
            p.my_slot[r] = ws.data(me) + r * stride
        plan, remote = ctypes.byref(p), 1
        ready, arrive, err = ws.calls[cid], ws.arrivals[cid], ws.err_dev
    with torch.cuda.device(x.device):
        e = lib.ring_dma_hop_launch(
            x.data_ptr(), out.data_ptr(), nb, rows, group.first_worker,
            group.num_workers, shift, grid, plan, remote, ready, arrive, err,
            cid, torch.cuda.current_stream(x.device).cuda_stream)
    _ok(e, "ring_dma hop launch")
    launches["ring_dma_hop"] += 1
    return out


def ring_allgather_cuda(x: torch.Tensor,
                        group: Optional[mesh_lib.WorkerGroup] = None
                        ) -> torch.Tensor:
    """The allgather on the card: one launch; on a process group the relay
    between processes through the workspace's chunk slots."""
    group = group or mesh_lib.current_group()
    _check(x, group, "ring_allgather")
    if not x.is_cuda:
        raise ValueError(f"ring_allgather_cuda needs a CUDA tensor, got "
                         f"{x.device}")
    lib = _lib()
    x = x.contiguous()
    out = torch.empty((group.num_workers,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    chunk = x.numel() * x.element_size()
    if chunk == 0:
        return out.flatten(0, 1)
    grid = _grid(lib, x.device, chunk, 1, group)
    n, me = group.num_processes, group.rank
    plan, stride, ready, arrive, err, cid = None, 0, 0, 0, None, 0
    if group.process_group:
        if n - 1 > _MAX_STEPS:
            raise ValueError(f"the relay takes at most {_MAX_STEPS + 1} "
                             f"processes, got {n}")
        ws = _workspace(group, x.device)
        stride = _round_up(chunk, _ALIGN)
        ws.ensure(n * stride)
        cid = COLLECTIVE_IDS["allgather"]
        ws.calls[cid] += 1
        ws.arrivals[cid] += grid
        right, left = (me + 1) % n, (me - 1) % n
        p = _AgPlan(ws.data(me), ws.data(right),
                    ws.counter(left, cid, _READY, 0),
                    ws.counter(me, cid, _READY, 0),
                    ws.counter(right, cid, _AG, 0),
                    ws.counter(me, cid, _AG, 0))
        plan = ctypes.byref(p)
        ready, arrive, err = ws.calls[cid], ws.arrivals[cid], ws.err_dev
    with torch.cuda.device(x.device):
        e = lib.ring_dma_allgather_launch(
            x.data_ptr(), out.data_ptr(), chunk, stride, n, me, grid, plan,
            ready, arrive, err, cid,
            torch.cuda.current_stream(x.device).cuda_stream)
    _ok(e, "ring_dma allgather launch")
    launches["ring_allgather"] += 1
    return out.flatten(0, 1)


def hop(x: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """One fused ring hop of the stacked rows ``x`` (W_local, ...): this
    worker's block moves to ``(id + shift)``; the result is the block of
    ``(id - shift)``, exactly ``lax_ops.rotate(x, shift)``, bitwise.

    The kernel on a CUDA tensor, the plain version on a CPU tensor. The
    JAX package's ``barrier`` switch is not taken: a stacked group never
    needs the handshake (stream order), a process group always does (its
    receive slots are reused from call to call)."""
    group = mesh_lib.current_group()
    _check(x, group, "hop")
    if x.device.type == "cuda":
        return hop_cuda(x, shift, group)
    if x.device.type == "cpu":
        return hop_plain(x, shift, group)
    raise ValueError(f"hop runs on cuda or cpu, not {x.device}")


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    raise TypeError(f"hop_tree takes tensors, tuples, lists and dicts, not "
                    f"{type(tree).__name__}")


def hop_tree(tree, shift: int = 1):
    """Hop every leaf of a tree (tensors in tuples, lists and dicts), float
    and int leaves alike: the engine is exact. Each leaf is its own call,
    with its own collective id and handshake."""
    return _tree_map(lambda leaf: hop(leaf, shift), tree)


def ring_allgather(x: torch.Tensor) -> torch.Tensor:
    """Fused ring allgather of the stacked blocks ``x`` (W_local, B, ...):
    every worker's block, tiled along axis 0 in worker order, held once,
    (W*B, ...): bitwise ``lax_ops.allgather``."""
    group = mesh_lib.current_group()
    _check(x, group, "ring_allgather")
    if x.dim() < 2:
        raise ValueError("ring_allgather needs at least one axis to tile")
    if group.num_workers == 1:
        return x.flatten(0, 1).clone()
    if x.device.type == "cuda":
        return ring_allgather_cuda(x, group)
    if x.device.type == "cpu":
        return ring_allgather_plain(x, group)
    raise ValueError(f"ring_allgather runs on cuda or cpu, not {x.device}")
