"""Fused ring DMA — one copy engine behind every fused ring schedule.

Port of ``harp_tpu/ops/ring_dma.py``. On the TPU a worker is a chip and the
engine issues the neighbour copy from inside a kernel
(``make_async_remote_copy``) after a credit-exact receiver-ready handshake.
Here a worker is a row of a process's stacked group (``parallel/mesh.py``):

* :func:`hop` — one whole-payload ring hop: the block of worker
  ``(id - shift) mod W``, bitwise for every dtype (exactly
  ``lax_ops.rotate``); :func:`hop_tree` hops every leaf of a tree;
* :func:`ring_allgather` — every worker's block, tiled in worker order
  (bitwise ``lax_ops.allgather``), by the ring relay;
* :class:`SendPlan` — the host side of a send made from inside another
  kernel (the ``ring_hop`` of ``pallas_kernels.dense_mf_hop`` and
  ``flash_attention``): the kernel stores its payload into the neighbour's
  row (or, in another process, its receive slot, after the credit) and
  signals; ``SendPlan.receive`` launches the receive kernel after the
  sending launch. It sends what the dense-MF hop left because the credit
  was not in yet (that kernel's blocks never wait), then waits for the
  sender and copies the slot out.

On a CUDA tensor each launches its hand-written kernel (``csrc/ring_dma.cu``
on the device functions of ``csrc/ring_dma.cuh``): on a stacked group one
launch copies every row to its neighbour's row, stream order standing in for
the handshake. That launch moves a few MiB in a few µs of device time, so
back-to-back calls run at the pace of the host's path to it, which is kept
short: the checks once a call, the raw handle of PyTorch's current stream
(no ``Stream`` object) and one ctypes call of a stacked entry with seven
pointer-sized arguments, which sizes the grid and makes the tensor's device
current (only when it is not) in C (``chip_smoke.py`` reads its host µs a
call). On a process group (several processes on one card) the kernel
writes a block owned by another process straight into that process's
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
``COLLECTIVE_IDS`` holds the static ones, the JAX package's (the
allgather's and the two in-kernel sends'); each :func:`hop` call draws a
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

launches: Dict[str, int] = {"ring_dma_hop": 0, "ring_allgather": 0,
                             "ring_recv": 0}

# Static collective-ID registry (the JAX package's ids): each logical fused
# collective gets a stable id, the same on every worker.
COLLECTIVE_IDS = {"allgather": 2, "flash_ring": 3, "dense_mf_ring": 4}

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
                # every argument pointer-sized: c_void_p converts an int
                # without building a ctypes object (c_int and c_longlong do)
                "ring_dma_hop_stacked": [_vp] * 7,
                "ring_dma_allgather_stacked": [_vp] * 5,
                "ring_dma_hop_launch": [_vp, _vp, ll, i, i, i, i, i, _vp, ull,
                                        ull, _vp, i, i, _vp],
                "ring_dma_allgather_launch": [_vp, _vp, ll, ll, i, i, i, _vp,
                                              ull, ull, _vp, i, i, _vp],
                "ring_dma_recv_launch": [i, i, i, i, _vp, _vp, ll, _vp, ll, ll,
                                         _vp, _vp, i, ll, ull, ull, _vp, i, i,
                                         _vp]}.items():
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


def _grid(lib, device: int, nbytes: int, rows: int,
          group: mesh_lib.WorkerGroup) -> int:
    """Blocks a row of a process group's launch: its share of what the card
    holds at once, split over the rows and over the processes sharing the
    card (a stacked entry sizes its own grid by the same rule)."""
    g = lib.ring_dma_grid(device, nbytes, rows, group.num_processes)
    if g < 1:
        raise RuntimeError(f"ring_dma grid query failed: CUDA error {-g}")
    return g


def _stream(device: int) -> int:
    """The raw handle of PyTorch's current stream on ``device``, read
    without building a ``torch.cuda.Stream`` (the call PyTorch's own Triton
    launchers make; a card test pins it to the public call's handle)."""
    return torch._C._cuda_getCurrentRawStream(device)


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
        self.plans: Dict[tuple, _HopPlan] = {}  # (cid, stride, shift) -> plan
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
        self.plans.clear()      # their pointers name the old regions
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
        self.plans.clear()
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


def _hop_plan(ws: _Workspace, group: mesh_lib.WorkerGroup, cid: int,
              stride: int, shift: int) -> _HopPlan:
    """The pointers of one hop call of ``shift`` for each of this process's
    rows: its sender's ready counter and its receiver's arrival counter and
    receive slot (``stride`` bytes a row), its own counters and slot. Built
    once a (collective id, stride, shift) and kept in ``ws.plans`` until
    the workspace grows or closes."""
    key = (cid, stride, shift)
    p = ws.plans.get(key)
    if p is None:
        p = ws.plans[key] = _new_hop_plan(ws, group, cid, stride, shift)
    return p


def _new_hop_plan(ws: _Workspace, group: mesh_lib.WorkerGroup, cid: int,
                  stride: int, shift: int) -> _HopPlan:
    p = _HopPlan()
    rows = group.workers_per_process
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
    return p


def _check_rows(rows: int) -> None:
    if rows > _MAX_ROWS:
        raise ValueError(f"a process holds at most {_MAX_ROWS} workers for "
                         f"the ring-DMA kernels, got {rows}")


class SendPlan:
    """One call of an in-kernel ring send of shift 1 (the ``ring_hop`` of
    ``pallas_kernels.dense_mf_hop`` and ``flash_attention``, collective id
    ``COLLECTIVE_IDS[name]``), whose launch sends ``row_bytes`` from each of
    this process's rows from ``blocks`` blocks a row (the same count on
    every process). A collective call: every process makes it. On a stacked
    group every neighbour is in the launch and stream order stands in for
    the handshake: no plan, no wait and no receive."""

    def __init__(self, group: mesh_lib.WorkerGroup, device: torch.device,
                 name: str, row_bytes: int, blocks: int):
        self.group, self.row_bytes = group, row_bytes
        self.plan = None
        if not group.process_group:
            return
        _check_rows(group.workers_per_process)
        ws = _workspace(group, device)
        stride = _round_up(row_bytes, _ALIGN)
        ws.ensure(group.workers_per_process * stride)
        self.cid = COLLECTIVE_IDS[name]
        ws.calls[self.cid] += 1
        ws.arrivals[self.cid] += blocks
        self.plan = _hop_plan(ws, group, self.cid, stride, 1)
        self.ready, self.arrive = ws.calls[self.cid], ws.arrivals[self.cid]
        self.err = ws.err_dev

    @property
    def args(self) -> tuple:
        """The trailing arguments of the sending kernel's launch function:
        (plan, remote, global id of row 0, workers, the count the credit
        wait expects, error word, collective id). The dense-MF hop, whose
        blocks never wait, takes the first five."""
        g = self.group
        if self.plan is None:
            return (None, 0, g.first_worker, g.num_workers, 0, None, 0)
        return (ctypes.byref(self.plan), 1, g.first_worker, g.num_workers,
                self.ready, self.err, self.cid)

    def receive(self, dst0: torch.Tensor, dst1: Optional[torch.Tensor] = None,
                off1: int = 0, left: Optional[torch.Tensor] = None,
                sent: Optional[torch.Tensor] = None,
                tile_bytes: int = 0) -> None:
        """Launch the receive on the current stream, after the sending
        launch, and count it in ``launches["ring_recv"]``. With ``sent``
        (rows, tiles) int32, first each row whose receiver is in another
        process waits for its credit and sends the tiles of ``tile_bytes``
        that the sending launch left in its row of ``left`` (sent 0). Then
        each row whose sender is in another process waits for the sender's
        blocks and copies its slot into row r of ``dst0`` (the slot's first
        ``dst0[r]`` bytes) and of ``dst1`` (from byte ``off1``). Nothing on
        a stacked group."""
        if self.plan is None:
            return
        lib, group = _lib(), self.group
        rows = group.workers_per_process
        b0 = dst0[0].numel() * dst0.element_size()
        b1 = 0 if dst1 is None else dst1[0].numel() * dst1.element_size()
        dev = dst0.get_device()
        grid = _grid(lib, dev, self.row_bytes, rows, group)
        e = lib.ring_dma_recv_launch(
            rows, group.first_worker, group.num_workers, grid,
            ctypes.byref(self.plan), dst0.data_ptr(), b0,
            None if dst1 is None else dst1.data_ptr(), b1, off1,
            None if left is None else left.data_ptr(),
            None if sent is None else sent.data_ptr(),
            0 if sent is None else sent.shape[1], tile_bytes,
            self.ready, self.arrive, self.err, self.cid, dev, _stream(dev))
        _ok(e, "ring_dma receive launch")
        launches["ring_recv"] += 1


def hop_cuda(x: torch.Tensor, shift: int = 1,
             group: Optional[mesh_lib.WorkerGroup] = None) -> torch.Tensor:
    """One ring hop on the card: one launch for all of this process's
    rows; on a process group, with the credit handshake and the receive
    slots of the symmetric workspace."""
    group = group or mesh_lib.current_group()
    _check(x, group, "hop")
    if not x.is_cuda:
        raise ValueError(f"hop_cuda needs a CUDA tensor, got {x.device}")
    return _hop_cuda(x, shift, group)


def _hop_cuda(x: torch.Tensor, shift: int,
              group: mesh_lib.WorkerGroup) -> torch.Tensor:
    """:func:`hop_cuda` of a CUDA ``x`` that passed ``_check``."""
    lib = _lib()
    x = x.contiguous()
    out = torch.empty_like(x)
    rows = x.shape[0]
    nb = x.numel() // rows * x.element_size()
    if nb == 0:
        return out
    dev = x.get_device()
    if not group.process_group:
        e = lib.ring_dma_hop_stacked(x.data_ptr(), out.data_ptr(), nb, rows,
                                     shift, dev, _stream(dev))
    else:
        grid = _grid(lib, dev, nb, rows, group)
        _check_rows(rows)
        ws = _workspace(group, x.device)
        stride = _round_up(nb, _ALIGN)
        ws.ensure(rows * stride)
        cid = _next_hop_id()
        ws.calls[cid] += 1
        ws.arrivals[cid] += grid
        plan = _hop_plan(ws, group, cid, stride, shift)
        e = lib.ring_dma_hop_launch(
            x.data_ptr(), out.data_ptr(), nb, rows, group.first_worker,
            group.num_workers, shift, grid, ctypes.byref(plan),
            ws.calls[cid], ws.arrivals[cid], ws.err_dev, cid, dev,
            _stream(dev))
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
    return _allgather_cuda(x, group)


def _allgather_cuda(x: torch.Tensor,
                    group: mesh_lib.WorkerGroup) -> torch.Tensor:
    """:func:`ring_allgather_cuda` of a CUDA ``x`` that passed ``_check``."""
    lib = _lib()
    x = x.contiguous()
    n = group.num_processes
    # made in its final shape: a flatten would cost one more op a call
    out = x.new_empty((group.num_workers * x.shape[1],) + x.shape[2:])
    chunk = x.numel() * x.element_size()
    if chunk == 0:
        return out
    dev = x.get_device()
    if n == 1:
        e = lib.ring_dma_allgather_stacked(x.data_ptr(), out.data_ptr(),
                                           chunk, dev, _stream(dev))
    else:
        grid = _grid(lib, dev, chunk, 1, group)
        if n - 1 > _MAX_STEPS:
            raise ValueError(f"the relay takes at most {_MAX_STEPS + 1} "
                             f"processes, got {n}")
        me = group.rank
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
        e = lib.ring_dma_allgather_launch(
            x.data_ptr(), out.data_ptr(), chunk, stride, n, me, grid,
            ctypes.byref(p), ws.calls[cid], ws.arrivals[cid], ws.err_dev,
            cid, dev, _stream(dev))
    _ok(e, "ring_dma allgather launch")
    launches["ring_allgather"] += 1
    return out


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
    if x.is_cuda:
        return _hop_cuda(x, shift, group)
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
    if x.is_cuda:
        return _allgather_cuda(x, group)
    if x.device.type == "cpu":
        return ring_allgather_plain(x, group)
    raise ValueError(f"ring_allgather runs on cuda or cpu, not {x.device}")
