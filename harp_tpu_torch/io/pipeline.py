"""Streaming ingestion: a chunked part-file stream with H2D prefetch.

Port of ``harp_tpu/io/pipeline.py``. :mod:`loaders` materializes
every byte before the first device op runs; this module turns a part-file
set into a BOUNDED chunk stream instead:

* **reader pool**: ``sched.dynamic.DynamicScheduler`` (the native parser
  underneath, the interpreter lock released) parses part-files at once into
  a bounded output queue; a slow consumer holds the pool back, so
  parsed-but-unconsumed data never exceeds ``queue_depth`` files plus one
  in-flight file per thread.
* **chunker**: a reorder stage restores path order (the chunk sequence does
  not depend on thread count or completion order) and re-slices files into
  fixed-row-budget :class:`Chunk` s, each with its global row offset and
  valid-row count.
* **prefetch**: :class:`DevicePrefetcher` copies chunk N+1 to the card from
  pinned memory on a side CUDA stream while the consumer works on chunk N.
* **distributed COO->CSR**: :func:`regroup_coo_device` routes nonzeros to
  their owning worker through the bounded-round reshard engine
  (``collectives/reshard.py``), then the native counting-sort CSR build runs
  per worker, replacing the whole-table host shuffle of
  ``loaders.regroup_coo_by_row`` for multi-worker loads.

Every stage runs under a :class:`utils.metrics.Metrics` timer named in
:data:`STAGES`; ``benchmark/ingest.py`` reads them into its stage table, and
:func:`flush_stage_timings` writes them to the telemetry step log as
``kind: "timing"`` events.
"""

from __future__ import annotations

import dataclasses
import io as _io
import queue
import threading
from typing import Callable, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from harp_tpu_torch.io import loaders, native_bridge
from harp_tpu_torch.sched.dynamic import DynamicScheduler, Task
from harp_tpu_torch.utils.metrics import Metrics

#: Stage names of every timer in this module (the bench's stage table
#: iterates them).
STAGES = ("ingest.list", "ingest.count", "ingest.read", "ingest.parse",
          "ingest.chunk", "ingest.regroup", "ingest.h2d", "ingest.compute")


def flush_stage_timings(metrics: Metrics, extra: Optional[dict] = None
                        ) -> None:
    """Emit one ``kind: "timing"`` telemetry event per ingestion stage that
    recorded samples (a no-op when telemetry is off)."""
    from harp_tpu_torch import telemetry

    for stage in STAGES:
        if metrics.timing(stage).get("count"):
            telemetry.record_timing(stage, metrics=metrics, extra=extra)


@dataclasses.dataclass
class Chunk:
    """One fixed-budget slice of the stream.

    ``data`` is ``(budget, cols)``: always the FULL budget shape (the tail
    chunk is zero-padded), so downstream shapes never change. ``rows``
    counts the valid leading rows; ``offset`` is the global row index of
    ``data[0]`` across the whole part-file set, in path order.
    """

    index: int
    offset: int
    rows: int
    data: object              # np.ndarray on the host; a tensor after H2D
    nbytes: int


def _read_part(path: str, sep: str, metrics: Metrics) -> np.ndarray:
    """Parse one part-file to a (rows, cols) float32 array, timing the
    remote byte fetch (``ingest.read``) apart from tokenizing
    (``ingest.parse``); local files are mapped, so the read rides the parse
    timer."""
    if loaders._is_url(path):
        with metrics.timer("ingest.read"):
            with loaders._fsspec_open(path) as f:
                raw = f.read()
        with metrics.timer("ingest.parse"):
            return np.loadtxt(_io.BytesIO(raw), delimiter=sep,
                              dtype=np.float32, ndmin=2)
    with metrics.timer("ingest.parse"):
        return loaders.load_dense_csv_one(path, sep)


class StreamLoader:
    """Bounded-queue chunk stream over a part-file set.

    Iterating yields :class:`Chunk` s in path order. The reader pool runs at
    most ``queue_depth`` parsed files ahead of the consumer
    (DynamicScheduler ``out_capacity``), so host memory stays flat however
    far the disk outruns the device.

    ``count=True`` (local files and the native parser only) runs the cheap
    native counting pass first, filling :attr:`total_rows` and
    :attr:`num_cols`: the stream-fed K-means fit needs the total to size its
    device block.
    """

    def __init__(self, paths: Sequence[str], *, chunk_rows: int = 65536,
                 sep: str = ",", num_threads: int = 4, queue_depth: int = 4,
                 count: bool = True, serial: bool = False,
                 metrics: Optional[Metrics] = None):
        self.paths = list(paths)
        if not self.paths:
            raise FileNotFoundError(
                "StreamLoader: no input files (empty path list)")
        if chunk_rows <= 0:
            raise ValueError(f"chunk_rows must be positive, got {chunk_rows}")
        self.chunk_rows = int(chunk_rows)
        self.sep = sep
        self.num_threads = max(1, int(num_threads))
        self.queue_depth = max(1, int(queue_depth))
        # serial=True: no reader pool, no readahead; every part parses on
        # the CONSUMER thread when its rows are wanted (the prefetch-off
        # twin the overlap bench measures against)
        self.serial = bool(serial)
        self.metrics = metrics if metrics is not None else Metrics()
        self.total_rows: Optional[int] = None
        self.num_cols: Optional[int] = None
        if count:
            self._count_pass()

    def _count_pass(self) -> None:
        if any(loaders._is_url(p) for p in self.paths) \
                or not native_bridge.available():
            return
        with self.metrics.timer("ingest.count"):
            shapes = [native_bridge.count_csv(p, self.sep)
                      for p in self.paths]
        if any(s is None for s in shapes):
            return
        widths = {c for r, c in shapes if r > 0}
        if len(widths) > 1:
            raise ValueError(
                f"part files disagree on column count: {sorted(widths)}")
        self.total_rows = sum(r for r, _ in shapes)
        self.num_cols = widths.pop() if widths else 0

    def __iter__(self) -> Iterator[Chunk]:
        return self.chunks()

    def chunks(self) -> Iterator[Chunk]:
        """Generator over fixed-budget chunks, run on the CALLER's thread:
        pulling the next chunk is what gives the reader pool room to run
        ahead (at most ``queue_depth`` files)."""
        source = (self._serial_arrays() if self.serial
                  else self._pooled_arrays())
        return self._slice(source)

    def _serial_arrays(self) -> Iterator[np.ndarray]:
        for path in self.paths:
            yield _read_part(path, self.sep, self.metrics)

    def _pooled_arrays(self) -> Iterator[np.ndarray]:
        """Path-order arrays from the bounded reader pool: completions come
        in any order, so a reorder buffer restores path order (the chunk
        stream is byte-identical at any thread count)."""
        sep, metrics = self.sep, self.metrics

        class _ParseTask(Task[Tuple[int, str], Tuple[int, np.ndarray]]):
            def run(self, item):
                idx, path = item
                return idx, _read_part(path, sep, metrics)

        sched = DynamicScheduler(
            [_ParseTask() for _ in
             range(min(self.num_threads, len(self.paths)))],
            out_capacity=self.queue_depth)
        self._sched = sched           # introspection seam (backpressure test)
        sched.start()
        sched.submit_all(enumerate(self.paths))
        pending: dict = {}
        try:
            for next_idx in range(len(self.paths)):
                while next_idx not in pending:
                    idx, arr = sched.wait_for_output()
                    pending[idx] = arr
                yield pending.pop(next_idx)
        finally:
            sched.stop()

    def _slice(self, arrays: Iterable[np.ndarray]) -> Iterator[Chunk]:
        budget = self.chunk_rows
        parts: List[np.ndarray] = []     # parsed rows not yet emitted
        have = 0
        cols: Optional[int] = None
        index = 0
        offset = 0

        def _fill(out: np.ndarray, want: int) -> None:
            filled = 0
            while filled < want:
                head = parts[0]
                take = min(len(head), want - filled)
                out[filled:filled + take] = head[:take]
                if take == len(head):
                    parts.pop(0)
                else:
                    parts[0] = head[take:]
                filled += take

        for arr in arrays:
            if not len(arr):
                continue
            if cols is None:
                cols = arr.shape[1]
            elif arr.shape[1] != cols:
                raise ValueError(
                    f"part files disagree on column count: "
                    f"[{cols}, {arr.shape[1]}]")
            parts.append(arr)
            have += len(arr)
            while have >= budget:
                with self.metrics.timer("ingest.chunk"):
                    out = np.empty((budget, cols), np.float32)
                    _fill(out, budget)
                have -= budget
                yield Chunk(index, offset, budget, out, out.nbytes)
                offset += budget
                index += 1
        if have:
            with self.metrics.timer("ingest.chunk"):
                out = np.zeros((budget, cols), np.float32)
                _fill(out, have)
            yield Chunk(index, offset, have, out, have * cols * 4)


class _PrefetchDone:
    pass


class _PrefetchError:
    def __init__(self, error: BaseException):
        self.error = error


class DevicePrefetcher:
    """Double-buffered H2D stage: a background thread pulls host chunks and
    places them on the device into a bounded queue, so chunk N+1's parse
    and copy overlap chunk N's compute on the consumer thread.

    ``place`` maps a host ``(budget, cols)`` array to its device residence
    (``session.replicate_put`` for the stream-fed fit, ``session.scatter``
    for row-sharded minibatches); the device is that of the session
    ``place`` is a method of. ``enabled=False`` is the serialized
    twin the overlap bench compares against: the same placement, inline on
    the consumer thread.

    On a CUDA device each chunk goes through these steps, each guarding
    something (a race here would show only as wrong bits):

    1. the placing thread enters the session's device: the current CUDA
       device is per thread, and a new thread starts on device 0;
    2. the chunk is copied into pinned host memory: only from pinned memory
       is a ``non_blocking`` copy asynchronous (``HarpSession._put`` passes
       ``non_blocking`` for a pinned source);
    3. the copy runs on a side stream, so it overlaps the kernels the
       consumer queues on its own stream;
    4. the placing thread waits for an event recorded after the copy before
       it hands the chunk over (the JAX package waits for the transfer the
       same way): the consumer's stream reads only finished data, and the
       pinned staging block is not reused (the next chunk's pinning) before
       its copy has finished;
    5. the consumer marks the tensor with ``record_stream`` for its own
       stream: the caching allocator files the block under the side stream,
       and without the mark it could hand the block to the next chunk's copy
       while the consumer's kernels still read it.

    On the CPU ``place`` is a plain copy.
    """

    def __init__(self, chunks: Iterable[Chunk], place: Callable,
                 *, depth: int = 2, enabled: bool = True,
                 metrics: Optional[Metrics] = None):
        self._place = place
        self._metrics = metrics if metrics is not None else Metrics()
        self._enabled = bool(enabled)
        self._done = False
        device = getattr(getattr(place, "__self__", None), "device", None)
        self._device = torch.device(device) if device is not None else None
        if self._device is not None and self._device.type == "cuda" \
                and self._device.index is None:
            # "cuda" names the consumer's current device, not the placing
            # thread's (step 1)
            self._device = torch.device("cuda", torch.cuda.current_device())
        self._stream = (torch.cuda.Stream(device=self._device)
                        if self._device is not None
                        and self._device.type == "cuda" else None)
        if self._enabled:
            self._stop = threading.Event()
            self._q: "queue.Queue[object]" = queue.Queue(
                maxsize=max(1, int(depth)))
            self._src = iter(chunks)
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()
        else:
            self._it = iter(chunks)

    def _to_device(self, ch: Chunk) -> Chunk:
        with self._metrics.timer("ingest.h2d"):
            if self._stream is None:
                return dataclasses.replace(ch, data=self._place(ch.data))
            with torch.cuda.device(self._device):                    # 1
                host = torch.from_numpy(
                    np.ascontiguousarray(ch.data, np.float32)).pin_memory()  # 2
                with torch.cuda.stream(self._stream):                # 3
                    dev = self._place(host)
                    copied = self._stream.record_event()
                copied.synchronize()                                 # 4
        return dataclasses.replace(ch, data=dev)

    def _hand_over(self, ch: Chunk) -> Chunk:
        if self._stream is not None and isinstance(ch.data, torch.Tensor):
            ch.data.record_stream(torch.cuda.current_stream(self._device))  # 5
        return ch

    def _run(self) -> None:
        try:
            for ch in self._src:
                item: object = self._to_device(ch)
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
            self._q.put(_PrefetchDone())
        except BaseException as e:      # noqa: BLE001 (handed to the consumer)
            try:
                self._q.put(_PrefetchError(e), timeout=1.0)
            except queue.Full:
                pass

    def __iter__(self) -> "DevicePrefetcher":
        return self

    def __next__(self) -> Chunk:
        if self._done:
            raise StopIteration
        if not self._enabled:
            try:
                return self._hand_over(self._to_device(next(self._it)))
            except StopIteration:
                self._done = True
                raise
        got = self._q.get()
        if isinstance(got, _PrefetchDone):
            self._done = True
            raise StopIteration
        if isinstance(got, _PrefetchError):
            self._done = True
            raise got.error
        return self._hand_over(got)

    def close(self) -> None:
        """Stop the background thread (early-exit consumers)."""
        if not self._enabled:
            return
        self._stop.set()
        try:
            self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)


# --------------------------------------------------------------------------- #
# Stream-fed assembly (the bitwise seam of KMeans.fit_from_stream)
# --------------------------------------------------------------------------- #

def assemble_stream(session, chunks: Iterable[Chunk], total_rows: int,
                    padded_cols: int, dtype="float32", *,
                    metrics: Optional[Metrics] = None) -> torch.Tensor:
    """Stream chunks into ONE device block of ``total_rows`` rows and
    ``padded_cols`` columns, laid out as ``session.scatter(points, dtype)``
    lays out the same data loaded in memory (``KMeans.prepare``): the global
    (N, D) block, or this process's rows in a process group. The block is
    bitwise that scatter, so the unchanged fit on it is bitwise the
    in-memory fit.

    Each chunk's valid rows land at ``offset`` by slice assignment into the
    preallocated block; rows past ``total_rows``, and in a process group
    rows outside this process's range, are dropped. A host chunk is copied
    under the ``ingest.h2d`` timer, the placement runs under
    ``ingest.regroup``. The conversion to bf16 is the ``.to`` that
    ``scatter(dtype=)`` applies."""
    metrics = metrics if metrics is not None else Metrics()
    w = session.num_workers
    if total_rows <= 0 or total_rows % w:
        raise ValueError(f"total_rows {total_rows} must be a positive "
                         f"multiple of {w} workers (truncate at ingest)")
    out_dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    g = session.workers
    per = total_rows // w
    lo = g.first_worker * per if g.process_group else 0
    hi = lo + g.workers_per_process * per
    buf = torch.zeros((hi - lo, padded_cols), dtype=out_dtype,
                      device=session.device)
    for ch in chunks:
        data = ch.data
        if not isinstance(data, torch.Tensor):
            with metrics.timer("ingest.h2d"):
                data = session.replicate_put(np.asarray(data, np.float32))
        cols = data.shape[1]
        if cols > padded_cols:
            raise ValueError(f"chunk has {cols} cols, block holds "
                             f"{padded_cols}")
        with metrics.timer("ingest.regroup"):
            a = max(ch.offset, lo)
            b = min(ch.offset + ch.rows, hi)
            if b > a:
                buf[a - lo:b - lo, :cols] = \
                    data[a - ch.offset:b - ch.offset].to(out_dtype)
    if buf.is_cuda:
        torch.cuda.synchronize(buf.device)
    return buf


# --------------------------------------------------------------------------- #
# Distributed COO -> CSR (device regroup + native per-worker counting sort)
# --------------------------------------------------------------------------- #

def pack_coo(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray
             ) -> np.ndarray:
    """Pack (row int64, col int64, val float32) into (n, 5) int32 records:
    the fixed 20-byte wire row the regroup moves. A bit reinterpretation
    (numpy views), exact round trip through :func:`unpack_coo`."""
    n = len(rows)
    rec = np.empty((n, 5), np.int32)
    rec[:, 0:2] = np.ascontiguousarray(rows, np.int64).view(
        np.int32).reshape(n, 2)
    rec[:, 2:4] = np.ascontiguousarray(cols, np.int64).view(
        np.int32).reshape(n, 2)
    rec[:, 4] = np.ascontiguousarray(vals, np.float32).view(np.int32)
    return rec


def unpack_coo(rec: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    rec = np.ascontiguousarray(rec, np.int32)
    rows = np.ascontiguousarray(rec[:, 0:2]).view(np.int64).reshape(-1)
    cols = np.ascontiguousarray(rec[:, 2:4]).view(np.int64).reshape(-1)
    vals = np.ascontiguousarray(rec[:, 4]).view(np.float32)
    return rows, cols, vals


def regroup_coo_device(session, rows: np.ndarray, cols: np.ndarray,
                       vals: np.ndarray, *, num_rows: Optional[int] = None,
                       chunk_bytes: Optional[int] = None,
                       metrics: Optional[Metrics] = None
                       ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Route nonzeros to their row-block owner ON THE DEVICE: packed
    20-byte records ride the reshard engine's chunk-bounded ``all_to_all``
    rounds (at most ``chunk_bytes`` of foreign rows a round), replacing the
    whole-table host shuffle of ``loaders.regroup_coo_by_row``.

    Returns per-worker (rows, cols, vals) triples for all W workers (in a
    process group gathered from every process); each worker's slice is the
    host oracle's, nnz for nnz, in global parse order."""
    from harp_tpu_torch.collectives import reshard as rs
    from harp_tpu_torch.parallel import mesh as mesh_lib

    metrics = metrics if metrics is not None else Metrics()
    w = session.num_workers
    rows = np.asarray(rows, np.int64)
    if num_rows is None:
        num_rows = int(rows.max()) + 1 if rows.size else w
    if not rows.size:
        e = (np.empty(0, np.int64), np.empty(0, np.int64),
             np.empty(0, np.float32))
        return [e for _ in range(w)]
    plan, counts, cap = rs.plan_coo_regroup(
        rows, num_rows, w,
        chunk_bytes=(rs.DEFAULT_CHUNK_BYTES if chunk_bytes is None
                     else chunk_bytes))
    rec = pack_coo(rows, cols, vals)
    fill = session.scatter(np.zeros((w * cap, 5), np.int32))
    with metrics.timer("ingest.regroup"):
        fn, args = rs.prepare_reshard(session, rec, plan, fill)
        moved = mesh_lib.fetch(fn(*args), session.workers)
    return [unpack_coo(moved[wi * cap: wi * cap + int(counts[wi])])
            for wi in range(w)]


def coo_to_csr_distributed(session, rows: np.ndarray, cols: np.ndarray,
                           vals: np.ndarray, *,
                           num_rows: Optional[int] = None,
                           chunk_bytes: Optional[int] = None,
                           metrics: Optional[Metrics] = None
                           ) -> List[Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]]:
    """Distributed COO->CSR: the device regroup to row-block owners, then
    the native counting-sort CSR build per worker over LOCAL row ids.
    Worker ``w`` owns global rows ``[w * block, min((w + 1) * block,
    num_rows))`` with ``block = ceil(num_rows / W)``; its (indptr, indices,
    values) covers that block with row 0 its first global row."""
    w = session.num_workers
    rows = np.asarray(rows, np.int64)
    if num_rows is None:
        num_rows = int(rows.max()) + 1 if rows.size else w
    block = -(-max(int(num_rows), 1) // w)
    grouped = regroup_coo_device(session, rows, cols, vals,
                                 num_rows=num_rows, chunk_bytes=chunk_bytes,
                                 metrics=metrics)
    out = []
    for wi, (r, c, v) in enumerate(grouped):
        local_rows = min(block, max(0, int(num_rows) - wi * block))
        out.append(loaders.coo_to_csr(r - wi * block, c, v,
                                      num_rows=max(local_rows, 0)))
    return out
