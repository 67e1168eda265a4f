"""Input pipeline: whole-files-per-worker loading on the host.

Port of ``harp_tpu/io/loaders.py``. Reference parity: Harp's
``MultiFileInputFormat``/``MultiFileSplit`` (one split = a list of whole
files per worker) and ``HarpDAALDataSource`` (datasource/
HarpDAALDataSource.java:64), which read dense CSV, COO and CSR with a
multithreaded reader pool (MTReader).

Files are assigned to workers by the same contiguous-split rule and read by
a host thread pool (``sched.dynamic.DynamicScheduler``, the MTReader
equivalent); the host arrays are then placed by ``HarpSession.scatter``.
The parse is the repository's native C++ loader (``native/loader.cpp``,
through ``native_bridge``) wherever it builds, so a file loads to the JAX
package's float32 bits; without a compiler it is ``numpy.loadtxt``.
Basenames starting with ``_`` or ``.`` (``_SUCCESS``, ``_README``, ``.crc``)
are metadata and are skipped when a directory or glob is expanded; a file
named explicitly is always read.

Remote object stores (the HDFS role): a path containing a ``://`` scheme
(``gs://``, ``s3://``, ``memory://``, ``file://``) goes through
:mod:`fsspec`, imported only then (without it such a path raises); local
paths keep the native fast path. The reader pool does not care which, so
remote part-files overlap their downloads as the reference's MTReader over
libhdfs did. :func:`list_files` expands directories and globs of either
kind.
"""

from __future__ import annotations

import glob as _glob
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from harp_tpu_torch.io import native_bridge
from harp_tpu_torch.sched.dynamic import DynamicScheduler, Task


def _is_url(path: str) -> bool:
    return "://" in path


def _fsspec(path: str):
    try:
        import fsspec
    except ImportError as e:
        raise ImportError(
            f"reading {path!r} needs fsspec (the remote-store seam; local "
            f"paths work without it)") from e
    return fsspec


def _fsspec_open(path: str, mode: str = "rb"):
    return _fsspec(path).open(path, mode)


def _hidden(path: str) -> bool:
    """Hadoop input-format convention: ``_``/``.``-prefixed basenames are
    metadata, not data."""
    return os.path.basename(path.rstrip("/")).startswith(("_", "."))


def list_files(spec: str) -> List[str]:
    """A file, a directory of part-files or a glob, local or remote ->
    sorted file paths (remote ones with their scheme), ready for
    :func:`load_dense_csv` / :func:`load_coo`."""
    if _is_url(spec):
        fs, path = _fsspec(spec).core.url_to_fs(spec)
        if fs.isdir(path):
            # detail=True: one listing call, not one isdir stat per entry
            entries = fs.ls(path, detail=True)
        elif "*" not in path and "?" not in path and fs.exists(path):
            return [spec]        # an explicitly named file is never hidden
        else:
            # fs.glob(detail=True) exists only on recent fsspec; a plain
            # glob and an info call per entry keep older releases working
            try:
                got = fs.glob(path, detail=True)
            except TypeError:
                got = None
            if isinstance(got, dict):
                entries = got.values()
            else:
                entries = [fs.info(n) for n in (got if got is not None
                                                else fs.glob(path))]
        names = [e["name"] for e in entries if e.get("type") != "directory"
                 and not _hidden(e["name"])]
        return sorted(fs.unstrip_protocol(n) for n in names)
    if os.path.isfile(spec):
        return [spec]            # an explicitly named file is never hidden
    if os.path.isdir(spec):
        return sorted(os.path.join(spec, n) for n in os.listdir(spec)
                      if os.path.isfile(os.path.join(spec, n))
                      and not _hidden(n))
    return sorted(p for p in _glob.glob(spec) if not _hidden(p))


def split_files(paths: Sequence[str], num_workers: int) -> List[List[str]]:
    """MultiFileInputFormat semantics: contiguous whole-file groups per
    worker."""
    paths = sorted(paths)
    out: List[List[str]] = [[] for _ in range(num_workers)]
    base, extra = divmod(len(paths), num_workers)
    i = 0
    for w in range(num_workers):
        n = base + (1 if w < extra else 0)
        out[w] = list(paths[i:i + n])
        i += n
    return out


def load_dense_csv_one(path: str, sep: str = ",") -> np.ndarray:
    if _is_url(path):
        with _fsspec_open(path) as f:
            return np.loadtxt(f, delimiter=sep, dtype=np.float32, ndmin=2)
    arr = native_bridge.parse_csv(path, sep)
    if arr is not None:
        return arr
    return np.loadtxt(path, delimiter=sep, dtype=np.float32, ndmin=2)


def truncate_to_workers(arr: np.ndarray, num_workers: int) -> np.ndarray:
    """Trim the leading axis to a worker multiple (the load-then-shard
    idiom of every file-input CLI path)."""
    n = len(arr) - len(arr) % num_workers
    if n == 0:
        raise ValueError(
            f"{len(arr)} rows cannot shard over {num_workers} workers "
            f"(need at least one row per worker)")
    return arr[:n]


def _assemble_rows(parts: List[Optional[np.ndarray]], dtype) -> np.ndarray:
    """Concatenate without the 2x copy: preallocate the output from the
    summed row counts and copy each part into its slice, releasing parts as
    they are copied (peak memory is the total plus one part)."""
    kept = [p for p in parts if p is not None]
    if not kept:
        raise ValueError("need at least one array to assemble")
    widths = {p.shape[1] for p in kept if len(p)} or {kept[0].shape[1]}
    if len(widths) > 1:
        raise ValueError(
            f"part files disagree on column count: {sorted(widths)}")
    total = sum(len(p) for p in kept)
    out = np.empty((total, widths.pop()), dtype)
    off = 0
    for i, p in enumerate(kept):
        out[off:off + len(p)] = p
        off += len(p)
        kept[i] = None            # free each part as soon as it is copied
    return out


def _run_pool(task: Task, items: Sequence, num_threads: int) -> list:
    """Run ``task`` over ``items`` on a reader pool of at most
    ``num_threads`` threads; the results in completion order."""
    sched = DynamicScheduler(
        [task for _ in range(min(num_threads, max(len(items), 1)))])
    sched.start()
    sched.submit_all(items)
    try:
        return sched.drain()
    finally:
        sched.stop()


def _load_dense_csv_prealloc(paths: List[str], num_threads: int,
                             sep: str) -> Optional[np.ndarray]:
    """Load without an extra copy: a native counting pass sizes ONE
    (total_rows, cols) block, then the reader pool parses every file into
    its row-offset view (``native_bridge.parse_csv_into``). None when any
    file defeats the native counter; the caller falls back to the per-file
    path."""
    shapes = [native_bridge.count_csv(p, sep) for p in paths]
    if any(s is None for s in shapes):
        return None
    widths = {c for r, c in shapes if r > 0}
    if len(widths) > 1:
        raise ValueError(
            f"part files disagree on column count: {sorted(widths)}")
    total = sum(r for r, _ in shapes)
    out = np.empty((total, widths.pop() if widths else 0), np.float32)
    offsets = np.concatenate([[0], np.cumsum([r for r, _ in shapes])])

    class _ParseIntoTask(Task[Tuple[int, str], Tuple[int, int]]):
        def run(self, item):
            idx, path = item
            nrows = shapes[idx][0]
            view = out[offsets[idx]:offsets[idx] + nrows]
            if nrows and not native_bridge.parse_csv_into(path, view, sep):
                # the file changed between count and parse (or is ragged):
                # redo it with the robust single-file loader, shape-checked
                arr = np.loadtxt(path, delimiter=sep, dtype=np.float32,
                                 ndmin=2)
                if arr.shape != view.shape:
                    raise ValueError(
                        f"{path}: shape changed during load "
                        f"({view.shape} counted, {arr.shape} parsed)")
                view[:] = arr
            return idx, nrows

    _run_pool(_ParseIntoTask(), list(enumerate(paths)), num_threads)
    return out


def load_dense_csv(paths: Sequence[str], num_threads: int = 4,
                   sep: str = ",") -> np.ndarray:
    """Multithreaded dense CSV load (HarpDAALDataSource.
    createDenseNumericTable:76): the row-concatenation of all files, in
    path order, float32.

    With the native parser built and every path local, a counting pass
    preallocates the whole (total_rows, cols) block and each file parses
    into its row-offset view: no per-file intermediates and no extra copy
    of the dataset. Otherwise per-file arrays are assembled into one
    preallocated output, each part released as it is copied."""
    paths = list(paths)
    if not paths:
        raise FileNotFoundError(
            "load_dense_csv: no input files (empty path list: check the "
            "path or glob; _/.-prefixed basenames are skipped as hidden)")
    if native_bridge.available() and not any(_is_url(p) for p in paths):
        got = _load_dense_csv_prealloc(paths, num_threads, sep)
        if got is not None:
            return got
    results: List[Optional[np.ndarray]] = [None] * len(paths)

    class _ReadTask(Task[Tuple[int, str], Tuple[int, np.ndarray]]):
        """ReadDenseCSVTask equivalent (datasource/ReadDenseCSVTask.java)."""

        def run(self, item):
            idx, path = item          # indexed item: duplicate paths stay
            return idx, load_dense_csv_one(path, sep)

    for idx, arr in _run_pool(_ReadTask(), list(enumerate(paths)),
                              num_threads):
        results[idx] = arr
    return _assemble_rows(results, np.float32)


def _load_coo_one(path: str, sep: str
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    if not _is_url(path):
        triple = native_bridge.parse_coo(path, sep)
        if triple is not None:
            return triple
    delim = None if sep == " " else sep
    if _is_url(path):
        with _fsspec_open(path) as f:
            m = np.loadtxt(f, delimiter=delim, ndmin=2)
    else:
        m = np.loadtxt(path, delimiter=delim, ndmin=2)
    m = m.reshape(-1, 3)
    return (m[:, 0].astype(np.int64), m[:, 1].astype(np.int64),
            m[:, 2].astype(np.float32))


def _load_coo_prealloc(paths: List[str], sep: str, num_threads: int
                       ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """COO load without an extra copy: native line counts size the three
    output arrays once; each file parses into its offset views
    (``native_bridge.parse_coo_into``). None when counting fails."""
    counts = [native_bridge.count_lines(p) for p in paths]
    if any(c is None for c in counts):
        return None
    offsets = np.concatenate([[0], np.cumsum(counts)])
    total = int(offsets[-1])
    rows = np.empty(total, np.int64)
    cols = np.empty(total, np.int64)
    vals = np.empty(total, np.float32)

    class _ParseCOOIntoTask(Task[Tuple[int, str], Tuple[int, int]]):
        def run(self, item):
            idx, path = item
            lo, hi = offsets[idx], offsets[idx + 1]
            if hi > lo and not native_bridge.parse_coo_into(
                    path, rows[lo:hi], cols[lo:hi], vals[lo:hi]):
                r, c, v = _load_coo_one(path, sep)
                if len(r) != hi - lo:
                    raise ValueError(
                        f"{path}: line count changed during load "
                        f"({hi - lo} counted, {len(r)} parsed)")
                rows[lo:hi], cols[lo:hi], vals[lo:hi] = r, c, v
            return idx, int(hi - lo)

    _run_pool(_ParseCOOIntoTask(), list(enumerate(paths)), num_threads)
    return rows, cols, vals


def load_coo(paths: Sequence[str], sep: str = " ", num_threads: int = 4
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """COO triple load (HarpDAALDataSource.loadCOOFiles:317): each line
    ``row col value``. Returns (rows int64, cols int64, vals float32),
    concatenated in path order. Files are read by the reader pool; ctypes
    releases the interpreter lock, so the native parses overlap. Like
    :func:`load_dense_csv`, the native path preallocates the three outputs
    from summed line counts and parses into offset views."""
    paths = list(paths)
    if not paths:
        raise FileNotFoundError(
            "load_coo: no input files (empty path list: check the path or "
            "glob; _/.-prefixed basenames are skipped as hidden)")
    if (native_bridge.available() and sep in (" ", "\t")
            and not any(_is_url(p) for p in paths)):
        got = _load_coo_prealloc(paths, sep, num_threads)
        if got is not None:
            return got
    results: List[Optional[Tuple]] = [None] * len(paths)

    class _ReadCOOTask(Task[Tuple[int, str], Tuple[int, Tuple]]):
        """ReadCOOTask equivalent (datasource/ReadCOOTask.java)."""

        def run(self, item):
            idx, path = item          # indexed item: duplicate paths stay
            return idx, _load_coo_one(path, sep)

    for idx, triple in _run_pool(_ReadCOOTask(), list(enumerate(paths)),
                                 num_threads):
        results[idx] = triple
    total = sum(len(t[0]) for t in results)
    rows = np.empty(total, np.int64)
    cols = np.empty(total, np.int64)
    vals = np.empty(total, np.float32)
    off = 0
    for i, (r, c, v) in enumerate(results):
        rows[off:off + len(r)] = r
        cols[off:off + len(r)] = c
        vals[off:off + len(r)] = v
        off += len(r)
        results[i] = None         # free each part as soon as it is copied
    return rows, cols, vals


def coo_to_csr(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
               num_rows: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """COO->CSR conversion (HarpDAALDataSource.COOToCSR:439).

    Returns (indptr[num_rows + 1], indices, values) with rows ascending and
    each row's entries in input order (STABLE: duplicate semantics upstream
    rely on it). The native parallel counting sort where the library is
    built; a numpy stable argsort and ``bincount`` otherwise."""
    if num_rows is None:
        num_rows = int(rows.max()) + 1 if rows.size else 0
    if rows.size and (rows.min() < 0 or rows.max() >= num_rows):
        # the numpy fallback would otherwise wrap negatives into indptr[0]
        # silently; validate up front on BOTH paths
        raise ValueError(f"row ids must be in [0, {num_rows}); got "
                         f"[{rows.min()}, {rows.max()}]")
    vals = np.asarray(vals, np.float32)   # one output dtype on both paths
    if rows.size:
        native = native_bridge.coo_to_csr(rows, cols, vals, num_rows)
        if native is not None:
            return native
    order = np.argsort(rows, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    indptr = np.zeros(num_rows + 1, dtype=np.int64)
    # one vectorized counting pass (np.add.at is ~10x slower at large nnz);
    # the range was validated above, so minlength pins the length
    indptr[1:] = np.bincount(rows, minlength=num_rows)
    np.cumsum(indptr, out=indptr)
    return indptr, cols.astype(np.int64), vals


def regroup_coo_by_row(rows, cols, vals, num_workers: int):
    """Distributed COO regroup on the host (HarpDAALDataSource.
    regroupCOOList:399): route each nonzero to the worker owning its row
    block; per-worker COO triples. ``pipeline.regroup_coo_device`` is the
    device twin."""
    num_rows = int(rows.max()) + 1 if rows.size else num_workers
    block = -(-num_rows // num_workers)
    owner = np.minimum(rows // block, num_workers - 1)
    out = []
    for w in range(num_workers):
        m = owner == w
        out.append((rows[m], cols[m], vals[m]))
    return out


def load_corpus(spec: str, num_threads: int = 4) -> np.ndarray:
    """Rectangular token-id corpus: one document per line, space-separated
    integer token ids, every line the SAME length (``datasets/lda/``).
    ``spec`` is a file, a directory of part-files or a glob, local or
    remote; parts are read on the reader pool. Returns int64 (D, L) in path
    order."""
    paths = list_files(spec)
    if not paths:
        raise FileNotFoundError(f"no corpus files match {spec!r}")
    results: List[Optional[np.ndarray]] = [None] * len(paths)

    class _ReadCorpusTask(Task[Tuple[int, str], Tuple[int, np.ndarray]]):
        def run(self, item):
            idx, path = item
            if _is_url(path):
                with _fsspec_open(path) as f:
                    return idx, np.loadtxt(f, dtype=np.int64, ndmin=2)
            return idx, np.loadtxt(path, dtype=np.int64, ndmin=2)

    for idx, arr in _run_pool(_ReadCorpusTask(), list(enumerate(paths)),
                              num_threads):
        results[idx] = arr
    widths = {p.shape[1] for p in results if p is not None}
    if len(widths) > 1:
        raise ValueError(
            f"corpus files disagree on document length: {sorted(widths)} "
            f"(the dense token-matrix format needs one fixed length)")
    return _assemble_rows(results, np.int64)


def load_labeled_csv(spec: str, num_threads: int = 4
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Dense CSV with the LABEL in the last column (the daal_svm/daal_naive
    fixture format): (x (N, D) float32, y (N,) int32)."""
    m = load_dense_csv(list_files(spec), num_threads=num_threads)
    if m.shape[1] < 2:
        raise ValueError("labeled CSV needs >= 2 columns (features, label)")
    return m[:, :-1], m[:, -1].astype(np.int32)
