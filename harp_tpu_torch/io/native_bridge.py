"""ctypes bridge to the native C++ loader (``native/loader.cpp``).

Port of ``harp_tpu/io/native_bridge.py``. Reference parity: Harp shipped
native .so helpers (libhdfs, DAAL's loaders) and read input with Java thread
pools; here a small C++ library does the parse-heavy work (CSV and COO
tokenizing, COO->CSR) with the interpreter lock released. It is the JAX
package's own source, so a file parses to the JAX package's float32 bits.

The first :func:`available` (or any parse) loads the library: the path in
``HARP_NATIVE_LIB`` if that is set, else the one ``native_build.build``
compiles into ``build/`` (built on that first call). Without a compiler the
callers fall back to numpy, as in the JAX package. :data:`parses` counts the
files the library parsed (``"csv"``, ``"coo"``) and the ``"coo_to_csr"``
calls it answered, read like the kernel wrappers' launch counts.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_PROBE = threading.Lock()
_COUNT = threading.Lock()

parses: Dict[str, int] = {"csv": 0, "coo": 0, "coo_to_csr": 0}


def _counted(kind: str) -> None:
    # the reader pool's threads parse at once: += is a read-modify-write
    with _COUNT:
        parses[kind] += 1


def _find_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _PROBE:
        if _TRIED:
            return _LIB
        path = os.environ.get("HARP_NATIVE_LIB", "")
        if not path:
            from harp_tpu_torch.io import native_build

            path = native_build.build() or ""
        if path and os.path.exists(path):
            try:
                lib = ctypes.CDLL(path)
                _configure(lib)
                _LIB = lib
            except OSError:
                pass
        _TRIED = True
        return _LIB


def _configure(lib: ctypes.CDLL) -> None:
    ll = ctypes.POINTER(ctypes.c_longlong)
    fl = ctypes.POINTER(ctypes.c_float)
    lib.harp_count_csv.restype = ctypes.c_longlong
    lib.harp_count_csv.argtypes = [ctypes.c_char_p, ctypes.c_char, ll, ll]
    lib.harp_parse_csv.restype = ctypes.c_int
    lib.harp_parse_csv.argtypes = [ctypes.c_char_p, ctypes.c_char, fl,
                                   ctypes.c_longlong]
    lib.harp_count_lines.restype = ctypes.c_longlong
    lib.harp_count_lines.argtypes = [ctypes.c_char_p]
    lib.harp_parse_coo.restype = ctypes.c_int
    lib.harp_parse_coo.argtypes = [ctypes.c_char_p, ll, ll, fl,
                                   ctypes.c_longlong]
    lib.harp_coo_to_csr.restype = ctypes.c_int
    lib.harp_coo_to_csr.argtypes = [ll, ll, fl, ctypes.c_longlong,
                                    ctypes.c_longlong, ll, ll, fl]


def reset() -> None:
    """Forget the loaded library (the next call probes again)."""
    global _LIB, _TRIED
    with _PROBE:
        _LIB, _TRIED = None, False


def available() -> bool:
    return _find_lib() is not None


def count_csv(path: str, sep: str = ",") -> Optional[Tuple[int, int]]:
    """(rows, cols) of a dense CSV from the native counting pass: the cheap
    first phase that lets loaders preallocate the whole dataset once and
    parse every part straight into its row-offset view."""
    lib = _find_lib()
    if lib is None:
        return None
    rows = ctypes.c_longlong(0)
    cols = ctypes.c_longlong(0)
    n = lib.harp_count_csv(path.encode(), sep.encode()[:1],
                           ctypes.byref(rows), ctypes.byref(cols))
    if n < 0:
        return None
    return int(rows.value), int(cols.value)


def parse_csv_into(path: str, out: np.ndarray, sep: str = ",") -> bool:
    """Parse a dense CSV into a caller-owned float32 buffer (usually a view
    into a preallocated dataset). ``out`` must be C-contiguous float32 of
    exactly rows * cols elements; False on any mismatch (capacity, ragged
    rows, no library): the caller falls back."""
    lib = _find_lib()
    if lib is None:
        return False
    if out.dtype != np.float32 or not out.flags["C_CONTIGUOUS"]:
        return False
    rc = lib.harp_parse_csv(path.encode(), sep.encode()[:1],
                            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                            out.size)
    if rc == 0:
        _counted("csv")
    return rc == 0


def parse_csv(path: str, sep: str = ",") -> Optional[np.ndarray]:
    shape = count_csv(path, sep)
    if shape is None:
        return None
    out = np.empty(shape, dtype=np.float32)
    return out if parse_csv_into(path, out, sep) else None


def count_lines(path: str) -> Optional[int]:
    lib = _find_lib()
    if lib is None:
        return None
    n = lib.harp_count_lines(path.encode())
    return int(n) if n >= 0 else None


def parse_coo_into(path: str, rows: np.ndarray, cols: np.ndarray,
                   vals: np.ndarray) -> bool:
    """Parse a COO part into caller-owned (int64, int64, float32) buffers of
    exactly the file's line count (views into preallocated whole-dataset
    arrays). False on a mismatch or without the library."""
    lib = _find_lib()
    if lib is None:
        return False
    if (rows.dtype != np.int64 or cols.dtype != np.int64
            or vals.dtype != np.float32
            or not (rows.flags["C_CONTIGUOUS"] and cols.flags["C_CONTIGUOUS"]
                    and vals.flags["C_CONTIGUOUS"])):
        return False
    rc = lib.harp_parse_coo(path.encode(),
                            rows.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
                            cols.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
                            vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                            len(rows))
    if rc == 0:
        _counted("coo")
    return rc == 0


def parse_coo(path: str, sep: str = " "
              ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    if sep not in (" ", "\t"):
        return None  # the native parser splits on whitespace only
    n = count_lines(path)
    if n is None:
        return None
    rows = np.empty(n, dtype=np.int64)
    cols = np.empty(n, dtype=np.int64)
    vals = np.empty(n, dtype=np.float32)
    return (rows, cols, vals) if parse_coo_into(path, rows, cols, vals) else None


def coo_to_csr(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
               num_rows: int
               ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Native stable parallel counting sort (COOToCSR parity); None without
    the library or when it reports out-of-range rows (``loaders.coo_to_csr``
    checks the range first, so its fallback never accepts what the native
    path rejected)."""
    lib = _find_lib()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    vals = np.ascontiguousarray(vals, np.float32)
    n = len(rows)
    indptr = np.empty(num_rows + 1, np.int64)
    indices = np.empty(n, np.int64)
    values = np.empty(n, np.float32)
    ll = ctypes.POINTER(ctypes.c_longlong)
    fl = ctypes.POINTER(ctypes.c_float)
    rc = lib.harp_coo_to_csr(
        rows.ctypes.data_as(ll), cols.ctypes.data_as(ll),
        vals.ctypes.data_as(fl), n, num_rows,
        indptr.ctypes.data_as(ll), indices.ctypes.data_as(ll),
        values.ctypes.data_as(fl))
    if rc != 0:
        return None
    _counted("coo_to_csr")
    return indptr, indices, values
