"""Input files — part-file listing and COO text parsing (numpy on the host).

Port of ``list_files``, ``load_coo``, ``load_corpus`` and
``truncate_to_workers`` from ``harp_tpu/io/loaders.py``, for
local paths only (reference: Harp's ``MultiFileInputFormat`` over a
directory of part-files, and ``HarpDAALDataSource.loadCOOFiles``). Basenames
starting with ``_`` or ``.`` (``_SUCCESS``, ``_README``, ``.crc``) are
metadata, not data, and are skipped when a directory or glob is expanded; a
file named explicitly is always read. Remote object stores, the native C++
parser and the reader thread pool of the JAX package are not ported: the
parse here is ``numpy.loadtxt`` and gives the same arrays.
"""

from __future__ import annotations

import glob
import os
from typing import List, Sequence, Tuple

import numpy as np


def _hidden(path: str) -> bool:
    """Hadoop input-format convention: ``_``/``.``-prefixed basenames are
    metadata."""
    return os.path.basename(path.rstrip("/")).startswith(("_", "."))


def list_files(spec: str) -> List[str]:
    """A file, a directory of part-files or a glob -> sorted file paths."""
    if "://" in spec:
        raise NotImplementedError(f"remote paths ({spec!r}) are not ported "
                                  f"yet: local files only")
    if os.path.isfile(spec):
        return [spec]            # an explicitly named file is never hidden
    if os.path.isdir(spec):
        return sorted(os.path.join(spec, n) for n in os.listdir(spec)
                      if os.path.isfile(os.path.join(spec, n))
                      and not _hidden(n))
    return sorted(p for p in glob.glob(spec) if not _hidden(p))


def load_coo(paths: Sequence[str], sep: str = " "
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``row col value`` lines -> (rows int64, cols int64, vals float32),
    concatenated in path order."""
    paths = list(paths)
    if not paths:
        raise FileNotFoundError(
            "load_coo: no input files (empty path list: check the path or "
            "glob; _/.-prefixed basenames are skipped as hidden)")
    parts = [np.loadtxt(p, delimiter=None if sep == " " else sep, ndmin=2)
             for p in paths]
    m = np.concatenate([p.reshape(-1, 3) for p in parts])
    return m[:, 0].astype(np.int64), m[:, 1].astype(np.int64), \
        m[:, 2].astype(np.float32)


def load_corpus(spec: str) -> np.ndarray:
    """Rectangular token-id corpus: one document per line, space-separated
    integer token ids, every line the SAME length (``datasets/lda/``);
    ``spec`` is a file, a directory of part-files or a glob. Returns int64
    (D, L) in path order."""
    paths = list_files(spec)
    if not paths:
        raise FileNotFoundError(f"no corpus files match {spec!r}")
    parts = [np.loadtxt(p, dtype=np.int64, ndmin=2) for p in paths]
    widths = {p.shape[1] for p in parts}
    if len(widths) > 1:
        raise ValueError(
            f"corpus files disagree on document length: {sorted(widths)} "
            f"(the dense token-matrix format needs one fixed length)")
    return np.concatenate(parts).astype(np.int64)


def truncate_to_workers(arr: np.ndarray, num_workers: int) -> np.ndarray:
    """Trim the leading axis to a worker multiple (the load-then-shard
    idiom of every file-input CLI path)."""
    n = len(arr) - len(arr) % num_workers
    if n == 0:
        raise ValueError(
            f"{len(arr)} rows cannot shard over {num_workers} workers "
            f"(need at least one row per worker)")
    return arr[:n]
