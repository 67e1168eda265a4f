"""Build and bind the port's CUDA kernels: nvcc into a shared library with a
plain C interface, loaded with ctypes.

Each source under ``harp_tpu_torch/csrc/`` is compiled at first use for
``sm_90a`` into ``build/harp_tpu_torch_kernels/`` at the repository root,
under a name keyed by the hash of the source and of the headers it
includes from ``csrc/``, so an edited source or header is rebuilt and an
unchanged one is reused. :func:`build_all` starts one ``nvcc`` per source
at once and waits for all of them. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "harp_tpu_torch_kernels"
SOURCES = {"kmeans_stats": "kmeans_stats.cu", "dense_mf_hop": "dense_mf_hop.cu",
           "spd_solve": "spd_solve.cu", "flash_attention": "flash_attention.cu",
           "ring_dma": "ring_dma.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           f"{home}/bin): the CUDA kernels cannot be built")
    return str(path)


def _target(name: str) -> Path:
    text = (CSRC / SOURCES[name]).read_bytes()
    headers = sorted(set(re.findall(rb'#include "([\w.]+)"', text)))
    for h in headers:
        text += (CSRC / h.decode()).read_bytes()
    digest = hashlib.sha1(text + " ".join(NVCC_FLAGS).encode()
                          ).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all() -> Dict[str, dict]:
    """Compile every source that has no up-to-date library, all in parallel.

    Returns, per kernel, the library path, whether it was built now, the
    seconds its build took and nvcc's output (``-Xptxas -v``: registers,
    shared memory and spills of each kernel)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, running = {}, {}
    for name in SOURCES:
        target = _target(name)
        if target.exists():
            log = target.with_suffix(".log")
            out[name] = {"path": str(target), "built": False, "seconds": 0.0,
                         "log": log.read_text() if log.exists() else ""}
            continue
        tmp = target.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, target, time.perf_counter())
    for name, (proc, tmp, target, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCES[name]} "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, target)
        target.with_suffix(".log").write_text(log)
        out[name] = {"path": str(target), "built": True, "seconds": seconds,
                     "log": log}
    return out


def library(name: str) -> ctypes.CDLL:
    """Load the library of kernel ``name``, built first if needed (the
    kernel's wrapper keeps the handle)."""
    target = _target(name)
    if not target.exists():
        build_all()
    return ctypes.CDLL(str(target))
