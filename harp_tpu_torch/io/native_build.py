"""Build the native loader: ``python -m harp_tpu_torch.io.native_build
[--force]``.

Port of ``harp_tpu/io/native_build.py``. It compiles the repository's shared
C++ source ``native/loader.cpp`` with g++ (the JAX module's flags) into
``build/harp_tpu_torch_native/`` at the repository root, under a name keyed
by the hash of the source and the flags, so an edited source is rebuilt and
an unchanged one reused. The library is written under a temporary name and
moved into place with ``os.replace``, so processes building at once never
load a half-written file. Nothing is written under ``native/``. Reference
parity: Harp shipped its native libraries prebuilt and loaded them at worker
start (data_aux/Initialize.loadDistributedLibs:67-84); here the host builds
from source.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Optional

REPO = Path(__file__).resolve().parents[2]
SOURCE = REPO / "native" / "loader.cpp"
BUILD_DIR = REPO / "build" / "harp_tpu_torch_native"
FLAGS = ["-O3", "-std=c++17", "-fPIC", "-pthread", "-shared"]


def _compiler() -> Optional[str]:
    return os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")


def lib_path() -> Path:
    """Where the library of the current source and flags lives."""
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(FLAGS).encode()
                          ).hexdigest()[:12]
    return BUILD_DIR / f"libharp_native-{digest}.so"


def build(force: bool = False) -> Optional[str]:
    """Compile the library unless it is built already; returns its path, or
    None without a compiler or when the compile fails (the loaders then
    parse with numpy)."""
    out = lib_path()
    if out.exists() and not force:
        return str(out)
    cxx = _compiler()
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    proc = subprocess.run([cxx, *FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        # a failing compile degrades to the numpy parse, exactly like the
        # no-compiler path, rather than crashing the caller
        print(f"native loader compile failed:\n{proc.stderr}",
              file=sys.stderr)
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)
    return str(out)


if __name__ == "__main__":
    path = build(force="--force" in sys.argv)
    if path is None:
        print("no C++ compiler found, or the compile failed; native loader "
              "unavailable", file=sys.stderr)
        sys.exit(1)
    print(path)
