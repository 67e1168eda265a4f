"""Checkpoint / resume: step directories of numpy arrays with CRC manifests.

Port of ``harp_tpu/utils/checkpoint.py`` (reference parity, SURVEY §5: Harp
saved only final models, ``KMUtil.storeCentroids``; periodic
checkpoint/resume is an upgrade). The payload is the JAX package's numpy
format: ``arrays.npz`` (one array a leaf, named ``"0"``, ``"1"``, ...) and
``manifest.json`` (leaf count, per-leaf CRC32, shape and dtype, and the
caller's ``meta``). A step directory written by the JAX package with
``use_orbax=False`` restores here, and one written here restores there.

Leaves are flattened in ``jax.tree.flatten``'s order: a dict by sorted
keys, a list or tuple in order, ``None`` holds no leaf, anything else is a
leaf. A tensor is copied to the host at :meth:`Checkpointer.save` (the
consistent cut; bf16 comes back as float32, numpy has no bf16), so the
background write of ``async_save`` never touches the device.

Departure from the JAX package: there is no orbax payload. A step directory
whose manifest has no ``arrays.npz`` beside it (an orbax step) verifies
False, as it does in the JAX package without orbax, and is skipped on
resume.

In a process group (``parallel/distributed.py``) every process calls
``save`` with the same state at the same step; process 0 writes, the
others return the path.

Usage::

    ckpt = Checkpointer(dir, async_save=True)
    ckpt.save(step, {"centroids": cen})    # returns once the copy is taken
    ...train next epochs...
    ckpt.wait()                            # join the in-flight write
    state = ckpt.restore_latest()          # None if no checkpoint
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

log = logging.getLogger("harp_tpu_torch.checkpoint")

# tmp dirs of OTHER writers younger than this survive _prune: they may
# belong to a live concurrent writer on a shared work dir; older ones are
# the leftovers of a writer killed mid-write
STALE_TMP_SECONDS = 3600.0

MANIFEST = "manifest.json"


# --------------------------------------------------------------------------- #
# Trees (jax.tree.flatten's order for dicts, lists, tuples and None)
# --------------------------------------------------------------------------- #

def _host(leaf) -> np.ndarray:
    """A leaf as a host ndarray of its own (a CPU tensor's ``numpy()``
    shares its memory, so the snapshot is copied: a caller updating the
    tensor in place after ``save`` must not reach the write)."""
    import torch

    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return np.array(leaf.cpu().numpy(), copy=True)
    return np.array(leaf, copy=True)


def tree_flatten(tree) -> List[Any]:
    """Leaves of ``tree`` in ``jax.tree.flatten``'s order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_flatten(t)]
    return [tree]


def tree_map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t) for t in tree)
    return fn(tree)


def tree_unflatten(like, leaves: List[Any]):
    """``like``'s structure with ``leaves`` in flatten order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(like)


# --------------------------------------------------------------------------- #
# Manifests and step directories
# --------------------------------------------------------------------------- #

def state_meta(state: Dict[str, Any], **extra) -> dict:
    """Manifest ``meta`` for a dict-of-arrays state: per-leaf shapes and
    dtypes plus the caller's fields (``world=``, ``model=``, layout
    geometry), so a resume at another world size can rebuild a restore
    template with the SAVED shapes (:func:`meta_like`)."""
    # the dtype a leaf is saved with, without copying a tensor off the device
    empty = {k: _host(v.reshape(-1)[:0]) if hasattr(v, "detach")
             else np.asarray(v) for k, v in state.items()}
    return {
        "shapes": {k: [int(d) for d in np.shape(v)] for k, v in state.items()},
        "dtypes": {k: str(e.dtype) for k, e in empty.items()},
        **extra,
    }


def meta_like(meta: dict) -> Dict[str, np.ndarray]:
    """A restore template (host zeros) with the saved leaves' shapes and
    dtypes, from a :func:`state_meta` manifest entry."""
    return {k: np.zeros(tuple(shape), np.dtype(meta["dtypes"][k]))
            for k, shape in meta["shapes"].items()}


def list_step_numbers(directory: str) -> List[int]:
    """Step numbers under ``directory`` (``step_NNN`` dirs), ascending."""
    out = []
    if os.path.isdir(directory):
        for name in os.listdir(directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append(int(m.group(1)))
    return sorted(out)


def _crc(arr) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def verify_step_dir(path: str, deep: bool = True) -> bool:
    """True iff the step directory's manifest checks out (leaf count and
    per-array CRC32), or it predates manifests (no manifest: trusted). A
    torn or bit-flipped step verifies False, so a resume falls back to the
    previous step. A manifest without ``arrays.npz`` (an orbax payload) is
    False: this package reads the numpy format only. ``deep`` is accepted
    for the JAX package's signature; the npz check always runs."""
    man_path = os.path.join(path, MANIFEST)
    if not os.path.exists(man_path):
        return True
    try:
        with open(man_path) as f:
            man = json.load(f)
        npz = os.path.join(path, "arrays.npz")
        if not os.path.exists(npz):
            return False
        with np.load(npz) as data:
            if len(data.files) != man["leaves"]:
                return False
            for i in range(man["leaves"]):
                if _crc(data[str(i)]) != man["arrays"][str(i)]["crc32"]:
                    return False
        return True
    except Exception:
        return False


def _load_manifest(path: str) -> Optional[dict]:
    man_path = os.path.join(path, MANIFEST)
    if not os.path.exists(man_path):
        return None
    with open(man_path) as f:
        return json.load(f)


def _leaves_match_manifest(man: dict, leaves) -> bool:
    if len(leaves) != man["leaves"]:
        return False
    return all(_crc(leaf) == man["arrays"][str(i)]["crc32"]
               for i, leaf in enumerate(leaves))


def latest_valid_step(directory: str, deep: bool = True) -> Optional[int]:
    """Newest step under ``directory`` whose manifest verifies."""
    for s in reversed(list_step_numbers(directory)):
        if verify_step_dir(os.path.join(directory, f"step_{s:012d}"), deep):
            return s
    return None


def _is_writer() -> bool:
    """Process 0 of a process group (or the only process) writes."""
    from harp_tpu_torch.parallel import distributed

    return distributed.process_index() == 0


class Checkpointer:
    """Step-indexed checkpoints of a tree of arrays, keeping the newest
    ``keep``."""

    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = False):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)
        self._executor = None
        self._pending = None
        if async_save:
            from concurrent.futures import ThreadPoolExecutor

            self._executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="harp-ckpt")

    # -- paths ---------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:012d}")

    def steps(self) -> list:
        self.wait()          # a just-saved checkpoint must be visible
        return list_step_numbers(self.directory)

    # -- save / restore ------------------------------------------------------
    def save(self, step: int, state: Any, meta: Optional[dict] = None) -> str:
        """Save a tree of arrays; prunes to the newest ``keep`` steps.

        ``meta`` (JSON-serialisable, see :func:`state_meta`) rides in the
        manifest. The host copy is taken here; with ``async_save`` the disk
        write runs on the background thread (one write in flight). In a
        process group only process 0 writes."""
        path = self._step_dir(step)
        if not _is_writer():
            return path
        state = tree_map(_host, state)
        if self._executor is not None:
            self.wait()
            self._pending = self._executor.submit(self._write, path, state,
                                                  meta)
        else:
            self._write(path, state, meta)
        return path

    def wait(self) -> None:
        """Join any in-flight background write (re-raises its error)."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def _write(self, path: str, state: Any,
               meta: Optional[dict] = None) -> None:
        # into a tmp dir, then a rename: a step dir exists only once it is
        # complete, and its manifest says whether it is intact
        tmp = f"{path}.tmp-{os.getpid()}"
        leaves = tree_flatten(state)
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{str(i): leaf for i, leaf in enumerate(leaves)})
        manifest = {
            "leaves": len(leaves),
            "arrays": {str(i): {"crc32": _crc(leaf),
                                "shape": list(np.shape(leaf)),
                                "dtype": str(np.asarray(leaf).dtype)}
                       for i, leaf in enumerate(leaves)},
        }
        if meta is not None:
            manifest["meta"] = meta
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f)
        if os.path.isdir(path):      # re-save of the same step
            shutil.rmtree(path)
        os.replace(tmp, path)
        self._prune()

    def restore(self, step: int, like: Optional[Any] = None) -> Any:
        """The step's leaves (host ndarrays), in ``like``'s structure when
        given, else as a list."""
        self.wait()
        path = self._step_dir(step)
        with np.load(os.path.join(path, "arrays.npz")) as data:
            leaves = [data[str(i)] for i in range(len(data.files))]
        return self._unflatten(path, leaves, like)

    def _require_leaf_count(self, path: str, count: int, like: Any) -> None:
        want = len(tree_flatten(like))
        if count != want:
            raise ValueError(
                f"checkpoint {path} holds {count} arrays but the "
                f"requested structure has {want} leaves — it was written "
                f"for a different state shape (wrong work dir, or the "
                f"model's state definition changed)")

    def _unflatten(self, path: str, leaves: List, like: Optional[Any]) -> Any:
        if like is None:
            return leaves
        self._require_leaf_count(path, len(leaves), like)
        return tree_unflatten(like, leaves)

    # -- integrity -----------------------------------------------------------
    def verify(self, step: int) -> bool:
        """Checksum-verify one step (manifest-less legacy dirs trusted)."""
        self.wait()
        return verify_step_dir(self._step_dir(step))

    def valid_steps(self) -> List[int]:
        """Steps that verify, oldest first (verifies every retained step:
        a diagnostic; resumes use :meth:`latest_valid_step`)."""
        out = []
        for s in self.steps():
            if verify_step_dir(self._step_dir(s)):
                out.append(s)
            else:
                log.warning("checkpoint step %d fails manifest verification "
                            "— skipping it for resume", s)
        return out

    def latest_valid_step(self) -> Optional[int]:
        """Newest step that verifies, scanning newest-first."""
        self.wait()
        for s in reversed(list_step_numbers(self.directory)):
            if verify_step_dir(self._step_dir(s)):
                return s
            log.warning("checkpoint step %d fails manifest verification "
                        "— skipping it for resume", s)
        return None

    def restore_latest_valid(self, like: Optional[Any] = None, *,
                             like_from_meta=None, return_meta: bool = False
                             ) -> Tuple:
        """``(step, state)`` of the newest step whose payload verifies,
        reading each candidate once; corrupt, torn or unreadable steps are
        logged and skipped. ``(None, None)`` when nothing usable exists.

        ``like_from_meta(meta)`` builds the restore template per candidate
        step from its manifest ``meta`` (None for meta-less steps),
        overriding ``like``: a step written at another world size holds
        leaves of the SAVED shapes. ``return_meta=True`` appends the step's
        meta: ``(step, state, meta)``."""
        self.wait()
        for s in reversed(list_step_numbers(self.directory)):
            path = self._step_dir(s)
            try:
                man = _load_manifest(path)
            except Exception as e:
                log.warning("checkpoint step %d has an unreadable manifest "
                            "(%r) — skipping it for resume", s, e)
                continue
            meta = man.get("meta") if man is not None else None
            eff_like = like_from_meta(meta) if like_from_meta is not None \
                else like
            if man is not None and eff_like is not None:
                # before the load: a structure mismatch raises, it is not
                # skipped as corruption (which would retrain from scratch)
                self._require_leaf_count(path, man["leaves"], eff_like)
            try:
                with np.load(os.path.join(path, "arrays.npz")) as data:
                    leaves = [data[str(i)] for i in range(len(data.files))]
            except Exception as e:
                log.warning("checkpoint step %d failed to load (%r) — "
                            "skipping it for resume", s, e)
                continue
            if man is not None and not _leaves_match_manifest(man, leaves):
                log.warning("checkpoint step %d fails manifest verification "
                            "— skipping it for resume", s)
                continue
            state = self._unflatten(path, leaves, eff_like)
            return (s, state, meta) if return_meta else (s, state)
        return (None, None, None) if return_meta else (None, None)

    def restore_latest(self, like: Optional[Any] = None) -> Optional[Any]:
        return self.restore_latest_valid(like=like)[1]

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def _prune(self) -> None:
        # runs on the writer thread under async_save: must not call steps()
        # (its wait() would join the writer's own future)
        steps = list_step_numbers(self.directory)
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
        now = time.time()
        for name in os.listdir(self.directory):
            # a foreign tmp dir may belong to a live writer on a shared
            # work dir: only reap those old enough that any live write
            # would long have renamed them away
            if ".tmp-" not in name or name.endswith(f"tmp-{os.getpid()}"):
                continue
            path = os.path.join(self.directory, name)
            try:
                age = now - os.path.getmtime(path)
            except OSError:
                continue          # racing rename/delete
            if age >= STALE_TMP_SECONDS:
                shutil.rmtree(path, ignore_errors=True)
