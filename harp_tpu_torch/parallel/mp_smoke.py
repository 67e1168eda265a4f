"""Multi-process gang smoke routine: the runnable proof of the process group.

Port of ``harp_tpu/parallel/mp_smoke.py``. Reference parity: Harp's
integration harness, one JVM a worker launched by ``collective/Driver.java``
with every collective class shipping a standalone ``main()``. Run it under
the launcher::

    python -m harp_tpu_torch.parallel.launch --nproc P \
        --workers-per-process W_local -- \
        python -m harp_tpu_torch.parallel.mp_smoke [--device cpu]

Each process joins the gang (``parallel.distributed.initialize`` through
``HarpSession(distributed=True)``) with W = P * W_local workers, builds the
same session stacked in one process beside it, and checks, across the
process boundary:

* every collective of ``collectives/lax_ops.py`` against numpy and bitwise
  against the stacked group at the same W;
* the fused ring-DMA ops (``ops/ring_dma.py``): ``hop`` at three shifts,
  ``hop_tree`` on a tree of f32, bf16 and int32 leaves and
  ``ring_allgather``, bitwise against the stacked group (on the card: the
  kernels between processes);
* one K-means iteration in each of the five comm variants, bitwise the
  stacked group's;
* small SGD-MF fits with ``fused_dma=True`` (dense, 1 and 2 slices; on the
  CPU also sparse), bitwise the stacked fused and unfused fits;
* ``HarpSession.barrier`` and a clean ``distributed.shutdown``.

It prints ``MP_SMOKE OK p<i>/<n>``; any failure raises. The host event
control plane and the P2P transport of the JAX routine are not ported yet.
The device is CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch


def _bits(t) -> torch.Tensor:
    t = torch.as_tensor(t).detach().cpu().contiguous().reshape(-1)
    return t.view(torch.uint8)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _same(a, b, what: str) -> None:
    """Bitwise equality of two results (dtype, shape and bytes)."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    _check(a.dtype == b.dtype and a.shape == b.shape
           and torch.equal(_bits(a), _bits(b)),
           f"{what}: the process group differs from the stacked group")


def _global(sess, x: torch.Tensor) -> torch.Tensor:
    """A sharded result of ``sess`` in its global layout."""
    if not sess.workers.process_group:
        return x
    from harp_tpu_torch.parallel import distributed

    return distributed.gather_rows(x)


def _both(pg, st, fn, x, out_spec: str):
    """``fn`` of one sharded argument on the process group and on the
    stacked group, each result in its global layout."""
    outs = []
    for sess in (pg, st):
        if out_spec == "shard":
            outs.append(_global(sess, sess.run(
                fn, sess.scatter(x), in_specs=(sess.shard(),),
                out_specs=sess.shard())))
        else:
            outs.append(sess.run(fn, sess.scatter(x),
                                 in_specs=(sess.shard(),),
                                 out_specs=sess.replicate()))
    return outs


def collective_checks(pg, st) -> None:
    from harp_tpu_torch.collectives import lax_ops, table_ops
    from harp_tpu_torch.table import Table

    w = pg.num_workers
    data = np.arange(w * 3, dtype=np.float32).reshape(w, 3) + 1.0
    contrib = (np.arange(w * w * 2, dtype=np.float32).reshape(w, w * 2)
               * 0.37 - 1.5)
    # a sharded argument (W, ...) arrives stacked (W, 1, ...)
    cases = {
        "allreduce": (lambda x: lax_ops.allreduce(x[:, 0]), data, "rep",
                      data.sum(0)),
        "table allreduce": (
            lambda x: table_ops.allreduce(Table.local(
                x, num_workers=w)).trim(), data, "rep", data.sum(0)[None]),
        "allgather": (lax_ops.allgather, data, "rep", data),
        "allgather untiled": (lambda x: lax_ops.allgather(x, tiled=False),
                              data, "rep", data[:, None]),
        "rotate": (lambda x: lax_ops.rotate(x, 1), data, "shard",
                   np.roll(data, 1, axis=0)),
        "rotate -1": (lambda x: lax_ops.rotate(x, -1), data, "shard",
                      np.roll(data, -1, axis=0)),
        "broadcast": (lambda x: lax_ops.broadcast(x[:, 0], root=w - 1),
                      data, "rep", data[w - 1]),
        "reduce": (lambda x: lax_ops.reduce(x[:, 0], root=1 % w)[:, None],
                   data, "shard",
                   np.stack([data.sum(0) if i == 1 % w else np.zeros(3)
                             for i in range(w)]).astype(np.float32)),
        "reduce_scatter": (lambda x: lax_ops.reduce_scatter(x[:, 0]),
                           contrib, "shard", contrib.sum(0)),
        "all_to_all": (lambda x: lax_ops.all_to_all(x[:, 0])[:, None],
                       contrib, "shard",
                       contrib.reshape(w, w, 2).transpose(1, 0, 2).reshape(
                           w, w * 2)),
        "worker_id": (lambda x: lax_ops.worker_id()[:, None].float(), data,
                      "shard", np.arange(w, dtype=np.float32)),
    }
    for name, (fn, x, spec, want) in cases.items():
        got, ref = _both(pg, st, fn, x, spec)
        _same(got, ref, name)
        np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-6,
                                   err_msg=name)


def ring_dma_checks(pg, st) -> None:
    from harp_tpu_torch.ops import ring_dma

    w = pg.num_workers
    rng = np.random.default_rng(3)
    f32 = rng.standard_normal((w, 5, 7)).astype(np.float32)
    i32 = rng.integers(-1000, 1000, size=(w, 3)).astype(np.int32)
    odd = rng.integers(0, 255, size=(w, 13)).astype(np.uint8)
    for shift in (1, -1, 3):
        for name, x in (("f32", f32), ("int32", i32), ("uint8", odd)):
            got, ref = _both(pg, st, lambda a: ring_dma.hop(a, shift), x,
                             "shard")
            _same(got, ref, f"hop {name} shift {shift}")
            np.testing.assert_array_equal(got.cpu().numpy(),
                                          np.roll(x, shift, axis=0))

    def tree(a, b):
        out = ring_dma.hop_tree({"f": (a, a.to(torch.bfloat16)), "i": [b]})
        return out["f"][0], out["f"][1].float(), out["i"][0]

    outs = [sess.run(tree, sess.scatter(f32), sess.scatter(i32),
                     in_specs=(sess.shard(),) * 2,
                     out_specs=(sess.shard(),) * 3) for sess in (pg, st)]
    for got, ref in zip(*outs):
        _same(_global(pg, got), ref, "hop_tree")
    got, ref = _both(pg, st, ring_dma.ring_allgather, f32, "rep")
    _same(got, ref, "ring_allgather")
    np.testing.assert_array_equal(got.cpu().numpy(), f32)
    if pg.device.type == "cuda":
        ring_dma.check_errors()


def kmeans_checks(pg, st) -> None:
    from harp_tpu_torch.io import datagen
    from harp_tpu_torch.models import kmeans as km

    w = pg.num_workers
    pts = datagen.dense_points(w * 16, 8, seed=0, num_clusters=4)
    cen0 = datagen.initial_centroids(pts, 4, seed=1)
    for comm in km.COMM_VARIANTS:
        cfg = km.KMeansConfig(4, 8, iterations=1, comm=comm)
        got = km.KMeans(pg, cfg).fit(pts, cen0)
        ref = km.KMeans(st, cfg).fit(pts, cen0)
        for a, b in zip(got, ref):
            _same(a, b, f"K-means iteration ({comm})")
        _check(bool(torch.isfinite(got[0]).all()),
               f"finite centroids ({comm})")


def sgd_mf_checks(pg, st) -> None:
    from harp_tpu_torch.models import sgd_mf as smf

    w = pg.num_workers
    nr = w * 8
    rng = np.random.default_rng(7)
    flat = rng.choice(nr * nr, size=nr * 6, replace=False)
    rr, cc = np.divmod(flat, nr)
    vv = (rng.random(len(rr)) + 0.5).astype(np.float32)
    layouts = ("dense",) if pg.device.type == "cuda" else ("dense", "sparse")
    for layout in layouts:
        for ns in (1, 2):
            fits = []
            for sess, fused in ((pg, True), (st, True), (st, False)):
                cfg = smf.SGDMFConfig(rank=4, epochs=2, minibatches_per_hop=2,
                                      num_slices=ns, layout=layout,
                                      fused_dma=fused)
                fits.append(smf.SGDMF(sess, cfg).fit(rr, cc, vv, nr, nr))
            for other in fits[1:]:
                for a, b in zip(fits[0], other):
                    _same(torch.from_numpy(a), torch.from_numpy(b),
                          f"SGD-MF fit ({layout}, {ns} slices)")
            _check(bool(np.all(np.isfinite(fits[0][0]))), "finite factors")


def run(device=None) -> None:
    from harp_tpu_torch.parallel import distributed
    from harp_tpu_torch.session import HarpSession

    distributed.initialize()
    nproc, rank = distributed.process_count(), distributed.process_index()
    wl = int(os.environ.get("HARP_WORKERS_PER_PROCESS", "1"))
    pg = HarpSession(num_workers=nproc * wl, device=device, distributed=True)
    st = HarpSession(num_workers=nproc * wl, device=device)
    _check(pg.workers.workers_per_process == wl,
           f"{wl} workers a process ({pg.workers})")
    collective_checks(pg, st)
    ring_dma_checks(pg, st)
    kmeans_checks(pg, st)
    sgd_mf_checks(pg, st)
    pg.barrier()
    distributed.shutdown()
    print(f"MP_SMOKE OK p{rank}/{nproc}", flush=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m harp_tpu_torch.parallel."
                                     "mp_smoke")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    run(args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
