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

* every collective of ``collectives/lax_ops.py`` and
  ``Combiner.psum_like``, the key-value shuffle of
  ``collectives/table_ops.py`` (``group_by_key``, ``group_by_key_sharded``
  with and without overflow, a ``bucket_route``/``route_back`` round trip)
  against numpy and bitwise against the stacked group at the same W;
* ``models/stats``' ``Sorting``, ``Quantiles`` and a ``PCA`` fit, bitwise
  the stacked group's;
* the fused ring-DMA ops (``ops/ring_dma.py``): ``hop`` at three shifts,
  ``hop_tree`` on a tree of f32, bf16 and int32 leaves and
  ``ring_allgather``, bitwise against the stacked group (on the card: the
  kernels between processes);
* the two in-kernel ring sends (``pallas_kernels.dense_mf_hop`` and
  ``flash_attention`` with ``ring_hop=True``), bitwise the stacked group,
  whose sent blocks are bitwise ``torch.roll`` (on the card: the kernels'
  sends between processes and the receive kernel);
* one K-means iteration in each of the five comm variants, bitwise the
  stacked group's;
* small SGD-MF fits with ``fused_dma=True`` (dense, 1 and 2 slices; on the
  CPU also sparse), bitwise the stacked fused and unfused fits;
* the quantized wire format (``collectives/quantize.py``): ``allreduce``
  and ``reduce_scatter`` with a residual, ``allgather`` and ``rotate``,
  int8 and bf16, an error-fed ``rotate_scan``, the int8 K-means iteration
  of four variants and a quantized SGD-MF fit (1 and 2 slices), bitwise
  the stacked group's;
* a small NN fit (``models/nn.py``) and the five gradient solvers
  (``models/solvers.py``), bitwise the stacked group's;
* the bounded-round reshard (``collectives/reshard.py``, both schedules)
  through the gloo ``all_to_all`` and ``rotate``, and resumes of SGD-MF
  (1 and 2 slices) and LDA checkpoints written at 2W workers (process 0
  writes, every process reads; device, ring and host), bitwise the stacked
  group's;
* LDA fits (``models/lda.py``: CGS fused on 1 slice and on 2 slices, CVB0,
  the int8 topic-total wire), bitwise the stacked group's;
* the streamed K-means fits (``io/pipeline.py``): part-files written by
  process 0 streamed through ``DevicePrefetcher`` into
  ``KMeans.fit_from_stream`` (float32 and bf16) and
  ``fit_stream_minibatch``, and the device COO regroup behind
  ``coo_to_csr_distributed``, bitwise the stacked group's;
* the host event plane (``parallel/events.py``, the session's events):
  collective events and the transportless message across processes, and
  ``send_event(dest=...)`` refused until the P2P transport is ported; then
  telemetry over it: the gang's snapshot exchange, the straggler report
  from scripted step walls (rank 1 flagged), the ``GangCollector`` and an
  events-triggered profiler window a rank;
* ``HarpSession.barrier`` and a clean ``distributed.shutdown``.

It prints ``MP_SMOKE OK p<i>/<n>``; any failure raises. The P2P transport
of the JAX routine is not ported yet.
The device is CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
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
    from harp_tpu_torch import combiner
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
        "gather": (lambda x: lax_ops.gather(x, root=w - 1),
                   data, "shard",
                   np.stack([data if i == w - 1 else np.zeros_like(data)
                             for i in range(w)]).reshape(w * w, 3)),
        "rotate_map": (lambda x: lax_ops.rotate_map(
            x, {i: w - 1 - i for i in range(w)}), data, "shard",
            data[::-1]),
        "send_recv": (lambda x: lax_ops.send_recv(x, [(0, w - 1)]), data,
                      "shard", np.stack([data[0] if i == w - 1
                                         else np.zeros(3, np.float32)
                                         for i in range(w)])),
        "barrier": (lambda x: (lax_ops.barrier(), x)[1], data, "shard",
                    data),
        "psum_like multiply": (
            lambda x: combiner.MULTIPLY.psum_like(x[:, 0]), data, "rep",
            data.prod(0)),
    }
    # the key-value shuffle: records (key, 3 values) of small integers
    rng = np.random.default_rng(11)
    kv = rng.integers(-2, 3, size=(w * 24, 4)).astype(np.float32)
    kv[:, 0] = rng.integers(0, 10, size=w * 24)
    kv[::7, 0] = -1                               # dropped, not counted
    good = kv[:, 0] >= 0
    sums = np.zeros((10, 3), np.float32)
    np.add.at(sums, kv[good, 0].astype(int), kv[good, 1:])

    def keyed(fn):
        return lambda x: fn(x[..., 0].long(), x[..., 1:])

    def round_trip(x):
        dest = x[..., 0].long() % w
        (routed,), _, _, routing = table_ops.bucket_route(dest, 24, (x,))
        back, ok = table_ops.route_back(routed * 2.0, routing)
        return torch.cat([back, ok[..., None].float()], dim=-1)

    cases.update({
        "group_by_key": (keyed(lambda k, v: table_ops.group_by_key(k, v, 10)),
                         kv, "rep", sums),
        "group_by_key_sharded": (
            keyed(lambda k, v: table_ops.group_by_key_sharded(k, v, 10)[0]),
            kv, "rep", sums),
        "group_by_key_sharded overflow": (
            keyed(lambda k, v: table_ops.group_by_key_sharded(
                k * 0, v, 10, capacity=2)[1].float()[None]), kv, "rep",
            np.array([(w * 24 - w * 2)], np.float32)),
        "bucket_route round trip": (round_trip, kv, "shard",
                                    np.concatenate([2 * kv, np.ones(
                                        (w * 24, 1), np.float32)], axis=1)),
    })
    for name, (fn, x, spec, want) in cases.items():
        got, ref = _both(pg, st, fn, x, spec)
        _same(got, ref, name)
        np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-6,
                                   err_msg=name)


def stats_checks(pg, st) -> None:
    from harp_tpu_torch.models import stats

    w = pg.num_workers
    x = np.random.default_rng(13).standard_normal((w * 32, 6)).astype(
        np.float32)
    outs = [(stats.Sorting(sess).compute(x),
             stats.Quantiles(sess).compute(x, [0.0, 0.3, 0.5, 1.0]),
             *stats.PCA(sess).fit(x)) for sess in (pg, st)]
    for name, got, ref in zip(("Sorting", "Quantiles", "PCA eigenvalues",
                               "PCA components", "PCA mean"), *outs):
        _same(got, ref, name)
    np.testing.assert_array_equal(outs[0][0], np.sort(x, axis=0))


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


def ring_send_checks(pg, st) -> None:
    from harp_tpu_torch.ops import pallas_kernels as pk
    from harp_tpu_torch.ops import ring_dma

    w = pg.num_workers
    rng = np.random.default_rng(5)
    rpw, cpb, k, nmb = 16, 40, 6, 2
    v = rng.random((w, rpw, cpb)).astype(np.float32)
    v[rng.random(v.shape) < 0.7] = np.nan
    seen = ~np.isnan(v)
    mf = (v, rng.random((w * rpw, k)).astype(np.float32),
          rng.random((w * cpb, k)).astype(np.float32),
          seen.sum(2).astype(np.float32),
          seen.reshape(w, nmb, rpw // nmb, cpb).sum(2).astype(np.float32))

    def hop(slab, w_, h_, rc, cc):
        zero = torch.zeros(slab.shape[0], dtype=torch.int32,
                           device=slab.device)
        w_, h_, sse, h_next = pk.dense_mf_hop(
            slab.bfloat16(), zero, w_, h_, rc, cc, nmb, 0.05, 0.01,
            ring_hop=True)
        return w_, h_, sse[:, None], h_next

    l, h, d = 24, 2, 8
    qkv = [rng.standard_normal((w * l, h, d)).astype(np.float32)
           for _ in range(3)]
    cases = (("dense_mf_hop", hop, mf, 4),
             ("flash_attention", lambda a, b, c: pk.flash_attention(
                 a, b, c, True, return_stats=True, ring_hop=True), qkv, 5))
    for name, fn, arrays, nout in cases:
        outs, recv = [], []
        for sess in (pg, st):
            before = ring_dma.launches["ring_recv"]
            outs.append(sess.run(fn, *(sess.scatter(a) for a in arrays),
                                 in_specs=(sess.shard(),) * len(arrays),
                                 out_specs=(sess.shard(),) * nout))
            recv.append(ring_dma.launches["ring_recv"] - before)
        if pg.device.type == "cuda":
            _check(recv == [1, 0], f"{name} ring_hop: one receive launch on "
                   f"the process group, none stacked ({recv})")
        for i, (got, ref) in enumerate(zip(*outs)):
            _same(_global(pg, got), ref, f"{name} ring_hop, output {i}")
        # the stacked group's received blocks: its left neighbours' h' or k, v
        ref = outs[1]
        sent = ([(ref[3], ref[1])] if nout == 4
                else [(ref[3], arrays[1]), (ref[4], arrays[2])])
        for nxt, blk in sent:
            blk = torch.as_tensor(blk).cpu()
            _check(torch.equal(nxt.cpu(), torch.roll(blk, blk.shape[0] // w,
                                                     0)),
                   f"{name} ring_hop: each worker receives its left "
                   f"neighbour's block")
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


def quant_checks(pg, st) -> None:
    from harp_tpu_torch import combiner
    from harp_tpu_torch.collectives import lax_ops, quantize, rotation
    from harp_tpu_torch.io import datagen
    from harp_tpu_torch.models import kmeans as km
    from harp_tpu_torch.models import sgd_mf as smf

    w = pg.num_workers
    rng = np.random.default_rng(17)
    x = rng.standard_normal((w * w * 3, 37)).astype(np.float32)
    r = (rng.standard_normal(x.shape) * 0.01).astype(np.float32)
    for codec in ("int8", "bf16"):
        comm = quantize.CommConfig(codec)

        def ops(a, b):
            ar, ar_res = lax_ops.allreduce(a, combiner.AVG, comm=comm,
                                           residual=b)
            rs, rs_res = lax_ops.reduce_scatter(a, comm=comm, residual=b)
            ag = lax_ops.allgather(a, comm=comm)
            rot = lax_ops.rotate(a, 1, comm=comm)

            def body(c, blk, t):
                return c, (blk[0] * 0.5 + 1.0, blk[1] + 1)

            _, (f, i), res = rotation.rotate_scan(
                body, None, (a, a[..., :2].to(torch.int32)), w + 1,
                comm=comm, ef_state=rotation.ef_zero(
                    (a, a[..., :2].to(torch.int32))))
            return (ar, ag, ar_res, rs, rs_res, rot, f, i.float(), res[0])

        outs = []
        for sess in (pg, st):
            got = sess.run(ops, sess.scatter(x), sess.scatter(r),
                           in_specs=(sess.shard(),) * 2,
                           out_specs=(sess.replicate(),) * 2
                           + (sess.shard(),) * 7)
            outs.append([got[0], got[1]] + [_global(sess, t)
                                            for t in got[2:]])
        for i, (got, ref) in enumerate(zip(*outs)):
            _same(got, ref, f"quantized collective {i} ({codec})")
    pts = datagen.dense_points(w * 16, 8, seed=0, num_clusters=4)
    cen0 = datagen.initial_centroids(pts, 4, seed=1)
    for comm in ("regroupallgather", "allreduce", "pushpull", "rotation"):
        cfg = km.KMeansConfig(4, 8, iterations=2, comm=comm, quant="int8")
        for a, b in zip(km.KMeans(pg, cfg).fit(pts, cen0),
                        km.KMeans(st, cfg).fit(pts, cen0)):
            _same(a, b, f"quantized K-means ({comm})")
    nr = w * 8
    flat = rng.choice(nr * nr, size=nr * 6, replace=False)
    rr, cc = np.divmod(flat, nr)
    vv = (rng.random(len(rr)) + 0.5).astype(np.float32)
    for ns in (1, 2):
        cfg = smf.SGDMFConfig(rank=4, epochs=2, minibatches_per_hop=2,
                              num_slices=ns, layout="dense", quant="bf16",
                              fused_dma=True)
        for a, b in zip(smf.SGDMF(pg, cfg).fit(rr, cc, vv, nr, nr),
                        smf.SGDMF(st, cfg).fit(rr, cc, vv, nr, nr)):
            _same(torch.from_numpy(a), torch.from_numpy(b),
                  f"quantized SGD-MF fit ({ns} slices)")


def nn_solver_checks(pg, st) -> None:
    from harp_tpu_torch.io import datagen
    from harp_tpu_torch.models import nn, solvers

    w = pg.num_workers
    x, y = datagen.classification_data(w * 40, 10, 3, seed=5)
    cfg = nn.NNConfig(layers=(12, 6), num_classes=3, batch_size=16,
                      epochs=2)
    fits = []
    for sess in (pg, st):
        m = nn.MLPClassifier(sess, cfg)
        fits.append([torch.from_numpy(m.fit(x, y, seed=3))]
                    + [t for wb in m.params for t in wb])
    for i, (got, ref) in enumerate(zip(*fits)):
        _same(got, ref, f"NN fit, output {i}")
    xr, yr, _ = datagen.regression_data(w * 40, 6, seed=6)
    yr = yr.reshape(-1)
    for kind in ("sgd", "sgd_minibatch", "sgd_momentum", "adagrad", "lbfgs"):
        scfg = solvers.SolverConfig(iterations=12, batch_size=16, history=3)
        got, ref = (solvers.Solver(sess, kind, scfg).minimize(
            solvers.mse_objective, xr, yr, np.zeros(6, np.float32))
            for sess in (pg, st))
        for a, b in zip(got, ref):
            _same(torch.from_numpy(a), torch.from_numpy(b),
                  f"solver {kind}")


def _shared_dir(name: str) -> str:
    """A directory every process of this gang names alike (process 0
    writes into it; the coordinator's port keeps gangs apart)."""
    import tempfile

    port = os.environ.get("HARP_COORDINATOR", "local").replace(":", "_")
    return os.path.join(tempfile.gettempdir(), f"harp_mp_{port}", name)


def checkpoint_lda_checks(pg, st) -> None:
    from harp_tpu_torch.collectives import reshard as rs
    from harp_tpu_torch.io import datagen
    from harp_tpu_torch.models import lda
    from harp_tpu_torch.models import sgd_mf as smf
    from harp_tpu_torch.models.sgd_mf import serpentine_assign
    from harp_tpu_torch.session import HarpSession
    from harp_tpu_torch.utils.checkpoint import Checkpointer

    w = pg.num_workers
    rng = np.random.default_rng(23)
    n = 11 * w + 3
    old = rs.block_layout(serpentine_assign(rng.integers(1, 9, n), 2 * w),
                          7, 2 * w)
    new = rs.block_layout(serpentine_assign(rng.integers(1, 9, n), w),
                          n // w + 2, w)
    saved = rng.standard_normal((2 * w * 7, 3)).astype(np.float32)
    fill = rng.standard_normal((w * new.local_rows, 3)).astype(np.float32)
    for schedule in ("alltoall", "ring"):
        got, ref = (_global(sess, rs.reshard_factor(
            sess, saved, old, 2 * w, new, n, sess.scatter(fill),
            chunk_bytes=40, schedule=schedule)) for sess in (pg, st))
        _same(got, ref, f"reshard ({schedule})")

    # checkpoints written by a 2W stacked group (process 0 writes), resumed
    # at W on the process group and on the stacked group
    wide = HarpSession(num_workers=2 * w, device=pg.device)
    nr = w * 8
    flat = rng.choice(nr * nr, size=nr * 6, replace=False)
    rr, cc = np.divmod(flat, nr)
    vv = (rng.random(len(rr)) + 0.5).astype(np.float32)
    for ns in (1, 2):
        cfg = smf.SGDMFConfig(rank=4, epochs=2, minibatches_per_hop=2,
                              num_slices=ns, layout="sparse")
        path = _shared_dir(f"mf{ns}")
        m = smf.SGDMF(wide, cfg)
        m.fit_checkpointed(m.prepare(rr, cc, vv, nr, nr), Checkpointer(path))
        pg.barrier()
        for mode in ("device", "ring", "host"):
            c = dataclasses.replace(cfg, reshard=mode)
            outs = []
            for sess in (pg, st):
                m = smf.SGDMF(sess, c)
                w_f, h_f, _, start = m.fit_checkpointed(
                    m.prepare(rr, cc, vv, nr, nr), Checkpointer(path))
                _check(start == 2, "SGD-MF resumed at its last epoch")
                outs.append((w_f, h_f))
            for a, b in zip(*outs):
                _same(torch.from_numpy(a), torch.from_numpy(b),
                      f"SGD-MF resume from 2W ({ns} slices, {mode})")

    docs = datagen.lda_corpus(w * 4, 40, 3, 10, seed=2)
    base = dict(num_topics=6, vocab=40, epochs=2, minibatches_per_hop=2)
    path = _shared_dir("lda")
    m = lda.LDA(wide, lda.LDAConfig(**base))
    m.fit_checkpointed(m.prepare(docs, seed=1), Checkpointer(path))
    pg.barrier()
    for mode in ("device", "ring", "host"):
        outs = []
        for sess in (pg, st):
            m = lda.LDA(sess, lda.LDAConfig(**base, reshard=mode))
            dt, wt, _, start = m.fit_checkpointed(m.prepare(docs, seed=1),
                                                  Checkpointer(path))
            _check(start == 2, "LDA resumed at its last epoch")
            outs.append((dt, wt))
        for a, b in zip(*outs):
            _same(torch.from_numpy(a), torch.from_numpy(b),
                  f"LDA resume from 2W ({mode})")
    for kw in (dict(fused_dma=True), dict(num_model_slices=2, fused_dma=True),
               dict(method="cvb0"), dict(quant="int8")):
        fits = [lda.LDA(sess, lda.LDAConfig(**base, **kw)).fit(docs, seed=3)
                for sess in (pg, st)]
        for a, b in zip(*fits):
            _same(torch.from_numpy(a), torch.from_numpy(b), f"LDA fit {kw}")
        _check(bool(np.all(np.isfinite(fits[0][2]))),
               f"finite LDA log-likelihoods {kw}")
    pg.barrier()
    if pg.workers.rank == 0:
        import shutil

        shutil.rmtree(os.path.dirname(path), ignore_errors=True)


def stream_checks(pg, st) -> None:
    from harp_tpu_torch.io import datagen, loaders
    from harp_tpu_torch.io import pipeline as pl
    from harp_tpu_torch.models import kmeans as km

    w = pg.num_workers
    path = _shared_dir("stream")
    if pg.workers.rank == 0:
        os.makedirs(path, exist_ok=True)
        for i, n in enumerate((5 * w + 3, 2 * w, 7 * w + 1)):
            np.savetxt(os.path.join(path, f"part-{i}"),
                       datagen.dense_points(n, 6, seed=40 + i,
                                            num_clusters=3),
                       fmt="%.6f", delimiter=",")
    pg.barrier()
    paths = loaders.list_files(path)
    head = loaders.load_dense_csv(paths[:1])
    n_fit = pl.StreamLoader(paths).total_rows // w * w
    for dtype in ("float32", "bfloat16"):
        cfg = km.KMeansConfig(3, 6, iterations=2, compute_dtype=dtype)
        fits = [km.KMeans(sess, cfg).fit_from_stream(
            pl.DevicePrefetcher(pl.StreamLoader(paths, chunk_rows=2 * w),
                                sess.replicate_put), head[:3], n_fit)
            for sess in (pg, st)]
        for a, b in zip(*fits):
            _same(a, b, f"streamed K-means fit ({dtype})")
    fits = [km.KMeans(sess, km.KMeansConfig(3, 6)).fit_stream_minibatch(
        pl.DevicePrefetcher(pl.StreamLoader(paths, chunk_rows=2 * w),
                            sess.scatter), head[:3]) for sess in (pg, st)]
    for a, b in zip(*fits):
        _same(torch.from_numpy(a), torch.from_numpy(b),
              "minibatch streamed K-means fit")
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 37, 300)
    cols = rng.integers(0, 11, 300)
    vals = rng.standard_normal(300).astype(np.float32)
    got, ref = (pl.coo_to_csr_distributed(sess, rows, cols, vals,
                                          chunk_bytes=200)
                for sess in (pg, st))
    for g, r in zip(got, ref):
        for a, b in zip(g, r):
            _same(torch.from_numpy(a), torch.from_numpy(b),
                  "distributed COO->CSR")
    pg.barrier()
    if pg.workers.rank == 0:
        import shutil

        shutil.rmtree(path, ignore_errors=True)


def event_telemetry_checks(pg, st=None) -> dict:
    """The host event plane and telemetry across the gang: collective events
    (rank 0's payload, then the last rank's) reach every process; the
    transportless ``send_message`` reaches only its dest; a point-to-point
    ``send_event`` raises until the P2P transport is ported; the metric
    snapshots of every rank are exchanged and the straggler report, from
    scripted step walls (60 ms on rank 1, 1 ms elsewhere), flags exactly
    rank 1, by ``publish_straggler_report`` and by a ``GangCollector`` at
    its boundary, and process 0 writes it; a ``request_xprof`` window leaves
    a trace under each rank's directory. Returns a record of what ran."""
    from harp_tpu_torch import telemetry
    from harp_tpu_torch.parallel import distributed
    from harp_tpu_torch.parallel import events as ev
    from harp_tpu_torch.telemetry import gang, xprof
    from harp_tpu_torch.utils.metrics import Metrics

    nproc, rank = distributed.process_count(), distributed.process_index()
    pg.send_event({"from": rank, "hello": "gang"})
    e = pg.get_event()
    _check(e is not None and e.type is ev.EventType.COLLECTIVE
           and e.source == 0 and e.payload == {"from": 0, "hello": "gang"},
           f"a collective event from rank 0 reaches rank {rank} ({e})")
    last = nproc - 1
    pg.send_event(("x", rank, list(range(rank + 3))), source=last)
    e = pg.get_event()
    _check(e is not None and e.source == last
           and e.payload == ("x", last, list(range(last + 3))),
           f"a collective event from rank {last} reaches rank {rank}")
    pg.open_events()[1].send_message(1, ("msg", rank), source=0)
    e = pg.get_event()
    _check((e is not None and e.type is ev.EventType.MESSAGE
            and e.source == 0 and e.payload == ("msg", 0)) if rank == 1
           else e is None,
           f"the transportless message reaches rank 1 only (rank {rank})")
    try:
        pg.send_event("p2p", dest=(rank + 1) % nproc)
        refused = ""
    except NotImplementedError as err:
        refused = str(err)
    _check("queue 1 item 5" in refused,
           "send_event(dest=...) across processes raises, naming the P2P "
           "transport's queue item")
    pg.close_events()
    _check(pg.get_event() is None, "a closed event plane is empty")

    root = _shared_dir("telemetry")
    m = Metrics()
    log = telemetry.configure(root, interval=4, metrics=m, rank=rank)
    wall = 0.060 if rank == 1 else 0.001          # scripted, not measured
    for step in range(6):
        telemetry.record_chunk("smoke", start=step, losses=[float(step)],
                               wall_s=wall)
    snaps = gang.gather_snapshots(pg, metrics=m)
    _check(sorted(snaps) == list(range(nproc))
           and snaps[rank] == m.snapshot(),
           "every rank's snapshot gathered on every rank")
    # k = 1.5: with 2 ranks the median is the mean of both p50s, which the
    # default k = 2 can never exceed
    report = gang.publish_straggler_report(pg, root, metrics=m, k=1.5,
                                           snapshots=snaps)
    _check(report["suspects"] == [1] and report["num_ranks"] == nproc
           and (nproc == 2 or report["bsp_suspects"] == []),
           f"the straggler report flags rank 1 exactly ({report['suspects']}"
           f", bsp {report['bsp_suspects']})")
    pg.barrier()
    if rank == 0:
        on_disk = gang.read_straggler_report(root)
        _check(on_disk is not None and on_disk["suspects"] == [1],
               "process 0 wrote the straggler report")
    col = gang.GangCollector(pg, root, k=1.5)
    log.add_boundary_hook(col)
    for step in range(6, 8):                     # boundary 8: a publish
        telemetry.record_chunk("smoke", start=step, losses=[float(step)],
                               wall_s=wall)
    _check(col.last_report is not None
           and col.last_report["suspects"] == [1]
           and sorted(col.last_snapshots) == list(range(nproc)),
           "the GangCollector published at its boundary")
    log.flush()
    with open(log.path) as f:
        n_lines = len(f.read().strip().splitlines())
    _check(n_lines == 8, f"rank {rank}'s steps.jsonl holds 8 events")
    ctrl = xprof.XprofController(pg, rank=rank)
    xprof.request_xprof(pg, steps=2, directory=os.path.join(root, "xprof"))
    ctrl(1)
    _check(ctrl.tracing, "the xprof request opened a window")
    torch.ones(256, device=pg.device).cumsum(0).sum().item()
    ctrl(2)
    ctrl(3)
    _check(not ctrl.tracing and ctrl.trace_dir == os.path.join(
        root, "xprof", f"rank{rank}") and os.path.exists(ctrl.trace_path),
        f"rank {rank}'s profiler trace is under its directory")
    rec = {"suspects": report["suspects"],
           "bsp_suspects": report["bsp_suspects"],
           "trace_bytes": os.path.getsize(ctrl.trace_path)}
    telemetry.disable()
    pg.close_events()
    pg.barrier()                   # every rank has read its trace
    if rank == 0:
        import shutil

        shutil.rmtree(root, ignore_errors=True)
    return rec


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
    stats_checks(pg, st)
    ring_dma_checks(pg, st)
    ring_send_checks(pg, st)
    kmeans_checks(pg, st)
    sgd_mf_checks(pg, st)
    quant_checks(pg, st)
    nn_solver_checks(pg, st)
    stream_checks(pg, st)
    checkpoint_lda_checks(pg, st)
    event_telemetry_checks(pg, st)
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
