"""The port's streaming ingestion (``io/pipeline.py``), the stream-fed
K-means fits, ``run kmeans --stream`` and the ingest bench, against the JAX
package's on the CPU.

Mirrors ``tests/test_pipeline.py``: bounded-queue backpressure (a stop with
a full output queue, a reorder buffer deeper than the queue with
completions out of order), a chunk stream identical at 1, 2 and 4 threads
and to the JAX ``StreamLoader``'s (index, offset, rows, bytes), the count
pass, ``memory://`` part-files, ``fit_from_stream`` bitwise the port's
``fit`` (float32 and bf16, W = 1 and 4, with and without the prefetcher)
and within rtol 1e-5 of the JAX ``fit_from_stream`` (the whole-fit
tolerance of ``tests/test_torch_kmeans.py``), ``fit_stream_minibatch``
within 1e-5 of the JAX one, the device COO regroup and the distributed
COO->CSR at W = 4 bitwise the JAX package's, and the CLI against
``harp_tpu.run``. On the CPU ``DevicePrefetcher`` places with a plain copy;
its CUDA steps run on the card (``chip_smoke.py``'s ``[ingest]``).
"""

import os
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harp_tpu import run as jrun
from harp_tpu.io import pipeline as jpl
from harp_tpu.models import kmeans as jkm
from harp_tpu.session import HarpSession as JaxSession
from harp_tpu_torch import run as trun
from harp_tpu_torch.benchmark import ingest
from harp_tpu_torch.io import loaders
from harp_tpu_torch.io import pipeline as pl
from harp_tpu_torch.models import kmeans as tkm
from harp_tpu_torch.sched.dynamic import DynamicScheduler, Task
from harp_tpu_torch.session import HarpSession as TorchSession


def _write_parts(tmp_path, sizes, d=6, seed=7):
    rng = np.random.default_rng(seed)
    paths = []
    for i, n in enumerate(sizes):
        path = tmp_path / f"part-{i:03d}"
        np.savetxt(path, rng.standard_normal((n, d)).astype(np.float32),
                   fmt="%.6f", delimiter=",")
        paths.append(str(path))
    return paths, loaders.load_dense_csv(paths)


def _bitwise(a, b):
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


class _Echo(Task):
    def run(self, item):
        return item


# --------------------------------------------------------------------------- #
# Reader-pool backpressure (DynamicScheduler out_capacity)
# --------------------------------------------------------------------------- #

def test_scheduler_bounded_output_backpressures_and_delivers():
    sched = DynamicScheduler([_Echo() for _ in range(4)], out_capacity=2)
    sched.start()
    try:
        sched.submit_all(range(32))
        time.sleep(0.3)
        # producers are instant: unbounded, all 32 results would be waiting
        assert sched._out.maxsize == 2
        assert sched._out.qsize() <= 2
        assert sorted(sched.wait_for_output() for _ in range(32)) == \
            list(range(32))
    finally:
        sched.stop()


def test_scheduler_stop_with_full_output_queue_does_not_deadlock():
    sched = DynamicScheduler([_Echo() for _ in range(2)], out_capacity=1)
    sched.start()
    sched.submit_all(range(16))
    time.sleep(0.2)        # the workers now block publishing into the bound
    t0 = time.perf_counter()
    done = threading.Thread(target=sched.stop)
    done.start()
    done.join(timeout=10.0)
    assert not done.is_alive() and time.perf_counter() - t0 < 10.0
    assert sched._submitted == sched._out.qsize()


def test_stream_loader_backpressure_bound(tmp_path):
    paths, whole = _write_parts(tmp_path, [40] * 8)
    loader = pl.StreamLoader(paths, chunk_rows=16, num_threads=4,
                             queue_depth=2)
    it = iter(loader)
    first = next(it)
    time.sleep(0.3)        # the consumer stalls; the pool may NOT run ahead
    assert loader._sched._out.qsize() <= 2
    rest = list(it)        # drain: every row still arrives, in order
    flat = np.concatenate([c.data[:c.rows] for c in [first] + rest])
    np.testing.assert_array_equal(flat, whole)


def test_reorder_buffer_drains_out_of_order_completions(tmp_path,
                                                        monkeypatch):
    """queue_depth 1 < num_threads 4, and later files finish first: the
    reorder buffer still drains and restores path order."""
    paths, whole = _write_parts(tmp_path, [9, 4, 11, 7, 5, 8])
    read = pl._read_part
    order = []

    def slow_first(path, sep, metrics):
        idx = paths.index(path)
        time.sleep(0.02 * (len(paths) - idx))      # file 0 is the slowest
        out = read(path, sep, metrics)
        order.append(idx)
        return out

    monkeypatch.setattr(pl, "_read_part", slow_first)
    chunks = list(pl.StreamLoader(paths, chunk_rows=10, num_threads=4,
                                  queue_depth=1))
    assert order != sorted(order)                   # completions out of order
    flat = np.concatenate([c.data[:c.rows] for c in chunks])
    np.testing.assert_array_equal(flat, whole)


# --------------------------------------------------------------------------- #
# Chunk determinism + counting pass
# --------------------------------------------------------------------------- #

def _snapshot(chunks):
    return [(c.index, c.offset, c.rows, np.asarray(c.data).copy())
            for c in chunks]


def test_chunk_stream_deterministic_and_the_jax_stream(tmp_path):
    sizes = [37, 5, 64, 1, 23]          # ragged on purpose
    paths, whole = _write_parts(tmp_path, sizes)
    ref = _snapshot(pl.StreamLoader(paths, chunk_rows=32, serial=True))
    jref = _snapshot(jpl.StreamLoader(paths, chunk_rows=32, serial=True))
    for kw in ({"num_threads": 1}, {"num_threads": 2}, {"num_threads": 4},
               {"num_threads": 4, "queue_depth": 1}):
        for got in (_snapshot(pl.StreamLoader(paths, chunk_rows=32, **kw)),
                    jref):
            assert [g[:3] for g in got] == [r[:3] for r in ref]
            for g, r in zip(got, ref):
                assert g[3].tobytes() == r[3].tobytes()
    # fixed budget shape everywhere, zero-padded tail, exact coverage
    assert all(r[3].shape == (32, whole.shape[1]) for r in ref)
    assert sum(r[2] for r in ref) == sum(sizes)
    flat = np.concatenate([r[3][:r[2]] for r in ref])
    np.testing.assert_array_equal(flat, whole)
    tail = ref[-1]
    assert not tail[3][tail[2]:].any()
    nbytes = [c.nbytes for c in pl.StreamLoader(paths, chunk_rows=32)]
    assert nbytes == [c.nbytes for c in jpl.StreamLoader(paths,
                                                         chunk_rows=32)]


def test_count_pass_totals(tmp_path):
    paths, whole = _write_parts(tmp_path, [10, 3, 9])
    loader = pl.StreamLoader(paths, chunk_rows=8)
    assert loader.total_rows == len(whole)
    assert loader.num_cols == whole.shape[1]
    assert loader.metrics.timing("ingest.count")["count"] == 1
    assert pl.StreamLoader(paths, count=False).total_rows is None
    with pytest.raises(ValueError, match="chunk_rows"):
        pl.StreamLoader(paths, chunk_rows=0)


def test_stream_over_memory_urls():
    """Object-store part-files ride the same pool (the fsspec read timed as
    ingest.read, no native fast path, no counting pass)."""
    import fsspec

    fs = fsspec.filesystem("memory")
    rng = np.random.default_rng(11)
    blocks = []
    try:
        for i in range(3):
            block = rng.standard_normal((12, 4)).astype(np.float32)
            blocks.append(block)
            with fsspec.open(f"memory://harp_torch_pl/part-{i:02d}", "w") as f:
                for row in block:
                    f.write(",".join(f"{v:.6f}" for v in row) + "\n")
        paths = loaders.list_files("memory://harp_torch_pl/")
        loader = pl.StreamLoader(paths, chunk_rows=10, num_threads=2)
        assert loader.total_rows is None        # no native count over URLs
        chunks = _snapshot(loader)
        flat = np.concatenate([c[3][:c[2]] for c in chunks])
        np.testing.assert_allclose(flat, np.concatenate(blocks), atol=1e-5)
        assert loader.metrics.timing("ingest.read")["count"] == 3
        jchunks = _snapshot(jpl.StreamLoader(paths, chunk_rows=10))
        assert [c[:3] for c in chunks] == [c[:3] for c in jchunks]
        for a, b in zip(chunks, jchunks):
            assert a[3].tobytes() == b[3].tobytes()
    finally:
        fs.rm("/harp_torch_pl", recursive=True)


# --------------------------------------------------------------------------- #
# Stream-fed K-means
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def stream_data(tmp_path_factory):
    return _write_parts(tmp_path_factory.mktemp("stream"), [50, 17, 30],
                        d=5)


@pytest.mark.parametrize("w", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fit_from_stream_bitwise_the_in_memory_fit(stream_data, w, dtype):
    paths, whole = stream_data
    sess = TorchSession(num_workers=w, device="cpu")
    pts = loaders.truncate_to_workers(whole, w)
    cen0 = whole[:4].copy()
    model = tkm.KMeans(sess, tkm.KMeansConfig(
        num_centroids=4, dim=5, iterations=3, compute_dtype=dtype))
    ref = model.fit(pts, cen0)
    _bitwise(pl.assemble_stream(sess, pl.StreamLoader(paths, chunk_rows=24),
                                len(pts), 5, dtype),
             model.prepare(pts, cen0)[0])
    for wrap in (lambda ld: ld,
                 lambda ld: pl.DevicePrefetcher(ld, sess.replicate_put),
                 lambda ld: pl.DevicePrefetcher(ld, sess.replicate_put,
                                                enabled=False)):
        loader = pl.StreamLoader(paths, chunk_rows=24, num_threads=3)
        got = model.fit_from_stream(wrap(loader), cen0, len(pts))
        for a, b in zip(got, ref):
            _bitwise(a, b)


def test_fit_from_stream_matches_jax(stream_data):
    paths, whole = stream_data
    pts = loaders.truncate_to_workers(whole, 4)
    cen0 = whole[:4].copy()
    sess = TorchSession(num_workers=4, device="cpu")
    model = tkm.KMeans(sess, tkm.KMeansConfig(4, 5, 3))
    cen, costs = model.fit_from_stream(
        pl.DevicePrefetcher(pl.StreamLoader(paths, chunk_rows=24),
                            sess.replicate_put), cen0, len(pts))
    jsess = JaxSession(num_workers=4)
    jmodel = jkm.KMeans(jsess, jkm.KMeansConfig(4, 5, 3))
    jcen, jcosts = jmodel.fit_from_stream(
        jpl.DevicePrefetcher(jpl.StreamLoader(paths, chunk_rows=24),
                             jsess.replicate_put), cen0, len(pts))
    np.testing.assert_allclose(cen.numpy(), np.asarray(jcen), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(costs.numpy(), np.asarray(jcosts), rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fit_stream_minibatch_matches_jax(tmp_path, dtype):
    paths, whole = _write_parts(tmp_path, [64, 64, 40], d=4, seed=3)
    sess = TorchSession(num_workers=4, device="cpu")
    model = tkm.KMeans(sess, tkm.KMeansConfig(
        num_centroids=3, dim=4, iterations=1, compute_dtype=dtype))
    cen, costs = model.fit_stream_minibatch(
        pl.StreamLoader(paths, chunk_rows=32), whole[:3])
    assert cen.shape == (3, 4) and np.isfinite(cen).all()
    assert costs.shape == (6,) and np.isfinite(costs).all()
    # the serialized and the prefetched twins are bitwise each other
    for enabled in (False, True):
        got = model.fit_stream_minibatch(pl.DevicePrefetcher(
            pl.StreamLoader(paths, chunk_rows=32, serial=not enabled),
            sess.scatter, enabled=enabled), whole[:3])
        for a, b in zip(got, (cen, costs)):
            np.testing.assert_array_equal(a, b)
    jsess = JaxSession(num_workers=4)
    jcen, jcosts = jkm.KMeans(jsess, jkm.KMeansConfig(
        num_centroids=3, dim=4, iterations=1, compute_dtype=dtype)
    ).fit_stream_minibatch(jpl.StreamLoader(paths, chunk_rows=32), whole[:3])
    np.testing.assert_allclose(cen, jcen, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(costs, jcosts, rtol=1e-5)
    with pytest.raises(ValueError, match="divide over"):
        model.fit_stream_minibatch(pl.StreamLoader(paths, chunk_rows=30),
                                   whole[:3])


def test_prefetcher_propagates_producer_error_and_closes():
    sess = TorchSession(device="cpu")

    def boom():
        yield pl.Chunk(0, 0, 4, np.zeros((4, 2), np.float32), 32)
        raise RuntimeError("parse exploded")

    pre = pl.DevicePrefetcher(boom(), sess.replicate_put)
    assert isinstance(next(pre).data, torch.Tensor)
    with pytest.raises(RuntimeError, match="parse exploded"):
        for _ in pre:
            pass
    many = (pl.Chunk(i, 4 * i, 4, np.zeros((4, 2), np.float32), 32)
            for i in range(100))
    pre = pl.DevicePrefetcher(many, sess.replicate_put, depth=1)
    next(pre)
    pre.close()                 # an early exit stops the placing thread
    assert not pre._thread.is_alive()


def test_assemble_stream_validates_and_drops_rows_past_the_total():
    sess = TorchSession(num_workers=2, device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        pl.assemble_stream(sess, [], 3, 8)
    data = np.arange(24, dtype=np.float32).reshape(6, 4)
    chunks = [pl.Chunk(0, 0, 4, data[:4], 64), pl.Chunk(1, 4, 2, data[4:], 32)]
    got = pl.assemble_stream(sess, chunks, 4, 5)
    np.testing.assert_array_equal(got[:, :4].numpy(), data[:4])
    assert not got[:, 4].any()
    with pytest.raises(ValueError, match="cols"):
        pl.assemble_stream(sess, chunks, 4, 3)


# --------------------------------------------------------------------------- #
# Distributed COO -> CSR
# --------------------------------------------------------------------------- #

def test_pack_unpack_coo_roundtrip(rng):
    rows = rng.integers(0, 2 ** 40, 100)
    cols = rng.integers(0, 2 ** 40, 100)
    vals = rng.standard_normal(100).astype(np.float32)
    rec = pl.pack_coo(rows, cols, vals)
    np.testing.assert_array_equal(rec, jpl.pack_coo(rows, cols, vals))
    r, c, v = pl.unpack_coo(rec)
    np.testing.assert_array_equal(r, rows)
    np.testing.assert_array_equal(c, cols)
    np.testing.assert_array_equal(v, vals)


def _coo(rng, num_rows, ncols, nnz):
    return (rng.integers(0, num_rows, nnz).astype(np.int64),
            rng.integers(0, ncols, nnz).astype(np.int64),
            rng.standard_normal(nnz).astype(np.float32))


def test_regroup_coo_device_matches_jax_and_the_host_oracle(rng):
    num_rows, nnz = 101, 4000           # ragged last block on purpose
    rows, cols, vals = _coo(rng, num_rows, 57, nnz)
    sess = TorchSession(num_workers=4, device="cpu")
    got = pl.regroup_coo_device(sess, rows, cols, vals, num_rows=num_rows,
                                chunk_bytes=2048)
    ref = jpl.regroup_coo_device(JaxSession(num_workers=4), rows, cols, vals,
                                 num_rows=num_rows, chunk_bytes=2048)
    block = -(-num_rows // 4)
    owner = np.minimum(rows // block, 3)
    assert len(got) == 4
    for wi in range(4):
        m = owner == wi                 # host oracle: same order, nnz for nnz
        for a, b, o in zip(got[wi], ref[wi], (rows[m], cols[m], vals[m])):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, o)
    empty = pl.regroup_coo_device(sess, np.empty(0, np.int64),
                                  np.empty(0, np.int64),
                                  np.empty(0, np.float32))
    assert len(empty) == 4 and all(len(r) == 0 for r, _, _ in empty)


def test_coo_to_csr_distributed_matches_jax_and_per_block_oracle(rng):
    num_rows, nnz = 96, 3000
    rows, cols, vals = _coo(rng, num_rows, 33, nnz)
    got = pl.coo_to_csr_distributed(TorchSession(num_workers=4, device="cpu"),
                                    rows, cols, vals, num_rows=num_rows)
    ref = jpl.coo_to_csr_distributed(JaxSession(num_workers=4), rows, cols,
                                     vals, num_rows=num_rows)
    block = num_rows // 4
    for wi in range(4):
        m = (rows >= wi * block) & (rows < (wi + 1) * block)
        oracle = loaders.coo_to_csr(rows[m] - wi * block, cols[m], vals[m],
                                    num_rows=block)
        for a, b, o in zip(got[wi], ref[wi], oracle):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, o)


def test_coo_to_csr_numpy_fallback_uses_bincount(monkeypatch):
    from harp_tpu_torch.io import native_bridge

    rows = np.array([3, 0, 3, 1, 0], np.int64)
    cols = np.array([1, 2, 0, 4, 3], np.int64)
    vals = np.array([1, 2, 3, 4, 5], np.float32)
    expect = loaders.coo_to_csr(rows, cols, vals, num_rows=5)
    monkeypatch.setattr(native_bridge, "coo_to_csr", lambda *a, **k: None)
    ip, ix, v = loaders.coo_to_csr(rows, cols, vals, num_rows=5)
    for a, b in zip((ip, ix, v), expect):
        np.testing.assert_array_equal(a, b)
    assert ip.tolist() == [0, 2, 3, 3, 5, 5]
    assert ix.tolist() == [2, 3, 4, 1, 0]      # stable within each row


# --------------------------------------------------------------------------- #
# The CLI and the bench row
# --------------------------------------------------------------------------- #

def test_run_kmeans_stream_matches_jax(tmp_path, capsys):
    data = tmp_path / "pts"
    data.mkdir()
    _write_parts(data, [60, 45, 70], d=6, seed=12)
    (data / "_README").write_text("skipped\n")
    argv = ["kmeans", "--stream", "--points-file", str(data),
            "--chunk-rows", "32", "--num-centroids", "4", "--iterations",
            "3", "--num-workers", "4"]
    assert jrun.main(argv + ["--work-dir", str(tmp_path / "j")]) == 0
    jline = capsys.readouterr().out.strip().splitlines()[-1]
    assert trun.main(argv + ["--device", "cpu", "--work-dir",
                             str(tmp_path / "t")]) == 0
    tline = capsys.readouterr().out.strip().splitlines()[-1]
    head = "kmeans[stream/regroupallgather] workers=4 n=172 k=4 d=6 " \
        "chunk_rows=32:"
    assert tline.startswith(head) and jline.startswith(head)
    jc, tc = (np.loadtxt(tmp_path / s / "centroids.csv", delimiter=",")
              for s in ("j", "t"))
    np.testing.assert_allclose(tc, jc[:, :6], rtol=1e-5, atol=1e-6)
    jr = [float(s) for s in jline.split("cost ")[1].split(" -> ")]
    tr = [float(s) for s in tline.split("cost ")[1].split(" -> ")]
    np.testing.assert_allclose(tr, jr, atol=0.1)
    for bad, msg in ((["--stream"], "requires --points-file"),
                     (["--stream", "--points-file", str(data),
                       "--save-every", "2", "--work-dir", str(tmp_path)],
                      "checkpointing applies")):
        with pytest.raises(SystemExit):
            trun.main(["kmeans", "--device", "cpu"] + bad)
        assert msg in capsys.readouterr().err


def test_bench_ingest_row_on_the_cpu(tmp_path):
    row = ingest.bench_ingest(total_mb=2, d=16, k=8, parts=4,
                              chunk_rows=2048, num_threads=2,
                              tmpdir=str(tmp_path), device="cpu")
    for key in ("stream_load_mb_per_sec", "serialized_wall_s",
                "overlapped_wall_s", "overlap_efficiency", "overlap_gate",
                "overlap_note", "e2e_stream_fit_wall_s", "stages",
                "regroup", "csv_bytes", "total_rows", "chunks", "config"):
        assert key in row, key
    assert row["device"] == "cpu" and row["cpu_count"] == os.cpu_count()
    assert row["chunks"] == -(-row["total_rows"] // 2048)
    assert {"nnz", "wall_s", "wire_bytes", "rounds"} <= set(row["regroup"])
    assert row["stages"]["parse"]["count"] == 4
    assert row["stages"]["compute"]["count"] == 1
    assert len(os.listdir(tmp_path)) == 4       # the caller's directory stays
