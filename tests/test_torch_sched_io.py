"""The port's schedulers (``sched/``) and loaders (``io/loaders.py``)
against the JAX package's, on the CPU.

Mirrors ``tests/test_sched_io.py``: the scheduler lifecycle cases (shared
queue, pause with and without a backlog, stop discarding a backlog, task
errors reaching the caller, pinned static queues), and every load (dense
CSV, COO, labeled CSV, the token corpus, ``memory://`` URLs through fsspec)
and the host COO transforms (``coo_to_csr``, ``regroup_coo_by_row``)
bitwise the JAX package's on the same seeded files.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from harp_tpu.io import datagen as jdatagen
from harp_tpu.io import loaders as jloaders
from harp_tpu_torch.io import loaders
from harp_tpu_torch.sched.dynamic import (AsyncPipeline, DynamicScheduler,
                                          Task, device_map)
from harp_tpu_torch.sched.static import StaticScheduler


class Square(Task):
    def run(self, x):
        return x * x


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


class TestDynamicScheduler:
    def test_shared_queue_processes_all(self):
        s = DynamicScheduler([Square() for _ in range(4)])
        s.start()
        s.submit_all(range(100))
        assert sorted(s.drain()) == sorted(i * i for i in range(100))
        s.stop()

    def test_pause_keeps_queue(self):
        s = DynamicScheduler([Square()])
        s.start()
        s.submit_all([1, 2, 3])
        assert sorted(s.drain()) == [1, 4, 9]
        s.pause()
        s.submit(5)           # queued while paused
        s.start()
        assert s.wait_for_output() == 25
        s.stop()

    def test_pause_with_backlog_does_not_run_backlog(self):
        """pause() puts its poison pills ahead of the backlog: it stops after
        the in-flight item and keeps the rest for the next start()."""
        ran = []
        gate = threading.Event()

        class Slow(Task):
            def run(self, x):
                gate.wait(5)
                ran.append(x)
                return x

        s = DynamicScheduler([Slow()])
        s.start()
        s.submit_all(range(50))
        time.sleep(0.05)       # the worker is blocked inside item 0
        gate.set()
        s.pause()
        assert len(ran) < 50, "pause executed the whole backlog"
        s.start()
        outs = [s.wait_for_output() for _ in range(s._submitted)]
        assert len(ran) == 50 and sorted(outs) == list(range(50))
        s.stop()

    def test_stop_discards_backlog(self):
        gate = threading.Event()

        class Slow(Task):
            def run(self, x):
                gate.wait(5)
                return x

        s = DynamicScheduler([Slow()])
        s.start()
        s.submit_all(range(20))
        gate.set()
        s.stop()
        # after stop the claimable outputs equal _submitted: no deadlock
        leftover = s.drain()
        assert len(leftover) < 20 and s._submitted == 0

    def test_propagates_task_errors(self):
        """A failing task fails the CALLER, not a drain() that hangs."""
        class Boom(Task):
            def run(self, item):
                if item == 2:
                    raise RuntimeError("task 2 exploded")
                return item * 10

        sched = DynamicScheduler([Boom(), Boom()])
        sched.start()
        sched.submit_all([1, 2, 3])
        with pytest.raises(RuntimeError, match="exploded"):
            sched.drain()
        sched.stop()


def test_static_scheduler_private_queues_stay_pinned():
    class Tag(Task):
        def __init__(self, tag):
            self.tag = tag

        def run(self, x):
            return (self.tag, threading.get_ident(), x)

    s = StaticScheduler([Tag(0), Tag(1), Tag(2)])
    s.start()
    idents = {}
    for rnd in range(3):
        for tid in range(3):
            s.submit(tid, tid * 10 + rnd)
        for tid in range(3):
            tag, ident, val = s.wait_for_output(tid)
            assert tag == tid and val == tid * 10 + rnd
            assert idents.setdefault(tid, ident) == ident   # one thread a task
    s.stop()
    assert len(set(idents.values())) == 3


@pytest.mark.parametrize("batched", [True, False])
def test_device_map_is_the_per_item_call(batched):
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    got = device_map(lambda r: (r * r).sum() + r[0], x, batched=batched)
    assert torch.equal(got, torch.stack([(r * r).sum() + r[0] for r in x]))


def test_async_pipeline_prefetches():
    pipe = AsyncPipeline(max_workers=2)
    futs = [pipe.prefetch(lambda i=i: i * 3) for i in range(5)]
    assert [f.result(timeout=10) for f in futs] == [0, 3, 6, 9, 12]
    pipe.close()


class TestLoaders:
    def test_split_files_contiguous(self):
        names = [f"f{i:02d}" for i in range(10)]
        groups = loaders.split_files(names, 4)
        assert [len(g) for g in groups] == [3, 3, 2, 2]
        assert groups[0] == ["f00", "f01", "f02"]
        assert groups == jloaders.split_files(names, 4)

    @pytest.mark.parametrize("threads", [1, 3])
    def test_dense_csv_bitwise_jax(self, tmp_path, threads):
        ref = np.random.default_rng(0).normal(size=(20, 5)).astype(np.float32)
        paths = []
        for i in range(4):
            p = tmp_path / f"part{i}.csv"
            np.savetxt(p, ref[i * 5:(i + 1) * 5], delimiter=",", fmt="%.9g")
            paths.append(str(p))
        out = loaders.load_dense_csv(paths + paths[:1], num_threads=threads)
        assert out.shape == (25, 5)
        np.testing.assert_allclose(out[:20], ref, atol=1e-6)
        _same(out, jloaders.load_dense_csv(paths + paths[:1]))

    def test_dense_csv_disagreeing_widths_raise(self, tmp_path):
        (tmp_path / "a.csv").write_text("1,2\n")
        (tmp_path / "b.csv").write_text("1,2,3\n")
        with pytest.raises(ValueError, match="column count"):
            loaders.load_dense_csv(loaders.list_files(str(tmp_path)))
        with pytest.raises(FileNotFoundError, match="no input files"):
            loaders.load_dense_csv([])

    def test_coo_to_csr(self):
        rows = np.array([2, 0, 1, 0, 2], dtype=np.int64)
        cols = np.array([1, 0, 2, 1, 0], dtype=np.int64)
        vals = np.arange(5, dtype=np.float32)
        indptr, idx, v = loaders.coo_to_csr(rows, cols, vals, num_rows=3)
        np.testing.assert_array_equal(indptr, [0, 2, 3, 5])
        np.testing.assert_array_equal(idx, [0, 1, 2, 1, 0])
        np.testing.assert_array_equal(v, [1, 3, 2, 0, 4])

    def test_coo_transforms_bitwise_jax(self):
        rows, cols, vals = jdatagen.sparse_ratings(100, 50, 4, density=0.1,
                                                   seed=1)
        for a, b in zip(loaders.coo_to_csr(rows, cols, vals, 101),
                        jloaders.coo_to_csr(rows, cols, vals, 101)):
            _same(a, b)
        parts = loaders.regroup_coo_by_row(rows, cols, vals, num_workers=4)
        assert sum(p[0].size for p in parts) == rows.size
        block = -(-100 // 4)
        for w, (r, _, _) in enumerate(parts):
            if r.size:
                assert np.all(np.minimum(r // block, 3) == w)
        for mine, theirs in zip(parts, jloaders.regroup_coo_by_row(
                rows, cols, vals, num_workers=4)):
            for a, b in zip(mine, theirs):
                _same(a, b)


def test_load_coo_bitwise_jax_and_pool(tmp_path):
    rows, cols, vals = jdatagen.sparse_ratings(64, 48, 4, density=0.2,
                                               seed=3)
    paths = []
    for i, sl in enumerate(np.array_split(np.arange(len(rows)), 5)):
        p = tmp_path / f"r{i}.coo"
        np.savetxt(p, np.c_[rows[sl], cols[sl], vals[sl]],
                   fmt=["%d", "%d", "%.7g"])
        paths.append(str(p))
    for threads in (1, 4):
        got = loaders.load_coo(paths, num_threads=threads)
        for a, b in zip(got, jloaders.load_coo(paths)):
            _same(a, b)
    np.testing.assert_array_equal(got[0], rows)
    tab = tmp_path / "t.coo"
    tab.write_text("0\t1\t2.5\n3\t4\t0.5\n")
    for a, b in zip(loaders.load_coo([str(tab)], sep="\t"),
                    jloaders.load_coo([str(tab)], sep="\t")):
        _same(a, b)


def test_load_coo_missing_file_raises_not_hangs(tmp_path):
    good = os.path.join(str(tmp_path), "good.coo")
    with open(good, "w") as f:
        f.write("0 1 2.5\n")
    with pytest.raises(Exception):
        loaders.load_coo([good, os.path.join(str(tmp_path), "missing.coo")])


def test_load_coo_duplicate_paths_keep_both(tmp_path):
    p = os.path.join(str(tmp_path), "a.coo")
    with open(p, "w") as f:
        f.write("0 1 2.0\n1 2 3.0\n")
    rows, cols, vals = loaders.load_coo([p, p])
    assert rows.tolist() == [0, 1, 0, 1]
    assert vals.tolist() == [2.0, 3.0, 2.0, 3.0]


def test_coo_to_csr_validates_and_fixes_dtype():
    rows = np.array([0, -1], np.int64)
    with pytest.raises(ValueError, match="row ids"):
        loaders.coo_to_csr(rows, np.zeros(2, np.int64),
                           np.ones(2, np.float64), num_rows=2)
    # float64 values come back float32 on BOTH paths
    ip, ix, v = loaders.coo_to_csr(np.array([1, 0]), np.array([3, 4]),
                                   np.array([1.5, 2.5], np.float64))
    assert v.dtype == np.float32
    assert ip.tolist() == [0, 1, 2] and ix.tolist() == [4, 3]


def test_labeled_csv_and_corpus_bitwise_jax(tmp_path):
    rng = np.random.default_rng(9)
    lab = tmp_path / "lab"
    lab.mkdir()
    for i in range(3):
        x = rng.standard_normal((7, 4))
        y = rng.integers(0, 3, 7)
        np.savetxt(lab / f"part-{i}", np.c_[x, y], delimiter=",",
                   fmt="%.8g")
    (lab / "_README").write_text("skipped\n")
    x, y = loaders.load_labeled_csv(str(lab), num_threads=2)
    jx, jy = jloaders.load_labeled_csv(str(lab))
    assert x.shape == (21, 4) and y.dtype == np.int32
    _same(x, jx)
    _same(y, jy)
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    docs = jdatagen.lda_corpus(12, 30, 3, 9, seed=2)
    for i, sl in enumerate(np.array_split(np.arange(12), 3)):
        np.savetxt(corpus / f"part-{i}", docs[sl], fmt="%d")
    got = loaders.load_corpus(str(corpus), num_threads=2)
    _same(got, jloaders.load_corpus(str(corpus)))
    np.testing.assert_array_equal(got, docs)
    (corpus / "part-9").write_text("1 2\n")
    with pytest.raises(ValueError, match="document length"):
        loaders.load_corpus(str(corpus))


def test_loaders_over_memory_urls():
    """The object-store seam: part-files on memory://, listed and loaded
    through the reader pool (dense CSV and COO) bitwise the JAX loaders,
    split over workers."""
    import fsspec

    rng = np.random.default_rng(5)
    fs = fsspec.filesystem("memory")
    parts, all_rows = [], []
    for i in range(3):
        block = rng.standard_normal((16, 4)).astype(np.float32)
        all_rows.append(block)
        path = f"memory://harp_torch_io_test/part-{i:03d}.csv"
        with fsspec.open(path, "w") as f:
            for row in block:
                f.write(",".join(f"{v:.6f}" for v in row) + "\n")
        parts.append(path)
    try:
        listed = loaders.list_files("memory://harp_torch_io_test/")
        assert listed == jloaders.list_files("memory://harp_torch_io_test/")
        assert [p.rsplit("/", 1)[-1] for p in listed] == \
            [p.rsplit("/", 1)[-1] for p in sorted(parts)], listed
        assert loaders.list_files(
            "memory://harp_torch_io_test/part-00*.csv") == listed
        assert loaders.list_files(parts[1]) == [parts[1]]
        dense = loaders.load_dense_csv(listed)
        np.testing.assert_allclose(dense, np.concatenate(all_rows),
                                   atol=1e-5)   # %.6f write precision
        _same(dense, jloaders.load_dense_csv(listed))
        assert [len(g) for g in loaders.split_files(listed, 3)] == [1, 1, 1]
        coo_path = "memory://harp_torch_io_test/coo-000.txt"
        with fsspec.open(coo_path, "w") as f:
            f.write("0 1 2.5\n1 0 1.5\n")
        r, c, v = loaders.load_coo([coo_path])
        assert r.tolist() == [0, 1] and c.tolist() == [1, 0]
        for a, b in zip((r, c, v), jloaders.load_coo([coo_path])):
            _same(a, b)
    finally:
        fs.rm("/harp_torch_io_test", recursive=True)


def test_list_files_local_dir_and_glob(tmp_path):
    for name in ("b.csv", "a.csv", "c.txt", "_SUCCESS", ".crc"):
        (tmp_path / name).write_text("1,2\n")
    got = loaders.list_files(str(tmp_path))
    assert [os.path.basename(p) for p in got] == ["a.csv", "b.csv", "c.txt"]
    assert got == jloaders.list_files(str(tmp_path))
    got = loaders.list_files(str(tmp_path / "*.csv"))
    assert [os.path.basename(p) for p in got] == ["a.csv", "b.csv"]
    named = str(tmp_path / "_SUCCESS")
    assert loaders.list_files(named) == [named]   # named files are read
