"""The port's resharding engine and resume paths against the JAX package's.

On the same maps the port's device engine (``harp_tpu_torch.collectives.
reshard``, both schedules) is bitwise ``harp_tpu.collectives.repartition``
and the JAX engine, W 8 -> 4 and 4 -> 8; padded slots keep ``fill``; every
round's collective payload stays within ``chunk_bytes``; the planners equal
the JAX package's and raise its messages. The SGD-MF resume of a checkpoint
written at another world size (and slice count) gives a state bitwise the
JAX package's resumed state, on the device, ring and host paths, with no
host gather on the device path; the errors name the wrong model, the
missing meta and another dataset.
"""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

from harp_tpu.collectives import repartition as jrep
from harp_tpu.collectives import reshard as jrs
from harp_tpu.io import datagen as jdatagen
from harp_tpu.models import sgd_mf as jmf
from harp_tpu.session import HarpSession as JaxSession
from harp_tpu.utils.checkpoint import Checkpointer as JaxCheckpointer
from harp_tpu_torch.collectives import lax_ops as tlax
from harp_tpu_torch.collectives import repartition as trep
from harp_tpu_torch.collectives import reshard as trs
from harp_tpu_torch.models import sgd_mf as tmf
from harp_tpu_torch.session import HarpSession as TorchSession
from harp_tpu_torch.utils.checkpoint import Checkpointer

SCHEDULES = ("alltoall", "ring")


@pytest.fixture(scope="module")
def tsess():
    return {w: TorchSession(num_workers=w, device="cpu") for w in (4, 8)}


@pytest.fixture(scope="module")
def jsess():
    return {w: JaxSession(num_workers=w) for w in (4, 8)}


def _case(rng, old_world, new_world, n, width=5):
    old_rpb = -(-n // old_world) + 3
    new_rpb = -(-n // new_world) + 2
    old_assign = jmf.serpentine_assign(rng.integers(1, 9, n), old_world)
    new_assign = jmf.identity_assign(n, new_world)
    saved = rng.standard_normal((old_world * old_rpb, width)
                                ).astype(np.float32)
    fill = rng.standard_normal((new_world * new_rpb, width)
                               ).astype(np.float32)
    return old_rpb, new_rpb, old_assign, new_assign, saved, fill


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("old_world,new_world,n",
                         [(8, 4, 53), (4, 8, 97), (2, 8, 61)])
def test_engine_bitwise_the_oracle_and_jax(rng, tsess, jsess, schedule,
                                           old_world, new_world, n):
    old_rpb, new_rpb, oa, na, saved, fill = _case(rng, old_world,
                                                  new_world, n)
    oracle = jrep.repartition_factor(saved, oa, old_rpb, na, new_rpb, n,
                                     fill.copy())
    np.testing.assert_array_equal(
        trep.repartition_factor(saved, oa, old_rpb, na, new_rpb, n,
                                fill.copy()), oracle)
    old = trs.block_layout(oa, old_rpb, old_world)
    new = trs.block_layout(na, new_rpb, new_world)
    s = tsess[new_world]
    out = trs.reshard_factor(s, saved, old, old_world, new, n,
                             s.scatter(fill), chunk_bytes=64,
                             schedule=schedule)
    np.testing.assert_array_equal(out.numpy(), oracle)
    js = jsess[new_world]
    jout = jrs.reshard_factor(js, saved, jrs.block_layout(oa, old_rpb,
                                                          old_world),
                              old_world, jrs.block_layout(na, new_rpb,
                                                          new_world),
                              n, js.scatter(fill), chunk_bytes=64,
                              schedule=schedule)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


def test_two_slice_layout_and_live_source(rng, tsess):
    # a 2-slice table (bins worker-major) resharded from a live tensor
    n, w = 40, 4
    assign = jmf.serpentine_assign(rng.integers(1, 5, n), 2 * w)
    lay = trs.block_layout(assign, 6, w, num_slices=2)
    jlay = jrs.block_layout(assign, 6, w, num_slices=2)
    for f in dataclasses.fields(lay):
        np.testing.assert_array_equal(np.asarray(getattr(lay, f.name)),
                                      np.asarray(getattr(jlay, f.name)))
    table = rng.standard_normal((w * lay.local_rows, 3)).astype(np.float32)
    new = trs.block_layout(jmf.identity_assign(n, w), 10, w)
    fill = np.zeros((w * 10, 3), np.float32)
    s = tsess[w]
    out = trs.reshard_factor(s, s.scatter(table), lay, w, new, n,
                             s.scatter(fill), chunk_bytes=48)
    canon = table[lay.device_positions(n)]
    np.testing.assert_array_equal(out.numpy()[new.device_positions(n)],
                                  canon)


def test_padded_slots_keep_fill(rng, tsess):
    n = 10
    old_assign, new_assign = jmf.identity_assign(n, 4), \
        jmf.identity_assign(n, 8)
    fill = rng.standard_normal((8 * 4, 2)).astype(np.float32)
    saved = rng.standard_normal((4 * 3, 2)).astype(np.float32)
    for schedule in SCHEDULES:
        out = trs.reshard_factor(
            tsess[8], saved, trs.block_layout(old_assign, 3, 4), 4,
            trs.block_layout(new_assign, 4, 8), n, tsess[8].scatter(fill),
            schedule=schedule).numpy()
        new_pos = trs.block_layout(new_assign, 4, 8).device_positions(n)
        untouched = np.setdiff1d(np.arange(32), new_pos)
        np.testing.assert_array_equal(out[untouched], fill[untouched])


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_rounds_respect_chunk_bytes(rng, tsess, monkeypatch, schedule):
    n, r, chunk = 97, 8, 512
    old = trs.block_layout(jmf.serpentine_assign(rng.integers(1, 9, n), 4),
                           28, 4)
    new = trs.block_layout(jmf.identity_assign(n, 8), 16, 8)
    saved = rng.standard_normal((4 * 28, r)).astype(np.float32)
    plan = trs.plan_factor_reshard(old, 4, new, 8, n, r * 4,
                                   chunk_bytes=chunk, schedule=schedule)
    assert plan.rounds > 1, "shape must force multiple rounds"
    sizes = []
    real = {"all_to_all": tlax.all_to_all, "rotate": tlax.rotate}

    def spy(name):
        def f(x, *a, **k):
            sizes.append(x[0].numel() * x.element_size())   # one worker's
            return real[name](x, *a, **k)
        return f

    monkeypatch.setattr(tlax, "all_to_all", spy("all_to_all"))
    monkeypatch.setattr(tlax, "rotate", spy("rotate"))
    out = trs.reshard(tsess[8], saved, plan,
                      tsess[8].scatter(np.zeros((8 * 16, r), np.float32)))
    assert sizes and max(sizes) <= chunk, sizes
    want = (plan.rounds if schedule == "alltoall"
            else plan.rounds - plan.ring_rounds[0][0].shape[1])
    assert len(sizes) == want
    oracle = trep.repartition_factor(
        saved, (old.bins, old.slots), 28, (new.bins, new.slots), 16, n,
        np.zeros((8 * 16, r), np.float32))
    np.testing.assert_array_equal(out.numpy(), oracle)


def test_planners_equal_jax_and_raise_its_messages(rng):
    n = 97
    old = trs.block_layout(jmf.serpentine_assign(rng.integers(1, 9, n), 4),
                           28, 4)
    new = trs.block_layout(jmf.identity_assign(n, 8), 16, 8)
    for schedule in SCHEDULES:
        tp = trs.plan_factor_reshard(old, 4, new, 8, n, 32, 512, schedule)
        jp = jrs.plan_factor_reshard(old, 4, new, 8, n, 32, 512, schedule)
        for f in dataclasses.fields(tp):
            a, b = getattr(tp, f.name), getattr(jp, f.name)
            if f.name == "ring_rounds":
                for (sa, ra), (sb, rb) in zip(a or (), b or ()):
                    np.testing.assert_array_equal(sa, sb)
                    np.testing.assert_array_equal(ra, rb)
            else:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    rows = rng.integers(0, 50, 200)
    tp, tc, tcap = trs.plan_coo_regroup(rows, 50, 4)
    jp, jc, jcap = jrs.plan_coo_regroup(rows, 50, 4)
    np.testing.assert_array_equal(tp.send_idx, jp.send_idx)
    np.testing.assert_array_equal(tc, jc)
    assert tcap == jcap
    for mod in (trs, jrs):
        with pytest.raises(ValueError, match="alltoall|ring"):
            mod.plan_moves(np.arange(4), np.arange(4), 8, 8, 4, 4,
                           schedule="gather")
        with pytest.raises(ValueError, match="collide"):
            mod.plan_moves(np.arange(4), np.zeros(4, np.int64), 8, 8, 4, 4)
        with pytest.raises(ValueError, match="outside the new layout"):
            mod.plan_moves(np.arange(4), np.array([0, 1, 2, 99]), 8, 8, 4,
                           4)
        with pytest.raises(ValueError, match="outside the flat leaf"):
            mod.plan_moves(np.array([99]), np.array([0]), 8, 8, 4, 4)
        with pytest.raises(ValueError, match="must divide the"):
            mod.plan_moves(np.arange(4), np.arange(4), 8, 9, 4, 4)
        with pytest.raises(ValueError, match=r"auto\|device\|ring\|host"):
            mod.resolve_mode("teleport", 4)
        assert mod.resolve_mode("auto", 1) == "host"
        assert mod.resolve_mode("auto", 4) == "device"
    assert trs.DEFAULT_CHUNK_BYTES == jrs.DEFAULT_CHUNK_BYTES


def test_rematch_tokens_equals_jax(rng):
    doc = rng.integers(0, 5, 60)
    voc = rng.integers(0, 7, 60)
    pay = rng.integers(0, 4, 60).astype(np.int32)
    perm = rng.permutation(60)
    np.testing.assert_array_equal(
        trep.rematch_tokens(doc, voc, pay, doc[perm], voc[perm]),
        jrep.rematch_tokens(doc, voc, pay, doc[perm], voc[perm]))
    with pytest.raises(ValueError, match="token multiset"):
        trep.rematch_tokens(doc, voc, pay, doc[perm], (voc[perm] + 1) % 7)


# --------------------------------------------------------------------------- #
# SGD-MF: resume at another world size, bitwise the JAX package's
# --------------------------------------------------------------------------- #

def _ratings():
    return jdatagen.sparse_ratings(64, 64, rank=4, density=0.25, seed=3)


def _mf_cfg(mod, **kw):
    base = dict(rank=4, epochs=2, layout="sparse", minibatches_per_hop=2)
    base.update(kw)
    return mod.SGDMFConfig(**base)


@pytest.fixture(scope="module")
def jax_written(tmp_path_factory, jsess):
    """JAX-written W=8 checkpoints (1 and 2 slices) and the JAX package's
    W=4 resumed factors for each (old slices, new slices)."""
    rows, cols, vals = _ratings()
    root = tmp_path_factory.mktemp("mf")
    dirs, resumed = {}, {}
    for ns in (1, 2):
        m8 = jmf.SGDMF(jsess[8], _mf_cfg(jmf, num_slices=ns))
        d = root / f"w8s{ns}"
        m8.fit_checkpointed(m8.prepare(rows, cols, vals, 64, 64, seed=0),
                            JaxCheckpointer(str(d), use_orbax=False),
                            save_every=1)
        dirs[ns] = d
    for old_ns, new_ns in ((1, 1), (2, 2), (2, 1)):
        d = root / f"j{old_ns}{new_ns}"
        shutil.copytree(dirs[old_ns], d)
        m4 = jmf.SGDMF(jsess[4], _mf_cfg(jmf, num_slices=new_ns))
        w, h, rmse, start = m4.fit_checkpointed(
            m4.prepare(rows, cols, vals, 64, 64, seed=0),
            JaxCheckpointer(str(d), use_orbax=False), save_every=1)
        assert start == 2 and len(rmse) == 0
        resumed[old_ns, new_ns] = (w, h)
    return dirs, resumed


@pytest.mark.parametrize("mode", ["device", "ring", "host"])
@pytest.mark.parametrize("old_ns,new_ns", [(1, 1), (2, 2), (2, 1)])
def test_sgd_mf_resume_w8_to_w4_bitwise_jax(tmp_path, tsess, jax_written,
                                            mode, old_ns, new_ns):
    dirs, resumed = jax_written
    rows, cols, vals = _ratings()
    shutil.copytree(dirs[old_ns], tmp_path / "ck")
    m4 = tmf.SGDMF(tsess[4], _mf_cfg(tmf, num_slices=new_ns, reshard=mode))
    w, h, rmse, start = m4.fit_checkpointed(
        m4.prepare(rows, cols, vals, 64, 64, seed=0),
        Checkpointer(str(tmp_path / "ck")), save_every=1)
    assert start == 2 and len(rmse) == 0
    jw, jh = resumed[old_ns, new_ns]
    np.testing.assert_array_equal(w, np.asarray(jw))
    np.testing.assert_array_equal(h, np.asarray(jh))


def test_sgd_mf_port_written_grow_resumes_in_both(tmp_path, tsess, jsess):
    rows, cols, vals = _ratings()
    m4 = tmf.SGDMF(tsess[4], _mf_cfg(tmf, num_slices=2))
    w4, h4, _, _ = m4.fit_checkpointed(
        m4.prepare(rows, cols, vals, 64, 64, seed=0),
        Checkpointer(str(tmp_path / "a")), save_every=1)
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    m8 = tmf.SGDMF(tsess[8], _mf_cfg(tmf))
    w, h, _, start = m8.fit_checkpointed(
        m8.prepare(rows, cols, vals, 64, 64, seed=0),
        Checkpointer(str(tmp_path / "a")), save_every=1)
    j8 = jmf.SGDMF(jsess[8], _mf_cfg(jmf))
    jw, jh, _, jstart = j8.fit_checkpointed(
        j8.prepare(rows, cols, vals, 64, 64, seed=0),
        JaxCheckpointer(str(tmp_path / "b"), use_orbax=False), save_every=1)
    assert start == jstart == 2
    np.testing.assert_array_equal(w, np.asarray(jw))
    np.testing.assert_array_equal(h, np.asarray(jh))
    # every referenced row is the saved row
    np.testing.assert_array_equal(w, w4)
    np.testing.assert_array_equal(h, h4)


def test_sgd_mf_same_world_resume_bitwise_uninterrupted(tmp_path, tsess):
    rows, cols, vals = _ratings()
    for layout in ("sparse", "dense"):
        cfg = _mf_cfg(tmf, epochs=4, layout=layout)
        m = tmf.SGDMF(tsess[4], cfg)
        st = m.prepare(rows, cols, vals, 64, 64, seed=0)
        w_a, h_a, r_a, _ = m.fit_checkpointed(
            st, Checkpointer(str(tmp_path / layout / "a")), save_every=2)
        m.fit_checkpointed(st, Checkpointer(str(tmp_path / layout / "b")),
                           save_every=2, epochs=2)
        m2 = tmf.SGDMF(tsess[4], cfg)
        w_b, h_b, r_b, start = m2.fit_checkpointed(
            m2.prepare(rows, cols, vals, 64, 64, seed=0),
            Checkpointer(str(tmp_path / layout / "b")), save_every=2)
        assert start == 2
        np.testing.assert_array_equal(w_b, w_a)
        np.testing.assert_array_equal(h_b, h_a)
        np.testing.assert_array_equal(r_b, r_a[2:])
        with pytest.raises(ValueError, match="exceeds the requested"):
            m2.fit_checkpointed(m2.prepare(rows, cols, vals, 64, 64),
                                Checkpointer(str(tmp_path / layout / "b")),
                                epochs=3)


def test_sgd_mf_device_resume_never_gathers(tmp_path, tsess, monkeypatch):
    rows, cols, vals = _ratings()
    m8 = tmf.SGDMF(tsess[8], _mf_cfg(tmf))
    m8.fit_checkpointed(m8.prepare(rows, cols, vals, 64, 64, seed=0),
                        Checkpointer(str(tmp_path)), save_every=1)
    from harp_tpu_torch.utils import checkpoint as ckpt_lib

    _, saved, meta = Checkpointer(str(tmp_path)).restore_latest_valid(
        like_from_meta=ckpt_lib.meta_like, return_meta=True)
    host_copies = []
    real_cpu, real_numpy = torch.Tensor.cpu, torch.Tensor.numpy

    def count_cpu(self, *a, **k):
        host_copies.append(("cpu", tuple(self.shape)))
        return real_cpu(self, *a, **k)

    def count_numpy(self, *a, **k):
        host_copies.append(("numpy", tuple(self.shape)))
        return real_numpy(self, *a, **k)

    def poisoned_fetch(*a, **k):
        raise AssertionError("the device reshard gathered a sharded leaf")

    for mode in ("device", "ring"):
        m4 = tmf.SGDMF(tsess[4], _mf_cfg(tmf, reshard=mode))
        st4 = m4.prepare(rows, cols, vals, 64, 64, seed=0)
        with monkeypatch.context() as mp:
            mp.setattr(tmf, "fetch", poisoned_fetch)
            mp.setattr(torch.Tensor, "cpu", count_cpu)
            mp.setattr(torch.Tensor, "numpy", count_numpy)
            out = m4._repartition_saved(saved, meta, st4)
        assert host_copies == [], host_copies
        assert isinstance(out["w"], torch.Tensor)
        assert isinstance(out["h"], torch.Tensor)
    # the host oracle does fetch (the path the device engine replaces)
    m4h = tmf.SGDMF(tsess[4], _mf_cfg(tmf, reshard="host"))
    st4h = m4h.prepare(rows, cols, vals, 64, 64, seed=0)
    monkeypatch.setattr(tmf, "fetch", poisoned_fetch)
    with pytest.raises(AssertionError, match="gathered a sharded leaf"):
        m4h._repartition_saved(saved, meta, st4h)


def test_sgd_mf_resume_errors(tmp_path, tsess):
    rows, cols, vals = _ratings()
    ck = Checkpointer(str(tmp_path / "km"))
    ck.save(1, {"centroids": np.zeros((3, 2), np.float32)},
            meta={"shapes": {"centroids": [3, 2]},
                  "dtypes": {"centroids": "float32"}, "model": "kmeans"})
    m4 = tmf.SGDMF(tsess[4], _mf_cfg(tmf))
    st4 = m4.prepare(rows, cols, vals, 64, 64, seed=0)
    with pytest.raises(ValueError, match="written by model 'kmeans'"):
        m4.fit_checkpointed(st4, ck)
    # a meta-less step of other shapes: no world to re-partition from
    legacy = Checkpointer(str(tmp_path / "legacy"))
    legacy.save(1, {"w": np.zeros((8, 4), np.float32),
                    "h": np.zeros((8, 4), np.float32)})
    with pytest.raises(ValueError, match="no world metadata"):
        m4.fit_checkpointed(st4, legacy)
    # a checkpoint of another rating matrix
    m8 = tmf.SGDMF(tsess[8], _mf_cfg(tmf))
    m8.fit_checkpointed(m8.prepare(rows, cols, vals, 64, 64, seed=0),
                        Checkpointer(str(tmp_path / "other")), save_every=2)
    m4b = tmf.SGDMF(tsess[4], _mf_cfg(tmf))
    st = m4b.prepare(rows, cols, vals, 64, 72, seed=0)
    with pytest.raises(ValueError, match="not the same dataset"):
        m4b.fit_checkpointed(st, Checkpointer(str(tmp_path / "other")))
    with pytest.raises(ValueError, match=r"auto\|device\|ring\|host"):
        tmf.SGDMF(tsess[4], _mf_cfg(tmf, reshard="teleport"))._reshard_mode()
