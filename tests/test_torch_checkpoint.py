"""The port's checkpoints against the JAX package's, on the CPU.

A step directory written by ``harp_tpu.utils.checkpoint.Checkpointer`` in
its numpy format (``use_orbax=False``) restores in ``harp_tpu_torch`` and
the other way round, leaf for leaf and bitwise; a torn or bit-flipped newest
step falls back to the previous one; ``like_from_meta`` resolves per step;
an async save's failure re-raises on ``wait``; ``_prune`` keeps the newest
``keep`` steps and spares a young foreign tmp dir; the K-means
``fit_checkpointed`` resumes bitwise an uninterrupted run and matches the
JAX package's checkpointed fit.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from harp_tpu.utils import checkpoint as jck
from harp_tpu_torch.utils import checkpoint as tck


def _state(rng):
    return {"w": rng.standard_normal((6, 3)).astype(np.float32),
            "b": np.arange(5, dtype=np.int32),
            "nested": {"z": rng.integers(0, 9, (2, 2)).astype(np.int64),
                       "a": (np.float32(1.5) * np.ones(3, np.float32),
                             np.zeros((1, 2), np.float64))}}


def _equal_trees(a, b):
    la, lb = tck.tree_flatten(a), tck.tree_flatten(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_flatten_order_is_jax_tree_order(rng):
    import jax

    state = _state(rng)
    jl = jax.tree.flatten(state)[0]
    tl = tck.tree_flatten(state)
    assert len(jl) == len(tl)
    for x, y in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(x), y)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_step_dir_round_trips_between_packages(tmp_path, rng, writer):
    state = _state(rng)
    meta = {"world": 4, "model": "demo"}
    if writer == "jax":
        jck.Checkpointer(str(tmp_path), use_orbax=False).save(3, state,
                                                              meta=meta)
        reader = tck.Checkpointer(str(tmp_path))
    else:
        torch_state = tck.tree_map(torch.from_numpy, state)
        tck.Checkpointer(str(tmp_path)).save(3, torch_state, meta=meta)
        reader = jck.Checkpointer(str(tmp_path), use_orbax=False)
    step, got, got_meta = reader.restore_latest_valid(like=state,
                                                      return_meta=True)
    assert step == 3 and got_meta == meta
    _equal_trees(got, state)
    assert jck.verify_step_dir(str(tmp_path / "step_000000000003"))
    assert tck.verify_step_dir(str(tmp_path / "step_000000000003"))
    with open(tmp_path / "step_000000000003" / "manifest.json") as f:
        man = json.load(f)
    assert man["leaves"] == len(tck.tree_flatten(state))


@pytest.mark.parametrize("damage", ["bitflip", "torn", "manifest"])
def test_damaged_newest_step_falls_back(tmp_path, rng, damage):
    ck = tck.Checkpointer(str(tmp_path), keep=5)
    good = {"x": rng.standard_normal(64).astype(np.float32)}
    ck.save(1, good)
    second = good["x"] + 1
    ck.save(2, {"x": second})
    newest = tmp_path / "step_000000000002"
    npz = newest / "arrays.npz"
    if damage == "bitflip":
        raw = bytearray(npz.read_bytes())
        at = raw.find(second.tobytes()[:16])   # the stored array's bytes
        assert at >= 0
        raw[at + 5] ^= 0x10
        npz.write_bytes(bytes(raw))
    elif damage == "torn":
        npz.write_bytes(npz.read_bytes()[:50])
    else:
        (newest / "manifest.json").write_text("{not json")
    assert not ck.verify(2)
    assert ck.latest_valid_step() == 1
    assert ck.valid_steps() == [1]
    step, got = ck.restore_latest_valid(like={"x": 0})
    assert step == 1
    np.testing.assert_array_equal(got["x"], good["x"])
    # the JAX package reads the same directory the same way
    assert jck.latest_valid_step(str(tmp_path)) == 1


def test_orbax_payload_verifies_false(tmp_path):
    d = tmp_path / "step_000000000007"
    d.mkdir()
    (d / "manifest.json").write_text(json.dumps({"leaves": 1, "arrays": {}}))
    assert not tck.verify_step_dir(str(d))
    assert tck.latest_valid_step(str(tmp_path)) is None
    # a directory without any manifest predates manifests: trusted
    legacy = tmp_path / "legacy"
    legacy.mkdir()
    assert tck.verify_step_dir(str(legacy))


def test_like_from_meta_resolves_per_step(tmp_path, rng):
    ck = tck.Checkpointer(str(tmp_path), keep=5)
    a = {"w": rng.standard_normal((8, 2)).astype(np.float32)}
    b = {"w": rng.standard_normal((4, 2)).astype(np.float32)}
    ck.save(1, a, meta=tck.state_meta(a, world=8))
    ck.save(2, b, meta=tck.state_meta(b, world=4))
    seen = []

    def like(meta):
        seen.append(meta["world"])
        return tck.meta_like(meta)

    step, got, meta = ck.restore_latest_valid(like_from_meta=like,
                                              return_meta=True)
    assert step == 2 and seen == [4] and meta["world"] == 4
    np.testing.assert_array_equal(got["w"], b["w"])
    # the newest step torn: the fallback step's meta builds its own template
    (tmp_path / "step_000000000002" / "arrays.npz").write_bytes(b"x")
    step, got = ck.restore_latest_valid(like_from_meta=like)
    assert step == 1 and seen == [4, 4, 8]
    np.testing.assert_array_equal(got["w"], a["w"])
    # state_meta of tensors names numpy dtypes, as the JAX package's does
    m = tck.state_meta({"t": torch.zeros(3, 2, dtype=torch.int32)})
    assert m["shapes"] == {"t": [3, 2]} and m["dtypes"] == {"t": "int32"}
    assert m == jck.state_meta({"t": np.zeros((3, 2), np.int32)})


def test_structure_mismatch_raises(tmp_path, rng):
    ck = tck.Checkpointer(str(tmp_path))
    ck.save(1, {"a": np.ones(2), "b": np.ones(3)})
    with pytest.raises(ValueError, match="holds 2 arrays"):
        ck.restore_latest_valid(like={"a": 0})


def test_async_save_reraises_on_wait(tmp_path, rng, monkeypatch):
    ck = tck.Checkpointer(str(tmp_path), async_save=True)
    x = torch.arange(6, dtype=torch.float32)
    ck.save(1, {"x": x})
    x += 100              # the copy was taken at save: the write sees 0..5
    ck.wait()
    np.testing.assert_array_equal(ck.restore(1, like={"x": 0})["x"],
                                  np.arange(6, dtype=np.float32))

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(tck.np, "savez", broken)
    ck.save(2, {"x": x})
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    assert ck.latest_step() == 1


def test_prune_keeps_newest_and_spares_young_foreign_tmp(tmp_path, rng):
    ck = tck.Checkpointer(str(tmp_path), keep=2)
    young = tmp_path / "step_000000000009.tmp-99999999"
    old = tmp_path / "step_000000000008.tmp-99999998"
    young.mkdir()
    old.mkdir()
    stale = time.time() - tck.STALE_TMP_SECONDS - 10
    os.utime(old, (stale, stale))
    for s in (1, 2, 3):
        ck.save(s, {"x": np.full(3, s, np.float32)})
    assert ck.steps() == [2, 3]
    assert young.exists(), "a live writer's tmp dir was reaped"
    assert not old.exists(), "a stale tmp dir survived"
    assert tck.STALE_TMP_SECONDS == jck.STALE_TMP_SECONDS


def test_list_step_numbers_matches_jax(tmp_path):
    for name in ("step_000000000004", "step_000000000012", "step_x",
                 "step_000000000001.tmp-1", "other"):
        (tmp_path / name).mkdir()
    assert (tck.list_step_numbers(str(tmp_path))
            == jck.list_step_numbers(str(tmp_path)) == [4, 12])


# --------------------------------------------------------------------------- #
# K-means fit_checkpointed
# --------------------------------------------------------------------------- #

def _kmeans_data():
    from harp_tpu.io import datagen

    pts = datagen.dense_points(256, 8, seed=4, num_clusters=5)
    cen0 = datagen.initial_centroids(pts, 5, seed=5)
    return pts, cen0


def test_kmeans_fit_checkpointed_resume_bitwise_and_matches_jax(tmp_path):
    from harp_tpu.models import kmeans as jkm
    from harp_tpu.session import HarpSession as JaxSession
    from harp_tpu_torch.models import kmeans as tkm
    from harp_tpu_torch.session import HarpSession as TorchSession

    pts, cen0 = _kmeans_data()
    cfg = dict(num_centroids=5, dim=8, iterations=6, lane_pad=False)
    sess = TorchSession(num_workers=4, device="cpu")
    model = tkm.KMeans(sess, tkm.KMeansConfig(**cfg))
    p, c = model.prepare(pts, cen0)
    whole, costs, start = model.fit_checkpointed(
        p, c, tck.Checkpointer(str(tmp_path / "a")), save_every=2)
    assert start == 0 and len(costs) == 6
    # interrupted after 4 iterations, resumed in a fresh model
    ck = tck.Checkpointer(str(tmp_path / "b"))
    model.fit_checkpointed(p, c, ck, save_every=2, iterations=4)
    again = tkm.KMeans(sess, tkm.KMeansConfig(**cfg))
    resumed, rcosts, rstart = again.fit_checkpointed(
        p, c, tck.Checkpointer(str(tmp_path / "b")), save_every=2)
    assert rstart == 4 and len(rcosts) == 2
    assert torch.equal(resumed, whole)
    np.testing.assert_array_equal(rcosts, costs[4:])
    # past the budget
    with pytest.raises(ValueError, match="exceeds the requested"):
        again.fit_checkpointed(p, c, tck.Checkpointer(str(tmp_path / "b")),
                               iterations=3)
    # the JAX package's checkpointed fit from the same start
    jsess = JaxSession(num_workers=4)
    jmodel = jkm.KMeans(jsess, jkm.KMeansConfig(**cfg))
    jp, jc = jmodel.prepare(pts, cen0)
    jcen, jcosts, _ = jmodel.fit_checkpointed(
        jp, jc, jck.Checkpointer(str(tmp_path / "j"), use_orbax=False),
        save_every=2)
    np.testing.assert_allclose(whole.numpy(), np.asarray(jcen), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(costs, jcosts, rtol=1e-5)
    # and each package resumes the other's directory
    meta = json.load(open(tmp_path / "j" / "step_000000000006" /
                          "manifest.json"))["meta"]
    assert meta["model"] == "kmeans" and meta["world"] == 4
    got, _, s = model.fit_checkpointed(
        p, c, tck.Checkpointer(str(tmp_path / "j")), save_every=2)
    assert s == 6
    np.testing.assert_array_equal(got.numpy(), np.asarray(jcen))


@pytest.mark.parametrize("old,new", [(8, 4), (4, 8)])
def test_kmeans_resume_across_world_sizes_is_identity(tmp_path, old, new):
    from harp_tpu_torch.models import kmeans as tkm
    from harp_tpu_torch.session import HarpSession as TorchSession

    pts, cen0 = _kmeans_data()
    cfg = tkm.KMeansConfig(num_centroids=5, dim=8, iterations=4)
    ma = tkm.KMeans(TorchSession(num_workers=old, device="cpu"), cfg)
    cen_a, _, _ = ma.fit_checkpointed(*ma.prepare(pts, cen0),
                                      tck.Checkpointer(str(tmp_path)),
                                      save_every=2)
    mb = tkm.KMeans(TorchSession(num_workers=new, device="cpu"), cfg)
    cen_b, costs_b, start = mb.fit_checkpointed(
        *mb.prepare(pts, cen0), tck.Checkpointer(str(tmp_path)),
        save_every=2)
    assert start == 4 and len(costs_b) == 0
    assert torch.equal(cen_b, cen_a)
