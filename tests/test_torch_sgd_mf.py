"""The port's SGD-MF slice against the JAX package's, on the CPU.

Same numpy inputs (made from a seed) go through ``harp_tpu`` and its
counterpart in ``harp_tpu_torch``: the host planning helpers (exact), the
dense hop's plain version (against the Pallas kernel in interpret mode and
the XLA stripe loop, rtol/atol 1e-5 on one hop), whole ``SGDMF`` fits in
every (workers, slices, layout) combination (per-epoch RMSE rtol 1e-5,
factors within 1e-4 of their largest entry: the packages round the bf16
products' sums and the scatter-adds in different orders), the state
converter (bitwise), the budget tuner, the CLI and the loaders.
"""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harp_tpu.collectives import rotation as jrot
from harp_tpu.io import datagen as jdatagen
from harp_tpu.io import loaders as jloaders
from harp_tpu.models import sgd_mf as jmf
from harp_tpu.ops import pallas_kernels as jpk
from harp_tpu.session import HarpSession as JaxSession
from harp_tpu_torch import convert
from harp_tpu_torch import run as trun
from harp_tpu_torch.collectives import rotation as trot
from harp_tpu_torch.io import datagen as tdatagen
from harp_tpu_torch.io import loaders as tloaders
from harp_tpu_torch.models import sgd_mf as tmf
from harp_tpu_torch.ops import pallas_kernels as tpk
from harp_tpu_torch.session import HarpSession as TorchSession

REPO = pathlib.Path(__file__).resolve().parent.parent
NU, NI = 256, 384
RANK = {1: 8, 2: 16, 4: 20}


@pytest.fixture(scope="module")
def ratings():
    return jdatagen.sparse_ratings(NU, NI, rank=8, density=0.05, seed=3)


def max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


# --------------------------------------------------------------------------- #
# Host planning: exact
# --------------------------------------------------------------------------- #

def _planning(r):
    rows, cols, vals = r
    counts = np.bincount(rows, minlength=NU)
    dup = (np.concatenate([rows, rows[:7]]), np.concatenate([cols, cols[:7]]),
           np.concatenate([vals, vals[:7] + 1]))
    return {
        "serpentine_assign": lambda m: m.serpentine_assign(counts, 3),
        "identity_assign": lambda m: m.identity_assign(NU, 3),
        "dedupe_coo": lambda m: m.dedupe_coo(*dup, NI),
        "bucketize": lambda m: m.bucketize(
            rows, cols, vals, 2, NU, NI, 4, num_col_blocks=4,
            row_assign=m.serpentine_assign(counts, 2)),
    }


@pytest.mark.parametrize("fn", ["sparse_ratings", "serpentine_assign",
                                "identity_assign", "dedupe_coo", "bucketize"])
def test_host_planning_matches_jax(ratings, fn):
    if fn == "sparse_ratings":
        got = tdatagen.sparse_ratings(300, 200, rank=4, density=0.1, seed=9)
        ref = jdatagen.sparse_ratings(300, 200, rank=4, density=0.1, seed=9)
    else:
        call = _planning(ratings)[fn]
        got, ref = call(tmf), call(jmf)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


def test_layout_choice_matches_jax():
    for w, ns, dense_max in ((1, 1, 6_000_000_000), (4, 2, 6_000_000_000),
                             (2, 1, 1 << 20), (1, 1, 1 << 62)):
        kw = dict(rank=4, num_slices=ns, dense_max_bytes=dense_max)
        t = tmf.SGDMF(TorchSession(num_workers=w, device="cpu"),
                      tmf.SGDMFConfig(**kw))
        j = jmf.SGDMF(JaxSession(num_workers=w), jmf.SGDMFConfig(**kw))
        for shape in ((512, 512), (40_000, 40_000), (200_000, 200_000)):
            assert t._choose_layout(*shape) == j._choose_layout(*shape)
            assert t._dense_geometry(*shape) == j._dense_geometry(*shape)


# --------------------------------------------------------------------------- #
# The dense hop's plain version
# --------------------------------------------------------------------------- #

def _xla_stripes(vb, w0, h0, rc, cc, nmb, lr, lam):
    """The stripe loop of harp_tpu/models/sgd_mf.py::_build_dense, as the
    JAX package's own kernel test writes it (tests/test_sgd_mf.py)."""
    bf = jnp.bfloat16
    s, k = w0.shape[0] // nmb, w0.shape[1]

    def stripe(state, xs):
        hb, sse = state
        w_s, v_s, rc_s, cc_s = xs
        hb_b = hb.astype(bf)
        pred = jax.lax.dot_general(w_s.astype(bf), hb_b,
                                   (((1,), (1,)), ((), ())),
                                   preferred_element_type=jnp.float32)
        g = jnp.where(jnp.isnan(v_s), jnp.asarray(0.0),
                      v_s.astype(jnp.float32) - pred).astype(bf)
        dw = jax.lax.dot_general(g, hb_b, (((1,), (0,)), ((), ())),
                                 preferred_element_type=jnp.float32)
        dh = jax.lax.dot_general(g, w_s.astype(bf), (((0,), (0,)), ((), ())),
                                 preferred_element_type=jnp.float32)
        w_s = w_s + lr * (dw - lam * rc_s[:, None] * w_s)
        hb = hb + lr * (dh - lam * cc_s[:, None] * hb)
        sse = sse + jnp.sum(g.astype(jnp.float32) ** 2)
        return (hb, sse), w_s

    (h, sse), w = jax.lax.scan(
        stripe, (h0, jnp.zeros(())),
        (w0.reshape(nmb, s, k), vb.reshape(nmb, s, -1), rc.reshape(nmb, s),
         cc))
    return np.asarray(w.reshape(-1, k)), np.asarray(h), float(sse)


@pytest.mark.parametrize("nmb,s,cpb,k,pallas", [
    (2, 16, 256, 8, True),       # the JAX kernel test's shape
    (4, 12, 200, 20, False),     # ragged cpb, K not a multiple of 8
])
def test_dense_mf_hop_plain_matches_pallas_and_xla(nmb, s, cpb, k, pallas):
    """dense_mf_hop_plain on one hop against the TPU kernel in interpret
    mode and the XLA stripe loop; the counts are summed from a finer
    stripe split (nmb_fine = 2 nmb) as the model stores them."""
    rng = np.random.default_rng(nmb + cpb)
    rpw, lr, lam = nmb * s, 0.05, 0.01
    v = rng.random((rpw, cpb)).astype(np.float32)
    v[rng.random((rpw, cpb)) < 0.9] = np.nan
    w0 = rng.random((rpw, k)).astype(np.float32)
    h0 = rng.random((cpb, k)).astype(np.float32)
    rc = rng.integers(1, 5, rpw).astype(np.float32)
    cc_fine = rng.integers(0, 3, (2 * nmb, cpb)).astype(np.float32)
    cc = cc_fine.reshape(nmb, 2, cpb).sum(axis=1)
    vb = jnp.asarray(v, jnp.bfloat16)
    ref = _xla_stripes(vb, jnp.asarray(w0), jnp.asarray(h0), jnp.asarray(rc),
                       jnp.asarray(cc), nmb, lr, lam)
    t = torch.from_numpy
    w1, h1, sse = tpk.dense_mf_hop_plain(
        t(v).to(torch.bfloat16)[None, None], torch.zeros(1, dtype=torch.int32),
        t(w0)[None], t(h0)[None], t(rc)[None, None], t(cc_fine)[None, None],
        nmb, lr, lam)
    refs = [ref]
    if pallas:
        w_t, h_t, sse_pl = jpk.dense_mf_hop_pallas(
            vb, jnp.asarray(w0).T, jnp.asarray(h0).T,
            jnp.asarray(rc).reshape(nmb, s), jnp.asarray(cc), lr, lam,
            col_tile=128, interpret=True)
        refs.append((np.asarray(w_t).T, np.asarray(h_t).T, float(sse_pl)))
    for w_r, h_r, sse_r in refs:
        np.testing.assert_allclose(w1[0].numpy(), w_r, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(h1[0].numpy(), h_r, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(sse[0]), sse_r, rtol=1e-5)


def test_dense_mf_hop_dispatcher_sends_cpu_tensors_to_plain():
    rng = np.random.default_rng(1)
    v = torch.from_numpy(rng.random((2, 3, 8, 16)).astype(np.float32))
    args = (v.to(torch.bfloat16), torch.tensor([2, 0], dtype=torch.int32),
            torch.rand(2, 8, 4), torch.rand(2, 16, 4), torch.ones(2, 3, 8),
            torch.ones(2, 3, 4, 16), 2, 0.05, 0.01)
    before = dict(tpk.launches)
    out = tpk.dense_mf_hop(*args)
    for a, b in zip(out, tpk.dense_mf_hop_plain(*args)):
        assert torch.equal(a, b)
    assert tpk.launches == before            # no kernel launched on the CPU
    with pytest.raises(ValueError, match="CUDA device"):
        tpk.dense_mf_hop_cuda(*args)
    with pytest.raises(ValueError, match="nmb"):
        tpk.dense_mf_hop(*args[:6], 3, 0.05, 0.01)


# --------------------------------------------------------------------------- #
# Rotation schedule
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("ns", [1, 2])
def test_rotator_visits_the_model_bucket_schedule(ns):
    """Tag every H block with its block id and run the Rotator: the block
    resident on worker w at hop t is SGDMF._bucket_id(w, t) (the JAX
    package's schedule), and every block is home after one epoch."""
    w = 4
    sess = TorchSession(num_workers=w, device="cpu")
    model = tmf.SGDMF(sess, tmf.SGDMFConfig(num_slices=ns))
    ids = torch.arange(ns * w, dtype=torch.float32)
    slices = tuple(ids[s * w:(s + 1) * w].clone() for s in range(ns))
    seen = []

    def body(carry, block, t):
        seen.append(block.clone())
        return carry, block

    def run():
        return trot.Rotator(w, ns).run(body, None, slices)

    _, out = sess.run(run, in_specs=(), out_specs=sess.replicate())
    for t, block in enumerate(seen):
        want = [model._bucket_id(i, t, w) for i in range(w)]
        assert block.tolist() == want
    for a, b in zip(out, slices):
        assert torch.equal(a, b)
    for nbytes in (1, 1 << 20, 5 << 20, 100 << 20):
        for link in ("ici", "dcn"):
            assert (trot.chunks_for_link(nbytes, link)
                    == jrot.chunks_for_link(nbytes, link))


# --------------------------------------------------------------------------- #
# Whole fits
# --------------------------------------------------------------------------- #

def _cfg(w, ns, layout, **kw):
    return dict(rank=RANK[w], lam=0.01, lr=0.05, epochs=3, num_slices=ns,
                layout=layout, minibatches_per_hop=4, **kw)


@pytest.mark.parametrize("layout", ["dense", "sparse"])
@pytest.mark.parametrize("ns", [1, 2])
@pytest.mark.parametrize("w", [1, 2, 4])
def test_fit_matches_jax(ratings, w, ns, layout):
    rows, cols, vals = ratings
    kw = _cfg(w, ns, layout)
    jw, jh, jr = jmf.SGDMF(JaxSession(num_workers=w),
                           jmf.SGDMFConfig(**kw)).fit(rows, cols, vals, NU,
                                                      NI, seed=1)
    model = tmf.SGDMF(TorchSession(num_workers=w, device="cpu"),
                      tmf.SGDMFConfig(**kw))
    tw, th, tr = model.fit(rows, cols, vals, NU, NI, seed=1)
    assert model.last_layout_stats["layout"] == layout
    assert tw.shape == (NU, RANK[w]) and th.shape == (NI, RANK[w])
    np.testing.assert_allclose(tr, np.asarray(jr), rtol=1e-5)
    assert max_rel(tw, jw) <= 1e-4 and max_rel(th, jh) <= 1e-4
    assert np.all(np.diff(tr) < 0)
    assert tmf.numpy_rmse(tw, th, rows, cols, vals) < tr[0]


@pytest.mark.parametrize("ns", [1, 2])
def test_convert_places_jax_factors(ratings, ns):
    """The port's prepared initial factors equal the JAX model's, carried
    over by convert.sgd_mf_state_from_jax; _finalize inverts the converter
    bitwise."""
    rows, cols, vals = ratings
    kw = _cfg(4, ns, "dense")
    jm = jmf.SGDMF(JaxSession(num_workers=4), jmf.SGDMFConfig(**kw))
    _, _, jw0, jh0, jmeta = jm.prepare(rows, cols, vals, NU, NI, seed=6)
    w_np, h_np = jm._finalize(jw0, jh0, jmeta)
    model = tmf.SGDMF(TorchSession(num_workers=4, device="cpu"),
                      tmf.SGDMFConfig(**kw))
    state = model.prepare(rows, cols, vals, NU, NI, seed=6)
    cfg, conv = convert.sgd_mf_state_from_jax(
        model, state, w_np, h_np, dataclasses.asdict(jm.config))
    assert cfg == model.config
    assert torch.equal(conv[2], state[2]) and torch.equal(conv[3], state[3])
    w_back, h_back = model._finalize(conv[2], conv[3], conv[4])
    np.testing.assert_array_equal(w_back, w_np)
    np.testing.assert_array_equal(h_back, h_np)
    # other factors land where _finalize reads them
    rng = np.random.default_rng(0)
    w2 = rng.standard_normal(w_np.shape).astype(np.float32)
    h2 = rng.standard_normal(h_np.shape).astype(np.float32)
    _, conv2 = convert.sgd_mf_state_from_jax(model, state, w2, h2,
                                             dataclasses.asdict(jm.config))
    w_back, h_back = model._finalize(conv2[2], conv2[3], conv2[4])
    np.testing.assert_array_equal(w_back, w2)
    np.testing.assert_array_equal(h_back, h2)


def test_fit_adaptive_picks_a_divisor(ratings):
    rows, cols, vals = ratings
    model = tmf.SGDMF(TorchSession(num_workers=2, device="cpu"),
                      tmf.SGDMFConfig(**_cfg(2, 1, "dense", )))
    state = model.prepare(rows, cols, vals, NU, NI, seed=1)
    w, h, rmse, tuner = model.fit_adaptive(state, epochs=5)
    assert 4 % tuner.chosen == 0 and tuner.chosen in (1, 2, 4)
    assert sorted(tuner.times) == [1, 2, 4]
    assert rmse.shape == (5,) and np.all(np.isfinite(rmse))
    assert w.shape == (NU, RANK[2]) and h.shape == (NI, RANK[2])
    j = jmf.HopBudgetTuner([1, 2, 4])
    t = tmf.HopBudgetTuner([1, 2, 4])
    for budget, sec in ((1, 0.3), (2, 0.31), (4, 0.5), (2, 0.2), (2, 0.4)):
        assert t.next_budget() == j.next_budget()
        t.record(budget, sec)
        j.record(budget, sec)
        assert t.chosen == j.chosen and t.times == j.times


def test_what_is_not_ported_raises():
    sess = TorchSession(num_workers=2, device="cpu")
    with pytest.raises(NotImplementedError, match="quant"):
        tmf.SGDMF(sess, tmf.SGDMFConfig(quant="int8"))
    with pytest.raises(NotImplementedError, match="comm"):
        trot.Rotator(2, 1, comm=object())
    with pytest.raises(NotImplementedError, match="not ported"):
        tmf.SGDMF(sess, tmf.SGDMFConfig()).fit_checkpointed(None, None)
    with pytest.raises(NotImplementedError):
        convert.sgd_mf_state_from_jax(None, None, None, None,
                                      dataclasses.asdict(
                                          jmf.SGDMFConfig(quant="int8")))
    # fused_dma=True is ported: the fused Rotator's trajectory is bitwise
    # the unfused one (tests/test_torch_ring_dma.py holds it to the JAX one)
    assert tmf.SGDMF(sess, tmf.SGDMFConfig(fused_dma=True)).config.fused_dma
    blocks = torch.arange(12.0).reshape(4, 3)

    def rotation(fused):
        def fn(b):
            c, (out,) = trot.Rotator(2, 1, fused_dma=fused).run(
                lambda c, blk, t: (c * 1.5 + blk, blk + t), b * 0, (b,))
            return c, out
        return sess.run(fn, blocks, in_specs=(sess.shard(),),
                        out_specs=(sess.shard(), sess.shard()))

    for a, b in zip(rotation(True), rotation(False)):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------- #
# CLI and loaders
# --------------------------------------------------------------------------- #

def test_loaders_match_jax():
    for spec in ("datasets/sgd_mf", "datasets/sgd_mf/part-*",
                 "datasets/sgd_mf/_README", "datasets/kmeans"):
        path = str(REPO / spec)
        assert tloaders.list_files(path) == jloaders.list_files(path)
    paths = tloaders.list_files(str(REPO / "datasets/sgd_mf"))
    assert [pathlib.Path(p).name for p in paths] == ["part-00000",
                                                     "part-00001"]
    for a, b in zip(tloaders.load_coo(paths), jloaders.load_coo(paths)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_cli_sgd_mf_on_cpu(capsys, tmp_path):
    assert trun.main(["sgd_mf", "--device", "cpu", "--num-users", "256",
                      "--num-items", "256", "--density", "0.05", "--rank",
                      "8", "--epochs", "3", "--num-workers", "2",
                      "--work-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert out.startswith("sgd_mf[dense] workers=2 nnz=")
    assert "M samples/s, rmse" in out
    assert np.loadtxt(tmp_path / "w.csv", delimiter=",").shape == (256, 8)
    assert trun.main(["sgd_mf", "--device", "cpu", "--ratings-file",
                      str(REPO / "datasets/sgd_mf"), "--epochs", "2",
                      "--adaptive", "--layout", "sparse"]) == 0
    out = capsys.readouterr().out
    rows, cols, vals = jloaders.load_coo(jloaders.list_files(
        str(REPO / "datasets/sgd_mf")))
    nnz = len(jmf.dedupe_coo(rows, cols, vals, int(cols.max()) + 1)[0])
    assert "tuned budget:" in out and f"nnz={nnz}" in out
    assert "sgd_mf[sparse] workers=1" in out
    # --fused-dma yes is ported (tests/test_torch_ring_dma.py holds it to
    # the JAX CLI)
    assert trun.main(["sgd_mf", "--device", "cpu", "--num-users", "64",
                      "--num-items", "64", "--epochs", "2", "--num-workers",
                      "2", "--fused-dma", "yes"]) == 0
    assert capsys.readouterr().out.startswith("sgd_mf[dense] workers=2 ")
    for flag in (["--save-every", "2"], ["--quant", "int8"]):
        with pytest.raises(SystemExit):
            trun.main(["sgd_mf", "--device", "cpu", *flag])
        assert "not yet ported" in capsys.readouterr().err
