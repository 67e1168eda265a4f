"""The port's LDA slice against the JAX package's, on the CPU.

Same numpy inputs through ``harp_tpu`` and ``harp_tpu_torch``:
``ops/threefry`` is bitwise ``jax.random`` (``PRNGKey``, ``fold_in``,
``split``, ``uniform``); ``xla_cumsum`` is bitwise ``jnp.cumsum`` on the
CPU; ``lda_corpus``, ``bucketize_tokens*``, ``gemm_scatter`` and
``sub_block_split`` are bitwise the JAX package's. CGS epochs run in lock
step with ``harp_tpu.models.lda`` from one state (W=1 and W=4, 1 and 2
slices, the sub-block layout): every draw equal, a differing draw allowed
only where ``u`` lies within 1e-6 (relative) of a CDF boundary, and counted;
the word-topic, doc-topic and total counts exact. CVB0 is within 1e-5 of
the largest entry; the fused fit is bitwise the unfused one (through the
ring-DMA hop); the quantized fits stay within the JAX tests' bounds;
``fit_checkpointed`` resumes bitwise an uninterrupted run; a W=8 chain
resumed at W=4 (device, ring and host) gives the JAX package's counts; the
CLI prints what ``harp_tpu.run`` prints.
"""

import os
import re
import shutil
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harp_tpu.io import datagen as jdatagen
from harp_tpu.io import loaders as jloaders
from harp_tpu.models import lda as jl
from harp_tpu.ops import lane_pack as jlp
from harp_tpu.session import HarpSession as JaxSession
from harp_tpu.utils.checkpoint import Checkpointer as JaxCheckpointer
from harp_tpu_torch import convert
from harp_tpu_torch.io import datagen as tdatagen
from harp_tpu_torch.io import loaders as tloaders
from harp_tpu_torch.models import lda as tl
from harp_tpu_torch.ops import lane_pack as tlp
from harp_tpu_torch.ops import ring_dma
from harp_tpu_torch.ops import threefry
from harp_tpu_torch.session import HarpSession as TorchSession
from harp_tpu_torch.utils.checkpoint import Checkpointer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIE = 1e-6


@pytest.fixture(scope="module")
def docs():
    return jdatagen.lda_corpus(32, 60, 4, 16, seed=5)


@pytest.fixture(scope="module")
def sessions():
    return ({w: JaxSession(num_workers=w) for w in (1, 4, 8)},
            {w: TorchSession(num_workers=w, device="cpu") for w in (1, 4, 8)})


def _cfg(mod, **kw):
    base = dict(num_topics=8, vocab=60, epochs=2)
    base.update(kw)
    return mod.LDAConfig(**base)


# --------------------------------------------------------------------------- #
# Random numbers, cumulative sums, data and layout: bitwise
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("seed", [0, 1, 7, 2 ** 31 - 1, -3])
def test_threefry_bitwise_jax_random(seed):
    key = jax.random.PRNGKey(seed)
    tkey = threefry.prng_key(seed)
    np.testing.assert_array_equal(np.asarray(key).astype(np.int64),
                                  tkey.numpy())
    for data in (0, 5, 123456789):
        np.testing.assert_array_equal(
            np.asarray(jax.random.fold_in(key, data)).astype(np.int64),
            threefry.fold_in(tkey, data).numpy())
    k2 = jax.random.fold_in(key, 3)
    t2 = threefry.fold_in(tkey, 3)
    for num in (2, 3, 5):
        np.testing.assert_array_equal(
            np.asarray(jax.random.split(k2, num)).astype(np.int64),
            threefry.split(t2, num).numpy())
    for shape in ((1,), (7,), (3, 4, 1), (2, 65, 3)):
        np.testing.assert_array_equal(
            np.asarray(jax.random.uniform(k2, shape, jnp.float32)),
            threefry.uniform(t2, shape).numpy())
        np.testing.assert_array_equal(
            np.asarray(jax.random.bits(k2, shape, jnp.uint32)).astype(
                np.int64), threefry.random_bits(t2, shape).numpy())


def test_threefry_batched_over_workers():
    # the CGS stream: fold_in(PRNGKey(0), seed + worker), split, uniform
    seed = 11
    tkeys = threefry.fold_in(threefry.prng_key(0), torch.arange(4) + seed)
    for w in range(4):
        key = jax.random.fold_in(jax.random.PRNGKey(0), jnp.int32(seed) + w)
        key, sub = jax.random.split(key)
        pair = threefry.split(tkeys[w])
        np.testing.assert_array_equal(np.asarray(key).astype(np.int64),
                                      pair[0].numpy())
        np.testing.assert_array_equal(
            np.asarray(jax.random.uniform(sub, (6, 5, 1), jnp.float32)),
            threefry.uniform(pair[1], (6, 5, 1)).numpy())


@pytest.mark.parametrize("k", [2, 8, 16, 17, 32, 64, 100, 300])
def test_xla_cumsum_bitwise_jnp_cumsum(k):
    p = (np.random.default_rng(k).random((20, 7, k)) ** 3 * 1e3
         ).astype(np.float32)
    want = np.asarray(jax.jit(lambda x: jnp.cumsum(x, axis=-1))(p))
    np.testing.assert_array_equal(tl.xla_cumsum(torch.from_numpy(p)).numpy(),
                                  want)


@pytest.mark.parametrize("args", [(40, 50, 4, 16, 3), (64, 2000, 16, 128, 3),
                                  (7, 300, 8, 33, 0)])
def test_lda_corpus_bitwise(args):
    n, v, k, l, seed = args
    np.testing.assert_array_equal(
        tdatagen.lda_corpus(n, v, k, l, seed=seed),
        jdatagen.lda_corpus(n, v, k, l, seed=seed))


def test_loaders_match_jax(tmp_path):
    got = tloaders.load_corpus(os.path.join(REPO, "datasets", "lda"))
    want = jloaders.load_corpus(os.path.join(REPO, "datasets", "lda"))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(tloaders.truncate_to_workers(got, 3),
                                  jloaders.truncate_to_workers(want, 3))
    with pytest.raises(ValueError, match="cannot shard"):
        tloaders.truncate_to_workers(got[:2], 3)
    (tmp_path / "a").write_text("1 2 3\n")
    (tmp_path / "b").write_text("1 2\n")
    with pytest.raises(ValueError, match="disagree on document length"):
        tloaders.load_corpus(str(tmp_path))


def test_bucketize_bitwise(docs):
    from harp_tpu.models.sgd_mf import serpentine_assign

    wb, ws = serpentine_assign(np.bincount(docs.reshape(-1), minlength=60), 8)
    for a, b in zip(tl.bucketize_tokens(docs, 8, 8, wb, ws),
                    jl.bucketize_tokens(docs, 8, 8, wb, ws)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tl.bucketize_tokens(docs, 4, 15),
                    jl.bucketize_tokens(docs, 4, 15)):
        np.testing.assert_array_equal(a, b)
    wb, ws = serpentine_assign(np.bincount(docs.reshape(-1), minlength=60), 2)
    for a, b in zip(tl.bucketize_tokens_subblock(docs, 2, 32, 8, wb, ws),
                    jl.bucketize_tokens_subblock(docs, 2, 32, 8, wb, ws)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="multiple of sub"):
        tl.bucketize_tokens_subblock(docs, 2, 30, 8, wb, ws)


@pytest.mark.parametrize("batch,chunk", [((), None), ((), 7), ((3,), None),
                                         ((2, 2), 5)])
def test_gemm_scatter_bitwise(batch, chunk):
    rng = np.random.default_rng(len(batch))
    t, width, k = 53, 24, 6
    ids = rng.integers(0, width, batch + (t,)).astype(np.int32)
    delta = rng.integers(-1, 2, batch + (t, k)).astype(np.float32)
    want = np.asarray(jlp.gemm_scatter(jnp.asarray(ids), jnp.asarray(delta),
                                       width, chunk=chunk))
    got = tlp.gemm_scatter(torch.from_numpy(ids), torch.from_numpy(delta),
                           width, chunk=chunk)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    real = rng.standard_normal(batch + (t, k)).astype(np.float32)
    np.testing.assert_allclose(
        tlp.gemm_scatter(torch.from_numpy(ids), torch.from_numpy(real),
                         width, chunk=chunk, policy="f32").numpy(),
        np.asarray(jlp.gemm_scatter(jnp.asarray(ids), jnp.asarray(real),
                                    width, chunk=chunk, policy="f32")),
        rtol=1e-5, atol=1e-5)


def test_scatter_helpers_and_errors():
    for args in ((1000, 128), (4096, 8064, 1), (53 * 7, 128, 63), (0, 8)):
        assert tlp.scatter_chunk(*args) == jlp.scatter_chunk(*args)
    slots = np.arange(300)
    for a, b in zip(tlp.sub_block_split(torch.from_numpy(slots), 128),
                    jlp.sub_block_split(jnp.asarray(slots), 128)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ids = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError, match="exact_pm1"):
        tlp.gemm_scatter(ids, torch.zeros(4, 2, dtype=torch.float64), 3)
    with pytest.raises(ValueError, match="policy must be one of"):
        tlp.gemm_scatter(ids, torch.zeros(4, 2), 3, policy="int8")
    with pytest.raises(ValueError, match="trailing K axis"):
        tlp.gemm_scatter(ids, torch.zeros(4), 3)


# --------------------------------------------------------------------------- #
# CGS in lock step with the JAX package, from one state
# --------------------------------------------------------------------------- #

def _jax_state_arrays(state):
    key, data, seed, (wb, ws, vpb) = state
    docs_b, mask_b, z, wt = (np.asarray(a) for a in data)
    return {"docs": docs_b, "mask": mask_b, "z": z, "wt": wt,
            "word_block": wb, "word_slot": ws, "vpb": vpb}


def _record_draws(monkeypatch):
    """Record (cdf, u, z) of every CGS draw of the port, in call order."""
    draws, pending = [], {}
    real_cumsum, real_uniform = tl.xla_cumsum, threefry.uniform

    def cumsum(p):
        out = real_cumsum(p)
        pending["cdf"] = out
        return out

    def uniform(key, shape):
        out = real_uniform(key, shape)
        draws.append((pending["cdf"], out[..., 0] * pending["cdf"][..., -1]))
        return out

    monkeypatch.setattr(tl, "xla_cumsum", cumsum)
    monkeypatch.setattr(threefry, "uniform", uniform)
    return draws


def _near_tie(cdf, u, z):
    """Draws whose u lies within TIE (relative) of a boundary of z."""
    scale = cdf[..., -1]
    hi = cdf.gather(-1, z[..., None].long())[..., 0]
    lo = torch.where(z > 0, cdf.gather(-1, (z - 1).clamp(min=0)[..., None]
                                       .long())[..., 0],
                     torch.zeros_like(hi))
    return (((u - hi).abs() <= TIE * scale)
            | ((u - lo).abs() <= TIE * scale) & (z > 0))


def _lockstep(jm, tm, jstate, epochs_before, monkeypatch):
    """Run the JAX chain ``epochs_before`` epochs, hand its state to the
    port, then one epoch in both; compare every draw. Returns the number of
    counted near-tie draws that differed and of those checked."""
    key, data, seed, maps = jstate
    fn = jm._fns[key]
    if epochs_before:
        pre = jl.LDA(jm.session, jm.config.__class__(
            **{**jm.config.__dict__, "epochs": epochs_before}))
        pre_fn = pre._build(*key[:3], key[3] // key[0], key[6])
        _, wt, z, _ = pre_fn(*data[:2], data[2], data[3], seed)
        data = (data[0], data[1], z, wt)
    arrays = _jax_state_arrays((key, data, seed, maps))
    tstate = convert.lda_state_from_jax(tm, arrays, seed=int(seed) + 1)
    draws = _record_draws(monkeypatch)
    tkey = tstate[0]
    t_dt, t_wt, t_z, t_ll = tm._fns[tkey](*tstate[1], tstate[2])
    j_dt, j_wt, j_z, j_ll = fn(*data, jnp.asarray(int(seed) + 1, jnp.int32))
    j_z, j_wt, j_dt = np.asarray(j_z), np.asarray(j_wt), np.asarray(j_dt)
    # the port's draws, in its call order: hop t, row r, group g
    cfg = tm.config
    w = tm.session.num_workers
    ns = cfg.num_model_slices
    d_local = arrays["docs"].shape[0] // w
    nmb = tm._effective_minibatches(d_local)
    dg = d_local // nmb
    steps = w * ns
    assert len(draws) == steps * w * nmb
    zl = j_z.reshape(w, d_local, *j_z.shape[1:])
    mask = arrays["mask"].reshape(w, d_local, *arrays["mask"].shape[1:])
    parted, differed, ties = set(), 0, 0
    i = 0
    for t in range(steps):
        parted_now = set(parted)
        for r in range(w):
            src = (r - t) % w if ns == 1 else (t % 2) * w + (r - t // 2) % w
            for g in range(nmb):
                cdf, u = draws[i]
                i += 1
                if r in parted_now:
                    continue
                sl = slice(g * dg, (g + 1) * dg)
                want = torch.from_numpy(zl[r, sl, src].astype(np.int64))
                # the port's own draw (recomputed from its cdf and u)
                got = torch.clamp((cdf < u[..., None]).sum(-1), 0,
                                  cfg.num_topics - 1)
                m = torch.from_numpy(mask[r, sl, src] > 0)
                tie = _near_tie(cdf, u, got) & m
                ties += int(tie.sum())
                diff = (got != want) & m
                if diff.any():
                    assert bool((diff <= tie).all()), (
                        f"draws differ away from any near tie at hop {t}, "
                        f"worker {r}, group {g}")
                    differed += int(diff.sum())
                    parted_now.add(r)         # this row's chain has parted
        parted |= parted_now
        if parted:
            parted = set(range(w))            # the totals carry it everywhere
    if not differed:
        # one chain: the counts are exact and equal
        np.testing.assert_array_equal(t_z.numpy(), j_z)
        np.testing.assert_array_equal(t_wt.numpy(), j_wt)
        np.testing.assert_array_equal(t_dt.numpy(), j_dt)
        np.testing.assert_allclose(t_ll.numpy(), np.asarray(j_ll),
                                   rtol=1e-6)
    return differed, ties


@pytest.mark.parametrize("w,ns,extra", [
    (1, 1, {}), (4, 1, {}), (4, 2, {}), (1, 1, {"vocab_sub_block": 16}),
    (4, 1, {"wt_access": "gather"}), (4, 2, {"wt_access": "gemm"})])
def test_cgs_epoch_in_lock_step_with_jax(docs, sessions, monkeypatch, w, ns,
                                         extra):
    js, ts = sessions
    jm = jl.LDA(js[w], _cfg(jl, epochs=1, num_model_slices=ns, **extra))
    tm = tl.LDA(ts[w], _cfg(tl, epochs=1, num_model_slices=ns, **extra))
    jstate = jm.prepare(docs, seed=3)
    differed, ties = _lockstep(jm, tm, jstate, 2, monkeypatch)
    assert differed <= ties
    assert differed == 0, f"{differed} near-tie draws differed"


def _counts_from_z(z, mask, docs_b, wt_rows, k):
    oh = np.eye(k, dtype=np.float32)[z] * mask[..., None]
    return oh.sum(axis=(1, 2))


@pytest.mark.parametrize("w,ns", [(1, 1), (4, 2)])
def test_cgs_fit_bitwise_jax_and_counts_consistent(docs, sessions, w, ns):
    js, ts = sessions
    jdt, jwt, jll = jl.LDA(js[w], _cfg(jl, num_model_slices=ns, epochs=3)
                           ).fit(docs, seed=2)
    tm = tl.LDA(ts[w], _cfg(tl, num_model_slices=ns, epochs=3))
    state = tm.prepare(docs, seed=2)
    tdt, twt, tll = tm.fit_prepared(state)
    np.testing.assert_array_equal(tdt, np.asarray(jdt))
    np.testing.assert_array_equal(twt, np.asarray(jwt))
    np.testing.assert_allclose(tll, np.asarray(jll), rtol=1e-6)
    # counts consistent with z exactly
    key, data, seed, _ = state
    dt, wt_out, z, _ = tm._fns[key](*data, seed)
    mask = data[1].numpy()
    np.testing.assert_array_equal(
        dt.numpy(), _counts_from_z(z.numpy(), mask, None, None, 8))
    assert twt.sum() == docs.size and tdt.sum() == docs.size
    np.testing.assert_array_equal(twt.sum(axis=0), tdt.sum(axis=0))
    for v in range(60):
        assert twt[v].sum() == (docs == v).sum()


def test_cvb0_within_1e5_of_jax(docs, sessions):
    js, ts = sessions
    for w, ns in ((1, 1), (4, 1), (4, 2)):
        jdt, jwt, jll = jl.LDA(js[w], _cfg(jl, method="cvb0",
                                           num_model_slices=ns)
                               ).fit(docs, seed=2)
        tdt, twt, tll = tl.LDA(ts[w], _cfg(tl, method="cvb0",
                                           num_model_slices=ns)
                               ).fit(docs, seed=2)
        for a, b in ((tdt, jdt), (twt, jwt)):
            b = np.asarray(b)
            assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
        np.testing.assert_allclose(tll, np.asarray(jll), rtol=1e-5)


def test_fused_bitwise_unfused_through_the_ring_hop(docs, sessions,
                                                    monkeypatch):
    _, ts = sessions
    calls = []
    real = ring_dma.hop

    def counted(x, shift=1):
        calls.append(tuple(x.shape))
        return real(x, shift)

    monkeypatch.setattr(ring_dma, "hop", counted)
    for ns in (1, 2):
        outs = []
        for fused in (False, True):
            calls.clear()
            outs.append(tl.LDA(ts[4], _cfg(tl, epochs=3, num_model_slices=ns,
                                           fused_dma=fused)).fit(docs, seed=0))
            assert len(calls) == (3 * 4 * ns if fused else 0)
        for a, b in zip(*outs):
            np.testing.assert_array_equal(a, b)


def test_quantized_fits_within_the_jax_bounds(sessions):
    _, ts = sessions
    rng = np.random.default_rng(42)
    qdocs = rng.integers(0, 96, size=(16, 12))
    base = dict(num_topics=4, vocab=96, epochs=4, method="cvb0")
    _, _, ll0 = tl.LDA(ts[8], tl.LDAConfig(**base)).fit(qdocs, seed=0)
    _, _, jll0 = jl.LDA(sessions[0][8], jl.LDAConfig(**base)).fit(qdocs,
                                                                  seed=0)
    np.testing.assert_allclose(ll0, np.asarray(jll0), rtol=1e-5)
    for codec in ("int8", "bf16"):
        _, _, ll = tl.LDA(ts[8], tl.LDAConfig(**base, quant=codec)).fit(
            qdocs, seed=0)
        np.testing.assert_allclose(ll, ll0, rtol=1e-3)
        for ns in (1, 2):
            _, _, ll = tl.LDA(ts[8], tl.LDAConfig(
                **base, quant=codec, quant_wt=True, num_model_slices=ns)
                ).fit(qdocs, seed=0)
            np.testing.assert_allclose(ll, ll0, rtol=0.2)
    # CGS with a quantized topic-total wire still improves the chain
    _, _, ll = tl.LDA(ts[8], tl.LDAConfig(num_topics=4, vocab=96, epochs=4,
                                          quant="int8")).fit(qdocs, seed=0)
    assert ll[-1] > ll[0]


def test_config_errors_match_jax(sessions):
    _, ts = sessions
    for kw, msg in ((dict(method="em"), "method must be"),
                    (dict(num_model_slices=3), "num_model_slices"),
                    (dict(ablate_stage="x"), "ablate_stage must be"),
                    (dict(ablate_stage="sample", method="cvb0"), "sample"),
                    (dict(wt_access="gemm_scatter", method="cvb0"),
                     "requires method='cgs'"),
                    (dict(quant_wt=True), "quant_wt"),
                    (dict(vocab_sub_block=16, method="cvb0"),
                     "vocab_sub_block requires")):
        for mod, s in ((tl, ts[4]), (jl, sessions[0][4])):
            with pytest.raises(ValueError, match=msg):
                mod.LDA(s, _cfg(mod, **kw))


def test_ablations_and_oracles_match_jax(docs, sessions):
    js, ts = sessions
    for kw in (dict(ablate_rotation=True), dict(ablate_stage="sample"),
               dict(ablate_stage="gather+scatter")):
        j = jl.LDA(js[4], _cfg(jl, **kw)).fit(docs, seed=1)
        t = tl.LDA(ts[4], _cfg(tl, **kw)).fit(docs, seed=1)
        for a, b in zip(t[:2], j[:2]):
            np.testing.assert_array_equal(a, np.asarray(b))
    wt = np.random.default_rng(0).integers(0, 5, (60, 8)).astype(np.float32)
    dt = np.random.default_rng(1).integers(0, 5, (32, 8)).astype(np.float32)
    assert tl.reference_log_likelihood(wt, 0.01, 60) == \
        jl.reference_log_likelihood(wt, 0.01, 60)
    assert tl.full_model_log_likelihood(dt, wt, 0.1, 0.01, 60) == \
        jl.full_model_log_likelihood(dt, wt, 0.1, 0.01, 60)
    small = docs[:4, :6]
    for a, b in zip(tl.sequential_cgs_reference(small, _cfg(tl), seed=3),
                    jl.sequential_cgs_reference(small, _cfg(jl), seed=3)):
        np.testing.assert_array_equal(a, b)


def test_converter_round_trip(docs, sessions):
    js, ts = sessions
    jstate = jl.LDA(js[4], _cfg(jl, num_model_slices=2)).prepare(docs, 4)
    tm = tl.LDA(ts[4], _cfg(tl, num_model_slices=2))
    arrays = _jax_state_arrays(jstate)
    back = convert.lda_state_to_jax(tm, convert.lda_state_from_jax(
        tm, arrays, seed=4))
    for name in convert.LDA_ARRAYS:
        np.testing.assert_array_equal(back[name], np.asarray(arrays[name]))
    # the port's own prepare gives the same state
    own = convert.lda_state_to_jax(tm, tm.prepare(docs, seed=4))
    for name in convert.LDA_ARRAYS:
        np.testing.assert_array_equal(own[name], np.asarray(arrays[name]))
    with pytest.raises(ValueError, match="does not match"):
        convert.lda_state_from_jax(tl.LDA(ts[4], _cfg(tl)), arrays)


# --------------------------------------------------------------------------- #
# Checkpoints
# --------------------------------------------------------------------------- #

def test_fit_checkpointed_resume_bitwise_uninterrupted(tmp_path, docs,
                                                       sessions):
    _, ts = sessions
    for method in ("cgs", "cvb0"):
        cfg = _cfg(tl, epochs=5, method=method)
        m = tl.LDA(ts[4], cfg)
        st = m.prepare(docs, seed=1)
        dt_a, wt_a, ll_a, s_a = m.fit_checkpointed(
            st, Checkpointer(str(tmp_path / method / "a")), save_every=2)
        assert s_a == 0 and len(ll_a) == 5
        # interrupted at a checkpoint of the save_every grid
        m.fit_checkpointed(st, Checkpointer(str(tmp_path / method / "b")),
                           save_every=2, epochs=4)
        m2 = tl.LDA(ts[4], cfg)
        dt_b, wt_b, ll_b, s_b = m2.fit_checkpointed(
            m2.prepare(docs, seed=1),
            Checkpointer(str(tmp_path / method / "b")), save_every=2)
        assert s_b == 4
        np.testing.assert_array_equal(dt_b, dt_a)
        np.testing.assert_array_equal(wt_b, wt_a)
        np.testing.assert_array_equal(ll_b, ll_a[4:])
        # fully resumed: doc_topic rebuilt from z
        dt_c, wt_c, ll_c, s_c = m2.fit_checkpointed(
            m2.prepare(docs, seed=1),
            Checkpointer(str(tmp_path / method / "b")), save_every=2)
        assert s_c == 5 and len(ll_c) == 0
        np.testing.assert_allclose(dt_c, dt_a, atol=1e-5)
        np.testing.assert_array_equal(wt_c, wt_a)


def test_fit_checkpointed_matches_jax(tmp_path, docs, sessions):
    js, ts = sessions
    j = jl.LDA(js[4], _cfg(jl, epochs=3))
    jdt, jwt, jll, _ = j.fit_checkpointed(
        j.prepare(docs, seed=1),
        JaxCheckpointer(str(tmp_path / "j"), use_orbax=False), save_every=2)
    t = tl.LDA(ts[4], _cfg(tl, epochs=3))
    tdt, twt, tll, _ = t.fit_checkpointed(
        t.prepare(docs, seed=1), Checkpointer(str(tmp_path / "t")),
        save_every=2)
    np.testing.assert_array_equal(tdt, np.asarray(jdt))
    np.testing.assert_array_equal(twt, np.asarray(jwt))
    np.testing.assert_allclose(tll, jll, rtol=1e-6)


@pytest.fixture(scope="module")
def w8_chain(tmp_path_factory, docs, sessions):
    """A JAX-written W=8 CGS chain (1 and 2 slices) and the JAX package's
    W=4 resumed counts."""
    js, _ = sessions
    root = tmp_path_factory.mktemp("lda")
    out = {}
    for ns in (1, 2):
        m8 = jl.LDA(js[8], _cfg(jl, num_model_slices=ns))
        d = root / f"w8s{ns}"
        m8.fit_checkpointed(m8.prepare(docs, seed=0),
                            JaxCheckpointer(str(d), use_orbax=False),
                            save_every=1)
        shutil.copytree(d, root / f"j{ns}")
        m4 = jl.LDA(js[4], _cfg(jl, num_model_slices=ns))
        dt, wt, ll, start = m4.fit_checkpointed(
            m4.prepare(docs, seed=0),
            JaxCheckpointer(str(root / f"j{ns}"), use_orbax=False),
            save_every=1)
        assert start == 2 and len(ll) == 0
        out[ns] = (d, np.asarray(dt), np.asarray(wt))
    return out


@pytest.mark.parametrize("mode", ["device", "ring", "host"])
@pytest.mark.parametrize("ns", [1, 2])
def test_chain_resume_w8_to_w4_gives_jax_counts(tmp_path, docs, sessions,
                                                w8_chain, mode, ns):
    _, ts = sessions
    d, jdt, jwt = w8_chain[ns]
    shutil.copytree(d, tmp_path / "ck")
    m4 = tl.LDA(ts[4], _cfg(tl, num_model_slices=ns, reshard=mode))
    dt, wt, ll, start = m4.fit_checkpointed(
        m4.prepare(docs, seed=0), Checkpointer(str(tmp_path / "ck")),
        save_every=1)
    assert start == 2 and len(ll) == 0
    np.testing.assert_array_equal(wt, jwt)
    np.testing.assert_array_equal(dt, jdt)


def test_chain_resume_errors(tmp_path, docs, sessions):
    _, ts = sessions
    ck = Checkpointer(str(tmp_path / "mf"))
    ck.save(1, {"w": np.zeros(2)}, meta={"shapes": {"w": [2]},
                                         "dtypes": {"w": "float64"},
                                         "model": "sgd_mf"})
    m = tl.LDA(ts[4], _cfg(tl))
    st = m.prepare(docs, seed=0)
    with pytest.raises(ValueError, match="written by model 'sgd_mf'"):
        m.fit_checkpointed(st, ck)
    with pytest.raises(ValueError, match="no world metadata"):
        m._repartition_chain({}, None, {}, 8, (32, 4, 8))
    m8 = tl.LDA(ts[8], _cfg(tl))
    m8.fit_checkpointed(m8.prepare(docs, seed=0),
                        Checkpointer(str(tmp_path / "c")), save_every=2)
    other = tl.LDA(ts[4], _cfg(tl, vocab=61))
    with pytest.raises(ValueError, match="does not describe this model"):
        other.fit_checkpointed(other.prepare(docs, seed=0),
                               Checkpointer(str(tmp_path / "c")))
    with pytest.raises(ValueError, match="exceeds the requested"):
        m8.fit_checkpointed(m8.prepare(docs, seed=0),
                            Checkpointer(str(tmp_path / "c")), epochs=1)


# --------------------------------------------------------------------------- #
# The CLI
# --------------------------------------------------------------------------- #

def _cli(module, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2",
               PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-m", module, *args],
                         capture_output=True, text=True, timeout=240,
                         cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_cli_lda_and_save_every_match_jax(tmp_path):
    ll = r"ll (\S+) -> (\S+)"
    args = ("--num-workers", "4", "--num-docs", "64", "--doc-len", "16",
            "--vocab", "100", "--num-topics", "8", "--epochs", "3")
    j = _cli("harp_tpu.run", "lda", "--cpu-mesh", *args)
    t = _cli("harp_tpu_torch.run", "lda", "--device", "cpu", *args)
    assert re.search(ll, j).groups() == re.search(ll, t).groups()
    assert t.startswith("lda[cgs] workers=4 docs=64 vocab=100 K=8: ")
    corpus = ("--num-workers", "2", "--corpus-file", "datasets/lda",
              "--epochs", "3", "--save-every", "2")
    j = _cli("harp_tpu.run", "lda", "--cpu-mesh", *corpus, "--work-dir",
             str(tmp_path / "j"))
    t = _cli("harp_tpu_torch.run", "lda", "--device", "cpu", *corpus,
             "--work-dir", str(tmp_path / "t"))
    assert re.search(ll, j).groups() == re.search(ll, t).groups()
    again = _cli("harp_tpu_torch.run", "lda", "--device", "cpu", *corpus,
                 "--work-dir", str(tmp_path / "t"))
    assert "fully resumed from checkpoint" in again
    km = ("kmeans", "--num-workers", "4", "--num-points", "2048", "--dim",
          "16", "--num-centroids", "8", "--iterations", "4",
          "--save-every", "2")
    j = _cli("harp_tpu.run", km[0], "--cpu-mesh", *km[1:], "--work-dir",
             str(tmp_path / "jk"))
    t = _cli("harp_tpu_torch.run", km[0], "--device", "cpu", *km[1:],
             "--work-dir", str(tmp_path / "tk"))
    cost = r"cost (\S+) -> (\S+)"
    assert re.search(cost, j).groups() == re.search(cost, t).groups()
    assert sorted(os.listdir(tmp_path / "tk" / "ckpt")) == sorted(
        os.listdir(tmp_path / "jk" / "ckpt"))
    mf = ("sgd_mf", "--num-workers", "4", "--num-users", "256",
          "--num-items", "256", "--rank", "8", "--epochs", "3",
          "--layout", "sparse", "--save-every", "2")
    j = _cli("harp_tpu.run", mf[0], "--cpu-mesh", *mf[1:], "--work-dir",
             str(tmp_path / "jm"))
    t = _cli("harp_tpu_torch.run", mf[0], "--device", "cpu", *mf[1:],
             "--work-dir", str(tmp_path / "tm"))
    rmse = r"rmse (\S+) -> (\S+)"
    assert re.search(rmse, j).groups() == re.search(rmse, t).groups()
    # resumed at another worker count from the port's own checkpoint
    t2 = _cli("harp_tpu_torch.run", "sgd_mf", "--device", "cpu",
              "--num-workers", "2", *mf[3:], "--epochs", "4", "--work-dir",
              str(tmp_path / "tm"))
    assert "rmse" in t2
    with pytest.raises(AssertionError, match="requires --work-dir"):
        _cli("harp_tpu_torch.run", "lda", "--device", "cpu",
             "--save-every", "2")


class _HostEvent:
    """``torch.cuda.Event`` on the host clock, for the budget on the CPU."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


class _NoProfile:
    def __init__(self, *a, **k):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def key_averages(self):
        return []


@pytest.mark.parametrize("sub_block", [0, 16])
def test_lda_budget_measure_on_the_cpu(monkeypatch, sub_block):
    """``benchmark/lda_budget.measure`` at a small row, with the card's
    timer, profiler and ``nvidia-smi`` stubbed: every budget and the gather
    path write the word-topic table bitwise the default budget's."""
    import functools as _ft
    import types

    from harp_tpu_torch import session as tsession
    from harp_tpu_torch.benchmark import lda_budget

    monkeypatch.setattr(tsession, "HarpSession",
                        _ft.partial(TorchSession, device="cpu"))
    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    monkeypatch.setattr(torch.profiler, "profile", _NoProfile)
    monkeypatch.setattr(lda_budget.subprocess, "run",
                        lambda *a, **k: types.SimpleNamespace(
                            stdout="card, 1.00 W\n"))
    out = lda_budget.measure(64, 200, 16, 8, sub_block=sub_block)
    assert out["card"] == "card, 1.00 W"
    assert out["wt_path"] == ("gemm_scatter_subblock" if sub_block
                              else "gemm_scatter")
    assert out["profile"]["kernel_launches"] == 0
    rows = out["budgets"].values()
    assert len(rows) == len(lda_budget.BUDGETS)
    assert all(r["bitwise"] and r["one_hot_chunks_an_epoch"] >= 1
               and r["epoch_ms"] > 0 for r in rows)
    assert ("gather" in out) == (not sub_block)
    if not sub_block:
        assert out["gather"]["bitwise"]
