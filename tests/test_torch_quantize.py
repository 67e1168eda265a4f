"""The port's quantized wire format against the JAX package's, on the CPU.

``harp_tpu_torch.collectives.quantize`` against ``harp_tpu.collectives.
quantize`` on the same numpy inputs:

* the codecs bitwise: int8 codes and float32 scales (a ragged length, an
  all-zero block, exact .5 ties that round half to even), bf16 payloads,
  the decodes and the error-feedback residual; the packed-row codec;
* the quantized collectives at W=4 (``allreduce``, ``reduce_scatter``,
  ``allgather``, ``rotate`` through ``lax_ops`` with ``comm=``, with and
  without a residual) and their ``table_ops`` faces: both packages decode
  the same codes and differ only in the order of the float32 sum over the
  sources, so results and residuals agree within 1e-6 of the largest
  input;
* the error-fed ``rotate_scan`` and ``pipelined_rotation`` (``ef_state``),
  integer leaves exact;
* the quantized K-means fits (four variants x two codecs, against the JAX
  fits with ``lane_pad=False``: the JAX lane padding moves the int8
  blocks) and SGD-MF fits (1 and 2 slices x two codecs), within 1e-5, and
  against the port's float32 fits within the JAX tests' own bounds
  (``tests/test_quantize.py``); ``bcastreduce`` refuses quant;
* ``run kmeans --quant int8`` against ``harp_tpu.run`` (whose launcher drops
  ``--quant`` and fits on the float32 wire), within the int8 bound.
"""

import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harp_tpu import combiner as jcb
from harp_tpu import partitioner as jpart
from harp_tpu.collectives import lax_ops as jlax
from harp_tpu.collectives import quantize as jq
from harp_tpu.collectives import rotation as jrot
from harp_tpu.collectives import table_ops as jtops
from harp_tpu.io import datagen as jdatagen
from harp_tpu.models import kmeans as jkm
from harp_tpu.models import sgd_mf as jmf
from harp_tpu.session import HarpSession as JaxSession
from harp_tpu.table import Table as JTable
from harp_tpu_torch import combiner as tcb
from harp_tpu_torch import partitioner as tpart
from harp_tpu_torch import run as trun
from harp_tpu_torch.collectives import lax_ops as tlax
from harp_tpu_torch.collectives import quantize as tq
from harp_tpu_torch.collectives import rotation as trot
from harp_tpu_torch.collectives import table_ops as ttops
from harp_tpu_torch.models import kmeans as tkm
from harp_tpu_torch.models import sgd_mf as tmf
from harp_tpu_torch.ops import ring_dma
from harp_tpu_torch.session import HarpSession as TorchSession
from harp_tpu_torch.table import Table as TTable

REPO = pathlib.Path(__file__).resolve().parents[1]
W = 4
CODECS = ["int8", "bf16"]
_SESSIONS = {}


def sessions(w=W):
    if w not in _SESSIONS:
        _SESSIONS[w] = (JaxSession(num_workers=w),
                        TorchSession(num_workers=w, device="cpu"))
    return _SESSIONS[w]


def bits(a) -> np.ndarray:
    a = a.float().numpy() if isinstance(a, torch.Tensor) and (
        a.dtype == torch.bfloat16) else np.asarray(
        a.astype(jnp.float32) if hasattr(a, "dtype") and a.dtype == jnp.bfloat16
        else a)
    a = np.ascontiguousarray(a)
    return a.view(np.uint8)


def same_bits(a, b) -> bool:
    a = a.numpy() if isinstance(a, torch.Tensor) and a.dtype != torch.bfloat16 \
        else a
    return np.array_equal(bits(a), bits(b))


def close(a, b, scale, tol=1e-6):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert float(np.abs(a - b).max()) <= tol * scale, (
        float(np.abs(a - b).max()), scale)


def vector(n, seed):
    """Values over six decades with zero runs (an all-zero block at n >=
    256)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 3, n)).astype(
        np.float32)
    x[:min(n, 256)] = 0.0 if n >= 512 else x[:min(n, 256)]
    x[-min(n, 5):] *= 0.0
    return x


# --------------------------------------------------------------------------- #
# Config and codecs
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("n,chunks", [(1, 1), (7, 1), (255, 1), (256, 1),
                                      (257, 1), (1000, 4), (5, 8)])
def test_block_for_and_wire_bytes_match_jax(n, chunks):
    for block in (1, 16, 256):
        jc, tc = jq.CommConfig("int8", block), tq.CommConfig("int8", block)
        assert tq._block_for(n, tc, chunks) == jq._block_for(n, jc, chunks)
        assert tq.wire_bytes_per_element(tc, n) == jq.wire_bytes_per_element(
            jc, n)
    for q in (None, "bf16"):
        assert (tq.wire_bytes_per_element(tq.CommConfig(q), n)
                == jq.wire_bytes_per_element(jq.CommConfig(q), n))
    assert tq.wire_bytes_per_element(None) == 4.0
    with pytest.raises(ValueError, match="block must be"):
        tq.CommConfig("int8", 0)
    assert not tq.CommConfig().active and tq.CommConfig("bf16").active


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("n", [1, 7, 300, 1000, 4099])
def test_codecs_bitwise_jax(codec, n):
    x = vector(n, n)
    res = (np.random.default_rng(n + 1).standard_normal(n) * 0.01).astype(
        np.float32)
    jc, tc = jq.CommConfig(codec), tq.CommConfig(codec)
    block = jq._block_for(n, jc)
    jp, js, jn = jq.encode_flat(jnp.asarray(x), jc, block)
    tp, ts, tn = tq.encode_flat(torch.from_numpy(x), tc, block)
    assert jn == tn == n
    assert same_bits(tp, jp), "codes"
    if codec == "int8":
        assert tp.dtype == torch.int8 and tp.shape == jp.shape
        assert same_bits(ts, js), "scales"
    else:
        assert ts is None and js is None and tp.dtype == torch.bfloat16
    assert same_bits(tq.decode_flat(tp, ts, n, tc),
                     jq.decode_flat(jp, js, n, jc))
    *_, jr = jq.ef_encode_flat(jnp.asarray(x), jnp.asarray(res), jc, block)
    *_, tr = tq.ef_encode_flat(torch.from_numpy(x), torch.from_numpy(res),
                               tc, block)
    assert same_bits(tr, jr), "residual"
    # stacked rows encode independently: row i's codes are row i alone's
    two = torch.from_numpy(np.stack([x, res]))
    sp, ss, _ = tq.encode_flat(two, tc, block)
    assert torch.equal(sp[0], tp)
    if ss is not None:
        assert torch.equal(ss[0], ts)


def test_ties_round_half_to_even_and_zero_blocks():
    """A block whose largest |x| is 127 has scale 1, so x = k + 0.5 is an
    exact tie; both packages round it to the even code. An all-zero block
    encodes to zero codes with scale 0 and decodes to exact zeros."""
    x = np.array([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -2.5],
                 np.float32)
    x = np.concatenate([x, np.zeros(8, np.float32)])
    jc, tc = jq.CommConfig("int8", 8), tq.CommConfig("int8", 8)
    jp, js, _ = jq.encode_flat(jnp.asarray(x), jc, 8)
    tp, ts, _ = tq.encode_flat(torch.from_numpy(x), tc, 8)
    assert same_bits(tp, jp) and same_bits(ts, js)
    assert tp[0].tolist() == [127, 2, -4, 0, 0, 2, 126, -2]
    assert tp[1].tolist() == [0] * 8 and ts.tolist() == [1.0, 0.0]
    dec = tq.decode_flat(tp, ts, 16, tc)
    assert torch.equal(dec[8:], torch.zeros(8))


def test_packed_rows_match_jax():
    rng = np.random.default_rng(3)
    rows = rng.standard_normal((5, 3, 12)).astype(np.float32)
    rows[1, 2] = 0.0                                   # a default row
    packed = tq.encode_rows_np(rows)
    jpacked = jq.encode_rows_np(rows)
    assert packed.dtype == np.int8 and np.array_equal(packed, jpacked)
    assert packed.shape[-1] == tq.packed_row_width(12) == 16
    q, scale = tq.decode_rows(torch.from_numpy(packed))
    jqq, jscale = jq.decode_rows(jnp.asarray(packed))
    assert same_bits(q, jqq) and same_bits(scale, jscale)
    deq = tq.dequantize_rows(torch.from_numpy(packed))
    assert same_bits(deq, jq.dequantize_rows(jnp.asarray(packed)))
    assert torch.equal(deq[1, 2], torch.zeros(12))
    # the scale round trip is exact: its bits are the row's tail
    want = (np.abs(rows).max(-1) / 127.0).astype(np.float32)
    assert np.array_equal(scale.numpy().view(np.uint32), want.view(np.uint32))


# --------------------------------------------------------------------------- #
# Collectives
# --------------------------------------------------------------------------- #

DATA = np.random.default_rng(0).standard_normal((W * 8, 5, 7)).astype(
    np.float32)
RES = (np.random.default_rng(1).standard_normal((W * 8, 5, 7)) * 0.01
       ).astype(np.float32)
SCALE = float(np.abs(DATA).max())


def _jax_op(op, jc, residual):
    if op == "allreduce":
        return lambda a, r: jlax.allreduce(a, jcb.SUM, comm=jc, residual=r)
    if op == "reduce_scatter":
        return lambda a, r: jlax.reduce_scatter(a, jcb.AVG, comm=jc,
                                                residual=r)
    if op == "allgather":
        return lambda a, r: jlax.allgather(a, comm=jc)
    return lambda a, r: jlax.rotate(a, 3, comm=jc)


def _torch_op(op, tc):
    if op == "allreduce":
        return lambda a, r: tlax.allreduce(a, tcb.SUM, comm=tc, residual=r)
    if op == "reduce_scatter":
        return lambda a, r: tlax.reduce_scatter(a, tcb.AVG, comm=tc,
                                                residual=r)
    if op == "allgather":
        return lambda a, r: tlax.allgather(a, comm=tc)
    return lambda a, r: tlax.rotate(a, 3, comm=tc)


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("op,residual", [
    ("allreduce", False), ("allreduce", True), ("reduce_scatter", False),
    ("reduce_scatter", True), ("allgather", False), ("rotate", False)])
def test_quantized_collectives_match_jax(op, residual, codec):
    """allgather and rotate carry no residual (stateless)."""
    js, ts = sessions()
    jc, tc = jq.CommConfig(codec), tq.CommConfig(codec)
    res = RES if residual else None
    out_spec = "rep" if op in ("allreduce", "allgather") else "shard"
    jspec = js.replicate() if out_spec == "rep" else js.shard()
    tspec = ts.replicate() if out_spec == "rep" else ts.shard()
    jf, tf = _jax_op(op, jc, residual), _torch_op(op, tc)
    if residual:
        jo, jr = js.run(jf, DATA, res, in_specs=(js.shard(), js.shard()),
                        out_specs=(jspec, js.shard()))
        to, tr = ts.run(tf, torch.from_numpy(DATA), torch.from_numpy(res),
                        in_specs=(ts.shard(), ts.shard()),
                        out_specs=(tspec, ts.shard()))
        close(tr.numpy(), jr, SCALE)
    else:
        jo = js.run(lambda a: jf(a, None), DATA, in_specs=(js.shard(),),
                    out_specs=jspec)
        to = ts.run(lambda a: tf(a, None), torch.from_numpy(DATA),
                    in_specs=(ts.shard(),), out_specs=tspec)
    close(to.numpy(), jo, SCALE * (W if op == "allreduce" else 1))
    # the lossy wire moved the result by a bounded amount from float32
    exact = {"allreduce": DATA.reshape(W, -1, 5, 7).sum(0),
             "reduce_scatter": DATA.reshape(W, W, -1, 5, 7).mean(0).reshape(
                 DATA.shape[0] // W, 5, 7),
             "allgather": DATA, "rotate": np.roll(DATA.reshape(W, -1, 5, 7),
                                                  3, 0).reshape(DATA.shape)}
    if op == "reduce_scatter":
        exact[op] = np.concatenate([DATA.reshape(W, W, -1, 5, 7)[:, i].mean(0)
                                    for i in range(W)])
    # a worker's error is at most half a code step of its block (int8,
    # plus the second stage's; residuals shift the input by up to 0.05)
    bound = (W if op == "allreduce" else 1) * SCALE * (
        1 / 127 if codec == "int8" else 2 ** -8)
    assert float(np.abs(to.numpy() - exact[op]).max()) <= 2 * bound + 0.05


@pytest.mark.parametrize("codec", CODECS)
def test_table_ops_quantized_match_jax(codec):
    """``table_ops.allreduce``/``regroup``/``push`` with a residual and a
    non-block partitioner, ``allgather``/``pull`` with ``comm``."""
    js, ts = sessions()
    jc, tc = jq.CommConfig(codec), tq.CommConfig(codec)
    data = DATA[:, :, 0]                              # (W*8, 5)
    res = RES[:, :, 0]
    jp, tp = jpart.ModuloPartitioner(8, W), tpart.ModuloPartitioner(8, W)

    def jfn(a, r):
        full, r1 = jtops.allreduce(JTable.local(a, num_workers=W), comm=jc,
                                   residual=r)
        g, r2 = jtops.regroup(JTable.local(a, num_workers=W), jp, comm=jc,
                              residual=r)
        zero = JTable.sharded(jnp.zeros_like(g.data), num_workers=W)
        pg, r3 = jtops.push(JTable.local(a, num_workers=W), zero, jp,
                            comm=jc, residual=r)
        pulled = jtops.pull(pg, jp, comm=jc)
        return full.data, pulled.data, r1, r2, r3

    def tfn(a, r):
        full, r1 = ttops.allreduce(TTable.local(a, num_workers=W), comm=tc,
                                   residual=r)
        g, r2 = ttops.regroup(TTable.local(a, num_workers=W), tp, comm=tc,
                              residual=r)
        zero = TTable.sharded(torch.zeros_like(g.data), num_workers=W)
        pg, r3 = ttops.push(TTable.local(a, num_workers=W), zero, tp,
                            comm=tc, residual=r)
        pulled = ttops.pull(pg, tp, comm=tc)
        return full.data, pulled.data, r1, r2, r3

    j = js.run(jfn, data, res, in_specs=(js.shard(), js.shard()),
               out_specs=(js.replicate(),) * 2 + (js.shard(),) * 3)
    t = ts.run(tfn, torch.from_numpy(data), torch.from_numpy(res),
               in_specs=(ts.shard(), ts.shard()),
               out_specs=(ts.replicate(),) * 2 + (ts.shard(),) * 3)
    for a, b in zip(t, j):
        close(a.numpy(), b, W * SCALE)


def test_inactive_comm_and_residual_keep_the_float32_path():
    ts = sessions()[1]
    x = torch.from_numpy(DATA)
    r = torch.from_numpy(RES)
    out, res = ts.run(lambda a, b: tlax.allreduce(a, comm=tq.CommConfig(),
                                                  residual=b), x, r,
                      in_specs=(ts.shard(), ts.shard()),
                      out_specs=(ts.replicate(), ts.shard()))
    assert torch.equal(res, r)
    assert torch.equal(out, ts.run(tlax.allreduce, x, in_specs=(ts.shard(),),
                                   out_specs=ts.replicate()))
    assert tq.zeros_residual((x, x[:1])) [1].shape == (1, 5, 7)


# --------------------------------------------------------------------------- #
# Error-fed rotation
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("two_slice", [False, True])
def test_error_fed_rotation_matches_jax(codec, two_slice):
    """A (float32, int32) block through ``rotate_scan`` (or a pair of
    slices through ``pipelined_rotation``) with ``ef_state`` carried in and
    out: the float leaf and the residual within 1e-6 of JAX's, the integer
    leaf exact."""
    js, ts = sessions()
    jc, tc = jq.CommConfig(codec), tq.CommConfig(codec)
    rng = np.random.default_rng(9)
    f = rng.standard_normal((W * 3, 17)).astype(np.float32)
    i = rng.integers(-50, 50, size=(W * 3, 2)).astype(np.int32)

    def jbody(c, blk, t):
        a, b = blk
        return c + jnp.sum(a), (a * 1.01 + t, b + 1)

    def tbody(c, blk, t):
        a, b = blk
        return c + a.sum((1, 2)), (a * 1.01 + t, b + 1)

    steps = 2 * W + 1
    if two_slice:
        def jfn(a, b):
            blk = (a, b)
            ef = (jrot.ef_zero(blk), jrot.ef_zero(blk))
            c, sa, sb, (ra, rb) = jrot.pipelined_rotation(
                jbody, jnp.zeros(()), blk, blk, steps, comm=jc, ef_state=ef)
            return c[None], sa[0], sa[1], sb[0], ra[0], rb[0]

        def tfn(a, b):
            blk = (a, b)
            ef = (trot.ef_zero(blk), trot.ef_zero(blk))
            c, sa, sb, (ra, rb) = trot.pipelined_rotation(
                tbody, a.new_zeros(a.shape[0]), blk, blk, steps, comm=tc,
                ef_state=ef)
            return c[:, None], sa[0], sa[1], sb[0], ra[0], rb[0]
    else:
        def jfn(a, b):
            blk = (a, b)
            c, out, r = jrot.rotate_scan(jbody, jnp.zeros(()), blk, steps,
                                         comm=jc, ef_state=jrot.ef_zero(blk))
            c, out, r = jrot.rotate_scan(jbody, c, out, W, comm=jc,
                                         ef_state=r)
            return c[None], out[0], out[1], out[0] * 0, r[0], r[0] * 0

        def tfn(a, b):
            blk = (a, b)
            c, out, r = trot.rotate_scan(tbody, a.new_zeros(a.shape[0]), blk,
                                         steps, comm=tc,
                                         ef_state=trot.ef_zero(blk))
            c, out, r = trot.rotate_scan(tbody, c, out, W, comm=tc,
                                         ef_state=r)
            return c[:, None], out[0], out[1], out[0] * 0, r[0], r[0] * 0

    j = js.run(jfn, f, i, in_specs=(js.shard(), js.shard()),
               out_specs=(js.shard(),) * 6)
    t = ts.run(tfn, torch.from_numpy(f), torch.from_numpy(i),
               in_specs=(ts.shard(), ts.shard()),
               out_specs=(ts.shard(),) * 6)
    scale = float(np.abs(np.asarray(j[1])).max())
    assert np.array_equal(t[2].numpy(), np.asarray(j[2]))    # int32 exact
    assert t[2].dtype == torch.int32
    # the carry sums the block in another order: relative to its own size
    close(t[0].numpy(), j[0], float(np.abs(np.asarray(j[0])).max()))
    for k in (1, 3, 4, 5):
        close(t[k].numpy(), j[k], scale)
    assert float(t[4].abs().max()) > 0                         # fed back


def test_rotator_comm_takes_precedence_over_fused_dma(monkeypatch):
    """A quantized SGD-MF fit with ``fused_dma=True`` sends nothing through
    the ring-DMA engine nor the hop kernel's in-kernel send, as in the JAX
    package: bitwise the quantized fit without ``fused_dma``."""
    def refuse(*a, **k):
        raise AssertionError("a quantized hop went through the ring engine")

    monkeypatch.setattr(ring_dma, "hop", refuse)
    monkeypatch.setattr(ring_dma, "use_ring_dma", lambda device=None: True)
    r, c, v = RATINGS
    fits = [tmf.SGDMF(sessions()[1], tmf.SGDMFConfig(
        rank=8, epochs=2, minibatches_per_hop=2, num_slices=ns, quant="int8",
        layout="dense", fused_dma=fused)).fit(r, c, v, 64, 48)
        for ns in (1, 2) for fused in (True, False)]
    for a, b in ((fits[0], fits[1]), (fits[2], fits[3])):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)


# --------------------------------------------------------------------------- #
# Models and the CLI
# --------------------------------------------------------------------------- #

KM_PTS = jdatagen.dense_points(64, 16, seed=12, num_clusters=8)
KM_CEN = jdatagen.initial_centroids(KM_PTS, 8, seed=13)
_F32_FITS = {}


def _f32_kmeans(variant):
    if variant not in _F32_FITS:
        _F32_FITS[variant] = tkm.KMeans(sessions()[1], tkm.KMeansConfig(
            8, 16, iterations=5, comm=variant)).fit(KM_PTS, KM_CEN)
    return _F32_FITS[variant]


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("variant", ["allreduce", "regroupallgather",
                                     "pushpull", "rotation"])
def test_kmeans_quantized_fit_matches_jax(variant, codec):
    js, ts = sessions()
    jc, jk = jkm.KMeans(js, jkm.KMeansConfig(
        8, 16, iterations=5, comm=variant, quant=codec,
        lane_pad=False)).fit(KM_PTS, KM_CEN)
    tc, tk = tkm.KMeans(ts, tkm.KMeansConfig(
        8, 16, iterations=5, comm=variant, quant=codec)).fit(KM_PTS, KM_CEN)
    close(tc.numpy(), jc, float(np.abs(np.asarray(jc)).max()), 1e-5)
    close(tk.numpy(), jk, float(np.asarray(jk).max()), 1e-5)
    # the JAX test's bounds against the float32 fit
    c0, k0 = (t.numpy() for t in _f32_kmeans(variant))
    cen_tol, cost_tol = {"int8": (0.2, 1e-2), "bf16": (0.05, 1e-3)}[codec]
    assert np.abs(tc.numpy() - c0).max() < cen_tol
    np.testing.assert_allclose(tk.numpy(), k0, rtol=2e-2)
    np.testing.assert_allclose(tk.numpy()[-1], k0[-1], rtol=cost_tol)


def test_kmeans_int8_from_a_start_with_near_ties_tracks_jax():
    """``chip_smoke.py``'s [kmeans:stacked] data and start at a quarter of
    its n (262,144 points, k = 100, d = 100, W=4, 5 iterations): 43 of the
    100 generated clusters get no starting centroid, so centroids that share
    a cluster split it at near ties, and the lossy wire moves the fit to
    another local optimum. Both packages' int8 fits leave the float32
    costs by more than the JAX test's 2e-2 (that bound presumes a start
    without near ties), and the port's trajectory tracks the JAX one within
    1e-4."""
    from harp_tpu_torch.io import datagen as tdatagen

    n, k, d, it, seed = 1 << 18, 100, 100, 5, 21
    pts = tdatagen.dense_points(n, d, seed=seed, num_clusters=k)
    cen0 = tdatagen.initial_centroids(pts, k, seed=seed + 1)
    js, ts = sessions()
    _, j32 = jkm.KMeans(js, jkm.KMeansConfig(
        k, d, it, lane_pad=False)).fit(pts, cen0)
    _, j8 = jkm.KMeans(js, jkm.KMeansConfig(
        k, d, it, quant="int8", lane_pad=False)).fit(pts, cen0)
    _, t8 = tkm.KMeans(ts, tkm.KMeansConfig(k, d, it, quant="int8")).fit(
        pts, cen0)
    j32, j8, t8 = np.asarray(j32), np.asarray(j8), t8.numpy()
    np.testing.assert_allclose(t8, j8, rtol=1e-4)
    assert np.max(np.abs(j8 - j32) / j32) > 2e-2
    assert np.max(np.abs(t8 - j32) / j32) > 2e-2


def test_kmeans_rejects_quantized_bcastreduce():
    with pytest.raises(ValueError, match="bcastreduce"):
        tkm.KMeans(sessions()[1], tkm.KMeansConfig(8, 16, comm="bcastreduce",
                                                   quant="int8"))
    with pytest.raises(ValueError, match="quant must be one of"):
        tkm.KMeans(sessions()[1], tkm.KMeansConfig(8, 16, quant="int4"))


_RNG = np.random.default_rng(42)
RATINGS = (_RNG.integers(0, 64, size=400), _RNG.integers(0, 48, size=400),
           _RNG.normal(size=400).astype(np.float32))


@pytest.mark.parametrize("num_slices", [1, 2])
def test_sgd_mf_quantized_fit_matches_jax(num_slices):
    js, ts = sessions()
    r, c, v = RATINGS
    cfg = dict(rank=8, epochs=4, minibatches_per_hop=2, num_slices=num_slices)
    _, _, r0 = tmf.SGDMF(ts, tmf.SGDMFConfig(**cfg)).fit(r, c, v, 64, 48)
    for codec in CODECS:
        jw, jh, jr = jmf.SGDMF(js, jmf.SGDMFConfig(**cfg, quant=codec)).fit(
            r, c, v, 64, 48)
        tw, th, tr = tmf.SGDMF(ts, tmf.SGDMFConfig(**cfg, quant=codec)).fit(
            r, c, v, 64, 48)
        close(tr, jr, 1.0, 1e-5)
        close(tw, jw, float(np.abs(jw).max()), 1e-5)
        close(th, jh, float(np.abs(jh).max()), 1e-5)
        # the JAX test's bound against the float32 fit
        np.testing.assert_allclose(tr, r0, atol=0.02)
        assert not np.array_equal(tr, r0)


def test_run_kmeans_quant_against_jax(capsys):
    args = ["kmeans", "--num-points", "4000", "--num-workers", "4",
            "--iterations", "6", "--quant", "int8"]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-m", "harp_tpu.run", *args,
                          "--cpu-mesh"], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    jline = out.stdout.strip().splitlines()[-1]
    assert trun.main([*args, "--device", "cpu"]) == 0
    tline = capsys.readouterr().out.strip().splitlines()[-1]
    head = "kmeans[regroupallgather] workers=4 n=4000 k=10 d=100: "
    assert jline.startswith(head) and tline.startswith(head)
    jcost = [float(v) for v in re.findall(r"cost (\S+) -> (\S+)", jline)[0]]
    tcost = [float(v) for v in re.findall(r"cost (\S+) -> (\S+)", tline)[0]]
    assert jcost[0] == tcost[0]                   # the same start
    np.testing.assert_allclose(tcost[1], jcost[1], rtol=1e-2)
    assert tcost[1] != jcost[1]                    # the port took the wire
