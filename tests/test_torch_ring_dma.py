"""The port's ring-DMA engine and process group against the JAX package's,
on the CPU.

The same numpy inputs, made from a seed, go through ``harp_tpu`` on the
8-device virtual mesh (the ``session`` fixture; off the TPU the JAX engine
runs its tagged fallback, as ``tests/test_ring_dma.py`` runs it) and through
``harp_tpu_torch`` on a stacked CPU group, where the wrappers run their
plain versions: ``hop``/``hop_tree`` at three shifts and three dtypes,
``ring_allgather`` and the fused ``allgather``/``pull``, the fused
rotations, fused ring attention and fused SGD-MF fits, the CLI's
``--fused-dma yes`` and the state converter. The engine moves bytes, so
every fused result is bitwise the JAX one where the JAX one is exact, and
bitwise the port's unfused result; float fits keep the tolerances of
``tests/test_torch_sgd_mf.py`` (RMSE rtol 1e-5, factors 1e-4 of their
largest entry) and ``tests/test_torch_attention.py`` (1e-5).

Two tests spawn gloo gangs through the port's launcher (P=4 x 1 worker and
P=2 x 2 workers), each under its own timeout, running
``parallel/mp_smoke.py``: every collective, the ring-DMA ops, five K-means
iterations and fused SGD-MF fits, bitwise the stacked group at the same W.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harp_tpu import run as jrun
from harp_tpu.collectives import lax_ops as jlax
from harp_tpu.collectives import rotation as jrot
from harp_tpu.collectives import table_ops as jtops
from harp_tpu.combiner import SUM as JSUM
from harp_tpu.io import datagen as jdatagen
from harp_tpu.models import sgd_mf as jmf
from harp_tpu.ops import ring_dma as jdma
from harp_tpu.parallel import ring_attention as jra
from harp_tpu.partitioner import ModuloPartitioner as JModulo
from harp_tpu.session import HarpSession as JaxSession
from harp_tpu.table import Dist as JDist
from harp_tpu.table import Table as JTable
from harp_tpu_torch import convert
from harp_tpu_torch import run as trun
from harp_tpu_torch.collectives import lax_ops as tlax
from harp_tpu_torch.collectives import rotation as trot
from harp_tpu_torch.collectives import table_ops as ttops
from harp_tpu_torch.combiner import SUM as TSUM
from harp_tpu_torch.models import sgd_mf as tmf
from harp_tpu_torch.ops import ring_dma as tdma
from harp_tpu_torch.parallel import distributed, launch
from harp_tpu_torch.parallel import ring_attention as tra
from harp_tpu_torch.partitioner import ModuloPartitioner as TModulo
from harp_tpu_torch.session import HarpSession as TorchSession
from harp_tpu_torch.table import Dist as TDist
from harp_tpu_torch.table import Table as TTable

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = 8
_TS = {}


def tsess(w=W):
    if w not in _TS:
        _TS[w] = TorchSession(num_workers=w, device="cpu")
    return _TS[w]


def as_np(x):
    """A JAX or torch result as numpy (bf16 widened to float32, exactly)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = jnp.asarray(x)
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def same(a, b):
    a, b = as_np(a), as_np(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                       a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


def block(dtype, seed, shape=(W * 2, 3)):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(-1000, 1000, size=shape).astype(np.int32)
    return rng.standard_normal(shape).astype(np.float32)


def to_j(x, dtype):
    a = jnp.asarray(x)
    return a.astype(jnp.bfloat16) if dtype == "bf16" else a


def to_t(x, dtype):
    t = torch.from_numpy(x)
    return t.bfloat16() if dtype == "bf16" else t


# --------------------------------------------------------------------------- #
# Engine primitives on a stacked group
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", ["f32", "bf16", "int32"])
@pytest.mark.parametrize("shift", [1, -1, 3])
def test_hop_matches_jax(session, shift, dtype):
    x = block(dtype, seed=shift + 7)
    j = session.run(lambda a: jdma.hop(a, shift), session.scatter(to_j(x, dtype)),
                    in_specs=(session.shard(),), out_specs=session.shard())
    ts = tsess()
    t = ts.run(lambda a: tdma.hop(a, shift), to_t(x, dtype),
               in_specs=(ts.shard(),), out_specs=ts.shard())
    same(t, j)
    u = ts.run(lambda a: tlax.rotate(a, shift), to_t(x, dtype),
               in_specs=(ts.shard(),), out_specs=ts.shard())
    same(t, u)


def test_hop_tree_mixed_tree_matches_jax(session):
    f, i = block("f32", 1), block("int32", 2)

    def jfn(a, b):
        out = jdma.hop_tree({"f": (a, a.astype(jnp.bfloat16)), "i": [b]}, 3)
        return out["f"][0], out["f"][1].astype(jnp.float32), out["i"][0]

    def tfn(a, b):
        out = tdma.hop_tree({"f": (a, a.bfloat16()), "i": [b]}, 3)
        return out["f"][0], out["f"][1].float(), out["i"][0]

    j = session.spmd(jfn, in_specs=(session.shard(),) * 2,
                     out_specs=(session.shard(),) * 3)(
        session.scatter(jnp.asarray(f)), session.scatter(jnp.asarray(i)))
    ts = tsess()
    t = ts.spmd(tfn, in_specs=(ts.shard(),) * 2,
                out_specs=(ts.shard(),) * 3)(torch.from_numpy(f),
                                             torch.from_numpy(i))
    for a, b in zip(t, j):
        same(a, b)


def _gather_both(session, x, jfn, tfn):
    j = session.run(lambda a: jfn(a)[None], session.scatter(jnp.asarray(x)),
                    in_specs=(session.shard(),), out_specs=session.replicate())
    ts = tsess()
    t = ts.run(tfn, torch.from_numpy(x), in_specs=(ts.shard(),),
               out_specs=ts.replicate())
    return t, np.asarray(j)[0]


def test_ring_allgather_matches_jax(session):
    x = block("f32", 5)
    t, j = _gather_both(session, x, jdma.ring_allgather, tdma.ring_allgather)
    same(t, j)
    np.testing.assert_array_equal(t.numpy(), x)


@pytest.mark.parametrize("tiled", [True, False])
def test_lax_ops_allgather_fused_matches_jax(session, tiled):
    x = block("f32", 6)
    t, j = _gather_both(
        session, x, lambda a: jlax.allgather(a, tiled=tiled, fused=True),
        lambda a: tlax.allgather(a, tiled=tiled, fused=True))
    same(t, j)
    _, u = _gather_both(session, x,
                        lambda a: jlax.allgather(a, tiled=tiled),
                        lambda a: tlax.allgather(a, tiled=tiled))
    same(t, u)


@pytest.mark.parametrize("op", ["allgather", "pull"])
def test_table_gather_fused_with_partitioner_matches_jax(session, op):
    data = block("f32", 8, (W, 4))

    def jfn(fused):
        def f(x):
            t = JTable(x, JSUM, JDist.SHARDED, W, W, "t")
            return getattr(jtops, op)(t, JModulo(W, W), fused=fused).data
        return f

    def tfn(fused):
        def f(x):
            t = TTable.sharded(x, combiner=TSUM, num_workers=W)
            return getattr(ttops, op)(t, TModulo(W, W), fused=fused).data
        return f

    t, j = _gather_both(session, data, jfn(True), tfn(True))
    same(t, j)
    u, _ = _gather_both(session, data, jfn(False), tfn(False))
    same(t, u)


def test_ring_dma_errors():
    assert tdma.use_ring_dma("cuda") and not tdma.use_ring_dma("cpu")
    ts = tsess(4)
    with pytest.raises(ValueError, match="at least one axis"):
        ts.run(tdma.ring_allgather, torch.zeros(4),
               in_specs=(ts.replicate(),), out_specs=ts.replicate())
    with pytest.raises(ValueError, match="stacked"):
        ts.run(lambda a: tdma.hop(a[:2]), torch.zeros(8, 2),
               in_specs=(ts.shard(),), out_specs=ts.shard())
    with pytest.raises(ValueError, match="CUDA tensor"):
        ts.run(tdma.hop_cuda, torch.zeros(8, 2), in_specs=(ts.shard(),),
               out_specs=ts.shard())
    with pytest.raises(TypeError, match="hop_tree takes"):
        ts.run(lambda a: tdma.hop_tree({"a": 1}), torch.zeros(8, 2),
               in_specs=(ts.shard(),), out_specs=ts.shard())
    tdma.check_errors()            # no workspace on the CPU: nothing to read
    ids = [tdma._next_hop_id() for _ in range(241)]
    assert min(ids) >= 16 and max(ids) <= 255 and len(set(ids)) == 240
    assert tdma.COLLECTIVE_IDS == {"allgather": jdma.COLLECTIVE_IDS["allgather"]}


# --------------------------------------------------------------------------- #
# Fused rotations: bitwise the JAX fused schedule and the unfused port
# --------------------------------------------------------------------------- #

def _rotations(mod, xp, fused, kind):
    """The fused test schedules of tests/test_ring_dma.py, written once for
    both packages (``xp``: jnp or torch)."""
    zero = (lambda: jnp.zeros(())) if xp is jnp else (
        lambda: torch.zeros(W))

    def add(c, blk):
        s = (jnp.sum(blk) if xp is jnp
             else blk.flatten(1).sum(1, dtype=blk.dtype).float())
        return c + s

    if kind == "rotate_scan":
        def body(c, blk, t):
            bf, bi = blk
            return add(add(c, bf), bi), (bf * 1.001 + 0.1, bi + 1)

        def fn(bf, bi):
            c, (of, oi) = mod.rotate_scan(body, zero(), (bf, bi), W,
                                          fused_dma=fused)
            return (c[None] if xp is jnp else c[:, None]), of, oi
        return fn

    def body(c, blk, t):
        return add(c, blk), blk + 0.5

    def fn(ba, bb):
        if kind == "pipelined":
            c, sa, sb = mod.pipelined_rotation(body, zero(), ba, bb, 2 * W,
                                               fused_dma=fused)
        else:
            c, (sa, sb) = mod.Rotator(W, 2, fused_dma=fused).run(
                body, zero(), (ba, bb), epochs=2)
        return (c[None] if xp is jnp else c[:, None]), sa, sb
    return fn


@pytest.mark.parametrize("kind", ["rotate_scan", "pipelined", "rotator"])
def test_fused_rotations_match_jax(session, kind):
    a = block("f32", 11, (W, 4))
    b = (np.arange(W, dtype=np.int32).reshape(W, 1) if kind == "rotate_scan"
         else block("f32", 12, (W, 4)))
    j = session.spmd(_rotations(jrot, jnp, True, kind),
                     in_specs=(session.shard(),) * 2,
                     out_specs=(session.shard(),) * 3)(a, b)
    ts = tsess()
    outs = [ts.spmd(_rotations(trot, torch, fused, kind),
                    in_specs=(ts.shard(),) * 2,
                    out_specs=(ts.shard(),) * 3)(torch.from_numpy(a),
                                                 torch.from_numpy(b))
            for fused in (True, False)]
    for x, y in zip(*outs):
        same(x, y)
    # the bodies' float arithmetic rounds differently in the two packages
    # (XLA fuses a multiply-add, a block's sum runs in another order)
    for x, y in zip(outs[0], j):
        assert as_np(x).shape == as_np(y).shape
        np.testing.assert_allclose(as_np(x), as_np(y), rtol=1e-5)


# --------------------------------------------------------------------------- #
# Models
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_mha_fused_matches_jax(session, causal):
    rng = np.random.default_rng(21 + causal)
    q, k, v = (rng.standard_normal((4 * 8, 4, 8)).astype(np.float32)
               for _ in range(3))
    js = JaxSession(num_workers=4, devices=jax.devices()[:4])
    j = js.run(lambda a, b, c: jra.ring_attention_mha(
        a, b, c, causal, use_flash=False, fused_dma=True),
        *[js.scatter(jnp.asarray(x)) for x in (q, k, v)],
        in_specs=(js.shard(),) * 3, out_specs=js.shard())
    ts = tsess(4)
    outs = [ts.run(lambda a, b, c: tra.ring_attention_mha(
        a, b, c, causal, use_flash=False, fused_dma=fused),
        *map(torch.from_numpy, (q, k, v)), in_specs=(ts.shard(),) * 3,
        out_specs=ts.shard()) for fused in (True, False)]
    same(outs[0], outs[1])
    j = np.asarray(j)
    assert np.abs(outs[0].numpy() - j).max() <= 1e-5 * np.abs(j).max()


@pytest.fixture(scope="module")
def ratings():
    return jdatagen.sparse_ratings(256, 384, rank=8, density=0.05, seed=3)


def _mf_cfg(ns, layout, fused):
    return dict(rank=20, lam=0.01, lr=0.05, epochs=3, num_slices=ns,
                layout=layout, minibatches_per_hop=4, fused_dma=fused)


def _max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("layout", ["dense", "sparse"])
@pytest.mark.parametrize("ns", [1, 2])
def test_sgd_mf_fused_matches_jax(ratings, ns, layout):
    rows, cols, vals = ratings
    jw, jh, jr = jmf.SGDMF(JaxSession(num_workers=4),
                           jmf.SGDMFConfig(**_mf_cfg(ns, layout, True))).fit(
        rows, cols, vals, 256, 384, seed=1)
    fits = [tmf.SGDMF(tsess(4), tmf.SGDMFConfig(**_mf_cfg(ns, layout, f))
                      ).fit(rows, cols, vals, 256, 384, seed=1)
            for f in (True, False)]
    for a, b in zip(*fits):
        np.testing.assert_array_equal(a, b)
    tw, th, tr = fits[0]
    np.testing.assert_allclose(tr, np.asarray(jr), rtol=1e-5)
    assert _max_rel(tw, jw) <= 1e-4 and _max_rel(th, jh) <= 1e-4


def test_run_sgd_mf_fused_dma_matches_jax(capsys):
    argv = ["sgd_mf", "--num-users", "256", "--num-items", "256",
            "--density", "0.05", "--rank", "8", "--epochs", "3",
            "--num-workers", "4", "--fused-dma", "yes"]
    assert jrun.main(argv) == 0
    jout = capsys.readouterr().out
    assert trun.main(argv + ["--device", "cpu"]) == 0
    tout = capsys.readouterr().out
    jline = next(ln for ln in jout.splitlines() if ln.startswith("sgd_mf["))
    tline = next(ln for ln in tout.splitlines() if ln.startswith("sgd_mf["))
    assert tline.split(":")[0] == jline.split(":")[0]   # layout, W, nnz, rank
    jr = [float(s) for s in jline.split("rmse ")[1].split(" -> ")]
    tr = [float(s) for s in tline.split("rmse ")[1].split(" -> ")]
    np.testing.assert_allclose(tr, jr, atol=1e-4)


@pytest.mark.parametrize("ns", [1, 2])
def test_convert_takes_fused_dma(ratings, ns):
    """A fused JAX model's factors carried over: the port's fused fit from
    them matches the JAX fused fit from the same start."""
    rows, cols, vals = ratings
    kw = _mf_cfg(ns, "dense", True)
    jm = jmf.SGDMF(JaxSession(num_workers=4), jmf.SGDMFConfig(**kw))
    jstate = jm.prepare(rows, cols, vals, 256, 384, seed=6)
    w_np, h_np = jm._finalize(jstate[2], jstate[3], jstate[4])
    jw, jh, jr = jm.fit_prepared(jstate)
    model = tmf.SGDMF(tsess(4), tmf.SGDMFConfig(**kw))
    state = model.prepare(rows, cols, vals, 256, 384, seed=0)
    cfg, conv = convert.sgd_mf_state_from_jax(
        model, state, w_np, h_np, dataclasses.asdict(jm.config))
    assert cfg.fused_dma and cfg == model.config
    tw, th, tr = model.fit_prepared(conv)
    np.testing.assert_allclose(tr, np.asarray(jr), rtol=1e-5)
    assert _max_rel(tw, jw) <= 1e-4 and _max_rel(th, jh) <= 1e-4


# --------------------------------------------------------------------------- #
# The process group: gloo gangs through the launcher
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("nproc,per", [(4, 1), (2, 2)])
def test_process_group_is_bitwise_the_stacked_group(nproc, per):
    result = launch.launch(
        nproc, [sys.executable, "-m", "harp_tpu_torch.parallel.mp_smoke",
                "--device", "cpu"], per, timeout=150, cwd=REPO,
        extra_env={"PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"})
    for i, (rc, out) in enumerate(result):
        assert rc == 0 and f"MP_SMOKE OK p{i}/{nproc}" in out, out[-4000:]


def test_launcher_is_fail_stop():
    code = ("import os, sys, time; r = int(os.environ['HARP_PROCESS_ID']); "
            "print('member', r, os.environ['HARP_NUM_PROCESSES'], "
            "os.environ['HARP_WORKERS_PER_PROCESS'], flush=True); "
            "time.sleep(1); sys.exit(3) if r == 1 else time.sleep(60)")
    result = launch.launch(3, [sys.executable, "-c", code], 2, timeout=50)
    assert result.first_failure == (1, 3) and not result.ok
    assert result[0][1].startswith("member 0 3 2")
    assert result[0][0] != 0 and result[2][0] != 0     # killed, not waited
    with pytest.raises(subprocess.TimeoutExpired):
        launch.launch(1, [sys.executable, "-c", "import time; "
                          "time.sleep(30)"], timeout=1)
    assert launch.main(["--nproc", "2", "--", sys.executable, "-c",
                        "print('hi')"]) == 0


def test_distributed_initialize_without_a_gang(monkeypatch):
    for name in ("HARP_COORDINATOR", "HARP_NUM_PROCESSES", "HARP_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    distributed.initialize()                    # single process: a no-op
    assert not distributed.is_initialized()
    assert distributed.process_count() == 1 and distributed.process_index() == 0
    with pytest.raises(RuntimeError, match="needs a process group"):
        TorchSession(num_workers=2, device="cpu", distributed=True)
    with pytest.raises(ValueError, match="coordinator"):
        distributed.initialize(num_processes=2)
