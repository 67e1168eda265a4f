"""The port's stacked collectives against the JAX package's, on the CPU.

Each ``harp_tpu_torch.collectives`` op runs on the same numpy inputs as its
``harp_tpu`` counterpart on the 8-device virtual mesh (W=4 and W=8). The
inputs are small integers stored as float32, so every sum, product and
average over workers is exact in any order and the results must agree
bitwise.
"""

import numpy as np
import pytest
import torch

from harp_tpu import combiner as jcb
from harp_tpu import partitioner as jpart
from harp_tpu.collectives import lax_ops as jlax
from harp_tpu.collectives import table_ops as jtops
from harp_tpu.session import HarpSession as JaxSession
from harp_tpu.table import Table as JTable
from harp_tpu_torch import combiner as tcb
from harp_tpu_torch import partitioner as tpart
from harp_tpu_torch.collectives import lax_ops as tlax
from harp_tpu_torch.collectives import rotation as trot
from harp_tpu_torch.collectives import table_ops as ttops
from harp_tpu_torch.session import HarpSession as TorchSession
from harp_tpu_torch.table import Dist, Table as TTable

P, F = 8, 3          # partitions per worker contribution, features
_SESSIONS = {}


def sessions(w):
    if w not in _SESSIONS:
        _SESSIONS[w] = (JaxSession(num_workers=w),
                        TorchSession(num_workers=w, device="cpu"))
    return _SESSIONS[w]


def contribs(w, rows=P, seed=0):
    """Global (W*rows, F) array: worker i's contribution is rows [i*rows, ...)."""
    rng = np.random.default_rng(seed + w)
    return rng.integers(-3, 4, size=(w * rows, F)).astype(np.float32)


def run_both(w, jfn, tfn, data, out="rep"):
    js, ts = sessions(w)
    jout = js.run(jfn, data, in_specs=(js.shard(),),
                  out_specs=js.shard() if out == "shard" else js.replicate())
    tout = ts.run(tfn, torch.from_numpy(data), in_specs=(ts.shard(),),
                  out_specs=ts.shard() if out == "shard" else ts.replicate())
    return np.asarray(jout), tout.numpy()


W_PARAMS = pytest.mark.parametrize("w", [4, 8])
OPS = ["sum", "max", "min", "avg", "multiply", "minus"]


@W_PARAMS
@pytest.mark.parametrize("op", OPS)
def test_allreduce(w, op):
    j, t = run_both(w, lambda x: jlax.allreduce(x, jcb.get(op)),
                    lambda x: tlax.allreduce(x, tcb.get(op)), contribs(w))
    np.testing.assert_array_equal(t, j)


@W_PARAMS
@pytest.mark.parametrize("root", [0, 3])
def test_reduce_and_broadcast(w, root):
    d = contribs(w)
    j, t = run_both(w, lambda x: jlax.reduce(x, root),
                    lambda x: tlax.reduce(x, root), d, out="shard")
    np.testing.assert_array_equal(t, j)
    j, t = run_both(w, lambda x: jlax.broadcast(x, root),
                    lambda x: tlax.broadcast(x, root), d)
    np.testing.assert_array_equal(t, j)


@W_PARAMS
@pytest.mark.parametrize("op", ["sum", "avg", "max"])
def test_reduce_scatter_and_allgather(w, op):
    d = contribs(w)
    j, t = run_both(w, lambda x: jlax.reduce_scatter(x, jcb.get(op)),
                    lambda x: tlax.reduce_scatter(x, tcb.get(op)), d,
                    out="shard")
    np.testing.assert_array_equal(t, j)
    j, t = run_both(w, jlax.allgather, tlax.allgather, contribs(w, rows=2))
    np.testing.assert_array_equal(t, j)


@W_PARAMS
@pytest.mark.parametrize("steps", [1, 3])
def test_rotate_and_worker_id(w, steps):
    j, t = run_both(w, lambda x: jlax.rotate(x, steps),
                    lambda x: tlax.rotate(x, steps), contribs(w), out="shard")
    np.testing.assert_array_equal(t, j)
    j, t = run_both(
        w, lambda x: (jlax.worker_id() * 10 + jlax.num_workers()
                      ).astype(np.float32).reshape(1, 1) + 0 * x[:1, :1],
        lambda x: (tlax.worker_id() * 10 + tlax.num_workers()
                   ).float().reshape(-1, 1, 1) + 0 * x[:, :1, :1],
        contribs(w), out="shard")
    np.testing.assert_array_equal(t, j)


def _partitioners(kind, p, w):
    if kind == "block":
        return None, None
    if kind == "modulo":
        return jpart.ModuloPartitioner(p, w), tpart.ModuloPartitioner(p, w)
    owners = tuple(int(o) for o in np.random.default_rng(5).permutation(
        np.repeat(np.arange(w), p // w)))
    return (jpart.CustomPartitioner(p, w, owners),
            tpart.CustomPartitioner(p, w, owners))


@W_PARAMS
@pytest.mark.parametrize("kind", ["block", "modulo", "custom"])
def test_regroup_allgather_aggregate(w, kind):
    d = contribs(w)
    jp, tp = _partitioners(kind, P, w)

    def jfn(x):
        t = JTable.local(x, num_workers=w)
        g = jtops.regroup(t, jp)
        return jtops.allgather(g, jp).data, g.data

    def tfn(x):
        t = TTable.local(x, num_workers=w)
        g = ttops.regroup(t, tp)
        assert g.dist is Dist.SHARDED
        return ttops.allgather(g, tp).data, g.data

    js, ts = sessions(w)
    jfull, jsh = js.run(jfn, d, in_specs=(js.shard(),),
                        out_specs=(js.replicate(), js.shard()))
    tfull, tsh = ts.run(tfn, torch.from_numpy(d), in_specs=(ts.shard(),),
                        out_specs=(ts.replicate(), ts.shard()))
    np.testing.assert_array_equal(tsh.numpy(), np.asarray(jsh))
    np.testing.assert_array_equal(tfull.numpy(), np.asarray(jfull))
    # aggregate == regroup + allgather == allreduce, partition by partition
    j, t = run_both(
        w, lambda x: jtops.aggregate(JTable.local(x, num_workers=w), jp).data,
        lambda x: ttops.aggregate(TTable.local(x, num_workers=w), tp).data, d)
    np.testing.assert_array_equal(t, j)
    j, t = run_both(
        w, lambda x: jtops.allreduce(JTable.local(x, num_workers=w)).data,
        lambda x: ttops.allreduce(TTable.local(x, num_workers=w)).data, d)
    np.testing.assert_array_equal(t, j)


@W_PARAMS
def test_table_reduce_broadcast_rotate_push_pull(w):
    d = contribs(w)
    j, t = run_both(
        w, lambda x: jtops.reduce(JTable.local(x, num_workers=w), 1).data,
        lambda x: ttops.reduce(TTable.local(x, num_workers=w), 1).data, d,
        out="shard")
    np.testing.assert_array_equal(t, j)
    j, t = run_both(
        w, lambda x: jtops.broadcast(JTable.local(x, num_workers=w), 2).data,
        lambda x: ttops.broadcast(TTable.local(x, num_workers=w), 2).data, d)
    np.testing.assert_array_equal(t, j)
    j, t = run_both(
        w, lambda x: jtops.rotate(JTable.sharded(x, num_workers=w), 2).data,
        lambda x: ttops.rotate(TTable.sharded(x, num_workers=w), 2).data, d,
        out="shard")
    np.testing.assert_array_equal(t, j)

    def jpp(x):
        glob = JTable.sharded(x[: P // w] * 0 + 1, num_workers=w)
        return jtops.pull(jtops.push(JTable.local(x, num_workers=w), glob)).data

    def tpp(x):
        glob = TTable.sharded(x[:, : P // w] * 0 + 1, num_workers=w)
        return ttops.pull(ttops.push(TTable.local(x, num_workers=w), glob)).data

    j, t = run_both(w, jpp, tpp, d)
    np.testing.assert_array_equal(t, j)


def test_ragged_table_pads_with_identity():
    """Table.local pads the partition axis with the combiner identity, as
    JAX does: a MAX table pads with -inf and stays exact."""
    w = 4
    d = contribs(w, rows=6)
    j, t = run_both(
        w, lambda x: jtops.allreduce(JTable.local(
            x, combiner=jcb.MAX, num_workers=w)).data,
        lambda x: ttops.allreduce(TTable.local(
            x, combiner=tcb.MAX, num_workers=w)).data, d)
    np.testing.assert_array_equal(t, j)
    ts = sessions(w)[1]
    tab = ts.run(lambda x: TTable.local(x, combiner=tcb.MAX, num_workers=w)
                 .data, torch.from_numpy(d), in_specs=(ts.shard(),),
                 out_specs=ts.shard())
    assert tab.shape == (w * 8, F)


def test_rotate_scan_visits_every_block():
    """After W hops each worker has seen every block once, in ring order,
    and every block is home again (rotation.rotate_scan)."""
    w = 4
    ts = sessions(w)[1]

    def fn(blocks):
        def body(seen, blk, t):
            return seen + [blk[:, 0, 0].clone()], blk
        seen, home = trot.rotate_scan(body, [], blocks, w)
        return torch.stack(seen, dim=1), home

    blocks = torch.arange(w, dtype=torch.float32).repeat_interleave(2)[:, None]
    seen, home = ts.run(fn, blocks, in_specs=(ts.shard(),),
                        out_specs=(ts.replicate(), ts.shard()))
    expect = (np.arange(w)[:, None] - np.arange(w)[None, :]) % w
    np.testing.assert_array_equal(seen.numpy(), expect)
    np.testing.assert_array_equal(home.numpy(), blocks.numpy())


def test_misuse_is_loud():
    w = 4
    ts = sessions(w)[1]
    x = torch.from_numpy(contribs(w))
    with pytest.raises(RuntimeError, match="no worker group is bound"):
        tlax.allreduce(x.reshape(w, P, F))
    with pytest.raises(ValueError, match="expects a sharded table"):
        ts.run(lambda a: ttops.allgather(TTable.local(a, num_workers=w)), x,
               in_specs=(ts.shard(),), out_specs=ts.replicate())
    # fused=True is ported: the ring relay gives the plain gather, bitwise
    fused = ts.run(lambda a: tlax.allgather(a, fused=True), x,
                   in_specs=(ts.shard(),), out_specs=ts.replicate())
    assert torch.equal(fused, ts.run(tlax.allgather, x, in_specs=(ts.shard(),),
                                     out_specs=ts.replicate()))
    with pytest.raises(NotImplementedError, match="comm="):
        ts.run(lambda a: tlax.allreduce(a, comm="int8"), x,
               in_specs=(ts.shard(),), out_specs=ts.replicate())
    with pytest.raises(ValueError, match="divide over"):
        ts.scatter(np.zeros((w * P + 1, F), np.float32))
