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
    # comm= is ported: a quantized wire takes the codec's path (an unknown
    # codec is refused by its CommConfig), an inactive one the float32 path
    from harp_tpu_torch.collectives import quantize as tq

    with pytest.raises(ValueError, match="quant must be one of"):
        tq.CommConfig(quant="int4")
    assert torch.equal(
        ts.run(lambda a: tlax.allreduce(a, comm=tq.CommConfig()), x,
               in_specs=(ts.shard(),), out_specs=ts.replicate()),
        ts.run(tlax.allreduce, x, in_specs=(ts.shard(),),
               out_specs=ts.replicate()))
    with pytest.raises(ValueError, match="SUM/AVG"):
        ts.run(lambda a: tlax.allreduce(a, tcb.MAX,
                                        comm=tq.CommConfig("int8")), x,
               in_specs=(ts.shard(),), out_specs=ts.replicate())
    with pytest.raises(ValueError, match="divide over"):
        ts.scatter(np.zeros((w * P + 1, F), np.float32))


# --------------------------------------------------------------------------- #
# The rest of the collectives and the key-value shuffle
# --------------------------------------------------------------------------- #

def run_both_n(w, jfn, tfn, arrays, outs):
    """``jfn``/``tfn`` of several sharded arguments; ``outs`` names each
    output "rep" or "shard". Returns (jax outputs, port outputs) as numpy."""
    js, ts = sessions(w)
    spec = {"rep": (js.replicate(), ts.replicate()),
            "shard": (js.shard(), ts.shard())}
    jout = js.run(jfn, *arrays, in_specs=(js.shard(),) * len(arrays),
                  out_specs=tuple(spec[o][0] for o in outs))
    tout = ts.run(tfn, *(torch.from_numpy(a) for a in arrays),
                  in_specs=(ts.shard(),) * len(arrays),
                  out_specs=tuple(spec[o][1] for o in outs))
    return ([np.asarray(o) for o in jout],
            [o.numpy() if isinstance(o, torch.Tensor) else np.asarray(o)
             for o in tout])


def assert_all_equal(got, want):
    for g, j in zip(got, want):
        np.testing.assert_array_equal(g, j)


@W_PARAMS
@pytest.mark.parametrize("op", OPS)
def test_psum_like(w, op):
    j, t = run_both(w, lambda x: jcb.get(op).psum_like(x, "workers"),
                    lambda x: tcb.get(op).psum_like(x), contribs(w))
    np.testing.assert_array_equal(t, j)


@W_PARAMS
@pytest.mark.parametrize("root", [0, 3])
def test_gather_and_table_gather(w, root):
    d = contribs(w)
    j, t = run_both(w, lambda x: jlax.gather(x, root),
                    lambda x: tlax.gather(x, root), d, out="shard")
    np.testing.assert_array_equal(t, j)
    j, t = run_both(w, lambda x: jlax.gather(x, root, tiled=False),
                    lambda x: tlax.gather(x, root, tiled=False), d,
                    out="shard")
    np.testing.assert_array_equal(t, j)

    def jfn(x):
        out = jtops.gather(JTable.sharded(x, num_workers=w), root)
        assert out.dist.value == "local"
        return out.data

    def tfn(x):
        out = ttops.gather(TTable.sharded(x, num_workers=w), root)
        assert out.dist is Dist.LOCAL
        return out.data

    j, t = run_both(w, jfn, tfn, d, out="shard")
    np.testing.assert_array_equal(t, j)


@W_PARAMS
def test_join_and_its_count_check(w):
    d = contribs(w)
    j, t = run_both_n(
        w, lambda s, c: (jtops.join(JTable.local(c, num_workers=w),
                                    JTable.sharded(s[: P // w],
                                                   num_workers=w)).data,),
        lambda s, c: (ttops.join(TTable.local(c, num_workers=w),
                                 TTable.sharded(s[:, : P // w],
                                                num_workers=w)).data,),
        (d, d), ("shard",))
    assert_all_equal(t, j)
    errors = []
    for fn, x, sess, table in (
            (jtops.join, d, sessions(w)[0], JTable),
            (ttops.join, torch.from_numpy(d), sessions(w)[1], TTable)):
        with pytest.raises(ValueError, match="matching partition counts") as e:
            sess.run(lambda s: fn(table.local(s, num_workers=w),
                                  table.sharded(s, num_workers=w)).data,
                     x, in_specs=(sess.shard(),), out_specs=sess.shard())
        errors.append(str(e.value))
    assert errors[0] == errors[1]


@W_PARAMS
def test_rotate_maps_send_recv_and_barrier(w):
    d = contribs(w)
    perm = np.random.default_rng(w).permutation(w)
    mapping = {i: int(perm[i]) for i in range(w)}
    j, t = run_both(
        w, lambda x: jtops.rotate_with_map(JTable.sharded(x, num_workers=w),
                                           mapping).data,
        lambda x: ttops.rotate_with_map(TTable.sharded(x, num_workers=w),
                                        mapping).data, d, out="shard")
    np.testing.assert_array_equal(t, j)
    j, t = run_both(w, lambda x: jlax.rotate_map(x, mapping),
                    lambda x: tlax.rotate_map(x, mapping), d, out="shard")
    np.testing.assert_array_equal(t, j)
    pairs = [(0, w - 1), (2, 0), (w - 1, 1)]
    j, t = run_both(w, lambda x: jlax.send_recv(x, pairs),
                    lambda x: tlax.send_recv(x, pairs), d, out="shard")
    np.testing.assert_array_equal(t, j)

    def tb(x):
        tlax.barrier()
        return x * 2

    def jb(x):
        jlax.barrier()
        return x * 2

    j, t = run_both(w, jb, tb, d, out="shard")
    np.testing.assert_array_equal(t, j)


def test_rotate_map_and_send_recv_errors():
    w = 4
    js, ts = sessions(w)
    d = contribs(w)
    for mapping in ({0: 1, 1: 0}, {0: 1, 1: 2, 2: 3, 3: 5}):
        msgs = []
        for sess, fn, x in ((js, jlax.rotate_map, d),
                            (ts, tlax.rotate_map, torch.from_numpy(d))):
            with pytest.raises(ValueError, match="bijection") as e:
                sess.run(lambda a: fn(a, mapping), x,
                         in_specs=(sess.shard(),), out_specs=sess.shard())
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    x = torch.from_numpy(d)
    for pairs in ([(0, 1), (0, 2)], [(0, 1), (2, 1)], [(0, 4)]):
        with pytest.raises(ValueError, match="send_recv"):
            ts.run(lambda a: tlax.send_recv(a, pairs), x,
                   in_specs=(ts.shard(),), out_specs=ts.shard())


def kv_records(w, n, num_keys, feat=3, seed=0, lo=0):
    """Global keys (W*n,) in [lo, num_keys) and small-integer values."""
    rng = np.random.default_rng(seed + 31 * w)
    keys = rng.integers(lo, num_keys, size=w * n).astype(np.int32)
    vals = rng.integers(-3, 4, size=(w * n, feat)).astype(np.float32)
    return keys, vals


@W_PARAMS
@pytest.mark.parametrize("op", ["sum", "avg", "max", "min"])
def test_group_by_key(w, op):
    keys, vals = kv_records(w, 6, 24)          # some keys are empty
    j, t = run_both_n(
        w, lambda k, v: (jtops.group_by_key(k, v, 24, jcb.get(op)),),
        lambda k, v: (ttops.group_by_key(k, v, 24, tcb.get(op)),),
        (keys, vals), ("rep",))
    assert_all_equal(t, j)
    empty = np.bincount(keys, minlength=24) == 0
    assert empty.any()
    if op in ("max", "min"):
        assert np.all(np.isinf(t[0][empty]))
    ref = np.zeros((24, 3))
    np.add.at(ref, keys, vals)
    if op == "sum":
        np.testing.assert_array_equal(t[0], ref)


@W_PARAMS
def test_bucket_route_and_route_back(w):
    n, cap = 10, 3
    rng = np.random.default_rng(w)
    dest = rng.integers(-2, w + 2, size=w * n).astype(np.int32)
    valid = rng.random(w * n) < 0.8
    keys, vals = kv_records(w, n, 50, seed=1)

    def jfn(d, v, k, p):
        (rk, rv), rm, ovf, routing = jtops.bucket_route(d, cap, (k, p),
                                                        valid=v)
        back, ok = jtops.route_back(rv * 2.0, routing)
        return rk, rv, rm, ovf, back, ok

    def tfn(d, v, k, p):
        (rk, rv), rm, ovf, routing = ttops.bucket_route(d, cap, (k, p),
                                                        valid=v)
        back, ok = ttops.route_back(rv * 2.0, routing)
        return rk, rv, rm, ovf, back, ok

    j, t = run_both_n(w, jfn, tfn, (dest, valid, keys, vals),
                      ("shard", "shard", "shard", "rep", "shard", "shard"))
    assert_all_equal(t, j)
    # every kept record comes back doubled in its place; the rest get zeros
    back, ok = t[4], t[5]
    np.testing.assert_array_equal(back[ok], 2 * vals[ok])
    assert ok.sum() + int(t[3]) <= (valid & (dest >= 0) & (dest < w)).sum()


@W_PARAMS
@pytest.mark.parametrize("case", ["parity", "overflow", "sharded_block",
                                  "negative_keys"])
@pytest.mark.parametrize("op", ["sum", "avg", "max", "min"])
def test_group_by_key_sharded(w, case, op):
    n, num_keys, cap, rep = 12, 16, 12, True
    keys, vals = kv_records(w, n, num_keys, seed=2)
    if case == "overflow":
        keys[:] = 0                             # one bucket overflows
        cap = 2
    elif case == "sharded_block":
        num_keys, rep = 4 * w + 3, False        # a ragged key space
        keys, vals = kv_records(w, n, num_keys, seed=3)
        cap = 2 * n // w + 4
    elif case == "negative_keys":
        keys[::3] = -np.arange(1, len(keys[::3]) + 1)
        cap = 16
    out = "rep" if rep else "shard"

    def jfn(k, v):
        o, ovf = jtops.group_by_key_sharded(k, v, num_keys, jcb.get(op), cap,
                                            replicate_result=rep)
        return (o if rep else o[None]), ovf

    def tfn(k, v):
        return ttops.group_by_key_sharded(k, v, num_keys, tcb.get(op), cap,
                                          replicate_result=rep)

    j, t = run_both_n(w, jfn, tfn, (keys, vals), (out, "rep"))
    if not rep:
        j[0] = j[0].reshape(t[0].shape)
    assert_all_equal(t, j)
    if case == "overflow":
        assert int(t[1]) == w * n - w * cap
    elif case == "negative_keys":
        assert int(t[1]) == 0
    if op == "sum" and case != "overflow":
        ref = np.zeros((t[0].reshape(-1, 3).shape[0], 3))
        good = keys >= 0
        np.add.at(ref, keys[good], vals[good])
        np.testing.assert_array_equal(t[0].reshape(-1, 3), ref)


@W_PARAMS
def test_key_value_table(w):
    from harp_tpu.table import key_value_table as jkv
    from harp_tpu_torch.table import key_value_table as tkv

    keys, vals = kv_records(w, 5, 40, seed=4)   # 5 records pad to w
    j, t = run_both_n(
        w, lambda k, v: (jkv(k, v, num_workers=w).data[None],),
        lambda k, v: (tkv(k, v, num_workers=w).data,), (keys, vals),
        ("shard",))
    np.testing.assert_array_equal(t[0], j[0].reshape(t[0].shape))
