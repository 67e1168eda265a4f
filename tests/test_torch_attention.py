"""The port's attention path against the JAX package's, on the CPU.

The same numpy q, k and v, made from a seed, go through a JAX function and
its counterpart in ``harp_tpu_torch``: the flash kernel's plain version
against ``flash_attention_pallas`` in interpret mode (bq = bk = 32), the
streamed ``blocked_attention``, the single-head and multi-head ring and
Ulysses inside a JAX ``HarpSession`` at W=8 (the ``session`` fixture) and
W=4 against a stacked torch ``HarpSession`` on the CPU, and the new
collectives (``all_to_all``, ``rotate_scan`` over a (k, v) tuple). The JAX
outputs that need interpret-mode Pallas are built once per module.

Tolerance: out, m and den within 1e-5 of the largest entry of the JAX
output (``close``). The collectives move data only and must agree bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harp_tpu.collectives import lax_ops as jlax
from harp_tpu.collectives import rotation as jrot
from harp_tpu.ops import pallas_kernels as jpk
from harp_tpu.parallel import ring_attention as jra
from harp_tpu.session import HarpSession as JaxSession
from harp_tpu_torch.collectives import lax_ops as tlax
from harp_tpu_torch.collectives import rotation as trot
from harp_tpu_torch.ops import pallas_kernels as tpk
from harp_tpu_torch.parallel import ring_attention as tra
from harp_tpu_torch.session import HarpSession as TorchSession

TOL = 1e-5
_SESSIONS = {}


def close(got, want, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, (f"max abs diff {err:.3g} > {tol:g} x "
                                f"{scale:.3g}")


def qkv(shape_qk, dv, seed, bf16=False):
    """q, k (shape_qk) and v (shape_qk[:-1] + (dv,)) float32 numpy arrays
    from a seed; with ``bf16`` every entry is a bf16 value."""
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal(s).astype(np.float32)
           for s in (shape_qk, shape_qk, shape_qk[:-1] + (dv,))]
    if bf16:
        out = [torch.from_numpy(x).bfloat16().float().numpy() for x in out]
    return out


def sessions(w, jax_session8):
    """(JAX session, torch CPU session) with w workers."""
    if w not in _SESSIONS:
        js = (jax_session8 if w == 8
              else JaxSession(num_workers=w, devices=jax.devices()[:w]))
        _SESSIONS[w] = (js, TorchSession(num_workers=w, device="cpu"))
    return _SESSIONS[w]


def run_both(w, jax_session8, jfn, tfn, arrays):
    """``jfn`` and ``tfn`` over the same sequence-sharded arrays; both
    outputs as numpy."""
    js, ts = sessions(w, jax_session8)
    n = len(arrays)
    jout = js.run(jfn, *[js.scatter(jnp.asarray(a)) for a in arrays],
                  in_specs=(js.shard(),) * n, out_specs=js.shard())
    tout = ts.run(tfn, *[torch.from_numpy(a) for a in arrays],
                  in_specs=(ts.shard(),) * n, out_specs=ts.shard())
    return np.asarray(jout), tout.numpy()


# --------------------------------------------------------------------------- #
# flash_attention: the plain version against the Pallas kernel (interpret)
# --------------------------------------------------------------------------- #

# (L, H, Dh, Dv, causal, bf16): the shapes of tests/test_aux_sp.py's flash
# tests — aligned and prime L, causal and not, Dv != Dh, one bf16 case
FLASH_CASES = {
    "l64": (64, 2, 16, 16, False, False),
    "l64-causal": (64, 2, 16, 16, True, False),
    "l61": (61, 2, 16, 16, False, False),
    "l61-causal": (61, 2, 16, 16, True, False),
    "l97": (97, 1, 8, 8, False, False),
    "l97-causal": (97, 1, 8, 8, True, False),
    "dv24-causal": (64, 2, 16, 24, True, False),
    "bf16-causal": (64, 2, 32, 32, True, True),
    # heads past the kernel's 128 (its wide variant on the card): Gemma's
    # 256, and DeepSeek-V2/V3's query/key 192 with value 128, at a prime L
    "dh256-causal": (61, 2, 256, 256, True, False),
    "dh192-dv128-causal": (61, 2, 192, 128, True, False),
}
# cases also run through the Pallas kernel without return_stats
NO_STATS = ("l61", "l97-causal")


@pytest.fixture(scope="module")
def jax_flash():
    out = {}
    for i, (name, (l, h, dh, dv, causal, bf16)) in enumerate(
            FLASH_CASES.items()):
        q, k, v = qkv((l, h, dh), dv, seed=100 + i, bf16=bf16)
        dt = jnp.bfloat16 if bf16 else jnp.float32
        jq, jk, jv = (jnp.asarray(x, dt) for x in (q, k, v))
        stats = jpk.flash_attention_pallas(jq, jk, jv, causal, bq=32, bk=32,
                                           interpret=True, return_stats=True)
        plain = (jpk.flash_attention_pallas(jq, jk, jv, causal, bq=32, bk=32,
                                            interpret=True)
                 if name in NO_STATS else None)
        out[name] = ((q, k, v), [np.asarray(x) for x in stats],
                     None if plain is None else np.asarray(plain))
    return out


def _torch_inputs(arrays, bf16):
    t = [torch.from_numpy(x) for x in arrays]
    return [x.bfloat16() for x in t] if bf16 else t


@pytest.mark.parametrize("name", list(FLASH_CASES))
def test_flash_attention_plain_matches_pallas(jax_flash, name):
    _, h, dh, dv, causal, bf16 = FLASH_CASES[name]
    arrays, (jo, jm, jd), jplain = jax_flash[name]
    q, k, v = _torch_inputs(arrays, bf16)
    out, m, den = tpk.flash_attention(q, k, v, causal, return_stats=True)
    assert out.dtype == m.dtype == den.dtype == torch.float32
    close(out, jo)
    close(m, jm)
    close(den, jd)
    alone = tpk.flash_attention(q, k, v, causal)
    assert torch.equal(alone, out)
    if jplain is not None:
        close(alone, jplain)
    if h % 2 == 0 and dh <= 64 and dv <= 64:
        assert torch.equal(tpk.flash_attention(q, k, v, causal,
                                               head_pack=True), out)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_stacked_equals_separate_calls(causal):
    q, k, v = (torch.from_numpy(x) for x in qkv((3, 61, 2, 16), 24, seed=7))
    out, m, den = tpk.flash_attention(q, k, v, causal, return_stats=True)
    assert out.shape == (3, 61, 2, 24) and m.shape == den.shape == (3, 61, 2)
    for w in range(3):
        o1, m1, d1 = tpk.flash_attention(q[w], k[w], v[w], causal,
                                         return_stats=True)
        assert torch.equal(out[w], o1) and torch.equal(m[w], m1)
        assert torch.equal(den[w], d1)


def test_flash_attention_plain_matches_blocked_reference():
    """Full-row softmax and the streamed merge are one function: the plain
    version against the port's own streamed loop, at a length that takes
    several score chunks."""
    q, k, v = (torch.from_numpy(x) for x in qkv((97, 3, 8), 8, seed=3))
    for causal in (False, True):
        close(tpk.flash_attention(q, k, v, causal),
              tra._streamed_attention(q, k, v, causal, kv_block=16))


@pytest.mark.parametrize("l", [1, 63, 64, 65, 200, 16384])
@pytest.mark.parametrize("tiles", [tpk.FLASH_TILES, tpk.FLASH_WIDE_TILES,
                                   (64, 128)])
def test_flash_tiles_visited_is_the_tpu_trapezoid(l, tiles):
    """The KV-tile count that the card tests and ``chip_smoke.py`` demand of
    the kernel (``trapezoid_tiles``) is the length of the JAX package's
    trapezoid grid at the kernel's tiles (128 query rows by 64 keys; the
    wide variant's 64 x 64), and at a tile with more keys than rows."""
    bq, bk = tiles
    for causal in (False, True):
        iq_of, _ = jpk._flash_grid_layout(-(-l // bq), -(-l // bk), bq, bk,
                                          causal)
        assert tpk.trapezoid_tiles(l, causal, tiles) == len(iq_of)


@pytest.mark.parametrize("causal", [False, True])
def test_count_flash_tiles_counts_no_plain_tiles(causal):
    """The tile count is the kernel's own: the plain version on the CPU
    loads no tiles, and the count is off outside the block."""
    q, k, v = (torch.from_numpy(x) for x in qkv((2, 97, 2, 8), 8, seed=5))
    with tpk.count_flash_tiles() as tiles:
        tpk.flash_attention(q, k, v, causal)
        assert tiles() == 0
    assert tpk._flash_tile_counters is None


def test_flash_attention_errors():
    q = torch.zeros(8, 3, 16)
    with pytest.raises(ValueError, match="requires return_stats"):
        tpk.flash_attention(q, q, q, ring_hop=True)
    with pytest.raises(ValueError, match="stacked"):     # no worker axis
        tpk.flash_attention(q, q, q, return_stats=True, ring_hop=True)
    ts = TorchSession(num_workers=2, device="cpu")       # ported: it works
    x = torch.arange(2 * 8 * 3 * 16, dtype=torch.float32).reshape(16, 3, 16)
    out = ts.run(lambda a: tpk.flash_attention(a, a, a, return_stats=True,
                                               ring_hop=True), x,
                 in_specs=(ts.shard(),), out_specs=(ts.shard(),) * 5)
    assert len(out) == 5 and torch.equal(out[3], torch.roll(x, 8, 0))
    with pytest.raises(ValueError, match="head_pack=True needs even H"):
        tpk.flash_attention(q, q, q, head_pack=True)       # H = 3
    with pytest.raises(ValueError, match="head_pack=True needs even H"):
        wide = torch.zeros(8, 2, 96)
        tpk.flash_attention(wide, wide, wide, head_pack=True)
    meta = torch.zeros(8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        tpk.flash_attention(meta, meta, meta)
    with pytest.raises(ValueError, match="CUDA device"):
        tpk.flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="k must be"):
        tpk.flash_attention(q, torch.zeros(9, 3, 16), q)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_ring_hop_matches_pallas_and_rotate(session, causal):
    """flash_attention(return_stats=True, ring_hop=True) on a stacked CPU
    group of 4 workers against the TPU kernel in interpret mode with
    return_stats on every worker's block and ``lax_ops.rotate`` of k and v
    in a JAX session (the kernel's own ``ring_hop`` has no interpret
    lowering): out, m, den within 1e-5, k_next and v_next bitwise."""
    w = 4
    q, k, v = qkv((w * 16, 2, 8), 12, seed=41 + causal)

    def jfn(a, b, c):
        o, m, d = jpk.flash_attention_pallas(a, b, c, causal, bq=32, bk=32,
                                             interpret=True,
                                             return_stats=True)
        return o, m, d, jlax.rotate(b, 1), jlax.rotate(c, 1)

    js, ts = sessions(w, session)
    jout = js.run(jfn, *[js.scatter(jnp.asarray(x)) for x in (q, k, v)],
                  in_specs=(js.shard(),) * 3, out_specs=(js.shard(),) * 5)
    tout = ts.run(lambda a, b, c: tpk.flash_attention(
        a, b, c, causal, return_stats=True, ring_hop=True),
        *map(torch.from_numpy, (q, k, v)), in_specs=(ts.shard(),) * 3,
        out_specs=(ts.shard(),) * 5)
    for got, want in zip(tout[:3], jout[:3]):
        close(got, want)
    for got, want, x in zip(tout[3:], jout[3:], (k, v)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(),
                                      np.roll(x, x.shape[0] // w, axis=0))


def test_use_flash_pallas_rule():
    for dev in ("cuda", torch.device("cuda"), torch.device("cuda", 0)):
        assert tpk.use_flash_pallas(8192, dev)
        assert tpk.use_flash_pallas(16384, dev)
        assert not tpk.use_flash_pallas(8191, dev)
    for dev in ("cpu", torch.device("cpu"), torch.device("meta")):
        assert not tpk.use_flash_pallas(8192, dev)
        assert not tpk.use_flash_pallas(1 << 20, dev)


# --------------------------------------------------------------------------- #
# blocked_attention
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("l", [47, 48])
@pytest.mark.parametrize("causal", [False, True])
def test_blocked_attention_matches_jax(l, causal):
    q, k, v = qkv((l, 2, 8), 8, seed=l + causal)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    for blk in (5, 16, 48, 512):
        want = jra.blocked_attention(jq, jk, jv, causal, kv_block=blk)
        got = tra.blocked_attention(tq, tk, tv, causal, kv_block=blk)
        close(got, want)
    stacked = tra.blocked_attention(tq[None].expand(2, -1, -1, -1),
                                    tk[None].expand(2, -1, -1, -1),
                                    tv[None].expand(2, -1, -1, -1), causal,
                                    kv_block=16)
    assert torch.equal(stacked[1], tra.blocked_attention(tq, tk, tv, causal,
                                                         kv_block=16))


@pytest.mark.parametrize("dh,dv", [(256, 256), (192, 128)])
def test_blocked_attention_wide_head_matches_jax(dh, dv):
    """Heads past 128 (the flash kernel's wide variant on the card): the
    streamed loop at a prime L, causal, against the JAX package's."""
    q, k, v = qkv((47, 2, dh), dv, seed=dh + dv)
    want = jra.blocked_attention(*map(jnp.asarray, (q, k, v)), True,
                                 kv_block=16)
    got = tra.blocked_attention(*map(torch.from_numpy, (q, k, v)), True,
                                kv_block=16)
    close(got, want)


def test_reference_attention_matches_jax():
    q, k, v = qkv((40, 8), 12, seed=4)
    for causal in (False, True):
        close(tra.reference_attention(*map(torch.from_numpy, (q, k, v)),
                                      causal),
              jra.reference_attention(*map(jnp.asarray, (q, k, v)), causal))


# --------------------------------------------------------------------------- #
# ring attention, single head and multi-head
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("w,causal", [(8, False), (8, True), (4, False),
                                      (4, True)])
def test_ring_attention_single_head_matches_jax(session, w, causal):
    q, k, v = qkv((64, 16), 16, seed=5 + w)
    j, t = run_both(w, session,
                    lambda a, b, c: jra.ring_attention(a, b, c, causal),
                    lambda a, b, c: tra.ring_attention(a, b, c, causal),
                    (q, k, v))
    close(t, j)


# (W, local length, causal, use_flash): aligned and prime (7) local blocks,
# the einsum hop and the flash hop (interpret-mode Pallas on the JAX side)
MHA_CASES = [(8, 7, True, False), (8, 8, False, False), (4, 7, False, False),
             (4, 8, True, False), (8, 7, True, True), (4, 16, False, True)]


@pytest.mark.parametrize("w,l_local,causal,use_flash", MHA_CASES)
def test_ring_attention_mha_matches_jax(session, w, l_local, causal,
                                        use_flash):
    q, k, v = qkv((w * l_local, 4, 8), 12, seed=l_local + 3 * w)
    j, t = run_both(
        w, session,
        lambda a, b, c: jra.ring_attention_mha(
            a, b, c, causal, use_flash=use_flash, interpret=use_flash,
            fused_dma=False),
        lambda a, b, c: tra.ring_attention_mha(a, b, c, causal,
                                               use_flash=use_flash),
        (q, k, v))
    close(t, j)
    # the other hop route gives the same attention
    _, ts = sessions(w, session)
    other = ts.run(
        lambda a, b, c: tra.ring_attention_mha(a, b, c, causal,
                                               use_flash=not use_flash),
        *map(torch.from_numpy, (q, k, v)), in_specs=(ts.shard(),) * 3,
        out_specs=ts.shard())
    close(other, j)


@pytest.mark.parametrize("use_flash", [False, True])
def test_ring_attention_mha_wide_head_matches_jax(session, use_flash):
    """The causal multi-head ring at Dh = Dv = 256 on 4 workers, einsum and
    flash hops (interpret-mode Pallas on the JAX side)."""
    q, k, v = qkv((4 * 8, 2, 256), 256, seed=256 + use_flash)
    j, t = run_both(
        4, session,
        lambda a, b, c: jra.ring_attention_mha(
            a, b, c, True, use_flash=use_flash, interpret=use_flash,
            fused_dma=False),
        lambda a, b, c: tra.ring_attention_mha(a, b, c, True,
                                               use_flash=use_flash),
        (q, k, v))
    close(t, j)


def test_ring_attention_mha_ablation_matches_jax(session):
    q, k, v = qkv((32, 4, 8), 8, seed=11)
    j, t = run_both(
        4, session,
        lambda a, b, c: jra.ring_attention_mha(a, b, c, True, use_flash=False,
                                               fused_dma=False,
                                               ablate_rotation=True),
        lambda a, b, c: tra.ring_attention_mha(a, b, c, True,
                                               ablate_rotation=True),
        (q, k, v))
    close(t, j)


def test_ring_attention_mha_refuses_fused_dma():
    """fused_dma=True is ported (it refused before): the ring-DMA hops give
    the unfused ring's attention bitwise, and fused_dma=None, which is
    ``ring_dma.use_ring_dma`` of the device, is the unfused ring on the CPU
    (tests/test_torch_ring_dma.py holds fused_dma=True to the JAX
    package)."""
    ts = TorchSession(num_workers=2, device="cpu")
    q, k, v = map(torch.from_numpy, qkv((8, 2, 4), 4, seed=5))
    outs = [ts.run(lambda a, b, c: tra.ring_attention_mha(
        a, b, c, True, fused_dma=fused), q, k, v,
        in_specs=(ts.shard(),) * 3, out_specs=ts.shard())
        for fused in (True, False, None)]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[1], outs[2])


# --------------------------------------------------------------------------- #
# Ulysses and the collectives under it
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("w", [8, 4])
def test_ulysses_attention_matches_jax(session, w):
    q, k, v = qkv((64, 8, 8), 8, seed=9 + w)
    j, t = run_both(w, session,
                    lambda a, b, c: jra.ulysses_attention(a, b, c, 8, True),
                    lambda a, b, c: tra.ulysses_attention(a, b, c, 8, True),
                    (q, k, v))
    close(t, j)


def test_ulysses_attention_errors():
    ts = TorchSession(num_workers=4, device="cpu")
    x = torch.zeros(16, 6, 4)
    with pytest.raises(ValueError, match="divisible by 4 workers"):
        ts.run(lambda a, b, c: tra.ulysses_attention(a, b, c, 6),
               x, x, x, in_specs=(ts.shard(),) * 3, out_specs=ts.shard())
    with pytest.raises(ValueError, match="num_heads=4"):
        ts.run(lambda a, b, c: tra.ulysses_attention(a, b, c, 4),
               x, x, x, in_specs=(ts.shard(),) * 3, out_specs=ts.shard())


@pytest.mark.parametrize("w", [4, 8])
def test_all_to_all_matches_jax(session, w):
    x = np.arange(w * w * 3 * 2, dtype=np.float32).reshape(w * w * 3, 2)
    j, t = run_both(w, session, lambda a: jlax.all_to_all(a),
                    lambda a: tlax.all_to_all(a), (x,))
    np.testing.assert_array_equal(t, j)


def test_rotate_scan_rotates_a_tuple_like_jax(session):
    """K and V of different widths rotate together; the body sees the
    block each worker holds at each step, as in the JAX scan."""
    w = 4
    k = np.arange(w * 2 * 3, dtype=np.float32).reshape(w * 2, 3)
    v = -np.arange(w * 2 * 5, dtype=np.float32).reshape(w * 2, 5)

    def jbody(c, blk, t):
        kb, vb = blk
        return c + kb.sum() * (t + 1) + vb[:, 0].sum(), (kb + 1.0, vb)

    def tbody(c, blk, t):
        kb, vb = blk
        return c + kb.sum(dim=(1, 2)) * (t + 1) + vb[:, :, 0].sum(1), (
            kb + 1.0, vb)

    def jfn(a, b):
        c, (kb, vb) = jrot.rotate_scan(jbody, jnp.zeros(()), (a, b), w)
        return c[None], kb, vb

    def tfn(a, b):
        c, (kb, vb) = trot.rotate_scan(tbody, torch.zeros(w), (a, b), w)
        return c[:, None], kb, vb

    js, ts = sessions(w, session)
    jc, jk, jv = js.run(jfn, js.scatter(jnp.asarray(k)),
                        js.scatter(jnp.asarray(v)), in_specs=(js.shard(),) * 2,
                        out_specs=(js.shard(),) * 3)
    tc, tk, tv = ts.run(tfn, torch.from_numpy(k), torch.from_numpy(v),
                        in_specs=(ts.shard(),) * 2,
                        out_specs=(ts.shard(),) * 3)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # a single tensor still rotates as before
    single = ts.run(lambda a: trot.rotate_scan(
        lambda c, b, t: (c, b), None, a, 1)[1], torch.from_numpy(k),
        in_specs=(ts.shard(),), out_specs=ts.shard())
    np.testing.assert_array_equal(single.numpy(), np.roll(k, 2, axis=0))
