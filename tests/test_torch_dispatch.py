"""The port's dispatch rules and the SPD solve past K = 64, on the CPU.

* Every dispatch predicate (``use_kmeans_pallas``, ``use_flash_pallas``,
  ``use_spd_solve_pallas``) at shapes inside and just outside its rule, on
  the device strings "cuda" and "cpu": on "cpu" every one is False, on
  "cuda" each says yes exactly inside its rule.
* ``HARP_ALS_PALLAS``, the one switch the port reads: "0" turns ALS's
  ``solver="auto"`` away from the kernel on "cuda", unset or any other value
  leaves it on, and no other predicate moves.
* ``ring_attention_mha`` with ``fused_dma=None`` follows
  ``ring_dma.use_ring_dma`` of the device; its einsum hops are counted one a
  hop actually computed, whatever ``use_flash`` was.
* The K-means shared-memory twin at known (D, K), the wide E-step's plan
  (chunk sizes, a grid that does not depend on W, workspaces), the SPD
  solve's shared-memory twin (both buffer layouts) and limit, and the
  one-warp solve's twin (lanes a system, shared memory, grid) at the edges
  of its lanes a system.
* The SPD solve's routing by K (``spd_solve_variant``: the one-warp kernel
  to K = 32, the shared-memory kernel to ``SPD_MAX_K_SMEM``, the
  global-memory kernel above), with no launch.
* ``ALS._resolve_solver`` around the two SPD limits.
* ``spd_solve_plain`` against the JAX package's ``spd_solve_pallas`` in
  interpret mode at K = 72 and 96, and against ``numpy.linalg.solve`` in
  float64 at K = 128 and 200: rtol 1e-4 relative to max |x| (the pattern of
  ``tests/test_torch_als.py``).
* A W=4 ALS fit at rank 96 with ``solver="pallas"`` (the plain solve on the
  CPU) against the JAX fit, within the tolerances of
  ``tests/test_torch_als.py`` (RMSE rtol 1e-4, factors 1e-3 of their largest
  entry). The JAX fit takes ``solver="cholesky"``: its Pallas solve in
  interpret mode spends about 25 s compiling each K = 96 half-step on the
  CPU, and the solve itself is held to that kernel by the test above.

The card's side (kernel launches, ``plain_on_card`` outside each predicate,
the loud error beyond a kernel's width, the shared-memory SPD kernel) is in
``tests/test_torch_cuda_kernels.py``.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from harp_tpu.io import datagen as jdatagen
from harp_tpu.models import als as jals
from harp_tpu.ops import pallas_kernels as jpk
from harp_tpu.session import HarpSession as JaxSession
from harp_tpu_torch.collectives import lax_ops as tlax
from harp_tpu_torch.models import als as tals
from harp_tpu_torch.ops import pallas_kernels as tpk
from harp_tpu_torch.ops import ring_dma as tdma
from harp_tpu_torch.parallel import ring_attention as tra
from harp_tpu_torch.session import HarpSession as TorchSession

F32, BF16 = torch.float32, torch.bfloat16

# (predicate, arguments inside its rule, arguments just outside)
PREDICATES = {
    # past one block's shared memory the wide variant runs, and past the
    # stated limits the kernel raises: only the point type decides
    "kmeans": (tpk.use_kmeans_pallas,
               [(1_000_000, 100, 249, F32), (1, 100, 100, BF16),
                (tpk.KMEANS_MAX_N, 8, 4, F32), (1_000_000, 100, 250, F32),
                (1000, 256, 200, F32), (tpk.KMEANS_MAX_N + 1, 8, 4, F32)],
               [(1000, 100, 100, torch.float16),
                (1000, 100, 100, torch.float64)]),
    "flash": (tpk.use_flash_pallas, [(8192,), (16384,), (1 << 20,)],
              [(8191,), (1,)]),
    "spd": (tpk.use_spd_solve_pallas, [(1,), (32,), (64,)],
            [(65,), (128,)]),
}


@pytest.fixture(autouse=True)
def als_switch_unset(monkeypatch):
    monkeypatch.delenv("HARP_ALS_PALLAS", raising=False)


@pytest.mark.parametrize("device", ["cuda", "cpu", torch.device("cuda", 0)])
@pytest.mark.parametrize("name", sorted(PREDICATES))
def test_predicate_limits(name, device):
    fn, inside, outside = PREDICATES[name]
    on_card = torch.device(device).type == "cuda"
    for args in inside:
        assert fn(*args, device) is on_card, (name, args, device)
    for args in outside:
        assert fn(*args, device) is False, (name, args, device)


@pytest.mark.parametrize("value,on", [(None, True), ("0", False), ("1", True),
                                      ("", True), ("off", True)])
def test_als_pallas_switch(monkeypatch, value, on):
    if value is not None:
        monkeypatch.setenv("HARP_ALS_PALLAS", value)
    assert tpk.use_spd_solve_pallas(64, "cuda") is on
    assert tpk.use_spd_solve_pallas(64, "cpu") is False
    # the switch turns off the SPD solve's "auto" rule and nothing else
    for name, (fn, inside, _) in PREDICATES.items():
        if name != "spd":
            assert fn(*inside[0], "cuda") is True, name


def _qkv(w=4, l_local=8, seed=4):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(
        (w * l_local, 2, 8)).astype(np.float32)) for _ in range(3))


@pytest.mark.parametrize("card", [True, False])
def test_ring_attention_fused_dma_none_follows_use_ring_dma(monkeypatch,
                                                            card):
    """fused_dma=None is ``use_ring_dma`` of the device: evaluated as on
    the card, its hops go through the ring-DMA engine (spied on, the plain
    hop standing in for the kernel); on the CPU it is the unfused ring. The
    result is bitwise the unfused ring either way."""
    real = tdma.use_ring_dma
    calls = []

    def spy_hop(x, shift=1):
        calls.append(shift)
        return tlax.rotate(x, shift)

    if card:
        monkeypatch.setattr(tdma, "use_ring_dma", lambda device: real("cuda"))
    monkeypatch.setattr(tdma, "hop", spy_hop)
    monkeypatch.setattr(tdma, "hop_tree",
                        lambda tree, shift=1: tuple(spy_hop(x, shift)
                                                    for x in tree))
    ts = TorchSession(num_workers=4, device="cpu")
    q, k, v = _qkv()

    def ring(fused_dma):
        return ts.run(lambda a, b, c: tra.ring_attention_mha(
            a, b, c, True, fused_dma=fused_dma), q, k, v,
            in_specs=(ts.shard(),) * 3, out_specs=ts.shard())

    got = ring(None)
    assert bool(calls) is card
    calls.clear()
    assert torch.equal(got, ring(False)) and not calls


@pytest.mark.parametrize("use_flash", [None, False])
def test_ring_attention_counts_each_plain_hop(monkeypatch, use_flash):
    """The ring's einsum path asks ``count_plain_on_card`` once for every
    hop it computes (W hops for W workers), whether ``use_flash`` was
    resolved to False or passed so."""
    seen = []
    monkeypatch.setattr(tpk, "count_plain_on_card",
                        lambda name, device: seen.append(
                            (name, torch.device(device).type)))
    ts = TorchSession(num_workers=4, device="cpu")
    q, k, v = _qkv()
    ts.run(lambda a, b, c: tra.ring_attention_mha(
        a, b, c, False, use_flash=use_flash, fused_dma=False), q, k, v,
        in_specs=(ts.shard(),) * 3, out_specs=ts.shard())
    assert seen == [("flash_attention", "cpu")] * 4


def test_cpu_dispatch_counts_nothing():
    """On a CPU tensor every dispatcher takes the plain version, outside a
    predicate too, and neither ``launches`` nor ``plain_on_card`` moves;
    ``count_plain_on_card`` counts CUDA devices only."""
    before = dict(tpk.launches), dict(tpk.plain_on_card)
    x, c = torch.randn(64, 256), torch.randn(250, 256)     # the wide variant's
    got = tpk.kmeans_stats(x, c, 200)
    for a, b in zip(got, tpk.kmeans_stats_plain(x, c, 200)):
        assert torch.equal(a, b)
    assert (dict(tpk.launches), dict(tpk.plain_on_card)) == before
    tpk.count_plain_on_card("flash_attention", "cpu")
    assert tpk.plain_on_card == before[1]
    tpk.count_plain_on_card("flash_attention", "cuda")
    assert (tpk.plain_on_card["flash_attention"]
            == before[1]["flash_attention"] + 1)
    tpk.plain_on_card["flash_attention"] -= 1


@pytest.mark.parametrize("d,k,want", [
    # TF32 hi and lo planes (chunk rows x D rounded up to 8), norms, the
    # partial (K x (D rounded up to 4, plus 4)), three warpgroups' tiles (64
    # rows of D_8 + 4 words) with their 64 ranks, distances, (row, point)
    # pairs and 8 part bounds
    (100, 100, 8 * 112 * 104 + 4 * 112 + 4 * 100 * 104
     + 3 * 4 * (64 * 108 + 264)),
    (16, 8, 8 * 32 * 16 + 4 * 32 + 4 * 8 * 20 + 3 * 4 * (64 * 20 + 264)),
    (64, 32, 8 * 32 * 64 + 4 * 32 + 4 * 32 * 68 + 3 * 4 * (64 * 68 + 264)),
])
def test_kmeans_smem_twin(d, k, want):
    assert tpk.kmeans_smem_bytes(d, k) == want


def test_kmeans_and_spd_shared_memory_limits():
    # D = 100: K = 112 is the last centroid count one block holds
    assert tpk.kmeans_smem_bytes(100, 112) <= tpk.MAX_SMEM_BYTES
    assert tpk.kmeans_smem_bytes(100, 113) > tpk.MAX_SMEM_BYTES
    # the shared-memory solve: its stated limit is the last K whose block
    # fits
    lim = tpk.SPD_MAX_K_SMEM
    assert tpk.spd_solve_block_smem_bytes(lim) <= tpk.MAX_SMEM_BYTES
    assert tpk.spd_solve_block_smem_bytes(lim + 1) > tpk.MAX_SMEM_BYTES
    # the geometry the wrapper picks fits at every K the kernel takes
    for k in range(tpk.SPD_MAX_K_WARP + 1, lim + 1):
        assert tpk.spd_solve_block_geometry(k) in tpk.SPD_BLOCK_SHAPES
        assert tpk.spd_solve_block_smem_bytes(k) <= tpk.MAX_SMEM_BYTES
    # the global-memory solve keeps the right-hand side (K floats, rounded
    # up to 4) and its panel's staging area (global_stage_floats in
    # csrc/spd_solve.cu, 4,416 floats) in shared memory: its stated limit fits
    top = tpk.SPD_MAX_K_GLOBAL
    assert 4 * (-(-top // 4) * 4 + 4416) <= tpk.MAX_SMEM_BYTES
    assert tpk.spd_solve_global_workspace_bytes(132, 512) == \
        4 * 132 * 131_328
    assert tpk.spd_solve_global_workspace_bytes(1, 339) == 4 * 57_630


# block_smem_floats in csrc/spd_solve.cu, written out: the packed triangle
# and b, each rounded up to 4 floats, then the staging area: the diagonal
# block's L transposed (32 x 32), the panel's L below it (32 x the K - 32
# trailing rows rounded up to 32), dinv and y (2 x 32)
@pytest.mark.parametrize("k,want", [
    (33, 4 * (564 + 36 + 1024 + 32 * 32 + 64)),
    (64, 4 * (2080 + 64 + 1024 + 32 * 32 + 64)),
    (96, 4 * (4656 + 96 + 1024 + 32 * 64 + 64)),
    (128, 4 * (8256 + 128 + 1024 + 32 * 96 + 64)),
    (307, 4 * (47_280 + 308 + 1024 + 32 * 288 + 64)),
    (338, 4 * (57_292 + 340 + 1024 + 32 * 320 + 64)),
])
def test_spd_block_smem_twin(k, want):
    assert tpk.spd_solve_block_smem_bytes(k) == want


# warp_block_floats in csrc/spd_solve.cu, written out: W warps of 32 / G
# slots, G lanes a system; a slot is K rows at a pitch of K rounded up to an
# odd number of float4s, rounded up to G floats past a multiple of 32
@pytest.mark.parametrize("k,lanes,warps,slot", [
    (1, 4, 4, 4),           # 1 x 4
    (8, 4, 4, 100),         # 8 x 12 = 96
    (9, 8, 4, 136),         # 9 x 12 = 108
    (16, 8, 4, 328),        # 16 x 20 = 320
    (17, 8, 4, 360),        # 17 x 20 = 340
    (24, 8, 4, 680),        # 24 x 28 = 672
    (25, 8, 2, 712),        # 25 x 28 = 700
    (32, 8, 2, 1160),       # 32 x 36 = 1152
])
def test_spd_warp_twin(k, lanes, warps, slot):
    """The one-warp solve's host twin: lanes a system (K / G rows a lane),
    warps a block, shared memory a block (static, so within 48 KB) and the
    grid rule: the resident blocks (8 an SM on 132 SMs), at most the blocks
    whose warps N systems fill."""
    assert tpk.spd_solve_warp_group(k) == lanes
    assert tpk.spd_solve_warp_block_warps(k) == warps
    assert slot % 32 == lanes % 32          # a warp's slots lie G banks apart
    assert tpk.spd_solve_warp_smem_bytes(k) == 4 * warps * (32 // lanes) * slot
    assert tpk.spd_solve_warp_smem_bytes(k) <= 48 * 1024
    assert tpk.spd_solve_warp_grid(8192, k, 8, 132) == min(
        8 * 132, 8192 // (32 // lanes) // warps)
    assert tpk.spd_solve_warp_grid(1, k, 8, 132) == 1
    assert tpk.spd_solve_warp_grid(8191, k, 1, 1) == 1


def test_spd_stamped_copy_finds_its_anchors():
    """``benchmark/spd_stamps.py`` stamps a copy of the K <= 32 kernel at
    fixed anchors; each must still be in the source, once: four phases, a
    stamp for the turn count, and the macros' definitions."""
    from harp_tpu_torch.benchmark import spd_stamps
    from harp_tpu_torch.ops import _cuda_build

    src = (_cuda_build.CSRC / "spd_solve.cu").read_text()
    assert not spd_stamps.is_parent_layout(src)
    stamped = spd_stamps.stamped_source(src)
    assert stamped.count("STAMP(") == len(spd_stamps.PHASES) + 1
    assert stamped.count("STAMP_TURN()") == 2


@pytest.mark.parametrize("k,variant", [
    (1, "spd_solve"), (32, "spd_solve"),
    (33, "spd_solve_block"), (64, "spd_solve_block"),
    (65, "spd_solve_block"), (307, "spd_solve_block"),
    (308, "spd_solve_global"), (338, "spd_solve_global"),
    (339, "spd_solve_global"), (29_056, "spd_solve_global"),
])
def test_spd_solve_routes_by_k(k, variant):
    """The variant ``spd_solve_cuda`` launches at rank K, by the name of
    the launch counter it adds to, with no launch: the one-warp kernel to
    K = 32, the shared-memory kernel to ``SPD_MAX_K_SMEM``, the
    global-memory kernel above. ``SPD_MAX_K`` (64) decides only
    ``solver="auto"`` (``test_resolve_solver``)."""
    assert (tpk.SPD_MAX_K_WARP, tpk.SPD_MAX_K_SMEM) == (32, 307)
    assert tpk.spd_solve_variant(k) == variant
    assert variant in tpk.launches


@pytest.mark.parametrize("k", [0, 29_057])
def test_spd_solve_routes_nothing_outside_its_limits(k):
    with pytest.raises(ValueError, match="1 <= K <= 29056"):
        tpk.spd_solve_variant(k)


@pytest.mark.parametrize("n,d,k,grid", [
    (1 << 20, 100, 400, 256),      # a 4096-point range a block
    (1 << 20, 128, 1024, 256),
    (262_144, 1024, 256, 64),
    (4097, 100, 250, 2),           # a ragged last range
    (0, 825, 1, 1),                # no points: one block
    (1 << 20, 8190, 32_768, 256),  # the widest tables: the same ranges
    (1 << 20, 4094, 2048, 256),
])
def test_kmeans_wide_plan(n, d, k, grid):
    """The wide E-step's plan: the C side's chunk sizes, the sort's ranges
    whatever W, and the workspaces' shapes and bytes (norms and planes
    padded to 128 rows and 32 features, each point's assignment and
    distance, the sort's buffers and histograms, starts, pieces and the
    rows' distances)."""
    kp = -(-k // 128) * 128
    dpw = -(-d // 32) * 32
    ranges = -(-n // 4096)
    pieces = -(-n // 256) + k
    for w in (1, 4):
        for per_worker in (False, True):
            plan = tpk.kmeans_wide_plan(n, d, k, w, per_worker)
            assert plan["grid"] == grid == max(1, ranges)
            assert (plan["point_tile"], plan["centroid_chunk"],
                    plan["depth_chunk"], plan["sort_range"],
                    plan["piece"]) == (192 if d <= 128 else 128, 128, 32,
                                       4096, 256)
            tables = w if per_worker else 1
            assert plan["shapes"] == {
                "norms": (tables, kp), "planes": (tables, 2 * kp * dpw),
                "asg": (w, n), "dist": (w, n), "sort": (4, w, n),
                "hist": (w, ranges, 256), "starts": (w, k + 1),
                "pstart": (w, k + 1), "pieces": (w, pieces, d + 1),
                "rowcost": (w, k)}
            assert plan["workspace_bytes"] == 4 * (
                tables * kp * (1 + 2 * dpw) + 6 * w * n + w * 256 * ranges
                + 2 * w * (k + 1) + w * pieces * (d + 1) + w * k)
    # the stated limit
    assert 32_768 * (8190 + 2) == tpk.KMEANS_MAX_KD


@pytest.mark.parametrize("k,kp", [(1, 16), (16, 16), (20, 32), (128, 128),
                                  (129, 256), (136, 256), (256, 256),
                                  (257, 512), (1000, 1024), (1024, 1024),
                                  (1025, 0), (0, 0)])
def test_mf_padded_rank(k, kp):
    # up to 128 the narrow kernel's ranks, past it the wide path's, 0 past
    # the stated limit MF_MAX_K
    assert tpk.mf_padded_rank(k) == kp
    assert tpk.MF_MAX_K == 1024


def test_dense_mf_wide_shapes():
    # bf16 blobs of core matrices: Wb (W, nmb, nch, C, 64 x 256), G (W,
    # nmb, nch, 2 n_ct, 64 x 32), the snapshots (W, nmb, n_ct, C, 64 x 256),
    # then the SSE partials (W, n_ct C); C = KP / 256 rank slices, nch =
    # ceil(rpw / nmb / 64), n_ct = ceil(cpb / 64)
    assert tpk.dense_mf_wide_shapes(1, 32768, 32768, 256, 8) == (
        (1, 8, 64, 1, 16384), (1, 8, 64, 1024, 2048), (1, 8, 512, 1, 16384),
        (1, 512))
    assert tpk.dense_mf_wide_shapes(2, 64, 1001, 512, 2) == (
        (2, 2, 1, 2, 16384), (2, 2, 1, 32, 2048), (2, 2, 16, 2, 16384),
        (2, 32))


@pytest.mark.parametrize("nw,rpw,cpb,kp,nmb", [
    (1, 32768, 32768, 256, 8), (1, 32768, 32768, 512, 8),
    (1, 32768, 32768, 1024, 8), (1, 520, 1001, 256, 4),
    (1, 64, 520, 256, 4), (2, 256, 520, 1024, 2), (4, 512, 512, 256, 4)])
def test_dense_mf_wide_buffers_hold_every_operand(nw, rpw, cpb, kp, nmb):
    # Wb holds every factor row of every stripe (rows padded to whole 64-row
    # chunks), the snapshots every column of every stripe's Hb (columns
    # padded to whole 64-column tiles), G one bf16 a padded (row, column)
    # slot; one SSE partial a block of the grid (n_ct tiles x C slices)
    wb, g, snap, parts = tpk.dense_mf_wide_shapes(nw, rpw, cpb, kp, nmb)
    nch = -(-(rpw // nmb) // 64)
    n_ct = -(-cpb // 64)
    assert math.prod(wb) == nw * nmb * nch * 64 * kp
    assert math.prod(g) == nw * nmb * nch * 64 * n_ct * 64
    assert math.prod(snap) == nw * nmb * n_ct * 64 * kp
    assert parts == (nw, n_ct * kp // tpk.MF_WIDE_RANKS_A_BLOCK)
    assert kp // tpk.MF_WIDE_RANKS_A_BLOCK in (1, 2, 4)
    assert tpk.MF_WIDE_COLS == 64 and tpk.MF_CHUNK_ROWS == 64


@pytest.mark.parametrize("rank,solver,device,want", [
    (64, "auto", "cuda", "pallas"),
    (65, "auto", "cuda", "cholesky"),
    (128, "auto", "cuda", "cholesky"),
    (64, "auto", "cpu", "cholesky"),
    (64, "pallas", "cuda", "pallas"),
    (65, "pallas", "cuda", "pallas"),
    (128, "pallas", "cuda", "pallas"),
    (338, "pallas", "cuda", "pallas"),
    (339, "pallas", "cpu", "pallas"),
    (339, "pallas", "cuda", "pallas"),
    (1000, "pallas", "cuda", "pallas"),
])
def test_resolve_solver(rank, solver, device, want):
    # an explicit "pallas" takes the kernel at every rank on the card (past
    # K = 338 the global-memory solve); "auto" only up to K = 64
    cfg = tals.ALSConfig(rank=rank, solver=solver)
    assert tals._resolve_solver(cfg, device) == want


def test_resolve_solver_auto_honours_the_switch(monkeypatch):
    monkeypatch.setenv("HARP_ALS_PALLAS", "0")
    assert tals._resolve_solver(tals.ALSConfig(rank=32), "cuda") == "cholesky"
    # an explicit request still takes the kernel
    assert tals._resolve_solver(tals.ALSConfig(rank=32, solver="pallas"),
                                "cuda") == "pallas"


def normal_equations(n, k, seed):
    """ALS-shaped SPD systems: V'V over 4k factor rows plus 0.1 I, with a
    right-hand side, as numpy float32."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, 4 * k, k)).astype(np.float32) / np.sqrt(k)
    a = (np.einsum("nek,nel->nkl", v, v)
         + 0.1 * np.eye(k, dtype=np.float32)).astype(np.float32)
    b = rng.standard_normal((n, k)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("k", [72, 96])
def test_spd_solve_plain_matches_pallas_interpret_past_64(k):
    n = 16
    a, b = normal_equations(n, k, seed=k)
    ref = np.asarray(jpk.spd_solve_pallas(jnp.asarray(a), jnp.asarray(b),
                                          tile_b=n, interpret=True))
    got = tpk.spd_solve_plain(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == (n, k)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got.numpy() / scale, ref / scale, rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("k", [128, 200])
def test_spd_solve_plain_matches_numpy_past_64(k):
    a, b = normal_equations(8, k, seed=k)
    exact = np.linalg.solve(a.astype(np.float64),
                            b.astype(np.float64)[..., None])[..., 0]
    got = tpk.spd_solve_plain(torch.from_numpy(a), torch.from_numpy(b))
    scale = np.abs(exact).max()
    np.testing.assert_allclose(got.numpy() / scale, exact / scale, rtol=1e-4,
                               atol=1e-4)


def test_als_fit_rank96_pallas_matches_jax():
    nu, ni = 128, 96
    rows, cols, vals = jdatagen.sparse_ratings(nu, ni, rank=4, density=0.1,
                                               seed=3)
    data = (rows, cols, np.abs(vals), nu, ni, 1)
    kw = dict(rank=96, lam=0.1, alpha=40.0, iterations=3, implicit=True,
              layout="sparse")
    ref = jals.ALS(JaxSession(num_workers=4),
                   jals.ALSConfig(**kw, solver="cholesky")).fit(*data)
    got = tals.ALS(TorchSession(num_workers=4, device="cpu"),
                   tals.ALSConfig(**kw, solver="pallas")).fit(*data)
    assert got[0].shape == (nu, 96) and got[1].shape == (ni, 96)
    assert np.all(np.diff(got[2]) < 0)
    np.testing.assert_allclose(got[2], np.asarray(ref[2]), rtol=1e-4)
    for g, r in zip(got[:2], ref[:2]):
        r = np.asarray(r, np.float64)
        assert np.abs(np.asarray(g, np.float64) - r).max() <= (
            1e-3 * np.abs(r).max())
