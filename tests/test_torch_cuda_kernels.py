"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc and skips without them. This
file imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerances: K-means f32 sums rtol 1e-4 (the kernel and the matmul sum the
cross term in different orders), counts exact except for near-tie rows, cost
rtol 1e-4; bf16 sums rtol 2e-2. Two runs of a kernel are bitwise equal.

Dense SGD-MF hop: SSE rtol 1e-5 against the plain version. W and H are
held against the plain version run in float64 (exact sums of the same bf16
products): relative to their largest entry, the kernel must be within 1e-4
or within 4x the distance of the float32 plain version from it, whichever
is larger. A last-bit difference in pred can flip the bf16 rounding of an
entry of G, and the flip moves H, so every later stripe's pred, and G's
roundings there: one hop amplifies rounding by itself, by an amount that
depends on the data, so the yardstick is measured on the same inputs.

Batched SPD solve: the kernel and the plain version sum in different orders
(the kernel's shuffles, fused multiply-adds), so both are held against a
float64 ``torch.linalg.solve`` of the same systems: the kernel within
max(1e-5, 4x the plain version's own distance from it), relative to max
|x|.

Flash attention: the kernel and the plain version (a full-row softmax) sum
in different orders, so both are held against a float64 attention of the
same inputs over sampled query rows of every head: out, m and den within
max(1e-5, 4x the plain version's own distance), relative to their largest
entry. A stacked launch is bitwise the separate ones, and two runs are
bitwise equal. The KV tiles the kernel counts as loaded are exactly the
causal trapezoid of its 64 x 64 tiles (``trapezoid_tiles``, which
tests/test_torch_attention.py holds against the JAX package's grid).

Ring DMA: the hop and the allgather are bitwise ``torch.roll`` and the
stacked copy for every dtype and for a ragged byte count, one launch a
call; ``parallel/mp_smoke.py`` as 2 processes x 2 workers on the card holds
the kernels between processes bitwise to the stacked group.
"""

import math

import numpy as np
import pytest
import torch

from harp_tpu_torch.ops import pallas_kernels as pk

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


def _near_ties(x, c, valid_k, eps=1e-4):
    """Rows whose best two scores are within eps (relative) of each other."""
    cdtype = None if x.dtype == torch.float32 else x.dtype
    from harp_tpu_torch.ops import distance

    s = distance.pairwise_scores(x, c, cdtype)[..., :valid_k]
    top2 = torch.topk(s, 2, dim=-1, largest=False).values
    scale = s.abs().amax(dim=-1)
    return int(((top2[..., 1] - top2[..., 0]) <= eps * scale).sum())


@pytest.mark.parametrize("w,n,k,d,valid_k,dtype,per_worker", [
    (1, 4099, 10, 16, 10, torch.float32, False),    # ragged N
    (1, 2048, 37, 33, 30, torch.float32, False),    # valid_k < K, odd widths
    (1, 3000, 20, 24, 20, torch.bfloat16, False),   # bf16 points
    (3, 1000, 12, 8, 11, torch.float32, True),      # stacked, per-worker c
    (1, 5000, 64, 40, 50, torch.float32, False),    # 4 centroids a thread
    (2, 2500, 112, 48, 112, torch.float32, False),  # 7 centroids a thread
    (2, 700, 130, 9, 129, torch.float32, False),    # K above one chunk
    (1, 1500, 20, 200, 20, torch.float32, False),   # D above 128 features
])
def test_kmeans_stats_kernel_matches_plain(cuda, w, n, k, d, valid_k, dtype,
                                           per_worker):
    g = torch.Generator().manual_seed(n + k)
    x = torch.randn(w, n, d, generator=g).to(cuda, dtype)
    c = torch.randn(k, d, generator=g).to(cuda)
    if per_worker:
        c = c.expand(w, -1, -1).contiguous()
    before = pk.launches["kmeans_stats"]
    sums, counts, cost = pk.kmeans_stats_cuda(x, c, valid_k)
    torch.cuda.synchronize()
    assert pk.launches["kmeans_stats"] == before + 1
    ps, pc, pq = pk.kmeans_stats_plain(x, c, valid_k)
    ties = _near_ties(x, c, valid_k)
    assert float((counts - pc).abs().sum()) <= 2 * ties
    assert float(counts[..., valid_k:].sum()) == 0.0
    assert float(counts.sum()) == w * n
    rtol = 1e-4 if dtype == torch.float32 else 2e-2
    if ties == 0:
        torch.testing.assert_close(sums, ps, rtol=rtol, atol=rtol)
    torch.testing.assert_close(cost, pq, rtol=1e-4, atol=1e-3)
    again = pk.kmeans_stats_cuda(x, c, valid_k)
    for a, b in zip((sums, counts, cost), again):
        assert torch.equal(a, b)


def test_kmeans_stats_kernel_refuses_bad_inputs(cuda):
    x = torch.zeros(64, 8, device=cuda)
    c = torch.zeros(4, 8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        pk.kmeans_stats_cuda(x.t().contiguous().t(), c)
    with pytest.raises(TypeError, match="float32"):
        pk.kmeans_stats_cuda(x.half(), c)
    with pytest.raises(ValueError, match="shared memory"):
        pk.kmeans_stats_cuda(torch.zeros(64, 256, device=cuda),
                             torch.zeros(200, 256, device=cuda))


def mf_hop_inputs(nw, n_blocks, rpw, cpb, k, nmb_fine, density=0.05,
                  seed=0):
    """A NaN-coded bf16 slab of rank-8 ratings plus noise (the shape of
    ``datagen.sparse_ratings``) with its true regularizer counts, and random
    factors, made with numpy from a seed (CPU tensors)."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((nw, n_blocks, rpw, 8)).astype(np.float32)
    m = rng.standard_normal((nw, n_blocks, 8, cpb)).astype(np.float32)
    v = (u @ m) / 8.0 + 0.01 * rng.standard_normal((nw, n_blocks, rpw, cpb))
    v[rng.random(v.shape) >= density] = np.nan
    seen = ~np.isnan(v)
    row_cnt = seen.sum(axis=3).astype(np.float32)
    col_cnt = seen.reshape(nw, n_blocks, nmb_fine, rpw // nmb_fine,
                           cpb).sum(axis=3).astype(np.float32)
    scale = 1.0 / np.sqrt(k)
    w = (scale * rng.standard_normal((nw, rpw, k))).astype(np.float32)
    h = (scale * rng.standard_normal((nw, cpb, k))).astype(np.float32)
    t = torch.from_numpy
    return (t(v.astype(np.float32)).to(torch.bfloat16), t(w), t(h),
            t(row_cnt), t(col_cnt))


def max_rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("nw,n_blocks,rpw,cpb,k,nmb,nmb_fine,buckets", [
    (1, 1, 4096, 4096, 32, 8, 8, [0]),          # the flagship cut to 4096^2
    (1, 1, 1024, 3000, 32, 4, 4, [0]),          # ragged column tile
    (1, 1, 520, 1001, 16, 4, 4, [0]),           # odd cpb, ragged row chunks
    (1, 1, 1024, 2048, 20, 4, 4, [0]),          # K padded to 32
    (1, 1, 1024, 2048, 128, 4, 4, [0]),         # rank 128
    (1, 2, 512, 1024, 64, 2, 4, [1]),           # K=64, coarser budget
    (4, 8, 512, 512, 32, 4, 8, [5, 2, 7, 0]),   # stacked, per-worker buckets
])
def test_dense_mf_hop_kernel_matches_plain(cuda, nw, n_blocks, rpw, cpb, k,
                                           nmb, nmb_fine, buckets):
    v, w, h, rc, cc = (x.to(cuda) for x in mf_hop_inputs(
        nw, n_blocks, rpw, cpb, k, nmb_fine, seed=rpw + cpb + k))
    b = torch.tensor(buckets, dtype=torch.int32, device=cuda)
    args = (v, b, w, h, rc, cc, nmb, 0.05, 0.01)
    before = pk.launches["dense_mf_hop"]
    w1, h1, sse1 = pk.dense_mf_hop_cuda(*args)
    torch.cuda.synchronize()
    assert pk.launches["dense_mf_hop"] == before + 1
    w2, h2, sse2 = pk.dense_mf_hop_plain(*args)
    w3, h3, _ = pk.dense_mf_hop_plain(v, b, w.double(), h.double(),
                                      rc.double(), cc.double(), nmb, 0.05,
                                      0.01)
    assert w1.shape == w.shape and h1.shape == h.shape and sse1.shape == (nw,)
    for got, plain, exact in ((w1, w2, w3), (h1, h2, h3)):
        tol = max(1e-4, 4 * max_rel(plain.double(), exact))
        assert max_rel(got.double(), exact) <= tol
    torch.testing.assert_close(sse1, sse2, rtol=1e-5, atol=0)
    again = pk.dense_mf_hop_cuda(*args)
    for a, c in zip((w1, h1, sse1), again):
        assert torch.equal(a, c)


def test_dense_mf_hop_kernel_refuses_bad_inputs(cuda):
    v, w, h, rc, cc = (x.to(cuda) for x in mf_hop_inputs(1, 1, 64, 64, 8, 2))
    b = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        pk.dense_mf_hop_cuda(v, b.long(), w, h, rc, cc, 2, 0.05, 0.01)
    with pytest.raises(ValueError, match="K <= 128"):
        pk.dense_mf_hop_cuda(v, b, torch.zeros(1, 64, 130, device=cuda),
                             torch.zeros(1, 64, 130, device=cuda), rc, cc, 2,
                             0.05, 0.01)
    with pytest.raises(ValueError, match="nmb"):
        pk.dense_mf_hop_cuda(v, b, w, h, rc, cc, 3, 0.05, 0.01)


def spd_inputs(n, k, seed=0):
    """ALS-shaped SPD systems (V'V over 4k rows plus 0.1 I) and right-hand
    sides, made with numpy from a seed (CPU float32 tensors)."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, 4 * k, k)).astype(np.float32) / np.sqrt(k)
    a = np.einsum("nek,nel->nkl", v, v) + 0.1 * np.eye(k, dtype=np.float32)
    b = rng.standard_normal((n, k)).astype(np.float32)
    return torch.from_numpy(a.astype(np.float32)), torch.from_numpy(b)


@pytest.mark.parametrize("n,k", [
    (8192, 32),       # the ALS flagship's systems
    (8191, 10),       # odd N, K below a warp
    (4096, 33),       # the first K with two columns a lane
    (8192, 64),       # the largest K
    (100, 1),         # one unknown
])
def test_spd_solve_kernel_matches_plain(cuda, n, k):
    a, b = (t.to(cuda) for t in spd_inputs(n, k, seed=n + k))
    before = pk.launches["spd_solve"]
    x = pk.spd_solve_cuda(a, b)
    torch.cuda.synchronize()
    assert pk.launches["spd_solve"] == before + 1
    assert x.shape == (n, k) and x.dtype == torch.float32
    plain = pk.spd_solve_plain(a, b)
    exact = torch.linalg.solve(a.double(), b.double())
    tol = max(1e-5, 4 * max_rel(plain.double(), exact))
    assert max_rel(x.double(), exact) <= tol
    assert torch.equal(x, pk.spd_solve_cuda(a, b))


def test_spd_solve_kernel_refuses_bad_inputs(cuda):
    a, b = (t.to(cuda) for t in spd_inputs(4, 65))
    with pytest.raises(ValueError, match="K <= 64"):
        pk.spd_solve_cuda(a, b)
    a, b = (t.to(cuda) for t in spd_inputs(4, 8))
    with pytest.raises(ValueError, match="CUDA device"):
        pk.spd_solve_cuda(a.cpu(), b.cpu())
    with pytest.raises(TypeError, match="float32"):
        pk.spd_solve_cuda(a.double(), b.double())
    with pytest.raises(ValueError, match="contiguous"):
        pk.spd_solve_cuda(a.transpose(1, 2), b)


def attention64(q, k, v, causal, rows):
    """float64 attention of the query rows ``rows`` of every stacked worker
    and head against all keys: (out (W, R, H, Dv), m (W, R, H), den)."""
    q, k, v = (x if x.dim() == 4 else x[None] for x in (q, k, v))
    s = torch.einsum("wqhd,wkhd->whqk", q[:, rows].double(), k.double())
    s = s / math.sqrt(q.shape[-1])
    if causal:
        keys = torch.arange(k.shape[1], device=k.device)
        s = s.masked_fill(rows[:, None] < keys[None, :], -math.inf)
    m = s.amax(dim=3)
    p = torch.exp(s - m[..., None])
    den = p.sum(dim=3)
    out = torch.einsum("whqk,wkhd->wqhd", p, v.double())
    return (out / den.transpose(1, 2)[..., None], m.transpose(1, 2),
            den.transpose(1, 2))


def sample_rows(l, n=256, seed=0):
    g = torch.Generator().manual_seed(seed)
    rows = torch.cat([torch.tensor([0, l - 1]), torch.randint(0, l, (n,),
                                                              generator=g)])
    return torch.unique(rows)


@pytest.mark.parametrize("w,l,h,dh,dv,causal,dtype", [
    (1, 4096, 8, 64, 64, True, torch.float32),      # the flagship's shape, cut
    (1, 1000, 4, 64, 64, False, torch.float32),     # ragged L, not causal
    (1, 97, 1, 8, 8, True, torch.float32),          # prime L, narrow head
    (1, 2048, 4, 128, 128, True, torch.float32),    # Dh = 128
    (1, 1031, 2, 64, 96, True, torch.float32),      # Dv != Dh, ragged
    (1, 2048, 8, 64, 64, True, torch.bfloat16),     # bf16 inputs
    (3, 700, 3, 32, 48, False, torch.float32),      # stacked, odd W H
    (1, 130, 2, 100, 20, True, torch.float32),      # odd widths
])
def test_flash_attention_kernel_matches_plain(cuda, w, l, h, dh, dv, causal,
                                              dtype):
    g = torch.Generator().manual_seed(l + dh + dv)
    q, k = (torch.randn(w, l, h, dh, generator=g).to(cuda, dtype)
            for _ in range(2))
    v = torch.randn(w, l, h, dv, generator=g).to(cuda, dtype)
    before = pk.launches["flash_attention"]
    out, m, den = pk.flash_attention_cuda(q, k, v, causal, return_stats=True)
    torch.cuda.synchronize()
    assert pk.launches["flash_attention"] == before + 1
    assert out.shape == (w, l, h, dv) and m.shape == den.shape == (w, l, h)
    assert out.dtype == m.dtype == den.dtype == torch.float32
    plain = pk.flash_attention_plain(q, k, v, causal, return_stats=True)
    rows = sample_rows(l).to(cuda)
    exact = attention64(q, k, v, causal, rows)
    for got, ref, ex in zip((out, m, den), plain, exact):
        tol = max(1e-5, 4 * max_rel(ref[:, rows].double(), ex))
        assert max_rel(got[:, rows].double(), ex) <= tol
    assert torch.equal(out, pk.flash_attention_cuda(q, k, v, causal))
    for wi in range(w):
        one = pk.flash_attention_cuda(q[wi], k[wi], v[wi], causal,
                                      return_stats=True)
        assert all(torch.equal(a[wi], b) for a, b in zip((out, m, den), one))


FLASH_TILE = 64   # the kernel's query and key tile


def trapezoid_tiles(l, causal, tile=FLASH_TILE):
    """KV tiles one (worker, head) loads at length ``l``: causal, query
    tile iq walks the min(n, iq + 1) tiles at or below the diagonal (none
    above it); otherwise all n of the n x n square."""
    n = -(-l // tile)
    return sum(min(n, iq + 1) for iq in range(n)) if causal else n * n


@pytest.mark.parametrize("l", [1, 63, 64, 65, 200, 8209])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_kernel_loads_the_trapezoid(cuda, l, causal):
    w, h = 2, 3
    g = torch.Generator().manual_seed(l)
    q, k, v = (torch.randn(w, l, h, 16, generator=g).to(cuda)
               for _ in range(3))
    with pk.count_flash_tiles() as tiles:
        pk.flash_attention_cuda(q, k, v, causal)
        assert tiles() == w * h * trapezoid_tiles(l, causal)
        pk.flash_attention_cuda(q, k, v, causal)
        assert tiles() == 2 * w * h * trapezoid_tiles(l, causal)


def test_flash_attention_kernel_refuses_bad_inputs(cuda):
    x = torch.zeros(64, 2, 16, device=cuda)
    with pytest.raises(ValueError, match="Dh, Dv <= 128"):
        wide = torch.zeros(64, 2, 130, device=cuda)
        pk.flash_attention_cuda(wide, wide, wide)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        pk.flash_attention_cuda(x.half(), x.half(), x.half())
    with pytest.raises(TypeError, match="share one type"):
        pk.flash_attention_cuda(x, x, x.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(2, 64, 16, device=cuda).transpose(0, 1)
        pk.flash_attention_cuda(t, t, t)
    with pytest.raises(ValueError, match="CUDA device"):
        pk.flash_attention_cuda(x, x.cpu(), x)


# --------------------------------------------------------------------------- #
# Ring DMA: the hop and the allgather (bitwise: the engine moves bytes)
# --------------------------------------------------------------------------- #

RING_DTYPES = [torch.float32, torch.bfloat16, torch.int32, torch.uint8]


def _ring_block(cuda, dtype, w=4, n=4099, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(-1000, 1000, (w, n), generator=g)
    return (x % 256 if dtype == torch.uint8 else x).to(dtype).to(cuda)


@pytest.mark.parametrize("dtype", RING_DTYPES)
@pytest.mark.parametrize("shift", [1, -1, 3])
def test_ring_dma_hop_kernel_matches_roll(cuda, dtype, shift):
    from harp_tpu_torch.ops import ring_dma
    from harp_tpu_torch.parallel.mesh import WorkerGroup

    group = WorkerGroup(4, cuda)
    for n in (4099, 1 << 18):           # a ragged byte count and 1 MiB a row
        x = _ring_block(cuda, dtype, n=n, seed=n)
        before = ring_dma.launches["ring_dma_hop"]
        got = ring_dma.hop_cuda(x, shift, group)
        assert ring_dma.launches["ring_dma_hop"] == before + 1
        assert torch.equal(got, torch.roll(x, shift, 0))


@pytest.mark.parametrize("dtype", RING_DTYPES)
def test_ring_allgather_kernel_matches_the_copy(cuda, dtype):
    from harp_tpu_torch.ops import ring_dma
    from harp_tpu_torch.parallel.mesh import WorkerGroup

    x = _ring_block(cuda, dtype).reshape(4, 1, -1)
    before = ring_dma.launches["ring_allgather"]
    got = ring_dma.ring_allgather_cuda(x, WorkerGroup(4, cuda))
    assert ring_dma.launches["ring_allgather"] == before + 1
    assert torch.equal(got, x.flatten(0, 1))


def test_ring_dma_kernels_between_processes(cuda):
    """parallel/mp_smoke.py as 2 processes x 2 workers on the card: the
    kernels between processes (through CUDA IPC) and within one, bitwise
    the stacked group."""
    import os
    import sys

    from harp_tpu_torch.parallel import launch

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    result = launch.launch(
        2, [sys.executable, "-m", "harp_tpu_torch.parallel.mp_smoke"], 2,
        timeout=300, cwd=root)
    for i, (rc, out) in enumerate(result):
        assert rc == 0 and f"MP_SMOKE OK p{i}/2" in out, out[-4000:]


def test_ring_dma_hop_gives_up_on_a_hung_peer(cuda):
    """Process 1 never enters the hop: process 0's kernel gives up after its
    spin limit (about 10 s) and ``check_errors`` raises instead of the run
    hanging."""
    import os
    import sys

    from harp_tpu_torch.parallel import launch

    code = (
        "import sys, time, torch\n"
        "from harp_tpu_torch import HarpSession\n"
        "from harp_tpu_torch.ops import ring_dma\n"
        "s = HarpSession(num_workers=2, distributed=True)\n"
        "x = torch.ones(1, 1024, device='cuda')\n"
        "assert torch.equal(ring_dma.hop_cuda(x, 1, s.workers), x)\n"
        "ring_dma.check_errors()\n"
        "s.barrier()\n"
        "if s.workers.rank == 1:\n"
        "    time.sleep(20)\n"
        "    sys.exit(0)\n"
        "t0 = time.time()\n"
        "ring_dma.hop_cuda(x, 1, s.workers)\n"
        "try:\n"
        "    ring_dma.check_errors()\n"
        "except RuntimeError as e:\n"
        "    print('GAVE UP', round(time.time() - t0, 1), e, flush=True)\n"
        "    sys.exit(0)\n"
        "sys.exit(1)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    result = launch.launch(2, [sys.executable, "-c", code], timeout=120,
                           cwd=root, extra_env={"PYTHONPATH": root})
    assert result.ok, result
    assert "GAVE UP" in result[0][1] and "credit" in result[0][1]
