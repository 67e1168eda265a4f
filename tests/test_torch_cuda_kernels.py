"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc and skips without them. This
file imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerances: K-means f32 sums rtol 1e-4 (the kernel and the matmul sum the
cross term in different orders), counts exact except for near-tie rows, cost
rtol 1e-4; bf16 sums rtol 2e-2. Two runs of a kernel are bitwise equal, and
a stacked launch of 4 workers is bitwise their separate launches at a tile
count above the grid (its blocks a worker do not depend on W).

Dense SGD-MF hop (K <= 128, and the wide path up to K = 1024): SSE rtol
1e-5 against the plain version. W and H are
held against the plain version run in float64 (exact sums of the same bf16
products): relative to their largest entry, the kernel must be within 1e-4
or within 4x the distance of the float32 plain version from it, whichever
is larger. A last-bit difference in pred can flip the bf16 rounding of an
entry of G, and the flip moves H, so every later stripe's pred, and G's
roundings there: one hop amplifies rounding by itself, by an amount that
depends on the data, so the yardstick is measured on the same inputs.

Batched SPD solve: the kernel and the plain version sum in different orders
(the kernel's fused multiply-adds), so both are held against a
float64 ``torch.linalg.solve`` of the same systems: the kernel within
max(1e-5, 4x the plain version's own distance from it), relative to max
|x|. The one-warp kernel (K <= 32) solves 8 or 4 systems a warp, K / G
rows a lane: at the edges of its lanes and rows (K = 4, 5, 8, 9, 16, 17,
24, 25) and at N ragged against them
by the same rule; a system's x is bitwise the same solved alone and at any
place in a batch, and a system that is not positive definite gives NaN in
its own row only, its neighbours bitwise as without it. The shared-memory kernel (32 < K <= ``SPD_MAX_K_SMEM``) and the
global-memory kernel (above it; both a panel-blocked Cholesky) follow the
plain version's steps and are held to it within 1e-4 of max |x| as well; the
two run the same arithmetic (every element's chain of fused multiply-adds in
the same order), so where both take a K they agree bitwise, at every
geometry of the shared-memory kernel, at panel edges and at ragged N too.
The global-memory kernel is held by the same rules at its limit, K =
``SPD_MAX_K_GLOBAL``, on one system.

Dispatch: where the JAX package takes XLA (K-means on float16 points;
attention below the flash length), a dispatcher on CUDA tensors launches
nothing, counts each plain call in ``plain_on_card`` and answers as the
plain version does, within the tolerances above. At the widths past the
narrow kernels (K-means K=400 at D=100, dense-MF K=192, flash Dh=192 at
L=8192) the dispatcher launches the wide kernel once, makes no plain call
and answers within the kernel's own tolerance of the plain version.

K-means past one block's shared memory (the wide variant): the narrow
kernel's rules at ragged N, phantom rows, bf16, per-worker tables, D past
824 and one centroid; a stacked launch bitwise its per-worker launches at
K = 1024, D = 128; its grid the twin of ``kmeans_wide_plan``; a W = 4 fit
at K = 1030, D = 1024 one wide launch an iteration. Both variants also at
the edges of their tensor-core layout: rows whose bytes are not a multiple
of 16 (float32 at D = 33, bf16 at D = 100), D past 128 (the 128-feature
sums carried in float32), K not a multiple of the centroid chunk, N under
one point tile, phantom rows with a per-worker table.

Flash attention: the kernel and the plain version (a full-row softmax) sum
in different orders, so both are held against a float64 attention of the
same inputs over sampled query rows of every head: out, m and den within
max(1e-5, 4x the plain version's own distance), relative to their largest
entry; heads past 128 (the wide variant) by the same rule, with q kept in
shared memory to Dh = 256 and reloaded in chunks past it, and Dv sliced in
256 columns: a Dv = 512 launch is bitwise two Dv = 256 launches on its
halves. A stacked launch is bitwise the separate ones, and two runs are
bitwise equal. The KV tiles the kernel counts as loaded are exactly the
causal trapezoid of its tiles (``pk.trapezoid_tiles``: 128 query rows by 64
keys to Dh, Dv = 128, 64 x 64 in the wide variant; tests/
test_torch_attention.py holds the formula against the JAX package's grid).

Ring DMA: the hop and the allgather are bitwise ``torch.roll`` and the
stacked copy for every dtype and for a ragged byte count, one launch a
call, and on a stream of the caller's, behind the kernel that wrote their
input; the raw stream handle they read is ``current_stream()``'s;
``parallel/mp_smoke.py`` as 2 processes x 2 workers on the card holds
the kernels between processes bitwise to the stacked group, the in-kernel
sends among them.

In-kernel ring sends (``ring_hop``): the dense-MF hop's and flash
attention's other outputs are bitwise the launch without the send, and the
sent blocks (h_next; k_next, v_next) bitwise ``torch.roll`` of h' and of k,
v; 200 back-to-back dense-MF sends between 2 processes, one held back by a
busy kernel of varying length, all deliver their own iteration's block.
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
    """Rows whose best two scores are within eps (relative) of each other
    (none with one centroid)."""
    if valid_k < 2:
        return 0
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
    (1, 2048, 100, 100, 100, torch.bfloat16, False),  # bf16 rows of 200 B
    (1, 50, 20, 33, 17, torch.float32, False),      # N under one tile
    (1, 3333, 70, 48, 70, torch.float32, False),    # K not a chunk multiple
    (2, 1000, 100, 100, 90, torch.bfloat16, True),  # per worker, phantom
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


def test_kmeans_stats_stacked_launch_is_bitwise_the_separate_ones(cuda):
    """262,144 points a worker, K = 100, D = 100: 4096 tiles, more than the
    blocks of one worker's grid, so the grid is the card's resident blocks
    in both launches and each worker's partial sums add in the same order."""
    w, n, k, d = 4, 262_144, 100, 100
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(w, n, d, generator=g, device=cuda)
    c = torch.randn(k, d, generator=g, device=cuda)
    lib = pk._kmeans_lib()
    grid = lib.kmeans_stats_grid(n, d, k, k, 0)
    assert 1 <= grid < -(-n // 64)
    stacked = pk.kmeans_stats_cuda(x, c)
    for wi in range(w):
        one = pk.kmeans_stats_cuda(x[wi], c)
        assert all(torch.equal(a[wi], b) for a, b in zip(stacked, one))


@pytest.mark.parametrize("d,k", [(1, 1), (16, 8), (100, 100), (100, 249),
                                 (100, 250), (33, 37), (256, 200)])
def test_kmeans_smem_twin_matches_the_library(cuda, d, k):
    assert pk._kmeans_lib().kmeans_stats_smem_bytes(d, k) == \
        pk.kmeans_smem_bytes(d, k)


@pytest.mark.parametrize("w,n,k,d,valid_k,dtype,per_worker", [
    (1, 65_537, 408, 100, 400, torch.float32, False),  # ragged, phantom rows
    (2, 5000, 250, 100, 250, torch.float32, False),    # the first K past smem
    (1, 4099, 264, 100, 250, torch.bfloat16, False),   # bf16 points
    (3, 3000, 16, 900, 16, torch.float32, True),       # D past 824, per worker
    (1, 2000, 1, 825, 1, torch.float32, False),        # one centroid
    (1, 3001, 300, 1030, 290, torch.float32, False),   # D not a chunk multiple
    (1, 3001, 500, 33, 480, torch.float32, False),     # f32 rows of 132 B
    (1, 4099, 300, 100, 290, torch.bfloat16, False),   # bf16 rows of 200 B
    (1, 2100, 300, 1030, 300, torch.bfloat16, False),  # bf16 past D = 128
    (1, 5000, 200, 64, 200, torch.float32, False),     # K not a multiple of 128
    (1, 100, 300, 100, 300, torch.float32, False),     # N under one tile
    (3, 2000, 300, 100, 280, torch.float32, True),     # per worker, phantom
])
def test_kmeans_stats_wide_kernel_matches_plain(cuda, w, n, k, d, valid_k,
                                                dtype, per_worker):
    """Past one block's shared memory the wrapper launches the wide
    variant, held to the plain version by the narrow kernel's rules."""
    assert pk.kmeans_smem_bytes(d, k) > pk.MAX_SMEM_BYTES
    g = torch.Generator().manual_seed(n + k + d)
    x = torch.randn(w, n, d, generator=g).to(cuda, dtype)
    c = torch.randn(k, d, generator=g).to(cuda)
    if per_worker:
        c = c.expand(w, -1, -1).contiguous()
    before = dict(pk.launches)
    sums, counts, cost = pk.kmeans_stats_cuda(x, c, valid_k)
    torch.cuda.synchronize()
    assert _moved(before, pk.launches) == {"kmeans_stats": 1,
                                           "kmeans_stats_wide": 1}
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


@pytest.mark.parametrize("per_worker", [False, True])
def test_kmeans_stats_wide_stacked_launch_is_bitwise_the_separate_ones(
        cuda, per_worker):
    """K = 1024, D = 128, 65,536 points a worker: 1024 tiles of the sums
    pass, more than its grid, so each worker's slabs add in the same order
    in a stacked launch and in its own."""
    w, n, k, d = 4, 65_536, 1024, 128
    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(w, n, d, generator=g, device=cuda)
    c = torch.randn(w if per_worker else 1, k, d, generator=g, device=cuda)
    c = c if per_worker else c[0]
    grid = pk._kmeans_lib().kmeans_stats_wide_grid(n, d, k)
    assert 1 <= grid < -(-n // 64)
    stacked = pk.kmeans_stats_cuda(x, c)
    for wi in range(w):
        one = pk.kmeans_stats_cuda(x[wi], c[wi] if per_worker else c)
        assert all(torch.equal(a[wi], b) for a, b in zip(stacked, one))


@pytest.mark.parametrize("n,d,k", [(1 << 20, 100, 400), (1 << 20, 128, 1024),
                                   (262_144, 1024, 256), (4097, 100, 250),
                                   (1, 825, 1), (1 << 20, 4094, 2048)])
def test_kmeans_wide_plan_matches_the_library(cuda, n, d, k):
    assert pk._kmeans_lib().kmeans_stats_wide_grid(n, d, k) == \
        pk.kmeans_wide_plan(n, d, k)["grid"]


def test_kmeans_stats_kernel_refuses_bad_inputs(cuda):
    x = torch.zeros(64, 8, device=cuda)
    c = torch.zeros(4, 8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        pk.kmeans_stats_cuda(x.t().contiguous().t(), c)
    with pytest.raises(TypeError, match="float32"):
        pk.kmeans_stats_cuda(x.half(), c)
    # the stated limit: one (K, D + 2) slab within the wide variant's budget
    k = pk.KMEANS_MAX_KD // 3 + 1
    with pytest.raises(ValueError, match="K \\(D \\+ 2\\)"):
        pk.kmeans_stats_cuda(torch.zeros(64, 1, device=cuda),
                             torch.zeros(k, 1, device=cuda))


def test_kmeans_fit_takes_the_wide_variant(cuda):
    """A W = 4 fit at K = 1030, D = 1024 (k_pad = 1032, valid_k = K): one
    wide launch an iteration, no plain call, costs that never rise and a
    final cost within 1e-4 of the same fit through the plain E-step."""
    from harp_tpu_torch import HarpSession
    from harp_tpu_torch.io import datagen
    from harp_tpu_torch.models import kmeans as km

    pts = datagen.dense_points(8192, 1024, seed=4, num_clusters=1030)
    cen0 = datagen.initial_centroids(pts, 1030, seed=5)
    cfg = km.KMeansConfig(1030, 1024, 3)
    b_launch, b_plain = _counts()
    cen, costs = km.KMeans(HarpSession(num_workers=4, device=cuda),
                           cfg).fit(pts, cen0)
    a_launch, a_plain = _counts()
    assert _moved(b_launch, a_launch) == {"kmeans_stats": 3,
                                          "kmeans_stats_wide": 3}
    assert _moved(b_plain, a_plain) == {}
    c = costs.cpu().double().numpy()
    assert np.all(np.isfinite(c)) and np.all(np.diff(c) <= 1e-6 * c[:-1])
    _, pcosts = km.KMeans(HarpSession(num_workers=4, device="cpu"),
                          cfg).fit(pts, cen0)
    assert abs(c[-1] - float(pcosts[-1])) <= 1e-4 * abs(float(pcosts[-1]))


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
    (1, 1, 512, 2100, 32, 4, 4, [0]),           # 9 tiles: a padded cluster
    (1, 1, 256, 256, 32, 2, 2, [0]),            # one tile and a pad block
    (1, 1, 512, 4352, 16, 4, 4, [0]),           # rank 16, 17 tiles
    (1, 1, 512, 2176, 64, 4, 4, [0]),           # rank 64, 17 tiles
    (1, 1, 520, 1000, 128, 4, 4, [0]),          # rank 128, ragged chunks
    (1, 1, 260, 1001, 100, 4, 4, [0]),          # K=100, odd cpb, 32-row chunks
    (4, 4, 256, 4096, 32, 4, 4, [3, 0, 2, 1]),  # stacked, 16 tiles a worker
    (1, 1, 1024, 2048, 256, 4, 4, [0]),         # wide path, rank 256
    (1, 1, 520, 1001, 136, 4, 4, [0]),          # wide, K=136, odd cpb
    (1, 1, 512, 1024, 512, 4, 4, [0]),          # wide, rank 512
    (1, 1, 256, 1000, 1024, 2, 2, [0]),         # wide, rank 1024
    (4, 8, 512, 512, 256, 4, 8, [5, 2, 7, 0]),  # wide, stacked
    (1, 1, 64, 520, 256, 4, 4, [0]),            # wide, stripes of 16 rows
    (1, 1, 64, 1003, 512, 4, 4, [0]),           # wide, cluster of 2, odd cpb
    (2, 2, 256, 520, 1024, 2, 2, [1, 0]),       # wide, stacked rank 1024
    (1, 1, 200, 130, 300, 2, 2, [0]),           # wide, a tile of 2 columns
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


@pytest.mark.parametrize("k,cpb", [(32, 1000), (20, 1000), (256, 1000),
                                   (200, 1000), (32, 2100), (128, 1100),
                                   (512, 1000), (1024, 520)])
def test_dense_mf_hop_ring_hop_sends_h_bitwise(cuda, k, cpb):
    """W=4 stacked, per-worker buckets, K=32 and K=20 (padded to 32), and
    the wide path at K=256 and 200 (padded to 256) and in clusters of 2 and
    4 rank slices (K=512, 1024); at K=32 with 9 column tiles and K=128 with
    9, each a grid padded to two clusters: the send changes no other
    output, and h_next is h' rolled by one worker, bitwise the
    kernel-plus-``ring_dma.hop`` pair it replaces."""
    from harp_tpu_torch.ops import ring_dma
    from harp_tpu_torch.parallel.mesh import WorkerGroup

    v, w, h, rc, cc = (x.to(cuda) for x in mf_hop_inputs(
        4, 8, 512, cpb, k, 8, seed=k))
    b = torch.tensor([5, 2, 7, 0], dtype=torch.int32, device=cuda)
    args = (v, b, w, h, rc, cc, 4, 0.05, 0.01)
    plain = pk.dense_mf_hop_cuda(*args)
    before = dict(pk.launches)
    group = WorkerGroup(4, cuda)
    got = pk.dense_mf_hop_cuda(*args, ring_hop=True, group=group)
    torch.cuda.synchronize()
    assert pk.launches["dense_mf_hop"] == before["dense_mf_hop"] + 1
    assert pk.launches["dense_mf_hop_ring"] == before["dense_mf_hop_ring"] + 1
    assert len(got) == 4 and got[3].shape == h.shape
    for a, c in zip(got[:3], plain):
        assert torch.equal(a, c)
    assert torch.equal(got[3], torch.roll(got[1], 1, 0))
    assert torch.equal(got[3], ring_dma.hop_cuda(plain[1], 1, group))


@pytest.mark.parametrize("kp", [16, 32, 64, 128])
def test_dense_mf_narrow_twin_matches_the_library(cuda, kp):
    """``MF_NARROW_TILES`` and ``MF_CHUNK_ROWS`` (and so
    ``dense_mf_narrow_shapes``) are the library's column tile, cluster size
    and rows a chunk."""
    import ctypes

    lib = pk._mf_lib()
    assert (lib.dense_mf_hop_col_tile(kp),
            lib.dense_mf_hop_cluster(kp)) == pk.MF_NARROW_TILES[kp]
    assert lib.dense_mf_hop_cluster(kp) > 1
    geo = (ctypes.c_int * 4)()
    assert lib.dense_mf_hop_geometry(kp, geo) == 0
    assert geo[0] == pk.MF_CHUNK_ROWS and geo[3] == pk.MF_NARROW_TILES[kp][1]


@pytest.mark.parametrize("kp", [256, 512, 1024])
def test_dense_mf_wide_twin_matches_the_library(cuda, kp):
    """``MF_WIDE_COLS``, ``MF_WIDE_RANKS_A_BLOCK`` and ``MF_CHUNK_ROWS`` (and
    so ``dense_mf_wide_shapes``) are the wide path's column tile, ranks a
    block and rows a chunk in the library; its cluster is the rank slices,
    and the card holds at least one cluster with three stages or more."""
    import ctypes

    lib = pk._mf_lib()
    assert lib.dense_mf_hop_col_tile(kp) == pk.MF_WIDE_COLS
    assert lib.dense_mf_hop_cluster(kp) == kp // pk.MF_WIDE_RANKS_A_BLOCK
    geo = (ctypes.c_int * 6)()
    assert lib.dense_mf_hop_wide_geometry(kp, geo) == 0
    rows, stages, active, cluster, ranks, dw_stages = list(geo)
    assert rows == pk.MF_CHUNK_ROWS and ranks == pk.MF_WIDE_RANKS_A_BLOCK
    assert cluster == kp // ranks and stages >= 3 and dw_stages >= 3
    assert active >= 1
    assert lib.dense_mf_hop_wide_geometry(128, geo) == -1


@pytest.mark.parametrize("k", [16, 1024])
def test_dense_mf_hop_ring_sends_survive_a_held_back_rank(cuda, k):
    """2 processes x 1 worker: 200 back-to-back sends, process 1 held back
    before each by a busy kernel of varying length; every h_next is its
    left neighbour's block of the same iteration (an all-missing slab with
    zero counts leaves H as it was), and each send has its receive launch;
    at K = 16 (the narrow kernel) and 1024 (the wide path in clusters of
    4, whose rank 0 decides each column tile's send)."""
    import os
    import sys

    from harp_tpu_torch.parallel import launch

    code = (
        "import torch\n"
        "from harp_tpu_torch import HarpSession\n"
        "from harp_tpu_torch.ops import pallas_kernels as pk, ring_dma\n"
        "s = HarpSession(num_workers=2, distributed=True)\n"
        "g, r = s.workers, s.workers.rank\n"
        "dev = torch.device('cuda')\n"
        "slab = torch.full((1, 1, 16, 1000), float('nan'), device=dev)\n"
        "slab = slab.bfloat16()\n"
        "b = torch.zeros(1, dtype=torch.int32, device=dev)\n"
        f"w = torch.ones(1, 16, {k}, device=dev)\n"
        f"h = torch.empty(1, 1000, {k}, device=dev)\n"
        "rc = torch.zeros(1, 1, 16, device=dev)\n"
        "cc = torch.zeros(1, 1, 1, 1000, device=dev)\n"
        "bad = torch.zeros((), dtype=torch.int64, device=dev)\n"
        "s.barrier()\n"
        "for it in range(200):\n"
        "    if r == 1:\n"
        "        torch.cuda._sleep(20000 * (it % 13))\n"
        "    h.fill_(r * 1000 + it)\n"
        "    out = pk.dense_mf_hop_cuda(slab, b, w, h, rc, cc, 1, 0.05, "
        "0.01, ring_hop=True, group=g)\n"
        "    bad += (out[3] != (1 - r) * 1000 + it).sum()\n"
        "    bad += (out[1] != h).sum()\n"
        "ring_dma.check_errors()\n"
        "print('SENDS', int(bad), ring_dma.launches['ring_recv'], "
        "flush=True)\n"
        "s.barrier()\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    result = launch.launch(2, [sys.executable, "-c", code], timeout=300,
                           cwd=root, extra_env={"PYTHONPATH": root})
    assert result.ok, result
    for _, out in result:
        assert "SENDS 0 200" in out, out[-4000:]


def test_dense_mf_hop_kernel_refuses_bad_inputs(cuda):
    v, w, h, rc, cc = (x.to(cuda) for x in mf_hop_inputs(1, 1, 64, 64, 8, 2))
    b = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        pk.dense_mf_hop_cuda(v, b.long(), w, h, rc, cc, 2, 0.05, 0.01)
    with pytest.raises(ValueError, match="K <= 1024"):
        pk.dense_mf_hop_cuda(v, b, torch.zeros(1, 64, 1025, device=cuda),
                             torch.zeros(1, 64, 1025, device=cuda), rc, cc, 2,
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
    (8192, 32),       # the ALS flagship's systems, the largest K
    (8191, 10),       # odd N, K below a warp
    (4096, 17),       # K neither a power of two nor a multiple of 8
    (8192, 31),       # one lane idle
    (100, 1),         # one unknown
    (8191, 8),        # 4 lanes a system, 8 a warp: the last warp ragged
    (4096, 9),        # the first K of 8 lanes a system
    (4096, 16),       # the last K of two rows a lane at 8 lanes
    (1, 10),          # one system, the rest of its warp empty
    (4099, 4),        # the last K of one row a lane
    (4099, 5),        # the first K of two rows a lane
    (2053, 24),       # the last K of three rows a lane
    (2053, 25),       # the first K of four rows a lane, two warps a block
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


@pytest.mark.parametrize("k", [8, 10, 32])
def test_spd_solve_kernel_solves_each_system_alone(cuda, k):
    """A system's x does not depend on its place in the batch or on its
    neighbours in the warp: solved alone (N = 1) it is bitwise what the
    batch gives it at positions 0, middle and last."""
    n = 1031                      # ragged against 1, 2 and 4 systems a warp
    a, b = (t.to(cuda) for t in spd_inputs(n, k, seed=k))
    x = pk.spd_solve_cuda(a, b)
    for pos in (0, n // 2, n - 1):
        alone = pk.spd_solve_cuda(a[pos:pos + 1].contiguous(),
                                  b[pos:pos + 1].contiguous())
        assert torch.equal(alone[0], x[pos]), pos


@pytest.mark.parametrize("k", [8, 10, 32])
def test_spd_solve_kernel_keeps_a_bad_system_to_itself(cuda, k):
    """One system that is not positive definite gives NaN in its own row of
    x only; every other system, its neighbours in the warp among them, is
    bitwise what it is without it."""
    n, bad = 37, 5
    a, b = (t.to(cuda) for t in spd_inputs(n, k, seed=k + 1))
    good = pk.spd_solve_cuda(a, b)
    a[bad, k - 1, k - 1] = -5.0   # the last pivot negative
    x = pk.spd_solve_cuda(a, b)
    assert bool(torch.isnan(x[bad]).all())
    rest = torch.arange(n, device=cuda) != bad
    assert not bool(torch.isnan(x[rest]).any())
    assert torch.equal(x[rest], good[rest])


@pytest.mark.parametrize("k", [1, 8, 9, 16, 17, 24, 25, 32])
def test_spd_solve_kernel_twin_matches_the_library(cuda, k):
    assert pk._spd_lib().spd_solve_warp_smem_bytes(k) == \
        pk.spd_solve_warp_smem_bytes(k)
    assert pk.spd_solve_warp_per_sm(k) >= 1


@pytest.mark.parametrize("n,k", [(4096, 33), (8192, 64), (2048, 65),
                                 (2048, 96), (2048, 128), (257, 256),
                                 (64, 307)])
def test_spd_solve_block_kernel_matches_plain(cuda, n, k):
    a, b = (t.to(cuda) for t in spd_inputs(n, k, seed=n + k))
    before = dict(pk.launches)
    x = pk.spd_solve_cuda(a, b)
    torch.cuda.synchronize()
    assert pk.launches["spd_solve_block"] == before["spd_solve_block"] + 1
    assert pk.launches["spd_solve"] == before["spd_solve"]
    assert x.shape == (n, k) and x.dtype == torch.float32
    plain = pk.spd_solve_plain(a, b)
    assert max_rel(x.double(), plain.double()) <= 1e-4
    exact = torch.linalg.solve(a.double(), b.double())
    tol = max(1e-5, 4 * max_rel(plain.double(), exact))
    assert max_rel(x.double(), exact) <= tol
    assert torch.equal(x, pk.spd_solve_cuda(a, b))


@pytest.mark.parametrize("k", [33, 64, 65, 128, 307, 338])
def test_spd_solve_block_smem_twin_matches_the_library(cuda, k):
    assert pk._spd_lib().spd_solve_block_smem_bytes(k) == \
        pk.spd_solve_block_smem_bytes(k)


@pytest.mark.parametrize("n,k", [
    (4097, 33),       # ragged N against the grid; one column past a panel
    (1, 64),          # one system
    (8192, 65),
    (4097, 96),
    (8192, 128),
    (1031, 200),      # K not a multiple of the panel
    (257, 307),       # the shared-memory kernel's limit
])
def test_spd_solve_block_kernel_is_bitwise_the_global_kernel(cuda, n, k):
    """The shared-memory kernel runs the global-memory kernel's chains of
    operations: at every geometry, its x is the global kernel's bit for
    bit, and the route the wrapper takes is one of them."""
    a, b = spd_inputs_on(cuda, n, k, seed=n + k)
    glob = pk._spd_solve_global(a, b)
    assert pk.spd_solve_variant(k) == "spd_solve_block"
    assert torch.equal(pk.spd_solve_cuda(a, b), glob)
    for threads, regs in pk.SPD_BLOCK_SHAPES:
        x = pk._spd_solve_block(a, b, threads, regs)
        assert torch.equal(x, glob), (threads, regs)


def spd_inputs_on(dev, n, k, seed=0):
    """spd_inputs' systems made on ``dev`` with torch (V'V over 4k rows
    plus 0.1 I, and right-hand sides): numpy's einsum takes minutes at the
    wide K."""
    g = torch.Generator(device=dev).manual_seed(seed)
    v = torch.randn(n, 4 * k, k, generator=g, device=dev) / k ** 0.5
    a = torch.bmm(v.transpose(1, 2), v) + 0.1 * torch.eye(k, device=dev)
    return a.contiguous(), torch.randn(n, k, generator=g, device=dev)


@pytest.mark.parametrize("n,k", [(2048, 339), (1024, 384), (257, 512),
                                 (3, 700), (3, 2048)])
def test_spd_solve_global_kernel_matches_plain(cuda, n, k):
    a, b = spd_inputs_on(cuda, n, k, seed=n + k)
    before = dict(pk.launches)
    x = pk.spd_solve_cuda(a, b)
    torch.cuda.synchronize()
    assert pk.launches["spd_solve_global"] == before["spd_solve_global"] + 1
    assert pk.launches["spd_solve_block"] == before["spd_solve_block"]
    assert x.shape == (n, k) and x.dtype == torch.float32
    plain = pk.spd_solve_plain(a, b)
    assert max_rel(x.double(), plain.double()) <= 1e-4
    exact = torch.linalg.solve(a.double(), b.double())
    tol = max(1e-5, 4 * max_rel(plain.double(), exact))
    assert max_rel(x.double(), exact) <= tol
    assert torch.equal(x, pk.spd_solve_cuda(a, b))


def test_spd_solve_global_kernel_is_bitwise_the_block_kernel(cuda):
    """At a K both take (300), the global-memory kernel runs the
    shared-memory kernel's arithmetic: the same x bit for bit, on a grid
    smaller than N (each block loops over systems)."""
    a, b = spd_inputs_on(cuda, 4099, 300, seed=3)
    assert pk._spd_lib().spd_solve_global_grid(4099, 300) < 4099
    assert torch.equal(pk._spd_solve_global(a, b), pk.spd_solve_cuda(a, b))


@pytest.mark.parametrize("n,k", [(1031, 65), (2049, 100)])
def test_spd_solve_global_kernel_is_bitwise_the_block_kernel_at_panel_edges(
        cuda, n, k):
    """K = 65 (two panels and one column) and 100 (a partial last panel),
    neither a multiple of the panel width, at a ragged N over a grid
    smaller than N: the global-memory kernel's x is the shared-memory
    kernel's bit for bit."""
    a, b = spd_inputs_on(cuda, n, k, seed=n + k)
    assert pk._spd_lib().spd_solve_global_grid(n, k) < n
    assert torch.equal(pk._spd_solve_global(a, b), pk.spd_solve_cuda(a, b))


def test_spd_solve_global_kernel_at_two_panels_and_a_column(cuda):
    """K = 65, two 32-column panels and a column, through the global-memory
    kernel itself: within 1e-4 of the plain version and within max(1e-5,
    4x the plain version's distance) of a float64 solve, and two runs
    bitwise equal."""
    n, k = 1000, 65
    a, b = spd_inputs_on(cuda, n, k, seed=k)
    before = pk.launches["spd_solve_global"]
    x = pk._spd_solve_global(a, b)
    torch.cuda.synchronize()
    assert pk.launches["spd_solve_global"] == before + 1
    plain = pk.spd_solve_plain(a, b)
    assert max_rel(x.double(), plain.double()) <= 1e-4
    exact = torch.linalg.solve(a.double(), b.double())
    tol = max(1e-5, 4 * max_rel(plain.double(), exact))
    assert max_rel(x.double(), exact) <= tol
    assert torch.equal(x, pk._spd_solve_global(a, b))


def test_spd_solve_global_kernel_at_its_limit(cuda):
    """K = SPD_MAX_K_GLOBAL, one system (about 70 s of kernel and three
    minutes of the plain version on the card): finite, within 1e-4 of the
    plain version and within max(1e-5, 4x the plain version's distance) of
    a float64 solve."""
    k = pk.SPD_MAX_K_GLOBAL
    a, b = spd_inputs_on(cuda, 1, k, seed=k)
    before = dict(pk.launches)
    x = pk.spd_solve_cuda(a, b)
    torch.cuda.synchronize()
    assert pk.launches["spd_solve_global"] == before["spd_solve_global"] + 1
    assert x.shape == (1, k) and bool(torch.isfinite(x).all())
    exact = torch.linalg.solve(a.double(), b.double())
    plain = pk.spd_solve_plain(a, b)
    assert max_rel(x.double(), plain.double()) <= 1e-4
    tol = max(1e-5, 4 * max_rel(plain.double(), exact))
    assert max_rel(x.double(), exact) <= tol


def test_spd_solve_kernel_refuses_bad_inputs(cuda):
    k = pk.SPD_MAX_K_GLOBAL + 1
    with pytest.raises(ValueError, match=f"K <= {k - 1}"):
        pk.spd_solve_cuda(torch.zeros(1, 1, 1, device=cuda).expand(1, k, k),
                          torch.zeros(1, k, device=cuda))
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
    (1, 300, 2, 33, 17, True, torch.float32),       # unaligned: no cp.async
    (2, 300, 3, 20, 12, False, torch.bfloat16),     # unaligned bf16 rows
    (1, 1031, 2, 256, 256, True, torch.float32),    # wide: Dh = Dv = 256
    (1, 700, 2, 192, 128, True, torch.bfloat16),    # wide: MLA's 192 / 128
    (2, 300, 3, 512, 512, False, torch.float32),    # wide, stacked, 512
    (1, 130, 2, 100, 200, True, torch.float32),     # wide Dv only, odd
    # not causal at L = 4096: every row sums all 4096 keys, the shape where
    # a tensor-core sum carried across the KV tiles drifts past the check
    *((2, 4096, 2, dh, dv, False, dtype)
      for dh, dv in ((32, 48), (64, 96), (96, 64), (128, 80))
      for dtype in (torch.float32, torch.bfloat16)),
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


@pytest.mark.parametrize("dh,dv", [(64, 48), (256, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_ring_hop_sends_kv_bitwise(cuda, causal, dtype, dh,
                                                   dv):
    """W=4 stacked, ragged L, Dv != Dh, and a wide head (Dh = Dv = 256):
    out, m and den bitwise the launch without the send; k_next and v_next
    bitwise k and v rolled by one worker, in the input type, and the
    ``ring_dma.hop`` of each (the pair the send replaces)."""
    from harp_tpu_torch.ops import ring_dma
    from harp_tpu_torch.parallel.mesh import WorkerGroup

    g = torch.Generator().manual_seed(7 + causal)
    q, k = (torch.randn(4, 1000, 2, dh, generator=g) for _ in range(2))
    v = torch.randn(4, 1000, 2, dv, generator=g)
    q, k, v = (x.to(dtype).to(cuda) for x in (q, k, v))
    plain = pk.flash_attention_cuda(q, k, v, causal, return_stats=True)
    before = dict(pk.launches)
    group = WorkerGroup(4, cuda)
    got = pk.flash_attention_cuda(q, k, v, causal, return_stats=True,
                                  ring_hop=True, group=group)
    torch.cuda.synchronize()
    assert pk.launches["flash_attention"] == before["flash_attention"] + 1
    assert (pk.launches["flash_attention_ring"]
            == before["flash_attention_ring"] + 1)
    assert len(got) == 5
    for a, c in zip(got[:3], plain):
        assert torch.equal(a, c)
    for nxt, x in zip(got[3:], (k, v)):
        assert nxt.dtype == dtype and torch.equal(nxt, torch.roll(x, 1, 0))
        assert torch.equal(nxt, ring_dma.hop_cuda(x, 1, group))


@pytest.mark.parametrize("l", [1, 63, 64, 65, 127, 128, 129, 200, 8209])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_kernel_loads_the_trapezoid(cuda, l, causal):
    w, h = 2, 3
    g = torch.Generator().manual_seed(l)
    q, k, v = (torch.randn(w, l, h, 16, generator=g).to(cuda)
               for _ in range(3))
    with pk.count_flash_tiles() as tiles:
        pk.flash_attention_cuda(q, k, v, causal)
        assert tiles() == w * h * pk.trapezoid_tiles(l, causal)
        pk.flash_attention_cuda(q, k, v, causal)
        assert tiles() == 2 * w * h * pk.trapezoid_tiles(l, causal)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_wide_kernel_loads_the_trapezoid_a_slice(cuda,
                                                                 causal):
    """Dv = 300 takes the wide variant's two 256-column slices, each of
    which walks the trapezoid (Dh = 192, q kept whole, k in two chunks, one
    KV tile each)."""
    w, h, l = 1, 2, 200
    g = torch.Generator().manual_seed(l)
    q, k = (torch.randn(w, l, h, 192, generator=g).to(cuda) for _ in range(2))
    v = torch.randn(w, l, h, 300, generator=g).to(cuda)
    with pk.count_flash_tiles() as tiles:
        pk.flash_attention_cuda(q, k, v, causal)
        assert tiles() == 2 * w * h * pk.trapezoid_tiles(
            l, causal, pk.FLASH_WIDE_TILES)


def test_flash_attention_wide_kernel_takes_one_slice_at_dv256(cuda):
    """Dh = Dv = 256: one slice, so the scores once and the trapezoid once."""
    w, h, l = 2, 3, 1000
    g = torch.Generator().manual_seed(l)
    q, k, v = (torch.randn(w, l, h, 256, generator=g).to(cuda)
               for _ in range(3))
    with pk.count_flash_tiles() as tiles:
        pk.flash_attention_cuda(q, k, v, True)
        assert tiles() == w * h * pk.trapezoid_tiles(
            l, True, pk.FLASH_WIDE_TILES)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_wide_kernel_slices_dv512_in_two(cuda, causal):
    """Dv = 512: two 256-column slices, each walking the trapezoid; the
    launch is bitwise two Dv = 256 launches on v's halves (out), and m and
    den, written by slice 0, are bitwise theirs (every slice computes the
    same scores)."""
    l, h = 700, 2
    g = torch.Generator().manual_seed(l + causal)
    q, k = (torch.randn(l, h, 256, generator=g).to(cuda) for _ in range(2))
    v = torch.randn(l, h, 512, generator=g).to(cuda)
    with pk.count_flash_tiles() as tiles:
        out, m, den = pk.flash_attention_cuda(q, k, v, causal,
                                              return_stats=True)
        assert tiles() == 2 * h * pk.trapezoid_tiles(
            l, causal, pk.FLASH_WIDE_TILES)
    for half in (slice(0, 256), slice(256, 512)):
        o2, m2, d2 = pk.flash_attention_cuda(q, k, v[..., half].contiguous(),
                                             causal, return_stats=True)
        assert torch.equal(out[..., half], o2)
        assert torch.equal(m, m2) and torch.equal(den, d2)


@pytest.mark.parametrize("dh", [256, 257])
def test_flash_attention_wide_kernel_q_resident_and_chunked(cuda, dh):
    """Dh = 256 keeps the q tile in shared memory for the whole KV loop,
    Dh = 257 reloads it in 128-wide chunks beside k: each held against a
    float64 attention within max(1e-5, 4x the plain version's distance)."""
    l, h, dv = 1031, 2, 96
    g = torch.Generator().manual_seed(dh)
    q, k = (torch.randn(1, l, h, dh, generator=g).to(cuda) for _ in range(2))
    v = torch.randn(1, l, h, dv, generator=g).to(cuda)
    got = pk.flash_attention_cuda(q, k, v, True, return_stats=True)
    plain = pk.flash_attention_plain(q, k, v, True, return_stats=True)
    rows = sample_rows(l).to(cuda)
    exact = attention64(q, k, v, True, rows)
    for a, ref, ex in zip(got, plain, exact):
        tol = max(1e-5, 4 * max_rel(ref[:, rows].double(), ex))
        assert max_rel(a[:, rows].double(), ex) <= tol


def test_flash_attention_kernel_refuses_bad_inputs(cuda):
    x = torch.zeros(64, 2, 16, device=cuda)
    # a head past 128 is no longer refused: one launch of the wide variant
    wide = torch.randn(64, 2, 130, device=cuda)
    before = pk.launches["flash_attention"]
    torch.testing.assert_close(pk.flash_attention_cuda(wide, wide, wide),
                               pk.flash_attention_plain(wide, wide, wide),
                               rtol=1e-4, atol=1e-5)
    assert pk.launches["flash_attention"] == before + 1
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


def test_ring_kernels_launch_on_the_current_stream(cuda):
    """The stacked hop and allgather under ``torch.cuda.stream(s)``, called
    right after a kernel on s writes x (behind a wait of some 25 ms on s):
    bitwise ``torch.roll`` and the copy of what that kernel wrote, so each
    launch was queued on s, behind the write."""
    from harp_tpu_torch.ops import ring_dma
    from harp_tpu_torch.parallel.mesh import WorkerGroup

    group = WorkerGroup(4, cuda)
    src = _ring_block(cuda, torch.float32, n=1 << 18, seed=5)
    for call, want in ((lambda x: ring_dma.hop_cuda(x, 1, group),
                        lambda x: torch.roll(x, 1, 0)),
                       (lambda x: ring_dma.ring_allgather_cuda(
                           x.reshape(4, 1, -1), group),
                        lambda x: x.clone())):
        x = torch.zeros_like(src)
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            torch.cuda._sleep(50_000_000)
            x.copy_(src)
            got = call(x)
        torch.cuda.synchronize()
        assert torch.equal(got, want(src))


def test_ring_dma_raw_stream_is_the_current_stream(cuda):
    """``ring_dma._stream`` (PyTorch's private raw-stream call) names the
    stream ``torch.cuda.current_stream()`` does, on a stream of its own and
    on the default one: a torch that changes the call fails here."""
    from harp_tpu_torch.ops import ring_dma

    dev = torch.cuda.current_device()
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        assert ring_dma._stream(dev) == s.cuda_stream
        assert ring_dma._stream(dev) == torch.cuda.current_stream().cuda_stream
    assert ring_dma._stream(dev) == torch.cuda.current_stream().cuda_stream
    assert ring_dma._stream(dev) != s.cuda_stream


def test_ring_dma_kernels_between_processes(cuda):
    """parallel/mp_smoke.py as 2 processes x 2 workers on the card: the
    kernels between processes (through CUDA IPC) and within one, the
    dense-MF and flash in-kernel sends (each process's h_next, k_next and
    v_next) and the fused SGD-MF fits among them, bitwise the stacked
    group."""
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


# --------------------------------------------------------------------------- #
# Dispatch outside each kernel's limits
# --------------------------------------------------------------------------- #

def _counts():
    from harp_tpu_torch.ops import ring_dma

    torch.cuda.synchronize()
    return {**pk.launches, **ring_dma.launches}, dict(pk.plain_on_card)


def _moved(before, after):
    """The counters that moved between two readings, with their steps."""
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _kmeans_plain_case(dev, n=4096, k=100, d=100, seed=3):
    """float16 points: the type the JAX package also sends to XLA."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, d, generator=g).half()
    c = torch.randn(k, d, generator=g)
    b_launch, b_plain = _counts()
    got = pk.kmeans_stats(x.to(dev), c.to(dev), k)
    a_launch, a_plain = _counts()
    ref = pk.kmeans_stats_plain(x, c, k)
    ties = _near_ties(x, c, k)
    assert float((got[1].cpu() - ref[1]).abs().sum()) <= 2 * ties
    if ties == 0:
        torch.testing.assert_close(got[0].cpu(), ref[0], rtol=1e-4,
                                   atol=1e-4)
    torch.testing.assert_close(got[2].cpu(), ref[2], rtol=1e-4, atol=1e-3)
    return _moved(b_launch, a_launch), _moved(b_plain, a_plain)


def _flash_plain_case(dev, l=4096, h=2, dh=64, dv=64):
    from harp_tpu_torch.parallel import ring_attention as ra

    g = torch.Generator().manual_seed(l + dh)
    q, k = (torch.randn(l, h, dh, generator=g) for _ in range(2))
    v = torch.randn(l, h, dv, generator=g)
    b_launch, b_plain = _counts()
    got = ra.blocked_attention(q.to(dev), k.to(dev), v.to(dev), True)
    a_launch, a_plain = _counts()
    ref = pk.flash_attention_plain(q, k, v, True)
    rows = sample_rows(l)
    exact = attention64(q, k, v, True, rows)[0]
    tol = max(1e-5, 4 * max_rel(ref[None][:, rows].double(), exact))
    assert max_rel(got.cpu()[None][:, rows].double(), exact) <= tol
    return _moved(b_launch, a_launch), _moved(b_plain, a_plain)


def _ring_plain_case(dev, w=4, l_local=1024):
    """A ring below the flash length: W einsum hops, each counted."""
    from harp_tpu_torch import HarpSession
    from harp_tpu_torch.parallel import ring_attention as ra

    g = torch.Generator().manual_seed(l_local)
    q, k, v = (torch.randn(w * l_local, 2, 32, generator=g)
               for _ in range(3))
    sess = HarpSession(num_workers=w, device=dev)
    b_launch, b_plain = _counts()
    got = sess.run(lambda a, b, c: ra.ring_attention_mha(
        a, b, c, True, fused_dma=False), q.to(dev), k.to(dev), v.to(dev),
        in_specs=(sess.shard(),) * 3, out_specs=sess.shard())
    a_launch, a_plain = _counts()
    rows = sample_rows(w * l_local)
    exact = attention64(q, k, v, True, rows)[0]
    ref = pk.flash_attention_plain(q, k, v, True)
    tol = max(1e-5, 4 * max_rel(ref[None][:, rows].double(), exact))
    assert max_rel(got.cpu()[None][:, rows].double(), exact) <= tol
    return _moved(b_launch, a_launch), _moved(b_plain, a_plain)


@pytest.mark.parametrize("case,name,calls", [
    (_kmeans_plain_case, "kmeans_stats", 1),
    (_flash_plain_case, "flash_attention", 1),
    (_ring_plain_case, "flash_attention", 4),
])
def test_dispatch_outside_the_kernel_takes_the_plain_version(cuda, case,
                                                             name, calls):
    """Where the JAX package takes XLA (its E-step by default, attention
    below its flash length), the dispatcher takes the plain version: no
    launch, one count a plain call."""
    launched, plain = case(cuda)
    assert launched == {} and plain == {name: calls}


def test_dispatch_past_the_narrow_width_launches_the_wide_kernel(cuda):
    """The widths the narrow kernels refused before their wide variants
    (K-means K=400 at D=100, dense-MF K=192, flash Dh=192 at L=8192) now
    raise nothing: each dispatcher launches its kernel once, makes no plain
    call and answers within the kernel's own tolerance of the plain
    version. The stated limits are pinned in the kernels' refusal tests."""
    from harp_tpu_torch.parallel import ring_attention as ra

    gk = torch.Generator().manual_seed(400)
    xk, ck = torch.randn(4096, 100, generator=gk), torch.randn(400, 100,
                                                             generator=gk)
    b_launch, b_plain = _counts()
    got = pk.kmeans_stats(xk.to(cuda), ck.to(cuda), 400)
    a_launch, a_plain = _counts()
    assert _moved(b_launch, a_launch) == {"kmeans_stats": 1,
                                          "kmeans_stats_wide": 1}
    assert _moved(b_plain, a_plain) == {}
    ref = pk.kmeans_stats_plain(xk, ck, 400)
    ties = _near_ties(xk, ck, 400)
    assert float((got[1].cpu() - ref[1]).abs().sum()) <= 2 * ties
    if ties == 0:
        torch.testing.assert_close(got[0].cpu(), ref[0], rtol=1e-4,
                                   atol=1e-4)
    torch.testing.assert_close(got[2].cpu(), ref[2], rtol=1e-4, atol=1e-3)

    v, w, h, rc, cc = mf_hop_inputs(1, 1, 512, 1024, 192, 4, seed=192)
    b = torch.zeros(1, dtype=torch.int32)
    args = (v, b, w, h, rc, cc, 4, 0.05, 0.01)
    g = torch.Generator().manual_seed(192)
    q, k, vv = (torch.randn(8192, 1, 192, generator=g).to(cuda)
                for _ in range(3))
    b_launch, b_plain = _counts()
    got = pk.dense_mf_hop(*(t.to(cuda) if torch.is_tensor(t) else t
                            for t in args))
    mid_launch, mid_plain = _counts()
    out = ra.blocked_attention(q, k, vv, True)
    a_launch, a_plain = _counts()
    assert _moved(b_launch, mid_launch) == {"dense_mf_hop": 1}
    assert _moved(mid_launch, a_launch) == {"flash_attention": 1}
    assert _moved(b_plain, a_plain) == {}
    plain = pk.dense_mf_hop_plain(*args)
    exact = pk.dense_mf_hop_plain(v, b, w.double(), h.double(), rc.double(),
                                  cc.double(), 4, 0.05, 0.01)
    for got_t, plain_t, exact_t in zip(got[:2], plain[:2], exact[:2]):
        tol = max(1e-4, 4 * max_rel(plain_t.double(), exact_t))
        assert max_rel(got_t.cpu().double(), exact_t) <= tol
    rows = sample_rows(8192).to(cuda)
    ex = attention64(q, k, vv, True, rows)[0]
    ref = pk.flash_attention_plain(q, k, vv, True)
    tol = max(1e-5, 4 * max_rel(ref[None][:, rows].double(), ex))
    assert max_rel(out[None][:, rows].double(), ex) <= tol


def test_ring_attention_fused_dma_none_is_fused_on_the_card(cuda):
    """fused_dma=None on the card takes the ring-DMA engine (2 hop launches
    a hop: k and v), bitwise the unfused ring."""
    from harp_tpu_torch import HarpSession
    from harp_tpu_torch.parallel import ring_attention as ra

    sess = HarpSession(num_workers=4, device=cuda)
    g = torch.Generator().manual_seed(9)
    q, k, v = (torch.randn(4 * 256, 2, 32, generator=g).to(cuda)
               for _ in range(3))

    def ring(fused):
        return sess.run(lambda a, b, c: ra.ring_attention_mha(
            a, b, c, True, fused_dma=fused), q, k, v,
            in_specs=(sess.shard(),) * 3, out_specs=sess.shard())

    unfused = ring(False)
    before, _ = _counts()
    out = ring(None)
    after, _ = _counts()
    assert after["ring_dma_hop"] - before["ring_dma_hop"] == 8
    assert torch.equal(out, unfused)
