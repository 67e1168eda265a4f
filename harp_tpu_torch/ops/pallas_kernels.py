"""Hand-written GPU kernels — the counterparts of the JAX package's Pallas
kernels (``harp_tpu/ops/pallas_kernels.py``; the module keeps its name so a
reader finds the counterpart).

Ported:

* the fused K-means E-step. ``kmeans_stats_cuda`` launches the CUDA kernel
  ``csrc/kmeans_stats.cu`` (scores on the tensor cores with float32
  accuracy, argmin + partial sums, never writing the (N, K) score matrix)
  at any K and D: the narrow kernel where one block's shared memory holds
  the centroids and the partial, past it the wide variant (centroids and
  features streamed in chunks, each point's assignment written, the sums
  by centroid after a counting sort);
  ``kmeans_stats_plain`` is the same function in plain PyTorch
  (``ops/distance.partial_sums_counts``);
* the dense SGD-MF hop. ``dense_mf_hop_cuda`` launches ``csrc/
  dense_mf_hop.cu`` (the masked stripe-GEMM update of every stacked
  worker's H block against its slab bucket, pred and G kept on chip; with
  ``ring_hop``, each block also sends its final H tile to the right ring
  neighbour), at K <= 128 in clusters of blocks that sum dW through
  distributed shared memory, and past it the wide path (the rank split over
  the warps, dW by a GEMM kernel after the hop) up to ``MF_MAX_K``;
  ``dense_mf_hop_plain`` is the stripe loop in plain PyTorch, followed by
  ``ring_dma.hop_plain`` with ``ring_hop``;
* the batched SPD solve of ALS. ``spd_solve_cuda`` launches ``csrc/
  spd_solve.cu``: at K <= 32 a group of 4 or 8 lanes a system, up to four
  rows a lane in registers, l_j set out in shared memory, on a persistent
  grid;
  past it a panel-blocked Cholesky with register-tiled trailing updates on
  a persistent grid, the packed lower triangle in shared memory at
  33 <= K <= 307 and in device memory above, two kernels with the same
  chains of operations and so bitwise equal. ``spd_solve_plain`` is the TPU kernel's Cholesky and
  substitutions, vectorized over the batch;
* flash attention. ``flash_attention_cuda`` launches ``csrc/
  flash_attention.cu`` (running max, denominator and accumulator on chip,
  the causal trapezoid of KV tiles, any L, any Dh and Dv: to 128 on the
  tensor cores (three TF32 passes, k and v tiles by asynchronous copies,
  ``FLASH_TILES``), past 128 on the CUDA cores (q kept in shared memory
  to Dh = 256, k staged in chunks and Dv sliced across the grid in 256
  columns, ``FLASH_WIDE_TILES``), optional stats; with
  ``ring_hop``, copy blocks beside the attention blocks send k and v to the
  right ring neighbour); ``flash_attention_plain`` is a full-row softmax in
  plain PyTorch.

The two ``ring_hop`` sends run on the ring-DMA engine's device functions
(``csrc/ring_dma.cuh``). On a process group the receive of a send from
another process is ``ring_dma.SendPlan.receive``, a kernel launched after
the sending one and counted in ``ring_dma.launches["ring_recv"]``.

A ``*_cuda`` wrapper takes CUDA tensors only and raises on a shape its
kernel cannot take. A CPU tensor always takes the plain version. On a CUDA
tensor the dispatchers the models call (``kmeans_stats``, ``dense_mf_hop``,
``spd_solve``; ``blocked_attention`` and the ring's hops in ``parallel/
ring_attention.py``) launch the kernel, with two exceptions decided before
any launch, where the JAX package itself takes XLA: ``kmeans_stats``
outside :func:`use_kmeans_pallas` (points other than float32 or bfloat16)
and attention below :func:`use_flash_pallas`'s length. Every width the JAX
package's kernels take launches a kernel here; the stated limits (E-step N
above ``KMEANS_MAX_N`` or K (D + 2) above ``KMEANS_MAX_KD``, a dense-MF
rank above ``MF_MAX_K``, an SPD rank above ``SPD_MAX_K_GLOBAL``) raise.
Nothing catches a build or launch error.

``launches`` counts kernel launches per wrapper: each wrapper adds one where
it launches its kernel and nowhere else, so a run can show that its main
path went through the kernel; a launch of the E-step's wide variant also
counts in ``kmeans_stats_wide``, and one with the ring send in
``dense_mf_hop_ring`` or ``flash_attention_ring``. ``plain_on_card`` counts
the plain calls those two exceptions made on a CUDA device.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import os
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from harp_tpu_torch.ops import distance, ring_dma
from harp_tpu_torch.parallel import mesh as mesh_lib

launches: Dict[str, int] = {"kmeans_stats": 0, "kmeans_stats_wide": 0,
                             "dense_mf_hop": 0,
                             "dense_mf_hop_ring": 0, "spd_solve": 0,
                             "spd_solve_block": 0, "spd_solve_global": 0,
                             "flash_attention": 0,
                             "flash_attention_ring": 0}
plain_on_card: Dict[str, int] = {"kmeans_stats": 0, "flash_attention": 0}

# shared memory one block may use on an H100 (227 KB)
MAX_SMEM_BYTES = 232_448
_GRID: Dict[tuple, int] = {}
_LIB: Dict[str, ctypes.CDLL] = {}


def _on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def count_plain_on_card(name: str, device) -> None:
    """Count one plain call of dispatcher ``name`` on ``device`` in
    :data:`plain_on_card` (a CPU device counts nothing)."""
    if _on_card(device):
        plain_on_card[name] += 1


# the E-step kernel's limits: N above KMEANS_MAX_N (the kernels index rows
# and tiles with 32-bit ints) and K (D + 2) above KMEANS_MAX_KD raise;
# points other than float32 or bfloat16 take the plain version. A (K, D)
# whose block needs more shared memory than MAX_SMEM_BYTES
# (kmeans_smem_bytes) takes the wide variant.
KMEANS_MAX_N = 2 ** 31 - 2 ** 19
KMEANS_DTYPES = (torch.float32, torch.bfloat16)
# KMEANS_MAX_KD is the wide variant's stated limit: its centroid planes
# (two float32 words an element) and its (K, D+1) rows stay within 32-bit
# element offsets (it is also far past what the TPU kernel holds, its
# whole (K, D) centroid and sums tables as VMEM blocks).
KMEANS_MAX_KD = 2 ** 28
_KM_TILE = 64                 # points a warpgroup tile (kTile in kmeans_stats.cu)
_KM_STEP = 8                  # features a TF32 k-step (Fmt<float>::kStep)
_KM_GROUPS = 3                # warpgroups a narrow block (kGroups)
_KMW_POINTS = 128             # the streamed assign pass's points (kAPoints)
_KMW_RESIDENT_POINTS = 192    # the resident pass's, D <= 128 (kRPoints)
_KMW_CENTROIDS = 128          # its centroid chunk (kACols)
_KMW_DEPTH = 32               # its feature stage (kADepth)
_KMW_SORT_POINTS = 4096       # a range of the counting sort (kSortPoints)
_KMW_PIECE = 256              # points a piece of the sums (kPiece)


def _kmeans_chunk_cols(valid_k: int, d: int) -> int:
    """The narrow kernel's centroids a chunk (``chunk_cols``): the smallest
    of 32, 64, 112 that covers ``valid_k``, above 112 chunks of 128; past
    D = 128 (a thread also carries 128-feature partial sums) 32 or 64."""
    if d > 128:
        return 32 if valid_k <= 32 else 64
    return (32 if valid_k <= 32 else 64 if valid_k <= 64
            else 112 if valid_k <= 112 else 128)


def kmeans_smem_bytes(d: int, k: int) -> int:
    """Bytes of shared memory one narrow E-step block needs at (D, K) for
    float32 points: the twin of ``Narrow<float>::bytes`` in
    ``csrc/kmeans_stats.cu``: the centroids' TF32 hi and lo planes over
    the chunks' rows and D rounded up to 8, their norms, the partial (K
    rows of D rounded up to 4 plus 4 columns: the count, the distance and
    2 of padding), and for each of the three
    warpgroups its 64-point tile (rows of D rounded up to 8, plus 4
    words), its 64 assignments and distances, its 64 ranked (row, point)
    pairs and 8 part bounds. bf16 points need less; the variant is chosen
    by this figure for both types."""
    cols = _kmeans_chunk_cols(k, d)
    rows = -(-k // cols) * cols
    dp = -(-d // _KM_STEP) * _KM_STEP
    rs = -(-d // 4) * 4 + 4
    part = 8 * rows * dp + 4 * rows + 4 * k * rs
    part = -(-part // 16) * 16
    return part + _KM_GROUPS * 4 * (_KM_TILE * (dp + 4) + 4 * _KM_TILE + 8)


def kmeans_wide_plan(n: int, d: int, k: int, workers: int = 1,
                     per_worker_c: bool = False) -> Dict[str, object]:
    """The wide E-step's plan at (N, D, K) for ``workers`` stacked workers:
    the twin of ``kmeans_stats_wide_grid`` and ``kmeans_stats_wide_launch``
    in ``csrc/kmeans_stats.cu``.

    ``grid`` is the counting sort's blocks a worker, a 4096-point range
    each (at least 1); it never depends on ``workers``. ``point_tile`` is
    the assign pass's points a block: 192 where the block's points stay in
    shared memory (D <= 128), else 128. ``shapes`` are the
    workspaces the wrapper allocates, each in 4-byte elements: the centroid
    norms and planes (rows padded to the 128-row chunks, features to the
    32-feature stages, two words an element), each point's assignment and
    distance, the sort's keys and indices (two of each), its histograms
    (256 digits a range), each centroid's first position and first piece,
    the pieces' sums (one a 256-point piece of a centroid, at most N / 256
    + K) and each row's distance; ``workspace_bytes`` their total."""
    tables = workers if per_worker_c else 1
    kp = -(-k // _KMW_CENTROIDS) * _KMW_CENTROIDS
    dpw = -(-d // _KMW_DEPTH) * _KMW_DEPTH
    ranges = -(-n // _KMW_SORT_POINTS)
    pieces = -(-n // _KMW_PIECE) + k
    shapes = {"norms": (tables, kp), "planes": (tables, 2 * kp * dpw),
              "asg": (workers, n), "dist": (workers, n),
              "sort": (4, workers, n), "hist": (workers, ranges, 256),
              "starts": (workers, k + 1), "pstart": (workers, k + 1),
              "pieces": (workers, pieces, d + 1), "rowcost": (workers, k)}
    return {"point_tile": _KMW_RESIDENT_POINTS if d <= 128 else _KMW_POINTS,
            "centroid_chunk": _KMW_CENTROIDS,
            "depth_chunk": _KMW_DEPTH, "sort_range": _KMW_SORT_POINTS,
            "piece": _KMW_PIECE, "grid": max(1, ranges), "shapes": shapes,
            "workspace_bytes": 4 * sum(math.prod(s) for s in shapes.values())}


def use_kmeans_pallas(n: int, d: int, k: int, dtype, device) -> bool:
    """Whether ``kmeans_stats`` takes the E-step kernel for (N, D) points
    of ``dtype`` against K centroid rows on ``device``: a CUDA device and
    ``dtype`` in ``KMEANS_DTYPES``, the JAX package's own rule for its
    kernel (its ``kmeans_stats`` sends other types to XLA). The shape
    decides nothing: past one block's shared memory the wide variant runs,
    and past ``KMEANS_MAX_N`` or ``KMEANS_MAX_KD`` the kernel raises."""
    return _on_card(device) and dtype in KMEANS_DTYPES


def kmeans_stats_plain(x: torch.Tensor, c: torch.Tensor,
                       valid_k: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The E-step in plain PyTorch: ``torch.matmul`` scores (full float32,
    TF32 off), argmin, ``index_add_`` sums. Same contract as
    :func:`kmeans_stats_cuda`; bf16 points take the cross term with the
    centroids rounded to bf16, as the kernel does."""
    cdtype = None if x.dtype == torch.float32 else x.dtype
    return distance.partial_sums_counts(x, c, compute_dtype=cdtype,
                                        valid_k=valid_k)


def _kmeans_lib() -> ctypes.CDLL:
    lib = _LIB.get("kmeans_stats")
    if lib is None:
        from harp_tpu_torch.ops import _cuda_build

        lib = _cuda_build.library("kmeans_stats")
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.kmeans_stats_smem_bytes.argtypes = [i, i]
        lib.kmeans_stats_smem_bytes.restype = ctypes.c_longlong
        lib.kmeans_stats_grid.argtypes = [i] * 5
        lib.kmeans_stats_grid.restype = i
        lib.kmeans_stats_launch.argtypes = [vp] * 7 + [i] * 8 + [vp]
        lib.kmeans_stats_launch.restype = i
        lib.kmeans_stats_wide_grid.argtypes = [i] * 3
        lib.kmeans_stats_wide_grid.restype = i
        lib.kmeans_stats_wide_launch.argtypes = [vp] * 15 + [i] * 7 + [vp]
        lib.kmeans_stats_wide_launch.restype = i
        _LIB["kmeans_stats"] = lib
    return lib


def kmeans_stats_cuda(x: torch.Tensor, c: torch.Tensor,
                      valid_k: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused E-step on the card: (sums (K, D), counts (K,), cost ()).

    ``x``: (N, D) or stacked (W, N, D), float32 or bfloat16, contiguous.
    ``c``: (K, D) shared or (W, K, D) per worker, float32, contiguous.
    Outputs carry the worker axis when ``x`` does. Centroid rows >= valid_k
    are masked out of the argmin. cost = Σ min score + Σ‖x‖². Raises past
    N = ``KMEANS_MAX_N`` and K (D + 2) = ``KMEANS_MAX_KD``.

    Where one block's shared memory holds the (K, D) table and its partial
    (``kmeans_smem_bytes(d, k) <= MAX_SMEM_BYTES``) the narrow kernel runs;
    past it the wide variant (``kmeans_wide_plan``), counted also in
    ``launches["kmeans_stats_wide"]``. Either way each worker's point tiles
    are summed by the same number of blocks whatever W is (a function of
    N, D, K, valid_k, the type and the card), so a stacked launch is
    bitwise the launches of its workers one by one."""
    if not (x.is_cuda and c.is_cuda) or x.device != c.device:
        raise ValueError(f"kmeans_stats_cuda needs both tensors on one CUDA "
                         f"device, got {x.device} and {c.device}")
    if x.dtype not in KMEANS_DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if c.dtype != torch.float32:
        raise TypeError(f"c must be float32, got {c.dtype}")
    if x.dim() not in (2, 3) or c.dim() not in (2, 3):
        raise ValueError(f"x (N, D)/(W, N, D) and c (K, D)/(W, K, D), got "
                         f"{tuple(x.shape)} and {tuple(c.shape)}")
    if not (x.is_contiguous() and c.is_contiguous()):
        raise ValueError("x and c must be contiguous")
    x3 = x if x.dim() == 3 else x.unsqueeze(0)
    w, n, d = x3.shape
    k = c.shape[-2]
    per_worker = c.dim() == 3
    if c.shape[-1] != d or (per_worker and c.shape[0] != w):
        raise ValueError(f"shapes do not match: x {tuple(x.shape)}, "
                         f"c {tuple(c.shape)}")
    if per_worker and x.dim() == 2:
        raise ValueError("a per-worker c (W, K, D) needs a stacked x")
    vk = k if valid_k is None else min(valid_k, k)
    if k < 1 or vk < 1 or d < 1:
        raise ValueError(f"need K >= 1, valid_k >= 1, D >= 1 (K={k}, "
                         f"valid_k={vk}, D={d})")
    if n > KMEANS_MAX_N:
        raise ValueError(f"kmeans_stats_cuda takes N <= {KMEANS_MAX_N}, got "
                         f"N={n}")
    if k * (d + 2) > KMEANS_MAX_KD:
        raise ValueError(f"kmeans_stats_cuda takes K (D + 2) <= "
                         f"{KMEANS_MAX_KD}, got K={k}, D={d}")
    lib = _kmeans_lib()
    bf16 = int(x.dtype == torch.bfloat16)
    if kmeans_smem_bytes(d, k) > MAX_SMEM_BYTES:
        return _kmeans_stats_wide(lib, x, x3, c, vk, bf16)
    with torch.cuda.device(x.device):
        key = (x.device.index, n, d, k, vk, bf16)
        g = _GRID.get(key)
        if g is None:
            g = lib.kmeans_stats_grid(n, d, k, vk, bf16)
            if g < 1:
                raise RuntimeError(f"kmeans_stats grid query failed: CUDA "
                                   f"error {-g}")
            _GRID[key] = g
        ws = torch.empty((w, g, k, d + 2), dtype=torch.float32, device=x.device)
        rowcost = torch.empty((w, k), dtype=torch.float32, device=x.device)
        sums = torch.empty((w, k, d), dtype=torch.float32, device=x.device)
        counts = torch.empty((w, k), dtype=torch.float32, device=x.device)
        cost = torch.empty((w,), dtype=torch.float32, device=x.device)
        err = lib.kmeans_stats_launch(
            x3.data_ptr(), c.data_ptr(), ws.data_ptr(), rowcost.data_ptr(),
            sums.data_ptr(), counts.data_ptr(), cost.data_ptr(), w, n, d, k,
            vk,
            int(per_worker), g, bf16,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"kmeans_stats kernel launch failed: CUDA error "
                           f"{err}")
    launches["kmeans_stats"] += 1
    if x.dim() == 2:
        return sums[0], counts[0], cost[0]
    return sums, counts, cost


def _kmeans_stats_wide(lib, x, x3, c, vk, bf16):
    """The wide variant on operands :func:`kmeans_stats_cuda` checked."""
    w, n, d = x3.shape
    k = c.shape[-2]
    per_worker = c.dim() == 3
    dev = x.device
    with torch.cuda.device(dev):
        g = lib.kmeans_stats_wide_grid(n, d, k)
        plan = kmeans_wide_plan(n, d, k, w, per_worker)
        if plan["grid"] != g:
            raise RuntimeError(f"kmeans_wide_plan's grid {plan['grid']} is "
                               f"not the kernel's {g}")
        shapes = plan["shapes"]
        ws = {name: torch.empty(shape, device=dev, dtype=torch.int32 if name
                                in ("asg", "sort", "hist", "starts",
                                    "pstart") else torch.float32)
              for name, shape in shapes.items()}
        sums = torch.empty((w, k, d), dtype=torch.float32, device=dev)
        counts = torch.empty((w, k), dtype=torch.float32, device=dev)
        cost = torch.empty((w,), dtype=torch.float32, device=dev)
        err = lib.kmeans_stats_wide_launch(
            x3.data_ptr(), c.data_ptr(),
            *(ws[name].data_ptr() for name in shapes), sums.data_ptr(),
            counts.data_ptr(), cost.data_ptr(), w, n, d, k, vk,
            int(per_worker), bf16,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"kmeans_stats wide kernel launch failed: CUDA "
                           f"error {err}")
    launches["kmeans_stats"] += 1
    launches["kmeans_stats_wide"] += 1
    if x.dim() == 2:
        return sums[0], counts[0], cost[0]
    return sums, counts, cost


def kmeans_stats(x: torch.Tensor, c: torch.Tensor,
                 valid_k: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The K-means E-step the model calls: the CUDA kernel where
    :func:`use_kmeans_pallas` says so (any K and D: the narrow kernel or
    its wide variant; past the stated limits it raises), else the plain
    version (counted in ``plain_on_card`` on a CUDA device: points other
    than float32 or bfloat16, which the JAX package also sends to XLA)."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"kmeans_stats runs on cuda or cpu, not {x.device}")
    n, d = x.shape[-2:]
    if use_kmeans_pallas(n, d, c.shape[-2], x.dtype, x.device):
        return kmeans_stats_cuda(x, c, valid_k)
    count_plain_on_card("kmeans_stats", x.device)
    return kmeans_stats_plain(x, c, valid_k)


# --------------------------------------------------------------------------- #
# Dense SGD-MF hop
# --------------------------------------------------------------------------- #

# ranks the kernel is built for; K is zero-padded up to the next one, so
# the kernel takes 1 <= K <= MF_MAX_K: MF_RANKS by the kernel that holds
# each warp's dH piece in registers, MF_WIDE_RANKS by the wide path, whose
# block holds a 64-column x 256-rank tile of H and dH^T in registers and
# splits wider ranks over a cluster of KP / 256 blocks: 4 is the largest
# cluster the card keeps resident at its shared memory (the JAX kernel's own
# VMEM budget ends near K = 1000 at cpb = 8192)
MF_RANKS = (16, 32, 64, 128)
MF_WIDE_RANKS = (256, 512, 1024)
MF_MAX_K = MF_WIDE_RANKS[-1]


def mf_padded_rank(k: int) -> int:
    """The rank KP the kernel runs rank K at (K zero-padded up to it: exact),
    0 outside 1 <= K <= ``MF_MAX_K``. KP > 128 takes the wide path."""
    return next((r for r in MF_RANKS + MF_WIDE_RANKS if 1 <= k <= r), 0)


# the narrow kernel's column tile and cluster size per padded rank: twins of
# Geom<KT>::CT and Geom<KT>::C in csrc/dense_mf_hop.cu (the card tests hold
# them to dense_mf_hop_col_tile and dense_mf_hop_cluster)
MF_NARROW_TILES = {16: (256, 2), 32: (256, 2), 64: (128, 2), 128: (128, 2)}
MF_CHUNK_ROWS = 64            # Geom<KT>::R, rows a chunk


def dense_mf_narrow_shapes(nw: int, rpw: int, cpb: int, kp: int,
                           nmb: int) -> Tuple[tuple, tuple]:
    """Shapes of the narrow kernel's device buffers for one hop at padded
    rank ``kp`` <= 128, in the order ``dense_mf_hop_launch`` takes them:
    Wb (W, nmb, ceil(rpw / nmb / 64) 64, KP) bf16 (each stripe's rows in
    chunks of 64 as the kernel's shared memory holds them, one copy a
    chunk, zero past the stripe) and the dW workspace (W, ceil(n_ct / C),
    rpw, KP) float32, one partial a cluster of C column tiles (n_ct =
    ceil(cpb / CT)); the grid pads the column tiles to a multiple of C."""
    col_tile, cluster = MF_NARROW_TILES[kp]
    n_cl = -(-cpb // (col_tile * cluster))
    return ((nw, nmb, -(-(rpw // nmb) // MF_CHUNK_ROWS) * MF_CHUNK_ROWS, kp),
            (nw, n_cl, rpw, kp))


# the wide path's geometry: twins of WideGeom<KP>::CT, R and KR in
# csrc/dense_mf_hop.cu (the card tests hold them to dense_mf_hop_col_tile,
# dense_mf_hop_cluster and dense_mf_hop_wide_geometry)
MF_WIDE_COLS = 64             # columns a block
MF_WIDE_RANKS_A_BLOCK = 256   # ranks a block; a cluster of KP / 256 blocks


def dense_mf_wide_shapes(nw: int, rpw: int, cpb: int, kp: int,
                         nmb: int) -> Tuple[tuple, ...]:
    """Shapes of the wide path's device buffers for one hop at padded rank
    ``kp`` > 128, in the order ``dense_mf_hop_wide_launch``
    (``csrc/dense_mf_hop.cu``) takes them: bf16 blobs of core matrices, C =
    kp / 256 rank slices, nch = ceil(rpw / nmb / 64) chunks of 64 rows a
    stripe, n_ct = ceil(cpb / 64) column tiles: Wb (W, nmb, nch, C, 64 x
    256), the G buffer (W, nmb, nch, 2 n_ct, 64 x 32) and the stripe
    snapshots of Hb (W, nmb, n_ct, C, 64 x 256); then the SSE partials (W,
    n_ct C), float32, one a block."""
    nsl = kp // MF_WIDE_RANKS_A_BLOCK
    nch = -(-(rpw // nmb) // MF_CHUNK_ROWS)
    n_ct = -(-cpb // MF_WIDE_COLS)
    blob = MF_CHUNK_ROWS * MF_WIDE_RANKS_A_BLOCK
    return ((nw, nmb, nch, nsl, blob), (nw, nmb, nch, 2 * n_ct,
                                        MF_CHUNK_ROWS * MF_WIDE_COLS // 2),
            (nw, nmb, n_ct, nsl, blob), (nw, n_ct * nsl))


def _mf_shapes(slab, buckets, w, h, row_cnt, col_cnt, nmb):
    """(W, n_blocks, rpw, cpb, K, nmb_fine) of one hop's operands, checked."""
    if slab.dim() != 4:
        raise ValueError(f"slab must be (W, n_blocks, rpw, cpb), got "
                         f"{tuple(slab.shape)}")
    nw, n_blocks, rpw, cpb = slab.shape
    k = w.shape[-1]
    if (tuple(w.shape) != (nw, rpw, k) or tuple(h.shape) != (nw, cpb, k)
            or tuple(buckets.shape) != (nw,)
            or tuple(row_cnt.shape) != (nw, n_blocks, rpw)
            or col_cnt.dim() != 4
            or tuple(col_cnt.shape[:2]) != (nw, n_blocks)
            or col_cnt.shape[3] != cpb):
        raise ValueError(
            f"dense_mf_hop: inconsistent shapes: slab {tuple(slab.shape)}, "
            f"buckets {tuple(buckets.shape)}, w {tuple(w.shape)}, h "
            f"{tuple(h.shape)}, row_cnt {tuple(row_cnt.shape)}, col_cnt "
            f"{tuple(col_cnt.shape)}")
    nmb_fine = col_cnt.shape[2]
    if nmb < 1 or rpw % nmb or nmb_fine % nmb:
        raise ValueError(f"nmb={nmb} must divide rpw={rpw} and the fine "
                         f"stripe count {nmb_fine}")
    return nw, n_blocks, rpw, cpb, k, nmb_fine


def dense_mf_hop_plain(slab: torch.Tensor, buckets: torch.Tensor,
                       w: torch.Tensor, h: torch.Tensor,
                       row_cnt: torch.Tensor, col_cnt: torch.Tensor, nmb: int,
                       lr: float, lam: float, ring_hop: bool = False
                       ) -> Tuple[torch.Tensor, ...]:
    """One dense SGD-MF hop in plain PyTorch: the stripe loop of the JAX
    package's ``SGDMF._build_dense``, per worker; with ``ring_hop``, then
    ``ring_dma.hop_plain(h', 1)`` on the bound worker group (a stacked
    group, or gloo between processes). Same contract as
    :func:`dense_mf_hop_cuda`; the products are ``torch.matmul`` of the
    bf16-rounded operands in the factors' type (bf16 products are exact in
    float32, so only the order of the sums differs from the kernel; with
    float64 factors the sums are exact to float32 precision, a reference
    for how far rounding alone moves a hop). Reads the bucket indices on the
    host (a device sync for a CUDA tensor)."""
    nw, _, rpw, cpb, _, nmb_fine = _mf_shapes(slab, buckets, w, h, row_cnt,
                                              col_cnt, nmb)
    s = rpw // nmb
    w_out = torch.empty_like(w)
    h_out = torch.empty_like(h)
    sse = w.new_zeros(nw)
    zero = w.new_zeros(())
    for wi, b in enumerate(buckets.tolist()):
        vb, rc = slab[wi, b], row_cnt[wi, b]
        cc = col_cnt[wi, b].reshape(nmb, nmb_fine // nmb, cpb).sum(dim=1)
        hb, total = h[wi], zero
        for i in range(nmb):
            rows = slice(i * s, (i + 1) * s)
            w_s = w[wi, rows]
            wb = w_s.to(torch.bfloat16).to(w.dtype)
            hbb = hb.to(torch.bfloat16).to(w.dtype)
            v = vb[rows].to(w.dtype)
            g = torch.where(torch.isnan(v), zero, v - wb @ hbb.t()
                            ).to(torch.bfloat16).to(w.dtype)
            dw = g @ hbb
            dh = g.t() @ wb
            w_out[wi, rows] = w_s + lr * (dw - lam * rc[rows, None] * w_s)
            hb = hb + lr * (dh - lam * cc[i][:, None] * hb)
            total = total + (g * g).sum()
        h_out[wi] = hb
        sse[wi] = total
    if ring_hop:
        return w_out, h_out, sse, ring_dma.hop_plain(h_out, 1)
    return w_out, h_out, sse


def _mf_lib() -> ctypes.CDLL:
    lib = _LIB.get("dense_mf_hop")
    if lib is None:
        from harp_tpu_torch.ops import _cuda_build

        lib = _cuda_build.library("dense_mf_hop")
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.dense_mf_hop_col_tile.argtypes = [i]
        lib.dense_mf_hop_col_tile.restype = i
        lib.dense_mf_hop_smem_bytes.argtypes = [i]
        lib.dense_mf_hop_smem_bytes.restype = ctypes.c_longlong
        lib.dense_mf_hop_cluster.argtypes = [i]
        lib.dense_mf_hop_cluster.restype = i
        lib.dense_mf_hop_geometry.argtypes = [i, ctypes.POINTER(i)]
        lib.dense_mf_hop_geometry.restype = i
        lib.dense_mf_hop_wide_geometry.argtypes = [i, ctypes.POINTER(i)]
        lib.dense_mf_hop_wide_geometry.restype = i
        lib.dense_mf_hop_launch.argtypes = ([vp] * 12 + [i] * 7
                                            + [f, f, vp, vp, vp, i, i, i,
                                               ctypes.c_ulonglong, vp])
        lib.dense_mf_hop_launch.restype = i
        lib.dense_mf_hop_wide_launch.argtypes = ([vp] * 13 + [i] * 7
                                                 + [f, f, vp, vp, vp, i, i,
                                                    i, ctypes.c_ulonglong,
                                                    vp])
        lib.dense_mf_hop_wide_launch.restype = i
        _LIB["dense_mf_hop"] = lib
    return lib


def dense_mf_hop_cuda(slab: torch.Tensor, buckets: torch.Tensor,
                      w: torch.Tensor, h: torch.Tensor,
                      row_cnt: torch.Tensor, col_cnt: torch.Tensor, nmb: int,
                      lr: float, lam: float, ring_hop: bool = False,
                      group: Optional[mesh_lib.WorkerGroup] = None
                      ) -> Tuple[torch.Tensor, ...]:
    """One dense SGD-MF hop of every stacked worker on the card:
    (w' (W, rpw, K), h' (W, cpb, K), sse (W,)), and with ``ring_hop`` h_next
    (W, cpb, K), the block of worker (id - 1) mod W of ``group`` (by default
    the bound one), bitwise ``ring_dma.hop_plain(h', 1)``: the same launch
    sends each final H tile to the right neighbour (``csrc/dense_mf_hop.cu``;
    across processes where the receiver's credit is in, and the receive
    kernel after it sends the rest and receives).

    ``slab``: (W, n_blocks, rpw, cpb) bf16, NaN = missing; ``buckets``: (W,)
    int32, the block each worker updates (no bucket is copied);
    ``w``: (W, rpw, K) and ``h``: (W, cpb, K) float32; ``row_cnt``: (W,
    n_blocks, rpw) and ``col_cnt``: (W, n_blocks, nmb_fine, cpb) float32
    regularizer counts, ``col_cnt`` summed over ``nmb_fine // nmb`` adjacent
    fine stripes per stripe. All on one CUDA device and contiguous. 1 <= K
    <= ``MF_MAX_K``, zero-padded here to :func:`mf_padded_rank` (exact): up
    to 128 a Wb launch, the hop kernel in clusters along the column tiles
    and the W reduction, past it the wide path (a Wb launch, the hop, the
    dW GEMM with the W update, ranks past 256 over a cluster of KP / 256
    blocks); a larger K raises. With ``ring_hop`` W is the group's workers
    a process."""
    args = (slab, buckets, w, h, row_cnt, col_cnt)
    if not all(t.is_cuda and t.device == slab.device for t in args):
        raise ValueError("dense_mf_hop_cuda needs every tensor on one CUDA "
                         "device, got " + ", ".join(str(t.device)
                                                    for t in args))
    if slab.dtype != torch.bfloat16 or buckets.dtype != torch.int32:
        raise TypeError(f"slab must be bfloat16 and buckets int32, got "
                        f"{slab.dtype} and {buckets.dtype}")
    if any(t.dtype != torch.float32 for t in (w, h, row_cnt, col_cnt)):
        raise TypeError("w, h, row_cnt and col_cnt must be float32")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("every dense_mf_hop_cuda operand must be contiguous")
    nw, n_blocks, rpw, cpb, k, nmb_fine = _mf_shapes(*args, nmb)
    kp = mf_padded_rank(k)
    if not kp:
        raise ValueError(f"dense_mf_hop_cuda takes 1 <= K <= {MF_MAX_K}, "
                         f"got K={k}")
    if slab.data_ptr() % 16:
        raise ValueError("the slab must start on a 16-byte boundary")
    if ring_hop:
        group = group or mesh_lib.current_group()
        if nw != group.workers_per_process:
            raise ValueError(f"ring_hop: the slab holds {nw} workers, the "
                             f"group {group.workers_per_process} a process")
    lib = _mf_lib()
    col_tile = lib.dense_mf_hop_col_tile(kp)
    n_ct = -(-cpb // col_tile)
    w_in = w if kp == k else F.pad(w, (0, kp - k))
    h_in = h if kp == k else F.pad(h, (0, kp - k))
    if w_in.data_ptr() % 16:
        w_in = w_in.clone()
    dev = slab.device
    with torch.cuda.device(dev):
        w_out = torch.empty((nw, rpw, kp), dtype=torch.float32, device=dev)
        h_out = torch.empty((nw, cpb, kp), dtype=torch.float32, device=dev)
        if kp in MF_WIDE_RANKS:
            *shapes, part_shape = dense_mf_wide_shapes(nw, rpw, cpb, kp, nmb)
            ws = tuple(torch.empty(shape, dtype=torch.bfloat16, device=dev)
                       for shape in shapes)
            launch = lib.dense_mf_hop_wide_launch
        else:
            wb_shape, ws_shape = dense_mf_narrow_shapes(nw, rpw, cpb, kp,
                                                        nmb)
            ws = (torch.empty(wb_shape, dtype=torch.bfloat16, device=dev),
                  torch.empty(ws_shape, dtype=torch.float32, device=dev))
            launch = lib.dense_mf_hop_launch
            part_shape = (nw, n_ct)
        sse_part = torch.empty(part_shape, dtype=torch.float32, device=dev)
        sse = torch.empty((nw,), dtype=torch.float32, device=dev)
        h_next = sent = None
        ring = (None, None, 0, 0, 1, 0, None)           # no send
        if ring_hop:
            h_next = torch.empty_like(h_out)
            send = ring_dma.SendPlan(group, dev, "dense_mf_ring",
                                     h_out[0].numel() * 4, n_ct)
            if send.plan is not None:
                sent = torch.empty((nw, n_ct), dtype=torch.int32, device=dev)
            ring = (h_next.data_ptr(), *send.args[:5],
                    None if sent is None else sent.data_ptr())
        err = launch(
            slab.data_ptr(), buckets.data_ptr(), w_in.data_ptr(),
            h_in.data_ptr(), row_cnt.data_ptr(), col_cnt.data_ptr(),
            w_out.data_ptr(), h_out.data_ptr(), *(t.data_ptr() for t in ws),
            sse_part.data_ptr(), sse.data_ptr(), nw, n_blocks, rpw, cpb, kp,
            nmb, nmb_fine, float(lr), float(lam),
            torch.cuda.current_stream(dev).cuda_stream, *ring)
        if err == 0 and ring_hop:
            send.receive(h_next, left=h_out, sent=sent,
                         tile_bytes=col_tile * kp * 4)
    if err != 0:
        raise RuntimeError(f"dense_mf_hop kernel launch failed: CUDA error "
                           f"{err}")
    launches["dense_mf_hop"] += 1
    if kp != k:
        w_out = w_out[..., :k].contiguous()
        h_out = h_out[..., :k].contiguous()
    if not ring_hop:
        return w_out, h_out, sse
    launches["dense_mf_hop_ring"] += 1
    return w_out, h_out, sse, (h_next if kp == k
                               else h_next[..., :k].contiguous())


def dense_mf_hop(slab: torch.Tensor, buckets: torch.Tensor, w: torch.Tensor,
                 h: torch.Tensor, row_cnt: torch.Tensor, col_cnt: torch.Tensor,
                 nmb: int, lr: float, lam: float, ring_hop: bool = False
                 ) -> Tuple[torch.Tensor, ...]:
    """The dense SGD-MF hop the model calls: the CUDA kernel for a CUDA
    slab (K above ``MF_MAX_K`` raises, the kernel's stated limit), the
    plain version for a CPU slab. ``ring_hop`` (the JAX package's in-kernel
    send) also returns h_next, the left neighbour's updated block on the
    bound worker group, exactly ``lax_ops.rotate(h', 1)``: on the card
    sent by the same launch, never by ``ring_dma.hop``."""
    if slab.device.type == "cuda":
        return dense_mf_hop_cuda(slab, buckets, w, h, row_cnt, col_cnt, nmb,
                                 lr, lam, ring_hop=ring_hop)
    if slab.device.type == "cpu":
        return dense_mf_hop_plain(slab, buckets, w, h, row_cnt, col_cnt, nmb,
                                  lr, lam, ring_hop)
    raise ValueError(f"dense_mf_hop runs on cuda or cpu, not {slab.device}")


# --------------------------------------------------------------------------- #
# Batched small SPD solve (the ALS normal equations)
# --------------------------------------------------------------------------- #

# the largest K of the one-warp kernel (four rows of the system a lane)
SPD_MAX_K_WARP = 32
# the JAX package's rule for solver="auto" (its kernel's K), and nothing more
SPD_MAX_K = 64
# the columns of a panel of the panel-blocked kernels (kPanel)
SPD_PANEL = 32
# the largest K of the shared-memory kernel: its packed lower triangle, b and
# the staging area must fit one block's shared memory
# (spd_solve_block_smem_bytes)
SPD_MAX_K_SMEM = 307
# the largest K of the global-memory kernel, kept from the step-by-step
# kernel it replaced (whose two K-vectors filled one block's shared memory);
# the panel-blocked kernel keeps b (K floats) and a staging area of 4,416
# floats there, which would fit past K = 52,000
SPD_MAX_K_GLOBAL = 29_056


def _round4(v: int) -> int:
    return -(-v // 4) * 4


def spd_solve_block_smem_bytes(k: int) -> int:
    """Bytes of shared memory a block of the shared-memory solve needs at
    K: the twin of ``block_smem_floats`` in ``csrc/spd_solve.cu``. It holds
    one system's packed lower triangle, K (K + 1) / 2 floats, and its b,
    each rounded up to 4 floats, and a staging area: a panel's diagonal
    block of L transposed (32 x 32), the panel's L below it (32 x its K -
    32 rows, rounded up to whole 32-row blocks), and the panel's dinv and y
    (2 x 32)."""
    nb = SPD_PANEL
    rows = -(-(k - nb) // 32) * 32
    return 4 * (_round4(k * (k + 1) // 2) + _round4(k) + nb * nb + nb * rows
                + 2 * nb)


# the shared-memory solve's instances: (threads a block, registers a thread
# at most, so 8, 4 and 2 blocks an SM where shared memory allows)
SPD_BLOCK_SHAPES = ((128, 64), (128, 128), (256, 128))


def spd_solve_block_geometry(k: int) -> Tuple[int, int]:
    """(threads, registers) of the shared-memory solve at rank K, chosen
    by the ``[spd:sweep]`` timings of ``chip_smoke.py`` on an H100: the
    64-register instance to K = 96 (8 blocks an SM, or as many as shared
    memory holds), 128 registers to K = 128, 256 threads above (1 or 2
    blocks an SM)."""
    if k <= 96:
        return 128, 64
    return (128, 128) if k <= 128 else (256, 128)


def spd_solve_warp_group(k: int) -> int:
    """Lanes that solve one system of rank K <= 32 in the one-warp kernel
    (``warp_group`` in ``csrc/spd_solve.cu``): 8 from K = 9, 4 below, so a
    warp holds 4 or 8 systems; a lane holds K / G rows of its system,
    rounded up (1 to 4)."""
    return 8 if k > 8 else 4


def spd_solve_warp_block_warps(k: int) -> int:
    """Warps a block of the one-warp kernel at rank K (``warp_block_warps``
    in ``csrc/spd_solve.cu``): 2 past K = 24, where a thread takes up to
    232 registers, 4 below."""
    return 2 if k > 24 else 4


def spd_solve_warp_smem_bytes(k: int) -> int:
    """Bytes of shared memory a block of the one-warp kernel holds at rank
    K <= 32: the twin of ``warp_block_floats`` in ``csrc/spd_solve.cu``.
    Each of its warps has a slot for each of its 32 / G systems: K rows
    at a pitch of K rounded up to an odd number of float4s, rounded up to G
    floats past a multiple of 32 (so the slots of a warp lie G banks
    apart)."""
    g = spd_solve_warp_group(k)
    pitch = ((-(-k // 4)) | 1) * 4
    slot = (k * pitch - g + 31) // 32 * 32 + g
    return 4 * spd_solve_warp_block_warps(k) * (32 // g) * slot


def spd_solve_warp_grid(n: int, k: int, per_sm: int, sms: int) -> int:
    """Blocks of the one-warp kernel's persistent grid for N systems of
    rank K: the resident blocks (``per_sm`` an SM on ``sms`` SMs), at most
    the blocks whose warps the systems fill (32 / G systems a warp)."""
    warps = -(-n // (32 // spd_solve_warp_group(k)))
    blocks = -(-warps // spd_solve_warp_block_warps(k))
    return max(1, min(per_sm * sms, blocks))


def spd_solve_variant(k: int) -> str:
    """The variant that takes rank K, by the name of its launch counter:
    the one-warp kernel to ``SPD_MAX_K_WARP``, the shared-memory kernel to
    ``SPD_MAX_K_SMEM``, the global-memory kernel to ``SPD_MAX_K_GLOBAL``."""
    if not 1 <= k <= SPD_MAX_K_GLOBAL:
        raise ValueError(f"spd_solve_cuda takes 1 <= K <= "
                         f"{SPD_MAX_K_GLOBAL}, got K={k}")
    if k <= SPD_MAX_K_WARP:
        return "spd_solve"
    return "spd_solve_block" if k <= SPD_MAX_K_SMEM else "spd_solve_global"


def spd_solve_global_workspace_bytes(grid: int, k: int) -> int:
    """Bytes of the global-memory solve's workspace: one packed lower
    triangle, K (K + 1) / 2 floats, for each of the ``grid`` blocks of its
    persistent grid (``spd_solve_global_grid`` in ``csrc/spd_solve.cu``).
    The grid never exceeds N, so this is at most half of A's bytes."""
    return 4 * grid * (k * (k + 1) // 2)


def _spd_shapes(a: torch.Tensor, b: torch.Tensor) -> Tuple[int, int]:
    if b.dim() != 2 or tuple(a.shape) != (b.shape[0], b.shape[1], b.shape[1]):
        raise ValueError(f"spd_solve: a must be (N, K, K) and b (N, K), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    return b.shape[0], b.shape[1]


def spd_solve_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched SPD solve ``a @ x = b`` in plain PyTorch: a (N, K, K), b (N,
    K) -> x (N, K), in the inputs' type.

    The JAX package's ``_chol_solve_kernel`` step for step, vectorized over
    the batch: at step j the running Schur complement's column j, scaled by
    the rsqrt of its pivot and masked to rows >= j, is column j of L, and
    the rank-1 update follows; then forward substitution L y = b and back
    substitution Lᵀ x = y in the kernel's order. Reads only the lower
    triangle of ``a``; any K, no padding."""
    _, k = _spd_shapes(a, b)
    rows = torch.arange(k, device=a.device)
    cols = []
    for j in range(k):
        col = a[:, :, j]
        dinv = torch.rsqrt(col[:, j:j + 1])
        lj = torch.where(rows >= j, col * dinv, 0.0)
        cols.append(lj)
        if j + 1 < k:
            a = a - lj[:, :, None] * lj[:, None, :]
    r, ys = b, []
    for j in range(k):
        yj = r[:, j:j + 1] / cols[j][:, j:j + 1]
        ys.append(yj)
        if j + 1 < k:
            r = r - cols[j] * yj
    lfull = torch.stack(cols, dim=2)        # (N, row, col)
    r = torch.cat(ys, dim=1)
    xs = [None] * k
    for p in range(k - 1, -1, -1):
        xp = r[:, p:p + 1] / cols[p][:, p:p + 1]
        xs[p] = xp
        if p:
            r = r - lfull[:, p, :] * xp
    return torch.cat(xs, dim=1)


def _spd_lib() -> ctypes.CDLL:
    lib = _LIB.get("spd_solve")
    if lib is None:
        from harp_tpu_torch.ops import _cuda_build

        lib = _cuda_build.library("spd_solve")
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.spd_solve_launch.argtypes = [vp, vp, vp, ll, i, i, vp]
        lib.spd_solve_launch.restype = i
        lib.spd_solve_warp_smem_bytes.argtypes = [i]
        lib.spd_solve_warp_smem_bytes.restype = ll
        lib.spd_solve_warp_per_sm.argtypes = [i]
        lib.spd_solve_warp_per_sm.restype = i
        lib.spd_solve_block_smem_bytes.argtypes = [i]
        lib.spd_solve_block_smem_bytes.restype = ll
        lib.spd_solve_block_per_sm.argtypes = [i, i, i]
        lib.spd_solve_block_per_sm.restype = i
        lib.spd_solve_block_launch.argtypes = [vp, vp, vp, ll, i, i, i, i,
                                               vp]
        lib.spd_solve_block_launch.restype = i
        lib.spd_solve_global_grid.argtypes = [ll, i]
        lib.spd_solve_global_grid.restype = i
        lib.spd_solve_global_launch.argtypes = [vp] * 4 + [ll, i, i, vp]
        lib.spd_solve_global_launch.restype = i
        _LIB["spd_solve"] = lib
    return lib


def spd_solve_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched SPD solve on the card: x (N, K) with ``a[n] @ x[n] = b[n]``.

    ``a``: (N, K, K) and ``b``: (N, K) float32, contiguous, on one CUDA
    device; any N. :func:`spd_solve_variant` routes by K: to
    ``SPD_MAX_K_WARP`` the one-warp kernel (counted in
    ``launches["spd_solve"]``; :func:`spd_solve_warp_group` lanes a system,
    on :func:`spd_solve_warp_grid`'s blocks), to ``SPD_MAX_K_SMEM`` the
    shared-memory kernel (``launches["spd_solve_block"]``), to
    ``SPD_MAX_K_GLOBAL`` the global-memory kernel
    (``launches["spd_solve_global"]``); a larger K raises. Like the plain
    version all read only the lower triangle of each system; a system that
    is not positive definite gives NaN, as the TPU kernel does."""
    if not (a.is_cuda and b.is_cuda) or a.device != b.device:
        raise ValueError(f"spd_solve_cuda needs both tensors on one CUDA "
                         f"device, got {a.device} and {b.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"a and b must be float32, got {a.dtype} and "
                        f"{b.dtype}")
    n, k = _spd_shapes(a, b)
    variant = spd_solve_variant(k)
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    if variant == "spd_solve_global":
        return _spd_solve_global(a, b)
    if variant == "spd_solve_block":
        return _spd_solve_block(a, b, *spd_solve_block_geometry(k))
    lib = _spd_lib()
    with torch.cuda.device(a.device):
        x = torch.empty((n, k), dtype=torch.float32, device=a.device)
        sms = torch.cuda.get_device_properties(a.device).multi_processor_count
        grid = spd_solve_warp_grid(n, k, spd_solve_warp_per_sm(k, a.device),
                                   sms)
        err = lib.spd_solve_launch(
            a.data_ptr(), b.data_ptr(), x.data_ptr(), n, k, grid,
            torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"spd_solve kernel launch failed: CUDA error {err}")
    launches["spd_solve"] += 1
    return x


def spd_solve_warp_per_sm(k: int, device=None) -> int:
    """Blocks of the one-warp solve resident on one SM at rank K (the
    kernel's occupancy on ``device``, cached)."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    key = ("spd_solve", dev.index, k)
    if key not in _GRID:
        with torch.cuda.device(dev):
            per_sm = _spd_lib().spd_solve_warp_per_sm(k)
        if per_sm < 1:
            raise RuntimeError(f"spd_solve at K={k}: no block fits an SM "
                               f"({per_sm})")
        _GRID[key] = per_sm
    return _GRID[key]


def spd_solve_block_per_sm(k: int, threads: int, regs: int,
                           device=None) -> int:
    """Blocks of the shared-memory solve resident on one SM at that
    geometry (the kernel's occupancy on ``device``, cached)."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    key = ("spd_solve_block", dev.index, k, threads, regs)
    if key not in _GRID:
        with torch.cuda.device(dev):
            per_sm = _spd_lib().spd_solve_block_per_sm(k, threads, regs)
        if per_sm < 1:
            raise RuntimeError(f"spd_solve_block at K={k}, {threads} threads, "
                               f"{regs} registers: no block fits an SM "
                               f"({per_sm})")
        _GRID[key] = per_sm
    return _GRID[key]


def _spd_solve_block(a: torch.Tensor, b: torch.Tensor, threads: int,
                     regs: int) -> torch.Tensor:
    """The shared-memory kernel on checked operands at a geometry of
    ``SPD_BLOCK_SHAPES`` (:func:`spd_solve_cuda` passes
    :func:`spd_solve_block_geometry`'s), on a persistent grid of the
    resident blocks, at most N."""
    n, k = b.shape
    lib = _spd_lib()
    with torch.cuda.device(a.device):
        x = torch.empty((n, k), dtype=torch.float32, device=a.device)
        sms = torch.cuda.get_device_properties(a.device).multi_processor_count
        per_sm = spd_solve_block_per_sm(k, threads, regs, a.device)
        grid = max(1, min(n, sms * per_sm))
        err = lib.spd_solve_block_launch(
            a.data_ptr(), b.data_ptr(), x.data_ptr(), n, k, threads, regs,
            grid, torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"spd_solve kernel launch failed: CUDA error {err}")
    launches["spd_solve_block"] += 1
    return x


def _spd_solve_global(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The global-memory kernel on checked operands (any K up to
    ``SPD_MAX_K_GLOBAL``; :func:`spd_solve_cuda` sends it K >
    ``SPD_MAX_K_SMEM``, and at a K both take its x is the shared-memory
    kernel's bit for bit)."""
    n, k = b.shape
    lib = _spd_lib()
    with torch.cuda.device(a.device):
        x = torch.empty((n, k), dtype=torch.float32, device=a.device)
        grid = lib.spd_solve_global_grid(n, k) if n else 1
        if grid < 1:
            raise RuntimeError(f"spd_solve grid query failed: CUDA error "
                               f"{-grid}")
        ws = torch.empty(spd_solve_global_workspace_bytes(grid, k) // 4,
                         dtype=torch.float32, device=a.device)
        err = lib.spd_solve_global_launch(
            a.data_ptr(), b.data_ptr(), x.data_ptr(), ws.data_ptr(), n, k,
            grid, torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"spd_solve kernel launch failed: CUDA error {err}")
    launches["spd_solve_global"] += 1
    return x


def spd_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The batched SPD solve ALS's ``solver="pallas"`` calls, an explicit
    request for the kernel: the CUDA kernel for CUDA tensors (any K up to
    ``SPD_MAX_K_GLOBAL``; a larger K raises), the plain version for CPU
    tensors."""
    if a.device.type == "cuda":
        return spd_solve_cuda(a, b)
    if a.device.type == "cpu":
        return spd_solve_plain(a, b)
    raise ValueError(f"spd_solve runs on cuda or cpu, not {a.device}")


def use_spd_solve_pallas(k: int, device) -> bool:
    """Whether ALS's ``solver="auto"`` takes the hand-written solve: a CUDA
    device, ``HARP_ALS_PALLAS`` not "0" and K <= ``SPD_MAX_K`` (the JAX
    package's rule and opt-out, with the card in the TPU's place; elsewhere
    "auto" is "cholesky")."""
    return (_on_card(device) and os.environ.get("HARP_ALS_PALLAS") != "0"
            and 1 <= k <= SPD_MAX_K)


# --------------------------------------------------------------------------- #
# Flash attention
# --------------------------------------------------------------------------- #

# the JAX package's dispatch threshold (a TPU crossover, kept as it is)
FLASH_MIN_L = 8192
# (query rows, keys) of a tile of the kernel at Dh, Dv <= 128, and of its
# wide variant past 128: the causal trapezoid of these tiles is what a
# launch loads (``count_flash_tiles``)
FLASH_TILES = (128, 64)
FLASH_WIDE_TILES = (64, 64)


def trapezoid_tiles(l: int, causal: bool, tiles=FLASH_TILES) -> int:
    """KV tiles one (worker, head) loads at length ``l`` on (bq, bk) tiles
    (the narrow kernel's by default): causal, query tile iq walks the
    min(n_kv, ceil((iq + 1) bq / bk)) tiles at or below the diagonal (none
    above it); otherwise all n_q x n_kv of the rectangle."""
    bq, bk = tiles
    n_q, n_kv = -(-l // bq), -(-l // bk)
    if not causal:
        return n_q * n_kv
    return sum(min(n_kv, -(-((iq + 1) * bq) // bk)) for iq in range(n_q))

# head packing is a TPU lane layout: two heads share a 128-lane tile when
# H is even and both widths fit 64 lanes; the port keeps only its check
_PACK_LANES = 64
# the plain version takes its scores in chunks of query rows, at most this
# many scores a chunk (one head at L=16384 would be 1.07 GB)
_PLAIN_CHUNK_SCORES = 1 << 26
# the ring send's copy blocks: one for each 2 MiB of a row's k and v, at
# most 16 a row (a function of the shapes, so the same on every process)
_RING_COPY_BYTES = 2 << 20
_RING_MAX_COPY_BLOCKS = 16
# inside count_flash_tiles: one uint64 device counter a device, to which
# every kernel launch adds the KV tiles its blocks loaded
_flash_tile_counters: Optional[dict] = None


@contextlib.contextmanager
def count_flash_tiles():
    """Within the block, every ``flash_attention_cuda`` launch has its
    kernel count the KV tiles it loads (one atomic add a block). Yields a
    function that returns the count so far (it reads the device, so it
    waits for the launches). The plain version loads no tiles."""
    global _flash_tile_counters
    counters = _flash_tile_counters = {}
    try:
        yield lambda: sum(int(c) for c in counters.values())
    finally:
        _flash_tile_counters = None


def _flash_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """q, k, v viewed stacked (W, L, H, D), checked, and whether they came
    stacked."""
    if q.dim() not in (3, 4) or k.dim() != q.dim() or v.dim() != q.dim():
        raise ValueError(f"flash_attention takes q, k, v as (L, H, D) or "
                         f"stacked (W, L, H, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    stacked = q.dim() == 4
    q4, k4, v4 = (x if stacked else x.unsqueeze(0) for x in (q, k, v))
    w, l, h, dh = q4.shape
    if (tuple(k4.shape) != (w, l, h, dh) or tuple(v4.shape[:3]) != (w, l, h)
            or min(w, l, h, dh, v4.shape[3]) < 1):
        raise ValueError(f"flash_attention: q and k must be (W, L, H, Dh) "
                         f"and v (W, L, H, Dv), non-empty, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    return q4, k4, v4, stacked


def _flash_result(out, m, den, stacked: bool, return_stats: bool):
    res = (out, m, den) if return_stats else (out,)
    if not stacked:
        res = tuple(x[0] for x in res)
    return res if return_stats else res[0]


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False, return_stats: bool = False,
                          ring_hop: bool = False):
    """Attention in plain PyTorch, the same function as
    :func:`flash_attention_cuda` (with ``ring_hop``, then
    ``ring_dma.hop_plain`` of k and of v on the bound worker group, a
    stacked group or gloo between processes): float32 scores of the inputs
    scaled by 1/sqrt(Dh), causal keys masked with -1e30, a full-row softmax,
    out = (p @ v) / max(den, 1e-30) in float32 (v widened to float32). At
    the end of the kernel's KV walk its running max is the row max, so m and
    den are the kernel's. Loops over stacked workers and over chunks of
    query rows to bound the scores' memory."""
    q4, k4, v4, stacked = _flash_operands(q, k, v)
    w, l, h, dh = q4.shape
    group = _ring_group(stacked, return_stats, w, None) if ring_hop else None
    dv = v4.shape[3]
    scale = 1.0 / float(dh) ** 0.5
    dev = q.device
    out = torch.empty((w, l, h, dv), dtype=torch.float32, device=dev)
    m = torch.empty((w, l, h), dtype=torch.float32, device=dev)
    den = torch.empty((w, l, h), dtype=torch.float32, device=dev)
    rows = max(1, _PLAIN_CHUNK_SCORES // (h * l))
    k_pos = torch.arange(l, device=dev)
    for wi in range(w):
        kf, vf = k4[wi].float(), v4[wi].float()
        for r0 in range(0, l, rows):
            qf = q4[wi, r0:r0 + rows].float()
            s = torch.einsum("qhd,khd->hqk", qf, kf) * scale
            if causal:
                q_pos = torch.arange(r0, r0 + qf.shape[0], device=dev)
                s.masked_fill_(q_pos[:, None] < k_pos[None, :], -1e30)
            mx = s.amax(dim=2)                                # (H, rows)
            p = torch.exp(s - mx[..., None])
            d = p.sum(dim=2)
            o = torch.einsum("hqk,khd->qhd", p, vf)
            den_t = torch.clamp(d, min=1e-30).t()
            out[wi, r0:r0 + rows] = o / den_t[..., None]
            m[wi, r0:r0 + rows] = mx.t()
            den[wi, r0:r0 + rows] = d.t()
    if ring_hop:
        return (out, m, den, ring_dma.hop_plain(k, 1, group),
                ring_dma.hop_plain(v, 1, group))
    return _flash_result(out, m, den, stacked, return_stats)


def _flash_lib() -> ctypes.CDLL:
    lib = _LIB.get("flash_attention")
    if lib is None:
        from harp_tpu_torch.ops import _cuda_build

        lib = _cuda_build.library("flash_attention")
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = (
            [vp] * 7 + [i] * 5 + [ctypes.c_float, i, i, vp]
            + [vp, vp, i, ctypes.c_longlong, vp, i, i, i, ctypes.c_ulonglong,
               vp, i])
        lib.flash_attention_launch.restype = i
        _LIB["flash_attention"] = lib
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = False, return_stats: bool = False,
                         ring_hop: bool = False,
                         group: Optional[mesh_lib.WorkerGroup] = None):
    """Flash attention on the card: out (L, H, Dv), or (out, m (L, H), den
    (L, H)) with ``return_stats``; stacked inputs give stacked outputs.

    ``q``, ``k``: (L, H, Dh) or stacked (W, L, H, Dh); ``v``: (L, H, Dv) or
    (W, L, H, Dv); one type, float32 or bfloat16, contiguous, on one CUDA
    device; any L, Dh and Dv (a head wider than 128 takes the kernel's wide
    variant, ceil(Dv / 256) blocks a query tile). A
    stacked input is one launch for all workers. Outputs are float32
    whatever the input type.

    ``ring_hop`` (needs ``return_stats`` and stacked inputs, W the workers
    a process of ``group``, by default the bound one): the same launch also
    sends k and v to the right ring neighbour, and the call returns (out,
    m, den, k_next, v_next), k_next and v_next bitwise ``ring_dma.
    hop_plain(k, 1)`` and ``hop_plain(v, 1)`` in the input type (across
    processes with the credit handshake, and the receive kernel after the
    launch)."""
    args = (q, k, v)
    if not all(t.is_cuda and t.device == q.device for t in args):
        raise ValueError("flash_attention_cuda needs q, k and v on one CUDA "
                         "device, got " + ", ".join(str(t.device)
                                                    for t in args))
    if q.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != q.dtype for t in args):
        raise TypeError(f"q, k and v must share one type, float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("q, k and v must be contiguous")
    q4, k4, v4, stacked = _flash_operands(q, k, v)
    w, l, h, dh = q4.shape
    dv = v4.shape[3]
    if ring_hop:
        group = _ring_group(stacked, return_stats, w, group)
    lib = _flash_lib()
    dev = q.device
    with torch.cuda.device(dev):
        out = torch.empty((w, l, h, dv), dtype=torch.float32, device=dev)
        m = den = None
        if return_stats:
            m = torch.empty((w, l, h), dtype=torch.float32, device=dev)
            den = torch.empty((w, l, h), dtype=torch.float32, device=dev)
        tiles = None
        if _flash_tile_counters is not None:
            if dev not in _flash_tile_counters:
                _flash_tile_counters[dev] = torch.zeros((), dtype=torch.int64,
                                                        device=dev)
            tiles = _flash_tile_counters[dev].data_ptr()
        ring = (None, None, 0, 0, None, 0, 0, 1, 0, None, 0)    # no send
        if ring_hop:
            k_next, v_next = torch.empty_like(k4), torch.empty_like(v4)
            kbytes = k4[0].numel() * k4.element_size()
            v_off = -(-kbytes // 256) * 256
            row_bytes = v_off + v4[0].numel() * v4.element_size()
            cpr = min(_RING_MAX_COPY_BLOCKS,
                      max(1, -(-row_bytes // _RING_COPY_BYTES)))
            send = ring_dma.SendPlan(group, dev, "flash_ring", row_bytes,
                                     cpr)
            ring = (k_next.data_ptr(), v_next.data_ptr(), cpr, v_off,
                    *send.args)
        err = lib.flash_attention_launch(
            q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), out.data_ptr(),
            None if m is None else m.data_ptr(),
            None if den is None else den.data_ptr(), tiles, w, l, h, dh, dv,
            1.0 / float(dh) ** 0.5, int(causal),
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream, *ring)
        if err == 0 and ring_hop:
            send.receive(k_next, v_next, v_off)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches["flash_attention"] += 1
    if not ring_hop:
        return _flash_result(out, m, den, stacked, return_stats)
    launches["flash_attention_ring"] += 1
    return out, m, den, k_next, v_next


def _ring_group(stacked: bool, return_stats: bool, w: int,
                group: Optional[mesh_lib.WorkerGroup]
                ) -> mesh_lib.WorkerGroup:
    """The worker group of a ``ring_hop`` call, checked: stacked inputs of
    its workers a process, with the stats."""
    if not return_stats:
        raise ValueError("ring_hop=True requires return_stats=True (the "
                         "ring merge needs the streaming-softmax stats)")
    if not stacked:
        raise ValueError("ring_hop=True takes stacked (W, L, H, D) inputs")
    group = group or mesh_lib.current_group()
    if w != group.workers_per_process:
        raise ValueError(f"ring_hop=True: the inputs hold {w} workers, the "
                         f"group {group.workers_per_process} a process")
    return group


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, head_pack: Optional[bool] = None,
                    return_stats: bool = False, ring_hop: bool = False):
    """Flash attention as the JAX package's ``flash_attention_pallas``
    takes it: q, k (L, H, Dh), v (L, H, Dv), or stacked (W, L, H, D) -> out
    (L, H, Dv) float32, plus m and den (L, H) with ``return_stats``. The
    CUDA kernel for CUDA tensors, the plain version for CPU tensors.

    ``head_pack`` (the TPU's two-heads-per-lane-tile layout) never changes
    the output; True raises where the TPU could not pack (odd H, Dh or Dv
    above 64). ``ring_hop`` (the in-kernel KV ring send; needs
    ``return_stats`` and stacked inputs of the bound worker group) returns
    (out, m, den, k_next, v_next), k_next and v_next exactly
    ``lax_ops.rotate`` of k and v: on the card sent by the same launch,
    never by ``ring_dma.hop``; on the CPU the plain version and
    ``ring_dma.hop_plain``."""
    if ring_hop and not return_stats:
        raise ValueError("ring_hop=True requires return_stats=True (the "
                         "ring merge needs the streaming-softmax stats)")
    h, dh, dv = q.shape[-2], q.shape[-1], v.shape[-1]
    if head_pack and not (h % 2 == 0 and dh <= _PACK_LANES
                          and dv <= _PACK_LANES):
        raise ValueError(
            f"head_pack=True needs even H and Dh/Dv <= {_PACK_LANES}, "
            f"got H={h} Dh={dh} Dv={dv}")
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal, return_stats,
                                    ring_hop=ring_hop)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, return_stats, ring_hop)
    raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")


def use_flash_pallas(l: int, device) -> bool:
    """Whether attention takes the flash kernel at length L on ``device``: a
    CUDA device and L >= ``FLASH_MIN_L`` (the JAX package's rule, with the
    card in the TPU's place). Below it attention is plain tensor code, as
    the JAX package leaves it to XLA. Like the JAX kernel, this one takes
    any head width."""
    return _on_card(device) and l >= FLASH_MIN_L
