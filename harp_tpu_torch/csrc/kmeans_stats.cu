// Fused K-means E-step for Hopper (sm_90a): distances, row argmin and
// per-centroid partial sums in one pass, without writing the (N, K) score
// matrix to device memory.
//
// Replaces: harp_tpu/ops/pallas_kernels.py::_kmeans_tile_kernel (the TPU
// kernel behind kmeans_stats_pallas). It computes the same function, not the
// same tiling:
//   score[p, k] = ||c_k||^2 - 2 x_p . c_k   for k < valid_k (others masked)
//   a[p]        = argmin_k score[p, k]      (lowest index on ties)
//   sums[a[p]] += x_p, counts[a[p]] += 1, cost += score[p, a[p]] + ||x_p||^2
// with float32 accumulation throughout. bf16 points take the cross term with
// the centroids rounded to bf16 (exact products, float32 sums), as the TPU
// kernel did; norms, sums and counts stay float32.
//
// What bounds it on this card: the score pass is 2*N*K*D operations on the
// float32 CUDA cores (67 TFLOP/s on an H100 SXM) against one read of x
// (N*D*4 bytes at 3.35 TB/s); at the flagship N=1e6, K=D=100 that is
// 0.30 ms of operations against 0.12 ms of bytes, so it is bound by
// operations. The design answers that with register tiling: each thread
// holds a 4-point x CT-centroid block of dot products and, per feature,
// reads its 4 points with one 16-byte shared-memory load (the point tile is
// stored transposed) and its CT centroids with conflict-free scalar loads.
// CT is picked per call from valid_k (2, 4, 7 or 8), so K=100 computes 112
// columns, not 128. The next tile's loads are issued before the current
// tile's sums, so their latency hides behind that phase. Tensor cores (TF32)
// would be faster but round the cross term to ~3 digits and move argmins.
//
// Determinism: no float atomics. Each block strides over point tiles and
// accumulates a (K, D+2) partial in shared memory: columns [0, D) sums, D
// counts, D+1 the squared distance of the points assigned to that row. Per
// tile the points are ranked by assignment (a stable rank, so tile order is
// kept within a centroid), which makes each centroid's points one run; a
// thread per column sums each run in registers, in rank order, and adds the
// sum to the partial once. Runs are distinct rows, so a batch of them is
// read and written together, and the two halves of the block take disjoint
// runs. The partials go to a workspace (W, G, K, D+2) and a second kernel
// reduces them over G in a fixed order, so repeated runs are bitwise equal.
// G, the blocks a worker, is the resident blocks of the whole card, at most
// one a tile: a function of (N, D, K, valid_k, type), never of W. So a
// stacked launch of W workers (a (G, W) grid, run in waves) sums each
// worker's points in exactly the order of a launch that holds that worker
// alone, and a process holding 1 worker of a group is bitwise a stacked
// group. The kernel never waits on another block, so it needs no cap on
// the blocks resident at once.
//
// Layout: x is (W, N, D) row-major, c is (K, D) shared or (W, K, D) one table
// per worker (c_per_worker), all contiguous. The host binding is a plain C
// interface loaded with ctypes (harp_tpu_torch/ops/_cuda_build.py).
//
// The wide variant (kmeans_stats_wide_launch) takes every (K, D) whose block
// would need more shared memory than the card gives (smem_floats above 227
// KB: K > 249 at D = 100, any K past D = 824). It is three passes and the
// same reduction:
//   1. kmeans_norms_kernel: ||c_k||^2, a warp a centroid row.
//   2. kmeans_assign_kernel: a 128-point tile a block. The centroids stream
//      through shared memory in chunks of 128 rows and the features in
//      chunks of 16, both double-buffered; each thread holds an 8-point x
//      8-centroid block of dot products in registers (4 float4 loads feed 64
//      FMAs a feature). The point tile is re-read, from L2, for each
//      centroid chunk. A running (min score, argmin) per point lives in
//      shared memory: chunks in ascending order, strict <, so the lowest
//      index wins ties. It writes each point's assignment and distance
//      (min score + ||x||^2) to device memory: (W, N) int32 and float32.
//      A point's result depends on no other point, so its grid is free.
//   3. kmeans_wide_sums_kernel: the narrow kernel's sums, with the (K, D+2)
//      partial in a slab of device memory that one block owns: per 64-point
//      tile the points are ranked by assignment, each run summed in rank
//      order and added to its slab row once. G, the blocks a worker, is
//      2 a streaming multiprocessor, capped at the tiles and at
//      kWideSlabBudget / slab bytes: a function of (N, D, K) and the card,
//      never of W, so the determinism argument above holds unchanged.
// kmeans_reduce_kernel then sums the slabs over G in order. Work: the score
// pass is the same 2*N*K*D operations, bound by operations; the sums pass
// reads x once more and read-modify-writes one slab row a run (L2 or
// device memory), a few percent of the time at K >= 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                 // points per tile
static_assert(kThreads == 4 * kTile, "the rank gives each point four lanes");
constexpr int kXStride = kTile + 4;       // transposed tile row: 16-byte
                                          // aligned, conflict-free writes
constexpr int kPointGroups = 16;
constexpr int kPointsPerThread = kTile / kPointGroups;     // 4
constexpr int kCentroidGroups = kThreads / kPointGroups;   // 16
constexpr int kQuadsPerWarp = kTile / 4 / kWarps;          // 2
constexpr int kLoadBatch = 16;            // features per lane per batch: a
                                          // batch covers 128 features
constexpr int kRunBatch = 8;              // ranked points read per batch
constexpr int kReduceThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// the cross-term operand: centroids rounded to the points' type
template <typename T>
__device__ __forceinline__ float round_like(float v) { return v; }
template <>
__device__ __forceinline__ float round_like<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// centroid row stride in shared memory: odd, so rows fall on distinct banks
__host__ __device__ __forceinline__ int padded(int d) { return d | 1; }

// (the twin on the host side: pallas_kernels.kmeans_smem_bytes)
__host__ __device__ __forceinline__ size_t smem_floats(int d, int k) {
  return (size_t)(d + 2) * kXStride + (size_t)k * padded(d) + k +
         (size_t)k * (d + 2) + 4 * kTile + 1;
}

// Centroids per thread per chunk: the smallest of 2, 4, 7, 8 whose chunk
// (16 * CT columns) covers valid_k; above 128 columns, chunks of 128.
__host__ __forceinline__ int centroids_per_thread(int valid_k) {
  return valid_k <= 32 ? 2 : valid_k <= 64 ? 4 : valid_k <= 112 ? 7 : 8;
}

// One batch of a tile's loads: for each of this lane's point quads, the
// features j0, j0 + 8, ... (kLoadBatch of them), zero past the tile or D.
template <typename T>
__device__ __forceinline__ void fetch(const T* xw, int base, int cnt, int d,
                                      int warp, int lane, int j0,
                                      float (&v)[kQuadsPerWarp][kLoadBatch]) {
  const int pl = lane & 3;
#pragma unroll
  for (int h = 0; h < kQuadsPerWarp; ++h) {
    const int p = 4 * (warp + kWarps * h) + pl;
    const T* src = xw + ((size_t)base + min(p, cnt - 1)) * d;
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int j = j0 + 8 * u;
      v[h][u] = (p < cnt && j < d) ? to_float(src[j]) : 0.f;
    }
  }
}

// Store a fetched batch into the transposed tile and add its squares.
__device__ __forceinline__ void put(float* xt, int d, int warp, int lane,
                                    int j0,
                                    const float (&v)[kQuadsPerWarp][kLoadBatch],
                                    float (&s)[kQuadsPerWarp]) {
  const int pl = lane & 3;
#pragma unroll
  for (int h = 0; h < kQuadsPerWarp; ++h) {
    const int p = 4 * (warp + kWarps * h) + pl;
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int j = j0 + 8 * u;
      if (j < d) {
        xt[j * kXStride + p] = v[h][u];
        s[h] = fmaf(v[h][u], v[h][u], s[h]);
      }
    }
  }
}

template <typename T, int CT>
__global__ void __launch_bounds__(kThreads)
kmeans_stats_kernel(const T* __restrict__ x, const float* __restrict__ c,
                    float* __restrict__ ws, int n, int d, int k, int valid_k,
                    int c_per_worker) {
  constexpr int kChunk = kCentroidGroups * CT;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int dp = padded(d);
  const int row = d + 2;
  // xt: the point tile transposed, (d + 2, kXStride); row d holds ones and
  // row d + 1 each point's distance, so the sums of all d + 2 columns of
  // the partial read one array
  float* xt = smem;
  float* cs = xt + (size_t)(d + 2) * kXStride;  // (k, dp) cross-term centroids
  float* c2 = cs + (size_t)k * dp;          // (k) squared norms
  float* acc = c2 + k;                      // (k, d+2) partial stats
  float* xsq = acc + (size_t)k * row;       // (kTile) ||x_p||^2
  int* asg = reinterpret_cast<int*>(xsq + kTile);  // (kTile) assignment
  int* srow = asg + kTile;                  // (kTile) ranked: assignment
  int* sidx = srow + kTile;                 // (kTile) ranked: point
  int* split = sidx + kTile;                // where the second half starts

  const int tid = threadIdx.x;
  const int w = blockIdx.y;
  const int g = blockIdx.x;
  const int grid_g = gridDim.x;
  const T* xw = x + (size_t)w * n * d;
  const float* cw = c + (c_per_worker ? (size_t)w * k * d : 0);

  for (int i = tid; i < k * d; i += kThreads) {
    const int r = i / d;
    cs[r * dp + (i - r * d)] = round_like<T>(cw[i]);
  }
  for (int r = tid; r < k; r += kThreads) {
    float s = 0.f;
    for (int j = 0; j < d; ++j) s = fmaf(cw[r * d + j], cw[r * d + j], s);
    c2[r] = s;
  }
  for (int i = tid; i < k * row; i += kThreads) acc[i] = 0.f;
  for (int p = tid; p < kTile; p += kThreads) xt[d * kXStride + p] = 1.f;

  const int pg = tid / kCentroidGroups;   // point group: 4 points
  const int kg = tid % kCentroidGroups;   // centroid group
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int jj = lane >> 2;               // this lane's first feature
  const int num_tiles = (n + kTile - 1) / kTile;

  // the first batch of this block's first tile; later tiles' first batches
  // are fetched during the previous tile's sums
  float v[kQuadsPerWarp][kLoadBatch];
  if (g < num_tiles)
    fetch(xw, g * kTile, min(kTile, n - g * kTile), d, warp, lane, jj, v);

  for (int tile = g; tile < num_tiles; tile += grid_g) {
    const int base = tile * kTile;
    const int cnt = min(kTile, n - base);
    __syncthreads();  // the previous tile's readers are done

    if (tid == 0) *split = cnt;

    // the tile, transposed, and ||x_p||^2: a warp covers 4 points x 8
    // features per load (lane = 4 * feature + point); each point's squares
    // are summed over its 8 lanes with a fixed shuffle tree
    {
      float s[kQuadsPerWarp];
#pragma unroll
      for (int h = 0; h < kQuadsPerWarp; ++h) s[h] = 0.f;
      put(xt, d, warp, lane, jj, v, s);
      for (int j0 = jj + 8 * kLoadBatch; j0 < d; j0 += 8 * kLoadBatch) {
        fetch(xw, base, cnt, d, warp, lane, j0, v);
        put(xt, d, warp, lane, j0, v, s);
      }
#pragma unroll
      for (int h = 0; h < kQuadsPerWarp; ++h) {
        for (int off = 4; off < 32; off <<= 1)
          s[h] += __shfl_xor_sync(0xffffffffu, s[h], off);
        if (jj == 0) xsq[4 * (warp + kWarps * h) + (lane & 3)] = s[h];
      }
    }
    __syncthreads();

    // scores and running argmin: this thread's 4 points against its
    // centroids kg, kg+16, ... of each chunk, in index order
    float best[kPointsPerThread];
    int bidx[kPointsPerThread];
#pragma unroll
    for (int i = 0; i < kPointsPerThread; ++i) {
      best[i] = INFINITY;
      bidx[i] = 0;
    }
    const float* xcol = xt + pg * kPointsPerThread;
    for (int k0 = 0; k0 < valid_k; k0 += kChunk) {
      int coff[CT];
#pragma unroll
      for (int j = 0; j < CT; ++j)
        coff[j] = min(k0 + kg + kCentroidGroups * j, k - 1) * dp;
      float dot[kPointsPerThread][CT];
#pragma unroll
      for (int i = 0; i < kPointsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) dot[i][j] = 0.f;
#pragma unroll 8
      for (int col = 0; col < d; ++col) {
        const float4 xv =
            *reinterpret_cast<const float4*>(xcol + col * kXStride);
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          const float cv = cs[coff[j] + col];
          dot[0][j] = fmaf(xv.x, cv, dot[0][j]);
          dot[1][j] = fmaf(xv.y, cv, dot[1][j]);
          dot[2][j] = fmaf(xv.z, cv, dot[2][j]);
          dot[3][j] = fmaf(xv.w, cv, dot[3][j]);
        }
      }
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int kk = k0 + kg + kCentroidGroups * j;
        if (kk < valid_k) {
          const float cn = c2[kk];
#pragma unroll
          for (int i = 0; i < kPointsPerThread; ++i) {
            const float s = cn - 2.f * dot[i][j];
            if (s < best[i]) {
              best[i] = s;
              bidx[i] = kk;
            }
          }
        }
      }
    }
    // argmin across the 16 centroid groups (lanes of one half-warp);
    // ties go to the lower index
#pragma unroll
    for (int i = 0; i < kPointsPerThread; ++i) {
      for (int off = kCentroidGroups / 2; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best[i], off);
        const int oi = __shfl_xor_sync(0xffffffffu, bidx[i], off);
        if (ob < best[i] || (ob == best[i] && oi < bidx[i])) {
          best[i] = ob;
          bidx[i] = oi;
        }
      }
    }
    if (kg == 0) {
#pragma unroll
      for (int i = 0; i < kPointsPerThread; ++i) {
        const int p = pg * kPointsPerThread + i;
        asg[p] = bidx[i];
        xt[(d + 1) * kXStride + p] = best[i] + xsq[p];
      }
    }
    __syncthreads();

    // stable rank of each point by assignment, four lanes per point each
    // counting over a quarter of the tile. A point with no equal before it
    // starts its centroid's run; the ranked points are split in two at the
    // first run that starts at or after the middle, so no centroid falls in
    // both halves (an integer minimum: the same in any order)
    {
      const int p = tid >> 2;
      const int part = tid & 3;
      const int a = asg[p];
      int less = 0, same = 0;
#pragma unroll
      for (int u = 0; u < kTile / 4; ++u) {
        const int q = part * (kTile / 4) + u;
        const int b = asg[q];
        less += (q < cnt) & (b < a);
        same += (b == a) & (q < p);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        less += __shfl_xor_sync(0xffffffffu, less, off);
        same += __shfl_xor_sync(0xffffffffu, same, off);
      }
      const int r = less + same;
      if (part == 0 && p < cnt) {
        srow[r] = a;
        sidx[r] = p;
        if (same == 0 && 2 * r >= cnt - cnt % 2) atomicMin(split, r);
      }
    }
    __syncthreads();

    // the next tile's first batch: in flight during the sums below
    if (tile + grid_g < num_tiles) {
      const int nb = base + grid_g * kTile;
      fetch(xw, nb, min(kTile, n - nb), d, warp, lane, jj, v);
    }

    // segmented add: a thread owns column tid % 128 (+ 128 ...) of one half
    // of the ranked points and walks it kRunBatch points at a time: it
    // sums each run of one centroid in registers, in rank order, and adds
    // the run's sum to the partial once. The runs ending in one batch are
    // distinct rows, so their read-modify-writes are issued together
    {
      const int half = tid / (kThreads / 2);
      const int lo = half ? *split : 0;
      const int hi = half ? cnt : *split;
      for (int col = tid % (kThreads / 2); col < row; col += kThreads / 2) {
        const float* xc = xt + col * kXStride;
        for (int i0 = lo; i0 < hi; i0 += kRunBatch) {
          int rr[kRunBatch];
          float vv[kRunBatch];
#pragma unroll
          for (int u = 0; u < kRunBatch; ++u) {
            const int i = i0 + u;
            rr[u] = i < hi ? srow[i] : -1;
            vv[u] = i < hi ? xc[sidx[i]] : 0.f;
          }
#pragma unroll
          for (int u = 1; u < kRunBatch; ++u)
            if (rr[u] == rr[u - 1]) vv[u] += vv[u - 1];
          bool last[kRunBatch];
          float a[kRunBatch];
#pragma unroll
          for (int u = 0; u < kRunBatch; ++u) {
            last[u] = rr[u] >= 0 && (u + 1 == kRunBatch || rr[u + 1] != rr[u]);
            a[u] = last[u] ? acc[rr[u] * row + col] : 0.f;
          }
#pragma unroll
          for (int u = 0; u < kRunBatch; ++u)
            if (last[u]) acc[rr[u] * row + col] = a[u] + vv[u];
        }
      }
    }
  }
  __syncthreads();
  float* out = ws + ((size_t)w * grid_g + g) * k * row;
  for (int i = tid; i < k * row; i += kThreads) out[i] = acc[i];
}

// Reduce the (W, G, K, D+2) partials over G in order. Blocks [0, nb) own
// the sums and counts columns; the last block of each worker sums the cost
// column over K and G in a fixed order.
__global__ void __launch_bounds__(kReduceThreads)
kmeans_reduce_kernel(const float* __restrict__ ws, float* __restrict__ sums,
                     float* __restrict__ counts, float* __restrict__ cost,
                     int d, int k, int grid_g) {
  const int w = blockIdx.y;
  const int row = d + 2;
  const size_t stride = (size_t)k * row;
  const float* wsw = ws + (size_t)w * grid_g * stride;
  const int tid = threadIdx.x;
  if (blockIdx.x + 1 < gridDim.x) {
    const int i = blockIdx.x * kReduceThreads + tid;
    if (i >= k * row) return;
    const int r = i / row;
    const int col = i - r * row;
    if (col > d) return;
    float s = 0.f;
    for (int g = 0; g < grid_g; ++g) s += wsw[g * stride + i];
    if (col < d)
      sums[((size_t)w * k + r) * d + col] = s;
    else
      counts[(size_t)w * k + r] = s;
    return;
  }
  __shared__ float part[kReduceThreads];
  float s = 0.f;
  for (int r = tid; r < k; r += kReduceThreads) {
    float t = 0.f;
    for (int g = 0; g < grid_g; ++g) t += wsw[g * stride + (size_t)r * row + d + 1];
    s += t;
  }
  part[tid] = s;
  __syncthreads();
  if (tid == 0) {
    float tot = 0.f;
    for (int i = 0; i < kReduceThreads; ++i) tot += part[i];
    cost[w] = tot;
  }
}

// --------------------------------------------------------------------------
// The wide variant
// --------------------------------------------------------------------------

constexpr int kAPoints = 128;             // points a tile of the assign pass
constexpr int kACents = 128;              // centroid rows a chunk
constexpr int kADepth = 16;               // features a chunk
constexpr int kAStride = kAPoints + 4;    // shared row: 16-byte aligned
constexpr int kALoads = kAPoints * kADepth / kThreads;   // 8 a thread
static_assert(kAPoints == kACents, "points and centroids load alike");
static_assert(kThreads == 16 * 16, "a 16 x 16 grid of 8 x 8 thread blocks");
constexpr int kSumsBlocksPerSM = 2;       // the sums pass's grid a SM
constexpr int kWideRunBatch = 16;         // ranked points a batch there: its
                                          // reads go to L2 or device memory
// the per-worker byte budget of the sums pass's slabs (the twin on the host
// side: pallas_kernels.KMEANS_WIDE_SLAB_BYTES)
constexpr long long kWideSlabBudget = 1LL << 30;

// ||c_r||^2 of every row, a warp a row: lane-strided sums, a fixed tree
__global__ void __launch_bounds__(kThreads)
kmeans_norms_kernel(const float* __restrict__ c, float* __restrict__ c2,
                    int rows, int d) {
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;                  // the same for the whole warp
  const float* cr = c + (size_t)r * d;
  float s = 0.f;
  for (int j = lane; j < d; j += 32) s = fmaf(cr[j], cr[j], s);
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) c2[r] = s;
}

// One step's loads of the assign pass: feature j of the tile's points and
// of centroid rows k0.., rows lr, lr + 16, ...; zero past the tile, valid_k
// or D. Centroids rounded to the points' type for the cross term.
template <typename T>
__device__ __forceinline__ void fetch_step(const T* xw, const float* cw,
                                           int cnt, int valid_k, int d,
                                           int k0, int j, int lr,
                                           float (&px)[kALoads],
                                           float (&pc)[kALoads]) {
#pragma unroll
  for (int u = 0; u < kALoads; ++u) {
    const int r = lr + 16 * u;
    px[u] = (r < cnt && j < d) ? to_float(xw[(size_t)r * d + j]) : 0.f;
    pc[u] = (k0 + r < valid_k && j < d)
                ? round_like<T>(cw[(size_t)(k0 + r) * d + j])
                : 0.f;
  }
}

// Store one step's loads, feature-major: (kADepth, kAStride) each.
__device__ __forceinline__ void put_step(float (*xs)[kAStride],
                                         float (*cs)[kAStride], int lf,
                                         int lr, const float (&px)[kALoads],
                                         const float (&pc)[kALoads]) {
#pragma unroll
  for (int u = 0; u < kALoads; ++u) {
    xs[lf][lr + 16 * u] = px[u];
    cs[lf][lr + 16 * u] = pc[u];
  }
}

// One 128-point tile: the argmin over all valid_k centroids and the
// point's distance. Thread (ty, tx) = (tid / 16, tid % 16) owns points
// 4ty..4ty+3 and 64+4ty..64+4ty+3 against the same pattern of centroids.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
kmeans_assign_kernel(const T* __restrict__ x, const float* __restrict__ c,
                     const float* __restrict__ c2, int* __restrict__ asg,
                     float* __restrict__ dist, int n, int d, int k,
                     int valid_k, int c_per_worker) {
  __shared__ __align__(16) float xs[2][kADepth][kAStride];
  __shared__ __align__(16) float cs[2][kADepth][kAStride];
  __shared__ float best[kAPoints];
  __shared__ int bidx[kAPoints];

  const int tid = threadIdx.x;
  const int w = blockIdx.y;
  const int base = blockIdx.x * kAPoints;
  const int cnt = min(kAPoints, n - base);
  const T* xw = x + ((size_t)w * n + base) * d;
  const float* cw = c + (c_per_worker ? (size_t)w * k * d : 0);
  const float* c2w = c2 + (c_per_worker ? (size_t)w * k : 0);
  const int lf = tid % kADepth;           // this thread's loads: feature lf
  const int lr = tid / kADepth;           // of rows lr, lr + 16, ...
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int nd = (d + kADepth - 1) / kADepth;
  const int steps = ((valid_k + kACents - 1) / kACents) * nd;

  if (tid < kAPoints) {
    best[tid] = INFINITY;
    bidx[tid] = 0;
  }
  float xsq = 0.f;                        // ||x_tid||^2, from the first chunk
  float px[kALoads], pc[kALoads];
  float acc[8][8];
  fetch_step(xw, cw, cnt, valid_k, d, 0, lf, lr, px, pc);
  put_step(xs[0], cs[0], lf, lr, px, pc);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    const int kc = s / nd;
    const int dc = s - kc * nd;
    if (s + 1 < steps) {                  // in flight during the FMAs
      const int kn = (s + 1) / nd;
      fetch_step(xw, cw, cnt, valid_k, d, kn * kACents,
                 (s + 1 - kn * nd) * kADepth + lf, lr, px, pc);
    }
    if (dc == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
#pragma unroll
    for (int f = 0; f < kADepth; ++f) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[buf][f][4 * ty]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&xs[buf][f][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&cs[buf][f][4 * tx]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&cs[buf][f][64 + 4 * tx]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (kc == 0 && tid < kAPoints) {
#pragma unroll
      for (int f = 0; f < kADepth; ++f)
        xsq = fmaf(xs[buf][f][tid], xs[buf][f][tid], xsq);
    }
    if (s + 1 < steps) put_step(xs[buf ^ 1], cs[buf ^ 1], lf, lr, px, pc);
    __syncthreads();
    if (dc + 1 < nd) continue;
    // the chunk's scores: each thread's best of its 8 columns (ascending),
    // then across the 16 lanes of the half-warp that share its points
    // (ties to the lower index), then against the earlier chunks (strict <)
    const int k0 = kc * kACents;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float bs = INFINITY;
      int bi = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kk = k0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
        if (kk < valid_k) {
          const float sc = c2w[kk] - 2.f * acc[i][j];
          if (sc < bs) {
            bs = sc;
            bi = kk;
          }
        }
      }
      for (int off = 8; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, bs, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (ob < bs || (ob == bs && oi < bi)) {
          bs = ob;
          bi = oi;
        }
      }
      if (tx == 0) {
        const int p = i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4;
        if (bs < best[p]) {
          best[p] = bs;
          bidx[p] = bi;
        }
      }
    }
  }
  __syncthreads();
  if (tid < cnt) {
    asg[(size_t)w * n + base + tid] = bidx[tid];
    dist[(size_t)w * n + base + tid] = best[tid] + xsq;
  }
}

// The sums pass: block g of worker w owns slab (w, g) of ws, a (K, D+2)
// partial (columns [0, D) sums, D counts, D+1 distances), and walks the
// 64-point tiles g, g + G, ... as the narrow kernel does, reading the
// assignments and distances the assign pass wrote.
template <typename T>
__global__ void __launch_bounds__(kThreads)
kmeans_wide_sums_kernel(const T* __restrict__ x, const int* __restrict__ asg,
                        const float* __restrict__ dist,
                        float* __restrict__ ws, int n, int d, int k) {
  __shared__ int sasg[kTile];             // the tile's assignments
  __shared__ int srow[kTile];             // ranked: assignment
  __shared__ int sidx[kTile];             // ranked: point
  __shared__ int split;                   // where the second half starts

  const int tid = threadIdx.x;
  const int w = blockIdx.y;
  const int g = blockIdx.x;
  const int grid_g = gridDim.x;
  const int row = d + 2;
  const size_t slab_size = (size_t)k * row;
  float* slab = ws + ((size_t)w * grid_g + g) * slab_size;
  const T* xw = x + (size_t)w * n * d;
  const int* aw = asg + (size_t)w * n;
  const float* dw = dist + (size_t)w * n;
  const int num_tiles = (n + kTile - 1) / kTile;

  for (size_t i = tid; i < slab_size; i += kThreads) slab[i] = 0.f;

  for (int tile = g; tile < num_tiles; tile += grid_g) {
    const int base = tile * kTile;
    const int cnt = min(kTile, n - base);
    __syncthreads();  // the slab is zeroed, the previous tile's readers done
    if (tid < kTile) sasg[tid] = tid < cnt ? aw[base + tid] : 0;
    if (tid == 0) split = cnt;
    __syncthreads();

    // the narrow kernel's stable rank and split
    {
      const int p = tid >> 2;
      const int part = tid & 3;
      const int a = sasg[p];
      int less = 0, same = 0;
#pragma unroll
      for (int u = 0; u < kTile / 4; ++u) {
        const int q = part * (kTile / 4) + u;
        const int b = sasg[q];
        less += (q < cnt) & (b < a);
        same += (b == a) & (q < p);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        less += __shfl_xor_sync(0xffffffffu, less, off);
        same += __shfl_xor_sync(0xffffffffu, same, off);
      }
      const int r = less + same;
      if (part == 0 && p < cnt) {
        srow[r] = a;
        sidx[r] = p;
        if (same == 0 && 2 * r >= cnt - cnt % 2) atomicMin(&split, r);
      }
    }
    __syncthreads();

    // the narrow kernel's segmented add, each value read from device
    // memory (a warp reads 32 neighbouring columns of one point) and each
    // run's sum added to the slab once, in batches of 16 for more reads in
    // flight
    {
      const int half = tid / (kThreads / 2);
      const int lo = half ? split : 0;
      const int hi = half ? cnt : split;
      for (int col = tid % (kThreads / 2); col < row; col += kThreads / 2) {
        for (int i0 = lo; i0 < hi; i0 += kWideRunBatch) {
          int rr[kWideRunBatch];
          float vv[kWideRunBatch];
#pragma unroll
          for (int u = 0; u < kWideRunBatch; ++u) {
            const int i = i0 + u;
            rr[u] = -1;
            vv[u] = 0.f;
            if (i < hi) {
              const int p = base + sidx[i];
              rr[u] = srow[i];
              vv[u] = col < d    ? to_float(xw[(size_t)p * d + col])
                      : col == d ? 1.f
                                 : dw[p];
            }
          }
#pragma unroll
          for (int u = 1; u < kWideRunBatch; ++u)
            if (rr[u] == rr[u - 1]) vv[u] += vv[u - 1];
          bool last[kWideRunBatch];
          float a[kWideRunBatch];
#pragma unroll
          for (int u = 0; u < kWideRunBatch; ++u) {
            last[u] = rr[u] >= 0 && (u + 1 == kWideRunBatch || rr[u + 1] != rr[u]);
            a[u] = last[u] ? slab[(size_t)rr[u] * row + col] : 0.f;
          }
#pragma unroll
          for (int u = 0; u < kWideRunBatch; ++u)
            if (last[u]) slab[(size_t)rr[u] * row + col] = a[u] + vv[u];
        }
      }
    }
  }
}

// Blocks a worker of the sums pass: 2 a SM, at most one a 64-point tile,
// at most kWideSlabBudget / slab bytes (at least 1). Negative: a CUDA
// error code.
int wide_grid(int n, int d, int k) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -(int)err;
  long long g = (long long)kSumsBlocksPerSM * sms;
  const long long tiles = (n + (long long)kTile - 1) / kTile;
  const long long cap = kWideSlabBudget / (4LL * k * (d + 2));
  if (g > tiles) g = tiles;
  if (g > cap) g = cap;
  return g < 1 ? 1 : (int)g;
}

template <typename T>
int launch_wide(const void* x, const void* c, void* c2, void* asg,
                void* dist, void* ws, void* sums, void* counts, void* cost,
                int w, int n, int d, int k, int valid_k, int c_per_worker,
                int grid_g, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = c_per_worker ? w * k : k;
  kmeans_norms_kernel<<<(rows + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      static_cast<const float*>(c), static_cast<float*>(c2), rows, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int tiles = (n + kAPoints - 1) / kAPoints;
  if (tiles > 0) {
    kmeans_assign_kernel<T><<<dim3(tiles, w), kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(c),
        static_cast<const float*>(c2), static_cast<int*>(asg),
        static_cast<float*>(dist), n, d, k, valid_k, c_per_worker);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  kmeans_wide_sums_kernel<T><<<dim3(grid_g, w), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const int*>(asg),
      static_cast<const float*>(dist), static_cast<float*>(ws), n, d, k);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int nb = (k * (d + 2) + kReduceThreads - 1) / kReduceThreads;
  kmeans_reduce_kernel<<<dim3(nb + 1, w), kReduceThreads, 0, s>>>(
      static_cast<const float*>(ws), static_cast<float*>(sums),
      static_cast<float*>(counts), static_cast<float*>(cost), d, k, grid_g);
  return (int)cudaGetLastError();
}

template <typename T>
using StatsKernel = void (*)(const T*, const float*, float*, int, int, int,
                             int, int);

template <typename T>
StatsKernel<T> pick(int valid_k) {
  switch (centroids_per_thread(valid_k)) {
    case 2: return kmeans_stats_kernel<T, 2>;
    case 4: return kmeans_stats_kernel<T, 4>;
    case 7: return kmeans_stats_kernel<T, 7>;
    default: return kmeans_stats_kernel<T, 8>;
  }
}

template <typename T>
cudaError_t prepare(StatsKernel<T> kern, int d, int k, size_t* bytes) {
  *bytes = smem_floats(d, k) * sizeof(float);
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*bytes);
}

template <typename T>
int grid_size(int n, int d, int k, int valid_k) {
  const StatsKernel<T> kern = pick<T>(valid_k);
  size_t bytes = 0;
  cudaError_t err = prepare<T>(kern, d, k, &bytes);
  if (err != cudaSuccess) return -(int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return -(int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -(int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                      bytes);
  if (err != cudaSuccess) return -(int)err;
  if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
  const int tiles = (n + kTile - 1) / kTile;
  int g = per_sm * sms;
  if (g > tiles) g = tiles;
  return g < 1 ? 1 : g;
}

template <typename T>
int launch(const void* x, const void* c, void* ws, void* sums, void* counts,
           void* cost, int w, int n, int d, int k, int valid_k,
           int c_per_worker, int grid_g, void* stream) {
  const StatsKernel<T> kern = pick<T>(valid_k);
  size_t bytes = 0;
  cudaError_t err = prepare<T>(kern, d, k, &bytes);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kern<<<dim3(grid_g, w), kThreads, bytes, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(c),
      static_cast<float*>(ws), n, d, k, valid_k, c_per_worker);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nb = (k * (d + 2) + kReduceThreads - 1) / kReduceThreads;
  kmeans_reduce_kernel<<<dim3(nb + 1, w), kReduceThreads, 0, s>>>(
      static_cast<const float*>(ws), static_cast<float*>(sums),
      static_cast<float*>(counts), static_cast<float*>(cost), d, k, grid_g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs for (d, k).
long long kmeans_stats_smem_bytes(int d, int k) {
  return (long long)(smem_floats(d, k) * sizeof(float));
}

// Blocks per worker: resident blocks per SM times the SM count, at most
// one per tile, whatever the number of workers a launch holds. Negative: a
// CUDA error code.
int kmeans_stats_grid(int n, int d, int k, int valid_k, int bf16) {
  return bf16 ? grid_size<__nv_bfloat16>(n, d, k, valid_k)
              : grid_size<float>(n, d, k, valid_k);
}

// Launch the E-step and its reduction on ``stream``. Returns
// cudaGetLastError() after the launches (0 on success).
int kmeans_stats_launch(const void* x, const void* c, void* ws, void* sums,
                        void* counts, void* cost, int w, int n, int d, int k,
                        int valid_k, int c_per_worker, int grid_g, int bf16,
                        void* stream) {
  return bf16 ? launch<__nv_bfloat16>(x, c, ws, sums, counts, cost, w, n, d,
                                      k, valid_k, c_per_worker, grid_g, stream)
              : launch<float>(x, c, ws, sums, counts, cost, w, n, d, k,
                              valid_k, c_per_worker, grid_g, stream);
}

// The wide variant's sums-pass blocks a worker (the twin on the host side:
// pallas_kernels.kmeans_wide_plan). Negative: a CUDA error code.
int kmeans_stats_wide_grid(int n, int d, int k) { return wide_grid(n, d, k); }

// Launch the wide variant (norms, assign, sums, reduce) on ``stream``, with
// the workspaces the host allocated: c2 (rows of c), asg and dist (W, N),
// ws (W, grid_g, K, D+2). Returns cudaGetLastError() after the launches.
int kmeans_stats_wide_launch(const void* x, const void* c, void* c2,
                             void* asg, void* dist, void* ws, void* sums,
                             void* counts, void* cost, int w, int n, int d,
                             int k, int valid_k, int c_per_worker, int grid_g,
                             int bf16, void* stream) {
  return bf16 ? launch_wide<__nv_bfloat16>(x, c, c2, asg, dist, ws, sums,
                                           counts, cost, w, n, d, k, valid_k,
                                           c_per_worker, grid_g, stream)
              : launch_wide<float>(x, c, c2, asg, dist, ws, sums, counts,
                                   cost, w, n, d, k, valid_k, c_per_worker,
                                   grid_g, stream);
}

}  // extern "C"
