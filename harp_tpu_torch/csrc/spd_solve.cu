// Batched small SPD solve for Hopper (sm_90a): for each of N independent
// systems A x = b with A (K, K) symmetric positive definite, factor A = L L^T
// by the outer-product Cholesky, then solve L y = b and L^T x = y. All in
// float32. Three kernels: one warp a system in registers for K <= 64
// (spd_solve_kernel), one block a system in shared memory for 64 < K <= 338
// (spd_solve_block_kernel, after the first), and for a wider K a
// panel-blocked Cholesky on a workspace in device memory with the same
// arithmetic (spd_solve_global_kernel, last).
//
// Replaces: harp_tpu/ops/pallas_kernels.py::_chol_solve_kernel (the TPU
// kernel behind spd_solve_pallas). It computes the same function in the same
// order of steps: at step j the running Schur complement's column j, times
// rsqrt of its pivot, is column j of L (rows >= j), and the rank-1 update
// A <- A - l_j l_j^T follows; the forward substitution runs column by column
// beside the factorization (y_j = r_j / L[j][j], r <- r - l_j y_j, the
// kernel's order) and the back substitution row by row of L, from the last
// unknown up. Like the TPU kernel it reads only the lower triangle of A. It
// does not carry over the TPU layout move: the Pallas wrapper pads K to a
// multiple of 8 and N to a multiple of 256 with identity systems and
// transposes A to (K, K, N) so the batch lies on the 128 lanes, each a full
// extra pass over A. Here A is read as it is, (N, K, K) row-major, and the
// kernel masks K and the ragged end of N itself.
//
// What bounds it on this card: bytes. At the ALS flagship (N = 8192
// systems, K = 32) A is 33.55 MB and b and x 1.05 MB each, 35.65 MB over
// 3.35 TB/s = 10.6 us, against about (K^3 / 3 + 2 K^2) N = 1e8 multiply-adds
// (3.2 us of float32 operations at 67 TFLOP/s). At K = 64 the bytes are 4x
// (40 us) and the operations 8x.
//
// Design: one warp per system, several warps a block, a grid over N; no
// shared memory, no atomics, no sum across blocks, so two runs are bitwise
// equal. Lane r holds column r of the system in registers (K <= 32; lanes
// r and r + 32 for 33 <= K <= 64), so the warp reads A row by row, 32
// consecutive floats a load. Each lane keeps the symmetric mirror of the
// lower triangle: entry i of column r is A[i][r] for i >= r and A[r][i]
// above. The symmetric updates keep the running complement bitwise
// symmetric (fma(-l_i, l_r, a) is fma(-l_r, l_i, a)), so at step j every
// lane finds l_j at its own row, A[j][r] / sqrt(pivot), in its own
// registers; only l_j's other entries travel, one __shfl_sync each from the
// lane that owns column j. That is K (K + 1) / 2 shuffles a system for the
// factorization and K for each substitution. After step j lane j's column
// holds column j of L, and lane r's right-hand side holds y_r and then x_r.
// Rows are indexed at compile time only (registers, not local memory): at
// K <= 32 the steps are unrolled and only the lower triangle is computed;
// at K <= 64 the steps are a runtime loop that sweeps all rows under a
// predicate, twice the shuffles of the triangle but a small body (a full
// unroll there took nvcc over 100 s and still spilled the array to local
// memory). Making it fast (several systems a warp at small K, staging A
// through shared memory with cp.async) is later work.
//
// The host binding is a plain C interface loaded with ctypes
// (harp_tpu_torch/ops/_cuda_build.py).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// v[p] for a part index p (0 or 1) that may be a runtime value: a register
// select, never an indexed load from local memory.
template <int NC>
__device__ __forceinline__ float pick(const float (&v)[NC], int p) {
  return (NC == 1 || p == 0) ? v[0] : v[NC - 1];
}

// Row j of each of the lane's columns, for a row index j that may be a
// runtime value: a chain of selects over the compile-time rows, which folds
// to register reads when j is a compile-time constant.
template <int NC>
__device__ __forceinline__ void row_of(const float (&c)[NC][32 * NC], int j,
                                       float (&out)[NC]) {
#pragma unroll
  for (int q = 0; q < NC; ++q) out[q] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32 * NC; ++i) {
    if (i == j) {
#pragma unroll
      for (int q = 0; q < NC; ++q) out[q] = c[q][i];
    }
  }
}

// Step j of the factorization, with the forward substitution beside it.
template <int NC>
__device__ __forceinline__ void factor_step(float (&c)[NC][32 * NC],
                                            float (&r)[NC], int j, int k,
                                            int lane) {
  const int src = j & 31, part = j >> 5;   // column j: lane src, part part
  float cj[NC];
  row_of<NC>(c, j, cj);
  const float d = __shfl_sync(kFull, pick<NC>(cj, part), src);  // pivot
  const float dinv = 1.0f / sqrtf(d);
  const float ljj = d * dinv;                                   // L[j][j]
  const float yj = __shfl_sync(kFull, pick<NC>(r, part), src) / ljj;
  float mine[NC];                                               // l_j[col]
#pragma unroll
  for (int q = 0; q < NC; ++q) mine[q] = cj[q] * dinv;
#pragma unroll
  for (int i = 1; i < 32 * NC; ++i) {
    if (i > j && i < k) {
      float own[NC];
#pragma unroll
      for (int q = 0; q < NC; ++q) own[q] = c[q][i];
      const float t = __shfl_sync(kFull, pick<NC>(own, part), src) * dinv;
#pragma unroll
      for (int q = 0; q < NC; ++q)
        if (lane + 32 * q > j) c[q][i] = fmaf(-t, mine[q], c[q][i]);
    }
  }
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    const int col = lane + 32 * q;
    if (col == j) {                        // becomes column j of L
#pragma unroll
      for (int i = 0; i < 32 * NC; ++i)
        if (i >= j && i < k) c[q][i] *= dinv;
      r[q] = yj;
    } else if (col > j) {
      r[q] = fmaf(-mine[q], yj, r[q]);
    }
  }
}

// Step p of the back substitution L^T x = y: lane col holds L[p][col] for
// p >= col, and the owner of column p holds L[p][p].
template <int NC>
__device__ __forceinline__ void back_step(const float (&c)[NC][32 * NC],
                                          float (&r)[NC], int p, int lane) {
  const int src = p & 31, part = p >> 5;
  float cp[NC];
  row_of<NC>(c, p, cp);
  const float xp =
      __shfl_sync(kFull, pick<NC>(r, part) / pick<NC>(cp, part), src);
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    const int col = lane + 32 * q;
    if (col < p) r[q] = fmaf(-cp[q], xp, r[q]);
    else if (col == p) r[q] = xp;
  }
}

// NC columns a lane: K <= 32 * NC. At NC = 1 the steps are unrolled, so
// every row index is a compile-time constant and the loops over rows keep
// only the lower triangle; at NC = 2 the steps are a runtime loop over
// rows indexed through selects, which keeps the 128-entry register array in
// registers and the code small.
template <int NC>
__global__ void __launch_bounds__(kThreads)
spd_solve_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ x, long long n, int k) {
  constexpr int kMax = 32 * NC;
  const int lane = threadIdx.x & 31;
  const long long sys = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (sys >= n) return;                    // the whole warp leaves together
  const float* as = a + sys * k * k;
  const float* bs = b + sys * k;

  float c[NC][kMax];   // c[q][i]: row i of the lane's column lane + 32 q
  float r[NC];         // the lane's entry of the right-hand side
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    const int col = lane + 32 * q;
    r[q] = col < k ? bs[col] : 0.0f;
#pragma unroll
    for (int i = 0; i < kMax; ++i) {
      float v = 0.0f;
      if (i < k && col < k) v = as[i >= col ? i * k + col : col * k + i];
      c[q][i] = v;
    }
  }

  if constexpr (NC == 1) {
#pragma unroll
    for (int j = 0; j < kMax; ++j)
      if (j < k) factor_step<NC>(c, r, j, k, lane);
#pragma unroll
    for (int p = kMax - 1; p >= 0; --p)
      if (p < k) back_step<NC>(c, r, p, lane);
  } else {
#pragma unroll 1
    for (int j = 0; j < k; ++j) factor_step<NC>(c, r, j, k, lane);
#pragma unroll 1
    for (int p = k - 1; p >= 0; --p) back_step<NC>(c, r, p, lane);
  }
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    const int col = lane + 32 * q;
    if (col < k) x[sys * k + col] = r[q];
  }
}

// ---------------------------------------------------------------------------
// One block a system, 64 < K <= 338.
//
// Above K = 64 a system no longer fits one warp's registers, so a block holds
// it in shared memory: the packed lower triangle of A (row i at i (i + 1) / 2,
// K (K + 1) / 2 floats), the right-hand side and column j of L, which fit the
// 232,448 bytes a block may use up to K = 338 (block_smem_floats; the host's
// twin is pallas_kernels.spd_solve_block_smem_bytes). The steps are the TPU
// kernel's, in its order, each ended by a __syncthreads():
//   1. step j of the outer-product Cholesky: every thread reads the pivot,
//      the threads over rows i >= j scale the Schur complement's column j by
//      1 / sqrt(pivot) into column j of L (kept in place and copied to lc)
//      and take the forward substitution's r_i -= L[i][j] y_j beside it;
//      then the rank-1 update of the unfinished triangle, a[i][m] -=
//      L[i][j] L[m][j] for j < m <= i: a warp a row, its lanes over m, so a
//      warp's reads and writes are 32 consecutive floats (no bank conflict)
//      and L[i][j] is a register;
//   2. y_i = r_i / L[i][i] for every i at once: no step after step i
//      changes r_i, so this is the TPU kernel's y_i, which it divides out
//      at step i (step j also needs y_j for its own update, and each
//      thread computes it the same way);
//   3. the back substitution row by row of L from the last unknown:
//      x_p = y_p / L[p][p], then r_i -= L[p][i] x_p for i < p.
// Like the warp kernel it reads A as it is, (N, K, K) row-major, only its
// lower triangle, and uses no atomics: two runs are bitwise equal.
//
// What bounds it on this card: operations, in the bound's count. At N = 8192
// and K = 128 the Cholesky and the substitutions are (2 K^3 / 3 + 4 K^2) N =
// 1.2e10 float32 operations (0.18 ms at 67 TFLOP/s) against 0.08 ms of the
// lower triangle's bytes. The kernel is held instead by shared memory: each
// multiply-add of the update reads and writes a[i][m] and reads L[m][j], so
// it runs at about a third of the shared-memory rate, and by the 3 K
// barriers of one block. A register-tiled update is later work.
// ---------------------------------------------------------------------------

constexpr int kBlockThreads = 256;
constexpr int kBlockWarps = kBlockThreads / 32;

__host__ __device__ __forceinline__ int tri(int i) { return i * (i + 1) / 2; }

__host__ __device__ __forceinline__ size_t block_smem_floats(int k) {
  return (size_t)k * (k + 1) / 2 + 2 * (size_t)k;
}

__global__ void __launch_bounds__(kBlockThreads)
spd_solve_block_kernel(const float* __restrict__ a,
                       const float* __restrict__ b, float* __restrict__ x,
                       int k) {
  extern __shared__ float smem[];
  float* t = smem;              // the packed lower triangle, then L
  float* r = t + tri(k);        // b, then y
  float* lc = r + k;            // column j of L at step j, then x
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long sys = blockIdx.x;
  const float* as = a + sys * k * k;

  for (int i = warp; i < k; i += kBlockWarps) {
    const float* row = as + (size_t)i * k;
    float* dst = t + tri(i);
    for (int m = lane; m <= i; m += 32) dst[m] = row[m];
  }
  for (int i = tid; i < k; i += kBlockThreads) r[i] = b[sys * k + i];
  __syncthreads();

  for (int j = 0; j < k; ++j) {
    const float d = t[tri(j) + j];
    const float dinv = 1.0f / sqrtf(d);
    const float ljj = d * dinv;                 // L[j][j]
    const float yj = r[j] / ljj;
    for (int i = j + tid; i < k; i += kBlockThreads) {
      const float l = i == j ? ljj : t[tri(i) + j] * dinv;
      lc[i] = l;
      if (i > j) {
        t[tri(i) + j] = l;
        r[i] = fmaf(-l, yj, r[i]);
      }
    }
    __syncthreads();
    if (tid == 0) t[tri(j) + j] = ljj;          // nobody reads it below
    for (int i = j + 1 + warp; i < k; i += kBlockWarps) {
      const float li = lc[i];
      float* row = t + tri(i);
      for (int m = j + 1 + lane; m <= i; m += 32)
        row[m] = fmaf(-li, lc[m], row[m]);
    }
    __syncthreads();
  }

  for (int i = tid; i < k; i += kBlockThreads) r[i] = r[i] / t[tri(i) + i];
  __syncthreads();
  for (int p = k - 1; p >= 0; --p) {
    const float* row = t + tri(p);              // row p of L
    const float xp = r[p] / row[p];
    if (tid == 0) lc[p] = xp;
    for (int i = tid; i < p; i += kBlockThreads)
      r[i] = fmaf(-row[i], xp, r[i]);
    __syncthreads();
  }
  for (int i = tid; i < k; i += kBlockThreads) x[sys * k + i] = lc[i];
}

// ---------------------------------------------------------------------------
// K > 338: a panel-blocked Cholesky, the triangle in device memory.
//
// Past K = 338 the packed lower triangle no longer fits one block's shared
// memory, so it lives in a workspace in device memory, one triangle a
// resident block: the grid is persistent (each block loops over systems
// blockIdx.x, blockIdx.x + grid, ...; spd_solve_global_grid, the card's
// resident blocks, at most N), so the workspace is at most half of A's bytes.
// The first panel reads A itself; every later read is of the workspace, which
// ends holding L. The factorization runs over panels of kPanel = nb columns
// [j0, j0 + nb), each in three steps, with a barrier after each:
//   (a) the nb x nb diagonal block, staged through shared memory, is
//       factored by one warp, nb / 32 rows a lane in registers, with the
//       one-block kernel's step arithmetic (d, dinv = 1 / sqrtf(d), ljj =
//       d dinv, l = a dinv; the rank-1 update of the rest of the block,
//       l_mj by a shuffle from the lane of row m), the forward substitution
//       of its rows beside it (y_j = r_j / ljj, r_q -= l_qj y_j); then its
//       L goes back to the workspace and, transposed, to shared memory for
//       (b);
//   (b) the panel rows below it: a thread a row, the row's nb entries in
//       registers, right-looking over the panel's columns (l_ij = a_ij
//       dinv_j, then a_im -= l_ij l_mj for the panel's m > j, and r_i -=
//       l_ij y_j), each row independent of the others;
//   (c) the trailing lower triangle, rows and columns >= j0 + nb, in 64 x 64
//       tiles: a thread holds a 4 x 4 register tile of it (rows 4 ty ..,
//       columns tx + 16 c, so a warp's loads and stores are 16 consecutive
//       floats of a row), the tile's two 64-row blocks of the panel's L are
//       staged in shared memory (4 threads a row, columns interleaved, so
//       the transposed stores hit 32 banks), and each element gets the
//       panel's nb updates in ascending j.
// Each element of the triangle thus gets exactly the one-block kernel's
// chain, a_im = fmaf(-l_ij, l_mj, a_im) for j = 0, 1, ... in order, and r
// its forward chain, so L, y and x are that kernel's bit for bit wherever
// both run (no atomics, no TF32; two runs are bitwise equal). The back
// substitution runs over the same panels from the last: one warp solves the
// panel's unknowns (x_p = r_p / L[p][p], r_q -= L[p][q] x_p, p descending,
// r_p by a shuffle),
// then every thread takes the panel's nb updates of one unknown above it, p
// descending: each r_i gets the one-block kernel's chain, and x goes to
// device memory as its panel is solved.
//
// What bounds it: the bound's count is the one-block kernel's (operations at
// these widths). The trailing triangle is read and written once a panel, not
// once a column: about K^3 / (6 nb) element read-modify-writes a system
// instead of K^3 / 6, and 3 + 2 t barriers a panel with t its trailing
// tiles instead of 3 a column. nb = 32 was measured against 64 on the card
// (PERF.md): at 64 the warp's step (a) holds two 64-float rows a lane and
// step (b) 64 floats a thread, which spill (255 registers and a 512-byte
// stack frame), and it is slower at every K timed. The workspace's traffic
// no longer holds it: the serial steps (a), (b) and the back substitution
// (one warp, or one row a thread, between barriers) take about as long as
// the trailing products. Shared memory: b, then y and x (K floats), and the
// panel's staging area (global_stage_floats, 4,416 floats), which would take
// K past 52,000; SPD_MAX_K_GLOBAL = 29,056 stays the stated limit.
// ---------------------------------------------------------------------------

__host__ __device__ __forceinline__ long long tri_ll(long long i) {
  return i * (i + 1) / 2;
}

constexpr int kPanel = 32;             // nb: the columns of a panel
constexpr int kTile = 64;              // trailing tiles are kTile x kTile
constexpr int kTileLd = kTile + 4;     // a staged row block, transposed
static_assert(kBlockThreads == 256 && kTile == 64,
              "a 16 x 16 thread grid, 4 x 4 elements a thread; 4 threads "
              "stage each of a tile's 64 rows");
static_assert(kPanel % 32 == 0, "whole warps over a panel's columns");

// Floats of the staging area: the diagonal block (nb x (nb + 1)) and its L
// transposed (nb x nb) in (a) and (b), or the two staged row blocks of (c)
// (2 x nb x kTileLd), whichever is larger; then dinv and y of the panel.
__host__ __device__ constexpr int global_stage_floats() {
  return (kPanel * (kPanel + 1) + kPanel * kPanel > 2 * kPanel * kTileLd
              ? kPanel * (kPanel + 1) + kPanel * kPanel
              : 2 * kPanel * kTileLd) +
         2 * kPanel;
}

__host__ __device__ __forceinline__ size_t global_smem_floats(int k) {
  return (size_t)((k + 3) & ~3) + global_stage_floats();
}

__global__ void __launch_bounds__(kBlockThreads)
spd_solve_global_kernel(const float* __restrict__ a,
                        const float* __restrict__ b, float* __restrict__ x,
                        float* ws, long long n, int k) {
  constexpr int nb = kPanel, ld = kPanel + 1;
  constexpr int kRows = nb / 32;  // the diagonal block's rows a lane
  extern __shared__ float4 smem4[];
  float* r = reinterpret_cast<float*>(smem4);   // b, then y, then x's work
  float* st = r + ((k + 3) & ~3);
  float* dg = st;                 // (a): the diagonal block, [q][m], ld
  float* lt = st + nb * ld;       // (a)-(b): its L transposed, lt[j][m]
  float* li = st;                 // (c): the tile's rows' L, [j][row]
  float* lm = st + nb * kTileLd;  // (c): its columns' L, [j][perm(col)]
  float* dv = st + global_stage_floats() - 2 * nb;   // the panel's dinv
  float* yv = dv + nb;                               // its y, then its x
  float* t = ws + (size_t)blockIdx.x * tri_ll(k);    // the triangle, then L
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;

  for (long long sys = blockIdx.x; sys < n; sys += gridDim.x) {
    const float* as = a + sys * k * k;
    for (int i = tid; i < k; i += kBlockThreads) r[i] = b[sys * k + i];

    for (int j0 = 0; j0 < k; j0 += nb) {
      const int nbp = min(nb, k - j0);
      // row i's entries: A in the first panel, the workspace after it
      auto src = [&](int i) -> const float* {
        return j0 == 0 ? as + (size_t)i * k : t + tri_ll(i);
      };

      // (a) the diagonal block
      __syncthreads();            // the last panel's staged rows are read
      for (int e = tid; e < nb * nb; e += kBlockThreads) {
        const int q = e / nb, m = e % nb;
        if (q < nbp && m <= q) dg[q * ld + m] = src(j0 + q)[j0 + m];
      }
      __syncthreads();
      if (warp == 0) {            // rows j0 + lane + 32 u, in registers
        float row[kRows][nb], rq[kRows], yq[kRows];
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          const int q = lane + 32 * u;
#pragma unroll
          for (int m = 0; m < nb; ++m)
            row[u][m] = q < nbp && m <= q ? dg[q * ld + m] : 0.f;
          rq[u] = q < nbp ? r[j0 + q] : 0.f;
          yq[u] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < nb; ++j) {
          if (j < nbp) {
            const float d = __shfl_sync(kFull, row[j / 32][j], j % 32);
            const float dinv = 1.0f / sqrtf(d);
            const float ljj = d * dinv;           // L[j][j]
            const float yj = __shfl_sync(kFull, rq[j / 32], j % 32) / ljj;
            float l[kRows];                       // l_qj below the pivot
#pragma unroll
            for (int u = 0; u < kRows; ++u) {
              const int q = lane + 32 * u;
              l[u] = row[u][j] * dinv;
              if (q > j) {
                row[u][j] = l[u];
                rq[u] = fmaf(-l[u], yj, rq[u]);
              } else if (q == j) {
                row[u][j] = ljj;
                yq[u] = yj;
                dv[j] = dinv;
                yv[j] = yj;
              }
            }
#pragma unroll
            for (int m = j + 1; m < nb; ++m) {   // a_qm -= l_qj l_mj
              const float lm = __shfl_sync(kFull, l[m / 32], m % 32);
#pragma unroll
              for (int u = 0; u < kRows; ++u)
                if (lane + 32 * u >= m) row[u][m] = fmaf(-l[u], lm, row[u][m]);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          const int q = lane + 32 * u;
          if (q < nbp) {
            r[j0 + q] = yq[u];
            float* o = t + tri_ll(j0 + q) + j0;
#pragma unroll
            for (int m = 0; m < nb; ++m)
              if (m <= q) o[m] = row[u][m];
          }
#pragma unroll
          for (int j = 0; j < nb; ++j)          // lt[j][q] = l_qj
            lt[j * nb + q] = q > j && q < nbp ? row[u][j] : 0.f;
        }
      }
      __syncthreads();

      // (b) the panel rows below it (only a full panel has any)
      for (int i = j0 + nb + tid; i < k; i += kBlockThreads) {
        const float* s = src(i) + j0;
        float row[nb];
#pragma unroll
        for (int m = 0; m < nb; ++m) row[m] = s[m];
        float ri = r[i];
#pragma unroll
        for (int j = 0; j < nb; ++j) {
          const float l = row[j] * dv[j];
          row[j] = l;
          ri = fmaf(-l, yv[j], ri);
#pragma unroll
          for (int m4 = (j + 1) / 4; m4 < nb / 4; ++m4) {
            const float4 w = *reinterpret_cast<const float4*>(lt + j * nb +
                                                              4 * m4);
            const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (4 * m4 + e > j)
                row[4 * m4 + e] = fmaf(-l, wv[e], row[4 * m4 + e]);
          }
        }
        float* o = t + tri_ll(i) + j0;
#pragma unroll
        for (int m = 0; m < nb; ++m) o[m] = row[m];
        r[i] = ri;
      }

      // (c) the trailing lower triangle, rows and columns >= s0
      const int s0 = j0 + nb;
      const int nt = s0 < k ? (k - s0 + kTile - 1) / kTile : 0;
      int ti = 0, tm = 0;
      for (int tile = 0; tile < nt * (nt + 1) / 2; ++tile) {
        const int i0 = s0 + ti * kTile, m0 = s0 + tm * kTile;
        float acc[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + ty * 4 + u;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int m = m0 + tx + 16 * c;
            acc[u][c] = i < k && m <= i ? src(i)[m] : 0.f;
          }
        }
        __syncthreads();          // (b) or the last tile is done with st
        {                         // 4 threads a row, columns jq + 4 q
          const int rr = tid >> 2, jq = tid & 3;
          const int ii = i0 + rr, mm = m0 + rr;
          const float* pi = t + tri_ll(ii) + j0 + jq;
          const float* pm = t + tri_ll(mm) + j0 + jq;
          float* di = li + jq * kTileLd + rr;
          float* dm = lm + jq * kTileLd + (rr & 15) * 4 + (rr >> 4);
#pragma unroll
          for (int q = 0; q < nb / 4; ++q) {
            di[4 * q * kTileLd] = ii < k ? pi[4 * q] : 0.f;
            dm[4 * q * kTileLd] = mm < k ? pm[4 * q] : 0.f;
          }
        }
        __syncthreads();
#pragma unroll 8
        for (int j = 0; j < nb; ++j) {
          const float4 u4 =
              *reinterpret_cast<const float4*>(li + j * kTileLd + ty * 4);
          const float4 v4 =
              *reinterpret_cast<const float4*>(lm + j * kTileLd + tx * 4);
          const float ua[4] = {u4.x, u4.y, u4.z, u4.w};
          const float va[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[u][c] = fmaf(-ua[u], va[c], acc[u][c]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + ty * 4 + u;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int m = m0 + tx + 16 * c;
            if (i < k && m <= i) t[tri_ll(i) + m] = acc[u][c];
          }
        }
        if (++tm > ti) {
          ++ti;
          tm = 0;
        }
      }
    }

    // the back substitution L^T x = y, panel by panel from the last
    for (int p1 = k; p1 > 0;) {
      const int p0 = (p1 - 1) / nb * nb, nbp = p1 - p0;
      __syncthreads();            // the last panel's y / x and r are read
      for (int e = tid; e < nb * nb; e += kBlockThreads) {
        const int q = e / nb, m = e % nb;
        if (q < nbp && m <= q) dg[q * ld + m] = t[tri_ll(p0 + q) + p0 + m];
      }
      __syncthreads();
      if (warp == 0) {            // unknowns p0 + lane + 32 u
        float rq[kRows];
#pragma unroll
        for (int u = 0; u < kRows; ++u)
          rq[u] = lane + 32 * u < nbp ? r[p0 + lane + 32 * u] : 0.f;
#pragma unroll
        for (int p = nb - 1; p >= 0; --p) {
          if (p < nbp) {
            const float xp =
                __shfl_sync(kFull, rq[p / 32], p % 32) / dg[p * ld + p];
#pragma unroll
            for (int u = 0; u < kRows; ++u) {
              const int q = lane + 32 * u;
              if (q < p) rq[u] = fmaf(-dg[p * ld + q], xp, rq[u]);
              else if (q == p) yv[p] = xp;
            }
          }
        }
      }
      __syncthreads();
      for (int i = tid; i < p0; i += kBlockThreads) {
        float ri = r[i];
        for (int p = nbp - 1; p >= 0; --p)
          ri = fmaf(-t[tri_ll(p0 + p) + i], yv[p], ri);
        r[i] = ri;
      }
      for (int q = tid; q < nbp; q += kBlockThreads)
        x[sys * k + p0 + q] = yv[q];
      p1 = p0;
    }
  }
}

}  // namespace

extern "C" {

// Solve the n systems on `stream` with the one-warp kernel: a (n, k, k),
// b (n, k), x (n, k), float32, contiguous, 1 <= k <= 64 (checked by the
// caller). Returns cudaGetLastError() after the launch (0 on success).
int spd_solve_launch(const void* a, const void* b, void* x, long long n,
                     int k, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long grid = (n + kWarps - 1) / kWarps;
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  float* xf = static_cast<float*>(x);
  if (k <= 32)
    spd_solve_kernel<1><<<(unsigned)grid, kThreads, 0, s>>>(af, bf, xf, n, k);
  else
    spd_solve_kernel<2><<<(unsigned)grid, kThreads, 0, s>>>(af, bf, xf, n, k);
  return (int)cudaGetLastError();
}

// Bytes of dynamic shared memory one block of the one-block kernel needs.
long long spd_solve_block_smem_bytes(int k) {
  return (long long)(block_smem_floats(k) * sizeof(float));
}

// Solve the n systems on `stream` with the one-block kernel, one block a
// system: the same operands, 64 < k <= 338 (checked by the caller; a k whose
// triangle does not fit fails with the launch). Returns cudaGetLastError()
// after the launch (0 on success).
int spd_solve_block_launch(const void* a, const void* b, void* x,
                           long long n, int k, void* stream) {
  if (n == 0) return 0;
  if (n > INT_MAX) return (int)cudaErrorInvalidValue;
  const size_t bytes = block_smem_floats(k) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      spd_solve_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  spd_solve_block_kernel<<<(unsigned)n, kBlockThreads, bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(x), k);
  return (int)cudaGetLastError();
}

// Blocks of the global-memory kernel's persistent grid for n systems of
// rank k on the current device: the resident blocks, at most n. A negative
// value is a CUDA error, negated.
int spd_solve_global_grid(long long n, int k) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t bytes = global_smem_floats(k) * sizeof(float);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(spd_solve_global_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, spd_solve_global_kernel, kBlockThreads, bytes);
  if (e != cudaSuccess) return -(int)e;
  long long grid = (long long)sms * per_sm;
  if (grid > n) grid = n;
  return grid < 1 ? 1 : (int)grid;
}

// Solve the n systems on `stream` with the global-memory kernel: the same
// operands, k > 338 (checked by the caller; any k >= 1 runs), on `grid`
// blocks (spd_solve_global_grid) with ws (grid, k (k + 1) / 2) float32. Returns
// cudaGetLastError() after the launch (0 on success).
int spd_solve_global_launch(const void* a, const void* b, void* x, void* ws,
                            long long n, int k, int grid, void* stream) {
  if (n == 0) return 0;
  if (grid < 1) return (int)cudaErrorInvalidValue;
  const size_t bytes = global_smem_floats(k) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      spd_solve_global_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  spd_solve_global_kernel<<<(unsigned)grid, kBlockThreads, bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(x), static_cast<float*>(ws), n, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
