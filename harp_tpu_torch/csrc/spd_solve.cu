// Batched small SPD solve for Hopper (sm_90a): for each of N independent
// systems A x = b with A (K, K) symmetric positive definite, factor A = L L^T
// by the outer-product Cholesky, then solve L y = b and L^T x = y. All in
// float32. One kernel for each of three ranges of K (the host routes,
// pallas_kernels.spd_solve_variant):
//   K <= 32        4 or 8 lanes a system, up to four rows a lane in
//                  registers (spd_solve_kernel<K>);
//   33 <= K <= 307 one block a system, the packed triangle resident in
//                  shared memory, a panel-blocked Cholesky
//                  (spd_solve_block_kernel);
//   K > 307        a panel-blocked Cholesky on a triangle in device memory
//                  (spd_solve_global_kernel).
// The last two are separate code with the same chains of operations, so
// wherever both take a K their x is the same bit for bit.
//
// Replaces: harp_tpu/ops/pallas_kernels.py::_chol_solve_kernel (the TPU
// kernel behind spd_solve_pallas). It computes the same function in the same
// order of steps: at step j the running Schur complement's column j, times
// 1 / sqrt of its pivot, is column j of L (rows >= j), and the rank-1 update
// A <- A - l_j l_j^T follows; the forward substitution runs column by column
// beside the factorization (y_j = r_j / L[j][j], r <- r - l_j y_j, the
// kernel's order) and the back substitution row by row of L, from the last
// unknown up. Like the TPU kernel it reads only the lower triangle of A. It
// does not carry over the TPU layout move: the Pallas wrapper pads K to a
// multiple of 8 and N to a multiple of 256 with identity systems and
// transposes A to (K, K, N) so the batch lies on the 128 lanes, each a full
// extra pass over A. Here A is read as it is, (N, K, K) row-major, and the
// kernels mask K and the ragged end of N themselves.
//
// What bounds it on this card: bytes at the ALS flagship (N = 8192 systems,
// K = 32: A's lower triangle 17 MB and b and x 1 MB each, about 6.9 us at
// 3.35 TB/s, against 1e8 multiply-adds); from K = 128 on, operations
// ((K^3 / 3 + 2 K^2) N float32 operations at 67 TFLOP/s). What holds the
// kernels above that bound is the serial chain of the Cholesky: K pivots,
// each a square root and a reciprocal that the next column waits for, and K
// divisions of the back substitution, each waiting on the one before.
//
// The host binding is a plain C interface loaded with ctypes
// (harp_tpu_torch/ops/_cuda_build.py).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int tri(int i) { return i * (i + 1) / 2; }

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// ---------------------------------------------------------------------------
// K <= 32: a group of lanes a system, its rows in registers
// (spd_solve_kernel<K>, one instance a K).
//
// G lanes solve one system (warp_group: 8 from K = 9, 4 below), 32 / G
// systems a warp; lane q of a group holds rows q, q + G, ... of its system
// (warp_rows: K / G rounded up, 1 to 4). Each group has its own slot of
// shared memory and its own shuffles (width G), so no system touches
// another's numbers. What holds a system is its serial chain: at every
// step of the factorization two shuffles, a square root and two
// divisions, and at every step of the back substitution a division and a
// shuffle, each with its range checks, which every lane of the warp
// issues; with several rows a lane, 4 or 8 systems share each of those
// instructions, where a row a lane would give one system a warp at K = 32.
//
// A persistent grid of blocks of 4 warps (2 past K = 24; the resident
// blocks, at most the warps the systems need; spd_solve_warp_per_sm) walks
// over the systems, a warp's turns t, t + warps, ... A slot is one system's K rows at a pitch
// of K rounded up to an odd number of float4s (warp_pitch), the slot G
// floats past a multiple of 32 so the groups of a warp lie G banks apart.
// cp.async copies the system's lower-triangle rows into it (4 bytes a
// lane, a row an instruction: consecutive floats), and each lane reads its
// rows back as float4s. Then the slot becomes the L area: at step j row j
// of the slot takes column j of L. When a lane has read its columns of L
// back for the back substitution, the slot takes the next system's rows,
// whose copies run beside this system's back substitution; b comes by
// plain loads at the same time, a register a row.
//
// Lane q's row rho holds row rho of the running Schur complement: entries
// i <= rho, and past rho numbers that are never read (the updates run over
// every entry without a predicate), with its diagonal also on its own in
// dq, so that the next pivot waits on one update of a step, not on the
// row's. At step j the pivot d comes from row j's lane by a shuffle; dinv =
// 1 / sqrtf(d), ljj = d dinv, l_rho,j = a_rho,j dinv; each lane sets out
// its l_rho,j in row j of the slot and, after a __syncwarp, reads l_j's
// entries i > j back four at a time (float4 broadcasts) for a_rho,i =
// fmaf(-l_ij, l_rho,j, a_rho,i). The forward substitution runs beside: y_j
// = r_j / ljj (r_j from row j's lane), r_rho = fmaf(-l_rho,j, y_j, r_rho).
// These are the chains of operations of a Cholesky that keeps a column of
// the complement a lane and sends l_j's entries by shuffles from lane j's
// column: the complement stays bitwise symmetric (fma(-l_i, l_q, a) is
// fma(-l_q, l_i, a)), so row i's own l_ij is the number lane j would send.
// The back substitution L^T x = y takes column rho of L (row rho of the
// slot) for unknown rho: x_p = r_p / L[p][p] (divided in unknown p's lane,
// which sends it by a shuffle), r_rho = fmaf(-L[p][rho], x_p, r_rho), p
// descending. No atomics and no sum across
// lanes: two runs are bitwise equal, and a system's x does not depend on
// its neighbours or on N.
// ---------------------------------------------------------------------------

// Lanes that solve one system at rank k, and rows a lane (K / G rounded
// up: 1 or 2 at G = 4, 2 to 4 at G = 8).
__host__ __device__ constexpr int warp_group(int k) {
  return k > 8 ? 8 : 4;
}
__host__ __device__ constexpr int warp_rows(int k) {
  return (k + warp_group(k) - 1) / warp_group(k);
}

// Row pitch of a slot, floats: k rounded up to an odd number of float4s
// (the 8 rows 8 lanes read at once lie in 8 different bank quads).
__host__ __device__ constexpr int warp_pitch(int k) {
  return (((k + 3) / 4) | 1) * 4;
}

// Floats of one group's slot: k rows at warp_pitch, rounded up to G floats
// past a multiple of 32.
__host__ __device__ constexpr int warp_slot_floats(int k) {
  return ((k * warp_pitch(k) - warp_group(k) + 31) / 32) * 32 +
         warp_group(k);
}

// Warps a block: 2 past K = 24, whose four rows a lane take up to 232
// registers a thread and 4 warps' slots would pass the 48 KB of static
// shared memory a block; 4 below.
__host__ __device__ constexpr int warp_block_warps(int k) {
  return k > 24 ? 2 : 4;
}

// Shared memory of one block at rank k, floats.
__host__ __device__ constexpr int warp_block_floats(int k) {
  return warp_block_warps(k) * (32 / warp_group(k)) * warp_slot_floats(k);
}

// Resident blocks an SM each instance is built for: its register cap
// (65,536 / threads / blocks), the largest at which ptxas spills nothing
// (an H100 build): 64 registers to K = 12, 80 to 16, 128 to 23, 168 at
// K = 24, 255 past it.
__host__ __device__ constexpr int warp_min_blocks(int k) {
  return k > 24 ? 4 : k == 24 ? 3 : k > 16 ? 4 : k > 12 ? 6 : 8;
}

// cp.async of the lower-triangle rows of a system (src = A + q) into its
// slot s (row i at i * P), entries q, q + G, ... of every row a lane; then
// the commit of this lane's group of copies.
template <int K>
__device__ __forceinline__ void warp_stage(const float* src, int q,
                                           float* s, bool live) {
  constexpr int G = warp_group(K), R = warp_rows(K), P = warp_pitch(K);
  if (live) {
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int e = 0; e < R; ++e)
        if (G * e <= i && q + G * e <= i)
          cp_async4(s + i * P + q + G * e, src + i * K + G * e);
  }
  cp_async_commit();
}

template <int K>
__global__ void __launch_bounds__(32 * warp_block_warps(K),
                                  warp_min_blocks(K))
spd_solve_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ x, long long n) {
  constexpr int G = warp_group(K), R = warp_rows(K), P = warp_pitch(K);
  constexpr int SPW = 32 / G;                // systems a warp
  constexpr int W = warp_block_warps(K);     // warps a block
  constexpr int N4 = (K + 3) / 4;            // float4s of a row
  __shared__ __align__(16) float smem[warp_block_floats(K)];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = lane % G, grp = lane / G;
  float* const s = smem + (warp * SPW + grp) * warp_slot_floats(K);
  // turns of the warps: an int (the host checks), a system's index a long
  const int tasks = (int)((n + SPW - 1) / SPW);
  const int step = gridDim.x * W;
  int t = blockIdx.x * W + warp;
  if (t >= tasks) return;                    // the whole warp leaves together

  // lane q's rows: q + G r (rho[r]; the row it reads, clamped to K - 1)
  int rho[R], row[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    rho[r] = q + G * r;
    row[r] = rho[r] < K ? rho[r] : K - 1;
  }
  float rr[R], bn[R];
  auto fetch = [&](int task) {               // copies of task's system
    const long long sys = (long long)task * SPW + grp;
    const bool live = sys < n;
    warp_stage<K>(a + sys * (K * K) + q, q, s, live);
#pragma unroll
    for (int r = 0; r < R; ++r)
      bn[r] = live && rho[r] < K ? b[sys * K + rho[r]] : 0.0f;
  };
  fetch(t);
  for (;;) {
    cp_async_wait_all();
    __syncwarp();
    // row rho[r] of the system: c[r][i], entries i < (r + 1) G read
    float c[R][K], dq[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      rr[r] = bn[r];
#pragma unroll
      for (int m = 0; m < N4 && 4 * m < G * (r + 1); ++m) {
        const float4 w = *reinterpret_cast<const float4*>(s + row[r] * P +
                                                          4 * m);
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (4 * m + e < K) c[r][4 * m + e] = wv[e];
      }
      dq[r] = s[row[r] * P + row[r]];
    }
    __syncwarp();                            // the slot's rows are read

#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int rj = j / G, qj = j % G;      // row j: lane qj's row rj
      const float d = __shfl_sync(kFull, dq[rj], qj, G);     // pivot
      const float dinv = 1.0f / sqrtf(d);
      const float ljj = d * dinv;                            // L[j][j]
      const float yj = __shfl_sync(kFull, rr[rj], qj, G) / ljj;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (G * (r + 1) <= j) continue;      // every row of r is done
        c[r][j] *= dinv;                     // l_rho,j (row j: ljj)
        dq[r] = fmaf(-c[r][j], c[r][j], dq[r]);
        if (rho[r] < K) s[j * P + rho[r]] = c[r][j];
      }
      if (j + 1 < K) {
        __syncwarp();                        // row j of the slot is set
#pragma unroll
        for (int m = (j + 1) / 4; m < N4; ++m) {
          const float4 w = *reinterpret_cast<const float4*>(s + j * P + 4 * m);
          const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * m + e;
#pragma unroll
            for (int r = 0; r < R; ++r)
              if (i > j && i < K && i < G * (r + 1))
                c[r][i] = fmaf(-wv[e], c[r][j], c[r][i]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (G * (r + 1) <= j) continue;
        if (rho[r] > j) rr[r] = fmaf(-c[r][j], yj, rr[r]);
        else if (rho[r] == j) rr[r] = yj;
      }
    }
    __syncwarp();                            // the slot holds L by columns
    // column rho[r] of L: c[r][p] = L[p][rho] for p >= rho (p >= G r)
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int m = (G * r) / 4; m < N4; ++m) {
        const float4 w = *reinterpret_cast<const float4*>(s + row[r] * P +
                                                          4 * m);
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (4 * m + e < K) c[r][4 * m + e] = wv[e];
      }
    }
    __syncwarp();                            // the slot is free
    const long long sys = (long long)t * SPW + grp;
    t += step;
    if (t < tasks) fetch(t);
#pragma unroll
    for (int p = K - 1; p >= 0; --p) {
      const int rp = p / G, qp = p % G;      // unknown p: lane qp's row rp
      // lane qp divides r_p by L[p][p]; the others divide by 1 (a quotient
      // nobody reads, on the division's fast path)
      const float lpp = c[rp][p];
      const float xp = __shfl_sync(
          kFull, rr[rp] / (rho[rp] == p ? lpp : 1.0f), qp, G);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (G * r > p) continue;             // every unknown of r is past p
        if (rho[r] < p) rr[r] = fmaf(-c[r][p], xp, rr[r]);
        else if (rho[r] == p) rr[r] = xp;
      }
    }
    if (sys < n) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (rho[r] < K) x[sys * K + rho[r]] = rr[r];
    }
    if (t >= tasks) break;
  }
}

// ---------------------------------------------------------------------------
// 33 <= K <= 307: a panel-blocked Cholesky, the triangle in shared memory.
//
// One block solves one system at a time on its packed lower triangle t (row
// i at i (i + 1) / 2), resident in shared memory. A persistent grid (the
// resident blocks, at most N; spd_solve_block_per_sm) loops over systems
// blockIdx.x, blockIdx.x + grid, ... Each system's lower-triangle rows and b
// come in by cp.async (4 bytes each: a row of A and its packed place are not
// 16-byte aligned alike), a warp a row, so a warp's copies read 32
// consecutive floats. The back substitution copies the next system's rows
// into t as it frees them, from the last panel up, so only the first
// panel's rows and b are waited for.
//
// The factorization runs over panels of kPanel = nb = 32 columns [j0, j0 +
// nb), each in three steps, with a barrier after each:
//   (a) the nb x nb diagonal block is factored by one warp, a row a lane in
//       registers read in place (32 rows that start at a multiple of 32 lie
//       in 32 different banks: the triangular numbers T(0) .. T(31) are all
//       different mod 32): d, dinv = 1 / sqrtf(d), ljj = d dinv, l = a dinv;
//       the rank-1 update of the rest of the block, l_mj read four at a
//       time from column j, which the lanes set out in shared memory; the
//       forward substitution of its rows beside it (y_j = r_j / ljj, r_q -=
//       l_qj y_j). Its L goes back to t and, transposed, to the staging area
//       for (b);
//   (b) the panel rows below it: a thread a row, the row's nb entries in
//       registers, right-looking over the panel's columns (l_ij = a_ij
//       dinv_j, then a_im -= l_ij l_mj for the panel's m > j, and r_i -=
//       l_ij y_j), each row independent of the others; each row's L also
//       goes to a staged copy of the panel, laid out for (c);
//   (c) the trailing lower triangle, rows and columns >= j0 + nb, in 32 x 32
//       tiles, one to each group of 64 threads in turn, a thread a 4 x 4
//       register tile, both operands float4 reads of the staged panel, no
//       barrier between tiles; each element gets the panel's nb updates in
//       ascending j.
// Each element of the triangle thus gets a_im = fmaf(-l_ij, l_mj, a_im) for
// j = 0, 1, ... in order, and r its forward chain, as the TPU kernel's steps
// give them and as the global-memory kernel below computes them; no atomics,
// no TF32, and two runs are bitwise equal. The back substitution runs over
// the same panels from the last: one warp solves the panel's unknowns (x_p =
// r_p / L[p][p], r_q -= L[p][q] x_p, p descending; lane p divides and shares
// x_p), then every thread takes the panel's nb updates of one unknown above
// it, p descending, and x goes to device memory as its panel is solved.
//
// nb = 32: step (a) is one warp, a row a lane; at nb = 64 the warp's two
// rows a lane and step (b)'s 64 floats a thread spill.
//
// Shared memory a block (block_smem_floats): the triangle and b, each
// rounded up to 4 floats, and the staging area (block_stage_floats); K = 307
// is the last that fits the 232,448 bytes a block may use.
//
// What holds it: the serial chain (step (a) and the back substitution's
// warp, K pivots and K divisions a system, one after another) while the
// block's other warps wait at a barrier; the resident blocks overlap one
// system's serial steps with the others' trailing updates, so what counts
// is how many fit an SM. Three instances: 128 threads at 64 registers (8
// blocks an SM), 128 threads at 128 (4), 256 threads at 128 (2); the host
// picks one by K (pallas_kernels.spd_solve_block_geometry, from the
// [spd:sweep] timings of chip_smoke.py on an H100: 128 threads and 64
// registers to K = 96, where 7 to 8 blocks an SM fit; 128 registers to K =
// 128, where shared memory allows 4 and the smaller instance spills; 256
// threads above, where it allows 1 or 2).
// ---------------------------------------------------------------------------

constexpr int kPanel = 32;             // nb: the columns of a panel
static_assert(kPanel == 32, "step (a) is one warp, a row a lane");

// The row stride of the staged panel: its trailing rows (K - nb at the
// first panel), rounded up to whole 32-row blocks.
__host__ __device__ __forceinline__ int panel_ld(int k) {
  return (k - kPanel + 31) & ~31;
}

// Floats of the staging area: the diagonal block's L transposed (nb x nb),
// the panel's L below it (nb x panel_ld), then dinv and y of the panel.
__host__ __device__ __forceinline__ int block_stage_floats(int k) {
  return kPanel * kPanel + kPanel * panel_ld(k) + 2 * kPanel;
}

// One system's triangle, then b.
__host__ __device__ __forceinline__ int block_buffer_floats(int k) {
  return round4(tri(k)) + round4(k);
}

__host__ __device__ __forceinline__ size_t block_smem_floats(int k) {
  return (size_t)block_buffer_floats(k) + block_stage_floats(k);
}

// Position of trailing row r (from the panel's end) in a staged row of the
// panel: 32-row blocks, and in each the rows r, r + 8, r + 16, r + 24 side
// by side, so that a thread's four rows (or columns) of a 32 x 32 tile are
// one float4.
__device__ __forceinline__ int panel_pos(int r) {
  return (r & ~31) + ((r & 7) << 2) + ((r >> 3) & 3);
}

// cp.async of rows [lo, hi) of one system's lower triangle (as: its A) to
// their packed places in t, a warp a row: a warp's copies read 32
// consecutive floats.
template <int kThreads>
__device__ __forceinline__ void load_rows(const float* __restrict__ as,
                                          float* t, int lo, int hi, int k) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = lo + warp; i < hi; i += kThreads / 32) {
    const float* row = as + (size_t)i * k;
    float* dst = t + tri(i);
    for (int m = lane; m <= i; m += 32) cp_async4(dst + m, row + m);
  }
}

// One system. t: its packed lower triangle, holding A's. r: b, then y, then
// the back substitution's work. st: the staging area, 16-byte aligned
// (block_stage_floats(k) floats). Writes x (xs). next: the next system's A
// (or null), whose rows past the first panel the back substitution copies
// into t as it frees them.
template <int kThreads>
__device__ __forceinline__ void panel_solve(float* t, float* r, float* st,
                                            float* __restrict__ xs, int k,
                                            const float* __restrict__ next) {
  constexpr int nb = kPanel;
  static_assert(kThreads == 128 || kThreads == 256,
                "whole groups of 64 threads over (c)'s 32 x 32 tiles");
  const int sl = panel_ld(k);
  float* lt = st;                // (a)-(b): the diagonal block's L^T
  float* ls = st + nb * nb;      // (b)-(c): the panel's L, [j][panel_pos]
  float* dv = ls + nb * sl;      // the panel's dinv
  float* yv = dv + nb;           // its y, then its x
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  auto row_of = [&](int i) -> float* { return t + tri(i); };

  for (int j0 = 0; j0 < k; j0 += nb) {
    const int nbp = min(nb, k - j0);
    const int s0 = j0 + nb;

    // (a) the diagonal block
    __syncthreads();            // the last panel's trailing update is done
    if (warp == 0) {
      // lane q: row j0 + q in registers, and its pivot dq on its own, so
      // that step j + 1's pivot waits on one update of step j, not on all
      // of them. The steps stop at a short panel's end (K = 33 and 65 have
      // a one-column last panel); the rows past it, rows of the identity,
      // are never written back. Entries above the diagonal (m > q) take the
      // updates too and are never read: no predicate a column.
      const int q = lane;
      float row[nb], rq = 0.f, dq = 1.f, yq = 0.f, dinvq = 0.f;
#pragma unroll
      for (int m = 0; m < nb; ++m) {
        float v = m == q ? 1.f : 0.f;
        if (q < nbp && m <= q) v = row_of(j0 + q)[j0 + m];
        row[m] = v;
      }
      if (q < nbp) {
        rq = r[j0 + q];
        dq = row_of(j0 + q)[j0 + q];
      }
#pragma unroll
      for (int j = 0; j < nb; ++j) {
        if (j >= nbp) break;
        const float d = __shfl_sync(kFull, dq, j);   // row j's pivot
        const float dinv = 1.0f / sqrtf(d);
        const float ljj = d * dinv;                  // L[j][j]
        const float yj = __shfl_sync(kFull, rq, j) / ljj;
        const float l = row[j] * dinv;               // l_qj below the pivot
        const bool below = q > j;
        dq = below ? fmaf(-l, l, dq) : dq;           // a_qq -= l_qj l_qj
        row[j] = below ? l : q == j ? ljj : row[j];
        rq = below ? fmaf(-l, yj, rq) : rq;
        yq = q == j ? yj : yq;
        dinvq = q == j ? dinv : dinvq;
        // a_qm -= l_qj l_mj (m > q: unread), l_mj four at a time from
        // column j of the block, set out in lt (two alternating columns)
        float* lb = lt + (j & 1) * nb;
        lb[q] = l;
        __syncwarp();
#pragma unroll
        for (int m4 = (j + 1) / 4; m4 < nb / 4; ++m4) {
          const float4 w = *reinterpret_cast<const float4*>(lb + 4 * m4);
          const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (4 * m4 + e > j)
              row[4 * m4 + e] = fmaf(-l, wv[e], row[4 * m4 + e]);
        }
      }
      __syncwarp();                 // the last columns are read
      if (q < nbp) {
        r[j0 + q] = yq;
        dv[q] = dinvq;
        yv[q] = yq;
        float* o = row_of(j0 + q) + j0;
#pragma unroll
        for (int m = 0; m < nb; ++m)
          if (m <= q) o[m] = row[m];
      }
#pragma unroll
      for (int j = 0; j < nb; ++j)                  // lt[j][q] = l_qj
        lt[j * nb + q] = q > j && q < nbp ? row[j] : 0.f;
    }
    __syncthreads();

    // (b) the panel rows below it (only a full panel has any), each also to
    // the staged panel for (c)
    for (int i = s0 + tid; i < k; i += kThreads) {
      float* o = row_of(i) + j0;
      float row[nb];
#pragma unroll
      for (int m = 0; m < nb; ++m) row[m] = o[m];
      float ri = r[i];
#pragma unroll
      for (int j = 0; j < nb; ++j) {
        const float l = row[j] * dv[j];
        row[j] = l;
        ri = fmaf(-l, yv[j], ri);
#pragma unroll
        for (int m4 = (j + 1) / 4; m4 < nb / 4; ++m4) {
          const float4 w =
              *reinterpret_cast<const float4*>(lt + j * nb + 4 * m4);
          const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (4 * m4 + e > j)
              row[4 * m4 + e] = fmaf(-l, wv[e], row[4 * m4 + e]);
        }
      }
#pragma unroll
      for (int m = 0; m < nb; ++m) o[m] = row[m];
      float* p = ls + panel_pos(i - s0);
#pragma unroll
      for (int m = 0; m < nb; ++m) p[m * sl] = row[m];
      r[i] = ri;
    }

    // (c) the trailing lower triangle, rows and columns >= s0: 32 x 32
    // tiles, one to each group of 64 threads in turn, a thread's rows i0 +
    // gy + 8 u and columns m0 + gx + 8 c
    __syncthreads();            // (b)'s rows are staged
    const int g = tid >> 6, gx = tid & 7, gy = (tid >> 3) & 7;
    const int nt = (k - s0 + 31) >> 5;           // 32-row blocks
    for (int tile = g; tile < nt * (nt + 1) / 2; tile += kThreads / 64) {
      int bi = 0;                                // tile = bi (bi + 1) / 2 + bm
      while ((bi + 1) * (bi + 2) / 2 <= tile) ++bi;
      const int i0 = s0 + 32 * bi, m0 = s0 + 32 * (tile - bi * (bi + 1) / 2);
      float acc[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + gy + 8 * u;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int m = m0 + gx + 8 * c;
          acc[u][c] = 0.f;
          if (i < k && m <= i) acc[u][c] = row_of(i)[m];
        }
      }
      const float* pu = ls + (i0 - s0) + 4 * gy;
      const float* pv = ls + (m0 - s0) + 4 * gx;
#pragma unroll 4
      for (int j = 0; j < nb; ++j) {
        const float4 u4 = *reinterpret_cast<const float4*>(pu + j * sl);
        const float4 v4 = *reinterpret_cast<const float4*>(pv + j * sl);
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
        const int i = i0 + gy + 8 * u;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int m = m0 + gx + 8 * c;
          if (i < k && m <= i) row_of(i)[m] = acc[u][c];
        }
      }
    }
  }

  // the back substitution L^T x = y, panel by panel from the last
  for (int p1 = k, done = k; p1 > 0;) {
    const int p0 = (p1 - 1) / nb * nb, nbp = p1 - p0;
    __syncthreads();            // the last panel's y / x and r are read
    if (next != nullptr && p1 < done) {              // its rows are free
      load_rows<kThreads>(next, t, p1, done, k);
      cp_async_commit();
      done = p1;
    }
    if (warp == 0) {
      // lane q: unknown p0 + q, column q of the panel's L below the
      // diagonal in registers, and L[q][q]; lane p divides, then shares
      // x_p. The steps stop at a short panel's end, as in (a).
      const int q = lane;
      float lc[nb], rq = 0.f, dqq = 1.f, xq = 0.f;
#pragma unroll
      for (int p = 0; p < nb; ++p) {
        lc[p] = 0.f;
        if (q < p && p < nbp) lc[p] = row_of(p0 + p)[p0 + q];
      }
      if (q < nbp) {
        rq = r[p0 + q];
        dqq = row_of(p0 + q)[p0 + q];
      }
#pragma unroll
      for (int p = nb - 1; p >= 0; --p) {
        if (p >= nbp) continue;
        const float xp = __shfl_sync(kFull, rq / dqq, p);
        rq = fmaf(-lc[p], xp, rq);     // lanes q >= p: lc[p] = 0, rq done
        xq = q == p ? xp : xq;
      }
      yv[q] = xq;
    }
    __syncthreads();
    for (int i = tid; i < p0; i += kThreads) {
      float ri = r[i];
      for (int p = nbp - 1; p >= 0; --p)
        ri = fmaf(-row_of(p0 + p)[i], yv[p], ri);
      r[i] = ri;
    }
    for (int q = tid; q < nbp; q += kThreads) xs[p0 + q] = yv[q];
    p1 = p0;
  }
}

template <int kThreads, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
spd_solve_block_kernel(const float* __restrict__ a,
                       const float* __restrict__ b, float* __restrict__ x,
                       long long n, int k) {
  extern __shared__ float4 smem4[];
  float* t = reinterpret_cast<float*>(smem4);
  float* r = t + round4(tri(k));                // b
  float* st = t + block_buffer_floats(k);
  const long long kk = (long long)k * k;
  // rows [0, loaded) of a system are copied at the top of the loop: all at
  // the first, the first panel's after it (the rest came during the last
  // back substitution)
  int loaded = k;
  for (long long sys = blockIdx.x; sys < n; sys += gridDim.x) {
    __syncthreads();            // the last system's x and r are read
    load_rows<kThreads>(a + sys * kk, t, 0, loaded, k);
    for (int i = threadIdx.x; i < k; i += kThreads)
      cp_async4(r + i, b + sys * k + i);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    const long long next = sys + gridDim.x;
    panel_solve<kThreads>(t, r, st, x + sys * k, k,
                          next < n ? a + next * kk : nullptr);
    loaded = min(kPanel, k);
  }
  cp_async_wait_all();
}

// ---------------------------------------------------------------------------
// K > 307: a panel-blocked Cholesky, the triangle in device memory.
//
// Past the shared-memory kernel's limit the packed lower triangle lives in a
// workspace in device memory, one triangle a resident block: the grid is
// persistent (each block loops over systems blockIdx.x, blockIdx.x + grid,
// ...; spd_solve_global_grid, the card's resident blocks, at most N), so the
// workspace is at most half of A's bytes. The first panel reads A itself;
// every later read is of the workspace, which ends holding L. The
// factorization runs over the same panels of kPanel = nb columns as the
// shared-memory kernel's, in the same three steps, with a barrier after each:
//   (a) the nb x nb diagonal block, staged through shared memory, is
//       factored by one warp, nb / 32 rows a lane in registers (d, dinv = 1
//       / sqrtf(d), ljj = d dinv, l = a dinv; the rank-1 update of the rest
//       of the block, l_mj by a shuffle from the lane of row m), the forward
//       substitution of its rows beside it (y_j = r_j / ljj, r_q -= l_qj
//       y_j); then its L goes back to the workspace and, transposed, to
//       shared memory for (b);
//   (b) the panel rows below it: a thread a row, as in the shared-memory
//       kernel;
//   (c) the trailing lower triangle, rows and columns >= j0 + nb, in 64 x 64
//       tiles: a thread holds a 4 x 4 register tile of it (rows 4 ty ..,
//       columns tx + 16 c, so a warp's loads and stores are 16 consecutive
//       floats of a row), the tile's two 64-row blocks of the panel's L are
//       staged in shared memory (4 threads a row, columns interleaved, so
//       the transposed stores hit 32 banks), and each element gets the
//       panel's nb updates in ascending j.
// Each element of the triangle thus gets the shared-memory kernel's chain,
// a_im = fmaf(-l_ij, l_mj, a_im) for j = 0, 1, ... in order (the pivot too:
// a_qq there is updated by the same fmaf of l_qj with itself), and r its
// forward chain; the back substitution, one warp over a panel's unknowns (r_p
// by a shuffle, divided by L[p][p]) and then a thread an unknown above it,
// is the same chain too. So x is that kernel's bit for bit wherever both run
// (no atomics, no TF32; two runs are bitwise equal), which the tests and
// chip_smoke.py check at every K of the shared-memory kernel's range.
//
// What bounds it: operations at these widths. The trailing triangle is read
// and written once a panel, not once a column: about K^3 / (6 nb) element
// read-modify-writes a system instead of K^3 / 6, and 3 + 2 t barriers a
// panel with t its trailing tiles. nb = 32 was measured against 64 on the
// card (PERF.md): at 64 the warp's step (a) holds two 64-float rows a lane
// and step (b) 64 floats a thread, which spill, and it is slower at every K
// timed. The serial steps (a), (b) and the back substitution (one warp, or
// one row a thread, between barriers) wait on device memory and take about
// as long as the trailing products. Shared memory: b, then y and x (K
// floats), and the panel's staging area (global_stage_floats, 4,416 floats),
// which would take K past 52,000; SPD_MAX_K_GLOBAL = 29,056 stays the stated
// limit.
// ---------------------------------------------------------------------------

constexpr int kGlobalThreads = 256;

__host__ __device__ __forceinline__ long long tri_ll(long long i) {
  return i * (i + 1) / 2;
}

constexpr int kTile = 64;              // trailing tiles are kTile x kTile
constexpr int kTileLd = kTile + 4;     // a staged row block, transposed
static_assert(kGlobalThreads == 256 && kTile == 64,
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

__global__ void __launch_bounds__(kGlobalThreads)
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
    for (int i = tid; i < k; i += kGlobalThreads) r[i] = b[sys * k + i];

    for (int j0 = 0; j0 < k; j0 += nb) {
      const int nbp = min(nb, k - j0);
      // row i's entries: A in the first panel, the workspace after it
      auto src = [&](int i) -> const float* {
        return j0 == 0 ? as + (size_t)i * k : t + tri_ll(i);
      };

      // (a) the diagonal block
      __syncthreads();            // the last panel's staged rows are read
      for (int e = tid; e < nb * nb; e += kGlobalThreads) {
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
      for (int i = j0 + nb + tid; i < k; i += kGlobalThreads) {
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
      for (int e = tid; e < nb * nb; e += kGlobalThreads) {
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
      for (int i = tid; i < p0; i += kGlobalThreads) {
        float ri = r[i];
        for (int p = nbp - 1; p >= 0; --p)
          ri = fmaf(-t[tri_ll(p0 + p) + i], yv[p], ri);
        r[i] = ri;
      }
      for (int q = tid; q < nbp; q += kGlobalThreads)
        x[sys * k + p0 + q] = yv[q];
      p1 = p0;
    }
  }
}

template <class Kernel>
int resident_per_sm(Kernel kernel, int threads, size_t bytes, int* per_sm) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads,
                                                      bytes);
  return (int)e;
}

// The shared-memory kernel's instance at `threads` (128 or 256) with
// `regs` registers a thread at most (64: 8 blocks of 128 threads an SM;
// 128: 4 blocks of 128 or 2 of 256), passed to f; -1 for another geometry.
template <class F>
int with_block_kernel(int threads, int regs, F f) {
  if (threads == 128 && regs == 64) return f(spd_solve_block_kernel<128, 8>);
  if (threads == 128 && regs == 128) return f(spd_solve_block_kernel<128, 4>);
  if (threads == 256 && regs == 128) return f(spd_solve_block_kernel<256, 2>);
  return -1;
}

// The one-warp kernel's instance at rank k (1 <= k <= 32), passed to f;
// -1 for another k.
template <int K = 1, class F>
int with_warp_kernel(int k, F f) {
  if constexpr (K > 32) {
    return -1;
  } else {
    if (k == K) return f(spd_solve_kernel<K>);
    return with_warp_kernel<K + 1>(k, f);
  }
}

}  // namespace

extern "C" {

// Bytes of shared memory one block of the one-warp kernel holds at rank k
// (1 <= k <= 32): warp_block_warps(k) warps, each 32 / G slots
// (warp_slot_floats).
long long spd_solve_warp_smem_bytes(int k) {
  if (k < 1 || k > 32) return -1;
  return (long long)warp_block_floats(k) * (long long)sizeof(float);
}

// Blocks of the one-warp kernel resident on one SM of the current device
// at rank k, after asking for the largest shared-memory carveout for its
// instance (which its launches then take). A negative value is a CUDA
// error, negated.
int spd_solve_warp_per_sm(int k) {
  int per_sm = 0;
  const int e = with_warp_kernel(k, [&](auto kernel) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, 32 * warp_block_warps(k), 0);
    return (int)err;
  });
  if (e < 0) return -(int)cudaErrorInvalidValue;
  return e ? -e : per_sm;
}

// Solve the n systems on `stream` with the one-warp kernel: a (n, k, k),
// b (n, k), x (n, k), float32, contiguous, 1 <= k <= 32, on `grid` blocks
// of warp_block_warps(k) warps (the resident blocks, spd_solve_warp_per_sm
// times the SMs, at most the blocks whose warps the systems fill). Returns
// cudaGetLastError() after the launch (0 on success).
int spd_solve_launch(const void* a, const void* b, void* x, long long n,
                     int k, int grid, void* stream) {
  if (n == 0) return 0;
  // the warps' turns count in an int: never more for systems that fit a
  // card (K = 1, 8 systems a turn: 2^31 turns are 206 GB of A, b and x)
  if (grid < 1 || k < 1 || k > 32 ||
      (n + 32 / warp_group(k) - 1) / (32 / warp_group(k)) > 0x7fff0000LL)
    return (int)cudaErrorInvalidValue;
  const int e = with_warp_kernel(k, [&](auto kernel) {
    kernel<<<(unsigned)grid, 32 * warp_block_warps(k), 0,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(x), n);
    return (int)cudaGetLastError();
  });
  return e < 0 ? (int)cudaErrorInvalidValue : e;
}

// Bytes of dynamic shared memory one block of the shared-memory kernel needs
// at rank k.
long long spd_solve_block_smem_bytes(int k) {
  return (long long)(block_smem_floats(k) * sizeof(float));
}

// Blocks of the shared-memory kernel resident on one SM of the current
// device at that geometry (0 where a block does not fit). A negative value
// is a CUDA error, negated.
int spd_solve_block_per_sm(int k, int threads, int regs) {
  const size_t bytes = block_smem_floats(k) * sizeof(float);
  if (bytes > 232448) return 0;
  int per_sm = 0;
  const int e = with_block_kernel(threads, regs, [&](auto kernel) {
    return resident_per_sm(kernel, threads, bytes, &per_sm);
  });
  if (e < 0) return -(int)cudaErrorInvalidValue;
  return e ? -e : per_sm;
}

// Solve the n systems on `stream` with the shared-memory kernel: the same
// operands, 33 <= k within its limit (checked by the caller), at the
// geometry `threads` and `regs`, on `grid` blocks (the resident blocks,
// spd_solve_block_per_sm times the SMs, at most n). Returns
// cudaGetLastError() after the launch (0 on success).
int spd_solve_block_launch(const void* a, const void* b, void* x,
                           long long n, int k, int threads, int regs,
                           int grid, void* stream) {
  if (n == 0) return 0;
  if (grid < 1) return (int)cudaErrorInvalidValue;
  const size_t bytes = block_smem_floats(k) * sizeof(float);
  const int e = with_block_kernel(threads, regs, [&](auto kernel) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)grid, threads, bytes,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(x), n, k);
    return (int)cudaGetLastError();
  });
  return e < 0 ? (int)cudaErrorInvalidValue : e;
}

// Blocks of the global-memory kernel's persistent grid for n systems of
// rank k on the current device: the resident blocks, at most n. A negative
// value is a CUDA error, negated.
int spd_solve_global_grid(long long n, int k) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = (cudaError_t)resident_per_sm(spd_solve_global_kernel, kGlobalThreads,
                                     global_smem_floats(k) * sizeof(float),
                                     &per_sm);
  if (e != cudaSuccess) return -(int)e;
  long long grid = (long long)sms * per_sm;
  if (grid > n) grid = n;
  return grid < 1 ? 1 : (int)grid;
}

// Solve the n systems on `stream` with the global-memory kernel: the same
// operands, any k >= 1 (the caller sends it k past the shared-memory
// kernel's limit), on `grid` blocks (spd_solve_global_grid) with ws (grid,
// k (k + 1) / 2) float32. Returns cudaGetLastError() after the launch (0 on
// success).
int spd_solve_global_launch(const void* a, const void* b, void* x, void* ws,
                            long long n, int k, int grid, void* stream) {
  if (n == 0) return 0;
  if (grid < 1) return (int)cudaErrorInvalidValue;
  const size_t bytes = global_smem_floats(k) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      spd_solve_global_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  spd_solve_global_kernel<<<(unsigned)grid, kGlobalThreads, bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(x), static_cast<float*>(ws), n, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
