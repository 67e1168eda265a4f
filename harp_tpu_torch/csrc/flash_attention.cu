// Flash attention for Hopper (sm_90a): for every stacked worker w, head h and
// query row i, out[w, i, h] = sum_j p_ij v[w, j, h] / sum_j p_ij with
// p_ij = exp(s_ij - m_i), s_ij = (q[w, i, h] . k[w, j, h]) / sqrt(Dh), keys
// j > i masked when causal, and m_i the row's running maximum. Optionally it
// also writes m_i and the denominator sum_j p_ij (the streaming-softmax
// stats a ring hop merges). q, k (W, L, H, Dh), v (W, L, H, Dv), float32 or
// bfloat16; out (W, L, H, Dv) float32 whatever the input type, m and den
// (W, L, H) float32.
//
// Replaces: harp_tpu/ops/pallas_kernels.py::_flash_kernel (the TPU kernel
// behind flash_attention_pallas, with its ring_hop prologue and epilogue,
// _ring_start / _ring_wait at pallas_kernels.py:433-453). It computes
// the same function with the same update rule: running max m (starting at
// -1e30), denominator d and accumulator acc on chip; per KV tile
// m' = max(m, rowmax s), alpha = exp(m - m'), p = exp(s - m'),
// d = d alpha + rowsum p, acc = acc alpha + p v; at the end
// out = acc / max(d, 1e-30). Masked scores are -1e30, not -inf, so a masked
// key gives exp(-1e30 - m) = 0 for any finite m. Padded keys (the ragged
// last tile) are masked; padded query rows are computed and never written.
// The causal grid is the TPU kernel's trapezoid: query tile iq visits only
// the min(n_kv, ceil((iq + 1) BQ / BK)) KV tiles at or below the diagonal,
// so a tile above it is never loaded. Given a counter, every block adds the
// KV tiles it loaded, so a caller reads what the kernel walked, not what it
// should have walked. It does not carry over the TPU
// wrapper's transpose, pad and head-pack passes: q, k and v are read in
// their (W, L, H, D) layout, and D is zero-padded in shared memory only.
//
// Precision: the TPU kernel's. Scores are float32 products of the inputs
// (a bf16 input is widened exactly to float32 on load), and p stays float32
// in the p v product (the TPU kernel widens v to float32). Every product is
// a float32 FMA on the CUDA cores: one TF32 pass would move scores by about
// 1e-3, and rounding p to bf16, as FlashAttention does, is another function.
//
// What bounds it on this card: operations. At causal L = 16384, H = 8,
// Dh = Dv = 64 the work is (2 Dh + 2 Dv) H L (L + 1) / 2 = 2.75e11
// operations, 4.1 ms on the float32 CUDA cores (67 TFLOP/s) and 1.67 ms as
// three TF32 passes (the fastest route to float32 accuracy), against 134 MB
// of q, k, v and out (0.04 ms at 3.35 TB/s).
//
// Design (simple first): one block of 256 threads a (worker, head, 64-row
// query tile); a loop over 64-key tiles. The q tile and each k tile sit
// transposed in shared memory, the v tile and p as they are; a 16 x 16
// thread grid keeps a 4 x 4 register tile of scores (4 query rows x 4 keys)
// and a 4 x Dv/16 tile of the accumulator, the row max and sum travel by
// warp shuffles among the 16 threads of a row. Blocks are issued heaviest
// causal tile first. No atomics, no sum across blocks: two runs are bitwise
// equal, and a stacked launch is bitwise W separate ones (the optional tile
// counter is the only atomic, and no output reads it). Two TF32x3
// versions on mma.sync were measured and not kept: with cvt splits and the
// tensor core's truncating sums over all keys it broke the tolerance, and
// with exact sums it was slower than this kernel (PERF.md). wgmma on
// pre-split tiles, TMA and warp specialisation are later work.
//
// The ring send (ring_hop). The TPU kernel starts two whole-array copies of
// its k and v to the right neighbour at its first grid step and waits for
// them at its last, so the copy overlaps the whole pass. Here the launch
// carries rows x cpr extra copy blocks at the lowest block indices, issued
// before every attention block: they run beside the first wave of attention
// blocks (the copy is bound by bytes, the attention blocks by float32
// operations, so the two share the SMs), and an attention block never waits
// for them. A row's copy blocks move k[r] and v[r] as they lie, (L, H, D),
// with no head-pack or padding pass, so the bytes that arrive are k and v
// bitwise:
//   * neighbour in this launch: straight into k_next / v_next at its row
//     (fresh outputs, never the buffers this launch reads);
//   * neighbour in another process (ring_dma.cuh): the first copy block
//     gives every row's sender its credit before anything else, one credit a
//     call for both tensors as the TPU kernel runs one ring_ready; a copy
//     block waits for its own credit, stores its share of k and v into the
//     receiver's IPC receive slot and signals, cpr arrivals a row a call.
// Copy blocks wait only for the first copy block of the receiver's launch,
// which never waits before it gives; attention blocks wait on nothing. The
// receive (wait for the own sender, copy the slot into k_next / v_next) is
// ring_recv_kernel (ring_dma.cu), launched after this one in stream order.
//
// The host binding is a plain C interface loaded with ctypes
// (harp_tpu_torch/ops/_cuda_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "ring_dma.cuh"

namespace {

constexpr int kBQ = 64;            // query rows a block
constexpr int kBK = 64;            // keys a KV tile
constexpr int kThreads = 256;      // 16 x 16: 4 rows x 4 keys each
constexpr int kPad = 4;            // keeps float4 rows aligned
constexpr int kLd = kBQ + kPad;    // row length of the transposed tiles
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMasked = -1e30f;
static_assert(kBQ == kBK, "the transposed q, k and p tiles share kLd");

struct Args {
  const void* q;
  const void* k;
  const void* v;
  float* out;
  float* m_out;      // null unless the stats are asked for
  float* d_out;
  unsigned long long* tiles;  // null unless the loaded KV tiles are counted
  long long w_h;     // W * H
  int n_q;           // query tiles of one (worker, head)
  int seq;           // L
  int heads;         // H
  int dh;
  int dv;
  float scale;
  int causal;
  int bf16;
};

// The ring send of a launch, a parameter of its own: the attention blocks'
// Args stay as they are without the send (a larger Args, even unread,
// changed how the attention code was compiled and cost up to half its
// speed). rows = W, cpr copy blocks a row, base the global id of row 0 of
// nworkers, remote = 1 when the workers span processes (plan, ready, err,
// cid are then the call's), kbytes / vbytes a row's k / v, v_off the
// offset of v in a receive slot.
struct RingSend {
  int remote;
  int rows;
  int cpr;
  int base;
  int nworkers;
  char* k_next;
  char* v_next;
  long long kbytes;
  long long vbytes;
  long long v_off;
  ring_dma::HopPlan plan;
  unsigned long long ready;
  unsigned* err;
  unsigned cid;
};

// A copy block's share of the send (see the header): k and v of one row to
// the right neighbour's row (k_next, v_next) in this launch, or, with
// remote_dst set, into its receive slot after the own credit, then the
// arrival. Out of line, on scalar arguments: so built, the kRing instance's
// attention blocks time as the plain instance's (PERF.md, PR 9).
__device__ __noinline__ void ring_send_share(
    const char* ks, const char* vs, long long kbytes, long long vbytes,
    char* k_next, char* v_next, char* remote_dst, long long v_off,
    const unsigned long long* my_ready, unsigned long long* arrive_to,
    unsigned long long ready, unsigned* err, unsigned code, long long tid,
    long long nthreads) {
  if (remote_dst == nullptr) {
    ring_dma::copy_share(k_next, ks, kbytes, tid, nthreads);
    ring_dma::copy_share(v_next, vs, vbytes, tid, nthreads);
    return;
  }
  if (!ring_dma::block_wait(my_ready, ready, err, code)) return;
  ring_dma::copy_share(remote_dst, ks, kbytes, tid, nthreads);
  ring_dma::copy_share(remote_dst + v_off, vs, vbytes, tid, nthreads);
  ring_dma::signal_arrival(arrive_to);
}

__device__ __forceinline__ float load_in(const void* p, long long i,
                                         int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

template <int DK, int DV>
constexpr size_t smem_floats() {
  // q and k tiles transposed, the v tile, p transposed
  return (size_t)2 * DK * kLd + (size_t)kBK * (DV + kPad) + (size_t)kBK * kLd;
}

// out[w, l, h, :] lies at row (w L + l) H + h of a (rows, D) matrix.
template <int DK, int DV, bool kRing>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const Args a, const RingSend ring) {
  extern __shared__ float4 smem4[];
  constexpr int kLv = DV + kPad;
  constexpr int kNg = DV / 64;     // groups of 4 value columns a thread
  float* qs = reinterpret_cast<float*>(smem4);   // [DK][kLd]
  float* ks = qs + DK * kLd;                     // [DK][kLd]
  float* vs = ks + DK * kLd;                     // [kBK][kLv]
  float* ps = vs + kBK * kLv;                    // [kBK][kLd]

  long long blk = blockIdx.x;
  if constexpr (kRing) {
    const long long ncopy = (long long)ring.rows * ring.cpr;
    if (blk < ncopy) {   // copy block: row r, share blk % cpr
      const int r = (int)blk / ring.cpr;
      if (ring.remote) ring_dma::give_credits(ring.plan, ring.rows);
      const int d =
          ring_dma::ring_neighbor(ring.base + r, ring.nworkers, 1) - ring.base;
      const bool local = d >= 0 && d < ring.rows;
      ring_send_share(
          static_cast<const char*>(a.k) + r * ring.kbytes,
          static_cast<const char*>(a.v) + r * ring.vbytes, ring.kbytes,
          ring.vbytes, ring.k_next + d * ring.kbytes,
          ring.v_next + d * ring.vbytes,
          local ? nullptr : ring.plan.remote_dst[r], ring.v_off,
          ring.plan.my_ready[r], ring.plan.arrive_to[r], ring.ready,
          ring.err, ring_dma::kErrReady * 1000 + ring.cid,
          (blk % ring.cpr) * kThreads + threadIdx.x,
          (long long)ring.cpr * kThreads);
      return;
    }
    blk -= ncopy;
  }
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int iq = a.n_q - 1 - (int)(blk / a.w_h);   // heaviest tiles first
  const long long pair = blk % a.w_h;              // w H + h
  const long long w = pair / a.heads;
  const long long row0 = w * a.seq * a.heads + pair % a.heads;  // l = 0
  const int q0 = iq * kBQ;

  for (int i = t; i < kBQ * DK; i += kThreads) {
    const int r = i / DK, d = i % DK, l = q0 + r;
    qs[d * kLd + r] = (l < a.seq && d < a.dh)
        ? load_in(a.q, (row0 + (long long)l * a.heads) * a.dh + d, a.bf16)
        : 0.f;
  }

  float m[4], den[4], acc[4][kNg * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    den[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kNg * 4; ++c) acc[i][c] = 0.f;
  }

  const int n_kv = (a.seq + kBK - 1) / kBK;
  const int n_vis = a.causal ? min(n_kv, (q0 + kBQ + kBK - 1) / kBK) : n_kv;
  unsigned long long loaded = 0;
  for (int j = 0; j < n_vis; ++j) {
    const int k0 = j * kBK;
    __syncthreads();               // the last tile's k, v and p are read
    ++loaded;
    for (int i = t; i < kBK * DK; i += kThreads) {
      const int c = i / DK, d = i % DK, l = k0 + c;
      ks[d * kLd + c] = (l < a.seq && d < a.dh)
          ? load_in(a.k, (row0 + (long long)l * a.heads) * a.dh + d, a.bf16)
          : 0.f;
    }
    for (int i = t; i < kBK * DV; i += kThreads) {
      const int c = i / DV, d = i % DV, l = k0 + c;
      vs[c * kLv + d] = (l < a.seq && d < a.dv)
          ? load_in(a.v, (row0 + (long long)l * a.heads) * a.dv + d, a.bf16)
          : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DK; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(qs + d * kLd + ty * 4);
      const float4 kv = *reinterpret_cast<const float4*>(ks + d * kLd + tx * 4);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(qa[i], ka[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = kMasked;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + tx * 4 + c;
        const bool live = kpos < a.seq && (!a.causal || qpos >= kpos);
        s[i][c] = live ? s[i][c] * a.scale : kMasked;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] = expf(s[i][c] - m_new);
        sum += s[i][c];
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) sum += __shfl_xor_sync(kFull, sum, o);
      den[i] = den[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kNg * 4; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(ps + (tx * 4 + c) * kLd + ty * 4) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 pv = *reinterpret_cast<const float4*>(ps + c * kLd + ty * 4);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int g = 0; g < kNg; ++g) {
        const float4 vv =
            *reinterpret_cast<const float4*>(vs + c * kLv + g * 64 + tx * 4);
        const float va[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][g * 4 + e] = fmaf(pa[i], va[e], acc[i][g * 4 + e]);
      }
    }
  }
  if (a.tiles != nullptr && t == 0) atomicAdd(a.tiles, loaded);

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= a.seq) continue;   // a padded query row is never written
    const long long row = row0 + (long long)qpos * a.heads;
    const float dd = fmaxf(den[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < kNg; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = g * 64 + tx * 4 + e;
        if (d < a.dv) a.out[row * a.dv + d] = acc[i][g * 4 + e] / dd;
      }
    if (a.m_out != nullptr && tx == 0) {
      a.m_out[row] = m[i];
      a.d_out[row] = den[i];
    }
  }
}

template <int DK, int DV, bool kRing>
int launch(const Args& a, const RingSend& ring, unsigned grid,
           cudaStream_t s) {
  const size_t bytes = smem_floats<DK, DV>() * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel<DK, DV, kRing>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  flash_attention_kernel<DK, DV, kRing><<<grid, kThreads, bytes, s>>>(a, ring);
  return (int)cudaGetLastError();
}

template <int DK, int DV>
int launch(const Args& a, const RingSend* ring, unsigned grid,
           cudaStream_t s) {
  return ring != nullptr ? launch<DK, DV, true>(a, *ring, grid, s)
                         : launch<DK, DV, false>(a, RingSend{}, grid, s);
}

// ---------------------------------------------------------------------------
// Wide heads: Dh or Dv above 128, any width.
//
// The kernel above holds its whole q and k tiles (DK x 64) and a 64 x DV v
// tile in shared memory and a 4 x DV / 16 accumulator a thread: at DK = DV =
// 256 that is 223,232 bytes, at the edge of the 232,448 a block may use, and
// 64 accumulator floats a thread; a wider head fits neither. Its instances
// stay as they are (their parameters and code decide their speed: see
// RingSend), and a wider head takes this kernel, which cuts both widths:
//   * Dv is sliced across the grid in pieces of kDs = 256 columns: block
//     (slice, worker, head, query tile) keeps the accumulator of its slice,
//     4 x 16 floats a thread, so at Dv <= 256 the scores are computed once.
//     Past 256 every slice computes the same scores in the same order, so m
//     and den are bitwise equal across slices, and slice 0 writes them. A
//     head of Dv <= 128 (MLA's 192 / 128) takes the instance whose one slice
//     is 128 columns wide (4 x 8 a thread, a 64 x 128 v tile), so it pays
//     for no empty column.
//   * q stays in shared memory for Dh <= kQRes = 256: the block loads its q
//     tile once, before the KV loop. k is staged in chunks of kDc = 128:
//     for each KV tile the score loop runs over the chunks in order, so s_ij
//     is the same chain of fused multiply-adds over d = 0 .. Dh - 1 as in
//     one pass. Past 256 the q chunk is reloaded beside each k chunk.
// The update rule, masking, trapezoid, heaviest-first order, precision and
// the ring send's copy blocks are the kernel's above; a slice's blocks
// follow each other in the grid, so its neighbours find the k and v tiles
// in L2. What it costs: (2 Dh ceil(Dv / 256) + 2 Dv) operations a live
// pair, 2 Dh + 2 Dv up to Dv = 256. The tile counter adds each slice's
// loads: ceil(Dv / 256) times the trapezoid. Shared memory: 188,416 bytes
// (q 256 x 68, a k chunk 128 x 68, v 64 x 260, p 64 x 68 floats; 155,648
// with the 128-column slice), one block an SM, 197 registers (155 at 128).
// The slice width is a template parameter so the v tile's index math stays
// shifts: an integer division a loaded element, with the width a runtime
// value, took 48.5 ms against 29.4 at Dh = Dv = 256 (PERF.md).
// Bound: operations, as above (at Dh = Dv = 256, causal L = 16384, H = 4:
// 3.33 ms as three TF32 passes); on the float32 CUDA cores the kernel is
// held by them.
// ---------------------------------------------------------------------------

constexpr int kDc = 128;    // k (and past kQRes, q) staged in chunks
constexpr int kDs = 256;    // Dv sliced across the grid
constexpr int kQRes = 256;  // the widest q tile kept for the whole KV loop

// the slice width of a launch: a head of Dv <= 128 takes one 128-column
// slice (its accumulator and v tile at that width), a wider one kDs
inline int wide_slice(int dv) { return dv <= 128 ? 128 : kDs; }

template <int DS>
constexpr size_t wide_smem_floats() {
  // q transposed, a k chunk transposed, the v slice, p transposed
  return (size_t)kQRes * kLd + (size_t)kDc * kLd + (size_t)kBK * (DS + kPad) +
         (size_t)kBK * kLd;
}

template <bool kRing, int DS>
__global__ void __launch_bounds__(kThreads)
    flash_attention_wide_kernel(const Args a, const RingSend ring) {
  extern __shared__ float4 smem4[];
  constexpr int kLv = DS + kPad;
  constexpr int kNg = DS / 64;
  float* qs = reinterpret_cast<float*>(smem4);   // [kQRes][kLd]
  float* ks = qs + kQRes * kLd;                  // [kDc][kLd]
  float* vs = ks + kDc * kLd;                    // [kBK][kLv]
  float* ps = vs + kBK * kLv;                    // [kBK][kLd]

  long long blk = blockIdx.x;
  if constexpr (kRing) {   // the copy blocks, as in flash_attention_kernel
    const long long ncopy = (long long)ring.rows * ring.cpr;
    if (blk < ncopy) {
      const int r = (int)blk / ring.cpr;
      if (ring.remote) ring_dma::give_credits(ring.plan, ring.rows);
      const int d =
          ring_dma::ring_neighbor(ring.base + r, ring.nworkers, 1) - ring.base;
      const bool local = d >= 0 && d < ring.rows;
      ring_send_share(
          static_cast<const char*>(a.k) + r * ring.kbytes,
          static_cast<const char*>(a.v) + r * ring.vbytes, ring.kbytes,
          ring.vbytes, ring.k_next + d * ring.kbytes,
          ring.v_next + d * ring.vbytes,
          local ? nullptr : ring.plan.remote_dst[r], ring.v_off,
          ring.plan.my_ready[r], ring.plan.arrive_to[r], ring.ready,
          ring.err, ring_dma::kErrReady * 1000 + ring.cid,
          (blk % ring.cpr) * kThreads + threadIdx.x,
          (long long)ring.cpr * kThreads);
      return;
    }
    blk -= ncopy;
  }
  const int nvs = (a.dv + DS - 1) / DS;
  const int sv = (int)(blk % nvs);                 // the Dv slice
  blk /= nvs;
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int iq = a.n_q - 1 - (int)(blk / a.w_h);   // heaviest tiles first
  const long long pair = blk % a.w_h;              // w H + h
  const long long w = pair / a.heads;
  const long long row0 = w * a.seq * a.heads + pair % a.heads;  // l = 0
  const int q0 = iq * kBQ;
  const int dv0 = sv * DS;
  const int dvn = min(DS, a.dv - dv0);
  const int nck = (a.dh + kDc - 1) / kDc;
  const bool qres = a.dh <= kQRes;

  // q rows d0 .. d0 + nd - 1 (zero from dn on) into qs rows qr ..
  auto load_q = [&](int qr, int d0, int dn, int nd) {
    for (int i = t; i < kBQ * nd; i += kThreads) {
      const int r = i / nd, d = i % nd, l = q0 + r;
      qs[(qr + d) * kLd + r] = (l < a.seq && d < dn)
          ? load_in(a.q, (row0 + (long long)l * a.heads) * a.dh + d0 + d,
                    a.bf16)
          : 0.f;
    }
  };
  if (qres) load_q(0, 0, a.dh, (a.dh + 7) & ~7);   // once, zero-padded to 8

  float m[4], den[4], acc[4][kNg * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    den[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kNg * 4; ++c) acc[i][c] = 0.f;
  }

  const int n_kv = (a.seq + kBK - 1) / kBK;
  const int n_vis = a.causal ? min(n_kv, (q0 + kBQ + kBK - 1) / kBK) : n_kv;
  unsigned long long loaded = 0;
  for (int j = 0; j < n_vis; ++j) {
    const int k0 = j * kBK;
    __syncthreads();               // the last tile's k, v and p are read
    ++loaded;
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
    for (int ch = 0; ch < nck; ++ch) {
      const int d0 = ch * kDc, dn = min(kDc, a.dh - d0);
      if (ch > 0) __syncthreads();   // the last chunk's q and k are read
      if (!qres) load_q(0, d0, dn, kDc);
      for (int i = t; i < kBK * kDc; i += kThreads) {
        const int c = i / kDc, d = i % kDc, l = k0 + c;
        ks[d * kLd + c] = (l < a.seq && d < dn)
            ? load_in(a.k, (row0 + (long long)l * a.heads) * a.dh + d0 + d,
                      a.bf16)
            : 0.f;
      }
      if (ch == nck - 1) {
        for (int i = t; i < kBK * DS; i += kThreads) {
          const int c = i / DS, d = i % DS, l = k0 + c;
          vs[c * kLv + d] = (l < a.seq && d < dvn)
              ? load_in(a.v,
                        (row0 + (long long)l * a.heads) * a.dv + dv0 + d,
                        a.bf16)
              : 0.f;
        }
      }
      __syncthreads();
      const float* qc = qs + (qres ? d0 : 0) * kLd;
      const int dn8 = (dn + 7) & ~7;   // zero-padded to 8 in shared memory
#pragma unroll 8
      for (int d = 0; d < dn8; ++d) {
        const float4 qv =
            *reinterpret_cast<const float4*>(qc + d * kLd + ty * 4);
        const float4 kv =
            *reinterpret_cast<const float4*>(ks + d * kLd + tx * 4);
        const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
        const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[i][c] = fmaf(qa[i], ka[c], s[i][c]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = kMasked;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + tx * 4 + c;
        const bool live = kpos < a.seq && (!a.causal || qpos >= kpos);
        s[i][c] = live ? s[i][c] * a.scale : kMasked;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] = expf(s[i][c] - m_new);
        sum += s[i][c];
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) sum += __shfl_xor_sync(kFull, sum, o);
      den[i] = den[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kNg * 4; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(ps + (tx * 4 + c) * kLd + ty * 4) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 pv = *reinterpret_cast<const float4*>(ps + c * kLd + ty * 4);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int g = 0; g < kNg; ++g) {
        const float4 vv =
            *reinterpret_cast<const float4*>(vs + c * kLv + g * 64 + tx * 4);
        const float va[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][g * 4 + e] = fmaf(pa[i], va[e], acc[i][g * 4 + e]);
      }
    }
  }
  if (a.tiles != nullptr && t == 0) atomicAdd(a.tiles, loaded);

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= a.seq) continue;   // a padded query row is never written
    const long long row = row0 + (long long)qpos * a.heads;
    const float dd = fmaxf(den[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < kNg; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = g * 64 + tx * 4 + e;
        if (d < dvn) a.out[row * a.dv + dv0 + d] = acc[i][g * 4 + e] / dd;
      }
    if (a.m_out != nullptr && tx == 0 && sv == 0) {
      a.m_out[row] = m[i];
      a.d_out[row] = den[i];
    }
  }
}

template <bool kRing, int DS>
int launch_wide_slice(const Args& a, const RingSend& ring, unsigned grid,
                      cudaStream_t s) {
  const size_t bytes = wide_smem_floats<DS>() * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_wide_kernel<kRing, DS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  flash_attention_wide_kernel<kRing, DS><<<grid, kThreads, bytes, s>>>(a,
                                                                        ring);
  return (int)cudaGetLastError();
}

template <bool kRing>
int launch_wide(const Args& a, const RingSend& ring, unsigned grid,
                cudaStream_t s) {
  return wide_slice(a.dv) == kDs
             ? launch_wide_slice<kRing, kDs>(a, ring, grid, s)
             : launch_wide_slice<kRing, 128>(a, ring, grid, s);
}

}  // namespace

extern "C" {

// Attention of the n_wh = W H (worker, head) pairs on `stream`: q, k
// (W, L, H, dh), v (W, L, H, dv), float32 (bf16 = 0) or bfloat16 (bf16 = 1),
// out (W, L, H, dv) float32, m_out and d_out (W, L, H) float32 or both null;
// all contiguous, dh, dv >= 1; dh and dv <= 128 take the instances of
// flash_attention_kernel, a wider head flash_attention_wide_kernel
// (ceil(dv / 256) blocks a query tile). A non-null
// `tiles` (one uint64 on the device) gains the KV tiles the blocks loaded.
// A non-null k_next and v_next (shaped as k and v) take the ring send, with
// cpr copy blocks a row; the rows are workers base .. base + w - 1 of
// nworkers; with remote = 1, plan is the call's ring_dma HopPlan, v_off the
// offset of v in a receive slot, ready the count the credit wait expects,
// err the error word and cid the collective id. Returns cudaGetLastError()
// after the launch (0 on success).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, void* m_out, void* d_out, void* tiles,
                           int w, int seq, int heads, int dh, int dv,
                           float scale, int causal, int bf16, void* stream,
                           void* k_next, void* v_next, int cpr,
                           long long v_off, const void* plan, int remote,
                           int base, int nworkers, unsigned long long ready,
                           void* err, int cid) {
  if (w < 1 || seq < 1 || heads < 1 || dh < 1 || dv < 1)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = static_cast<float*>(out);
  a.m_out = static_cast<float*>(m_out);
  a.d_out = static_cast<float*>(d_out);
  a.tiles = static_cast<unsigned long long*>(tiles);
  a.w_h = (long long)w * heads;
  a.n_q = (seq + kBQ - 1) / kBQ;
  a.seq = seq;
  a.heads = heads;
  a.dh = dh;
  a.dv = dv;
  a.scale = scale;
  a.causal = causal;
  a.bf16 = bf16;
  RingSend ring{};
  const bool send = k_next != nullptr && v_next != nullptr;
  if (send) {
    if (cpr < 1) return (int)cudaErrorInvalidValue;
    const long long es = bf16 ? 2 : 4;
    ring.remote = remote;
    ring.rows = w;
    ring.cpr = cpr;
    ring.base = base;
    ring.nworkers = nworkers;
    ring.k_next = static_cast<char*>(k_next);
    ring.v_next = static_cast<char*>(v_next);
    ring.kbytes = (long long)seq * heads * dh * es;
    ring.vbytes = (long long)seq * heads * dv * es;
    ring.v_off = v_off;
    if (plan != nullptr) memcpy(&ring.plan, plan, sizeof(ring.plan));
    ring.ready = ready;
    ring.err = static_cast<unsigned*>(err);
    ring.cid = (unsigned)cid;
  }
  const bool wide = dh > 128 || dv > 128;
  const int ds = wide_slice(dv);
  const long long grid = a.w_h * a.n_q * (wide ? (dv + ds - 1) / ds : 1) +
                         (send ? (long long)ring.rows * ring.cpr : 0);
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned g = (unsigned)grid;
  if (wide)
    return send ? launch_wide<true>(a, ring, g, s)
                : launch_wide<false>(a, RingSend{}, g, s);
  const RingSend* r = send ? &ring : nullptr;
  if (dh <= 64)
    return dv <= 64 ? launch<64, 64>(a, r, g, s) : launch<64, 128>(a, r, g, s);
  return dv <= 64 ? launch<128, 64>(a, r, g, s)
                  : launch<128, 128>(a, r, g, s);
}

}  // extern "C"
