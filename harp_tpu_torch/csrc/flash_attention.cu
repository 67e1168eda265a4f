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
// Precision: float32, as the TPU kernel's. Scores are float32-accurate
// products of the inputs (a bf16 input is widened exactly), p stays float32
// in the p v product, and the sums are float32. One TF32 pass would move
// scores by about 1e-3, and rounding p to bf16, as FlashAttention does, is
// another function.
//
// What bounds it on this card: operations. At causal L = 16384, H = 8,
// Dh = Dv = 64 the work is (2 Dh + 2 Dv) H L (L + 1) / 2 = 2.75e11
// operations: 1.67 ms as three TF32 passes on the tensor cores (494.7
// TFLOP/s), 4.1 ms on the float32 CUDA cores (67 TFLOP/s), against 134 MB
// of q, k, v and out (0.04 ms at 3.35 TB/s).
//
// Design of the narrow kernel (Dh, Dv <= 128; wider heads take
// flash_attention_wide_kernel below). One block of 8 warps a (worker, head,
// 128-row query tile); a loop over 64-key tiles, the trapezoid's only.
//   * The feed: the block stages its q tile once; k and v tiles arrive by
//     16-byte cp.async copies into a ring of two stages, so tile j + 1 lands
//     while tile j is computed, with one barrier a tile. A bf16 tile is
//     copied as it lies and widened as its fragments are read. Rows are
//     padded (q and k by 16 elements, v by 16 bytes) so that every fragment
//     load (16 bytes of float32, 8 of bf16, a thread) meets no bank
//     conflict. Keys past L and columns past Dh and Dv are zero-filled by
//     the copies (src-size 0). Widths or pointers not 16-byte aligned take
//     a synchronous element-wise staging of the same layout.
//   * The math: both products on the tensor cores, mma.sync.m16n8k8 TF32,
//     as three passes lo hi' + hi lo' + hi hi', split in registers as the
//     fragments are loaded: hi = x rounded to TF32 (to nearest, ties away:
//     cvt.rna's rounding, done as an integer add and mask, which timed
//     faster than cvt.rna.tf32.f32 with the same bits), lo = the rest
//     rounded the same way. bf16 inputs are exact in TF32: q k^T takes one
//     pass, p v two (p's halves against v). wgmma is not used: TF32 wgmma
//     reads B only from shared memory, so the hi and lo parts of k need
//     planes of their own there, which at Dh = 128 leave no room for 8
//     warps an SM; at Dh <= 64, where they fit, q k^T on wgmma measured 6%
//     faster in float32 and 10% slower in bf16 (PERF.md). v (keys x Dv, Dv
//     contiguous) is not K-major, as TF32 wgmma requires.
//   * The accumulator boundary is the softmax step: the tensor core
//     truncates its running sums, so each step's p v starts from zero and
//     sums 64 keys (32 at Dv = 128), and the running acc stays in float32
//     registers as acc = fma(acc, alpha, step); q k^T sums Dh <= 128.
//   * The layout: a warp owns 16 query rows; a row's max and sum go over
//     its quad by shuffles. The score fragment of keys 8 jn .. 8 jn + 7 is
//     the A fragment of the p v product once its keys are read in the order
//     2 tq, 2 tq + 1: the v rows are loaded in that order, so p stays in
//     registers. The contraction index of q k^T is permuted the same way in
//     q and k so that each thread loads 4 consecutive elements, and v's
//     columns so that it loads 4 consecutive columns and writes 8.
//   * Registers: at Dv = 128 the online-softmax step is half a tile (32
//     keys) and p v takes 32 output columns at a time, so the scores, the
//     step's product and the 64-float accumulator fit 255 registers with
//     no spill (the step loop is kept rolled: unrolled, the compiler
//     overlapped the two steps and spilled); at Dv = 64 the step is the
//     tile, 64 columns at a time.
//   * A warp skips a tile whose rows all lie past L, and a step whose keys
//     all lie above its rows (the causal diagonal): m, den and acc would
//     not change.
// Shared memory a block (q 128 x (Dh + 16), 2 x k 64 x (Dh + 16), 2 x v 64
// x (Dv + 16 bytes)): float32 215,040 bytes at Dh/Dv 128/128, 182,272 at
// 128/64, 149,504 at 64/128, 116,736 at 64/64; bf16 108,544 at 128/128 to
// 59,392 at 64/64. One block an SM: 8 warps. Registers (ptxas, sm_90a):
// 253 at 128/128, 220 at 128/64, 255 at 64/128, 198 at 64/64, no spill.
// Blocks are issued heaviest causal tile first. No atomics, no sum across
// blocks: two runs are bitwise equal, and a stacked launch is bitwise W
// separate ones (the optional tile counter is the only atomic, and no
// output reads it).
//
// The ring send (ring_hop). The TPU kernel starts two whole-array copies of
// its k and v to the right neighbour at its first grid step and waits for
// them at its last, so the copy overlaps the whole pass. Here the launch
// carries rows x cpr extra copy blocks at the lowest block indices, issued
// before every attention block: they run in the first wave (a copy block
// holds its SM only while it moves its share, bound by bytes, while the
// attention blocks are bound by operations), and an attention block never
// waits for them. A row's copy blocks move k[r] and v[r] as they lie,
// (L, H, D), with no head-pack or padding pass, so the bytes that arrive
// are k and v bitwise:
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

// the wide kernel's tiles (the narrow kernel's are kNBQ x kNBK, below)
constexpr int kBQ = 64;            // query rows a block
constexpr int kBK = 64;            // keys a KV tile
constexpr int kThreads = 256;      // wide: 16 x 16, 4 rows x 4 keys each
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
  int n_q;           // query tiles of one (worker, head), the kernel's own
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

// ---------------------------------------------------------------------------
// The narrow kernel: Dh and Dv up to 128, on the tensor cores (the design is
// in the header note).
// ---------------------------------------------------------------------------

constexpr int kNBQ = 128;     // query rows a block: 8 warps of 16
constexpr int kNBK = 64;      // keys a KV tile
constexpr int kStages = 2;    // the k / v ring
static_assert(kNBQ == 16 * (kThreads / 32), "a warp owns 16 query rows");

// Shared memory of an instance: in elements of T (float, or the raw bits of
// a bf16) the q tile, then kStages k tiles and kStages v tiles, their rows
// padded (16 elements for q and k, 16 bytes for v) so that the fragment
// loads below meet no bank conflict.
template <int DK>
__host__ __device__ constexpr int narrow_lq() { return DK + 16; }
template <typename T, int DV>
__host__ __device__ constexpr int narrow_lv() {
  return DV + 16 / (int)sizeof(T);
}
template <typename T, int DK, int DV>
constexpr size_t narrow_smem_bytes() {
  return ((size_t)kNBQ * narrow_lq<DK>() +
          (size_t)kStages * kNBK * (narrow_lq<DK>() + narrow_lv<T, DV>())) *
         sizeof(T);
}

// x rounded to TF32, to nearest with ties away from zero: cvt.rna.tf32.f32's
// rounding of a finite x, as an integer add and mask on its bits
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo with both parts TF32: hi carries the top 11 bits, lo the next
// 11, so hi hi' + hi lo' + lo hi' is a float32-accurate product
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d += a b on the tensor core: a 16 x 8 (row-major fragment), b 8 x 8
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four consecutive elements of a shared-memory row, as float32 (a bf16 is
// widened exactly: its bits are the top half of the float's)
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void load4(const uint16_t* p, float (&x)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  x[0] = __uint_as_float(v.x << 16);
  x[1] = __uint_as_float(v.x & 0xffff0000u);
  x[2] = __uint_as_float(v.y << 16);
  x[3] = __uint_as_float(v.y & 0xffff0000u);
}

// 16 bytes from global to shared memory, asynchronously; bytes = 0 writes
// zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Rows first .. first + rows - 1 of one (worker, head) of a (W, L, H, width)
// input into a shared tile of D columns and row length ld, zero past the
// sequence and past width. With vec, as 16-byte asynchronous copies (the
// caller commits and waits); otherwise element by element, synchronously.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const void* src_v,
                                           long long row0, int heads,
                                           int width, int first, int rows,
                                           int seq, bool vec) {
  const T* src = static_cast<const T*>(src_v);
  if (vec) {
    constexpr int kEpc = 16 / (int)sizeof(T);   // elements a copy
    constexpr int kCpr = D / kEpc;              // copies a row
    for (int i = threadIdx.x; i < rows * kCpr; i += kThreads) {
      const int r = i / kCpr, c = i % kCpr, l = first + r;
      const bool live = l < seq && c * kEpc < width;
      cp_async16(dst + r * ld + c * kEpc,
                 live ? src + (row0 + (long long)l * heads) * width + c * kEpc
                      : src,
                 live ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * D; i += kThreads) {
      const int r = i / D, d = i % D, l = first + r;
      dst[r * ld + d] = (l < seq && d < width)
          ? src[(row0 + (long long)l * heads) * width + d]
          : T(0);
    }
  }
}

// One block of the narrow kernel: 128 query rows of one (worker, head).
template <int DK, int DV, typename T>
__device__ __forceinline__ void attend(const Args& a, long long blk) {
  constexpr bool kF32 = sizeof(T) == 4;   // else bf16: exact in TF32
  constexpr int kLq = narrow_lq<DK>(), kLv = narrow_lv<T, DV>();
  // output columns of the p v product at a time (32 at Dv = 128 leaves
  // registers for the accumulator)
  constexpr int kCols = DV == 128 ? 32 : 64;
  // keys an online-softmax step: the tile, or at Dv = 128 half of it (its
  // scores and the step's p v in registers beside the accumulator)
  constexpr int kSub = DV == 128 ? 32 : kNBK;
  constexpr int kNb = kSub / 8;   // 8-key blocks a step
  extern __shared__ float4 smem4[];
  T* qs = reinterpret_cast<T*>(smem4);            // [kNBQ][kLq]
  T* ks = qs + kNBQ * kLq;                        // [kStages][kNBK][kLq]
  T* vs = ks + kStages * kNBK * kLq;              // [kStages][kNBK][kLv]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;         // the mma fragment's row, col
  const int iq = a.n_q - 1 - (int)(blk / a.w_h);  // heaviest tiles first
  const long long pair = blk % a.w_h;             // w H + h
  const long long w = pair / a.heads;
  const long long row0 = w * a.seq * a.heads + pair % a.heads;  // l = 0
  const int q0 = iq * kNBQ;
  const int qw = q0 + warp * 16;                  // the warp's first row
  constexpr int kEpc = 16 / (int)sizeof(T);
  const bool vec = a.dh % kEpc == 0 && a.dv % kEpc == 0 &&
                   ((reinterpret_cast<uintptr_t>(a.q) |
                     reinterpret_cast<uintptr_t>(a.k) |
                     reinterpret_cast<uintptr_t>(a.v)) & 15) == 0;

  const int n_kv = (a.seq + kNBK - 1) / kNBK;
  const int n_vis = a.causal ? min(n_kv, (q0 + kNBQ + kNBK - 1) / kNBK) : n_kv;
  auto stage_kv = [&](int j) {
    const int st = j % kStages;
    stage_rows<T, DK>(ks + st * kNBK * kLq, kLq, a.k, row0, a.heads, a.dh,
                      j * kNBK, kNBK, a.seq, vec);
    stage_rows<T, DV>(vs + st * kNBK * kLv, kLv, a.v, row0, a.heads, a.dv,
                      j * kNBK, kNBK, a.seq, vec);
    cp_async_commit();
  };
  stage_rows<T, DK>(qs, kLq, a.q, row0, a.heads, a.dh, q0, kNBQ, a.seq, vec);
  stage_kv(0);

  // rows g (e = 0, 1) and g + 8 (e = 2, 3) of the warp's 16
  float m[2] = {kMasked, kMasked}, den[2] = {0.f, 0.f};
  float acc[DV / 8][4];
#pragma unroll
  for (int c = 0; c < DV / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;

  for (int j = 0; j < n_vis; ++j) {
    cp_async_wait_all();
    __syncthreads();   // tile j landed; every warp is done with tile j - 1
    if (j + 1 < n_vis) stage_kv(j + 1);   // into tile j - 1's stage
    if (qw >= a.seq) continue;   // the warp's rows are all padding
    const T* kt = ks + (j % kStages) * kNBK * kLq;
    const T* vt = vs + (j % kStages) * kNBK * kLv;
#pragma unroll 1
    for (int sub = 0; sub < kNBK / kSub; ++sub) {
      const int k0 = j * kNBK + sub * kSub;
      // keys all above the warp's rows would leave m, den and acc as they
      // are, and so would every later step's
      if (a.causal && k0 > qw + 15) break;

      // s = q k^T: key block jn's fragment holds keys k0 + 8 jn + 2 tq +
      // (e & 1). Depth is taken 16 at a time, thread tq holding d = 4 tq ..
      // 4 tq + 3 of both q rows and of its key: d 4 tq + 2 st and
      // 4 tq + 2 st + 1 are k-step st's columns tq and tq + 4 (a
      // permutation of d, the same in q and k).
      float s[kNb][4];
#pragma unroll
      for (int jn = 0; jn < kNb; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[jn][e] = 0.f;
      const T* qa = qs + (warp * 16 + g) * kLq + 4 * tq;
      const T* kb = kt + (sub * kSub + g) * kLq + 4 * tq;
#pragma unroll
      for (int u = 0; u < DK / 16; ++u) {
        float x0[4], x1[4];
        load4(qa + 16 * u, x0);
        load4(qa + 8 * kLq + 16 * u, x1);
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int st = 0; st < 2; ++st) {
          const float av[4] = {x0[2 * st], x1[2 * st], x0[2 * st + 1],
                               x1[2 * st + 1]};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if constexpr (kF32) tf32_split(av[e], ah[st][e], al[st][e]);
            else ah[st][e] = __float_as_uint(av[e]);
          }
        }
#pragma unroll
        for (int jn = 0; jn < kNb; ++jn) {
          float y[4];
          load4(kb + jn * 8 * kLq + 16 * u, y);
#pragma unroll
          for (int st = 0; st < 2; ++st) {
            if constexpr (kF32) {
              uint32_t b0h, b0l, b1h, b1l;
              tf32_split(y[2 * st], b0h, b0l);
              tf32_split(y[2 * st + 1], b1h, b1l);
              mma_tf32(s[jn], al[st], b0h, b1h);
              mma_tf32(s[jn], ah[st], b0l, b1l);
              mma_tf32(s[jn], ah[st], b0h, b1h);
            } else {
              mma_tf32(s[jn], ah[st], __float_as_uint(y[2 * st]),
                       __float_as_uint(y[2 * st + 1]));
            }
          }
        }
      }

      // the online softmax of the TPU kernel, a row's scores over its quad
      const bool edge =
          k0 + kSub > a.seq || (a.causal && k0 + kSub - 1 > qw);
      float mx[2] = {kMasked, kMasked};
#pragma unroll
      for (int jn = 0; jn < kNb; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (edge) {
            const int key = k0 + 8 * jn + 2 * tq + (e & 1);
            const int row = qw + g + 8 * (e >> 1);
            const bool live = key < a.seq && (!a.causal || row >= key);
            s[jn][e] = live ? s[jn][e] * a.scale : kMasked;
          } else {
            s[jn][e] *= a.scale;
          }
          mx[e >> 1] = fmaxf(mx[e >> 1], s[jn][e]);
        }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
        mx[h] = fmaxf(m[h], mx[h]);
        alpha[h] = expf(m[h] - mx[h]);
        m[h] = mx[h];
      }
#pragma unroll
      for (int jn = 0; jn < kNb; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[jn][e] = expf(s[jn][e] - mx[e >> 1]);
          sum[e >> 1] += s[jn][e];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(kFull, sum[h], 1);
        sum[h] += __shfl_xor_sync(kFull, sum[h], 2);
        den[h] = den[h] * alpha[h] + sum[h];
      }

      // acc = acc alpha + p v, the step's p v summed from zero on the
      // tensor core and added once, kCols columns at a time. p's fragment
      // of keys 8 jn .. is the A fragment as it lies, its key order (2 tq,
      // 2 tq + 1 for columns tq, tq + 4) taken into the rows of v that are
      // loaded. Output block c = 4 c1 + c0: fragment column n is v's column
      // 32 c1 + 4 n + c0, so thread g reads v[key][32 c1 + 4 g .. + 3] for
      // four blocks and holds out columns 32 c1 + 8 tq .. + 7.
      const T* vb = vt + (sub * kSub + 2 * tq) * kLv + 4 * g;
#pragma unroll
      for (int cg = 0; cg < DV / kCols; ++cg) {
        float o[kCols / 8][4];
#pragma unroll
        for (int c = 0; c < kCols / 8; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[c][e] = 0.f;
#pragma unroll
        for (int jn = 0; jn < kNb; ++jn) {
          // A fragment order: (g, key 2 tq), (g + 8, 2 tq), (g, 2 tq + 1),
          // (g + 8, 2 tq + 1)
          uint32_t ph[4], pl[4];
          tf32_split(s[jn][0], ph[0], pl[0]);
          tf32_split(s[jn][2], ph[1], pl[1]);
          tf32_split(s[jn][1], ph[2], pl[2]);
          tf32_split(s[jn][3], ph[3], pl[3]);
#pragma unroll
          for (int c1 = 0; c1 < kCols / 32; ++c1) {
            const T* vr = vb + 8 * jn * kLv + kCols * cg + 32 * c1;
            float y0[4], y1[4];   // keys 8 jn + 2 tq and 8 jn + 2 tq + 1
            load4(vr, y0);
            load4(vr + kLv, y1);
#pragma unroll
            for (int c0 = 0; c0 < 4; ++c0) {
              float (&oc)[4] = o[4 * c1 + c0];
              if constexpr (kF32) {
                uint32_t b0h, b0l, b1h, b1l;
                tf32_split(y0[c0], b0h, b0l);
                tf32_split(y1[c0], b1h, b1l);
                mma_tf32(oc, pl, b0h, b1h);
                mma_tf32(oc, ph, b0l, b1l);
                mma_tf32(oc, ph, b0h, b1h);
              } else {
                const uint32_t b0 = __float_as_uint(y0[c0]);
                const uint32_t b1 = __float_as_uint(y1[c0]);
                mma_tf32(oc, pl, b0, b1);
                mma_tf32(oc, ph, b0, b1);
              }
            }
          }
        }
#pragma unroll
        for (int c = 0; c < kCols / 8; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& ac = acc[kCols / 8 * cg + c][e];
            ac = fmaf(ac, alpha[e >> 1], o[c][e]);
          }
      }
    }
  }
  if (a.tiles != nullptr && threadIdx.x == 0)
    atomicAdd(a.tiles, (unsigned long long)n_vis);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qpos = qw + g + 8 * h;
    if (qpos >= a.seq) continue;   // a padded query row is never written
    const long long row = row0 + (long long)qpos * a.heads;
    const float dd = fmaxf(den[h], 1e-30f);
    float* orow = a.out + row * a.dv;
#pragma unroll
    for (int c1 = 0; c1 < DV / 32; ++c1)
#pragma unroll
      for (int c0 = 0; c0 < 4; ++c0)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = 32 * c1 + 8 * tq + 4 * e + c0;
          if (d < a.dv) orow[d] = acc[4 * c1 + c0][2 * h + e] / dd;
        }
    if (a.m_out != nullptr && tq == 0) {
      a.m_out[row] = m[h];
      a.d_out[row] = den[h];
    }
  }
}

// out[w, l, h, :] lies at row (w L + l) H + h of a (rows, D) matrix.
template <int DK, int DV, bool kRing>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_kernel(const Args a, const RingSend ring) {
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
  if (a.bf16)
    attend<DK, DV, uint16_t>(a, blk);
  else
    attend<DK, DV, float>(a, blk);
}

template <int DK, int DV, bool kRing>
int launch(const Args& a, const RingSend& ring, unsigned grid,
           cudaStream_t s) {
  const size_t bytes = a.bf16 ? narrow_smem_bytes<uint16_t, DK, DV>()
                              : narrow_smem_bytes<float, DK, DV>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel<DK, DV, kRing>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)narrow_smem_bytes<float, DK, DV>());
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
// The kernel above holds its whole q tile, two k tiles and two v tiles in
// shared memory and DV / 2 accumulator floats a thread: at DK = DV = 256
// neither would fit. Its instances stay as they are (their parameters and
// code decide their speed: see RingSend), and a wider head takes this
// kernel, on its own 64 x 64 tiles and the CUDA cores, which cuts both
// widths:
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
// The update rule, masking, trapezoid, heaviest-first order and the ring
// send's copy blocks are the kernel's above, and every product is a float32
// FMA on the CUDA cores; a slice's blocks
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
  if (!wide) a.n_q = (seq + kNBQ - 1) / kNBQ;   // the narrow kernel's tiles
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
