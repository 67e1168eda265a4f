// One dense SGD-MF hop for Hopper (sm_90a): for every stacked worker, the
// masked stripe-GEMM update of its resident H block against one bucket of the
// NaN-coded bf16 rating slab, with pred and G never written to device memory.
//
// Replaces: harp_tpu/ops/pallas_kernels.py::_dense_mf_hop_kernel (the TPU
// kernel behind dense_mf_hop_pallas), with its in-kernel ring send
// (ring_hop, _ring_send at pallas_kernels.py:225-247). It computes the same
// function, which is the XLA stripe loop of
// harp_tpu/models/sgd_mf.py::_build_dense. For stripe i = 0 .. nmb-1 in order:
//   Wb = bf16(W_i)   Hb = bf16(H)
//   pred = Wb Hb^T                         (bf16 products, f32 sums)
//   G    = bf16(isnan(V_i) ? 0 : f32(V_i) - pred)
//   dW   = G Hb       dH = G^T Wb          (bf16 products, f32 sums)
//   W_i <- W_i + lr (dW - lam rc_i W_i)
//   H   <- H   + lr (dH - lam cc_i H)
//   sse += sum f32(G)^2
// Factors ride (rows, K) row-major, K zero-padded by the wrapper to KP = 16,
// 32, 64 or 128 (exact: zero factor columns stay zero and change nothing).
//
// What bounds it on this card: one read of the bf16 slab bucket (2 bytes a
// rating slot) against 6 rows cols K bf16 operations on the tensor cores. At
// the flagship (32768 x 32768, K = 32) that is 2.15 GB at 3.35 TB/s = 0.65 ms
// against 2.06e11 operations at 989 TFLOP/s = 0.21 ms, so it is bound by
// bytes. The design streams the slab exactly once and keeps everything else
// on chip:
//   * Each stripe reads only its own rows of W, and only their values from
//     before the hop, so a column tile of H evolves through all nmb stripes
//     independently of every other tile. One block owns one (worker, column
//     tile) for the whole hop: its H tile lives in shared memory (f32, plus
//     a bf16 copy as the MMA operand) and it walks the stripes in order with
//     no grid-wide synchronisation.
//   * Rows are taken R at a time: the V chunk (bf16) and the W chunk (f32)
//     of chunk g+1 are in flight (cp.async, double-buffered) while chunk g
//     is computed.
//   * The products are mma.sync m16n8k16 (bf16 operands from ldmatrix, f32
//     accumulators), the reference's own precision contract. The 8 warps
//     split a chunk into 16-row by CW-column pieces. A warp keeps its piece
//     of pred in registers, turns it into G in registers (reading V from
//     shared memory at the accumulator's own positions), and uses G's
//     registers directly as the A operand of dW = G Hb: the accumulator
//     layout of two n8 tiles is the A layout of one k16 step. G goes to
//     shared memory once, for the transposed operand of dH = G^T Wb, whose
//     accumulators stay in registers for the whole stripe.
//   * dW needs a sum over columns: the warps' partials meet in shared memory
//     and are summed in a fixed order per chunk; each block's sum over its
//     column tile goes to a workspace (W, n_ct, rpw, KP) f32, and a second
//     kernel sums the tiles in a fixed order and applies the W update (W's
//     update can wait for the hop's end because no later stripe reads an
//     earlier stripe's rows). The per-block SSE partials are summed the same
//     way. No float atomics, so two runs are bitwise equal.
//   The workspace costs a write and a read of n_ct rpw KP 4 bytes per hop
//   (0.54 GB at the flagship); a cluster reduction would remove it.
//
// The ring send (ring_hop). With h_next given, each block also writes its
// final H tile to the right neighbour, worker (g + 1) mod W, where the TPU
// kernel ships the whole updated block from VMEM after its last step. A
// block owns its tile through every stripe, so the tile is final when the
// block's own last stripe ends and it sends with no grid-wide step:
//   * neighbour in this launch (a stacked group, or a row of this process):
//     straight into h_next at the neighbour's row; stream order plays the
//     credit's role, as in ring_hop_kernel (ring_dma.cu);
//   * neighbour in another process (ring_dma.cuh): the launch's first block
//     gives every row's sender its credit before anything else; a block
//     whose tile is final looks once at its own credit (the receiver has
//     entered this call, so its IPC receive slot is free). If the credit is
//     in, it stores the tile into that slot, fences and signals its arrival;
//     if not, it marks the tile as left (sent = 0) and goes on. One arrival
//     a tile, n_ct a row a call, whoever sends it.
// No block of this launch ever spins. Its grid is not capped at the blocks
// the card holds at once, so a block spinning here (for a credit, or for its
// sender's tiles) could hold the SM that a block of this launch which has
// not sent yet needs, or, where the processes' launches run at once (MPS),
// the SM that the peer's first block needs to give the credit, while the
// peer waits the same way. The waits are in ring_recv_kernel (ring_dma.cu),
// launched after this kernel in stream order on a grid capped at its share
// of the card, as every spinning launch of the ring engine is: it waits for
// the credit and sends the tiles left here from h_out, then waits for its
// own sender's n_ct arrivals and copies the slot into h_next.
// The send adds one write of H (cpb KP 4 bytes a worker) to the hop's bytes.
//
// Layout: slab (W, n_blocks, rpw, cpb) bf16; bucket (W) int32, the block each
// worker updates this hop; w (W, rpw, KP) f32; h (W, cpb, KP) f32; row_cnt
// (W, n_blocks, rpw) f32; col_cnt (W, n_blocks, nmb_fine, cpb) f32, summed
// over nmb_fine / nmb adjacent fine stripes per stripe; all contiguous.
// cpb % 8 == 0 takes 16-byte cp.async loads of V; any other cpb loads V one
// element at a time. The host binding is a plain C interface loaded with
// ctypes (harp_tpu_torch/ops/_cuda_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "ring_dma.cuh"

namespace {

using ring_dma::HopPlan;

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kReduceThreads = 256;

constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

// Shapes per padded rank KP = 16 KT. A block owns CT columns; its 8 warps
// form WR row groups x WCG column groups of CW = CT / WCG columns; a warp
// takes NSUB 16-row pieces of each chunk of R = 16 WR NSUB rows. Chosen so
// the accumulators fit the registers and one block's shared memory stays
// under the 227 KB an H100 block may use (one block per SM).
template <int KT>
struct Geom {
  static constexpr int KP = 16 * KT;
  static constexpr int CT = KT <= 2 ? 256 : 128;
  static constexpr int WR = KT <= 4 ? 2 : 1;
  static constexpr int WCG = kWarps / WR;
  static constexpr int CW = CT / WCG;
  static constexpr int NSUB = KT <= 4 ? 2 : 1;
  static constexpr int R = 16 * WR * NSUB;
  static constexpr int LDV = CT + 8;      // bf16 row strides: 16-byte steps
  static constexpr int LDK = KP + 8;      // that spread rows over banks
  static constexpr int LDG = CW + 8;
  static constexpr int LDH = KP + 4;      // f32
  static constexpr int LDD = KP + 8;      // f32, float2 stores
  static constexpr size_t HS = 0;                                    // H f32
  static constexpr size_t HB = align128(HS + (size_t)CT * LDH * 4);  // H bf16
  static constexpr size_t V = align128(HB + (size_t)CT * LDK * 2);   // 2 x V
  static constexpr size_t WF = align128(V + (size_t)2 * R * LDV * 2);  // 2 x W
  static constexpr size_t WB = align128(WF + (size_t)2 * R * KP * 4);  // W bf16
  static constexpr size_t GS = align128(WB + (size_t)R * LDK * 2);     // G
  static constexpr size_t DW = align128(GS + (size_t)kWarps * 16 * LDG * 2);
  static constexpr size_t BYTES = DW + (size_t)WCG * R * LDD * 4;
  static_assert(CW % 16 == 0 && WR * WCG == kWarps, "warp split");
  static_assert(WR == 1 || CW <= R, "dH scratch must fit the dW buffer");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void ldsm4t(unsigned (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// d += a b: a 16x16 (row), b 16x8 (col), bf16; d 16x8 f32
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned as_u32(bf162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}

// The ring send of a hop launch; h_next null: no send. remote: the workers
// span processes (plan, ready and sent are used); base: global id of row 0;
// sent (W, n_ct): per tile bound for another process, 1 where its block
// sent it, 0 where it left it to the receive kernel.
struct RingSend {
  float* h_next;
  HopPlan plan;
  int remote;
  int base;
  int nworkers;
  unsigned long long ready;
  int* sent;
};

// H <- H + lr (dH - lam cnt H), in the reference's order of operations
__device__ __forceinline__ float sgd_step(float x, float d, float cnt,
                                          float lr, float lam) {
  const float reg = __fmul_rn(__fmul_rn(lam, cnt), x);
  return __fadd_rn(x, __fmul_rn(lr, __fsub_rn(d, reg)));
}

template <int KT>
__global__ void __launch_bounds__(kThreads, 1)
dense_mf_hop_kernel(const bf16* __restrict__ slab,
                    const int* __restrict__ bucket,
                    const float* __restrict__ w, const float* __restrict__ h,
                    const float* __restrict__ col_cnt,
                    float* __restrict__ h_out, float* __restrict__ ws,
                    float* __restrict__ sse_part, int n_blocks, int rpw,
                    int cpb, int nmb, int nmb_fine, float lr, float lam,
                    int vec, const RingSend ring) {
  using G = Geom<KT>;
  constexpr int KP = G::KP, CT = G::CT, CW = G::CW, R = G::R;
  constexpr int NT = CW / 8;     // n8 tiles of pred per piece
  constexpr int NK = KP / 8;     // n8 tiles over the rank
  constexpr int MT = CW / 16;    // m16 tiles of dH per warp
  extern __shared__ __align__(128) unsigned char smem[];
  float* hs = reinterpret_cast<float*>(smem + G::HS);
  bf16* hb = reinterpret_cast<bf16*>(smem + G::HB);
  bf16* vbuf = reinterpret_cast<bf16*>(smem + G::V);
  float* wf = reinterpret_cast<float*>(smem + G::WF);
  bf16* wb = reinterpret_cast<bf16*>(smem + G::WB);
  float* dwp = reinterpret_cast<float*>(smem + G::DW);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;        // accumulator row (and row + 8)
  const int tq = lane & 3;         // accumulator column pair
  const int rg = warp / G::WCG;    // this warp's row group
  const int wcg = warp % G::WCG;   // and column group
  const int cw0 = wcg * CW;
  bf16* gs = reinterpret_cast<bf16*>(smem + G::GS) + warp * 16 * G::LDG;
  // ldmatrix lane offsets: plain (rows by lane, 8-column halves by lane/16)
  // and for the two transposed forms
  const int lr8 = lane & 7;
  const int lh = (lane >> 3) & 1;
  const int lq = lane >> 4;

  const int ct = blockIdx.x;
  const int n_ct = gridDim.x;
  const int wk = blockIdx.y;
  const int c0 = ct * CT;
  const int ncols = min(CT, cpb - c0);
  const size_t blk = (size_t)wk * n_blocks + bucket[wk];
  const bf16* vsl = slab + blk * rpw * cpb;                // (rpw, cpb)
  const float* wwk = w + (size_t)wk * rpw * KP;            // (rpw, KP)
  const float* ccw = col_cnt + blk * nmb_fine * cpb;       // (nmb_fine, cpb)
  const int s_rows = rpw / nmb;
  const int ratio = nmb_fine / nmb;
  const int nch = (s_rows + R - 1) / R;
  const int total = nmb * nch;

  if (ring.h_next != nullptr && ring.remote)
    ring_dma::give_credits(ring.plan, gridDim.y);

  for (int e = tid; e < CT * KP; e += kThreads) {
    const int c = e / KP, k = e - c * KP;
    const float v = c < ncols ? h[((size_t)wk * cpb + c0 + c) * KP + k] : 0.f;
    hs[c * G::LDH + k] = v;
    hb[c * G::LDK + k] = __float2bfloat16_rn(v);
  }

  // chunk g: rows [row0, row0 + nr) of stripe g / nch; rows past the stripe
  // and columns past the block are zero-filled (and masked out of G)
  auto issue = [&](int g) {
    const int c = g % nch;
    const int row0 = (g / nch) * s_rows + c * R;
    const int nr = min(R, s_rows - c * R);
    bf16* vd = vbuf + (g & 1) * R * G::LDV;
    float* wd = wf + (g & 1) * R * KP;
    if (vec) {
      constexpr int U = CT / 8;
      for (int u = tid; u < R * U; u += kThreads) {
        const int r = u / U, col = (u - r * U) * 8;
        const bool ok = r < nr && col < ncols;
        cp_async16(vd + r * G::LDV + col,
                   ok ? vsl + (size_t)(row0 + r) * cpb + c0 + col : vsl,
                   ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < R * CT; e += kThreads) {
        const int r = e / CT, col = e - r * CT;
        vd[r * G::LDV + col] = (r < nr && col < ncols)
                                   ? vsl[(size_t)(row0 + r) * cpb + c0 + col]
                                   : __float2bfloat16_rn(0.f);
      }
    }
    constexpr int UW = KP / 4;
    for (int u = tid; u < R * UW; u += kThreads) {
      const int r = u / UW, k = (u - r * UW) * 4;
      const bool ok = r < nr;
      cp_async16(wd + r * KP + k,
                 ok ? wwk + (size_t)(row0 + r) * KP + k : wwk, ok ? 16 : 0);
    }
    cp_async_commit();
  };

  float dh[MT][NK][4];
  float sse = 0.f;
  issue(0);
  for (int g = 0; g < total; ++g) {
    const int i = g / nch;
    const int c = g - i * nch;
    const int row0 = i * s_rows + c * R;
    const int nr = min(R, s_rows - c * R);
    if (c == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NK; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) dh[mt][nt][q] = 0.f;
    }
    if (g + 1 < total) {
      issue(g + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // chunk g landed; chunk g-1's readers are done

    const float* wc = wf + (g & 1) * R * KP;
    for (int e = 2 * tid; e < R * KP; e += 2 * kThreads) {
      const int r = e / KP;
      *reinterpret_cast<bf162*>(wb + r * G::LDK + (e - r * KP)) =
          __floats2bfloat162_rn(wc[e], wc[e + 1]);
    }
    __syncthreads();

    const bf16* vg = vbuf + (g & 1) * R * G::LDV;
#pragma unroll
    for (int s = 0; s < G::NSUB; ++s) {
      const int rs = (s * G::WR + rg) * 16;   // the piece's first row

      // pred = Wb Hb^T over this warp's CW columns
      float acc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        unsigned a[4];
        ldsm4(a, wb + (rs + lr8 + 8 * lh) * G::LDK + 16 * kk + 8 * lq);
#pragma unroll
        for (int jj = 0; jj < NT / 2; ++jj) {
          unsigned b[4];
          ldsm4(b, hb + (cw0 + 16 * jj + lr8 + 8 * lq) * G::LDK + 16 * kk +
                       8 * lh);
          mma(acc[2 * jj], a, b[0], b[1]);
          mma(acc[2 * jj + 1], a, b[2], b[3]);
        }
      }

      // G = bf16(V - pred) where rated, in registers and in gs
      unsigned ga[NT / 2][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = cw0 + 8 * j + 2 * tq;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = rs + gq + 8 * hh;
          const float2 v = __bfloat1622float2(
              *reinterpret_cast<const bf162*>(vg + r * G::LDV + col));
          const bool rok = r < nr;
          const float g0 = (rok && col < ncols && !isnan(v.x))
                               ? v.x - acc[j][2 * hh] : 0.f;
          const float g1 = (rok && col + 1 < ncols && !isnan(v.y))
                               ? v.y - acc[j][2 * hh + 1] : 0.f;
          const bf162 gb = __floats2bfloat162_rn(g0, g1);
          const float2 gf = __bfloat1622float2(gb);
          sse += gf.x * gf.x + gf.y * gf.y;
          ga[j / 2][(j & 1) * 2 + hh] = as_u32(gb);
          *reinterpret_cast<bf162*>(gs + (gq + 8 * hh) * G::LDG + 8 * j +
                                    2 * tq) = gb;
        }
      }

      // dW partial = G Hb over this warp's columns -> dwp[wcg]
      float dw[NK][4];
#pragma unroll
      for (int nt = 0; nt < NK; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) dw[nt][q] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
#pragma unroll
        for (int nn = 0; nn < NK / 2; ++nn) {
          unsigned b[4];
          ldsm4t(b, hb + (cw0 + 16 * kk + lr8 + 8 * lh) * G::LDK + 16 * nn +
                        8 * lq);
          mma(dw[2 * nn], ga[kk], b[0], b[1]);
          mma(dw[2 * nn + 1], ga[kk], b[2], b[3]);
        }
      }
      float* dst = dwp + ((size_t)wcg * R + rs) * G::LDD;
#pragma unroll
      for (int nt = 0; nt < NK; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(dst + (gq + 8 * hh) * G::LDD + 8 * nt +
                                     2 * tq) =
              make_float2(dw[nt][2 * hh], dw[nt][2 * hh + 1]);
      __syncwarp();

      // dH += G^T Wb for this warp's columns, over the piece's 16 rows
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        unsigned a[4];
        ldsm4t(a, gs + (lr8 + 8 * lq) * G::LDG + 16 * mt + 8 * lh);
#pragma unroll
        for (int nn = 0; nn < NK / 2; ++nn) {
          unsigned b[4];
          ldsm4t(b, wb + (rs + lr8 + 8 * lh) * G::LDK + 16 * nn + 8 * lq);
          mma(dh[mt][2 * nn], a, b[0], b[1]);
          mma(dh[mt][2 * nn + 1], a, b[2], b[3]);
        }
      }
      __syncwarp();   // gs is rewritten by the next piece
    }
    __syncthreads();   // every warp's dW partial is in dwp

    // this block's dW for the chunk: the column groups summed in order
    float* out = ws + (((size_t)wk * n_ct + ct) * rpw + row0) * KP;
    for (int e = tid; e < R * KP; e += kThreads) {
      const int r = e / KP, k = e - r * KP;
      if (r < nr) {
        float t = 0.f;
#pragma unroll
        for (int q = 0; q < G::WCG; ++q) t += dwp[((size_t)q * R + r) * G::LDD + k];
        out[(size_t)r * KP + k] = t;
      }
    }

    if (c == nch - 1) {
      // stripe end: sum the row groups' dH (group 0 + group 1 ...) and
      // H <- H + lr (dH - lam cc_i H) on the columns group 0 owns
      float* scratch = dwp;   // CT x LDD f32 per extra row group
      __syncthreads();        // dwp reads are done
      if (G::WR > 1 && rg > 0) {
        float* sc = scratch + (size_t)(rg - 1) * CT * G::LDD;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NK; ++nt)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              *reinterpret_cast<float2*>(
                  sc + (cw0 + 16 * mt + gq + 8 * hh) * G::LDD + 8 * nt +
                  2 * tq) = make_float2(dh[mt][nt][2 * hh],
                                        dh[mt][nt][2 * hh + 1]);
      }
      __syncthreads();
      if (rg == 0) {
        const float* cci = ccw + (size_t)i * ratio * cpb + c0;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int col = cw0 + 16 * mt + gq + 8 * hh;
            float cnt = 0.f;
            if (col < ncols)
              for (int f = 0; f < ratio; ++f) cnt += cci[(size_t)f * cpb + col];
#pragma unroll
            for (int nt = 0; nt < NK; ++nt) {
              const int k = 8 * nt + 2 * tq;
              float d0 = dh[mt][nt][2 * hh], d1 = dh[mt][nt][2 * hh + 1];
#pragma unroll
              for (int q = 1; q < G::WR; ++q) {
                const float2 o = *reinterpret_cast<const float2*>(
                    scratch + ((size_t)(q - 1) * CT + col) * G::LDD + k);
                d0 += o.x;
                d1 += o.y;
              }
              float* hp = hs + col * G::LDH + k;
              const float h0 = sgd_step(hp[0], d0, cnt, lr, lam);
              const float h1 = sgd_step(hp[1], d1, cnt, lr, lam);
              hp[0] = h0;
              hp[1] = h1;
              *reinterpret_cast<bf162*>(hb + col * G::LDK + k) =
                  __floats2bfloat162_rn(h0, h1);
            }
          }
      }
    }
  }
  __syncthreads();

  // the final tile goes to h_out and, with the ring send, to the neighbour
  // (in another process only if its credit is in: no block spins here)
  float* hn = nullptr;
  bool remote_send = false;
  if (ring.h_next != nullptr) {
    const int d =
        ring_dma::ring_neighbor(ring.base + wk, ring.nworkers, 1) - ring.base;
    if (d >= 0 && d < (int)gridDim.y) {
      hn = ring.h_next + (size_t)d * cpb * KP;
    } else {
      int in = 0;
      if (tid == 0) {
        in = ring_dma::acquire_load(ring.plan.my_ready[wk]) >= ring.ready;
        __threadfence();
        ring.sent[(size_t)wk * n_ct + ct] = in;
      }
      remote_send = __syncthreads_or(in) != 0;
      if (remote_send) hn = reinterpret_cast<float*>(ring.plan.remote_dst[wk]);
    }
  }
  for (int e = tid; e < CT * KP; e += kThreads) {
    const int c = e / KP, k = e - c * KP;
    if (c < ncols) {
      const float v = hs[c * G::LDH + k];
      const size_t o = (size_t)(c0 + c) * KP + k;
      h_out[(size_t)wk * cpb * KP + o] = v;
      if (hn != nullptr) hn[o] = v;
    }
  }
  if (remote_send) ring_dma::signal_arrival(ring.plan.arrive_to[wk]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sse += __shfl_xor_sync(0xffffffffu, sse, off);
  if (lane == 0) dwp[warp] = sse;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int q = 0; q < kWarps; ++q) s += dwp[q];
    sse_part[(size_t)wk * n_ct + ct] = s;
  }
}

// W <- W + lr (sum over tiles of dW - lam rc W), the tiles summed in order;
// block 0 of each worker also sums its SSE partials in order.
__global__ void __launch_bounds__(kReduceThreads)
dense_mf_w_kernel(const float* __restrict__ w, const float* __restrict__ ws,
                  const float* __restrict__ row_cnt,
                  const int* __restrict__ bucket,
                  const float* __restrict__ sse_part, float* __restrict__ w_out,
                  float* __restrict__ sse_out, int n_blocks, int rpw, int kp,
                  int n_ct, float lr, float lam) {
  const int wk = blockIdx.y;
  const size_t n = (size_t)rpw * kp;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    float s = 0.f;
    for (int t = 0; t < n_ct; ++t) s += sse_part[(size_t)wk * n_ct + t];
    sse_out[wk] = s;
  }
  const size_t i = (size_t)blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= n) return;
  const float* p = ws + (size_t)wk * n_ct * n + i;
  float dw = 0.f;
  for (int t = 0; t < n_ct; ++t) dw += p[(size_t)t * n];
  const int row = (int)(i / kp);
  const float rc = row_cnt[((size_t)wk * n_blocks + bucket[wk]) * rpw + row];
  w_out[(size_t)wk * n + i] = sgd_step(w[(size_t)wk * n + i], dw, rc, lr, lam);
}

template <int KT>
int launch(const void* slab, const void* bucket, const void* w, const void* h,
           const void* row_cnt, const void* col_cnt, void* w_out, void* h_out,
           void* ws, void* sse_part, void* sse_out, int nw, int n_blocks,
           int rpw, int cpb, int nmb, int nmb_fine, float lr, float lam,
           const RingSend& ring, cudaStream_t s) {
  using G = Geom<KT>;
  cudaError_t err = cudaFuncSetAttribute(
      dense_mf_hop_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)G::BYTES);
  if (err != cudaSuccess) return (int)err;
  const int n_ct = (cpb + G::CT - 1) / G::CT;
  dense_mf_hop_kernel<KT><<<dim3(n_ct, nw), kThreads, G::BYTES, s>>>(
      static_cast<const bf16*>(slab), static_cast<const int*>(bucket),
      static_cast<const float*>(w), static_cast<const float*>(h),
      static_cast<const float*>(col_cnt), static_cast<float*>(h_out),
      static_cast<float*>(ws), static_cast<float*>(sse_part), n_blocks, rpw,
      cpb, nmb, nmb_fine, lr, lam, cpb % 8 == 0 ? 1 : 0, ring);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)rpw * G::KP;
  const int nb = (int)((n + kReduceThreads - 1) / kReduceThreads);
  dense_mf_w_kernel<<<dim3(nb, nw), kReduceThreads, 0, s>>>(
      static_cast<const float*>(w), static_cast<const float*>(ws),
      static_cast<const float*>(row_cnt), static_cast<const int*>(bucket),
      static_cast<const float*>(sse_part), static_cast<float*>(w_out),
      static_cast<float*>(sse_out), n_blocks, rpw, G::KP, n_ct, lr, lam);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Columns per block (the column tile) for padded rank kp; 0 if kp is not
// 16, 32, 64 or 128.
int dense_mf_hop_col_tile(int kp) {
  switch (kp) {
    case 16: return Geom<1>::CT;
    case 32: return Geom<2>::CT;
    case 64: return Geom<4>::CT;
    case 128: return Geom<8>::CT;
    default: return 0;
  }
}

// Bytes of dynamic shared memory one block uses for padded rank kp.
long long dense_mf_hop_smem_bytes(int kp) {
  switch (kp) {
    case 16: return (long long)Geom<1>::BYTES;
    case 32: return (long long)Geom<2>::BYTES;
    case 64: return (long long)Geom<4>::BYTES;
    case 128: return (long long)Geom<8>::BYTES;
    default: return 0;
  }
}

// Launch one hop for all nw workers and its W/SSE reduction on ``stream``.
// A non-null h_next (nw, cpb, kp) takes the ring send: rows of the launch
// are workers base .. base + nw - 1 of nworkers; with remote = 1, plan is
// the call's ring_dma HopPlan, ready the count its credit check expects and
// sent (nw, n_ct) int32 the tiles sent (1) or left to ring_recv_kernel (0).
// Returns cudaGetLastError() after the launches (0 on success).
int dense_mf_hop_launch(const void* slab, const void* bucket, const void* w,
                        const void* h, const void* row_cnt,
                        const void* col_cnt, void* w_out, void* h_out,
                        void* ws, void* sse_part, void* sse_out, int nw,
                        int n_blocks, int rpw, int cpb, int kp, int nmb,
                        int nmb_fine, float lr, float lam, void* stream,
                        void* h_next, const void* plan, int remote, int base,
                        int nworkers, unsigned long long ready, void* sent) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RingSend ring{};
  ring.h_next = static_cast<float*>(h_next);
  if (plan != nullptr) memcpy(&ring.plan, plan, sizeof(HopPlan));
  ring.remote = remote;
  ring.base = base;
  ring.nworkers = nworkers;
  ring.ready = ready;
  ring.sent = static_cast<int*>(sent);
#define HARP_MF_LAUNCH(KT)                                                   \
  return launch<KT>(slab, bucket, w, h, row_cnt, col_cnt, w_out, h_out, ws,  \
                    sse_part, sse_out, nw, n_blocks, rpw, cpb, nmb, nmb_fine, \
                    lr, lam, ring, s)
  switch (kp) {
    case 16: HARP_MF_LAUNCH(1);
    case 32: HARP_MF_LAUNCH(2);
    case 64: HARP_MF_LAUNCH(4);
    case 128: HARP_MF_LAUNCH(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef HARP_MF_LAUNCH
}

}  // extern "C"
