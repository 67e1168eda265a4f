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
// 32, 64 or 128 (exact: zero factor columns stay zero and change nothing);
// a wider K takes the wide path below (KP = 256, 512 or 1024).
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

// ---------------------------------------------------------------------------
// The wide path, 128 < K <= 1024 (KP = 256, 512 or 1024).
//
// Where the kernel above stops: its block holds the H tile (CT x KP, f32
// and bf16) in shared memory and each warp a CW x KP piece of dH in
// registers, and it sums dW over the column tiles through a (W, n_ct, rpw,
// KP) workspace. At KP = 256 the tile no longer fits beside the chunk
// buffers at CT = 128, a warp's dH would be 128 floats a thread, and the
// workspace, 2 KP / CT times the slab's bytes, would be 17 GB at the
// flagship. So the wide path keeps the block's ownership of one (worker,
// column tile) through all nmb stripes, and changes three things:
//   * The rank is split across the warps: warp q owns rank columns
//     [q KP / 8, (q + 1) KP / 8). CT = 16384 / KP (64, 32, 16), so the
//     block's dH tile (CT x KP f32) is 64 floats a thread in registers,
//     warp q holding dH[:, its columns], and its H tile is 64 KB of f32 and
//     32 KB of bf16 in shared memory whatever KP is.
//   * pred = Wb Hb^T for a chunk of R = 16 rows: each warp multiplies its
//     rank columns (R x CT partial sums), the 8 partials meet in shared
//     memory and are summed in warp order. G = bf16(V - pred) is formed
//     once per chunk by the whole block, into shared memory (the operand of
//     dH += G^T Wb, each warp on its own rank columns) and into a G buffer
//     in device memory (W, rpw, cpb8) bf16, cpb8 = cpb rounded up to 8.
//   * dW is not summed over column tiles at all: at each stripe's start a
//     block writes its bf16 H tile to a snapshot (W, nmb, cpb8, KP), and
//     after the hop one GEMM kernel forms dW_i = G_i Hb_i for every stripe
//     i over the full cpb (a fixed order of sums: no atomics, two runs
//     bitwise equal) and applies the W update in its epilogue. The G buffer
//     and the snapshots cost one write and one read of rpw cpb 2 and nmb
//     cpb KP 2 bytes a worker, in place of the workspace's 2 KP / CT slabs.
//   Wb, the bf16 W of the bucket's rows, is written once per hop by a small
//   kernel, so a block streams its chunks with 16-byte cp.async loads in
//   the MMA operand's type, double-buffered like V.
// The ring send of the final tile, the SSE partials and their fixed-order
// sum are the kernel's above. KP = 1024 is the widest: there CT is 16, one
// m16 tile, and a wider rank would need dH outside registers.
// What bounds it: operations. At rank 256 on the flagship the hop is 6 rpw
// cpb K = 1.65e12 bf16 tensor-core operations (1.67 ms at 989 TFLOP/s)
// against the slab's 2.15 GB (0.64 ms). The 8-way partial sums of pred
// and three barriers a 16-row chunk, and every column tile's read of Wb
// (KP / CT = 4 times the narrow kernel's at rank 256), stand between it and
// that bound; larger chunks and a pred split over columns are the levers.
// ---------------------------------------------------------------------------

constexpr int kWideRows = 16;          // rows a chunk
constexpr int kWideTile = 16384;       // CT x KP: 64 dH floats a thread
constexpr int kGemmThreads = 128;      // dW GEMM: 4 warps, 64 x 64 tile
constexpr int kGemmBM = 64;
constexpr int kGemmBN = 64;
constexpr int kGemmBK = 32;

template <int KP_>
struct WideGeom {
  static constexpr int KP = KP_;
  static constexpr int CT = kWideTile / KP;
  static constexpr int R = kWideRows;
  static constexpr int KW = KP / kWarps;    // rank columns a warp owns
  static constexpr int MT = CT / 16;        // m16 tiles of dH (H columns)
  static constexpr int NK = KW / 8;         // n8 tiles of dH (rank)
  static constexpr int NT = CT / 8;         // n8 tiles of pred (H columns)
  static constexpr int LDK = KP + 8;        // bf16 rows over the rank
  static constexpr int LDH = KP + 4;        // f32
  static constexpr int LDV = CT + 8;        // bf16 rows over the columns
  static constexpr int LDP = CT + 4;        // f32 partial pred
  static constexpr size_t HS = 0;                                     // H f32
  static constexpr size_t HB = align128(HS + (size_t)CT * LDH * 4);   // bf16
  static constexpr size_t V = align128(HB + (size_t)CT * LDK * 2);    // 2 x V
  static constexpr size_t WB = align128(V + (size_t)2 * R * LDV * 2); // 2 x Wb
  static constexpr size_t GS = align128(WB + (size_t)2 * R * LDK * 2);  // G
  static constexpr size_t PP = align128(GS + (size_t)R * LDV * 2);
  static constexpr size_t BYTES = PP + (size_t)kWarps * R * LDP * 4;
  static_assert(MT * NK == 16, "64 dH floats a thread");
  static_assert(KW % 16 == 0 && CT % 16 == 0, "whole mma tiles");
};

__global__ void dense_mf_wbf16_kernel(const float* __restrict__ w,
                                      bf16* __restrict__ wb, size_t n) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    wb[i] = __float2bfloat16_rn(w[i]);
}

template <int KP>
__global__ void __launch_bounds__(kThreads, 1)
dense_mf_hop_wide_kernel(const bf16* __restrict__ slab,
                         const int* __restrict__ bucket,
                         const bf16* __restrict__ wbf,
                         const float* __restrict__ h,
                         const float* __restrict__ col_cnt,
                         float* __restrict__ h_out, bf16* __restrict__ gout,
                         bf16* __restrict__ hsnap,
                         float* __restrict__ sse_part, int n_blocks, int rpw,
                         int cpb, int nmb, int nmb_fine, float lr, float lam,
                         int vec, const RingSend ring) {
  using G = WideGeom<KP>;
  constexpr int CT = G::CT, R = G::R, KW = G::KW;
  constexpr int MT = G::MT, NK = G::NK, NT = G::NT;
  extern __shared__ __align__(128) unsigned char smem[];
  float* hs = reinterpret_cast<float*>(smem + G::HS);
  bf16* hb = reinterpret_cast<bf16*>(smem + G::HB);
  bf16* vbuf = reinterpret_cast<bf16*>(smem + G::V);
  bf16* wbuf = reinterpret_cast<bf16*>(smem + G::WB);
  bf16* gs = reinterpret_cast<bf16*>(smem + G::GS);
  float* pp = reinterpret_cast<float*>(smem + G::PP);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int lr8 = lane & 7;
  const int lh = (lane >> 3) & 1;
  const int lq = lane >> 4;
  const int kw0 = warp * KW;      // this warp's rank columns

  const int ct = blockIdx.x;
  const int n_ct = gridDim.x;
  const int wk = blockIdx.y;
  const int c0 = ct * CT;
  const int ncols = min(CT, cpb - c0);
  const int cpb8 = (cpb + 7) / 8 * 8;
  const int ncols8 = min(CT, cpb8 - c0);   // G and snapshot columns written
  const size_t blk = (size_t)wk * n_blocks + bucket[wk];
  const bf16* vsl = slab + blk * rpw * cpb;                 // (rpw, cpb)
  const bf16* wwk = wbf + (size_t)wk * rpw * KP;            // (rpw, KP)
  const float* ccw = col_cnt + blk * nmb_fine * cpb;        // (nmb_fine, cpb)
  bf16* gwk = gout + (size_t)wk * rpw * cpb8;               // (rpw, cpb8)
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

  // chunk g: rows [row0, row0 + nr) of stripe g / nch, zero-filled past the
  // stripe (and V past the block's columns)
  auto issue = [&](int g) {
    const int c = g % nch;
    const int row0 = (g / nch) * s_rows + c * R;
    const int nr = min(R, s_rows - c * R);
    bf16* vd = vbuf + (g & 1) * R * G::LDV;
    bf16* wd = wbuf + (g & 1) * R * G::LDK;
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
    constexpr int UW = KP / 8;
    for (int u = tid; u < R * UW; u += kThreads) {
      const int r = u / UW, k = (u - r * UW) * 8;
      const bool ok = r < nr;
      cp_async16(wd + r * G::LDK + k,
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
    cp_async_wait<0>();
    __syncthreads();   // chunk g landed; chunk g-1's readers are done
    if (g + 1 < total) issue(g + 1);
    if (c == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NK; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) dh[mt][nt][q] = 0.f;
      // stripe i's Hb, the B operand of its dW, for this warp's columns
      constexpr int UK = KW / 8;
      bf16* snap = hsnap + (((size_t)wk * nmb + i) * cpb8 + c0) * KP;
      for (int u = lane; u < ncols8 * UK; u += 32) {
        const int col = u / UK, k = kw0 + (u - col * UK) * 8;
        *reinterpret_cast<uint4*>(snap + (size_t)col * KP + k) =
            *reinterpret_cast<const uint4*>(hb + col * G::LDK + k);
      }
    }
    const bf16* vg = vbuf + (g & 1) * R * G::LDV;
    const bf16* wg = wbuf + (g & 1) * R * G::LDK;

    // this warp's share of pred = Wb Hb^T: its rank columns, all CT columns
    {
      float acc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KW / 16; ++kk) {
        unsigned a[4];
        ldsm4(a, wg + (lr8 + 8 * lh) * G::LDK + kw0 + 16 * kk + 8 * lq);
#pragma unroll
        for (int jj = 0; jj < NT / 2; ++jj) {
          unsigned b[4];
          ldsm4(b, hb + (16 * jj + lr8 + 8 * lq) * G::LDK + kw0 + 16 * kk +
                       8 * lh);
          mma(acc[2 * jj], a, b[0], b[1]);
          mma(acc[2 * jj + 1], a, b[2], b[3]);
        }
      }
      float* dst = pp + (size_t)warp * R * G::LDP;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(dst + (gq + 8 * hh) * G::LDP + 8 * j +
                                     2 * tq) =
              make_float2(acc[j][2 * hh], acc[j][2 * hh + 1]);
    }
    __syncthreads();

    // G = bf16(V - pred) where rated, the partials summed in warp order
    for (int e = tid; e < R * CT; e += kThreads) {
      const int r = e / CT, col = e - r * CT;
      float pred = 0.f;
#pragma unroll
      for (int q = 0; q < kWarps; ++q)
        pred += pp[((size_t)q * R + r) * G::LDP + col];
      const float v = __bfloat162float(vg[r * G::LDV + col]);
      const bool live = r < nr && col < ncols && !isnan(v);
      const bf16 gb = __float2bfloat16_rn(live ? v - pred : 0.f);
      const float gf = __bfloat162float(gb);
      sse += gf * gf;
      gs[r * G::LDV + col] = gb;
      if (r < nr && col < ncols8)
        gwk[(size_t)(row0 + r) * cpb8 + c0 + col] = gb;
    }
    __syncthreads();

    // dH += G^T Wb over the chunk's rows, this warp's rank columns
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      unsigned a[4];
      ldsm4t(a, gs + (lr8 + 8 * lq) * G::LDV + 16 * mt + 8 * lh);
#pragma unroll
      for (int nn = 0; nn < NK / 2; ++nn) {
        unsigned b[4];
        ldsm4t(b, wg + (lr8 + 8 * lh) * G::LDK + kw0 + 16 * nn + 8 * lq);
        mma(dh[mt][2 * nn], a, b[0], b[1]);
        mma(dh[mt][2 * nn + 1], a, b[2], b[3]);
      }
    }

    if (c == nch - 1) {
      // stripe end: H <- H + lr (dH - lam cc_i H) on this warp's columns
      const float* cci = ccw + (size_t)i * ratio * cpb + c0;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int col = 16 * mt + gq + 8 * hh;
          float cnt = 0.f;
          if (col < ncols)
            for (int f = 0; f < ratio; ++f) cnt += cci[(size_t)f * cpb + col];
#pragma unroll
          for (int nt = 0; nt < NK; ++nt) {
            const int k = kw0 + 8 * nt + 2 * tq;
            float* hp = hs + col * G::LDH + k;
            const float h0 = sgd_step(hp[0], dh[mt][nt][2 * hh], cnt, lr, lam);
            const float h1 =
                sgd_step(hp[1], dh[mt][nt][2 * hh + 1], cnt, lr, lam);
            hp[0] = h0;
            hp[1] = h1;
            *reinterpret_cast<bf162*>(hb + col * G::LDK + k) =
                __floats2bfloat162_rn(h0, h1);
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
  if (lane == 0) pp[warp] = sse;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int q = 0; q < kWarps; ++q) s += pp[q];
    sse_part[(size_t)wk * n_ct + ct] = s;
  }
}

// dW_i = G_i Hb_i for every stripe i (the G rows of the stripe against its
// H snapshot, a sum over all cpb8 columns in order), then W <- W + lr (dW
// - lam rc W). One block a 64-row x 64-rank tile of one stripe; 4 warps of
// 32 x 32; bf16 tiles of 32 columns double-buffered by cp.async. Block
// (0, 0) of each worker also sums its SSE partials in order.
__global__ void __launch_bounds__(kGemmThreads)
dense_mf_dw_kernel(const bf16* __restrict__ gbuf,
                   const bf16* __restrict__ hsnap,
                   const float* __restrict__ w,
                   const float* __restrict__ row_cnt,
                   const int* __restrict__ bucket,
                   const float* __restrict__ sse_part,
                   float* __restrict__ w_out, float* __restrict__ sse_out,
                   int n_blocks, int rpw, int cpb8, int kp, int nmb, int n_ct,
                   float lr, float lam) {
  constexpr int LDA = kGemmBK + 8, LDB = kGemmBN + 8;
  __shared__ __align__(128) bf16 as[2][kGemmBM * LDA];
  __shared__ __align__(128) bf16 bs[2][kGemmBK * LDB];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int lr8 = lane & 7;
  const int lh = (lane >> 3) & 1;
  const int lq = lane >> 4;
  const int wm = warp >> 1, wn = warp & 1;
  const int wk = blockIdx.z;
  const int s_rows = rpw / nmb;
  const int tiles_i = (s_rows + kGemmBM - 1) / kGemmBM;
  const int i = blockIdx.x / tiles_i;
  const int rs0 = (blockIdx.x - i * tiles_i) * kGemmBM;   // in the stripe
  const int nr = min(kGemmBM, s_rows - rs0);
  const int row0 = i * s_rows + rs0;
  const int n0 = blockIdx.y * kGemmBN;
  if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0) {
    float s = 0.f;
    for (int t = 0; t < n_ct; ++t) s += sse_part[(size_t)wk * n_ct + t];
    sse_out[wk] = s;
  }
  const bf16* ga = gbuf + ((size_t)wk * rpw + row0) * cpb8;
  const bf16* hbk = hsnap + ((size_t)wk * nmb + i) * cpb8 * kp + n0;
  const int nkt = (cpb8 + kGemmBK - 1) / kGemmBK;

  auto issue = [&](int t) {
    const int k0 = t * kGemmBK;
    bf16* ad = as[t & 1];
    bf16* bd = bs[t & 1];
    for (int u = tid; u < kGemmBM * (kGemmBK / 8); u += kGemmThreads) {
      const int r = u / (kGemmBK / 8), k = (u % (kGemmBK / 8)) * 8;
      const bool ok = r < nr && k0 + k < cpb8;
      cp_async16(ad + r * LDA + k, ok ? ga + (size_t)r * cpb8 + k0 + k : ga,
                 ok ? 16 : 0);
    }
    for (int u = tid; u < kGemmBK * (kGemmBN / 8); u += kGemmThreads) {
      const int r = u / (kGemmBN / 8), n = (u % (kGemmBN / 8)) * 8;
      const bool ok = k0 + r < cpb8;
      cp_async16(bd + r * LDB + n, ok ? hbk + (size_t)(k0 + r) * kp + n : hbk,
                 ok ? 16 : 0);
    }
    cp_async_commit();
  };

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][nj][q] = 0.f;
  issue(0);
  for (int t = 0; t < nkt; ++t) {
    cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < nkt) issue(t + 1);
    const bf16* a_s = as[t & 1];
    const bf16* b_s = bs[t & 1];
#pragma unroll
    for (int kk = 0; kk < kGemmBK / 16; ++kk) {
      unsigned a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm4(a[mi], a_s + (wm * 32 + 16 * mi + lr8 + 8 * lh) * LDA +
                         16 * kk + 8 * lq);
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        unsigned b[4];
        ldsm4t(b, b_s + (16 * kk + lr8 + 8 * lh) * LDB + wn * 32 + 16 * nn +
                      8 * lq);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma(acc[mi][2 * nn], a[mi], b[0], b[1]);
          mma(acc[mi][2 * nn + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }

  const float* rcw = row_cnt + ((size_t)wk * n_blocks + bucket[wk]) * rpw;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = wm * 32 + 16 * mi + gq + 8 * hh;
      if (r >= nr) continue;
      const float rc = rcw[row0 + r];
      const size_t o = ((size_t)wk * rpw + row0 + r) * kp;
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int k = n0 + wn * 32 + 8 * nj + 2 * tq;
        w_out[o + k] = sgd_step(w[o + k], acc[mi][nj][2 * hh], rc, lr, lam);
        w_out[o + k + 1] =
            sgd_step(w[o + k + 1], acc[mi][nj][2 * hh + 1], rc, lr, lam);
      }
    }
}

template <int KP>
int launch_wide(const void* slab, const void* bucket, const void* w,
                const void* h, const void* row_cnt, const void* col_cnt,
                void* w_out, void* h_out, void* wbf, void* gbuf, void* hsnap,
                void* sse_part, void* sse_out, int nw, int n_blocks, int rpw,
                int cpb, int nmb, int nmb_fine, float lr, float lam,
                const RingSend& ring, cudaStream_t s) {
  using G = WideGeom<KP>;
  const size_t nwb = (size_t)nw * rpw * KP;
  const size_t nb = (nwb + 255) / 256;
  dense_mf_wbf16_kernel<<<(unsigned)(nb < 4096 ? nb : 4096), 256, 0, s>>>(
      static_cast<const float*>(w), static_cast<bf16*>(wbf), nwb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dense_mf_hop_wide_kernel<KP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)G::BYTES);
  if (err != cudaSuccess) return (int)err;
  const int n_ct = (cpb + G::CT - 1) / G::CT;
  dense_mf_hop_wide_kernel<KP><<<dim3(n_ct, nw), kThreads, G::BYTES, s>>>(
      static_cast<const bf16*>(slab), static_cast<const int*>(bucket),
      static_cast<const bf16*>(wbf), static_cast<const float*>(h),
      static_cast<const float*>(col_cnt), static_cast<float*>(h_out),
      static_cast<bf16*>(gbuf), static_cast<bf16*>(hsnap),
      static_cast<float*>(sse_part), n_blocks, rpw, cpb, nmb, nmb_fine, lr,
      lam, cpb % 8 == 0 ? 1 : 0, ring);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int s_rows = rpw / nmb;
  const int tiles = nmb * ((s_rows + kGemmBM - 1) / kGemmBM);
  dense_mf_dw_kernel<<<dim3(tiles, KP / kGemmBN, nw), kGemmThreads, 0, s>>>(
      static_cast<const bf16*>(gbuf), static_cast<const bf16*>(hsnap),
      static_cast<const float*>(w), static_cast<const float*>(row_cnt),
      static_cast<const int*>(bucket), static_cast<const float*>(sse_part),
      static_cast<float*>(w_out), static_cast<float*>(sse_out), n_blocks, rpw,
      (cpb + 7) / 8 * 8, KP, nmb, n_ct, lr, lam);
  return (int)cudaGetLastError();
}

RingSend ring_send(void* h_next, const void* plan, int remote, int base,
                   int nworkers, unsigned long long ready, void* sent) {
  RingSend ring{};
  ring.h_next = static_cast<float*>(h_next);
  if (plan != nullptr) memcpy(&ring.plan, plan, sizeof(HopPlan));
  ring.remote = remote;
  ring.base = base;
  ring.nworkers = nworkers;
  ring.ready = ready;
  ring.sent = static_cast<int*>(sent);
  return ring;
}

}  // namespace

extern "C" {

// Columns per block (the column tile) for padded rank kp; 0 if kp is not
// 16, 32, 64, 128 (the kernel above) or 256, 512, 1024 (the wide path).
int dense_mf_hop_col_tile(int kp) {
  switch (kp) {
    case 16: return Geom<1>::CT;
    case 32: return Geom<2>::CT;
    case 64: return Geom<4>::CT;
    case 128: return Geom<8>::CT;
    case 256: return WideGeom<256>::CT;
    case 512: return WideGeom<512>::CT;
    case 1024: return WideGeom<1024>::CT;
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
    case 256: return (long long)WideGeom<256>::BYTES;
    case 512: return (long long)WideGeom<512>::BYTES;
    case 1024: return (long long)WideGeom<1024>::BYTES;
    default: return 0;
  }
}

// Launch one hop for all nw workers and its W/SSE reduction on ``stream``,
// kp = 16, 32, 64 or 128. A non-null h_next (nw, cpb, kp) takes the ring
// send: rows of the launch are workers base .. base + nw - 1 of nworkers;
// with remote = 1, plan is the call's ring_dma HopPlan, ready the count its
// credit check expects and sent (nw, n_ct) int32 the tiles sent (1) or left
// to ring_recv_kernel (0). Returns cudaGetLastError() after the launches (0
// on success).
int dense_mf_hop_launch(const void* slab, const void* bucket, const void* w,
                        const void* h, const void* row_cnt,
                        const void* col_cnt, void* w_out, void* h_out,
                        void* ws, void* sse_part, void* sse_out, int nw,
                        int n_blocks, int rpw, int cpb, int kp, int nmb,
                        int nmb_fine, float lr, float lam, void* stream,
                        void* h_next, const void* plan, int remote, int base,
                        int nworkers, unsigned long long ready, void* sent) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const RingSend ring =
      ring_send(h_next, plan, remote, base, nworkers, ready, sent);
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

// The wide path, kp = 256, 512 or 1024: the same operands and send, with
// the wide path's buffers in place of ws: wbf (nw, rpw, kp) bf16, gbuf (nw,
// rpw, cpb8) bf16 and hsnap (nw, nmb, cpb8, kp) bf16, cpb8 = cpb rounded up
// to a multiple of 8; three launches (Wb, the hop, the dW GEMM with the W
// update).
int dense_mf_hop_wide_launch(const void* slab, const void* bucket,
                             const void* w, const void* h,
                             const void* row_cnt, const void* col_cnt,
                             void* w_out, void* h_out, void* wbf, void* gbuf,
                             void* hsnap, void* sse_part, void* sse_out,
                             int nw, int n_blocks, int rpw, int cpb, int kp,
                             int nmb, int nmb_fine, float lr, float lam,
                             void* stream, void* h_next, const void* plan,
                             int remote, int base, int nworkers,
                             unsigned long long ready, void* sent) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const RingSend ring =
      ring_send(h_next, plan, remote, base, nworkers, ready, sent);
#define HARP_MF_WIDE(KP)                                                     \
  return launch_wide<KP>(slab, bucket, w, h, row_cnt, col_cnt, w_out, h_out, \
                         wbf, gbuf, hsnap, sse_part, sse_out, nw, n_blocks,  \
                         rpw, cpb, nmb, nmb_fine, lr, lam, ring, s)
  switch (kp) {
    case 256: HARP_MF_WIDE(256);
    case 512: HARP_MF_WIDE(512);
    case 1024: HARP_MF_WIDE(1024);
    default: return (int)cudaErrorInvalidValue;
  }
#undef HARP_MF_WIDE
}

}  // extern "C"
