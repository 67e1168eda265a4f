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
// bytes; at K = 128 the operations (0.83 ms) bound it. Between the first
// version of this kernel and that bound stood memory latency behind
// block-wide barriers, work repeated in every block, a dW workspace of
// 2 KP / CT slabs' bytes and, past those, shared memory's bandwidth under
// mma.sync's operand loads. The design:
//   * A block owns one (worker, column tile) for the whole hop: its H tile
//     lives in shared memory (f32, plus Hb^T in bf16 as the MMA operand)
//     and it walks the stripes in order with no grid-wide
//     synchronisation, one block an SM, a warpgroup (4 warps) per 64
//     columns (16 warps at CT = 256, 8 at 128). Rows are taken R = 64 at a
//     time. One thread issues a chunk's copies into a ring of S stages,
//     each completed on its own mbarrier, S chunks ahead: V as 64-column
//     boxes of a 2-D tensor map of the slab (TMA, 128-byte swizzle, so the
//     fragment reads have no bank conflicts; columns past cpb arrive as
//     zeros), and the chunk's Wb as one bulk copy. A warp waits on its
//     stage's barrier, not on the other warps. A cpb that is not a multiple
//     of 8 (rows not 16-byte aligned, no tensor map) stages V by element-
//     wise loads of all threads, in the same swizzled layout.
//   * W's rows are read only at their pre-hop values, so Wb = bf16(W) is
//     written once a hop by a small kernel (dense_mf_wb_chunks_kernel) as
//     the chunks a stage holds: R rows, zero past the stripe, in 8 x 8 core
//     matrices of 128 contiguous bytes (core_off).
//   * The three products run on the tensor cores as wgmma (bf16 operands
//     in shared memory, in core matrices without a swizzle; f32
//     accumulators), which a warpgroup reads once where mma.sync would
//     read them through every warp: warpgroup q forms pred = Wb Hb^T for
//     its 64 columns, G = bf16(V - pred) where rated (warp w its 16 rows,
//     into the G tile), and after a barrier of its own warps dH = G^T Wb
//     for the same columns (accumulators in registers for the whole
//     stripe: warp w holds columns 16 w .. + 15 of the warpgroup's). After
//     one block barrier, dW = G Hb over all CT columns: one warpgroup for
//     KP <= 64, two of 64 ranks each at 128 (the tensor cores' own sum, no
//     column-group partials).
//   * dW sums over all column tiles. The blocks of a cluster of C = 2
//     along the column tiles (never across workers, so a worker's result
//     does not depend on how many workers a launch holds; on an H100 the
//     card runs 66 such clusters at once, one wave at the flagship, where 8
//     runs 15 and 4 runs 30) exchange their partials through distributed
//     shared memory: block rank q owns rows [q R / C, (q + 1) R / C) of each
//     chunk, the others send it theirs by st.async, which completes on its
//     mbarrier (no cluster-scope fence a chunk: that cost about 900 cycles
//     a chunk), and while the next chunk is computed it sums the C
//     partials in rank order and writes one partial per cluster to the
//     workspace (W, ceil(n_ct / C), rpw, KP) f32. A relaxed cluster barrier
//     a chunk, waited on one step later, says the receive buffer has been
//     read. dense_mf_w_kernel sums a worker's ceil(n_ct / C) partials in
//     order and applies the W update (W's update can wait for the hop's end
//     because no later stripe reads an earlier stripe's rows). The grid's x
//     is padded to a multiple of C with blocks that own no columns: they
//     take part in every cluster barrier, sum their rows and send zeros.
//     The workspace costs a write and a read of ceil(n_ct / C) rpw KP 4
//     bytes a worker (0.268 GB at the flagship, half of one partial a
//     tile). The per-block SSE partials are summed the same way. No float
//     atomics, so two runs are bitwise equal.
//   What holds the kernel now (chip runs on an H100, cycles a chunk by a
//   clock-stamped copy of it): the single warpgroup's dW that the others
//   wait for (about a fifth of a chunk at the flagship) and G's element-wise
//   pass (about a fifth: its NaN and row masks are one AND on the packed
//   bf16 pair).
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
// No block of this launch waits for anything outside its own cluster (a
// cluster's blocks are scheduled together, so its barrier cannot wait on a
// block that is not running). Its grid is not capped at the blocks the card
// holds at once, so a block spinning here (for a credit, or for its
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
// The host binding is a plain C interface loaded with ctypes
// (harp_tpu_torch/ops/_cuda_build.py).

#include <cuda.h>
#include <cudaTypedefs.h>
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
constexpr int kCluster = 2;               // blocks a cluster
constexpr int kMaxStages = 4;
constexpr size_t kMaxSmem = 232448;       // one H100 block's opt-in maximum

constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }
constexpr size_t align1024(size_t x) { return (x + 1023) / 1024 * 1024; }
constexpr int min_int(size_t a, size_t b) { return (int)(a < b ? a : b); }

// Shapes per padded rank KP = 16 KT. A block owns CT columns, CT / 64
// warpgroups of 64 columns each (16 warps at CT = 256, 8 at 128); warp q
// owns columns [16 q, 16 q + 16) of dH. A chunk is R = 64 rows; warpgroups
// q < DWG form dW, WN ranks each. The stage ring holds S chunks of V and Wb,
// as many as fit beside the H tile, Hb^T, the G tile and the dW partials
// received from the cluster in one block's shared memory (one block an SM).
template <int KT>
struct Geom {
  static constexpr int KP = 16 * KT;
  static constexpr int CT = KT <= 2 ? 256 : 128;
  static constexpr int C = kCluster;
  static constexpr int R = 64;
  static constexpr int THREADS = 2 * CT;   // a warp per 16 columns
  static constexpr int DWG = KT == 8 ? 2 : 1;
  static constexpr int WN = KP / DWG;
  static constexpr int LDH = KP + 4;       // f32 H rows
  // Hb^T (KP x CT), the G tile (R x CT) and a chunk's Wb (R x KP), bf16,
  // in 8 x 8 core matrices of 128 contiguous bytes (core_off): the layout
  // wgmma reads without a swizzle
  static constexpr size_t WB = (size_t)R * KP * 2;
  static constexpr size_t HS = 0;                                   // H f32
  static constexpr size_t HB = align128(HS + (size_t)CT * LDH * 4); // Hb^T
  static constexpr size_t GT = align128(HB + (size_t)CT * KP * 2);  // G tile
  // the dW partials of this block's R / C rows from each block of the
  // cluster, (C, R / C, KP) f32
  static constexpr size_t RCV = align128(GT + (size_t)R * CT * 2);
  static constexpr size_t BAR = align128(RCV + (size_t)R * KP * 4);
  // stages from the first 1024-byte boundary at or past ST (the dynamic
  // base is 16-byte aligned; BYTES keeps 1008 bytes for the shift)
  static constexpr size_t ST = align128(BAR + (kMaxStages + 1) * 8);
  static constexpr int NV = CT / 64;       // V boxes a chunk: 64 columns
  static constexpr size_t VBOX = (size_t)R * 128;
  static constexpr size_t VB = NV * VBOX;  // a stage: V, then Wb
  static constexpr size_t STAGE = align1024(VB + WB);
  static constexpr int S =
      min_int(kMaxStages, (kMaxSmem - 1008 - ST) / STAGE);
  static constexpr size_t BYTES = ST + 1008 + (size_t)S * STAGE;
  static_assert(S >= 2 && BYTES <= kMaxSmem, "two stages must fit");
  static_assert(R % (16 * C) == 0 && WN <= 64 && 4 * DWG <= THREADS / 32,
                "a 16-row dW tile goes to one block of the cluster");
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

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// one arrival that also expects ``bytes`` of asynchronous copies this phase
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_u32(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// bytes (a multiple of 16) from global to this block's shared memory,
// completing on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// box (x = column, y = row) of the 2-D tensor map to this block's shared
// memory, completing on bar
__device__ __forceinline__ void tensor_copy(void* dst, const CUtensorMap* map,
                                            int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(map), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}

// Byte offset of V(r, col) in a stage: 64-column boxes of R rows of 128
// bytes, whose 16-byte chunks are swizzled as the tensor map's 128-byte
// mode writes them (chunk c of row r at c ^ (r mod 8))
template <int R>
__device__ __forceinline__ int v_offset(int r, int col) {
  return (col >> 6) * (R * 128) + r * 128 +
         ((((col & 63) >> 3) ^ (r & 7)) << 4) + (col & 7) * 2;
}

// Byte offset of element (r, c) of a bf16 matrix of CT columns stored in
// 8 x 8 core matrices: core matrix (r / 8, c / 8) holds 128 contiguous bytes
// at ((r / 8) (CT / 8) + c / 8) 128, its row r mod 8 the 16 bytes at
// 16 (r mod 8)
template <int CT>
__device__ __forceinline__ int core_off(int r, int c) {
  return (((r >> 3) * (CT / 8) + (c >> 3)) << 7) + ((r & 7) << 4) +
         ((c & 7) << 1);
}

// wgmma descriptor of a K-major bf16 operand in core matrices without a
// swizzle: lbo bytes between core matrices along K, sbo between 8-row
// groups
__device__ __forceinline__ uint64_t wg_desc(const void* p, unsigned lbo,
                                            unsigned sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

// wgmma m64nNk16, bf16 operands in shared memory, f32 accumulators: see
// wgmma_bf16

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n16(float (&d)[8], uint64_t a,
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %10, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7"
      "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB)
      : "memory");
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t a,
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB)
      : "memory");
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t a,
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,"
      "%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB)
      : "memory");
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a,
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,"
      "%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,"
      "%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,"
      "%62,%63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB)
      : "memory");
}

// d (+)= A B for one k16 step of a 64 x N tile on a warpgroup: A and B in
// shared memory (descriptors; TA / TB 1 where the operand is MN-major),
// f32 accumulators N / 2 a thread; warp q of the warpgroup holds rows 16 q
// .. 16 q + 15 as N / 8 mma.sync accumulator tiles
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t a,
                                           uint64_t b, int accumulate) {
  if constexpr (N == 16) wgmma_n16<TA, TB>(d, a, b, accumulate);
  if constexpr (N == 32) wgmma_n32<TA, TB>(d, a, b, accumulate);
  if constexpr (N == 64) wgmma_n64<TA, TB>(d, a, b, accumulate);
  if constexpr (N == 128) wgmma_n128<TA, TB>(d, a, b, accumulate);
}

// wgmma_bf16's accumulators are written asynchronously: wait for every
// committed group, then tell the compiler the registers changed here
template <int M>
__device__ __forceinline__ void wgmma_wait(float (&d)[M]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int q = 0; q < M; ++q) asm volatile("" : "+f"(d[q])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every block of the cluster: writes before it are seen by
// reads after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The split cluster barrier without memory ordering: it says only that
// every thread of the cluster has arrived (what was read before the arrival
// has been consumed). Data moves between blocks by st.async, whose arrival
// the receiver's mbarrier reports.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// this block's shared address p in block ``rank`` of the cluster
__device__ __forceinline__ unsigned cluster_addr(const void* p,
                                                 unsigned rank) {
  unsigned a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(smem_u32(p)), "r"(rank));
  return a;
}

// 8 bytes to the shared memory of another block of the cluster (a and bar
// from cluster_addr), completing on its mbarrier bar
__device__ __forceinline__ void st_async2(unsigned a, float x, float y,
                                          unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(a),
      "f"(x), "f"(y), "r"(bar)
      : "memory");
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

__global__ void dense_mf_wbf16_kernel(const float* __restrict__ w,
                                      bf16* __restrict__ wb, size_t n) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    wb[i] = __float2bfloat16_rn(w[i]);
}

// Wb = bf16(w) as the narrow kernel's chunks: for each worker, stripe and
// chunk of R rows (rows past the stripe zero), the R x KP rows in core
// matrices (core_off), one contiguous copy a chunk; n = nw nmb nch R KP
template <int R, int KP>
__global__ void dense_mf_wb_chunks_kernel(const float* __restrict__ w,
                                          bf16* __restrict__ wb, size_t n,
                                          int rpw, int nmb, int nch) {
  const int s_rows = rpw / nmb;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int k = (int)(i % KP);
    const int r = (int)(i / KP % R);
    const size_t chunk = i / ((size_t)R * KP);   // (wk nmb + stripe) nch + c
    const int c = (int)(chunk % nch);
    const size_t ws_ = chunk / nch;               // wk nmb + stripe
    const int rr = c * R + r;                     // row in the stripe
    const size_t row = ws_ / nmb * rpw + ws_ % nmb * s_rows + rr;
    const float v = rr < s_rows ? w[row * KP + k] : 0.f;
    *reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(wb) +
                             chunk * R * KP * 2 + core_off<KP>(r, k)) =
        __float2bfloat16_rn(v);
  }
}

// The final tile of a block goes to h_out and, with the ring send, to the
// neighbour (in another process only if its credit is in: no block spins
// here). hs: the f32 tile, ldh floats a row.
__device__ void store_tile(const float* hs, int ldh, int ct_cols, int kp,
                           float* __restrict__ h_out, int wk, int ct,
                           int n_ct, int c0, int ncols, int cpb,
                           const RingSend& ring) {
  float* hn = nullptr;
  bool remote_send = false;
  if (ring.h_next != nullptr) {
    const int d =
        ring_dma::ring_neighbor(ring.base + wk, ring.nworkers, 1) - ring.base;
    if (d >= 0 && d < (int)gridDim.y) {
      hn = ring.h_next + (size_t)d * cpb * kp;
    } else {
      int in = 0;
      if (threadIdx.x == 0) {
        in = ring_dma::acquire_load(ring.plan.my_ready[wk]) >= ring.ready;
        __threadfence();
        ring.sent[(size_t)wk * n_ct + ct] = in;
      }
      remote_send = __syncthreads_or(in) != 0;
      if (remote_send) hn = reinterpret_cast<float*>(ring.plan.remote_dst[wk]);
    }
  }
  for (int e = threadIdx.x; e < ct_cols * kp; e += blockDim.x) {
    const int c = e / kp, k = e - c * kp;
    if (c < ncols) {
      const float v = hs[c * ldh + k];
      const size_t o = (size_t)(c0 + c) * kp + k;
      h_out[(size_t)wk * cpb * kp + o] = v;
      if (hn != nullptr) hn[o] = v;
    }
  }
  if (remote_send) ring_dma::signal_arrival(ring.plan.arrive_to[wk]);
}

// The block's SSE partial: its threads' sums in warp order, into
// sse_part[wk, ct]; scratch holds kWarps floats.
__device__ void store_sse(float sse, float* scratch,
                          float* __restrict__ sse_part, int wk, int ct,
                          int n_ct) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sse += __shfl_xor_sync(0xffffffffu, sse, off);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = sse;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int q = 0; q < (int)(blockDim.x >> 5); ++q) s += scratch[q];
    sse_part[(size_t)wk * n_ct + ct] = s;
  }
}

// Launched in clusters of Geom<KT>::C blocks along x; grid (ceil(n_ct / C)
// C, W). Block x >= n_ct owns no columns.
template <int KT>
__global__ void __launch_bounds__(Geom<KT>::THREADS, 1)
dense_mf_hop_kernel(const bf16* __restrict__ slab,
                    const int* __restrict__ bucket,
                    const bf16* __restrict__ wbf, const float* __restrict__ h,
                    const float* __restrict__ col_cnt,
                    float* __restrict__ h_out, float* __restrict__ ws,
                    float* __restrict__ sse_part, int n_blocks, int rpw,
                    int cpb, int n_ct, int nmb, int nmb_fine, float lr,
                    float lam, int vec,
                    const __grid_constant__ CUtensorMap vmap,
                    const RingSend ring) {
  using G = Geom<KT>;
  constexpr int KP = G::KP, CT = G::CT, R = G::R, S = G::S, C = G::C;
  constexpr int NTH = G::THREADS, WN = G::WN, RQ = R / C;
  extern __shared__ __align__(128) unsigned char smem[];
  float* hs = reinterpret_cast<float*>(smem + G::HS);
  unsigned char* hbt = smem + G::HB;    // Hb^T in core matrices
  unsigned char* gtb = smem + G::GT;    // the G tile in core matrices
  float* recv = reinterpret_cast<float*>(smem + G::RCV);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + G::BAR);
  unsigned char* stages =
      smem + G::ST + ((1024 - (smem_u32(smem + G::ST) & 1023)) & 1023);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;        // accumulator row (and row + 8)
  const int tq = lane & 3;         // accumulator column pair
  const int wg = warp >> 2;        // this warp's warpgroup: columns 64 wg ..
  const int wr = 16 * (warp & 3);  // its 16 rows of the warpgroup's tiles
  const int cw0 = 16 * warp;       // its 16 columns of dH

  const int ct = blockIdx.x;
  const int wk = blockIdx.y;
  const unsigned crank = cluster_rank();
  const int c0 = ct * CT;
  const int ncols = max(0, min(CT, cpb - c0));
  const bool live = ncols > 0;     // uniform over the block
  const size_t blk = (size_t)wk * n_blocks + bucket[wk];
  const bf16* vsl = slab + blk * rpw * cpb;                // (rpw, cpb)
  const int vrow = (int)(blk * rpw);     // the bucket's row 0 in vmap
  const float* ccw = col_cnt + blk * nmb_fine * cpb;       // (nmb_fine, cpb)
  const int s_rows = rpw / nmb;
  const int ratio = nmb_fine / nmb;
  const int nch = (s_rows + R - 1) / R;
  const int total = nmb * nch;
  // this worker's Wb chunks, (nmb nch) of R rows in core matrices
  const unsigned char* wwk = reinterpret_cast<const unsigned char*>(wbf) +
                             (size_t)wk * total * G::WB;
  const int n_cl = gridDim.x / C;

  if (ring.h_next != nullptr && ring.remote)
    ring_dma::give_credits(ring.plan, gridDim.y);

  for (int e = tid; e < CT * KP; e += NTH) {
    const int c = e / KP, k = e - c * KP;
    const float v = c < ncols ? h[((size_t)wk * cpb + c0 + c) * KP + k] : 0.f;
    hs[c * G::LDH + k] = v;
    *reinterpret_cast<bf16*>(hbt + core_off<CT>(k, c)) =
        __float2bfloat16_rn(v);
  }
  // bar[0 .. S-1]: the stages; rbar: chunk g's partials of this block's
  // rows from the C - 1 other blocks (phase g; its bytes are expected before
  // any can arrive)
  uint64_t* rbar = bar + S;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(bar + s, 1);
    mbar_init(rbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(rbar, (C - 1) * RQ * KP * 4);
  }
  // Hb^T (generic stores) before wgmma reads it (async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  cluster_sync();   // every block's barriers are initialised

  // chunk g into stage g % S: V by the tensor map, whole boxes (rows past
  // the stripe are read and masked; columns past cpb arrive as zeros), and
  // its Wb chunk (rows past the stripe are zeros) in one copy
  auto issue = [&](int g) {
    const int s = g % S;
    const int c = g % nch;
    const int row0 = (g / nch) * s_rows + c * R;
    const int nr = min(R, s_rows - c * R);
    unsigned char* vd = stages + s * G::STAGE;
    if (!vec) {
      for (int e = tid; e < R * CT; e += NTH) {
        const int r = e / CT, col = e - r * CT;
        *reinterpret_cast<bf16*>(vd + v_offset<R>(r, col)) =
            (r < nr && col < ncols)
                ? vsl[(size_t)(row0 + r) * cpb + c0 + col]
                : __float2bfloat16_rn(0.f);
      }
    }
    if (tid == 0) {
      mbar_expect(bar + s, (vec ? (unsigned)G::VB : 0u) + (unsigned)G::WB);
      if (vec)
        for (int q = 0; q < G::NV; ++q)
          tensor_copy(vd + q * G::VBOX, &vmap, c0 + 64 * q, vrow + row0,
                      bar + s);
      bulk_copy(vd + G::VB, wwk + (size_t)g * G::WB, G::WB, bar + s);
    }
  };

  float dh[KP / 2];   // dH of this warp's 16 columns, a stripe long
  float sse = 0.f;

  // this block's R / C rows of the cluster's dW for chunk g: the C blocks'
  // partials summed in rank order, into the workspace; then the next
  // chunk's bytes are expected and this block's reads are done
  auto reduce = [&](int g) {
    const int c = g % nch;
    const int row0 = (g / nch) * s_rows + c * R;
    const int nr = min(R, s_rows - c * R);
    constexpr int U = KP / 4;
    mbar_wait(rbar, (unsigned)g & 1u);
    float* out = ws + (((size_t)wk * n_cl + ct / C) * rpw + row0) * KP;
    for (int e = tid; e < RQ * U; e += NTH) {
      const int rr = e / U, k = (e - rr * U) * 4;
      const int r = (int)crank * RQ + rr;
      if (r < nr) {
        float4 t = *reinterpret_cast<const float4*>(recv + rr * KP + k);
#pragma unroll
        for (int q = 1; q < C; ++q) {
          const float4 o = *reinterpret_cast<const float4*>(
              recv + ((size_t)q * RQ + rr) * KP + k);
          t.x += o.x;
          t.y += o.y;
          t.z += o.z;
          t.w += o.w;
        }
        *reinterpret_cast<float4*>(out + (size_t)r * KP + k) = t;
      }
    }
    if (tid == 0 && g + 1 < total) mbar_expect(rbar, (C - 1) * RQ * KP * 4);
    cluster_arrive_relaxed();
  };

  if (live) {
    for (int g = 0; g < S && g < total; ++g) issue(g);
    if (!vec) __syncthreads();
  }
  for (int g = 0; g < total; ++g) {
    const int i = g / nch;
    const int c = g - i * nch;
    const int nr = min(R, s_rows - c * R);
    const int s = g % S;
    const unsigned char* vg = stages + s * G::STAGE;
    const unsigned char* wg_b = vg + G::VB;   // the chunk's Wb
    if (live) {
      mbar_wait(bar + s, (unsigned)(g / S) & 1u);
      // pred = Wb Hb^T on this warpgroup's 64 columns (A: Wb, K-major; B:
      // Hb^T, MN-major), then G = bf16(V - pred) where rated, into the G
      // tile. Past the block's columns V is 0 and so is Hb: G is 0 there.
      float pr[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
        wgmma_bf16<64, 0, 1>(
            pr, wg_desc(wg_b + 256 * kk, 128, KP * 16),
            wg_desc(hbt + (2 * kk * (CT / 8) + 8 * wg) * 128, CT * 16, 128),
            kk);
      wgmma_commit();
      unsigned vv[2][8];   // V, loaded while pred is on the tensor cores
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          vv[hh][j] = *reinterpret_cast<const unsigned*>(
              vg + v_offset<R>(wr + gq + 8 * hh, 64 * wg + 8 * j + 2 * tq));
      wgmma_wait(pr);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = wr + gq + 8 * hh;
        const unsigned rmask = r < nr ? 0xffffffffu : 0u;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * wg + 8 * j + 2 * tq;
          const bf162 vb = *reinterpret_cast<const bf162*>(&vv[hh][j]);
          const float2 v = __bfloat1622float2(vb);
          // G = bf16(V - pred), then 0 where V is NaN (unrated) or the row
          // is past the stripe: a mask on the packed pair
          const bf162 gr = __floats2bfloat162_rn(v.x - pr[4 * j + 2 * hh],
                                                 v.y - pr[4 * j + 2 * hh + 1]);
          const unsigned gu = *reinterpret_cast<const unsigned*>(&gr) &
                              __heq2_mask(vb, vb) & rmask;
          const bf162 gb = *reinterpret_cast<const bf162*>(&gu);
          const float2 gf = __bfloat1622float2(gb);
          sse = fmaf(gf.x, gf.x, sse);
          sse = fmaf(gf.y, gf.y, sse);
          *reinterpret_cast<bf162*>(gtb + core_off<CT>(r, col)) = gb;
        }
      }
      // the warpgroup's G (generic stores) before wgmma reads it
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      // dH += G^T Wb on this warpgroup's 64 columns over the chunk's rows
      // (A: G^T, MN-major; B: Wb, MN-major)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < R / 16; ++kk)
        wgmma_bf16<KP, 1, 1>(
            dh, wg_desc(gtb + (2 * kk * (CT / 8) + 8 * wg) * 128, CT * 16, 128),
            wg_desc(wg_b + 2 * kk * KP * 16, KP * 16, 128), c > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait(dh);
    }
    // chunk g - 1's partials arrived while this chunk was computed
    if (g > 0) reduce(g - 1);
    // the G tile (generic stores) before dW's wgmma reads it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();   // the G tile is whole; stage s is read
    if (live && g + S < total) issue(g + S);

    // dW = G Hb over all CT columns on warpgroups q < DWG (A: the G tile,
    // K-major; B: Hb^T's ranks [q WN, (q + 1) WN), K-major); warp w of the
    // warpgroup holds rows 16 w .. 16 w + 15
    const bool dw_warp = warp < 4 * G::DWG;
    float dw[WN / 2];
#pragma unroll
    for (int q = 0; q < WN / 2; ++q) dw[q] = 0.f;
    if (live && dw_warp) {
      const unsigned char* bq = hbt + wg * (WN / 8) * (CT * 16);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CT / 16; ++kk)
        wgmma_bf16<WN, 0, 0>(dw, wg_desc(gtb + 256 * kk, 128, CT * 16),
                             wg_desc(bq + 256 * kk, 128, CT * 16), kk);
      wgmma_commit();
      wgmma_wait(dw);
    }
    // every block has read chunk g - 1's partials: send this chunk's rows
    // to the block that owns them (a block without columns sends zeros)
    if (g > 0) cluster_wait();
    if (dw_warp) {
      // rows wr + gq (+ 8) belong to block wr / RQ of the cluster: this
      // block's own rows are stored in place, the others' sent
      const int n0 = wg * WN;
      const unsigned owner = (unsigned)(wr / RQ);
      float* rows = recv + ((size_t)crank * RQ + wr - owner * RQ) * KP;
      if (owner == crank) {
#pragma unroll
        for (int nj = 0; nj < WN / 8; ++nj)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            *reinterpret_cast<float2*>(rows + (gq + 8 * hh) * KP + n0 +
                                       8 * nj + 2 * tq) =
                make_float2(dw[4 * nj + 2 * hh], dw[4 * nj + 2 * hh + 1]);
      } else {
        const unsigned to = cluster_addr(rows, owner);
        const unsigned to_bar = cluster_addr(rbar, owner);
#pragma unroll
        for (int nj = 0; nj < WN / 8; ++nj)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            st_async2(to + (unsigned)(((gq + 8 * hh) * KP + n0 + 8 * nj +
                                       2 * tq) * 4),
                      dw[4 * nj + 2 * hh], dw[4 * nj + 2 * hh + 1], to_bar);
      }
    }
    __syncthreads();   // every warp is past its dW: the G tile and Hb are free

    if (live && c == nch - 1) {
      // stripe end: H <- H + lr (dH - lam cc_i H) on this warp's columns
      const float* cci = ccw + (size_t)i * ratio * cpb + c0;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int col = cw0 + gq + 8 * hh;
        float cnt = 0.f;
        if (col < ncols)
          for (int f = 0; f < ratio; ++f) cnt += cci[(size_t)f * cpb + col];
#pragma unroll
        for (int nt = 0; nt < KP / 8; ++nt) {
          const int k = 8 * nt + 2 * tq;
          float* hp = hs + col * G::LDH + k;
          const float h0 = sgd_step(hp[0], dh[4 * nt + 2 * hh], cnt, lr, lam);
          const float h1 =
              sgd_step(hp[1], dh[4 * nt + 2 * hh + 1], cnt, lr, lam);
          hp[0] = h0;
          hp[1] = h1;
          *reinterpret_cast<bf16*>(hbt + core_off<CT>(k, col)) =
              __float2bfloat16_rn(h0);
          *reinterpret_cast<bf16*>(hbt + core_off<CT>(k + 1, col)) =
              __float2bfloat16_rn(h1);
        }
      }
      // Hb^T (generic stores) before the next stripe's wgmma reads it
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    }
  }
  reduce(total - 1);
  cluster_wait();   // no block leaves while another may still write to it
  if (!live) return;
  store_tile(hs, G::LDH, CT, KP, h_out, wk, ct, n_ct, c0, ncols, cpb, ring);
  store_sse(sse, recv, sse_part, wk, ct, n_ct);
}

// W <- W + lr (sum over the clusters' dW partials - lam rc W), the partials
// summed in order; block 0 of each worker also sums its n_ct SSE partials
// in order.
__global__ void __launch_bounds__(kReduceThreads)
dense_mf_w_kernel(const float* __restrict__ w, const float* __restrict__ ws,
                  const float* __restrict__ row_cnt,
                  const int* __restrict__ bucket,
                  const float* __restrict__ sse_part, float* __restrict__ w_out,
                  float* __restrict__ sse_out, int n_blocks, int rpw, int kp,
                  int n_ct, int n_cl, float lr, float lam) {
  const int wk = blockIdx.y;
  const size_t n = (size_t)rpw * kp;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    float s = 0.f;
    for (int t = 0; t < n_ct; ++t) s += sse_part[(size_t)wk * n_ct + t];
    sse_out[wk] = s;
  }
  const size_t i = (size_t)blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= n) return;
  const float* p = ws + (size_t)wk * n_cl * n + i;
  float dw = 0.f;
  for (int t = 0; t < n_cl; ++t) dw += p[(size_t)t * n];
  const int row = (int)(i / kp);
  const float rc = row_cnt[((size_t)wk * n_blocks + bucket[wk]) * rpw + row];
  w_out[(size_t)wk * n + i] = sgd_step(w[(size_t)wk * n + i], dw, rc, lr, lam);
}



// The slab as a 2-D tensor map (rows nw n_blocks rpw, columns cpb; boxes of
// 64 columns by rows, 128-byte swizzle, zeros out of bounds). Returns a
// CUresult; cpb must be a multiple of 8.
int slab_map(CUtensorMap* map, const void* slab, int nw, int n_blocks,
             int rpw, int cpb, int rows) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled",
                                reinterpret_cast<void**>(&encode),
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess) {
      encode = nullptr;
      return (int)CUDA_ERROR_NOT_FOUND;
    }
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cpb,
                              (cuuint64_t)nw * n_blocks * rpw};
  const cuuint64_t strides[1] = {(cuuint64_t)cpb * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)rows};
  const cuuint32_t step[2] = {1, 1};
  return (int)encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                     const_cast<void*>(slab), dims, strides, box, step,
                     CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The hop kernel's launch configuration: clusters of C along x
template <int KT>
struct HopLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  HopLaunch(int n_ct, int nw, cudaStream_t s) : cfg(), attr() {
    using G = Geom<KT>;
    cfg.gridDim = dim3((n_ct + G::C - 1) / G::C * G::C, nw);
    cfg.blockDim = dim3(G::THREADS);
    cfg.dynamicSmemBytes = G::BYTES;
    cfg.stream = s;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = G::C;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
};

template <int KT>
cudaError_t prepare_hop_kernel() {
  return cudaFuncSetAttribute(dense_mf_hop_kernel<KT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)Geom<KT>::BYTES);
}

template <int KT>
int launch(const void* slab, const void* bucket, const void* w, const void* h,
           const void* row_cnt, const void* col_cnt, void* w_out, void* h_out,
           void* wbf, void* ws, void* sse_part, void* sse_out, int nw,
           int n_blocks, int rpw, int cpb, int nmb, int nmb_fine, float lr,
           float lam, const RingSend& ring, cudaStream_t s) {
  using G = Geom<KT>;
  const int nch = (rpw / nmb + G::R - 1) / G::R;
  const size_t nwb = (size_t)nw * nmb * nch * G::R * G::KP;
  const size_t nbw = (nwb + 255) / 256;
  dense_mf_wb_chunks_kernel<G::R, G::KP>
      <<<(unsigned)(nbw < 4096 ? nbw : 4096), 256, 0, s>>>(
          static_cast<const float*>(w), static_cast<bf16*>(wbf), nwb, rpw,
          nmb, nch);
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  const int vec = cpb % 8 == 0 ? 1 : 0;
  CUtensorMap vmap;
  memset(&vmap, 0, sizeof(vmap));
  if (vec) {
    e = slab_map(&vmap, slab, nw, n_blocks, rpw, cpb, G::R);
    if (e != 0) return e;
  }
  cudaError_t err = prepare_hop_kernel<KT>();
  if (err != cudaSuccess) return (int)err;
  const int n_ct = (cpb + G::CT - 1) / G::CT;
  HopLaunch<KT> hl(n_ct, nw, s);
  err = cudaLaunchKernelEx(
      &hl.cfg, dense_mf_hop_kernel<KT>, static_cast<const bf16*>(slab),
      static_cast<const int*>(bucket), static_cast<const bf16*>(wbf),
      static_cast<const float*>(h), static_cast<const float*>(col_cnt),
      static_cast<float*>(h_out), static_cast<float*>(ws),
      static_cast<float*>(sse_part), n_blocks, rpw, cpb, n_ct, nmb, nmb_fine,
      lr, lam, vec, vmap, ring);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)rpw * G::KP;
  const int nb = (int)((n + kReduceThreads - 1) / kReduceThreads);
  dense_mf_w_kernel<<<dim3(nb, nw), kReduceThreads, 0, s>>>(
      static_cast<const float*>(w), static_cast<const float*>(ws),
      static_cast<const float*>(row_cnt), static_cast<const int*>(bucket),
      static_cast<const float*>(sse_part), static_cast<float*>(w_out),
      static_cast<float*>(sse_out), n_blocks, rpw, G::KP, n_ct,
      (n_ct + G::C - 1) / G::C, lr, lam);
  return (int)cudaGetLastError();
}

// Clusters of the hop kernel at padded rank KP that the card runs at once
// (cudaOccupancyMaxActiveClusters), or -1 on an error.
template <int KT>
int max_active_clusters() {
  if (prepare_hop_kernel<KT>() != cudaSuccess) return -1;
  HopLaunch<KT> hl(Geom<KT>::C, 1, nullptr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, dense_mf_hop_kernel<KT>, &hl.cfg) !=
      cudaSuccess)
    return -1;
  return n;
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

// Blocks a cluster of the hop kernel for padded rank kp: C along the column
// tiles for 16, 32, 64 and 128, 1 (no cluster) for the wide path, 0 for
// any other kp.
int dense_mf_hop_cluster(int kp) {
  switch (kp) {
    case 16: return Geom<1>::C;
    case 32: return Geom<2>::C;
    case 64: return Geom<4>::C;
    case 128: return Geom<8>::C;
    case 256: case 512: case 1024: return 1;
    default: return 0;
  }
}

// The narrow kernel's geometry for kp = 16, 32, 64 or 128 into out[0..3]:
// rows a chunk R, stages S, clusters the card runs at once
// (cudaOccupancyMaxActiveClusters, -1 on an error) and their blocks C.
// Returns 0, or -1 for another kp.
int dense_mf_hop_geometry(int kp, int* out) {
#define HARP_MF_GEOM(KT)                                                     \
  out[0] = Geom<KT>::R;                                                     \
  out[1] = Geom<KT>::S;                                                     \
  out[2] = max_active_clusters<KT>();                                       \
  out[3] = Geom<KT>::C;                                                     \
  return 0
  switch (kp) {
    case 16: HARP_MF_GEOM(1);
    case 32: HARP_MF_GEOM(2);
    case 64: HARP_MF_GEOM(4);
    case 128: HARP_MF_GEOM(8);
    default: return -1;
  }
#undef HARP_MF_GEOM
}

// Launch one hop for all nw workers on ``stream``, kp = 16, 32, 64 or 128:
// Wb into wbf (nw, nmb, ceil(rpw / nmb / 64) 64, kp) bf16 (each stripe's
// rows in chunks of 64, zero past the stripe, in core matrices), the hop
// kernel in clusters along the
// column tiles with its dW partials in ws (nw, ceil(n_ct / C), rpw, kp)
// f32, then the W/SSE reduction. A non-null h_next (nw, cpb, kp) takes the
// ring send: rows of the launch are workers base .. base + nw - 1 of
// nworkers; with remote = 1, plan is the call's ring_dma HopPlan, ready the
// count its credit check expects and sent (nw, n_ct) int32 the tiles sent
// (1) or left to ring_recv_kernel (0). Returns the first CUDA error of the
// launches (0 on success).
int dense_mf_hop_launch(const void* slab, const void* bucket, const void* w,
                        const void* h, const void* row_cnt,
                        const void* col_cnt, void* w_out, void* h_out,
                        void* wbf, void* ws, void* sse_part, void* sse_out,
                        int nw, int n_blocks, int rpw, int cpb, int kp,
                        int nmb, int nmb_fine, float lr, float lam,
                        void* stream, void* h_next, const void* plan,
                        int remote, int base, int nworkers,
                        unsigned long long ready, void* sent) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const RingSend ring =
      ring_send(h_next, plan, remote, base, nworkers, ready, sent);
#define HARP_MF_LAUNCH(KT)                                                   \
  return launch<KT>(slab, bucket, w, h, row_cnt, col_cnt, w_out, h_out, wbf, \
                    ws, sse_part, sse_out, nw, n_blocks, rpw, cpb, nmb,      \
                    nmb_fine, lr, lam, ring, s)
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
