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

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,"
      "%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,"
      "%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,"
      "%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,%64,%65,%66,%67,%68,%69,"
      "%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,%80,%81,%82,%83,%84,%85,%86,"
      "%87,%88,%89,%90,%91,%92,%93,%94,%95,%96,%97,%98,%99,%100,%101,%102,"
      "%103,%104,%105,%106,%107,%108,%109,%110,%111,%112,%113,%114,%115,"
      "%116,%117,%118,%119,%120,%121,%122,%123,%124,%125,%126,%127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
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
  if constexpr (N == 256) wgmma_n256<TA, TB>(d, a, b, accumulate);
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
// sse_part[wk, ct]; scratch holds a float a warp.
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

// A launch configuration in clusters of `cluster` blocks along x (1: no
// cluster attribute); built in place (cfg points at attr)
struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  ClusterLaunch(dim3 grid, int threads, size_t smem, int cluster,
                cudaStream_t s)
      : cfg(), attr() {
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = cluster > 1 ? 1 : 0;
  }
};

// The narrow hop kernel's launch: the column tiles padded to clusters of C
template <int KT>
struct HopLaunch : ClusterLaunch {
  using G = Geom<KT>;
  HopLaunch(int n_ct, int nw, cudaStream_t s)
      : ClusterLaunch(dim3((n_ct + G::C - 1) / G::C * G::C, nw), G::THREADS,
                      G::BYTES, G::C, s) {}
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
// Where the kernel above stops: its warps hold a CT x KP piece of dH each and
// it sums dW over the column tiles through a (W, n_ct, rpw, KP) workspace. At
// KP = 256 a warp's dH would be 128 floats a thread and the workspace 2 KP /
// CT times the slab's bytes (17 GB at the flagship). The wide path keeps the
// block's ownership of one (worker, column tile) through all nmb stripes and
// splits the work three ways:
//   * A block owns CT = 64 columns and KR = 256 ranks. Past 256 the rank is
//     split over a cluster of C = KP / 256 blocks of the same column tile
//     (block rank q: ranks [256 q, 256 q + 256)). So a block's operands are
//     the same at every KP: its Wb slice (64 rows x 256 ranks, 32 KB a
//     chunk), its Hb tile (64 x 256) and V; and Wb is read from L2 n_ct
//     times a hop at any KP (8.6, 17 and 34 GB at the flagship for KP = 256,
//     512, 1024), where a block owning all KP ranks would take CT = 16384 /
//     KP columns and read it KP / 64 times.
//   * Two consumer warpgroups split the columns (warpgroup q: 32 columns), a
//     producer warp fills a ring of S stages (V by the slab's tensor map, the
//     chunk's Wb slice by one bulk copy, each stage completed on its
//     mbarrier and freed by an mbarrier the 8 consumer warps arrive on). Per
//     64-row chunk a warpgroup forms pred = Wb Hb^T (wgmma m64n32, K = 256,
//     one accumulator chain), G = bf16(V - pred) from the accumulator
//     registers into its G tile in core matrices, then dH^T += Wb^T G (four
//     m64n32k16 chains over the rank, the transposed form, so M runs over
//     the rank and N over its 32 columns). dH^T and the f32 H tile live in
//     registers (64 floats each a thread); Hb^T in shared memory is the
//     operand of pred. The two warpgroups share only the stages: neither
//     waits for the other inside a chunk.
//   * With C > 1 the pred partials of a chunk meet in distributed shared
//     memory: block r owns rows [r 64 / C, (r + 1) 64 / C) of each chunk (the
//     rows of warp r C / 4 .. of each warpgroup), the other blocks send it
//     their partials by st.async onto its mbarrier, it sums the C partials
//     in rank order (every block's arithmetic is the same, so the result
//     does not depend on which block owns a row), forms G for its rows, and
//     sends the bf16 G rows to the others' G tiles the same way. Each block
//     then has the whole G tile of the chunk. SSE counts each row at its
//     owner.
//   * dW is not summed over column tiles in the hop: G goes to a G buffer in
//     device memory in 64 x 32 blobs of core matrices by one bulk store a
//     chunk (cluster rank 0's), and each stripe's Hb tile to a snapshot by
//     one bulk store a stripe (every block its rank slice). After the hop one
//     GEMM kernel (dense_mf_dw_wide_kernel) forms dW_i = G_i Hb_i for every
//     stripe i on wgmma (128 rows x 256 ranks a block, the column loop in
//     order: no atomics, two runs bitwise equal) and applies the W update in
//     its epilogue. Both kernels read their operands with bulk copies in the
//     layout wgmma takes, so no thread formats an operand on the way.
// Wb = bf16(W) is written once a hop by dense_mf_wb_slices_kernel as the
// chunks the stages hold: for each (worker, stripe, chunk of 64 rows, rank
// slice) 64 x 256 bf16 in core matrices, zero past the stripe.
// The ring send of the final tile (crank 0 of a cluster reads the credit and
// tells the cluster, so a column tile is sent whole or left whole), the SSE
// partials and their fixed-order sum are the narrow kernel's. KP = 1024 is
// the widest: a cluster of 4 is the largest whose blocks the card keeps
// resident beside each other at this shared memory.
// What bounds it: operations. At rank 256 on the flagship the hop is 6 rpw
// cpb K = 1.65e12 bf16 tensor-core operations (1.67 ms at 989 TFLOP/s)
// against the slab's 2.15 GB (0.64 ms); the G buffer adds 2.15 GB written
// and 2.15 C GB read.
// What holds it now (an H100, a clock-stamped copy of the kernel:
// harp_tpu_torch/benchmark/mf_wide_stamps.py): at C = 1 a chunk's pred and
// dH, m64n32 products whose operands both come from shared memory, more
// than half of its cycles, G's element-wise pass a sixth; at C = 2 and 4
// the exchange, whose two hops between blocks a chunk cost more than the
// products.
// ---------------------------------------------------------------------------

constexpr int kWideRanks = 256;        // KR: ranks a block
constexpr int kWideCols = 64;          // CT: columns a block
constexpr int kWideRows = 64;          // R: rows a chunk
constexpr int kWideGroups = 2;         // consumer warpgroups a block
constexpr int kWideThreads = 128 * kWideGroups + 32;   // and a producer warp
constexpr int kDwStages = 4;           // dW GEMM stage ring

template <int KP_>
struct WideGeom {
  static constexpr int KP = KP_;
  static constexpr int KR = kWideRanks;
  static constexpr int C = KP / KR;         // blocks a cluster (rank slices)
  static constexpr int CT = kWideCols;
  static constexpr int R = kWideRows;
  static constexpr int WC = CT / kWideGroups;   // columns a warpgroup
  static constexpr int RO = R / C;          // rows of a chunk a block owns
  static constexpr int MT = KR / 64;        // m64 tiles of dH^T
  // Hb^T (CT x KR, core_off<KR>(column, rank)), G tiles [group][2] (R x WC,
  // core_off<WC>(row, column)), the received pred partials [group][2][C]
  // (RO x WC f32, C > 1), the send flag, then the barriers: full[S],
  // empty[S], rbar[group][2], gbar[group][2]
  static constexpr size_t HB = 0;
  static constexpr size_t GT = HB + (size_t)CT * KR * 2;
  static constexpr size_t GTILE = (size_t)R * WC * 2;
  static constexpr size_t RCV = GT + kWideGroups * 2 * GTILE;
  static constexpr size_t RSLOT = (size_t)C * RO * WC * 4;
  static constexpr size_t FLAG = RCV + (C > 1 ? kWideGroups * 2 * RSLOT : 0);
  static constexpr size_t BAR = align128(FLAG + 16);
  static constexpr size_t ST = align128(BAR + (2 * 4 + 8) * 8);
  static constexpr size_t VB = (size_t)RO * 128;   // V: 64 columns x RO rows
  static constexpr size_t WB = (size_t)R * KR * 2;
  static constexpr size_t STAGE = align1024(VB + WB);
  static constexpr int S = min_int(4, (kMaxSmem - 1008 - ST) / STAGE);
  static constexpr size_t BYTES = ST + 1008 + (size_t)S * STAGE;
  static_assert(S >= 3 && BYTES <= kMaxSmem, "three stages must fit");
  static_assert(C == 1 || C == 2 || C == 4, "a warp's rows have one owner");
};

struct DwGeom {
  static constexpr size_t A = (size_t)2 * kWideRows * 64 * 2;   // 2 x 64 rows
  static constexpr size_t B = (size_t)64 * kWideRanks * 2;      // 64 columns
  static constexpr size_t STAGE = A + B;
  static constexpr size_t BAR = (size_t)kDwStages * STAGE;
  static constexpr size_t BYTES = BAR + 2 * kDwStages * 8;
  static_assert(BYTES <= kMaxSmem, "the dW stages fit");
};

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// bytes (a multiple of 16) from this block's shared memory to global, as
// one bulk-group
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           unsigned bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// this thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void group_sync(int q) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + q) : "memory");
}

__device__ __forceinline__ void st_async_b32(unsigned a, unsigned v,
                                             unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(a),
      "r"(v), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_cluster_u32(unsigned a, unsigned v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(a), "r"(v)
               : "memory");
}

template <int M>
__device__ __forceinline__ void pin(float (&d)[M]) {
#pragma unroll
  for (int q = 0; q < M; ++q) asm volatile("" : "+f"(d[q])::"memory");
}

// Wb = bf16(w) as the wide path's stage operands: for each worker, stripe,
// chunk of R rows (zero past the stripe) and rank slice of KR, the R x KR
// piece in core matrices (core_off), one contiguous copy; n = nw nmb nch R kp
template <int R, int KR>
__global__ void dense_mf_wb_slices_kernel(const float* __restrict__ w,
                                          bf16* __restrict__ wb, size_t n,
                                          int rpw, int nmb, int nch, int kp) {
  const int s_rows = rpw / nmb;
  const int nsl = kp / KR;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int kl = (int)(i % KR);
    const int r = (int)(i / KR % R);
    const size_t piece = i / ((size_t)R * KR);   // chunk nsl + slice
    const int q = (int)(piece % nsl);
    const size_t chunk = piece / nsl;            // (wk nmb + stripe) nch + c
    const int c = (int)(chunk % nch);
    const size_t ws_ = chunk / nch;
    const int rr = c * R + r;
    const size_t row = ws_ / nmb * rpw + ws_ % nmb * s_rows + rr;
    const float v = rr < s_rows ? w[row * kp + (size_t)q * KR + kl] : 0.f;
    *reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(wb) +
                             piece * R * KR * 2 + core_off<KR>(r, kl)) =
        __float2bfloat16_rn(v);
  }
}

// Launched in clusters of C blocks along x (C = 1: no cluster); grid (n_ct C,
// W). Block x owns column tile x / C and rank slice x mod C.
template <int KP>
__global__ void __launch_bounds__(kWideThreads, 1)
dense_mf_hop_wide_kernel(const bf16* __restrict__ slab,
                         const int* __restrict__ bucket,
                         const bf16* __restrict__ wbf,
                         const float* __restrict__ h,
                         const float* __restrict__ col_cnt,
                         float* __restrict__ h_out, bf16* __restrict__ gout,
                         bf16* __restrict__ hsnap,
                         float* __restrict__ sse_part, int n_blocks, int rpw,
                         int cpb, int nmb, int nmb_fine, float lr, float lam,
                         int vec, const __grid_constant__ CUtensorMap vmap,
                         const RingSend ring) {
  using G = WideGeom<KP>;
  constexpr int C = G::C, KR = G::KR, CT = G::CT, R = G::R, WC = G::WC;
  constexpr int RO = G::RO, S = G::S, MT = G::MT;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* hbt = smem + G::HB;
  float* recv = reinterpret_cast<float*>(smem + G::RCV);
  unsigned* flag = reinterpret_cast<unsigned*>(smem + G::FLAG);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::BAR);
  uint64_t* empty = full + S;
  uint64_t* rbar = full + 2 * 4;   // [group][2]
  uint64_t* gbar = rbar + 4;       // [group][2]
  unsigned char* stages =
      smem + G::ST + ((1024 - (smem_u32(smem + G::ST) & 1023)) & 1023);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int ct = blockIdx.x / C;
  const int n_ct = gridDim.x / C;
  const unsigned crank = C > 1 ? cluster_rank() : 0u;
  const int k0 = (int)crank * KR;      // this block's rank slice
  const int wk = blockIdx.y;
  const int c0 = ct * CT;
  const int ncols = min(CT, cpb - c0);
  const size_t blk = (size_t)wk * n_blocks + bucket[wk];
  const bf16* vsl = slab + blk * rpw * cpb;                // (rpw, cpb)
  const int vrow = (int)(blk * rpw);
  const float* ccw = col_cnt + blk * nmb_fine * cpb;       // (nmb_fine, cpb)
  const int s_rows = rpw / nmb;
  const int ratio = nmb_fine / nmb;
  const int nch = (s_rows + R - 1) / R;
  const int total = nmb * nch;
  // chunk g's Wb slice: (wk total + g) C + crank pieces of WB bytes
  const unsigned char* wsl = reinterpret_cast<const unsigned char*>(wbf) +
                             ((size_t)wk * total * C + crank) * G::WB;

  if (ring.h_next != nullptr && ring.remote)
    ring_dma::give_credits(ring.plan, gridDim.y);
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * kWideGroups);   // the consumer warps
    }
    for (int s = 0; s < 4; ++s) {
      mbar_init(rbar + s, 1);
      mbar_init(gbar + s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (C > 1) cluster_sync(); else __syncthreads();

  float sse = 0.f;
  float hreg[MT][WC / 2];   // the f32 H tile, dH^T's fragment layout
  if (warp == 4 * kWideGroups) {
    // the producer warp: chunk g into stage g % S once its consumers have
    // freed it, V by the tensor map (this block's RO rows; rows past the
    // stripe are read and masked, columns past cpb arrive as zeros) and the
    // Wb slice by one bulk copy; without the map (cpb % 8 != 0) V by
    // element-wise loads of the warp, in the same swizzled layout
    for (int g = 0; g < total; ++g) {
      const int s = g % S;
      if (g >= S) mbar_wait(empty + s, (unsigned)(g / S - 1) & 1u);
      const int c = g % nch;
      const int row0 = (g / nch) * s_rows + c * R;
      unsigned char* st = stages + s * G::STAGE;
      if (!vec) {
        const int nr = min(R, s_rows - c * R);
        for (int e = lane; e < RO * CT; e += 32) {
          const int r = e / CT, col = e - r * CT;
          const int rr = (int)crank * RO + r;
          *reinterpret_cast<bf16*>(st + v_offset<RO>(r, col)) =
              (rr < nr && col < ncols)
                  ? vsl[(size_t)(row0 + rr) * cpb + c0 + col]
                  : __float2bfloat16_rn(0.f);
        }
        __syncwarp();
      }
      if (lane == 0) {
        mbar_expect(full + s, (vec ? (unsigned)G::VB : 0u) + (unsigned)G::WB);
        if (vec)
          tensor_copy(st, &vmap, c0, vrow + row0 + (int)crank * RO, full + s);
        bulk_copy(st + G::VB, wsl + (size_t)g * C * G::WB, G::WB, full + s);
      }
    }
  } else {
    const int q = warp >> 2;          // warpgroup: columns 32 q ..
    const int wl = warp & 3;
    const int wr = 16 * wl;           // this warp's rows of a chunk
    const bool lead = (tid & 127) == 0;
    // this warp's rows belong to block wl C / 4 of the cluster
    const unsigned owner = (unsigned)(wl * C / 4);
    const bool mine = owner == crank;
    unsigned char* hbq = hbt + (size_t)q * WC * KR * 2;   // its Hb^T rows
    // element (rank 64 mt + wr + gq + 8 hh, column 8 j + 2 tq + e) of the
    // warpgroup's tile is hreg / dh [mt][4 j + 2 hh + e]
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int x = 0; x < WC / 2; ++x) {
        const int j = x >> 2, hh = (x >> 1) & 1, e = x & 1;
        const int col = q * WC + 8 * j + 2 * tq + e;
        const int kl = 64 * mt + wr + gq + 8 * hh;
        const float v =
            col < ncols ? h[((size_t)wk * cpb + c0 + col) * KP + k0 + kl] : 0.f;
        hreg[mt][x] = v;
        *reinterpret_cast<bf16*>(hbt + core_off<KR>(col, kl)) =
            __float2bfloat16_rn(v);
      }
    // Hb^T (generic stores) before wgmma and the bulk stores read it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    group_sync(q);

    float dh[MT][WC / 2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int x = 0; x < WC / 2; ++x) dh[mt][x] = 0.f;
    for (int g = 0; g < total; ++g) {
      const int i = g / nch;
      const int c = g - i * nch;
      const int nr = min(R, s_rows - c * R);
      const int s = g % S;
      const int slot = g & 1;
      const unsigned char* st = stages + s * G::STAGE;
      const unsigned char* wbs = st + G::VB;
      unsigned char* gt = smem + G::GT + (size_t)(2 * q + slot) * G::GTILE;
      mbar_wait(full + s, (unsigned)(g / S) & 1u);
      if (c == 0 && lead)   // stripe i's Hb, the B operand of its dW
        bulk_store(hsnap + ((((size_t)wk * nmb + i) * n_ct + ct) * C + crank) *
                               CT * KR + (size_t)q * WC * KR,
                   hbq, WC * KR * 2);

      // pred = Wb Hb^T on the warpgroup's columns (A: the Wb slice, B: Hb^T,
      // both K-major)
      float pr[WC / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KR / 16; ++kk)
        wgmma_bf16<WC, 0, 0>(pr, wg_desc(wbs + 256 * kk, 128, KR * 16),
                             wg_desc(hbq + 256 * kk, 128, KR * 16), kk);
      wgmma_commit();
      unsigned vv[2][WC / 8];   // V of this warp's rows, while pred runs
      if (mine) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int j = 0; j < WC / 8; ++j)
            vv[hh][j] = *reinterpret_cast<const unsigned*>(
                st + v_offset<RO>(wr + gq + 8 * hh - (int)crank * RO,
                                  q * WC + 8 * j + 2 * tq));
      }
      wgmma_wait(pr);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) pin(dh[mt]);
      // every wgmma of chunk g - 1 is done: its stage is free
      if (g > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + (g - 1) % S);
      }

      if constexpr (C > 1) {
        if (!mine) {
          // this warp's partial rows to their owner, slot [crank]
          const unsigned to = cluster_addr(
              recv + ((size_t)(2 * q + slot) * C + crank) * RO * WC, owner);
          const unsigned to_bar = cluster_addr(rbar + 2 * q + slot, owner);
#pragma unroll
          for (int j = 0; j < WC / 8; ++j)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int rl = wr + gq + 8 * hh - (int)owner * RO;
              st_async2(to + (unsigned)((rl * WC + 8 * j + 2 * tq) * 4),
                        pr[4 * j + 2 * hh], pr[4 * j + 2 * hh + 1], to_bar);
            }
        } else {
          // the C partials of this warp's rows, summed in rank order
          uint64_t* rb = rbar + 2 * q + slot;
          if (lane == 0 && wl == (int)crank * 4 / C)
            mbar_expect(rb, (unsigned)((C - 1) * RO * WC * 4));
          mbar_wait(rb, (unsigned)(g >> 1) & 1u);
          const float* rv = recv + (size_t)(2 * q + slot) * C * RO * WC;
#pragma unroll
          for (int j = 0; j < WC / 8; ++j)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int rl = wr + gq + 8 * hh - (int)crank * RO;
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float t = 0.f;
#pragma unroll
                for (int p = 0; p < C; ++p) {
                  const float x = p == (int)crank
                                      ? pr[4 * j + 2 * hh + e]
                                      : rv[((size_t)p * RO + rl) * WC + 8 * j +
                                           2 * tq + e];
                  t = p == 0 ? x : t + x;
                }
                pr[4 * j + 2 * hh + e] = t;
              }
            }
        }
      }
      if (mine) {
        // G = bf16(V - pred), 0 where V is NaN (unrated) or the row is past
        // the stripe (a mask on the packed pair), into the G tile; with C >
        // 1 also into the G tiles of the cluster's other blocks
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = wr + gq + 8 * hh;
          const unsigned rmask = r < nr ? 0xffffffffu : 0u;
#pragma unroll
          for (int j = 0; j < WC / 8; ++j) {
            const bf162 vb = *reinterpret_cast<const bf162*>(&vv[hh][j]);
            const float2 v = __bfloat1622float2(vb);
            const bf162 gr = __floats2bfloat162_rn(
                v.x - pr[4 * j + 2 * hh], v.y - pr[4 * j + 2 * hh + 1]);
            const unsigned gu = *reinterpret_cast<const unsigned*>(&gr) &
                                __heq2_mask(vb, vb) & rmask;
            const bf162 gb = *reinterpret_cast<const bf162*>(&gu);
            const float2 gf = __bfloat1622float2(gb);
            sse = fmaf(gf.x, gf.x, sse);
            sse = fmaf(gf.y, gf.y, sse);
            const int off = core_off<WC>(r, 8 * j + 2 * tq);
            *reinterpret_cast<unsigned*>(gt + off) = gu;
            if constexpr (C > 1) {
#pragma unroll
              for (int p = 1; p < C; ++p) {
                const unsigned to = (crank + p) % C;
                st_async_b32(cluster_addr(gt, to) + off, gu,
                             cluster_addr(gbar + 2 * q + slot, to));
              }
            }
          }
        }
      }
      if constexpr (C > 1) {
        // the other blocks' G rows
        uint64_t* gb = gbar + 2 * q + slot;
        if (lane == 0 && wl == 0)
          mbar_expect(gb, (unsigned)((C - 1) * RO * WC * 2));
        mbar_wait(gb, (unsigned)(g >> 1) & 1u);
      }
      // the G tile (generic stores) before wgmma and the bulk store read
      // it; the bulk stores of chunk g - 1 have read theirs, so the next
      // chunk may write that slot
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      if (lead) bulk_wait_read();
      group_sync(q);
      if (crank == 0 && lead)
        bulk_store(gout + ((((size_t)wk * nmb + i) * nch + c) * (2 * n_ct) +
                           2 * ct + q) * (R * WC),
                   gt, (unsigned)G::GTILE);

      // dH^T += Wb^T G over the chunk's rows (A: the Wb slice, MN-major; B:
      // the G tile, MN-major), m-tile mt: ranks 64 mt ..
      wgmma_fence();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kk = 0; kk < R / 16; ++kk)
          wgmma_bf16<WC, 1, 1>(
              dh[mt], wg_desc(wbs + mt * 1024 + 2 * kk * KR * 16, KR * 16, 128),
              wg_desc(gt + 2 * kk * WC * 16, WC * 16, 128), c > 0 || kk > 0);
      wgmma_commit();

      if (c == nch - 1) {
        // stripe end: H <- H + lr (dH - lam cc_i H) on the warpgroup's tile
        wgmma_wait(pr);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) pin(dh[mt]);
        if (lead) bulk_wait_read();   // the snapshot has read Hb^T
        group_sync(q);
        const float* cci = ccw + (size_t)i * ratio * cpb + c0;
        float cnt[WC / 8][2];
#pragma unroll
        for (int j = 0; j < WC / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = q * WC + 8 * j + 2 * tq + e;
            float t = 0.f;
            if (col < ncols)
              for (int f = 0; f < ratio; ++f) t += cci[(size_t)f * cpb + col];
            cnt[j][e] = t;
          }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int x = 0; x < WC / 2; ++x) {
            const int j = x >> 2, hh = (x >> 1) & 1, e = x & 1;
            const float v =
                sgd_step(hreg[mt][x], dh[mt][x], cnt[j][e], lr, lam);
            hreg[mt][x] = v;
            *reinterpret_cast<bf16*>(
                hbt + core_off<KR>(q * WC + 8 * j + 2 * tq + e,
                                   64 * mt + wr + gq + 8 * hh)) =
                __float2bfloat16_rn(v);
          }
        // Hb^T (generic stores) before the next stripe's wgmma reads it
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        group_sync(q);
      }
    }
    if (lead) bulk_wait();
  }
  __syncthreads();   // every stage is consumed: the ring is free

  // the final tile goes to h_out and, with the ring send, to the neighbour
  // (in another process only if its credit is in: no block spins here;
  // cluster rank 0 decides for the whole column tile)
  float* hn = nullptr;
  bool remote_send = false;
  if (ring.h_next != nullptr) {
    const int d =
        ring_dma::ring_neighbor(ring.base + wk, ring.nworkers, 1) - ring.base;
    if (d >= 0 && d < (int)gridDim.y) {
      hn = ring.h_next + (size_t)d * cpb * KP;
    } else {
      if (crank == 0 && tid == 0) {
        const unsigned in =
            ring_dma::acquire_load(ring.plan.my_ready[wk]) >= ring.ready;
        __threadfence();
        ring.sent[(size_t)wk * n_ct + ct] = (int)in;
        if constexpr (C > 1) {
          for (int p = 0; p < C; ++p) st_cluster_u32(cluster_addr(flag, p), in);
        } else {
          *flag = in;
        }
      }
      if constexpr (C > 1) cluster_sync(); else __syncthreads();
      remote_send = *reinterpret_cast<volatile unsigned*>(flag) != 0;
      if (remote_send) hn = reinterpret_cast<float*>(ring.plan.remote_dst[wk]);
    }
  }
  if (warp < 4 * kWideGroups) {
    const int q = warp >> 2, wr = 16 * (warp & 3);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int x = 0; x < WC / 2; ++x) {
        const int j = x >> 2, hh = (x >> 1) & 1, e = x & 1;
        const int col = q * WC + 8 * j + 2 * tq + e;
        if (col < ncols) {
          const size_t o =
              (size_t)(c0 + col) * KP + k0 + 64 * mt + wr + gq + 8 * hh;
          h_out[(size_t)wk * cpb * KP + o] = hreg[mt][x];
          if (hn != nullptr) hn[o] = hreg[mt][x];
        }
      }
  }
  if (remote_send) {
    if constexpr (C > 1) cluster_sync();   // every slice is in the slot
    if (crank == 0) ring_dma::signal_arrival(ring.plan.arrive_to[wk]);
  }
  store_sse(sse, reinterpret_cast<float*>(stages), sse_part, wk, blockIdx.x,
            gridDim.x);
  if constexpr (C > 1) cluster_sync();   // no block leaves before the others
}

// dW_i = G_i Hb_i for every stripe i (the G rows of the stripe against its
// Hb snapshot, a sum over all column tiles in order), then W <- W + lr (dW -
// lam rc W). One block a 128-row x 256-rank tile of one stripe: two consumer
// warpgroups of 64 rows (wgmma m64n256k16; A: G blobs, K-major; B: the
// snapshot, MN-major), a producer warp filling a ring of kDwStages stages by
// bulk copies (64 columns of G for each warpgroup, 8 KB, and of the
// snapshot, 32 KB). Block (0, 0) of each worker also sums its SSE partials
// in order. grid (nmb ceil(nch / 2), kp / 256, W).
__global__ void __launch_bounds__(kWideThreads, 1)
dense_mf_dw_wide_kernel(const bf16* __restrict__ gbuf,
                        const bf16* __restrict__ hsnap,
                        const float* __restrict__ w,
                        const float* __restrict__ row_cnt,
                        const int* __restrict__ bucket,
                        const float* __restrict__ sse_part,
                        float* __restrict__ w_out, float* __restrict__ sse_out,
                        int n_blocks, int rpw, int kp, int nmb, int n_ct,
                        int n_parts, float lr, float lam) {
  constexpr int S = kDwStages, R = kWideRows, KR = kWideRanks;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + DwGeom::BAR);
  uint64_t* empty = full + S;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wk = blockIdx.z;
  const int nsl = kp / KR;
  const int q = blockIdx.y;            // rank slice
  const int s_rows = rpw / nmb;
  const int nch = (s_rows + R - 1) / R;
  const int npair = (nch + 1) / 2;
  const int i = blockIdx.x / npair;
  const int cc0 = (blockIdx.x - i * npair) * 2;   // the block's first chunk
  const int nlive = min(2, nch - cc0);
  if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0) {
    float s = 0.f;
    for (int t = 0; t < n_parts; ++t) s += sse_part[(size_t)wk * n_parts + t];
    sse_out[wk] = s;
  }
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // G blob (chunk cc, 32 columns b) of stripe i; the snapshot of column tile
  // t and this rank slice
  const bf16* gst = gbuf + (((size_t)wk * nmb + i) * nch + cc0) *
                               (2 * n_ct) * (R * 32);
  const bf16* hst = hsnap + (((size_t)wk * nmb + i) * n_ct * nsl + q) *
                                (64 * KR);
  if (warp == 8) {
    if (lane == 0) {
      for (int t = 0; t < n_ct; ++t) {
        const int s = t % S;
        if (t >= S) mbar_wait(empty + s, (unsigned)(t / S - 1) & 1u);
        unsigned char* st = smem + s * DwGeom::STAGE;
        mbar_expect(full + s, (unsigned)(nlive * 8192 + DwGeom::B));
        for (int p = 0; p < nlive; ++p)
          bulk_copy(st + p * 8192,
                    gst + ((size_t)p * 2 * n_ct + 2 * t) * (R * 32), 8192,
                    full + s);
        bulk_copy(st + DwGeom::A, hst + (size_t)t * nsl * (64 * KR),
                  (unsigned)DwGeom::B, full + s);
      }
    }
    return;
  }
  const int p = warp >> 2;             // warpgroup: chunk cc0 + p
  const bool live = p < nlive;
  float acc[128];
#pragma unroll
  for (int x = 0; x < 128; ++x) acc[x] = 0.f;
  for (int t = 0; t < n_ct; ++t) {
    const int s = t % S;
    const unsigned char* st = smem + s * DwGeom::STAGE;
    mbar_wait(full + s, (unsigned)(t / S) & 1u);
    if (live) {
      const unsigned char* a = st + p * 8192;
      const unsigned char* b = st + DwGeom::A;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_bf16<256, 0, 1>(
            acc, wg_desc(a + (kk >> 1) * 4096 + (kk & 1) * 256, 128, 512),
            wg_desc(b + 2 * kk * KR * 16, KR * 16, 128), t > 0 || kk > 0);
      wgmma_commit();
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      pin(acc);
    }
    // step t - 1's wgmma is done: its stage is free
    if (t > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + (t - 1) % S);
    }
  }
  if (!live) return;
  wgmma_wait(acc);
  const int wr = 16 * (warp & 3);
  const int gq = lane >> 2, tq = lane & 3;
  const float* rcw = row_cnt + ((size_t)wk * n_blocks + bucket[wk]) * rpw;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int rs = (cc0 + p) * R + wr + gq + 8 * hh;   // row in the stripe
    if (rs >= s_rows) continue;
    const int row = i * s_rows + rs;
    const float rc = rcw[row];
    const size_t o = ((size_t)wk * rpw + row) * kp + (size_t)q * KR;
#pragma unroll
    for (int j = 0; j < KR / 8; ++j) {
      const int k = 8 * j + 2 * tq;
      const float2 x = *reinterpret_cast<const float2*>(w + o + k);
      *reinterpret_cast<float2*>(w_out + o + k) =
          make_float2(sgd_step(x.x, acc[4 * j + 2 * hh], rc, lr, lam),
                      sgd_step(x.y, acc[4 * j + 2 * hh + 1], rc, lr, lam));
    }
  }
}

template <int KP>
cudaError_t prepare_wide_kernels() {
  cudaError_t err = cudaFuncSetAttribute(
      dense_mf_hop_wide_kernel<KP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)WideGeom<KP>::BYTES);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(dense_mf_dw_wide_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)DwGeom::BYTES);
}

// The wide hop kernel's launch: C rank slices of each column tile
template <int KP>
struct WideLaunch : ClusterLaunch {
  using G = WideGeom<KP>;
  WideLaunch(int n_ct, int nw, cudaStream_t s)
      : ClusterLaunch(dim3(n_ct * G::C, nw), kWideThreads, G::BYTES, G::C, s) {}
};

template <int KP>
int launch_wide(const void* slab, const void* bucket, const void* w,
                const void* h, const void* row_cnt, const void* col_cnt,
                void* w_out, void* h_out, void* wbf, void* gbuf, void* hsnap,
                void* sse_part, void* sse_out, int nw, int n_blocks, int rpw,
                int cpb, int nmb, int nmb_fine, float lr, float lam,
                const RingSend& ring, cudaStream_t s) {
  using G = WideGeom<KP>;
  const int nch = (rpw / nmb + G::R - 1) / G::R;
  const size_t nwb = (size_t)nw * nmb * nch * G::R * KP;
  const size_t nbw = (nwb + 255) / 256;
  dense_mf_wb_slices_kernel<G::R, G::KR>
      <<<(unsigned)(nbw < 4096 ? nbw : 4096), 256, 0, s>>>(
          static_cast<const float*>(w), static_cast<bf16*>(wbf), nwb, rpw,
          nmb, nch, KP);
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  const int vec = cpb % 8 == 0 ? 1 : 0;
  CUtensorMap vmap;
  memset(&vmap, 0, sizeof(vmap));
  if (vec) {
    e = slab_map(&vmap, slab, nw, n_blocks, rpw, cpb, G::RO);
    if (e != 0) return e;
  }
  cudaError_t err = prepare_wide_kernels<KP>();
  if (err != cudaSuccess) return (int)err;
  const int n_ct = (cpb + G::CT - 1) / G::CT;
  WideLaunch<KP> wl(n_ct, nw, s);
  err = cudaLaunchKernelEx(
      &wl.cfg, dense_mf_hop_wide_kernel<KP>, static_cast<const bf16*>(slab),
      static_cast<const int*>(bucket), static_cast<const bf16*>(wbf),
      static_cast<const float*>(h), static_cast<const float*>(col_cnt),
      static_cast<float*>(h_out), static_cast<bf16*>(gbuf),
      static_cast<bf16*>(hsnap), static_cast<float*>(sse_part), n_blocks, rpw,
      cpb, nmb, nmb_fine, lr, lam, vec, vmap, ring);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int npair = (nch + 1) / 2;
  dense_mf_dw_wide_kernel<<<dim3(nmb * npair, G::C, nw), kWideThreads,
                            DwGeom::BYTES, s>>>(
      static_cast<const bf16*>(gbuf), static_cast<const bf16*>(hsnap),
      static_cast<const float*>(w), static_cast<const float*>(row_cnt),
      static_cast<const int*>(bucket), static_cast<const float*>(sse_part),
      static_cast<float*>(w_out), static_cast<float*>(sse_out), n_blocks, rpw,
      KP, nmb, n_ct, n_ct * G::C, lr, lam);
  return (int)cudaGetLastError();
}

// Clusters of the wide hop kernel at padded rank KP that the card runs at
// once (cudaOccupancyMaxActiveClusters; blocks a SM at C = 1), or -1 on an
// error.
template <int KP>
int wide_active_clusters() {
  if (prepare_wide_kernels<KP>() != cudaSuccess) return -1;
  WideLaunch<KP> wl(1, 1, nullptr);
  int n = 0;
  if (WideGeom<KP>::C == 1) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, dense_mf_hop_wide_kernel<KP>, kWideThreads,
            WideGeom<KP>::BYTES) != cudaSuccess)
      return -1;
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return -1;
    return n * sms;
  }
  if (cudaOccupancyMaxActiveClusters(&n, dense_mf_hop_wide_kernel<KP>,
                                     &wl.cfg) != cudaSuccess)
    return -1;
  return n;
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
// tiles for 16, 32, 64 and 128, the rank slices KP / 256 for the wide path,
// 0 for any other kp.
int dense_mf_hop_cluster(int kp) {
  switch (kp) {
    case 16: return Geom<1>::C;
    case 32: return Geom<2>::C;
    case 64: return Geom<4>::C;
    case 128: return Geom<8>::C;
    case 256: return WideGeom<256>::C;
    case 512: return WideGeom<512>::C;
    case 1024: return WideGeom<1024>::C;
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

// The wide path's geometry for kp = 256, 512 or 1024 into out[0..5]: rows a
// chunk R, stages S, clusters of the hop kernel the card runs at once (at C
// = 1 its blocks; -1 on an error), blocks a cluster C, ranks a block KR, and
// the dW GEMM's stages. Returns 0, or -1 for another kp.
int dense_mf_hop_wide_geometry(int kp, int* out) {
#define HARP_MF_WIDE_GEOM(KP)                                                \
  out[0] = WideGeom<KP>::R;                                                 \
  out[1] = WideGeom<KP>::S;                                                 \
  out[2] = wide_active_clusters<KP>();                                      \
  out[3] = WideGeom<KP>::C;                                                 \
  out[4] = WideGeom<KP>::KR;                                                \
  out[5] = kDwStages;                                                       \
  return 0
  switch (kp) {
    case 256: HARP_MF_WIDE_GEOM(256);
    case 512: HARP_MF_WIDE_GEOM(512);
    case 1024: HARP_MF_WIDE_GEOM(1024);
    default: return -1;
  }
#undef HARP_MF_WIDE_GEOM
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
// the wide path's buffers in place of ws, bf16 blobs in core matrices (C =
// kp / 256 rank slices, nch = ceil(rpw / nmb / 64) chunks a stripe, n_ct =
// ceil(cpb / 64) column tiles): wbf (nw, nmb, nch, C, 64 x 256), gbuf (nw,
// nmb, nch, 2 n_ct, 64 x 32) and hsnap (nw, nmb, n_ct, C, 64 x 256);
// sse_part (nw, n_ct C) f32. Three launches (Wb, the hop in clusters of C,
// the dW GEMM with the W update).
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
