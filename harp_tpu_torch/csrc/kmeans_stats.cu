// Fused K-means E-step for Hopper (sm_90a): distances, row argmin and
// per-centroid sums, without writing the (N, K) score matrix to device
// memory.
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
// What bounds it on this card: the cross term, 2*N*K*D operations, against
// one read of x. It runs on the tensor cores as wgmma with float32 accuracy:
// float32 points as three TF32 passes, lo hi' + hi lo' + hi hi', where hi is
// the value rounded to TF32 (to nearest, ties away: an integer add and
// mask) and lo the rest rounded the same way; the dropped lo lo' term is
// below float32's rounding. One TF32 pass would move the cross term by
// ~1e-3 relative and flip argmins. bf16 points take one bf16 pass against
// the centroids rounded to bf16 (exact products). At the flagship N = 1e6,
// K = D = 100 that is 0.126 ms of TF32 operations (494.7 TFLOP/s) against
// 0.119 ms of bytes (3.35 TB/s). The tensor core truncates its running sum,
// so a product sums at most 128 features in its accumulator; wider rows
// carry the 128-feature partial sums in float32.
//
// wgmma operands: A (the points) from registers, each thread's fragment of
// a 64-row tile read from shared memory in the mma.sync order (rows g and
// g + 8, features t and t + 4 of each 8-feature TF32 step; word t and t + 4
// of each 16-feature bf16 step) and split into hi and lo there; B (the
// centroids) from shared memory in 8-row x 16-byte core matrices without a
// swizzle, K-major: core column j / 4 (TF32) or j / 8 (bf16) of a chunk of
// NT centroid rows at byte (j / E) NT 16 + (n / 8) 128 + (n % 8) 16, so the
// descriptor's leading offset is NT 16 bytes and its stride 128. x and c
// are both row-major with D contiguous, so both operands are K-major, the
// only layout TF32 wgmma reads. A warpgroup's register-A products hold it
// until the tensor cores take its fragments, so the overlap comes from the
// other warpgroups of the block. A chunk's accumulators start at
// -||c||^2 / 2 (init_chunk), so a score is -2 acc exactly; the fragment
// gives a thread rows g and g + 8 and columns 8 j + 2 t, 8 j + 2 t + 1.
//
// The argmin: each row keeps its best two (score, index) pairs,
// lexicographic, so the lowest index wins ties: the thread's columns in
// ascending order, then its quad by shuffles. The tensor cores' rounding is
// independent of a float32 GEMM's, so where the best two lie within 2^-16
// of the score's scale (a few times what either can move them) the two are
// re-scored as one float32 FMA chain in feature order (refine, exact_score:
// the plain version's arithmetic), and those rows take the argmin the
// plain version takes.
//
// Determinism: no float atomics anywhere, and the order of every sum is a
// function of (N, D, K, valid_k, the type and the card), never of W, the
// workers a launch stacks: a stacked launch is a grid (blocks a worker, W),
// each worker's blocks do the same work in it as in a launch of that worker
// alone, and a process holding 1 worker of a group is bitwise a stacked
// group. Two runs are bitwise equal.
//
// The narrow kernel (kmeans_stats_kernel<T, NT, CARRY>: every (D, K) whose
// block fits in shared memory, Narrow::bytes): the centroids' hi and lo
// planes (bf16: one plane), their norms and the (K, D+2) partial (columns
// [0, D) sums, then the counts and the distances of the points assigned to
// the row) stay in one block's shared memory. Three warpgroups take turns
// at the 64-point tiles of the block's share (tiles g, g + G, ...; G the
// card's resident blocks, at most one a tile). Each loads its tile
// (cp.async, 16 bytes where D and x allow), scores it against the planes in
// chunks of NT centroids (NT = 32, 64, 112 or 128 from valid_k; past D =
// 128, 32 or 64, the 128-feature sums carried) and ranks the tile's points
// by assignment (stable), then adds the tile into the partial: a thread 4
// columns of one part of the ranked tile (parts cut at run boundaries) sums
// each run of one centroid in rank order in registers and adds it once.
// The adds are handed around the warpgroups in tile order by named
// barriers, so the partial takes the tiles in the order g, g + G, ... while
// the others' scores overlap them. The partials go to a workspace (W, G,
// K, D+2); kmeans_reduce_kernel sums them over G in order (a thread a
// (row, column), the distance column too) and kmeans_cost_kernel sums the
// rows' distances in a fixed tree.
//
// The wide variant (kmeans_stats_wide_launch: every other (K, D)) is
// passes over device memory:
//   1. kmeans_prep_kernel: ||c_k||^2 and the centroids' planes, in blocks of
//      128 rows x 32 features laid out as shared memory takes them.
//   2. the assign pass, a GEMM with a row-argmin epilogue over the
//      centroids in chunks of 128 rows, ascending, and the features in
//      stages of 32. At D <= 128 kmeans_assign_resident_kernel: three
//      warpgroups, 192 points whose tile stays in shared memory, the
//      centroid blocks streamed onto a ring of mbarriers by bulk copies.
//      Past it kmeans_assign_kernel: two warpgroups, 128 points, x
//      sub-tiles and centroid blocks through a cp.async ring (16-byte
//      copies where D and x allow, zero-filled past N and D; bf16 rows of
//      odd D by plain loads). Both write each point's assignment and
//      distance (min score + ||x||^2): (W, N) int32 and float32.
//   3. a counting sort of the points by assignment: a stable LSD radix sort
//      on 8-bit digits of the assignment (one pass to 256 centroids, two to
//      65,536), each pass a histogram a 4096-point range, an exclusive scan
//      and a stable scatter (a warp's equal digits by __match_any_sync,
//      earlier warps by their counts, earlier batches by a running count);
//      then each centroid's first position (kmeans_bounds_kernel).
//   4. kmeans_piece_sums_kernel: each centroid's points, in index order, in
//      pieces of 256 points; a piece's sums (and distances) in point order.
//   5. kmeans_combine_kernel: each centroid's pieces summed in order (its
//      count is its run's length); kmeans_cost_kernel the distances.
// The sums read x once more, 4 bytes an element, and no (K, D) slab a block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;                 // points a warpgroup tile (wgmma M)
constexpr int kWG = 128;                  // threads a warpgroup
constexpr int kGroups = 3;                // warpgroups a narrow block
constexpr int kThreads = kGroups * kWG;
constexpr int kAThreads = 2 * kWG;        // the assign pass: 2 warpgroups
constexpr int kBatch = 4;                 // k-steps issued between waits
constexpr int kFeatBlock = 128;           // features in one accumulator
constexpr int kAddBatch = 4;              // ranked points read per batch
constexpr int kReduceThreads = 256;
// named barriers: 0 is __syncthreads; the add token of each warpgroup and
// a barrier of each warpgroup alone
constexpr int kTokenBar = 1;              // + warpgroup
constexpr int kGroupBar = 1 + kGroups;    // + warpgroup
constexpr int kParts = 4;                 // parts of a ranked tile's adds
// the wide variant
constexpr int kAPoints = 2 * kTile;       // points a block of the assign pass
constexpr int kACols = 128;               // centroid rows a chunk
constexpr int kADepth = 32;               // features a stage
constexpr int kAStages = 3;               // the streamed pass's ring
constexpr int kSortPoints = 4096;         // points a range of the sort
constexpr int kSortThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kPiece = 256;               // points a piece of the sums
constexpr int kPieceThreads = 128;

// The cross term's operand format of a point type: bytes an element, the
// features of one wgmma k-step, the planes of each centroid (hi and lo for
// TF32, the bf16-rounded value for bf16), elements a 16-byte core row.
template <typename T>
struct Fmt;
template <>
struct Fmt<float> {
  static constexpr int kElem = 4, kStep = 8, kPlanes = 2, kCore = 4;
};
template <>
struct Fmt<__nv_bfloat16> {
  static constexpr int kElem = 2, kStep = 16, kPlanes = 1, kCore = 8;
};

__host__ __device__ __forceinline__ int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}
__host__ __device__ __forceinline__ size_t align16(size_t a) {
  return (a + 15) & ~(size_t)15;
}

// The narrow kernel's centroids a chunk: the smallest of 32, 64, 112 whose
// chunk covers valid_k, above 112 chunks of 128; past D = 128, where a
// thread also carries the 128-feature partial sums, 32 or 64. plane_rows:
// the rows the chunks span (planes sized for K cover every valid_k <= K).
__host__ __device__ __forceinline__ bool carries(int d) {
  return d > kFeatBlock;
}
__host__ __device__ __forceinline__ int chunk_cols(int valid_k, int d) {
  if (carries(d)) return valid_k <= 32 ? 32 : 64;
  return valid_k <= 32 ? 32 : valid_k <= 64 ? 64 : valid_k <= 112 ? 112 : 128;
}
__host__ __device__ __forceinline__ int plane_rows(int k, int d) {
  return round_up(k, chunk_cols(k, d));
}

// Byte offset of feature j of centroid row n in a block of NT rows: core
// matrices of 8 rows x 16 bytes, core column j / kCore
template <typename T>
__host__ __device__ __forceinline__ int core_off(int n, int j, int nt) {
  return (j / Fmt<T>::kCore) * nt * 16 + (n >> 3) * 128 + (n & 7) * 16 +
         (j % Fmt<T>::kCore) * Fmt<T>::kElem;
}

// The narrow kernel's shared memory at (D, K): the planes, the norms, the
// (K, rs()) partial (rows of D + 2 columns rounded up to 4, so a thread's
// 4 columns are one 16-byte access) and, for each warpgroup, its tile (64
// rows of stride() 32-bit words: a multiple of 4 plus 4, so the fragment
// loads of a warp's 8 rows x 4 words meet no bank conflict), its 64
// assignments and distances, its 64 ranked (row, point) pairs and the
// bounds of its adds' parts. (The twin on the host side:
// pallas_kernels.kmeans_smem_bytes, the float32 layout.)
template <typename T>
struct Narrow {
  __host__ __device__ static int dp(int d) { return round_up(d, Fmt<T>::kStep); }
  __host__ __device__ static int stride(int d) {
    return dp(d) * Fmt<T>::kElem / 4 + 4;
  }
  __host__ __device__ static int rs(int d) { return round_up(d, 4) + 4; }
  __host__ __device__ static size_t c2_at(int d, int k) {
    return (size_t)plane_rows(k, d) * dp(d) * Fmt<T>::kElem * Fmt<T>::kPlanes;
  }
  __host__ __device__ static size_t part_at(int d, int k) {
    return c2_at(d, k) + 4 * (size_t)plane_rows(k, d);
  }
  __host__ __device__ static size_t tiles_at(int d, int k) {
    return align16(part_at(d, k) + 4 * (size_t)k * rs(d));
  }
  __host__ __device__ static size_t group_bytes(int d) {
    return 4 * ((size_t)kTile * stride(d) + 4 * kTile + 2 * kParts);
  }
  __host__ __device__ static size_t bytes(int d, int k) {
    return tiles_at(d, k) + kGroups * group_bytes(d);
  }
};

// The streamed assign pass's shared memory: a ring of kAStages stages, each
// the x sub-tile (128 rows x 32 features, rows of kStride words as above)
// and one centroid block (128 rows x 32 features, each plane), then the
// float32 carry of each thread's sums (kACols / 2 a thread, column-major
// over the threads)
template <typename T>
struct Wide {
  static constexpr int kStride = kADepth * Fmt<T>::kElem / 4 + 4;
  static constexpr int kXBytes = kAPoints * kStride * 4;
  static constexpr int kCBytes = kACols * kADepth * Fmt<T>::kElem;  // a plane
  static constexpr int kStage = kXBytes + Fmt<T>::kPlanes * kCBytes;
  static constexpr int kCarry = kAStages * kStage;
  static constexpr int kBytes = kCarry + kACols / 2 * kAThreads * 4;
  static_assert(kXBytes % 128 == 0 && kCBytes % 128 == 0, "aligned stages");
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// v rounded to TF32, to nearest with ties away from zero (cvt.rna's bits)
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// Write centroid value v at byte offset off of its plane(s); plane_bytes
// apart (TF32 hi then lo; bf16 the rounded value)
__device__ __forceinline__ void put_planes(float, unsigned char* p, int off,
                                           size_t plane_bytes, float v) {
  const uint32_t hi = tf32_rna(v);
  *reinterpret_cast<uint32_t*>(p + off) = hi;
  *reinterpret_cast<uint32_t*>(p + plane_bytes + off) =
      tf32_rna(v - __uint_as_float(hi));
}
__device__ __forceinline__ void put_planes(__nv_bfloat16, unsigned char* p,
                                           int off, size_t, float v) {
  *reinterpret_cast<__nv_bfloat16*>(p + off) = __float2bfloat16_rn(v);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// wgmma descriptor of a K-major operand in core matrices without a swizzle:
// lbo bytes between core columns (along K), sbo between 8-row groups
__device__ __forceinline__ uint64_t wg_desc(unsigned addr, unsigned lbo,
                                            unsigned sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait for every committed group, then tell the compiler the accumulators
// changed here
template <int M>
__device__ __forceinline__ void wgmma_wait(float (&d)[M]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int q = 0; q < M; ++q) asm volatile("" : "+f"(d[q])::"memory");
}
// shared memory written by the threads, read next by wgmma (async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
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
// bytes (a multiple of 16) from global to this block's shared memory by
// the bulk-copy engine, completing on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// cp.async of VB bytes (zero-filled when !valid; src must stay a valid
// address)
template <int VB>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const int n = valid ? VB : 0;
  if constexpr (VB == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(VB), "r"(n)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int VB>
struct VecOf;
template <>
struct VecOf<16> { using type = uint4; };
template <>
struct VecOf<8> { using type = uint2; };
template <>
struct VecOf<4> { using type = uint32_t; };
template <>
struct VecOf<2> { using type = uint16_t; };

// d (+)= A B for one k-step of a 64 x N tile on a warpgroup: A from
// registers (the mma.sync fragment), B in shared memory (descriptor), f32
// accumulators N / 2 a thread; warp q of the warpgroup holds rows 16 q ..
// 16 q + 15 as N / 8 mma.sync accumulator tiles. accumulate 0 zeroes d.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2],
                                           const uint32_t (&a)[4], uint64_t b,
                                           int accumulate);
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2],
                                           const uint32_t (&a)[4], uint64_t b,
                                           int accumulate);

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16],
    const uint32_t (&a)[4], uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15"
      "}, {%16,%17,%18,%19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32],
    const uint32_t (&a)[4], uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,"
      "%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, {%32,%33,%34,%35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_tf32<112>(float (&d)[56],
    const uint32_t (&a)[4], uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %61, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n112k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,"
      "%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,"
      "%47,%48,%49,%50,%51,%52,%53,%54,%55"
      "}, {%56,%57,%58,%59}, %60, p, 1, 1;\n}\n"
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
        "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64],
    const uint32_t (&a)[4], uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,"
      "%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,"
      "%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,"
      "%62,%63"
      "}, {%64,%65,%66,%67}, %68, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float (&d)[16],
    const uint32_t (&a)[4], uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15"
      "}, {%16,%17,%18,%19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32],
    const uint32_t (&a)[4], uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,"
      "%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, {%32,%33,%34,%35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_bf16<112>(float (&d)[56],
    const uint32_t (&a)[4], uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %61, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,"
      "%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,"
      "%47,%48,%49,%50,%51,%52,%53,%54,%55"
      "}, {%56,%57,%58,%59}, %60, p, 1, 1, 0;\n}\n"
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
        "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64],
    const uint32_t (&a)[4], uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,"
      "%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,"
      "%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,"
      "%62,%63"
      "}, {%64,%65,%66,%67}, %68, p, 1, 1, 0;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate)
      : "memory");
}



// A warpgroup's fragments of up to kBatch k-steps of a 64-row tile: rows
// r0 (row g of the thread's warp) and r1 (g + 8), each pointing at the
// batch's first feature (32-bit words; a step is 8 words in both types),
// split into hi and lo (TF32; bf16 words as they lie, in hi). With
// want_sq, the squares of the thread's elements go into xsq (row g, row
// g + 8).
template <typename T>
struct Frags {
  uint32_t hi[kBatch][4];
  uint32_t lo[Fmt<T>::kPlanes == 2 ? kBatch : 1][4];
};

template <typename T>
__device__ __forceinline__ void load_frags(Frags<T>& f, const uint32_t* r0,
                                           const uint32_t* r1, int nsteps,
                                           bool want_sq, float (&xsq)[2]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int s = 0; s < kBatch; ++s) {
    if (s < nsteps) {
      const int w = 8 * s + t;
      const uint32_t raw[4] = {r0[w], r1[w], r0[w + 4], r1[w + 4]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (Fmt<T>::kPlanes == 2) {
          const float v = __uint_as_float(raw[e]);
          if (want_sq) xsq[e & 1] = fmaf(v, v, xsq[e & 1]);
          f.hi[s][e] = tf32_rna(v);
          f.lo[s][e] = tf32_rna(v - __uint_as_float(f.hi[s][e]));
        } else {
          if (want_sq) {
            const float v0 = __uint_as_float(raw[e] << 16);
            const float v1 = __uint_as_float(raw[e] & 0xffff0000u);
            xsq[e & 1] = fmaf(v1, v1, fmaf(v0, v0, xsq[e & 1]));
          }
          f.hi[s][e] = raw[e];
        }
      }
    }
  }
}

// Issue the batch's products into acc (zeroed by the first when first), B
// at shared byte address b (the batch's first core column; the lo plane
// lo_off bytes on), and commit them as one group: TF32 the small terms
// (lo hi' + hi lo') of its steps, then their large ones (hi hi'), so the
// small ones add while the truncating sum is smaller; bf16 one product a
// step
template <typename T, int NT>
__device__ __forceinline__ void issue_frags(float (&acc)[NT / 2],
                                            const Frags<T>& f, int nsteps,
                                            unsigned b, unsigned lo_off,
                                            bool first) {
  wgmma_fence();
  int keep = !first;
  if constexpr (Fmt<T>::kPlanes == 2) {
#pragma unroll
    for (int s = 0; s < kBatch; ++s) {
      if (s < nsteps) {
        const unsigned bs = b + s * 2 * NT * 16;
        wgmma_tf32<NT>(acc, f.lo[s], wg_desc(bs, NT * 16, 128), keep);
        wgmma_tf32<NT>(acc, f.hi[s], wg_desc(bs + lo_off, NT * 16, 128), 1);
        keep = 1;
      }
    }
  }
#pragma unroll
  for (int s = 0; s < kBatch; ++s) {
    if (s < nsteps) {
      const uint64_t dh = wg_desc(b + s * 2 * NT * 16, NT * 16, 128);
      if constexpr (Fmt<T>::kPlanes == 2)
        wgmma_tf32<NT>(acc, f.hi[s], dh, keep);
      else
        wgmma_bf16<NT>(acc, f.hi[s], dh, keep);
      keep = 1;
    }
  }
  wgmma_commit();
}

// One batch of up to kBatch k-steps, waited for: the narrow kernel's and
// the streamed assign pass's step
template <typename T, int NT>
__device__ __forceinline__ void mma_batch(float (&acc)[NT / 2],
                                          const uint32_t* r0,
                                          const uint32_t* r1, int nsteps,
                                          unsigned b, unsigned lo_off,
                                          bool first, bool want_sq,
                                          float (&xsq)[2]) {
  Frags<T> f;
  load_frags<T>(f, r0, r1, nsteps, want_sq, xsq);
  issue_frags<T, NT>(acc, f, nsteps, b, lo_off, first);
  wgmma_wait(acc);
}

// A thread's two rows' best two (score, index) pairs so far. The order is
// lexicographic, so the lowest index wins equal scores.
struct Top2 {
  float b[2], n[2];
  int i[2], j[2];
  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      b[r] = n[r] = INFINITY;
      i[r] = j[r] = 0;
    }
  }
};

__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  return a < b || (a == b && ia < ib);
}

constexpr float kRefine = 1.52587890625e-05f;   // 2^-16, see refine

// Whether score b (of centroid norm cb) and a runner-up n are near ties:
// within kRefine of b's scale |c2| + 2 |x . c|
__device__ __forceinline__ bool near_tie(float b, float n, float cb) {
  return n - b <= kRefine * (fabsf(cb) + fabsf(cb - b));
}

// A chunk's accumulators start at -||c||^2 / 2 of their columns, so the
// products leave v = x . c - ||c||^2 / 2 and the score is -2 v exactly:
// the epilogue takes the largest v, with no load or product a candidate
template <int NT>
__device__ __forceinline__ void init_chunk(float (&acc)[NT / 2],
                                           const float* c2, int col0) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float h = -0.5f * c2[col0 + 8 * j + 2 * t + e];
      acc[4 * j + e] = h;
      acc[4 * j + 2 + e] = h;
    }
}

// The chunk into the thread's two rows' best two: v (x . c - ||c||^2 / 2)
// of columns col0 + 8 j + 2 t (+1) in ascending order, the largest first
// (strict >: the lowest index wins equal scores). A first sweep keeps the
// chunk's best and, branch-free, its runner-up; only where the two are
// near ties does a second sweep find the runner-up's index (the lowest of
// that value). Scores (-2 v) go into top.
template <int NT>
__device__ __forceinline__ void argmin_chunk(const float (&v)[NT / 2],
                                             const float* c2, int col0,
                                             int valid_k, Top2& top) {
  const int t = threadIdx.x & 3;
  float cb[2] = {-INFINITY, -INFINITY}, cn[2] = {-INFINITY, -INFINITY};
  int ci[2] = {0, 0};
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (col0 + 8 * j + 2 * t + e < valid_k) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float x = v[4 * j + 2 * r + e];
          cn[r] = fmaxf(cn[r], fminf(x, cb[r]));
          if (x > cb[r]) {
            cb[r] = x;
            ci[r] = col0 + 8 * j + 2 * t + e;
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sb = -2.f * cb[r], sn = -2.f * cn[r];
    int cj = 0;
    if (sn < INFINITY && near_tie(sb, sn, c2[ci[r]])) {
      cj = -1;
#pragma unroll
      for (int j = 0; j < NT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + 8 * j + 2 * t + e;
          if (cj < 0 && col < valid_k && col != ci[r] &&
              v[4 * j + 2 * r + e] == cn[r])
            cj = col;
        }
    }
    if (before(sb, ci[r], top.b[r], top.i[r])) {
      if (before(top.b[r], top.i[r], sn, cj)) {
        top.n[r] = top.b[r];
        top.j[r] = top.i[r];
      } else {
        top.n[r] = sn;
        top.j[r] = cj;
      }
      top.b[r] = sb;
      top.i[r] = ci[r];
    } else if (before(sb, ci[r], top.n[r], top.j[r])) {
      top.n[r] = sb;
      top.j[r] = ci[r];
    }
  }
}

// The quad's best two of each of the thread's rows and their ||x||^2
// (summed in a fixed tree), the same bits in the quad's four lanes
__device__ __forceinline__ void quad_finish(Top2& top, float (&xsq)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, top.b[r], off);
      const int oi = __shfl_xor_sync(0xffffffffu, top.i[r], off);
      const float on = __shfl_xor_sync(0xffffffffu, top.n[r], off);
      const int oj = __shfl_xor_sync(0xffffffffu, top.j[r], off);
      if (before(ob, oi, top.b[r], top.i[r])) {
        if (!before(top.b[r], top.i[r], on, oj)) {
          top.b[r] = on;
          top.i[r] = oj;
        }
        top.n[r] = top.b[r];
        top.j[r] = top.i[r];
        top.b[r] = ob;
        top.i[r] = oi;
      } else if (before(ob, oi, top.n[r], top.j[r])) {
        top.n[r] = ob;
        top.j[r] = oi;
      }
      xsq[r] += __shfl_xor_sync(0xffffffffu, xsq[r], off);
    }
  }
}

// the cross-term operand: centroids rounded to the points' type
template <typename T>
__device__ __forceinline__ float round_like(float v) { return v; }
template <>
__device__ __forceinline__ float round_like<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ||c||^2 - 2 x . c with the cross term as one fused multiply-add chain in
// feature order: the arithmetic of a float32 GEMM and of the plain version
// (the loads 16 at a time, the chain in order)
template <typename T>
__device__ __noinline__ float exact_score(const T* x, const float* c,
                                          float c2, int d) {
  constexpr int U = 16;
  float dot = 0.f;
  int j = 0;
  for (; j + U <= d; j += U) {
    float xv[U], cv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      xv[u] = to_float(x[j + u]);
      cv[u] = round_like<T>(c[j + u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) dot = fmaf(xv[u], cv[u], dot);
  }
  for (; j < d; ++j) dot = fmaf(to_float(x[j]), round_like<T>(c[j]), dot);
  return c2 - 2.f * dot;
}

// Near ties re-scored: where a row's best two scores lie within kRefine
// of the scale of its best (|c2| + 2 |x . c|), a few times what the tensor
// cores' rounding and a float32 GEMM's together can move them, lanes 0 and
// 1 of the quad take the two exactly (exact_score) and the lexicographic
// minimum wins. So an argmin the products' rounding could move is decided
// by the float32 arithmetic of the plain version, whose rounding is
// independent of the tensor cores' (rows whose counts match can then
// still hold other points). x0, x1: the thread's two rows (valid where
// ok0, ok1); c: the worker's (K, D) table.
template <typename T>
__device__ __forceinline__ void refine(Top2& top, const T* x0, const T* x1,
                                       bool ok0, bool ok1, const float* c,
                                       const float* c2, int d) {
  const int lane = threadIdx.x & 31;
  const int q = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool near = (r ? ok1 : ok0) && top.n[r] < INFINITY &&
                      near_tie(top.b[r], top.n[r], c2[top.i[r]]);
    float sc = 0.f;
    if (near && q < 2) {
      const int row = q ? top.j[r] : top.i[r];
      sc = exact_score<T>(r ? x1 : x0, c + (size_t)row * d, c2[row], d);
    }
    const float s_best = __shfl_sync(0xffffffffu, sc, lane & ~3);
    const float s_next = __shfl_sync(0xffffffffu, sc, (lane & ~3) + 1);
    if (near) {
      if (before(s_next, top.j[r], s_best, top.i[r])) {
        top.b[r] = s_next;
        top.i[r] = top.j[r];
      } else {
        top.b[r] = s_best;
      }
    }
  }
}

// Copy cnt rows of d elements (contiguous at src) into the tile's rows of
// S words, VB bytes at a time (VB divides the row's bytes and src's
// alignment): by cp.async from 4 bytes, else by plain loads (bf16 rows of
// odd D)
template <typename T, int VB>
__device__ __forceinline__ void copy_rows(const T* src, int cnt, int d, int S,
                                          uint32_t* tile, int tid) {
  constexpr int E = VB / (int)sizeof(T);
  const int total = cnt * d;
  if constexpr (VB >= 4) {
    for (int q = tid; q * E < total; q += kWG) {
      const int f = q * E;
      const int r = f / d;
      cp_async<VB>(reinterpret_cast<T*>(tile + (size_t)r * S) + (f - r * d),
                   src + f, true);
    }
  } else if constexpr (VB >= (int)sizeof(T)) {
    for (int f = tid; f < total; f += kWG) {
      const int r = f / d;
      reinterpret_cast<T*>(tile + (size_t)r * S)[f - r * d] = src[f];
    }
  }
}

// The tile's copies, waited for
template <typename T>
__device__ __forceinline__ void load_tile(const T* src, int cnt, int d, int S,
                                          uint32_t* tile, int tid, int vb) {
  switch (vb) {
    case 16: copy_rows<T, 16>(src, cnt, d, S, tile, tid); break;
    case 8: copy_rows<T, 8>(src, cnt, d, S, tile, tid); break;
    case 4: copy_rows<T, 4>(src, cnt, d, S, tile, tid); break;
    default: copy_rows<T, 2>(src, cnt, d, S, tile, tid); break;
  }
  cp_async_commit();
  cp_async_wait<0>();
}

// Four consecutive features c0 .. c0 + 3 of a tile row (zero past D)
template <typename T>
__device__ __forceinline__ float4 row4(const uint32_t* row, int c0) {
  if constexpr (Fmt<T>::kPlanes == 2) {
    return *reinterpret_cast<const float4*>(row + c0);
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(
        reinterpret_cast<const __nv_bfloat16*>(row) + c0);
    return make_float4(__uint_as_float(u.x << 16),
                       __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16),
                       __uint_as_float(u.y & 0xffff0000u));
  }
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

template <typename T, int NT, bool CARRY>
__global__ void __launch_bounds__(kThreads, 1)
kmeans_stats_kernel(const T* __restrict__ x, const float* __restrict__ c,
                    float* __restrict__ ws, int n, int d, int k, int valid_k,
                    int c_per_worker, int vb) {
  using N = Narrow<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int DP = N::dp(d);
  const int S = N::stride(d);
  const int RS = N::rs(d);
  const int nct = (valid_k + NT - 1) / NT;
  const size_t plane_bytes = (size_t)NT * DP * Fmt<T>::kElem;
  const size_t chunk_bytes = plane_bytes * Fmt<T>::kPlanes;
  unsigned char* planes = smem;
  float* c2 = reinterpret_cast<float*>(smem + N::c2_at(d, k));
  float* acc = reinterpret_cast<float*>(smem + N::part_at(d, k));

  const int tid = threadIdx.x;
  const int wg = tid / kWG;
  const int wt = tid % kWG;
  uint32_t* tile = reinterpret_cast<uint32_t*>(smem + N::tiles_at(d, k) +
                                               wg * N::group_bytes(d));
  int* asg = reinterpret_cast<int*>(tile + (size_t)kTile * S);
  float* dist = reinterpret_cast<float*>(asg + kTile);
  int2* ranked = reinterpret_cast<int2*>(dist + kTile);
  int* split = reinterpret_cast<int*>(ranked + kTile);

  const int w = blockIdx.y;
  const int g = blockIdx.x;
  const int grid_g = gridDim.x;
  const T* xw = x + (size_t)w * n * d;
  const float* cw = c + (c_per_worker ? (size_t)w * k * d : 0);

  // the planes, the norms, a zero partial and zero tiles (the padded
  // features stay zero)
  const int rows = nct * NT;
  for (int i = tid; i < rows * DP; i += kThreads) {
    const int r = i / DP;
    const int j = i - r * DP;
    const float v = (r < valid_k && j < d) ? cw[(size_t)r * d + j] : 0.f;
    const int ct = r / NT;
    put_planes(T(), planes + ct * chunk_bytes, core_off<T>(r - ct * NT, j, NT),
               plane_bytes, v);
  }
  for (int r = tid; r < rows; r += kThreads) {
    float s = 0.f;
    if (r < valid_k)
      for (int j = 0; j < d; ++j) s = fmaf(cw[r * d + j], cw[r * d + j], s);
    c2[r] = s;
  }
  for (int i = tid; i < k * RS; i += kThreads) acc[i] = 0.f;
  {
    uint32_t* all = reinterpret_cast<uint32_t*>(smem + N::tiles_at(d, k));
    for (size_t i = tid; i < kGroups * N::group_bytes(d) / 4; i += kThreads)
      all[i] = 0u;
  }
  fence_async_smem();
  __syncthreads();

  const int lane = tid & 31;
  const int wq = (tid / 32) & 3;
  const int gq = lane >> 2;
  const uint32_t* r0 = tile + (size_t)(16 * wq + gq) * S;
  const uint32_t* r1 = r0 + 8 * S;
  const unsigned pbase = smem_u32(planes);
  // the adds: a thread sums 4 columns of one part of the ranked tile
  // (parts are cut at run boundaries, so each row's run is in one part):
  // a job a (part, group of 4 features), then a job a part for the count
  // and distance columns, so no warp's lanes mix the two kinds but one
  const int groups4 = RS / 4;               // the last: count, distance
  const int parts = max(1, min(kParts, kWG / groups4));
  const int xjobs = parts * (groups4 - 1);
  const int num_tiles = (n + kTile - 1) / kTile;
  const int mine = g < num_tiles ? (num_tiles - g + grid_g - 1) / grid_g : 0;
  const int iters = (mine + kGroups - 1) / kGroups;
  // the adds go in tile order around the warpgroups: warpgroup 0 first
  if (wg == kGroups - 1 && iters > 0) bar_arrive(kTokenBar, 2 * kWG);

  for (int it = 0; it < iters; ++it) {
    const int pos = kGroups * it + wg;
    const bool have = pos < mine;
    const int base = (g + pos * grid_g) * kTile;
    const int cnt = have ? min(kTile, n - base) : 0;
    if (have) {
      load_tile<T>(xw + (size_t)base * d, cnt, d, S, tile, wt, vb);
      bar_sync(kGroupBar + wg, kWG);

      Top2 top;
      top.reset();
      float xsq[2] = {0.f, 0.f};
      for (int ct = 0; ct < nct; ++ct) {
        float part[NT / 2];
        float sc[CARRY ? NT / 2 : 1];
        const unsigned cb = pbase + ct * chunk_bytes;
        for (int kb = 0; kb < DP; kb += kFeatBlock) {
          const int kend = min(DP, kb + kFeatBlock);
          // the chunk's first block starts from -||c||^2 / 2, a later
          // block (carried) from zero
          if (kb == 0) init_chunk<NT>(part, c2, ct * NT);
          for (int k0 = kb; k0 < kend; k0 += kBatch * Fmt<T>::kStep) {
            const int w0 = k0 * Fmt<T>::kElem / 4;
            mma_batch<T, NT>(part, r0 + w0, r1 + w0,
                             min(kBatch, (kend - k0) / Fmt<T>::kStep),
                             cb + (k0 / Fmt<T>::kCore) * NT * 16,
                             (unsigned)plane_bytes, kb > 0 && k0 == kb,
                             ct == 0, xsq);
          }
          if constexpr (CARRY) {
#pragma unroll
            for (int q = 0; q < NT / 2; ++q)
              sc[q] = kb == 0 ? part[q] : sc[q] + part[q];
          }
        }
        if constexpr (CARRY)
          argmin_chunk<NT>(sc, c2, ct * NT, valid_k, top);
        else
          argmin_chunk<NT>(part, c2, ct * NT, valid_k, top);
      }
      quad_finish(top, xsq);
      refine<T>(top, reinterpret_cast<const T*>(r0),
                reinterpret_cast<const T*>(r1), 16 * wq + gq < cnt,
                16 * wq + gq + 8 < cnt, cw, c2, d);
      if ((lane & 3) == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int p = 16 * wq + gq + 8 * r;
          asg[p] = top.i[r];
          dist[p] = top.b[r] + xsq[r];
        }
      }
      if (wt <= kParts) split[wt] = wt ? cnt : 0;
      bar_sync(kGroupBar + wg, kWG);

      // stable rank of each point by assignment, two lanes a point; each
      // part starts at the first run that starts at or past its share
      // (an integer minimum: the same in any order)
      {
        const int p = wt >> 1;
        const int half = wt & 1;
        const int a = asg[p];
        int less = 0, same = 0;
#pragma unroll
        for (int u = 0; u < kTile / 2; ++u) {
          const int q = half * (kTile / 2) + u;
          const int b = asg[q];
          less += (q < cnt) & (b < a);
          same += (b == a) & (q < p);
        }
        less += __shfl_xor_sync(0xffffffffu, less, 1);
        same += __shfl_xor_sync(0xffffffffu, same, 1);
        const int r = less + same;
        if (half == 0 && p < cnt) {
          ranked[r] = make_int2(a, p);
          if (same == 0)
            for (int q = 1; q < parts; ++q)
              if (r * parts >= q * cnt) atomicMin(&split[q], r);
        }
      }
      bar_sync(kGroupBar + wg, kWG);
    }

    // the adds, in tile order: each run of one centroid summed in rank
    // order in registers, 4 columns at a time, and added to the partial
    // once; the runs ending in one batch are distinct rows
    bar_sync(kTokenBar + wg, 2 * kWG);
    for (int job = wt; job < parts * groups4 && have; job += kWG) {
      const bool xj = job < xjobs;
      const int q = xj ? job / (groups4 - 1) : job - xjobs;
      const int c0 = xj ? 4 * (job - q * (groups4 - 1)) : RS - 4;
      const int hi = split[q + 1];
      for (int i0 = split[q]; i0 < hi; i0 += kAddBatch) {
        int rr[kAddBatch];
        float4 vv[kAddBatch];
#pragma unroll
        for (int u = 0; u < kAddBatch; ++u) {
          const int2 e =
              i0 + u < hi ? ranked[i0 + u] : make_int2(-1, ranked[i0].y);
          rr[u] = e.x;
          vv[u] = xj ? row4<T>(tile + (size_t)e.y * S, c0)
                     : make_float4(1.f, dist[e.y], 0.f, 0.f);
        }
#pragma unroll
        for (int u = 1; u < kAddBatch; ++u)
          if (rr[u] == rr[u - 1]) vv[u] = add4(vv[u - 1], vv[u]);
        bool last[kAddBatch];
#pragma unroll
        for (int u = 0; u < kAddBatch; ++u) {
          last[u] =
              rr[u] >= 0 && (u + 1 == kAddBatch || rr[u + 1] != rr[u]);
          if (last[u])
            vv[u] = add4(*reinterpret_cast<const float4*>(
                             acc + (size_t)rr[u] * RS + c0),
                         vv[u]);
        }
#pragma unroll
        for (int u = 0; u < kAddBatch; ++u)
          if (last[u])
            *reinterpret_cast<float4*>(acc + (size_t)rr[u] * RS + c0) = vv[u];
      }
    }
    if (wg + 1 < kGroups || it + 1 < iters)
      bar_arrive(kTokenBar + (wg + 1) % kGroups, 2 * kWG);
    bar_sync(kGroupBar + wg, kWG);        // the tile's readers are done
  }
  __syncthreads();
  const int row = d + 2;
  float* out = ws + ((size_t)w * grid_g + g) * k * row;
  for (int i = tid; i < k * row; i += kThreads) {
    const int r = i / row;
    const int col = i - r * row;
    out[i] = acc[(size_t)r * RS + (col < d ? col : RS - 4 + col - d)];
  }
}

// Reduce the (W, G, K, D+2) partials over G in order, a thread a (row,
// column): sums, counts, and each row's distance into rowcost (W, K)
__global__ void __launch_bounds__(kReduceThreads)
kmeans_reduce_kernel(const float* __restrict__ ws, float* __restrict__ sums,
                     float* __restrict__ counts, float* __restrict__ rowcost,
                     int d, int k, int grid_g) {
  const int w = blockIdx.y;
  const int row = d + 2;
  const int i = blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= k * row) return;
  const size_t stride = (size_t)k * row;
  const float* src = ws + (size_t)w * grid_g * stride + i;
  float s = 0.f;
#pragma unroll 8
  for (int g = 0; g < grid_g; ++g) s += src[g * stride];
  const int r = i / row;
  const int col = i - r * row;
  if (col < d)
    sums[((size_t)w * k + r) * d + col] = s;
  else if (col == d)
    counts[(size_t)w * k + r] = s;
  else
    rowcost[(size_t)w * k + r] = s;
}

// cost[w] = the rows' distances of worker w: each thread sums rows tid,
// tid + 256, ... in order, then a fixed tree
__global__ void __launch_bounds__(kReduceThreads)
kmeans_cost_kernel(const float* __restrict__ rowcost, float* __restrict__ cost,
                   int k) {
  __shared__ float part[kReduceThreads];
  const int w = blockIdx.x;
  const int tid = threadIdx.x;
  float s = 0.f;
  for (int r = tid; r < k; r += kReduceThreads) s += rowcost[(size_t)w * k + r];
  part[tid] = s;
  __syncthreads();
  for (int off = kReduceThreads / 2; off > 0; off >>= 1) {
    if (tid < off) part[tid] += part[tid + off];
    __syncthreads();
  }
  if (tid == 0) cost[w] = part[0];
}

// --------------------------------------------------------------------------
// The wide variant
// --------------------------------------------------------------------------

// ||c_r||^2 and the planes of every padded row (zero past valid_k and D), a
// warp a row: lane-strided sums, a fixed tree. Row r of table wc: c2 at
// wc kp + r; its planes in the blocks (r / 128, j / 32) of 128 rows x 32
// features, each plane of a block kCBytes on from the last.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
kmeans_prep_kernel(const float* __restrict__ c, float* __restrict__ c2,
                   unsigned char* __restrict__ planes, int k, int d,
                   int valid_k, int kp, int dpw, int tables) {
  const int r = blockIdx.x * (kReduceThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= tables * kp) return;           // the same for the whole warp
  const int wc = r / kp;
  const int rr = r - wc * kp;
  const bool real = rr < valid_k;
  const float* src = c + ((size_t)wc * k + rr) * d;
  const int nfc = dpw / kADepth;
  const size_t blk = (size_t)Fmt<T>::kPlanes * Wide<T>::kCBytes;
  unsigned char* pw = planes + (size_t)wc * (kp / kACols) * nfc * blk;
  const int ct = rr / kACols;
  const int n = rr - ct * kACols;
  float s = 0.f;
  for (int j = lane; j < dpw; j += 32) {
    const float v = real && j < d ? src[j] : 0.f;
    s = fmaf(v, v, s);
    const int fc = j / kADepth;
    put_planes(T(), pw + ((size_t)ct * nfc + fc) * blk,
               core_off<T>(n, j - fc * kADepth, kACols), Wide<T>::kCBytes, v);
  }
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) c2[r] = s;
}

// Rows [0, rows) of the block's points at xw, features [j0, j0 + nf), into
// shared rows of stride words at dst by nthreads threads, zero past cnt
// and D: by cp.async from 4 bytes, else (bf16 rows of odd D) by plain
// loads
template <typename T, int VB>
__device__ __forceinline__ void stage_rows(const T* xw, int cnt, int d,
                                           int j0, int nf, int stride,
                                           unsigned char* dst, int tid,
                                           int rows, int nthreads) {
  if constexpr (VB >= 4) {
    constexpr int E = VB / (int)sizeof(T);
    const int per_row = nf / E;
    for (int q = tid; q < rows * per_row; q += nthreads) {
      const int r = q / per_row;
      const int j = j0 + (q - r * per_row) * E;
      const bool ok = r < cnt && j < d;
      cp_async<VB>(dst + (size_t)r * stride * 4 + (j - j0) * sizeof(T),
                   ok ? xw + (size_t)r * d + j : xw, ok);
    }
  } else {
    for (int q = tid; q < rows * nf; q += nthreads) {
      const int r = q / nf;
      const int j = j0 + q - r * nf;
      reinterpret_cast<T*>(dst + (size_t)r * stride * 4)[j - j0] =
          r < cnt && j < d ? xw[(size_t)r * d + j] : T(0.f);
    }
  }
}

template <typename T>
__device__ __forceinline__ void stage_x(const T* xw, int cnt, int d, int j0,
                                        int nf, int stride,
                                        unsigned char* dst, int tid, int vb,
                                        int rows = kAPoints,
                                        int nthreads = kAThreads) {
  switch (vb) {
    case 16: stage_rows<T, 16>(xw, cnt, d, j0, nf, stride, dst, tid, rows,
                               nthreads); break;
    case 8: stage_rows<T, 8>(xw, cnt, d, j0, nf, stride, dst, tid, rows,
                             nthreads); break;
    case 4: stage_rows<T, 4>(xw, cnt, d, j0, nf, stride, dst, tid, rows,
                             nthreads); break;
    default: stage_rows<T, 2>(xw, cnt, d, j0, nf, stride, dst, tid, rows,
                              nthreads); break;
  }
}

// a centroid block (each plane of 128 rows x 32 features) into dst
template <typename T>
__device__ __forceinline__ void stage_c(const unsigned char* cblk,
                                        unsigned char* dst, int tid) {
  constexpr int cb = Fmt<T>::kPlanes * Wide<T>::kCBytes;
#pragma unroll
  for (int q = tid; q < cb / 16; q += kAThreads)
    cp_async<16>(dst + q * 16, cblk + q * 16, true);
}

// The thread's first row in the block: warpgroup g's rows from 64 g
__device__ __forceinline__ int block_row() {
  const int tid = threadIdx.x;
  return 64 * (tid / kWG) + 16 * ((tid / 32) & 3) + ((tid & 31) >> 2);
}

// The block's assignments and distances (its rows below cnt), near ties
// re-scored from the thread's rows x0 (row block_row()) and x1 (8 on)
template <typename T>
__device__ __forceinline__ void write_assign(int* asg, float* dist,
                                             size_t at, int cnt, Top2& top,
                                             float (&xsq)[2], const T* x0,
                                             const T* x1, const float* c,
                                             const float* c2, int d) {
  const int p0 = block_row();
  quad_finish(top, xsq);
  refine<T>(top, x0, x1, p0 < cnt, p0 + 8 < cnt, c, c2, d);
  if ((threadIdx.x & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (p0 + 8 * r < cnt) {
        asg[at + p0 + 8 * r] = top.i[r];
        dist[at + p0 + 8 * r] = top.b[r] + xsq[r];
      }
    }
  }
}

// A 128-point block: its argmin over all valid_k centroids and each
// point's distance; warpgroup wg owns rows 64 wg .. 64 wg + 63. Past D =
// 128 (the x tile does not stay in shared memory): x sub-tiles and the
// centroid blocks stream through the ring together, each stage's
// products waited for and its 32-feature sums carried in float32.
template <typename T>
__global__ void __launch_bounds__(kAThreads, 1)
kmeans_assign_kernel(const T* __restrict__ x, const float* __restrict__ c,
                     const unsigned char* __restrict__ planes,
                     const float* __restrict__ c2, int* __restrict__ asg,
                     float* __restrict__ dist, int n, int d, int k,
                     int valid_k, int c_per_worker, int vb) {
  using Wd = Wide<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int w = blockIdx.y;
  const int base = blockIdx.x * kAPoints;
  const int cnt = min(kAPoints, n - base);
  const int kp = round_up(valid_k, kACols);
  const int nct = kp / kACols;
  const int nfc = round_up(d, kADepth) / kADepth;
  const int dstep = round_up(d, Fmt<T>::kStep);
  const int steps = nct * nfc;
  constexpr int cb = Fmt<T>::kPlanes * Wd::kCBytes;
  const unsigned char* pw =
      planes + (c_per_worker ? (size_t)w * nct * nfc * cb : 0);
  const float* c2w = c2 + (c_per_worker ? (size_t)w * kp : 0);
  const T* xw = x + ((size_t)w * n + base) * d;
  const int rw0 = block_row() * Wd::kStride;
  const int rw1 = rw0 + 8 * Wd::kStride;

#pragma unroll
  for (int s = 0; s < kAStages - 1; ++s) {
    if (s < steps) {
      unsigned char* slot = smem + s * Wd::kStage;
      stage_x<T>(xw, cnt, d, (s % nfc) * kADepth, kADepth, Wd::kStride, slot,
                 tid, vb);
      stage_c<T>(pw + (size_t)s * cb, slot + Wd::kXBytes, tid);
    }
    cp_async_commit();
  }

  // the running best two and the carried sums in shared memory: they are
  // touched only at a 128-feature block's end
  __shared__ Top2 tops[kAThreads];
  Top2& top = tops[tid];
  top.reset();
  float* carry = reinterpret_cast<float*>(smem + Wd::kCarry) + tid;
  float xsq[2] = {0.f, 0.f};
  float part[kACols / 2];
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kAStages - 2>();
    fence_async_smem();
    __syncthreads();                      // stage s landed; slot s - 1 free
    {
      const int ls = s + kAStages - 1;
      if (ls < steps) {
        unsigned char* slot = smem + (ls % kAStages) * Wd::kStage;
        stage_x<T>(xw, cnt, d, (ls % nfc) * kADepth, kADepth, Wd::kStride,
                   slot, tid, vb);
        stage_c<T>(pw + (size_t)ls * cb, slot + Wd::kXBytes, tid);
      }
      cp_async_commit();
    }
    const int ct = s / nfc;
    const int fc = s - ct * nfc;
    unsigned char* slot = smem + (s % kAStages) * Wd::kStage;
    const uint32_t* xs = reinterpret_cast<const uint32_t*>(slot);
    // a chunk's first block starts from -||c||^2 / 2, a later one from
    // zero; a block is kFeatBlock / kADepth stages, and its sums are
    // carried in float32. The last stage takes only the k-steps D reaches.
    constexpr int kPer = kFeatBlock / kADepth;
    if (fc == 0) init_chunk<kACols>(part, c2w, ct * kACols);
    mma_batch<T, kACols>(part, xs + rw0, xs + rw1,
                         min(kADepth, dstep - fc * kADepth) / Fmt<T>::kStep,
                         smem_u32(slot + Wd::kXBytes), Wd::kCBytes,
                         fc % kPer == 0 && fc > 0, ct == 0, xsq);
    if (fc == nfc - 1) {
      if (fc >= kPer) {
#pragma unroll
        for (int q = 0; q < kACols / 2; ++q)
          part[q] += carry[q * kAThreads];
      }
      argmin_chunk<kACols>(part, c2w, ct * kACols, valid_k, top);
    } else if (fc % kPer == kPer - 1) {
#pragma unroll
      for (int q = 0; q < kACols / 2; ++q)
        carry[q * kAThreads] =
            fc < kPer ? part[q] : carry[q * kAThreads] + part[q];
    }
  }
  cp_async_wait<0>();
  const int p0 = block_row();
  write_assign<T>(asg, dist, (size_t)w * n + base, cnt, top, xsq,
                  xw + (size_t)min(p0, cnt - 1) * d,
                  xw + (size_t)min(p0 + 8, cnt - 1) * d,
                  c + (c_per_worker ? (size_t)w * k * d : 0), c2w, d);
}

// The resident assign pass: kRGroups warpgroups (64 points each). Its
// shared memory: the block's x tile (rows of D rounded up to 32 features,
// stride() words: a multiple of 4 plus 4) and the ring of centroid blocks
constexpr int kRGroups = 3;
constexpr int kRPoints = kRGroups * kTile;
constexpr int kRThreads = kRGroups * kWG;
template <typename T>
struct Resident {
  static constexpr int kStages = Fmt<T>::kPlanes == 2 ? 3 : 4;
  static constexpr int kCB = Fmt<T>::kPlanes * Wide<T>::kCBytes;
  __host__ __device__ static int stride(int d) {
    return round_up(d, kADepth) * Fmt<T>::kElem / 4 + 4;
  }
  __host__ __device__ static size_t x_bytes(int d) {
    return ((size_t)kRPoints * stride(d) * 4 + 127) & ~(size_t)127;
  }
  __host__ __device__ static size_t bytes(int d) {
    return x_bytes(d) + (size_t)kStages * kCB;
  }
};

// The assign pass at D <= 128: the block's x tile stays in shared memory,
// loaded once; the centroid blocks stream through a ring by bulk copies,
// each landing on its slot's mbarrier, and the last warp to finish with a
// slot (a count a slot) asks for the block that goes there next, so no
// warpgroup waits for another at a step. A warpgroup's register-A products
// hold it until the tensor cores take its fragments, so the overlap comes
// from the other warpgroups: while one's products run, the others read and
// split their next fragments. The whole D sums in one accumulator.
template <typename T>
__global__ void __launch_bounds__(kRThreads, 1)
kmeans_assign_resident_kernel(const T* __restrict__ x,
                              const float* __restrict__ c,
                              const unsigned char* __restrict__ planes,
                              const float* __restrict__ c2,
                              int* __restrict__ asg, float* __restrict__ dist,
                              int n, int d, int k, int valid_k,
                              int c_per_worker, int vb) {
  using R = Resident<T>;
  constexpr int S = R::kStages;
  constexpr int cb = R::kCB;
  constexpr int kConsumers = kRThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t full[S];
  __shared__ int done[S];
  const int tid = threadIdx.x;
  const int w = blockIdx.y;
  const int base = blockIdx.x * kRPoints;
  const int cnt = min(kRPoints, n - base);
  const int kp = round_up(valid_k, kACols);
  const int nct = kp / kACols;
  const int dpw = round_up(d, kADepth);
  const int nfc = dpw / kADepth;
  const int dstep = round_up(d, Fmt<T>::kStep);
  const int steps = nct * nfc;
  const unsigned char* pw =
      planes + (c_per_worker ? (size_t)w * nct * nfc * cb : 0);
  const int sx = R::stride(d);
  unsigned char* ring = smem + R::x_bytes(d);

  if (tid == 0) {
    for (int q = 0; q < S; ++q) {
      mbar_init(&full[q], 1);
      done[q] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int q = 0; q < S && q < steps; ++q) {
      mbar_expect(&full[q], cb);
      bulk_copy(ring + q * cb, pw + (size_t)q * cb, cb, &full[q]);
    }
  }
  // the x tile: each warpgroup its 64 rows (none past cnt: zeros)
  {
    const int g = tid / kWG;
    const int cg = max(0, min(kTile, cnt - g * kTile));
    const T* xw = x + ((size_t)w * n + base + (cg ? g * kTile : 0)) * d;
    stage_x<T>(xw, cg, d, 0, dpw, sx, smem + (size_t)g * kTile * sx * 4,
               tid % kWG, vb, kTile, kWG);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();                        // x landed, the barriers ready

  const uint32_t* xr = reinterpret_cast<const uint32_t*>(smem);
  const float* c2w = c2 + (c_per_worker ? (size_t)w * kp : 0);
  const int rw0 = block_row() * sx;
  const int rw1 = rw0 + 8 * sx;
  Top2 top;
  top.reset();
  float xsq[2] = {0.f, 0.f};
  float acc[kACols / 2];
  for (int s = 0; s < steps; ++s) {
    const int ct = s / nfc;
    const int fc = s - ct * nfc;
    const int nsteps = min(kADepth, dstep - fc * kADepth) / Fmt<T>::kStep;
    const int w0 = fc * kADepth * Fmt<T>::kElem / 4;
    Frags<T> f;
    load_frags<T>(f, xr + rw0 + w0, xr + rw1 + w0, nsteps, ct == 0, xsq);
    if (fc == 0) init_chunk<kACols>(acc, c2w, ct * kACols);
    mbar_wait(&full[s % S], (s / S) & 1);
    issue_frags<T, kACols>(acc, f, nsteps, smem_u32(ring + (s % S) * cb),
                           Wide<T>::kCBytes, false);
    wgmma_wait(acc);
    __syncwarp();
    if ((tid & 31) == 0) {
      // this warp is done with slot s % S; the last asks for stage s + S
      const int q = s % S;
      __threadfence_block();
      if (atomicAdd(&done[q], 1) == kConsumers / 32 - 1) {
        done[q] = 0;
        if (s + S < steps) {
          __threadfence_block();
          mbar_expect(&full[q], cb);
          bulk_copy(ring + q * cb, pw + (size_t)(s + S) * cb, cb, &full[q]);
        }
      }
    }
    if (fc == nfc - 1)
      argmin_chunk<kACols>(acc, c2w, ct * kACols, valid_k, top);
  }
  write_assign<T>(asg, dist, (size_t)w * n + base, cnt, top, xsq,
                  reinterpret_cast<const T*>(xr + rw0),
                  reinterpret_cast<const T*>(xr + rw1),
                  c + (c_per_worker ? (size_t)w * k * d : 0), c2w, d);
}

// The counting sort, one 8-bit digit of the assignment a pass. The
// histogram of each 4096-point range: hist[w][range][digit].
__global__ void __launch_bounds__(kSortThreads)
kmeans_digit_count_kernel(const int* __restrict__ keys, int n, int shift,
                          int* __restrict__ hist, int ranges) {
  __shared__ int cnt[256];
  const int w = blockIdx.y;
  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  cnt[tid] = 0;
  __syncthreads();
  const int* kw = keys + (size_t)w * n;
  const int hi = min(n, (r + 1) * kSortPoints);
  for (int i = r * kSortPoints + tid; i < hi; i += kSortThreads)
    atomicAdd(&cnt[(kw[i] >> shift) & 255], 1);
  __syncthreads();
  hist[((size_t)w * ranges + r) * 256 + tid] = cnt[tid];
}

// In-place exclusive scan of data[0, len) by one block of kScanThreads:
// a thread a contiguous segment
__device__ void block_exclusive_scan(int* data, int len) {
  __shared__ int part[kScanThreads];
  const int tid = threadIdx.x;
  const int per = (len + kScanThreads - 1) / kScanThreads;
  const int lo = min(len, tid * per);
  const int hi = min(len, lo + per);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += data[i];
  part[tid] = s;
  __syncthreads();
  for (int off = 1; off < kScanThreads; off <<= 1) {
    const int v = tid >= off ? part[tid - off] : 0;
    __syncthreads();
    part[tid] += v;
    __syncthreads();
  }
  int run = tid ? part[tid - 1] : 0;
  for (int i = lo; i < hi; ++i) {
    const int v = data[i];
    data[i] = run;
    run += v;
  }
}

// The exclusive scan of worker blockIdx.x's histogram in digit-major
// order (all ranges of digit 0, then digit 1, ...): thread (q, digit) sums
// quarter q of the digit's ranges (a warp reads 32 digits of a range at
// once), a scan of the 256 digits' totals, then each thread writes its
// quarter's offsets
__global__ void __launch_bounds__(kScanThreads)
kmeans_digit_scan_kernel(int* __restrict__ hist, int ranges) {
  constexpr int kQ = kScanThreads / 256;
  __shared__ int part[kQ][256];
  __shared__ int tot[256];
  const int dig = threadIdx.x & 255;
  const int q = threadIdx.x >> 8;
  int* hw = hist + (size_t)blockIdx.x * ranges * 256 + dig;
  const int per = (ranges + kQ - 1) / kQ;
  const int lo = min(ranges, q * per);
  const int hi = min(ranges, lo + per);
  int s = 0;
#pragma unroll 8
  for (int r = lo; r < hi; ++r) s += hw[(size_t)r * 256];
  part[q][dig] = s;
  __syncthreads();
  if (q == 0) {
    int t = 0;
#pragma unroll
    for (int u = 0; u < kQ; ++u) t += part[u][dig];
    tot[dig] = t;
  }
  __syncthreads();
  for (int off = 1; off < 256; off <<= 1) {
    const int v = q == 0 && dig >= off ? tot[dig - off] : 0;
    __syncthreads();
    if (q == 0) tot[dig] += v;
    __syncthreads();
  }
  int run = dig ? tot[dig - 1] : 0;
  for (int u = 0; u < q; ++u) run += part[u][dig];
  for (int r = lo; r < hi; ++r) {
    const int v = hw[(size_t)r * 256];
    hw[(size_t)r * 256] = run;
    run += v;
  }
}

// The stable scatter of one pass: a range's points in order, a batch of
// 256 at a time; a point's place is its digit's offset for the range, the
// equal digits of earlier batches, of earlier warps of its batch and of
// earlier lanes of its warp. idx_in null: the points' own indices.
__global__ void __launch_bounds__(kSortThreads)
kmeans_digit_scatter_kernel(const int* __restrict__ keys_in,
                            const int* __restrict__ idx_in,
                            int* __restrict__ keys_out,
                            int* __restrict__ idx_out,
                            const int* __restrict__ offs, int n, int shift,
                            int ranges) {
  constexpr int kW = kSortThreads / 32;
  __shared__ int run[256];
  __shared__ int wcnt[kW][256];
  const int w = blockIdx.y;
  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  run[tid] = 0;
#pragma unroll
  for (int q = 0; q < kW; ++q) wcnt[q][tid] = 0;
  __syncthreads();
  const size_t wo = (size_t)w * n;
  for (int b = r * kSortPoints; b < min(n, (r + 1) * kSortPoints);
       b += kSortThreads) {
    const int i = b + tid;
    const bool valid = i < n;
    const int key = valid ? keys_in[wo + i] : 0;
    const int dig = valid ? (key >> shift) & 255 : 256;
    const unsigned peers = __match_any_sync(0xffffffffu, dig);
    const unsigned below = peers & ((1u << lane) - 1u);
    if (valid && below == 0) wcnt[warp][dig] = __popc(peers);
    __syncthreads();
    if (valid) {
      int at = offs[((size_t)w * ranges + r) * 256 + dig] + run[dig] +
               __popc(below);
      for (int q = 0; q < warp; ++q) at += wcnt[q][dig];
      keys_out[wo + at] = key;
      idx_out[wo + at] = idx_in ? idx_in[wo + i] : i;
    }
    __syncthreads();
    int add = 0;
#pragma unroll
    for (int q = 0; q < kW; ++q) {
      add += wcnt[q][tid];
      wcnt[q][tid] = 0;
    }
    run[tid] += add;
    __syncthreads();
  }
}

// starts[w][c]: the first sorted position of centroid c (c <= nk; starts[nk]
// = n), a thread a position
__global__ void kmeans_bounds_kernel(const int* __restrict__ keys, int n,
                                     int nk, int* __restrict__ starts) {
  const int w = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i > n) return;
  const int* kw = keys + (size_t)w * n;
  const int prev = i == 0 ? -1 : kw[i - 1];
  const int cur = i == n ? nk : kw[i];
  int* sw = starts + (size_t)w * (nk + 1);
  for (int c = prev + 1; c <= cur; ++c) sw[c] = i;
}

// pstart[w][c]: the first piece of centroid c (pstart[nk] = the pieces)
__global__ void __launch_bounds__(kScanThreads)
kmeans_pieces_kernel(const int* __restrict__ starts, int nk,
                     int* __restrict__ pstart) {
  const int* sw = starts + (size_t)blockIdx.x * (nk + 1);
  int* pw = pstart + (size_t)blockIdx.x * (nk + 1);
  for (int c = threadIdx.x; c <= nk; c += kScanThreads)
    pw[c] = c < nk ? (sw[c + 1] - sw[c] + kPiece - 1) / kPiece : 0;
  __syncthreads();
  block_exclusive_scan(pw, nk + 1);
}

// Piece b of worker w: up to 256 of one centroid's sorted points; a thread
// a column (D: the distance) sums them in point order into part (W,
// max_pieces, D+1)
template <typename T>
__global__ void __launch_bounds__(kPieceThreads)
kmeans_piece_sums_kernel(const T* __restrict__ x, const int* __restrict__ idx,
                         const float* __restrict__ dist,
                         const int* __restrict__ starts,
                         const int* __restrict__ pstart,
                         float* __restrict__ part, int n, int d, int nk,
                         int max_pieces) {
  __shared__ int pts[kPiece];
  const int w = blockIdx.y;
  const int b = blockIdx.x;
  const int* pw = pstart + (size_t)w * (nk + 1);
  if (b >= pw[nk]) return;
  int lo = 0, hi = nk;                    // pw[lo] <= b < pw[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (pw[mid] <= b)
      lo = mid;
    else
      hi = mid;
  }
  const int* sw = starts + (size_t)w * (nk + 1);
  const int p0 = sw[lo] + (b - pw[lo]) * kPiece;
  const int cnt = min(kPiece, sw[lo + 1] - p0);
  const size_t wo = (size_t)w * n;
  for (int i = threadIdx.x; i < cnt; i += kPieceThreads)
    pts[i] = idx[wo + p0 + i];
  __syncthreads();
  const T* xw = x + wo * d;
  const float* dw = dist + wo;
  float* out = part + ((size_t)w * max_pieces + b) * (d + 1);
  for (int col = threadIdx.x; col <= d; col += kPieceThreads) {
    float s = 0.f;
    int i = 0;
    for (; i + 8 <= cnt; i += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] = col < d ? to_float(xw[(size_t)pts[i + u] * d + col])
                       : dw[pts[i + u]];
#pragma unroll
      for (int u = 0; u < 8; ++u) s += v[u];
    }
    for (; i < cnt; ++i)
      s += col < d ? to_float(xw[(size_t)pts[i] * d + col]) : dw[pts[i]];
    out[col] = s;
  }
}

// Each centroid's pieces summed in order, a thread a (row, column); counts
// from the sorted runs; rows past nk zero
__global__ void __launch_bounds__(kReduceThreads)
kmeans_combine_kernel(const float* __restrict__ part,
                      const int* __restrict__ starts,
                      const int* __restrict__ pstart, float* __restrict__ sums,
                      float* __restrict__ counts, float* __restrict__ rowcost,
                      int d, int k, int nk, int max_pieces) {
  const int w = blockIdx.y;
  const int row = d + 1;
  const int i = blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= k * row) return;
  const int r = i / row;
  const int col = i - r * row;
  float s = 0.f;
  if (r < nk) {
    const int* pw = pstart + (size_t)w * (nk + 1);
    const float* src = part + (size_t)w * max_pieces * row + col;
    for (int b = pw[r]; b < pw[r + 1]; ++b) s += src[(size_t)b * row];
  }
  if (col < d) {
    sums[((size_t)w * k + r) * d + col] = s;
  } else {
    const int* sw = starts + (size_t)w * (nk + 1);
    counts[(size_t)w * k + r] = r < nk ? (float)(sw[r + 1] - sw[r]) : 0.f;
    rowcost[(size_t)w * k + r] = s;
  }
}

// Bytes a copy of x moves at once: the largest of 16, 8, 4 (and 2 for
// bf16) that divides a row's bytes and x's address
template <typename T>
int copy_bytes(const void* x, int d) {
  int vb = 16;
  while (vb > (int)sizeof(T) &&
         (((size_t)d * sizeof(T)) % vb || (uintptr_t)x % vb))
    vb >>= 1;
  return vb;
}

int piece_rows(int n, int k) { return (n + kPiece - 1) / kPiece + k; }
int sort_ranges(int n) { return (n + kSortPoints - 1) / kSortPoints; }

template <typename T>
int launch_wide(const void* x, const void* c, void* c2, void* planes,
                void* asg, void* dist, void* sort, void* hist, void* starts,
                void* pstart, void* part, void* rowcost, void* sums,
                void* counts, void* cost, int w, int n, int d, int k,
                int valid_k, int c_per_worker, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tables = c_per_worker ? w : 1;
  const int kp = round_up(valid_k, kACols);
  const int dpw = round_up(d, kADepth);
  const int rows = tables * kp;
  constexpr int kRowsABlock = kReduceThreads / 32;
  kmeans_prep_kernel<T><<<(rows + kRowsABlock - 1) / kRowsABlock,
                          kReduceThreads, 0, s>>>(
      static_cast<const float*>(c), static_cast<float*>(c2),
      static_cast<unsigned char*>(planes), k, d, valid_k, kp, dpw, tables);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int* a = static_cast<int*>(asg);
  if (n > 0) {
    // x stays in shared memory where the whole D sums in one accumulator
    const bool resident = d <= kFeatBlock;
    const auto kern = resident ? kmeans_assign_resident_kernel<T>
                               : kmeans_assign_kernel<T>;
    const int bytes = resident ? (int)Resident<T>::bytes(d) : Wide<T>::kBytes;
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return (int)err;
    const int points = resident ? kRPoints : kAPoints;
    kern<<<dim3((n + points - 1) / points, w),
           resident ? kRThreads : kAThreads, bytes, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(c),
        static_cast<const unsigned char*>(planes),
        static_cast<const float*>(c2), a, static_cast<float*>(dist), n, d,
        k, valid_k, c_per_worker, copy_bytes<T>(x, d));
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  // the sort: (keys, idx) ping-pong in sort (4, W, N)
  const size_t wn = (size_t)w * n;
  int* bufs = static_cast<int*>(sort);
  const int* keys = a;
  const int* idx = nullptr;
  const int ranges = sort_ranges(n);
  int* h = static_cast<int*>(hist);
  for (int shift = 0, out = 0; n > 0 && shift < 32 &&
                               (shift == 0 || ((valid_k - 1) >> shift) > 0);
       shift += 8, out ^= 1) {
    int* ko = bufs + 2 * out * wn;
    int* io = ko + wn;
    kmeans_digit_count_kernel<<<dim3(ranges, w), kSortThreads, 0, s>>>(
        keys, n, shift, h, ranges);
    kmeans_digit_scan_kernel<<<w, kScanThreads, 0, s>>>(h, ranges);
    kmeans_digit_scatter_kernel<<<dim3(ranges, w), kSortThreads, 0, s>>>(
        keys, idx, ko, io, h, n, shift, ranges);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    keys = ko;
    idx = io;
  }
  int* st = static_cast<int*>(starts);
  int* ps = static_cast<int*>(pstart);
  kmeans_bounds_kernel<<<dim3(n / 256 + 1, w), 256, 0, s>>>(keys, n, valid_k,
                                                             st);
  kmeans_pieces_kernel<<<w, kScanThreads, 0, s>>>(st, valid_k, ps);
  const int mp = piece_rows(n, k);
  kmeans_piece_sums_kernel<T><<<dim3(mp, w), kPieceThreads, 0, s>>>(
      static_cast<const T*>(x), idx, static_cast<const float*>(dist), st, ps,
      static_cast<float*>(part), n, d, valid_k, mp);
  const int nb = (k * (d + 1) + kReduceThreads - 1) / kReduceThreads;
  kmeans_combine_kernel<<<dim3(nb, w), kReduceThreads, 0, s>>>(
      static_cast<const float*>(part), st, ps, static_cast<float*>(sums),
      static_cast<float*>(counts), static_cast<float*>(rowcost), d, k,
      valid_k, mp);
  kmeans_cost_kernel<<<w, kReduceThreads, 0, s>>>(
      static_cast<const float*>(rowcost), static_cast<float*>(cost), k);
  return (int)cudaGetLastError();
}

template <typename T>
using StatsKernel = void (*)(const T*, const float*, float*, int, int, int,
                             int, int, int);

template <typename T>
StatsKernel<T> pick(int valid_k, int d) {
  if (carries(d))
    return chunk_cols(valid_k, d) == 32 ? kmeans_stats_kernel<T, 32, true>
                                        : kmeans_stats_kernel<T, 64, true>;
  switch (chunk_cols(valid_k, d)) {
    case 32: return kmeans_stats_kernel<T, 32, false>;
    case 64: return kmeans_stats_kernel<T, 64, false>;
    case 112: return kmeans_stats_kernel<T, 112, false>;
    default: return kmeans_stats_kernel<T, 128, false>;
  }
}

template <typename T>
cudaError_t prepare(StatsKernel<T> kern, int d, int k, size_t* bytes) {
  *bytes = Narrow<T>::bytes(d, k);
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*bytes);
}

template <typename T>
int grid_size(int n, int d, int k, int valid_k) {
  const StatsKernel<T> kern = pick<T>(valid_k, d);
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
int launch(const void* x, const void* c, void* ws, void* rowcost, void* sums,
           void* counts, void* cost, int w, int n, int d, int k, int valid_k,
           int c_per_worker, int grid_g, void* stream) {
  const StatsKernel<T> kern = pick<T>(valid_k, d);
  size_t bytes = 0;
  cudaError_t err = prepare<T>(kern, d, k, &bytes);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kern<<<dim3(grid_g, w), kThreads, bytes, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(c),
      static_cast<float*>(ws), n, d, k, valid_k, c_per_worker,
      copy_bytes<T>(x, d));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nb = (k * (d + 2) + kReduceThreads - 1) / kReduceThreads;
  kmeans_reduce_kernel<<<dim3(nb, w), kReduceThreads, 0, s>>>(
      static_cast<const float*>(ws), static_cast<float*>(sums),
      static_cast<float*>(counts), static_cast<float*>(rowcost), d, k,
      grid_g);
  kmeans_cost_kernel<<<w, kReduceThreads, 0, s>>>(
      static_cast<const float*>(rowcost), static_cast<float*>(cost), k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one narrow block needs for (d, k), float32
// points (bf16 points need less; the variant is chosen by this figure for
// both types).
long long kmeans_stats_smem_bytes(int d, int k) {
  return (long long)Narrow<float>::bytes(d, k);
}

// Blocks per worker: resident blocks per SM times the SM count, at most
// one per tile, whatever the number of workers a launch holds. Negative: a
// CUDA error code.
int kmeans_stats_grid(int n, int d, int k, int valid_k, int bf16) {
  return bf16 ? grid_size<__nv_bfloat16>(n, d, k, valid_k)
              : grid_size<float>(n, d, k, valid_k);
}

// Launch the E-step, its reduction and its cost on ``stream``, with the
// workspaces the host allocated: ws (W, grid_g, K, D+2), rowcost (W, K).
// Returns cudaGetLastError() after the launches (0 on success).
int kmeans_stats_launch(const void* x, const void* c, void* ws, void* rowcost,
                        void* sums, void* counts, void* cost, int w, int n,
                        int d, int k, int valid_k, int c_per_worker,
                        int grid_g, int bf16, void* stream) {
  return bf16 ? launch<__nv_bfloat16>(x, c, ws, rowcost, sums, counts, cost,
                                      w, n, d, k, valid_k, c_per_worker,
                                      grid_g, stream)
              : launch<float>(x, c, ws, rowcost, sums, counts, cost, w, n, d,
                              k, valid_k, c_per_worker, grid_g, stream);
}

// The wide variant's sort ranges a worker, at least 1 (the twin on the
// host side: pallas_kernels.kmeans_wide_plan).
int kmeans_stats_wide_grid(int n, int d, int k) {
  (void)d;
  (void)k;
  const int r = sort_ranges(n);
  return r < 1 ? 1 : r;
}

// Launch the wide variant on ``stream`` with the workspaces the host
// allocated (pallas_kernels.kmeans_wide_plan's shapes). Returns
// cudaGetLastError() after the launches.
int kmeans_stats_wide_launch(const void* x, const void* c, void* c2,
                             void* planes, void* asg, void* dist, void* sort,
                             void* hist, void* starts, void* pstart,
                             void* part, void* rowcost, void* sums,
                             void* counts, void* cost, int w, int n, int d,
                             int k, int valid_k, int c_per_worker, int bf16,
                             void* stream) {
  return bf16 ? launch_wide<__nv_bfloat16>(
                    x, c, c2, planes, asg, dist, sort, hist, starts, pstart,
                    part, rowcost, sums, counts, cost, w, n, d, k, valid_k,
                    c_per_worker, stream)
              : launch_wide<float>(x, c, c2, planes, asg, dist, sort, hist,
                                   starts, pstart, part, rowcost, sums, counts,
                                   cost, w, n, d, k, valid_k, c_per_worker,
                                   stream);
}

}  // extern "C"
