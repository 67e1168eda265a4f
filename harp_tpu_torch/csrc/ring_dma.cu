// Ring-DMA kernels for Hopper (sm_90a): the whole-payload ring hop and the
// ring allgather relay, between the workers of a stacked group and between
// the processes of a process group on one card.
//
// Replaces: harp_tpu/ops/ring_dma.py::hop (kernel _hop_kernel, pallas_call
// at ring_dma.py:242) and ::ring_allgather (kernel _allgather_kernel,
// pallas_call at ring_dma.py:320). Both compute what those compute, bitwise
// for any dtype: hop(x, s) gives every worker the block of worker
// (id - s) mod W; ring_allgather gives every process all W blocks in worker
// order. The engine moves bytes and never rounds them.
//
// Design. A process holds W_local workers as rows of one tensor. One launch
// covers all of them, grid (blocks a row, rows), 16-byte copies over a
// grid-stride loop (ring_dma.cuh copy_share).
//   * Stacked group (one process): every neighbour is in this launch, so a
//     hop is one copy x[r] -> out[(r + s) mod W]; stream order plays the
//     credit's role and the handshake is skipped (barrier=False on the TPU).
//     Its kernels (ring_hop_stacked_kernel, ring_allgather_stacked_kernel)
//     take no plan: a call moves a few MiB in a few us, so the host's launch
//     path sets the pace of calls made back to back, and the stacked entries
//     (ring_dma_hop_stacked, ring_dma_allgather_stacked) keep it short: seven
//     or five arguments, all pointer-sized (ctypes passes an int as a
//     c_void_p without building an object for it), the grid sized here
//     (ring_dma_grid), a parameter block of 32 bytes or less.
//   * Process group: a neighbour in this process is copied straight into
//     `out`; a neighbour in another process is reached through the CUDA IPC
//     mapping of its workspace (ops/ring_dma.py). For that edge the kernel
//     runs the TPU kernel's steps: (1) give the sender its credit, (2) wait
//     for the own credit of this call (the receiver has entered the call, so
//     its receive slot is free), (3) copy into the receiver's slot, (4) fence
//     and release-add the receiver's arrival counter once a block, (5) wait
//     until every block of the own sender has arrived, then copy the own slot
//     into `out`. Counters of the edges inside the process move too, so every
//     counter gains the same count each call, and no block waits for
//     anything another block of its own launch produces.
//   * Receive (ring_recv_kernel): the second half of an in-kernel send made
//     by another kernel (the dense-MF hop's H tile, flash attention's k and
//     v: dense_mf_hop.cu, flash_attention.cu). The sending kernel gives its
//     credits and stores into its receiver's slot and signals; this kernel,
//     launched after it in stream order, waits until every block of the own
//     sender has arrived and copies the slot into the output. Rows whose
//     sender is in this process were written by the sending launch itself
//     and are skipped. The dense-MF hop's grid is not capped, so its blocks
//     never spin: a tile whose receiver's credit was not in yet when its
//     block ended is left in h_out, and this kernel first waits for that
//     credit and sends the left tiles, one arrival each. The wait for the
//     sender is kept out of the sending launch: a block spinning there could
//     hold the SM that a block of its own launch, one that has not sent yet,
//     needs, while the sender's launch is in the same state.
//   * Allgather: the TPU relay between processes. A process's W_local blocks
//     are one contiguous chunk; step t forwards chunk (p - t) mod P to the
//     right process's same slot and waits on the arrivals of step t, each
//     step with its own counter in the place of the TPU's receive semaphore
//     for each hop. Chunk p goes from x, the others from the own slots.
// The grid of a launch is at most its share of the blocks the card holds at
// once (ring_dma_grid): the resident count over the launch's rows and over
// the processes sharing the card. So no block waits on a block of its own
// launch that cannot be resident, and where the processes' launches run at
// once (under MPS) every process's blocks fit beside its peers' while they
// spin. Without MPS the processes' contexts take turns on the card. The
// sends made from inside other kernels keep to this: the dense-MF hop's
// blocks never spin, and the only blocks of a flash attention launch that
// spin are its copy blocks, at most 16 a row.
//
// What bounds it on this card: bytes. A hop reads the payload once and
// writes it once; at the SGD-MF flagship's H block (32 x 8192 f32, 1 MiB a
// worker, W = 4) that is 8 MiB over 3.35 TB/s = 2.5 us. Between processes
// the payload also passes through the receive slot, a second read and write
// of each block (the extra local copy, the first lever for later work: a
// receiver that computes from its slot, or a slot that is the output); the
// allgather writes each process chunk to the slots and then to `out`.
// Without MPS the processes' kernels time-slice the card and never run at
// once, so a hop between processes waits for context switches.
//
// The host binding is a plain C interface loaded with ctypes
// (harp_tpu_torch/ops/_cuda_build.py, ops/ring_dma.py).

#include <string.h>

#include "ring_dma.cuh"

namespace {

using namespace ring_dma;

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) ring_hop_kernel(
    const char* __restrict__ x, char* __restrict__ out, long long bytes,
    int nrows, int base, int nworkers, int shift, HopPlan plan,
    unsigned long long ready_target, unsigned long long arrive_target,
    unsigned* err, unsigned cid) {
  const int r = blockIdx.y;
  const int g = base + r;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * kThreads;
  const char* src = x + (long long)r * bytes;
  const int d = ring_neighbor(g, nworkers, shift) - base;
  const int from = ring_mod((long long)g - shift, nworkers) - base;
  give_credit(plan.credit_to[r]);
  char* dst;
  if (d >= 0 && d < nrows) {
    dst = out + (long long)d * bytes;
  } else {
    if (!block_wait(plan.my_ready[r], ready_target, err,
                    kErrReady * 1000 + cid))
      return;
    dst = plan.remote_dst[r];
  }
  copy_share(dst, src, bytes, tid, nthreads);
  signal_arrival(plan.arrive_to[r]);
  if (from < 0 || from >= nrows) {
    if (!block_wait(plan.my_arrive[r], arrive_target, err,
                    kErrArrive * 1000 + cid))
      return;
    copy_share(out + (long long)r * bytes, plan.my_slot[r], bytes, tid,
               nthreads);
  }
}

// The hop of a stacked group: row r's block to row (r + shift) mod nrows.
__global__ void __launch_bounds__(kThreads) ring_hop_stacked_kernel(
    const char* __restrict__ x, char* __restrict__ out, long long bytes,
    int nrows, int shift) {
  const int r = blockIdx.y;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * kThreads;
  copy_share(out + (long long)ring_neighbor(r, nrows, shift) * bytes,
             x + (long long)r * bytes, bytes, tid, nthreads);
}

// The allgather of a stacked group: its rows are every worker, in order.
__global__ void __launch_bounds__(kThreads) ring_allgather_stacked_kernel(
    const char* __restrict__ x, char* __restrict__ out, long long bytes) {
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  copy_share(out, x, bytes, tid, (long long)gridDim.x * kThreads);
}

__global__ void __launch_bounds__(kThreads) ring_allgather_kernel(
    const char* __restrict__ x, char* __restrict__ out, long long chunk,
    long long stride, int nproc, int proc, AgPlan plan,
    unsigned long long ready_target, unsigned long long ag_target,
    unsigned* err, unsigned cid) {
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * kThreads;
  give_credit(plan.credit_to);
  if (!block_wait(plan.my_ready, ready_target, err, kErrReady * 1000 + cid))
    return;
  for (int t = 0; t < nproc - 1; ++t) {
    const int q = ring_mod((long long)proc - t, nproc);
    const char* src = t == 0 ? x : plan.my_region + q * stride;
    copy_share(plan.right_region + q * stride, src, chunk, tid, nthreads);
    signal_arrival(plan.right_arrive + t);
    if (!block_wait(plan.my_arrive + t, ag_target, err,
                    kErrArrive * 1000 + cid))
      return;
  }
  for (int q = 0; q < nproc; ++q) {
    const char* src = q == proc ? x : plan.my_region + q * stride;
    copy_share(out + q * chunk, src, chunk, tid, nthreads);
  }
}

// The receive of an in-kernel send (see the header; shift 1, as the TPU
// kernels' ring_hop). First, where `sent` is set, for every row whose
// receiver is in another process: wait for the row's credit, then send each
// tile (`tile_bytes` of the row's `bytes0` in `left`) that the sending launch
// left (sent 0), one block and one arrival a tile. Then, for every row
// whose sender is in another process: wait for the sender's blocks and copy
// the row's slot (one payload at offset 0 and, where dst1 is set, a second
// at off1) into dst0 / dst1 at row r.
__global__ void __launch_bounds__(kThreads) ring_recv_kernel(
    int nrows, int base, int nworkers, HopPlan plan, char* dst0,
    long long bytes0, char* dst1, long long bytes1, long long off1,
    const char* left, const int* sent, int tiles, long long tile_bytes,
    unsigned long long ready_target, unsigned long long arrive_target,
    unsigned* err, unsigned cid) {
  const int r = blockIdx.y;
  const int to = ring_neighbor(base + r, nworkers, 1) - base;
  if (sent != nullptr && (to < 0 || to >= nrows)) {
    bool credited = false;
    for (int i = blockIdx.x; i < tiles; i += gridDim.x) {
      if (sent[(long long)r * tiles + i]) continue;
      if (!credited && !block_wait(plan.my_ready[r], ready_target, err,
                                   kErrReady * 1000 + cid))
        return;
      credited = true;
      const long long o = i * tile_bytes;
      const long long n = bytes0 - o < tile_bytes ? bytes0 - o : tile_bytes;
      copy_share(plan.remote_dst[r] + o, left + (long long)r * bytes0 + o, n,
                 threadIdx.x, kThreads);
      signal_arrival(plan.arrive_to[r]);
    }
  }
  const int from = ring_mod((long long)base + r - 1, nworkers) - base;
  if (from >= 0 && from < nrows) return;
  if (!block_wait(plan.my_arrive[r], arrive_target, err,
                  kErrArrive * 1000 + cid))
    return;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * kThreads;
  copy_share(dst0 + (long long)r * bytes0, plan.my_slot[r], bytes0, tid,
             nthreads);
  if (dst1 != nullptr)
    copy_share(dst1 + (long long)r * bytes1, plan.my_slot[r] + off1, bytes1,
               tid, nthreads);
}

int g_resident[64];   // resident blocks of the launch, per device (0 = unknown)

// Launch on `device`, whatever device is current on this thread (PyTorch
// may have another one current), and put the current one back: one
// cudaGetDevice a call, a cudaSetDevice each way only when they differ.
// Returns the launch's cudaGetLastError().
template <class Launch>
int on_device(int device, Launch launch) {
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e == cudaSuccess && prev != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  launch();
  e = cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return (int)e;
}

}  // namespace

extern "C" {

// Blocks a row for a payload of `bytes` over `rows` rows of each of the
// `sharers` processes on the card: enough for one 16-byte load a thread, at
// most what is resident at once over all rows of all sharers. The same on
// every process of a group on the same card model, which the arrival counts
// rely on. Returns the count, or -cudaError.
int ring_dma_grid(int device, long long bytes, int rows, int sharers) {
  if (device < 0 || device >= 64 || rows < 1 || sharers < 1) return -1;
  if (g_resident[device] == 0) {
    int sms = 0, hop = 0, ag = 0, recv = 0;
    cudaError_t e = cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&hop, ring_hop_kernel,
                                                        kThreads, 0);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &ag, ring_allgather_kernel, kThreads, 0);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &recv, ring_recv_kernel, kThreads, 0);
    if (e != cudaSuccess) return -(int)e;
    if (ag < hop) hop = ag;
    g_resident[device] = sms * (recv < hop ? recv : hop);
  }
  long long want = (bytes + kThreads * 16 - 1) / (kThreads * 16);
  long long cap = g_resident[device] / ((long long)rows * sharers);
  if (cap < 1) cap = 1;
  if (want > cap) want = cap;
  return (int)(want < 1 ? 1 : want);
}

// One workspace region: header of counters (zeroed) + `bytes` of data.
// Writes its base and its IPC handle (64 bytes).
int ring_dma_alloc(int device, long long bytes, void** base, void* handle) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cudaMalloc(base, kHeaderBytes + bytes);
  if (e == cudaSuccess) e = cudaMemset(*base, 0, kHeaderBytes);
  // zeroed before any peer, which may run first, can signal into it
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), *base);
  return (int)e;
}

int ring_dma_open(int device, const void* handle, void** base) {
  cudaError_t e = cudaSetDevice(device);
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  if (e == cudaSuccess)
    e = cudaIpcOpenMemHandle(base, h, cudaIpcMemLazyEnablePeerAccess);
  return (int)e;
}

int ring_dma_close(int device, void* base) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cudaIpcCloseMemHandle(base);
  return (int)e;
}

int ring_dma_free(int device, void* base) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cudaFree(base);
  return (int)e;
}

// Copy the counters of an old region into a new one (the workspace grows
// while every process is idle, so the counts carry on).
int ring_dma_copy_header(int device, void* dst, const void* src) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess)
    e = cudaMemcpy(dst, src, kHeaderBytes, cudaMemcpyDeviceToDevice);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return (int)e;
}

int ring_dma_header_bytes() { return (int)kHeaderBytes; }
int ring_dma_counters_per_id() { return kCountersPerId; }
int ring_dma_max_rows() { return kMaxRows; }
int ring_dma_max_steps() { return kMaxSteps; }
int ring_dma_plan_bytes() { return (int)sizeof(HopPlan); }

// A zeroed word of host memory mapped into the device (the error word).
int ring_dma_error_word(int device, void** host, void** dev) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cudaHostAlloc(host, 16, cudaHostAllocMapped);
  if (e == cudaSuccess) {
    memset(*host, 0, 16);
    e = cudaHostGetDevicePointer(dev, *host, 0);
  }
  return (int)e;
}

int ring_dma_free_error_word(int device, void* host) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cudaFreeHost(host);
  return (int)e;
}

// One hop of a stacked group's `nrows` rows of `bytes` each, x -> out, on
// `stream` of `device`. Returns cudaGetLastError().
int ring_dma_hop_stacked(const void* x, void* out, long long bytes,
                         long long nrows, long long shift, long long device,
                         void* stream) {
  const int rows = (int)nrows, dev = (int)device;
  const int grid = ring_dma_grid(dev, bytes, rows, 1);
  if (grid < 1) return -grid;
  return on_device(dev, [&] {
    ring_hop_stacked_kernel<<<dim3(grid, rows), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const char*>(x), static_cast<char*>(out), bytes, rows,
        (int)shift);
  });
}

// The allgather of a stacked group: its `bytes` of x into out, on `stream`
// of `device`. Returns cudaGetLastError().
int ring_dma_allgather_stacked(const void* x, void* out, long long bytes,
                               long long device, void* stream) {
  const int dev = (int)device;
  const int grid = ring_dma_grid(dev, bytes, 1, 1);
  if (grid < 1) return -grid;
  return on_device(dev, [&] {
    ring_allgather_stacked_kernel<<<grid, kThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const char*>(x), static_cast<char*>(out), bytes);
  });
}

// One hop of a process group's `nrows` rows of `bytes` each, x -> out, on
// `stream` of `device`, with its `plan`. Returns cudaGetLastError().
int ring_dma_hop_launch(const void* x, void* out, long long bytes,
                        int nrows, int base, int nworkers,
                        int shift, int grid, const void* plan,
                        unsigned long long ready_target,
                        unsigned long long arrive_target, void* err, int cid,
                        int device, void* stream) {
  HopPlan p{};
  memcpy(&p, plan, sizeof(p));
  return on_device(device, [&] {
    ring_hop_kernel<<<dim3(grid, nrows), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const char*>(x), static_cast<char*>(out), bytes, nrows,
        base, nworkers, shift, p, ready_target, arrive_target,
        static_cast<unsigned*>(err), (unsigned)cid);
  });
}

// The receive of an in-kernel send (ring_recv_kernel) for `nrows` rows on
// `stream` of `device`: `plan` is the sending call's plan; `sent` null, or
// the tiles the sending launch sent (nrows, tiles) and `left` the rows they
// were left in. Returns cudaGetLastError().
int ring_dma_recv_launch(int nrows, int base, int nworkers, int grid,
                         const void* plan, void* dst0,
                         long long bytes0, void* dst1, long long bytes1,
                         long long off1, const void* left, const void* sent,
                         int tiles, long long tile_bytes,
                         unsigned long long ready_target,
                         unsigned long long arrive_target, void* err, int cid,
                         int device, void* stream) {
  HopPlan p{};
  memcpy(&p, plan, sizeof(p));
  return on_device(device, [&] {
    ring_recv_kernel<<<dim3(grid, nrows), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        nrows, base, nworkers, p, static_cast<char*>(dst0), bytes0,
        static_cast<char*>(dst1), bytes1, off1,
        static_cast<const char*>(left), static_cast<const int*>(sent), tiles,
        tile_bytes, ready_target, arrive_target, static_cast<unsigned*>(err),
        (unsigned)cid);
  });
}

// One allgather of this process's chunk (`chunk` bytes) into out (nproc > 1
// chunks), on `stream` of `device`, with the process group's `plan`.
// Returns cudaGetLastError().
int ring_dma_allgather_launch(const void* x, void* out, long long chunk,
                              long long stride, int nproc, int proc, int grid,
                              const void* plan,
                              unsigned long long ready_target,
                              unsigned long long ag_target, void* err, int cid,
                              int device, void* stream) {
  AgPlan p{};
  memcpy(&p, plan, sizeof(p));
  return on_device(device, [&] {
    ring_allgather_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const char*>(x), static_cast<char*>(out), chunk, stride,
        nproc, proc, p, ready_target, ag_target, static_cast<unsigned*>(err),
        (unsigned)cid);
  });
}

}  // extern "C"
