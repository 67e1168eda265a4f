// Device-side ring engine shared by the ring kernels of the port: the ring
// math, the credit-exact receiver-ready handshake and the block copy with its
// arrival signal.
//
// Replaces: the kernel-side helpers of harp_tpu/ops/ring_dma.py
// (ring_neighbor, ring_ready, hop_op and start_hop). On the TPU a worker is
// a chip, the copy is an in-kernel remote DMA and the handshake uses the
// barrier semaphore. Here a worker is a row of a process's stacked group;
// workers of one process share a launch, and a worker in another process is
// reached through a CUDA IPC mapping of that process's workspace
// (harp_tpu_torch/ops/ring_dma.py). The remote DMA becomes stores by the
// launch's threads into the mapped buffer, and each semaphore becomes a 64-bit
// counter in device memory that only grows: a signal is a system-scope
// release add, a wait a system-scope acquire spin until the counter reaches
// the count the host expects after this call. Counters are never reset, so a
// wait can never be satisfied by a signal of an earlier call.
//
// Every spin is bounded by the global timer (kSpinTimeoutNs). On timeout the
// block writes an error code to a word of host-mapped memory and leaves; a
// block that finds the word already set leaves too. ring_dma.check_errors()
// reads the word after a device sync and raises. A hung peer therefore fails
// the run instead of hanging it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ring_dma {

constexpr int kMaxRows = 8;        // workers a process holds in a process group
constexpr int kMaxSteps = 32;      // allgather relay steps (processes - 1)
constexpr int kMaxIds = 256;       // collective ids (ops/ring_dma.py)
// per collective id: ready[kMaxRows], arrive[kMaxRows], ag_arrive[kMaxSteps]
constexpr int kCountersPerId = 2 * kMaxRows + kMaxSteps;
constexpr long long kHeaderBytes = 131072;   // >= kMaxIds * kCountersPerId * 8
constexpr unsigned long long kSpinTimeoutNs = 10ull * 1000 * 1000 * 1000;

// error codes written to the error word (code * 1000 + collective id)
constexpr unsigned kErrReady = 1;    // the receiver never entered (credit)
constexpr unsigned kErrArrive = 2;   // the sender's payload never arrived

// Pointers of one hop call, per local row r (a worker of this process).
// For a partner in the same process a counter pointer is local memory; the
// kernel only waits on a partner in another process.
struct HopPlan {
  unsigned long long* credit_to[kMaxRows];  // ready counter of r's sender
  unsigned long long* arrive_to[kMaxRows];  // arrival counter of r's receiver
  unsigned long long* my_ready[kMaxRows];
  unsigned long long* my_arrive[kMaxRows];
  char* remote_dst[kMaxRows];               // r's receiver's receive slot
  const char* my_slot[kMaxRows];            // r's own receive slot
};

// Pointers of one allgather call: the relay runs between processes, each
// forwarding one process's chunk (its W_local blocks) a step.
struct AgPlan {
  char* my_region;
  char* right_region;
  unsigned long long* credit_to;     // ready counter of the left process
  unsigned long long* my_ready;
  unsigned long long* right_arrive;  // right process's per-step arrivals
  unsigned long long* my_arrive;     // this process's per-step arrivals
};

__device__ __forceinline__ int ring_mod(long long a, int n) {
  long long m = a % n;
  return (int)(m < 0 ? m + n : m);
}

// (destination, source) of worker `my` for a hop of `shift`: the block goes
// to (my + shift) mod W and comes from (my - shift) mod W.
__device__ __forceinline__ int ring_neighbor(int my, int nworkers, int shift) {
  return ring_mod((long long)my + shift, nworkers);
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void release_add(unsigned long long* p,
                                            unsigned long long v) {
  asm volatile("red.release.sys.global.add.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long acquire_load(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void raise_error(unsigned* err, unsigned code) {
  *reinterpret_cast<volatile unsigned*>(err) = code;
  __threadfence_system();
}

// Thread 0 spins until *p >= target; the whole block learns whether it got
// there (a barrier that ANDs thread 0's answer with the others' 1, so the
// function needs no shared memory of its own). Call from every thread of
// the block.
__device__ bool block_wait(const unsigned long long* p,
                           unsigned long long target, unsigned* err,
                           unsigned code) {
  int ok = 1;
  if (threadIdx.x == 0) {
    const unsigned long long t0 = global_ns();
    for (unsigned spin = 0; acquire_load(p) < target; ++spin) {
      if ((spin & 1023u) == 1023u) {
        if (*reinterpret_cast<volatile unsigned*>(err) != 0) {
          ok = 0;
          break;
        }
        if (global_ns() - t0 > kSpinTimeoutNs) {
          raise_error(err, code);
          ok = 0;
          break;
        }
      }
      __nanosleep(64);
    }
    __threadfence();
  }
  return __syncthreads_and(ok) != 0;
}

// ring_ready: the credit-exact receiver-ready handshake. One thread of the
// launch gives this worker's sender its credit ("my buffer is live"), then
// every block that sends to another process waits until its own credits
// reach this call's count: exactly one credit is produced and one consumed a
// call, so a fast worker blocks at call e + 1 until its receiver has entered
// call e + 1.
__device__ __forceinline__ void give_credit(unsigned long long* credit_to) {
  if (blockIdx.x == 0 && threadIdx.x == 0) release_add(credit_to, 1);
}

// The same for a kernel that computes and then sends from each of its
// `nrows` rows (the in-kernel sends of dense_mf_hop.cu and
// flash_attention.cu): thread r of the launch's first block gives row r's
// sender its credit before that block does anything else. The first block
// is the first one issued, so no credit waits for a block of the launch to
// be scheduled behind others.
__device__ __forceinline__ void give_credits(const HopPlan& plan, int nrows) {
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x < nrows)
    release_add(plan.credit_to[threadIdx.x], 1);
}

// This block's share of a copy of n bytes, over the threads of every block
// of the row (thread `tid` of `nthreads`): 16 bytes a thread where source and
// destination agree modulo 16 (a head and a tail of single bytes around the
// aligned middle), byte by byte where they do not. Loads bypass L1 (.cg): a
// receive slot is written by another process's launch.
__device__ void copy_share(char* dst, const char* src, long long n,
                           long long tid, long long nthreads) {
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const uintptr_t d = reinterpret_cast<uintptr_t>(dst);
  if (((s ^ d) & 15u) == 0) {
    long long head = (long long)((16u - (s & 15u)) & 15u);
    if (head > n) head = n;
    if (tid < head) dst[tid] = __ldcg(src + tid);
    const long long vec = (n - head) >> 4;
    const uint4* vs = reinterpret_cast<const uint4*>(src + head);
    uint4* vd = reinterpret_cast<uint4*>(dst + head);
    for (long long i = tid; i < vec; i += nthreads) vd[i] = __ldcg(vs + i);
    const long long tail0 = head + (vec << 4);
    if (tid < n - tail0) dst[tail0 + tid] = __ldcg(src + tail0 + tid);
  } else {
    for (long long i = tid; i < n; i += nthreads) dst[i] = __ldcg(src + i);
  }
}

// hop_op/start_hop's completion: make this block's stores visible to the
// whole system, then one release add on the receiver's arrival counter.
// Call from every thread of the block.
__device__ __forceinline__ void signal_arrival(unsigned long long* arrive_to) {
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) release_add(arrive_to, 1);
}

}  // namespace ring_dma
