// Pieces of the persistent tile walks (csrc/large.cu's K2 and K3,
// csrc/convlarge.cu's K15): asynchronous 16-byte copies into shared memory,
// the empty asm that keeps per-thread values inside a walk's loop, and the
// phase stamps of the kernels' stamped forms.
#pragma once

#include <stdint.h>

#include "fft_tile.cuh"

namespace rf {

// %globaltimer in nanoseconds (the kernels' phase stamps).
static __device__ __forceinline__ unsigned long long walk_timer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Phase stamps of a kernel's kStamp form (built only into the library
// compiled with RF_PHASE_STAMPS, which no route loads): per block, its start
// and that start plus the running sums of the time in each of its kPhases
// phases over the block's units, each lap read by thread 0 after a block
// barrier (tools/torch_phase_times.py).
template <bool kStamp, int kPhases>
struct PhaseClock {
  unsigned long long start = 0, mark = 0, sum[kPhases] = {};
  __device__ void begin() {
    if constexpr (kStamp) {
      __syncthreads();
      start = mark = walk_timer();
    }
  }
  __device__ void lap(int phase) {
    if constexpr (kStamp) {
      __syncthreads();
      const unsigned long long now = walk_timer();
      sum[phase] += now - mark;
      mark = now;
    }
  }
  __device__ void write(unsigned long long* stamps) const {
    if constexpr (kStamp) {
      if (threadIdx.x == 0) {
        unsigned long long* out = stamps + (size_t)blockIdx.x * (kPhases + 1);
        out[0] = start;
        for (int i = 0; i < kPhases; ++i) out[i + 1] = out[i] + sum[i];
      }
    }
  }
};

static __device__ __forceinline__ void cp_async16(float2* dst, const float2* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// An 8-byte copy (a row that is only 8-byte aligned).
static __device__ __forceinline__ void cp_async8(float2* dst, const float2* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}

static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's latest cp.async groups are pending.
template <int N>
static __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v through an empty asm, anew in each unit of a persistent walk: the
// column index a stage's addresses come from (so that the swizzled shared
// memory addresses, which depend only on the thread, are computed in the
// unit instead of being hoisted out of the walk and held: ptxas spilled
// 236-552 bytes of them) and the twiddle tables (whose loop-invariant __ldg
// reads would be hoisted the same way).
static __device__ __forceinline__ int opaque_int(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

template <typename P>
static __device__ __forceinline__ P opaque_ptr(P p) {
  asm volatile("" : "+l"(p));
  return p;
}

// The blocks of `kernel` the card holds at once: its SMs times the blocks an
// SM holds.
template <typename K>
static cudaError_t resident_blocks(K kernel, int threads, size_t smem, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  *out = sms * per_sm;
  return err;
}

}  // namespace rf
