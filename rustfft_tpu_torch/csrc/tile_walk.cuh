// Pieces of the persistent tile walks (csrc/large.cu's K2 and K3,
// csrc/convlarge.cu's K15, csrc/large_gauss.cu's K4): asynchronous 16-byte
// copies into shared memory, the empty asm that keeps per-thread values
// inside a walk's loop, the phase stamps of the kernels' stamped forms, and
// the DFT forms of the radix-16 stages.
#pragma once

#include <stdint.h>

#include "fft_tile.cuh"
#include "gauss16.cuh"

namespace rf {

// The DFT form of the tile kernels' radix-16 stages (csrc/col_tile.cuh,
// csrc/row_tile.cuh), a template argument of each kernel: radix-2 register
// FFTs on the roots (kTileRoots: K2, K3 and the kernels on their bodies),
// or K4's Gauss form (kTileGauss: gauss_column with the DFT_16 tables as
// compile-time constants, csrc/gauss16.cuh, the direction read from the
// Gauss table the caller passes).  The constants took 0.51-0.55 and
// 0.71-0.72 ms at 64 x 2^20 in the column and row stages where the same
// kernels reading {Wr, Wi, Ws} from shared memory, one float4 broadcast a
// term, took 0.76-0.77 and 1.05-1.06 (tools/torch_ab.py K4; NVIDIA H100
// 80GB HBM3, 700 W).
enum TileForm { kTileRoots = 0, kTileGauss = 1 };

// float2 slots of shared memory the tables of `stages` radix-16 stages take
// in the form: 16 roots a stage, or none.
static __host__ __device__ constexpr int tile_table_slots(int form, int stages) {
  return form == kTileRoots ? 16 * stages : 0;
}

// The stages' tables into shared memory, as the form reads them.
template <int kForm>
static __device__ __forceinline__ void load_tile_tables(const Stages& st, float2* tables) {
  if constexpr (kForm == kTileRoots) load_roots(st, tables);
}

// The constants' direction: the sign of Wi(1) = Im w_16^(+-1) in stage 0's
// Gauss table (negative forward, positive inverse).
template <int kForm>
static __device__ __forceinline__ bool tile_inverse(const Stages& st) {
  if constexpr (kForm == kTileGauss) return __ldg(&st.gauss[0][16 + 1]) > 0.f;
  return false;
}

// DFT_16 of one column of the radix-16 stage `stage` in the form kForm,
// each output to sink(k, X[k]); `tables` as load_tile_tables left them.
// The constants' branch is the same for every thread of the launch.
template <int kForm, class Sink>
static __device__ __forceinline__ void tile_dft16(float2 (&v)[16], const float2* tables,
                                                  int stage, bool inverse, Sink sink) {
  if constexpr (kForm == kTileRoots) {
    dft_column<16>(v, tables + 16 * stage, sink);
  } else if (inverse) {
    gauss_column<16>(v, Gauss16<true>{}, sink);
  } else {
    gauss_column<16>(v, Gauss16<false>{}, sink);
  }
}

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
