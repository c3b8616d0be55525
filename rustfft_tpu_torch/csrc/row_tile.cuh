// K3's persistent row-tile kernel (Q = 4096 = 16 x 16 x 16 over 4 columns,
// a (4096, 4) tile of 128 KiB in place, one block an SM, 512 threads of two
// columns each): csrc/large.cu runs it on plain rows (K3, and K10's and
// K11's Q passes), csrc/large_gauss.cu with its three radix-16 stages in the
// Gauss form (K4's row stage, kForm = kTileGauss: tile_walk.cuh tile_dft16;
// everything else as K3).  The design is large.cu's header's (K3).
#pragma once

#include <stdint.h>

#include "large.cuh"
#include "tile_walk.cuh"

namespace rf {

// Phase stamps of K2's and K3's tile kernels (their kStamp forms;
// ops/kernels/large.py COL_PHASES, ROW_PHASES).
constexpr int kLargePhases = 3;

template <bool kStamp>
using LargeClock = PhaseClock<kStamp, kLargePhases>;

// ---- K3 at Q = 4096 ---------------------------------------------------------

constexpr int kRowT = 4;
constexpr int kRowQ = 4096;
constexpr int kRowElems = kRowQ * kRowT;
constexpr int kRowCols = kRowElems / 16;  // the columns of a radix-16 stage
// Two columns a thread: at 1024 threads (one a column) the 64 registers a
// thread may hold cover a column's 16 values and little else (ptxas, sm_90a:
// 276 bytes of spill; 0.90-0.93 ms at 64 x 2^20 against 0.58-0.61 at 512
// threads, 128 registers and no spill, on an H100 80GB HBM3 at 700 W).
constexpr int kRowThreads = 512;
constexpr int kRowPer = kRowCols / kRowThreads;

// This thread's copies of the (4096, 4) window at src into buf in plain
// order, one group: for each of its stage-0 columns col = c + 512*i, the
// rows col/4 + 256*j, j = 8*(c & 1) .. + 7, columns (c & 2) and (c & 2) + 1,
// the rows that column reads.  `at` is the first copy's offset, (c/4 +
// 2048*(c & 1))*P + (c & 2), and `step` 256*P (every offset of a (4096, P)
// row, below 4096*P, fits 32 bits: P <= 32768, K11's P1*P2 at 2^27).
static __device__ __forceinline__ void row_tile_copy(float2* buf, const float2* __restrict__ src,
                                                     unsigned at, unsigned step) {
  const int c = opaque_int(threadIdx.x);
  float2* dst = buf + ((c >> 2) + 2048 * (c & 1)) * kRowT + (c & 2);
#pragma unroll
  for (int i = 0; i < kRowPer; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      cp_async16(dst + kRowThreads * i + 1024 * j,
                 src + at + i * (kRowThreads / 4) * (step / 256) + j * step);
  }
  cp_async_commit();
}

// The Gauss forms' stages 1 and 2 hold one column at a time: a thread
// reads its column c into v and stashes its columns c + 512*i, i >= 1, in
// its own slots of `side` (kRowSide values past the tile and tables, side[c
// + 512*(16*(i - 1) + j)]), so that the values of one column, its sums and
// the DFT's accumulators fit 128 registers; base(col) is the stage's first
// element of column col, `stride` its digit's.
constexpr int kRowSide = (kRowPer - 1) * 16 * kRowThreads;

template <class Base>
static __device__ __forceinline__ void row_gauss_read(float2 (&v)[16], const float2* buf,
                                                      float2* side, int c, Base base,
                                                      int stride) {
#pragma unroll
  for (int j = 0; j < 16; ++j) v[j] = buf[swz(base(c) + stride * j)];
#pragma unroll
  for (int i = 1; i < kRowPer; ++i) {
    const int b = base(c + kRowThreads * i);
#pragma unroll
    for (int j = 0; j < 16; ++j)
      side[c + kRowThreads * (16 * (i - 1) + j)] = buf[swz(b + stride * j)];
  }
}

static __device__ __forceinline__ void row_gauss_unstash(float2 (&v)[16], const float2* side,
                                                         int c, int i) {
#pragma unroll
  for (int j = 0; j < 16; ++j) v[j] = side[c + kRowThreads * (16 * (i - 1) + j)];
}

template <bool kStamp, int kForm = kTileRoots>
__global__ void __launch_bounds__(kRowThreads, 1)
    row_tile_kernel(const float2* __restrict__ x, float2* __restrict__ y, unsigned tiles, int p,
                    Stages st, unsigned long long* stamps) {
  LargeClock<kStamp> clock;
  clock.begin();
  extern __shared__ float4 row_smem[];
  float2* buf = reinterpret_cast<float2*>(row_smem);
  float2* sroots = buf + kRowElems;
  float2* side = sroots + tile_table_slots(kForm, 3);  // the Gauss forms' columns i >= 1
  const unsigned per_row = (unsigned)p / kRowT;
  const size_t row_elems = (size_t)kRowQ * (size_t)p;
  const unsigned step = 256u * (unsigned)p;
  unsigned u = blockIdx.x;
  if (u < tiles) {
    const int c = threadIdx.x;
    row_tile_copy(buf, x + (size_t)(u / per_row) * row_elems + (u % per_row) * kRowT,
                  (unsigned)((c >> 2) + 2048 * (c & 1)) * (unsigned)p + (c & 2), step);
  }
  load_tile_tables<kForm>(st, sroots);
  const bool inverse = tile_inverse<kForm>(st);
  __syncthreads();
  for (; u < tiles; u += gridDim.x) {
    const int c = opaque_int(threadIdx.x);
    // stage 0, radix 16 over the top digit of columns c + 512*i, in place:
    // the groups of 16 a warp reads and writes are its own
    if constexpr (kForm == kTileRoots) {
      cp_async_wait<0>();
      __syncwarp();
      float2 v[kRowPer][16];
#pragma unroll
      for (int i = 0; i < kRowPer; ++i) {
#pragma unroll
        for (int j = 0; j < 16; ++j) v[i][j] = buf[c + kRowThreads * i + 1024 * j];
      }
      __syncwarp();
      const float2* __restrict__ tw = opaque_ptr(st.tw[0]);
#pragma unroll
      for (int i = 0; i < kRowPer; ++i) {
        const int col = c + kRowThreads * i;
        tile_dft16<kForm>(v[i], sroots, 0, inverse, [&](int k, float2 z) {
          z = cmul(z, __ldg(&tw[k * 256 + (col >> 2)]));
          buf[swz(k * 1024 + col)] = z;
        });
      }
    } else {
      // the Gauss forms one column after the other: column c + 512*i's
      // groups of 16 are its warp's and no other i's
      cp_async_wait<0>();
      const float2* __restrict__ tw = opaque_ptr(st.tw[0]);
#pragma unroll
      for (int i = 0; i < kRowPer; ++i) {
        const int col = c + kRowThreads * i;
        float2 v[16];
        __syncwarp();
#pragma unroll
        for (int j = 0; j < 16; ++j) v[j] = buf[col + 1024 * j];
        __syncwarp();
        tile_dft16<kForm>(v, sroots, 0, inverse, [&](int k, float2 z) {
          z = cmul(z, __ldg(&tw[k * 256 + (col >> 2)]));
          buf[swz(k * 1024 + col)] = z;
        });
      }
    }
    clock.lap(0);
    __syncthreads();
    // stage 1, radix 16 over the middle digit, in place (large.cuh's
    // fixed_stage<16, 16, 16, 4, kRowThreads> with this unit's column index)
    if constexpr (kForm == kTileRoots) {
      float2 v[kRowPer][16];
#pragma unroll
      for (int i = 0; i < kRowPer; ++i) {
        const int col = c + kRowThreads * i;
        const int base = (col >> 6) * 1024 + (col & 63);
#pragma unroll
        for (int j = 0; j < 16; ++j) v[i][j] = buf[swz(base + 64 * j)];
      }
      __syncthreads();
      const float2* __restrict__ tw = opaque_ptr(st.tw[1]);
#pragma unroll
      for (int i = 0; i < kRowPer; ++i) {
        const int col = c + kRowThreads * i;
        tile_dft16<kForm>(v[i], sroots, 1, inverse, [&](int k, float2 z) {
          z = cmul(z, __ldg(&tw[k * 16 + ((col & 63) >> 2)]));
          buf[swz(k * 1024 + col)] = z;
        });
      }
    } else {
      float2 v[16];
      row_gauss_read(v, buf, side, c, [](int col) { return (col >> 6) * 1024 + (col & 63); }, 64);
      __syncthreads();
      const float2* __restrict__ tw = opaque_ptr(st.tw[1]);
#pragma unroll
      for (int i = 0; i < kRowPer; ++i) {
        const int col = c + kRowThreads * i;
        if (i > 0) row_gauss_unstash(v, side, c, i);
        tile_dft16<kForm>(v, sroots, 1, inverse, [&](int k, float2 z) {
          z = cmul(z, __ldg(&tw[k * 16 + ((col & 63) >> 2)]));
          buf[swz(k * 1024 + col)] = z;
        });
      }
    }
    clock.lap(1);
    __syncthreads();
    // stage 2 over the rows 16*(col/4) .. + 15 of each column, the next
    // tile's copies started once every thread holds its rows, then the
    // stores
    if constexpr (kForm == kTileRoots) {
      float2 v[kRowPer][16];
#pragma unroll
      for (int i = 0; i < kRowPer; ++i) {
        const int col = c + kRowThreads * i;
        const int base = (col >> 2) * 64 + (col & 3);
#pragma unroll
        for (int j = 0; j < 16; ++j) v[i][j] = buf[swz(base + 4 * j)];
      }
      __syncthreads();
      const unsigned next = u + gridDim.x;
      if (next < tiles)
        row_tile_copy(buf, x + (size_t)(next / per_row) * row_elems + (next % per_row) * kRowT,
                      (unsigned)((c >> 2) + 2048 * (c & 1)) * (unsigned)p + (c & 2), step);
      float2* __restrict__ yr =
          y + (size_t)(u / per_row) * row_elems + (u % per_row) * kRowT + (c & 3);
#pragma unroll
      for (int i = 0; i < kRowPer; ++i) {
        const unsigned out = (unsigned)((c + kRowThreads * i) >> 2) * (unsigned)p;
        tile_dft16<kForm>(v[i], sroots, 2, inverse,
                          [&](int k, float2 z) { yr[out + k * step] = z; });
      }
    } else {
      float2 v[16];
      row_gauss_read(v, buf, side, c, [](int col) { return (col >> 2) * 64 + (col & 3); }, 4);
      __syncthreads();
      const unsigned next = u + gridDim.x;
      if (next < tiles)
        row_tile_copy(buf, x + (size_t)(next / per_row) * row_elems + (next % per_row) * kRowT,
                      (unsigned)((c >> 2) + 2048 * (c & 1)) * (unsigned)p + (c & 2), step);
      float2* __restrict__ yr =
          y + (size_t)(u / per_row) * row_elems + (u % per_row) * kRowT + (c & 3);
#pragma unroll
      for (int i = 0; i < kRowPer; ++i) {
        const unsigned out = (unsigned)((c + kRowThreads * i) >> 2) * (unsigned)p;
        if (i > 0) row_gauss_unstash(v, side, c, i);
        tile_dft16<kForm>(v, sroots, 2, inverse, [&](int k, float2 z) { yr[out + k * step] = z; });
      }
    }
    clock.lap(2);
  }
  clock.write(stamps);
}

template <int kForm = kTileRoots>
static size_t row_tile_smem() {
  return (size_t)(kRowElems + tile_table_slots(kForm, 3) + (kForm == kTileRoots ? 0 : kRowSide)) *
         sizeof(float2);
}

// One launch of `grid` persistent blocks (1 <= grid <= tiles) over the
// batch*P/4 tiles.
template <bool kStamp, int kForm = kTileRoots>
static cudaError_t launch_row_tile(const float2* x, float2* y, long long batch, int p,
                                   long long grid, const Stages& st, unsigned long long* stamps,
                                   cudaStream_t s) {
  const long long tiles = batch * (p / kRowT);
  if (p % kRowT != 0 || p > 32768 || grid < 1 || grid > tiles || tiles > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(row_tile_kernel<kStamp, kForm>, row_tile_smem<kForm>());
  if (err != cudaSuccess) return err;
  row_tile_kernel<kStamp, kForm><<<(unsigned)grid, kRowThreads, row_tile_smem<kForm>(), s>>>(
      x, y, (unsigned)tiles, p, st, stamps);
  return cudaGetLastError();
}

static bool row_tile_chain(int k, int r0, int r1, int r2, int pt) {
  return k == 3 && r0 == 16 && r1 == 16 && r2 == 16 && pt == kRowT;
}

}  // namespace rf
