// The column and row stages of the two-pass large-n pipeline, as templates
// on what the column stage loads and what the row stage stores.  n = P * Q,
// the input viewed as (B, P, Q) [j1, j2]:
//
//   column stage: a[b, j2, k1] = w_n^(k1*j2) * sum_j1 x[b, j1, j2] * w_P^(j1*k1),
//                 written as (B, Q, P);
//   row stage:    a length-Q FFT over j2 for every k1, giving X[b, k2*P + k1]
//                 in natural order.
//
// csrc/large.cu instantiates them with plain loads and stores (K2 and K3);
// csrc/conv_radix.cu with the two-pass convolution core's gathers, sums and
// epilogues (K14).  Two reads and two writes of the signal in device memory
// per FFT, as on the TPU.
//
// What bounds them on this card: memory alone is 32 bytes per point over the
// two stages.  Arithmetic is FP32 on the CUDA cores.  The TPU kernels
// contract a dense DFT_P (256 multiply-adds per point at P = 256) and split
// Q as q1 x q2 (128 at Q = 64 x 64), which their matrix unit absorbs; here
// both stages instead compute their DFT in the cheapest radix stages (16 x 16
// for P = 256, 16 x 16 x 16 for Q = 4096) as register FFTs, an exact DFT
// either way, and latency (loads, stages and stores of a block in turn;
// one 1024-thread row-stage block per SM) is what remains.
//
// Design: the column stage's block loads a (P, qt) tile, 16 consecutive j2
// per row (128-byte segments), runs DFT_P on its qt columns in shared memory,
// and stores the transposed (qt, P) tile with the outer twiddle, so both the
// loads and the stores are contiguous.  The row stage's block holds a
// (Q, pt) tile in shared memory: at Q = 4096 the TPU's 128-lane tile would
// be 4 MiB; the main path's compile-time kernel takes pt = 4 (32-byte row
// segments, one sector; 1024 threads, 128 KiB in place), the general kernel
// pt = 2 or 1.  The chains with compile-time kernels (fixed_chain) also read
// stage 0 from, and the row stage's last stage write to, device memory
// directly.  Grids are one-dimensional over (batch, tile) and every offset
// into device memory is size_t: batch 1024 at n = 2^20 is 2^31 floats.
//
// A column-stage source `Src` provides
//   float2 load(size_t b, int j, float2& acc) const  // element j of row b
//   void finish(size_t b, int tile, int tiles, float2 acc) const
// (finish is called by every thread of the block, once, after the loads; acc
// starts at 0 in each thread and is the source's to accumulate into).  A
// row-stage sink `Dst` provides
//   Row row(size_t b) const  // with void store(int k, float2 v) const
//   void finish(size_t b, int p0) const  // every thread, after the stores
#pragma once

#include "fft_tile.cuh"

namespace rf {

// Column-stage source of the plain pipeline: x (B, ld) row-major.
struct RowsIn {
  const float2* __restrict__ x;
  size_t ld;
  __device__ float2 load(size_t b, int j, float2&) const { return x[b * ld + j]; }
  __device__ void finish(size_t, int, int, float2) const {}
};

// Row-stage sink of the plain pipeline: y (B, ld) row-major, natural order.
struct RowsOut {
  float2* __restrict__ y;
  size_t ld;
  struct Row {
    float2* __restrict__ yr;
    __device__ void store(int k, float2 v) const { yr[k] = v; }
  };
  __device__ Row row(size_t b) const { return Row{y + b * ld}; }
  __device__ void finish(size_t, int) const {}
};

// Element f = j1*T + t of a column-stage tile, through the source.
template <int T, class Src>
struct TileIn {
  const Src& src;
  size_t b;
  int q, q0;
  float2& acc;
  __device__ float2 load(int f) const { return src.load(b, (f / T) * q + q0 + f % T, acc); }
};

// Element f = k2*T + t of a row-stage tile, to the sink's row.
template <int T, class Row>
struct TileOut {
  const Row& row;
  int p, p0;
  __device__ void store(int f, float2 v) const { row.store((f / T) * p + p0 + f % T, v); }
};

// The column stage's store: the tile's DFT_P output res[k1*qt + t] goes,
// times the outer twiddle, to yb[(q0 + t)*P + k1] (contiguous in k1).
static __device__ __forceinline__ void store_transposed(const float2* res, float2* __restrict__ yb,
                                                        int p, int q0, int qt,
                                                        const float2* __restrict__ tw_outer) {
  for (int f = threadIdx.x; f < p * qt; f += blockDim.x) {
    const int t = f / p, k1 = f - t * p;
    const size_t at = (size_t)(q0 + t) * p + k1;
    yb[at] = cmul(res[swz(k1 * qt + t)], __ldg(&tw_outer[at]));
  }
}

template <class Src>
__global__ void __launch_bounds__(256) col_kernel(Src src, float2* __restrict__ y, int p, int q,
                                                  int qt, Stages st,
                                                  const float2* __restrict__ tw_outer) {
  extern __shared__ float2 smem[];
  const int elems = p * qt;
  float2* a = smem;
  float2* b = smem + pad16(elems);
  float2* sroots = smem + 2 * pad16(elems);
  load_roots(st, sroots);
  const int tiles = q / qt;
  const size_t batch_idx = blockIdx.x / tiles;
  const int tile = (int)(blockIdx.x % tiles);
  const int q0 = tile * qt;
  float2 acc = make_float2(0.f, 0.f);
  for (int f = threadIdx.x; f < elems; f += blockDim.x) {
    const int j1 = f / qt, t = f - j1 * qt;
    a[swz(f)] = src.load(batch_idx, j1 * q + q0 + t, acc);
  }
  src.finish(batch_idx, tile, tiles, acc);
  __syncthreads();
  const float2* res = fft_tile(a, b, p, qt, st, sroots);
  store_transposed(res, y + batch_idx * (size_t)p * (size_t)q, p, q0, qt, tw_outer);
}

template <class Dst>
__global__ void __launch_bounds__(512) row_kernel(const float2* __restrict__ x, Dst dst, int q,
                                                  int p, int pt, Stages st) {
  extern __shared__ float2 smem[];
  const int elems = q * pt;
  float2* a = smem;
  float2* b = smem + pad16(elems);
  float2* sroots = smem + 2 * pad16(elems);
  load_roots(st, sroots);
  const int tiles = p / pt;
  const size_t batch_idx = blockIdx.x / tiles;
  const int p0 = (int)(blockIdx.x % tiles) * pt;
  const float2* xb = x + batch_idx * (size_t)q * (size_t)p;
  for (int f = threadIdx.x; f < elems; f += blockDim.x) {
    const int j2 = f / pt, t = f - j2 * pt;
    a[swz(f)] = xb[(size_t)j2 * p + p0 + t];
  }
  __syncthreads();
  const float2* res = fft_tile(a, b, q, pt, st, sroots);
  const auto row = dst.row(batch_idx);
  for (int f = threadIdx.x; f < elems; f += blockDim.x) {
    const int k2 = f / pt, t = f - k2 * pt;
    row.store(k2 * p + p0 + t, res[swz(f)]);
  }
  dst.finish(batch_idx, p0);
}

// col_kernel for one compile-time DFT_P chain and tile width T.
template <int T, int R0, int R1, int R2, class Src>
__global__ void __launch_bounds__(kFixedThreads<T, R0, R1, R2>)
    col_fixed_kernel(Src src, float2* __restrict__ y, int q, Stages st,
                     const float2* __restrict__ tw_outer) {
  constexpr int P = R0 * R1 * R2;
  __shared__ float2 buf[P * T];
  __shared__ float2 sroots[R0 + R1 + R2];
  load_roots(st, sroots);
  __syncthreads();
  const int tiles = q / T;
  const size_t batch_idx = blockIdx.x / tiles;
  const int tile = (int)(blockIdx.x % tiles);
  const int q0 = tile * T;
  float2 acc = make_float2(0.f, 0.f);  // stage 0 loads each element once
  fixed_chain<T, R0, R1, R2>(TileIn<T, Src>{src, batch_idx, q, q0, acc}, SmemTile{buf}, buf,
                             sroots, st);
  src.finish(batch_idx, tile, tiles, acc);
  __syncthreads();
  store_transposed(buf, y + batch_idx * (size_t)P * (size_t)q, P, q0, T, tw_outer);
}

// row_kernel for one compile-time length-Q chain and tile width T: stage 0
// reads the (Q, T) window from device memory, the last stage stores it
// through the sink.
template <int T, int R0, int R1, int R2, class Dst>
__global__ void __launch_bounds__(kFixedThreads<T, R0, R1, R2>)
    row_fixed_kernel(const float2* __restrict__ x, Dst dst, int p, Stages st) {
  constexpr int Q = R0 * R1 * R2;
  extern __shared__ float2 smem[];
  float2* buf = smem;
  float2* sroots = smem + Q * T;
  load_roots(st, sroots);
  __syncthreads();
  const int tiles = p / T;
  const size_t batch_idx = blockIdx.x / tiles;
  const int p0 = (int)(blockIdx.x % tiles) * T;
  const auto row = dst.row(batch_idx);
  fixed_chain<T, R0, R1, R2>(
      GlobalIn<T>{x + batch_idx * (size_t)Q * (size_t)p + p0, (size_t)p},
      TileOut<T, decltype(row)>{row, p, p0}, buf, sroots, st);
  dst.finish(batch_idx, p0);
}

// Launch the column stage over (batch, Q/qt) blocks: the compile-time kernel
// for P = 16 x 16 over 16 columns, the general kernel otherwise.
template <class Src>
static cudaError_t launch_col_stage(const Src& src, float2* y, long long batch, int p, int q,
                                    int qt, const Stages& st, const float2* tw_outer,
                                    cudaStream_t s) {
  const long long blocks = batch * (q / qt);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (st.k == 2 && st.r[0] == 16 && st.r[1] == 16 && qt == 16) {
    col_fixed_kernel<16, 16, 16, 1, Src>
        <<<(unsigned)blocks, kFixedThreads<16, 16, 16, 1>, 0, s>>>(src, y, q, st, tw_outer);
    return cudaGetLastError();
  }
  const size_t smem = tile_smem_bytes(p * qt, st);
  cudaError_t err = allow_smem(col_kernel<Src>, smem);
  if (err != cudaSuccess) return err;
  col_kernel<Src><<<(unsigned)blocks, 256, smem, s>>>(src, y, p, q, qt, st, tw_outer);
  return cudaGetLastError();
}

template <int T, int R0, int R1, int R2, class Dst>
static cudaError_t launch_row_fixed(const float2* x, const Dst& dst, long long blocks, int p,
                                    const Stages& st, cudaStream_t s) {
  const size_t smem = (size_t)(R0 * R1 * R2 * T + R0 + R1 + R2) * sizeof(float2);
  cudaError_t err = allow_smem(row_fixed_kernel<T, R0, R1, R2, Dst>, smem);
  if (err != cudaSuccess) return err;
  row_fixed_kernel<T, R0, R1, R2, Dst>
      <<<(unsigned)blocks, kFixedThreads<T, R0, R1, R2>, smem, s>>>(x, dst, p, st);
  return cudaGetLastError();
}

// Launch the row stage over (batch, P/pt) blocks: a compile-time kernel for
// Q = 4096 (16 x 16 x 16) over 4 columns and, where `fixed_ok`, Q = 256,
// 128 and 64 over 16 columns; the general kernel otherwise.
template <class Dst>
static cudaError_t launch_row_stage(const float2* x, const Dst& dst, long long batch, int q,
                                    int p, int pt, const Stages& st, bool fixed_ok,
                                    cudaStream_t s) {
  const long long blocks = batch * (p / pt);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int k = st.k, r0 = st.r[0], r1 = st.r[1], r2 = st.r[2];
  if (k == 3 && r0 == 16 && r1 == 16 && r2 == 16 && pt == 4)
    return launch_row_fixed<4, 16, 16, 16>(x, dst, blocks, p, st, s);
  if (fixed_ok && k == 2 && pt == 16) {
    if (r0 == 16 && r1 == 16) return launch_row_fixed<16, 16, 16, 1>(x, dst, blocks, p, st, s);
    if (r0 == 16 && r1 == 8) return launch_row_fixed<16, 16, 8, 1>(x, dst, blocks, p, st, s);
    if (r0 == 8 && r1 == 8) return launch_row_fixed<16, 8, 8, 1>(x, dst, blocks, p, st, s);
  }
  const size_t smem = tile_smem_bytes(q * pt, st);
  cudaError_t err = allow_smem(row_kernel<Dst>, smem);
  if (err != cudaSuccess) return err;
  row_kernel<Dst><<<(unsigned)blocks, 512, smem, s>>>(x, dst, q, p, pt, st);
  return cudaGetLastError();
}

}  // namespace rf
