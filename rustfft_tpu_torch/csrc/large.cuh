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
// epilogues (K14); csrc/large2f.cu and csrc/large3.cu with outer twiddles
// factored into small tables (K10, K11).  Two reads and two writes of the
// signal in device memory per FFT, as on the TPU.  The general kernels take
// one option: the Gauss form of every radix stage (kGauss, K4's Gauss
// kernels and K14's gauss_mode; fft_tile.cuh gauss_stage), launched by
// launch_col_gauss / launch_row_gauss.
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
// loads and the stores are contiguous.  At P = 1024..8192 (the top band's
// column stages) the compile-time kernels hold one (P, 16384/P) tile of
// 128 KiB in place: 16 down to 2 columns, 128- down to 16-byte segments.
// The row stage's block holds a
// (Q, pt) tile in shared memory: at Q = 4096 the TPU's 128-lane tile would
// be 4 MiB; the compile-time kernel takes pt = 4 (32-byte row segments, one
// sector; 1024 threads, 128 KiB in place), the general kernel pt = 2 or 1.
// The main path's chains with plain loads and stores (K2, K3, and K10's and
// K11's Q passes) run csrc/large.cu's persistent tile kernels instead; the
// compile-time bodies here serve the top band's column stages (K10, K11)
// and K2's and K3's other chains.  The chains with compile-time kernels (fixed_chain) also read
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
// and the column stage's outer twiddle `Outer` provides
//   float2 operator()(int j2, int k1) const  // w_n^(k1*j2), or a factor of it
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

// Outer twiddle from a (Q, P) table [j2, k1] of n entries (K2, K14).
struct FullOuter {
  const float2* __restrict__ tw;
  int p;
  __device__ float2 operator()(int j, int k) const { return __ldg(&tw[(size_t)j * p + k]); }
};

// w_n^(K*j3) with K = k2*P1 + k1 < P = P1*P2, from wob (Q, P1) [j3, k1] =
// w_n^(k1*j3) and wm (Q, P2) [j3, k2] = w_{n/P1}^(k2*j3): Q*(P1 + P2)
// entries (K10's column stage).
struct FactoredOuter {
  const float2* __restrict__ wob;
  const float2* __restrict__ wm;
  int p1, p2;
  __device__ float2 operator()(int j, int k) const {
    const int k2 = k / p1;
    return cmul(__ldg(&wob[(size_t)j * p1 + (k - k2 * p1)]), __ldg(&wm[(size_t)j * p2 + k2]));
  }
};

// wob[(j mod Q), k1] from a (Q, P) table: the j3 factor of K11's pass-1
// twiddle, j = j2*Q + j3.
struct ModOuter {
  const float2* __restrict__ wob;
  int p, q;
  __device__ float2 operator()(int j, int k) const {
    return __ldg(&wob[(size_t)(j % q) * p + k]);
  }
};

// The column stage's store: the tile's DFT_P output res[k1*qt + t] goes,
// times the outer twiddle, to yb[(q0 + t)*P + k1] (contiguous in k1).
template <class Outer>
static __device__ __forceinline__ void store_transposed(const float2* res, float2* __restrict__ yb,
                                                        int p, int q0, int qt,
                                                        const Outer& outer) {
  for (int f = threadIdx.x; f < p * qt; f += blockDim.x) {
    const int t = f / p, k1 = f - t * p;
    yb[(size_t)(q0 + t) * p + k1] = cmul(res[swz(k1 * qt + t)], outer(q0 + t, k1));
  }
}

// The tile width qt divides Q.  kGauss: every radix stage in the Gauss form.
template <class Src, class Outer, bool kGauss = false>
__global__ void __launch_bounds__(256) col_kernel(Src src, float2* __restrict__ y, int p, int q,
                                                  int qt, Stages st, Outer outer) {
  extern __shared__ float2 smem[];
  const int elems = p * qt;
  float2* a = smem;
  float2* b = smem + pad16(elems);
  float2* sroots = smem + 2 * pad16(elems);
  load_tables<kGauss>(st, sroots);
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
  const float2* res = fft_tile<kGauss>(a, b, p, qt, st, sroots);
  store_transposed(res, y + batch_idx * (size_t)p * (size_t)q, p, q0, qt, outer);
}

// The tile width pt divides P.  kGauss: every radix stage in the Gauss
// form.
template <class Dst, bool kGauss = false>
__global__ void __launch_bounds__(512) row_kernel(const float2* __restrict__ x, Dst dst, int q,
                                                  int p, int pt, Stages st) {
  extern __shared__ float2 smem[];
  const int elems = q * pt;
  float2* a = smem;
  float2* b = smem + pad16(elems);
  float2* sroots = smem + 2 * pad16(elems);
  load_tables<kGauss>(st, sroots);
  const int tiles = p / pt;
  const size_t batch_idx = blockIdx.x / tiles;
  const int p0 = (int)(blockIdx.x % tiles) * pt;
  const float2* xb = x + batch_idx * (size_t)q * (size_t)p;
  for (int f = threadIdx.x; f < elems; f += blockDim.x) {
    const int j2 = f / pt, t = f - j2 * pt;
    a[swz(f)] = xb[(size_t)j2 * p + p0 + t];
  }
  __syncthreads();
  const float2* res = fft_tile<kGauss>(a, b, q, pt, st, sroots);
  const auto row = dst.row(batch_idx);
  for (int f = threadIdx.x; f < elems; f += blockDim.x) {
    const int k2 = f / pt, t = f - k2 * pt;
    row.store(k2 * p + p0 + t, res[swz(f)]);
  }
  dst.finish(batch_idx, p0);
}

// col_kernel for one compile-time DFT_P chain and tile width T.
template <int T, int R0, int R1, int R2, class Src, class Outer>
__global__ void __launch_bounds__(kFixedThreads<T, R0, R1, R2>)
    col_fixed_kernel(Src src, float2* __restrict__ y, int q, Stages st, Outer outer) {
  constexpr int P = R0 * R1 * R2;
  extern __shared__ float2 smem[];
  float2* buf = smem;
  float2* sroots = smem + P * T;
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
  store_transposed(buf, y + batch_idx * (size_t)P * (size_t)q, P, q0, T, outer);
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

template <int T, int R0, int R1, int R2, class Src, class Outer>
static cudaError_t launch_col_fixed(const Src& src, float2* y, long long blocks, int q,
                                    const Stages& st, const Outer& outer, cudaStream_t s) {
  const size_t smem = (size_t)(R0 * R1 * R2 * T + R0 + R1 + R2) * sizeof(float2);
  cudaError_t err = allow_smem(col_fixed_kernel<T, R0, R1, R2, Src, Outer>, smem);
  if (err != cudaSuccess) return err;
  col_fixed_kernel<T, R0, R1, R2, Src, Outer>
      <<<(unsigned)blocks, kFixedThreads<T, R0, R1, R2>, smem, s>>>(src, y, q, st, outer);
  return cudaGetLastError();
}

// The general column kernel over (batch, Q/qt) blocks.
template <bool kGauss, class Src, class Outer>
static cudaError_t launch_col_general(const Src& src, float2* y, long long batch, int p, int q,
                                     int qt, const Stages& st, const Outer& outer,
                                     cudaStream_t s) {
  const long long blocks = batch * (q / qt);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = tile_smem_bytes(p * qt, st, kGauss);
  cudaError_t err = allow_smem(col_kernel<Src, Outer, kGauss>, smem);
  if (err != cudaSuccess) return err;
  col_kernel<Src, Outer, kGauss>
      <<<(unsigned)blocks, 256, smem, s>>>(src, y, p, q, qt, st, outer);
  return cudaGetLastError();
}

// The general row kernel over (batch, P/pt) blocks.
template <bool kGauss, class Dst>
static cudaError_t launch_row_general(const float2* x, const Dst& dst, long long batch, int q,
                                     int p, int pt, const Stages& st, cudaStream_t s) {
  const long long blocks = batch * (p / pt);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = tile_smem_bytes(q * pt, st, kGauss);
  cudaError_t err = allow_smem(row_kernel<Dst, kGauss>, smem);
  if (err != cudaSuccess) return err;
  row_kernel<Dst, kGauss><<<(unsigned)blocks, 512, smem, s>>>(x, dst, q, p, pt, st);
  return cudaGetLastError();
}

// Launch the column stage over (batch, Q/qt) blocks: a compile-time kernel
// for P = 16 x 16 over 16 columns and for the 128 KiB tiles of P = 1024,
// 2048, 4096 and 8192 (ops/kernels/large.py FIXED_COL); the general kernel
// otherwise.
template <class Src, class Outer>
static cudaError_t launch_col_stage(const Src& src, float2* y, long long batch, int p, int q,
                                    int qt, const Stages& st, const Outer& outer,
                                    cudaStream_t s) {
  const long long blocks = batch * (q / qt);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int k = st.k, r0 = st.r[0], r1 = st.r[1], r2 = st.r[2];
  if (k == 2 && r0 == 16 && r1 == 16 && qt == 16)
    return launch_col_fixed<16, 16, 16, 1>(src, y, blocks, q, st, outer, s);
  if (k == 3 && r0 == 16 && r1 == 16 && r2 == 4 && qt == 16)
    return launch_col_fixed<16, 16, 16, 4>(src, y, blocks, q, st, outer, s);
  if (k == 3 && r0 == 16 && r1 == 16 && r2 == 8 && qt == 8)
    return launch_col_fixed<8, 16, 16, 8>(src, y, blocks, q, st, outer, s);
  if (k == 3 && r0 == 16 && r1 == 16 && r2 == 16 && qt == 4)
    return launch_col_fixed<4, 16, 16, 16>(src, y, blocks, q, st, outer, s);
  if (k == 3 && r0 == 32 && r1 == 16 && r2 == 16 && qt == 2)
    return launch_col_fixed<2, 32, 16, 16>(src, y, blocks, q, st, outer, s);
  return launch_col_general<false>(src, y, batch, p, q, qt, st, outer, s);
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
  return launch_row_general<false>(x, dst, batch, q, p, pt, st, s);
}

// The column and row stages in the Gauss form (kGauss above) on the general
// kernels, `st` from make_gauss_stages: no compile-time chain has a Gauss
// form.  qt divides Q, pt divides P.
template <class Src, class Outer>
static cudaError_t launch_col_gauss(const Src& src, float2* y, long long batch, int p, int q,
                                    int qt, const Stages& st, const Outer& outer,
                                    cudaStream_t s) {
  return launch_col_general<true>(src, y, batch, p, q, qt, st, outer, s);
}

template <class Dst>
static cudaError_t launch_row_gauss(const float2* x, const Dst& dst, long long batch, int q,
                                    int p, int pt, const Stages& st, cudaStream_t s) {
  return launch_row_general<true>(x, dst, batch, q, p, pt, st, s);
}

}  // namespace rf
