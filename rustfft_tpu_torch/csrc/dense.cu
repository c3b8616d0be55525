// The whole DFT as one dense product: the port of K5.
//
// Replaces rustfft_tpu/ops/pallas/dense.py:_kernel_block (the 4-multiply
// form) and :_kernel_gauss (the 3-multiply Gauss form): for a (B, n) batch,
//
//   out[b, k] = sum_j x[b, j] W_n[j, k],   W_n[j, k] = w_n^(j*k),
//
//   block:  re += xr.Wr - xi.Wi, im += xr.Wi + xi.Wr (4 FMAs per term);
//   gauss:  P1 += xr.Wr, P2 += xi.Wi, P3 += (xr + xi).(Wr + Wi) (3 FMAs),
//           re = P1 - P2, im = P3 - P1 - P2.
//
// A tiled FP32 product on the CUDA cores (no tensor cores, no TF32).  A
// 256-thread block owns a (16*TM rows b) x (16*TN outputs k) tile of the
// output and walks j in steps of 16 through shared memory: the x tile
// (16*TM rows by 16 j, 128-byte row segments) and the W tile (16 j by 16*TN
// k, from the (n, n) complex64 table, which stays in L2: 512 KiB at n = 256,
// 8 MiB at 1009).  Each thread keeps a TM x TN register micro-tile of
// outputs, rows ty + 16 i and outputs tx + 16 j, so that a warp's shared
// reads are broadcasts (x) or 16 consecutive words (W), and its stores 128
// consecutive bytes of a row.  The ragged edges of n and of the batch load
// zero and skip their stores.  The Gauss form reads Wr + Wi from its own
// f32 table, the JAX package's `wr + wi`.
//
// What bounds it: 8 n^2 FP32 operations per transform (6 n^2 in the Gauss
// form) against 16 n bytes, so arithmetic from n ~ 8 up (ops/kernels/
// dense.py); the tile's shared loads (TM + TN values per 2 TM TN FMAs in the
// block form) and the single-buffered tiles are what keep it from the FP32
// peak.  It serves the Gauss form and the block form above kPairMax.
//
// The block form at 2 <= n <= kPairMax (the route's primes 5..23) runs
// dense_pair_kernel<n> instead: the same DFT of every row, for which the
// tile above would spend 8 * 32^2 = 8192 operations a row at n = 23 (356 a
// point, every block reading W from L2 and transposing x through shared
// memory) and 2048 at n = 5.
//  - One thread holds one row in registers and computes its DFT in the
//    conjugate-pair form of RustFFT's prime butterflies: a_j = x_j +
//    x_{n-j}, b_j = x_j - x_{n-j} (j = 1..(n-1)/2; x_{n-j} - x_j for the
//    inverse), X_0 = x_0 + sum a_j, and for k = 1..(n-1)/2
//        C = x_0 + sum_j cos(2 pi jk/n) a_j,  S = sum_j sin(2 pi jk/n) b_j,
//        X_k = C - iS,  X_{n-k} = C + iS,
//    with the middle term x_{n/2} at even n.  The cosines and sines are
//    compile-time constants (csrc/dense_pair.cuh: dft_matrix's entries cast
//    to f32), FMA immediates: (n-1)^2 + 4n operations a row (594 at 23, 26
//    a point against the 160 the card's FLOP/byte balance leaves per 16
//    bytes), so bytes bound it.  The direction is the sign of Im W[1, 1],
//    one read of the table a block.
//  - Rows are contiguous, so a tile of R = kPairThreads * (24 / n, at least
//    1) rows is one run of R*n*8 bytes (26-48 KiB), 16-byte aligned (R is
//    even): it lands by 16-byte cp.async (8 bytes for an odd tail) and
//    leaves by 16-byte stores, both consecutive.  The row reads from shared
//    memory are n*8 bytes apart: at odd n a half-warp's 8-byte reads fall
//    on 16 distinct bank pairs, no conflict; the results go back in place.
//  - A persistent grid (ops/kernels/dense.py pair_grid: at most the blocks
//    the card holds, two or more an SM) walks the tiles g, g + grid, ...;
//    the next tile lands in a second buffer while this one computes and is
//    stored.
#include <stdint.h>

#include <type_traits>

#include "dense_pair.cuh"
#include "tile_walk.cuh"

namespace rf {

constexpr int kDenseThreads = 256;
constexpr int kDenseBK = 16;  // j per step

template <int TM, int TN, bool kGauss>
__global__ void __launch_bounds__(kDenseThreads)
    dense_kernel(const float2* __restrict__ x, float2* __restrict__ y, long long batch, int n,
                 const float2* __restrict__ w, const float* __restrict__ ws) {
  constexpr int BM = 16 * TM, BN = 16 * TN, BK = kDenseBK;
  constexpr int NX = kGauss ? 3 : 2;  // planes: re, im[, re + im]
  // [plane][j][row]: a stride of BM + 2 words spreads the transposing
  // stores of a warp (16 j by 2 rows) over the 32 banks
  __shared__ float xs[NX][BK][BM + 2];
  __shared__ float wsm[NX][BK][BN];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int ktiles = (n + BN - 1) / BN;
  const int k0 = (int)(blockIdx.x % ktiles) * BN;
  const long long b0 = (long long)(blockIdx.x / ktiles) * BM;

  float acc[NX][TM][TN];
#pragma unroll
  for (int c = 0; c < NX; ++c)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[c][i][j] = 0.f;

  for (int j0 = 0; j0 < n; j0 += BK) {
    __syncthreads();  // the previous step's tiles are consumed
#pragma unroll
    for (int s = 0; s < TM; ++s) {  // x tile: BM x BK elements
      const int e = threadIdx.x + s * kDenseThreads;
      const int row = e / BK, col = e % BK;
      const long long b = b0 + row;
      const int j = j0 + col;
      float2 v = make_float2(0.f, 0.f);
      if (b < batch && j < n) v = x[b * n + j];
      xs[0][col][row] = v.x;
      xs[1][col][row] = v.y;
      if constexpr (kGauss) xs[NX - 1][col][row] = v.x + v.y;
    }
#pragma unroll
    for (int s = 0; s < TN; ++s) {  // W tile: BK x BN elements
      const int e = threadIdx.x + s * kDenseThreads;
      const int row = e / BN, col = e % BN;
      const int j = j0 + row, k = k0 + col;
      const bool in = j < n && k < n;
      const size_t idx = (size_t)j * n + k;
      const float2 v = in ? __ldg(&w[idx]) : make_float2(0.f, 0.f);
      wsm[0][row][col] = v.x;
      wsm[1][row][col] = v.y;
      if constexpr (kGauss) wsm[NX - 1][row][col] = in ? __ldg(&ws[idx]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[NX][TM], bw[NX][TN];
#pragma unroll
      for (int c = 0; c < NX; ++c) {
#pragma unroll
        for (int i = 0; i < TM; ++i) a[c][i] = xs[c][kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < TN; ++j) bw[c][j] = wsm[c][kk][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          if constexpr (kGauss) {
            acc[0][i][j] = fmaf(a[0][i], bw[0][j], acc[0][i][j]);
            acc[1][i][j] = fmaf(a[1][i], bw[1][j], acc[1][i][j]);
            acc[2][i][j] = fmaf(a[2][i], bw[2][j], acc[2][i][j]);
          } else {
            acc[0][i][j] = fmaf(a[0][i], bw[0][j], fmaf(-a[1][i], bw[1][j], acc[0][i][j]));
            acc[1][i][j] = fmaf(a[0][i], bw[1][j], fmaf(a[1][i], bw[0][j], acc[1][i][j]));
          }
        }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long b = b0 + ty + 16 * i;
    if (b >= batch) break;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int k = k0 + tx + 16 * j;
      if (k >= n) break;
      float2 v;
      if constexpr (kGauss) {
        v = make_float2(acc[0][i][j] - acc[1][i][j], acc[2][i][j] - acc[0][i][j] - acc[1][i][j]);
      } else {
        v = make_float2(acc[0][i][j], acc[1][i][j]);
      }
      y[b * n + k] = v;
    }
  }
}

template <int TM, int TN, bool kGauss>
static cudaError_t launch_dense(const float2* x, float2* y, long long batch, int n,
                                const float2* w, const float* ws, cudaStream_t s) {
  const long long blocks = (long long)((n + 16 * TN - 1) / (16 * TN)) *
                           ((batch + 16 * TM - 1) / (16 * TM));
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  dense_kernel<TM, TN, kGauss><<<(unsigned)blocks, kDenseThreads, 0, s>>>(x, y, batch, n, w, ws);
  return cudaGetLastError();
}

// The micro-tile: one 16-output column of threads for n <= 16 (8 rows each),
// 32 outputs for n <= 32, else 64 outputs by 64 rows.
template <bool kGauss>
static cudaError_t launch_dense_form(const float2* x, float2* y, long long batch, int n,
                                     const float2* w, const float* ws, cudaStream_t s) {
  if (n <= 16) return launch_dense<8, 1, kGauss>(x, y, batch, n, w, ws, s);
  if (n <= 32) return launch_dense<4, 2, kGauss>(x, y, batch, n, w, ws, s);
  return launch_dense<4, 4, kGauss>(x, y, batch, n, w, ws, s);
}

// ---- the pair form (block form, 2 <= n <= kPairMax) -----------------------

constexpr int kPairMax = 23;
constexpr int kPairThreads = 256;

// Rows a thread takes in one tile, and the tile's rows (ops/kernels/dense.py
// pair_rows).
template <int N>
constexpr int kPairPer = 24 / N > 1 ? 24 / N : 1;
template <int N>
constexpr int kPairRows = kPairThreads * kPairPer<N>;

// The DFT of one row, in place at `row` (N values in shared memory).
template <int N>
static __device__ __forceinline__ void pair_dft_row(float2* row, bool inverse) {
  constexpr int H = (N - 1) / 2;
  using W = PairRoots<N>;
  const float2 x0 = row[0];
  float2 a[H + 1], b[H + 1];  // [1..H]
#pragma unroll
  for (int j = 1; j <= H; ++j) {
    const float2 u = row[j], v = row[N - j];
    a[j] = make_float2(u.x + v.x, u.y + v.y);
    b[j] = inverse ? make_float2(v.x - u.x, v.y - u.y) : make_float2(u.x - v.x, u.y - v.y);
  }
  float2 mid = make_float2(0.f, 0.f);
  if constexpr (N % 2 == 0) mid = row[N / 2];
  float2 s0 = x0;
#pragma unroll
  for (int j = 1; j <= H; ++j) s0 = make_float2(s0.x + a[j].x, s0.y + a[j].y);
  if constexpr (N % 2 == 0) {
    s0 = make_float2(s0.x + mid.x, s0.y + mid.y);
    float2 h = make_float2(x0.x + ((N / 2) % 2 ? -mid.x : mid.x),
                           x0.y + ((N / 2) % 2 ? -mid.y : mid.y));
#pragma unroll
    for (int j = 1; j <= H; ++j)
      h = j % 2 ? make_float2(h.x - a[j].x, h.y - a[j].y)
                : make_float2(h.x + a[j].x, h.y + a[j].y);
    row[N / 2] = h;
  }
  row[0] = s0;
#pragma unroll
  for (int k = 1; k <= H; ++k) {
    float cr = x0.x, ci = x0.y, sr = 0.f, si = 0.f;
    if constexpr (N % 2 == 0) {
      cr += k % 2 ? -mid.x : mid.x;
      ci += k % 2 ? -mid.y : mid.y;
    }
#pragma unroll
    for (int j = 1; j <= H; ++j) {
      const float c = W::c((j * k) % N), s = W::s((j * k) % N);
      cr = fmaf(c, a[j].x, cr);
      ci = fmaf(c, a[j].y, ci);
      sr = fmaf(s, b[j].y, sr);
      si = fmaf(s, b[j].x, si);
    }
    row[k] = make_float2(cr + sr, ci - si);
    row[N - k] = make_float2(cr - sr, ci + si);
  }
}

// This thread's copies of the tile of `rows` rows at src into buf, one
// cp.async group: 16 bytes a copy, the odd 8 bytes of an odd value count by
// thread 0.
template <int N>
static __device__ __forceinline__ void pair_tile_in(float2* buf, const float2* __restrict__ src,
                                                    int rows) {
  const int vals = rows * N;
  for (int i = threadIdx.x; i < vals / 2; i += kPairThreads) cp_async16(buf + 2 * i, src + 2 * i);
  if ((vals & 1) && threadIdx.x == 0) cp_async8(buf + vals - 1, src + vals - 1);
  cp_async_commit();
}

template <int N>
__global__ void __launch_bounds__(kPairThreads)
    dense_pair_kernel(const float2* __restrict__ x, float2* __restrict__ y, long long batch,
                      const float2* __restrict__ w) {
  constexpr int R = kPairRows<N>;
  constexpr int kTile = R * N;
  extern __shared__ float4 pair_smem[];
  float2* bufs = reinterpret_cast<float2*>(pair_smem);
  bool inverse = false;
  if constexpr (N >= 3) inverse = __ldg(&w[N + 1]).y > 0.f;  // W[1, 1] = w_N^(+-1)
  const long long tiles = (batch + R - 1) / R;
  long long t = blockIdx.x;
  if (t < tiles) pair_tile_in<N>(bufs, x + t * kTile, (int)min((long long)R, batch - t * R));
  for (int cur = 0; t < tiles; t += gridDim.x, cur ^= 1) {
    float2* buf = bufs + cur * kTile;
    const int rows = (int)min((long long)R, batch - t * R);
    const long long next = t + gridDim.x;
    if (next < tiles) {
      pair_tile_in<N>(bufs + (cur ^ 1) * kTile, x + next * kTile,
                      (int)min((long long)R, batch - next * R));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the tile, every thread's copies
#pragma unroll
    for (int i = 0; i < kPairPer<N>; ++i) {
      const int r = threadIdx.x + i * kPairThreads;
      if (r < rows) pair_dft_row<N>(buf + r * N, inverse);
    }
    __syncthreads();
    float2* __restrict__ dst = y + t * kTile;
    const int vals = rows * N;
    for (int i = threadIdx.x; i < vals / 2; i += kPairThreads)
      *reinterpret_cast<float4*>(dst + 2 * i) = *reinterpret_cast<const float4*>(buf + 2 * i);
    if ((vals & 1) && threadIdx.x == 0) dst[vals - 1] = buf[vals - 1];
    __syncthreads();  // this buffer is free for the tile after next
  }
}

template <int N>
static size_t pair_smem() {
  return 2 * (size_t)kPairRows<N> * N * sizeof(float2);
}

template <int N>
static cudaError_t launch_pair(const float2* x, float2* y, long long batch, long long grid,
                               const float2* w, cudaStream_t s) {
  const long long tiles = (batch + kPairRows<N> - 1) / kPairRows<N>;
  if (grid < 1 || grid > tiles || grid > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(dense_pair_kernel<N>, pair_smem<N>());
  if (err != cudaSuccess) return err;
  dense_pair_kernel<N><<<(unsigned)grid, kPairThreads, pair_smem<N>(), s>>>(x, y, batch, w);
  return cudaGetLastError();
}

template <int N>
static cudaError_t pair_resident(int* out) {
  return resident_blocks(dense_pair_kernel<N>, kPairThreads, pair_smem<N>(), out);
}

// f<N>(args...) for the runtime n, 2 <= n <= kPairMax.
template <int N = 2, class F>
static cudaError_t pair_dispatch(int n, F f) {
  if constexpr (N <= kPairMax) {
    if (n == N) return f(std::integral_constant<int, N>{});
    return pair_dispatch<N + 1>(n, f);
  } else {
    return cudaErrorInvalidValue;
  }
}

}  // namespace rf

// x, y: (batch, n) complex64; w: (n, n) complex64 W_n; gauss != 0: the
// 3-multiply form, which also reads ws: (n, n) float32 Wr + Wi.  The block
// form at 2 <= n <= 23 runs dense_pair_kernel on `grid` persistent blocks
// (1 <= grid <= the tiles; ops/kernels/dense.py pair_grid), x and y 16-byte
// aligned; grid is not read otherwise.  Returns a cudaError_t code;
// launches on `stream`.
extern "C" int rf_dense_fft(const void* x, void* y, long long batch, int n, int gauss,
                            const void* w, const void* ws, long long grid, void* stream) {
  using namespace rf;
  if (batch <= 0 || n <= 0 || w == nullptr || (gauss && ws == nullptr))
    return cudaErrorInvalidValue;
  const auto* xp = static_cast<const float2*>(x);
  auto* yp = static_cast<float2*>(y);
  const auto* wp = static_cast<const float2*>(w);
  const auto* wsp = static_cast<const float*>(ws);
  auto s = static_cast<cudaStream_t>(stream);
  if (!gauss && n >= 2 && n <= kPairMax)
    return pair_dispatch(n, [&](auto c) {
      return launch_pair<decltype(c)::value>(xp, yp, batch, grid, wp, s);
    });
  return gauss ? launch_dense_form<true>(xp, yp, batch, n, wp, wsp, s)
               : launch_dense_form<false>(xp, yp, batch, n, wp, wsp, s);
}

// The blocks of dense_pair_kernel<n> the card holds at once, into *out.
extern "C" int rf_dense_pair_resident(int n, int* out) {
  using namespace rf;
  return pair_dispatch(n, [&](auto c) { return pair_resident<decltype(c)::value>(out); });
}
