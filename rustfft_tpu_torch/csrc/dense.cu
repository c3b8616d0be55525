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
// peak.
#include "fft_tile.cuh"

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

}  // namespace rf

// x, y: (batch, n) complex64; w: (n, n) complex64 W_n; gauss != 0: the
// 3-multiply form, which also reads ws: (n, n) float32 Wr + Wi.  Returns a
// cudaError_t code; launches on `stream`.
extern "C" int rf_dense_fft(const void* x, void* y, long long batch, int n, int gauss,
                            const void* w, const void* ws, void* stream) {
  using namespace rf;
  if (batch <= 0 || n <= 0 || w == nullptr || (gauss && ws == nullptr))
    return cudaErrorInvalidValue;
  const auto* xp = static_cast<const float2*>(x);
  auto* yp = static_cast<float2*>(y);
  const auto* wp = static_cast<const float2*>(w);
  const auto* wsp = static_cast<const float*>(ws);
  auto s = static_cast<cudaStream_t>(stream);
  return gauss ? launch_dense_form<true>(xp, yp, batch, n, wp, wsp, s)
               : launch_dense_form<false>(xp, yp, batch, n, wp, wsp, s);
}
