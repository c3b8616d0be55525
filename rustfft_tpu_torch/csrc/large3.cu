// Passes 1 and 2 of the three-pass top-band pipeline: the port of K11.
//
// Replaces rustfft_tpu/ops/pallas/large3.py.  n = P1 * P2 * Q, input index
// j = j1*(P2*Q) + j2*Q + j3, output X[k3*(P1*P2) + k2*P1 + k1]:
//
//   pass 1 (rf_large3_col_stage): K2's column stage (large.py:_kernel_a, as
//       large3.py calls it with the factored table's modular block map) at
//       P = P1 over M = P2*Q columns jr = j2*Q + j3, with only the j3 factor
//       of the outer twiddle, wob[jr mod Q, k1] = w_n^(k1*j3) (large.cuh
//       ModOuter): (B, M, P1) [jr, k1].  Unfactored, pass 1 is K2 itself
//       (rf_large_col_stage with the (M, P1) table of n entries).
//   pass 2 (rf_large3_p2, large3.py:_kernel_p2f; _kernel_p2 with wos NULL):
//       b[b, j3, k2, k1] = w_M^(k2*j3) * sum_j2 wos[j2, k1] * a[b, j2, j3, k1]
//       * w_P2^(j2*k2), wos[j2, k1] = w_{P1P2}^(k1*j2), written as
//       (B, Q, P2, P1) = (B, Q, P) [j3, K]: the layout K3's row stage reads;
//   pass 3: large_row_stage at (Q, P1*P2) (large3.py:_kernel_q).
//
// Pass 2's design: one thread per column (j3, k1) holds its P2 values in
// registers and runs the radix-2 FFT there (fft_tile.cuh fft_pow2_reg; P2
// <= 64, 128 registers of data).  Consecutive threads take consecutive k1,
// so each of the P2 loads (stride Q*P1) and each of the P2 stores is a
// contiguous 256-byte warp access; no shared memory but the roots, no
// barrier after them.  The TPU kernel ran the same chain as whole-tile
// butterflies on its vector unit (fused.py:_vpu_fft_list).
//
// What bounds pass 2 on this card: one read and one write, 16 bytes per
// point (2.1 GB at 2^26 x 2: 0.64 ms at 3.35 TB/s); its 5*log2(P2) + 12
// flops per point are far under the FP32 peak.
#include "large.cuh"

namespace rf {

template <int P2>
__global__ void __launch_bounds__(256)
    p2_kernel(const float2* __restrict__ a, float2* __restrict__ y, long long columns, int p1,
              int q, const float2* __restrict__ roots, const float2* __restrict__ wos,
              const float2* __restrict__ wm) {
  __shared__ float2 sroots[P2];
  for (int i = threadIdx.x; i < P2; i += blockDim.x) sroots[i] = roots[i];
  __syncthreads();
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= columns) return;
  const size_t cols = (size_t)q * (size_t)p1;  // columns (j3, k1) of one transform
  const size_t b = (size_t)g / cols;
  const int c = (int)((size_t)g - b * cols);
  const int j3 = c / p1, k1 = c - j3 * p1;
  const float2* ab = a + b * (size_t)P2 * cols + c;
  float2 v[P2];
#pragma unroll
  for (int j = 0; j < P2; ++j) {
    v[j] = ab[(size_t)j * cols];
    if (wos != nullptr) v[j] = cmul(v[j], __ldg(&wos[j * p1 + k1]));
  }
  float2* yb = y + b * (size_t)P2 * cols + (size_t)j3 * P2 * p1 + k1;
  const float2* wmj = wm + (size_t)j3 * P2;
  dft_column<P2>(v, sroots, [&](int k2, float2 z) {
    yb[(size_t)k2 * p1] = cmul(z, __ldg(&wmj[k2]));
  });
}

template <int P2>
static cudaError_t launch_p2(const float2* a, float2* y, long long columns, int p1, int q,
                             const float2* roots, const float2* wos, const float2* wm,
                             cudaStream_t s) {
  const long long blocks = (columns + 255) / 256;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  p2_kernel<P2><<<(unsigned)blocks, 256, 0, s>>>(a, y, columns, p1, q, roots, wos, wm);
  return cudaGetLastError();
}

}  // namespace rf

// x: (batch, P*M) complex64, y: (batch, M, P); the radices of `st` split P,
// qt divides M and Q divides M; wob: (Q, P).  Returns a cudaError_t code;
// launches on `stream`.
extern "C" int rf_large3_col_stage(const void* x, void* y, long long batch, int p, int m, int q,
                                   int qt, int k, int r0, int r1, int r2, const void* roots0,
                                   const void* roots1, const void* roots2, const void* tw0,
                                   const void* tw1, const void* wob, void* stream) {
  using namespace rf;
  if (batch <= 0 || m <= 0 || q <= 0 || m % q != 0 || qt <= 0 || m % qt != 0)
    return cudaErrorInvalidValue;
  const Stages st = make_stages(k, r0, r1, r2, roots0, roots1, roots2, tw0, tw1);
  if (!stages_ok(st, p) || wob == nullptr) return cudaErrorInvalidValue;
  return launch_col_stage(RowsIn{static_cast<const float2*>(x), (size_t)p * (size_t)m},
                          static_cast<float2*>(y), batch, p, m, qt, st,
                          ModOuter{static_cast<const float2*>(wob), p, q},
                          static_cast<cudaStream_t>(stream));
}

// a: (batch, P2, Q, P1), y: (batch, Q, P2, P1), complex64; roots: (P2,)
// w_P2^e; wos: (P2, P1) or NULL; wm: (Q, P2).  P2 a power of 2 up to 64.
// Returns a cudaError_t code; launches on `stream`.
extern "C" int rf_large3_p2(const void* a, void* y, long long batch, int p1, int p2, int q,
                            const void* roots, const void* wos, const void* wm, void* stream) {
  using namespace rf;
  if (batch <= 0 || p1 <= 0 || q <= 0 || roots == nullptr || wm == nullptr)
    return cudaErrorInvalidValue;
  const long long columns = batch * (long long)q * (long long)p1;
  const auto* ta = static_cast<const float2*>(a);
  auto* ty = static_cast<float2*>(y);
  const auto* tr = static_cast<const float2*>(roots);
  const auto* tos = static_cast<const float2*>(wos);
  const auto* tm = static_cast<const float2*>(wm);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (p2) {
    case 2: return launch_p2<2>(ta, ty, columns, p1, q, tr, tos, tm, s);
    case 4: return launch_p2<4>(ta, ty, columns, p1, q, tr, tos, tm, s);
    case 8: return launch_p2<8>(ta, ty, columns, p1, q, tr, tos, tm, s);
    case 16: return launch_p2<16>(ta, ty, columns, p1, q, tr, tos, tm, s);
    case 32: return launch_p2<32>(ta, ty, columns, p1, q, tr, tos, tm, s);
    case 64: return launch_p2<64>(ta, ty, columns, p1, q, tr, tos, tm, s);
    default: return cudaErrorInvalidValue;
  }
}
