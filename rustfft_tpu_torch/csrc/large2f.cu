// The fused column stage of the top power-of-two band: the port of K10.
//
// Replaces rustfft_tpu/ops/pallas/large2f.py:_kernel_a12 (and its
// reduced-rank twin _kernel_a12_2d).  n = P1 * P2 * Q, the input viewed as
// (B, P, Q) with P = P1 * P2 and row J = j1*P2 + j2:
//
//   a[b, j3, K] = w_n^(K*j3) * sum_J x[b, J, j3] * w_P^(J*K),
//   w_n^(K*j3) = wob[j3, k1] * wm[j3, k2],   K = k2*P1 + k1,
//
// written as (B, Q, P): the layout K3's row stage reads, so the second and
// last pass is large_row_stage at (Q, P), the port of the TPU's Q-FFT pass
// (large2f.py:_kernel_q_2d, large3.py:_kernel_q), giving X[k3*P + K] in
// natural order.  One read of x and one write of the intermediate.
//
// The TPU kernel contracts DFT_P1 on its matrix unit, twiddles by
// w_{P1P2}^(k1*j2) and runs the P2 chain on its vector unit.  Here the whole
// length-P DFT is one radix chain in registers (large.stage_radices(P):
// (16,16,4), (16,16,8), (16,16,16), (32,16,16) at P = 1024 .. 8192), the same
// DFT: w_{P1P2}^(k1*j2) is one of the chain's inter-stage twiddles.  The
// outer twiddle is large.cuh's FactoredOuter, two tables of Q*P1 and Q*P2
// entries (6 MB at 2^25) where a (Q, P) table would hold n.
//
// What bounds it on this card: one read and one write of the signal, 16
// bytes per point (1.07 GB at 2^23 x 8: 0.32 ms at 3.35 TB/s); the chain's
// FP32 work is well under the card's peak.  The block holds one 128 KiB
// (P, 16384/P) tile in place (large.cuh col_fixed_kernel): 8, 4 and 2
// columns j3 at P = 2048, 4096 and 8192, so rows are read in 64-, 32- and
// 16-byte segments; at 8192 the neighbouring block (the next block index,
// in flight at the same time) reads the other half of each 32-byte sector,
// which L2 then serves.  Stores are contiguous runs of P values.
#include "large.cuh"

// x: (batch, P1*P2*Q), y: (batch, Q, P1*P2), complex64; the radices of `st`
// split P1*P2, qt divides Q; wob: (Q, P1), wm: (Q, P2).  Returns a
// cudaError_t code; launches on `stream`.
extern "C" int rf_large2f_col_stage(const void* x, void* y, long long batch, int p1, int p2,
                                    int q, int qt, int k, int r0, int r1, int r2,
                                    const void* roots0, const void* roots1, const void* roots2,
                                    const void* tw0, const void* tw1, const void* wob,
                                    const void* wm, void* stream) {
  using namespace rf;
  if (batch <= 0 || p1 <= 0 || p2 <= 0 || q <= 0 || qt <= 0 || q % qt != 0)
    return cudaErrorInvalidValue;
  const int p = p1 * p2;
  const Stages st = make_stages(k, r0, r1, r2, roots0, roots1, roots2, tw0, tw1);
  if (!stages_ok(st, p) || wob == nullptr || wm == nullptr) return cudaErrorInvalidValue;
  return launch_col_stage(RowsIn{static_cast<const float2*>(x), (size_t)p * (size_t)q},
                          static_cast<float2*>(y), batch, p, q, qt, st,
                          FactoredOuter{static_cast<const float2*>(wob),
                                        static_cast<const float2*>(wm), p1, p2},
                          static_cast<cudaStream_t>(stream));
}
