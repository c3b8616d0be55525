// The Gauss forms of the two-pass pipeline's stages: the port of K4's
// rustfft_tpu/ops/pallas/large.py:_kernel_a_gauss (column stage) and
// _kernel_b_gauss with fftq_sublane_gauss (row stage).
//
// The JAX bodies contract every DFT as three real products, P1 = xr.Wr,
// P2 = xi.Wi, P3 = (xr + xi).(Wr + Wi), re = P1 - P2, im = P3 - P1 - P2, which
// saves a quarter of the matrix unit's passes.  Here both stages are
// large.cuh's general kernels with every radix stage in that form
// (fft_tile.cuh gauss_stage): DFT_P and the length-Q FFT in the radix stages
// of large.stage_radices, three multiply-adds per term where the default
// kernels run radix-2 register butterflies.  The inter-stage and outer
// twiddles stay complex products, as in the JAX bodies.
//
// What bounds them on this card: the same 16 bytes per point per stage as
// K2 and K3; the Gauss arithmetic is about 6r FP32 operations per point per
// radix-r stage (at 64 x 2^20 about 0.20 ms for the column stage and 0.30 ms
// for the row stage over 67 TFLOP/s, under the 0.32 ms of bytes), with one
// 16-byte shared-memory broadcast of {Wr, Wi, Ws} per three multiply-adds on
// top.  No compile-time chain has a Gauss form, so the row stage at Q = 4096
// runs two columns per block.
#include "large.cuh"

// x: (batch, P, Q), y: (batch, Q, P), complex64; g0..g2: (3, r_s) float32
// Gauss tables of the radices of P; qt divides Q.  Returns a cudaError_t
// code; launches on `stream`.
extern "C" int rf_large_col_stage_gauss(const void* x, void* y, long long batch, int p, int q,
                                        int qt, int k, int r0, int r1, int r2, const void* g0,
                                        const void* g1, const void* g2, const void* tw0,
                                        const void* tw1, const void* tw_outer, void* stream) {
  using namespace rf;
  if (batch <= 0 || q <= 0 || qt <= 0 || q % qt != 0) return cudaErrorInvalidValue;
  const Stages st = make_gauss_stages(k, r0, r1, r2, g0, g1, g2, tw0, tw1);
  if (!stages_ok(st, p, true) || tw_outer == nullptr) return cudaErrorInvalidValue;
  return launch_col_gauss(RowsIn{static_cast<const float2*>(x), (size_t)p * (size_t)q},
                          static_cast<float2*>(y), batch, p, q, qt, st,
                          FullOuter{static_cast<const float2*>(tw_outer), p},
                          static_cast<cudaStream_t>(stream));
}

// x, y: (batch, Q, P) complex64; g0..g2: (3, r_s) float32 Gauss tables of
// the radices of Q; pt divides P.  Returns a cudaError_t code; launches on
// `stream`.
extern "C" int rf_large_row_stage_gauss(const void* x, void* y, long long batch, int q, int p,
                                        int pt, int k, int r0, int r1, int r2, const void* g0,
                                        const void* g1, const void* g2, const void* tw0,
                                        const void* tw1, void* stream) {
  using namespace rf;
  if (batch <= 0 || p <= 0 || pt <= 0 || p % pt != 0) return cudaErrorInvalidValue;
  const Stages st = make_gauss_stages(k, r0, r1, r2, g0, g1, g2, tw0, tw1);
  if (!stages_ok(st, q, true)) return cudaErrorInvalidValue;
  return launch_row_gauss(static_cast<const float2*>(x),
                          RowsOut{static_cast<float2*>(y), (size_t)q * (size_t)p}, batch, q, p,
                          pt, st, static_cast<cudaStream_t>(stream));
}
