// The two-pass large-n pipeline: the ports of K2 (column stage) and K3 (row
// stage), the stages of csrc/large.cuh with plain loads and stores.
//
// The column stage replaces rustfft_tpu/ops/pallas/large.py:_kernel_a, the
// row stage large.py:_kernel_b (with fftq_sublane); large.cuh holds the
// kernels, their design and what bounds them on this card.
#include "large.cuh"

// x: (batch, P, Q), y: (batch, Q, P), complex64; P = product of the radices
// of `st`, qt divides Q.  Returns a cudaError_t code; launches on `stream`.
extern "C" int rf_large_col_stage(const void* x, void* y, long long batch, int p, int q,
                                  int qt, int k, int r0, int r1, int r2, const void* roots0,
                                  const void* roots1, const void* roots2, const void* tw0,
                                  const void* tw1, const void* tw_outer, void* stream) {
  using namespace rf;
  if (batch <= 0 || q <= 0 || qt <= 0 || q % qt != 0) return cudaErrorInvalidValue;
  const Stages st = make_stages(k, r0, r1, r2, roots0, roots1, roots2, tw0, tw1);
  if (!stages_ok(st, p) || tw_outer == nullptr) return cudaErrorInvalidValue;
  return launch_col_stage(RowsIn{static_cast<const float2*>(x), (size_t)p * (size_t)q},
                          static_cast<float2*>(y), batch, p, q, qt, st,
                          FullOuter{static_cast<const float2*>(tw_outer), p},
                          static_cast<cudaStream_t>(stream));
}

// x, y: (batch, Q, P) complex64, Q = product of the radices of `st`, pt
// divides P.  Returns a cudaError_t code; launches on `stream`.
extern "C" int rf_large_row_stage(const void* x, void* y, long long batch, int q, int p,
                                  int pt, int k, int r0, int r1, int r2, const void* roots0,
                                  const void* roots1, const void* roots2, const void* tw0,
                                  const void* tw1, void* stream) {
  using namespace rf;
  if (batch <= 0 || p <= 0 || pt <= 0 || p % pt != 0) return cudaErrorInvalidValue;
  const Stages st = make_stages(k, r0, r1, r2, roots0, roots1, roots2, tw0, tw1);
  if (!stages_ok(st, q)) return cudaErrorInvalidValue;
  return launch_row_stage(static_cast<const float2*>(x),
                          RowsOut{static_cast<float2*>(y), (size_t)q * (size_t)p}, batch, q, p,
                          pt, st, true, static_cast<cudaStream_t>(stream));
}
