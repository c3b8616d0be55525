// The two-pass large-n pipeline on ragged tiles: the port of K12.
//
// Replaces rustfft_tpu/ops/pallas/largepad.py:_kernel_a_pad (column stage)
// and _kernel_b_pad (row stage).  The TPU kernels pad Q and P to multiples
// of 128 lanes in device memory and slice after; on this card the stages of
// csrc/large.cuh take the same (B, P, Q) -> (B, Q, P) -> (B, n) passes with
// tiles that need not divide Q or P (kRagged): the column stage over 16
// columns j2 (128-byte row segments), the row stage over the widest (Q, pt)
// tile that fits shared memory.  The last tile on each axis loads zero past
// the edge and skips its stores there, so the padding lives in shared
// memory only and the intermediate stays (B, Q, P).
//
// What bounds it: four traversals of the signal (two per stage), as K2/K3.
// What it removes: at an odd Q or P the divisor rule of K2/K3 leaves one
// column per tile, so every load reads one 8-byte element per 32-byte
// sector (ops/kernels/largepad.py).
#include "large.cuh"

// x: (batch, P, Q), y: (batch, Q, P), complex64; P = product of the radices
// of `st`; any qt >= 1.  Returns a cudaError_t code; launches on `stream`.
extern "C" int rf_largepad_col_stage(const void* x, void* y, long long batch, int p, int q,
                                     int qt, int k, int r0, int r1, int r2, const void* roots0,
                                     const void* roots1, const void* roots2, const void* tw0,
                                     const void* tw1, const void* tw_outer, void* stream) {
  using namespace rf;
  if (batch <= 0 || q <= 0 || qt <= 0) return cudaErrorInvalidValue;
  const Stages st = make_stages(k, r0, r1, r2, roots0, roots1, roots2, tw0, tw1);
  if (!stages_ok(st, p) || tw_outer == nullptr) return cudaErrorInvalidValue;
  return launch_col_ragged(RowsIn{static_cast<const float2*>(x), (size_t)p * (size_t)q},
                           static_cast<float2*>(y), batch, p, q, qt, st,
                           FullOuter{static_cast<const float2*>(tw_outer), p},
                           static_cast<cudaStream_t>(stream));
}

// x: (batch, Q, P), y: (batch, Q*P) complex64, Q = product of the radices
// of `st`; any pt >= 1.  Returns a cudaError_t code; launches on `stream`.
extern "C" int rf_largepad_row_stage(const void* x, void* y, long long batch, int q, int p,
                                     int pt, int k, int r0, int r1, int r2, const void* roots0,
                                     const void* roots1, const void* roots2, const void* tw0,
                                     const void* tw1, void* stream) {
  using namespace rf;
  if (batch <= 0 || p <= 0 || pt <= 0) return cudaErrorInvalidValue;
  const Stages st = make_stages(k, r0, r1, r2, roots0, roots1, roots2, tw0, tw1);
  if (!stages_ok(st, q)) return cudaErrorInvalidValue;
  return launch_row_ragged(static_cast<const float2*>(x),
                           RowsOut{static_cast<float2*>(y), (size_t)q * (size_t)p}, batch, q, p,
                           pt, st, static_cast<cudaStream_t>(stream));
}
