// The row kernel of K12 (largepad.py:_kernel_b_pad) with its natural-order
// store (PadRowsOut): csrc/largepad.cuh has the design and the kernel.
#include "largepad.cuh"

namespace rf {

template <bool kStamp>
static int row_stage(const void* x, void* y, long long batch, int q, int p, int pt,
                     const Stages& st, unsigned long long* stamps, void* stream) {
  if (!pad_ok(batch, q, p, pt, st, kPadRowMaxM)) return cudaErrorInvalidValue;
  const auto* tx = static_cast<const float2*>(x);
  auto* ty = static_cast<float2*>(y);
  const auto s = static_cast<cudaStream_t>(stream);
  if (has_bluestein(st))
    return launch_pad_row<PadRowsOut, kPadRowMaxM, kStamp>(tx, ty, batch, q, p, pt, st, stamps,
                                                           PadRowsOut{}, s);
  return launch_pad_row<PadRowsOut, 0, kStamp>(tx, ty, batch, q, p, pt, st, stamps, PadRowsOut{},
                                               s);
}

}  // namespace rf

// x: (batch, Q, P), y: (batch, Q*P) complex64; the chain of the length-Q
// FFT (Bluestein lengths up to 512); tiles of pt columns (any pt >= 1, the
// last one ragged).  Returns a cudaError_t code; launches on `stream`.
extern "C" int rf_largepad_row_stage(const void* x, void* y, long long batch, int q, int p,
                                     int pt, int k, int r0, int r1, int r2,
                                     const void* roots0, const void* roots1, const void* roots2,
                                     const void* tw0, const void* tw1, int m0, int m1, int m2,
                                     void* stream) {
  using namespace rf;
  return row_stage<false>(
      x, y, batch, q, p, pt,
      pad_chain(k, r0, r1, r2, roots0, roots1, roots2, tw0, tw1, m0, m1, m2), nullptr, stream);
}

#ifdef RF_PHASE_STAMPS
// The row stage through its stamped form, as the column stage's
// (csrc/largepad.cu).
extern "C" int rf_largepad_row_phase_stamps(const void* x, void* y, long long batch, int q, int p,
                                            int pt, int k, int r0, int r1, int r2,
                                            const void* roots0, const void* roots1,
                                            const void* roots2, const void* tw0, const void* tw1,
                                            int m0, int m1, int m2, void* stamps, void* stream) {
  using namespace rf;
  if (stamps == nullptr) return cudaErrorInvalidValue;
  return row_stage<true>(
      x, y, batch, q, p, pt,
      pad_chain(k, r0, r1, r2, roots0, roots1, roots2, tw0, tw1, m0, m1, m2),
      static_cast<unsigned long long*>(stamps), stream);
}
#endif
