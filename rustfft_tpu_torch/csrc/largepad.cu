// The column kernel of K12 (largepad.py:_kernel_a_pad) on its plain rows
// (PadRowsIn): csrc/largepad.cuh has the design and the kernel.
#include "largepad.cuh"

namespace rf {

// The column stage's checks and launch: the form without a Bluestein stage
// where the chain has none; the stamped form where kStamp.
template <bool kStamp>
static int col_stage(const void* x, void* y, long long batch, int p, int q, int qt,
                     const Stages& st, const void* outer, unsigned long long* stamps,
                     void* stream) {
  if (outer == nullptr || !pad_ok(batch, p, q, qt, st, kPadColMaxM))
    return cudaErrorInvalidValue;
  const auto* tx = static_cast<const float2*>(x);
  auto* ty = static_cast<float2*>(y);
  const auto* to = static_cast<const float2*>(outer);
  const auto s = static_cast<cudaStream_t>(stream);
  if (has_bluestein(st))
    return launch_pad_col<PadRowsIn, kPadColMaxM, kStamp>(tx, ty, batch, p, q, qt, st, to, stamps,
                                                          PadRowsIn{}, s);
  return launch_pad_col<PadRowsIn, 0, kStamp>(tx, ty, batch, p, q, qt, st, to, stamps,
                                              PadRowsIn{}, s);
}

}  // namespace rf

// x: (batch, P, Q), y: (batch, Q, P), complex64; the chain of DFT_P (the
// chain_args of ops/kernels/fused.py: Bluestein lengths up to 1024);
// tw_outer: (Q, P) w_n^(k1*j2); tiles of qt columns (any qt >= 1, the last
// one ragged).  Returns a cudaError_t code; launches on `stream`.
extern "C" int rf_largepad_col_stage(const void* x, void* y, long long batch, int p, int q,
                                     int qt, int k, int r0, int r1, int r2,
                                     const void* roots0, const void* roots1, const void* roots2,
                                     const void* tw0, const void* tw1, int m0, int m1, int m2,
                                     const void* tw_outer, void* stream) {
  using namespace rf;
  return col_stage<false>(
      x, y, batch, p, q, qt,
      pad_chain(k, r0, r1, r2, roots0, roots1, roots2, tw0, tw1, m0, m1, m2), tw_outer, nullptr,
      stream);
}

#ifdef RF_PHASE_STAMPS
// The column stage through its stamped form: stamps (blocks, kPadStamps)
// uint64 %globaltimer nanoseconds, blocks = batch * tiles.  Only the library
// built with RF_PHASE_STAMPS has it (ops/kernels/_build.py
// load(phase_stamps=True); tools/torch_phase_times.py).
extern "C" int rf_largepad_col_phase_stamps(const void* x, void* y, long long batch, int p, int q,
                                            int qt, int k, int r0, int r1, int r2,
                                            const void* roots0, const void* roots1,
                                            const void* roots2, const void* tw0, const void* tw1,
                                            int m0, int m1, int m2, const void* tw_outer,
                                            void* stamps, void* stream) {
  using namespace rf;
  if (stamps == nullptr) return cudaErrorInvalidValue;
  return col_stage<true>(
      x, y, batch, p, q, qt,
      pad_chain(k, r0, r1, r2, roots0, roots1, roots2, tw0, tw1, m0, m1, m2), tw_outer,
      static_cast<unsigned long long*>(stamps), stream);
}
#endif
