// The two-pass convolution core's row stages on K12's ragged in-place
// tiles: K14's four-stage form (ops/kernels/conv_radix.py conv_row_stage).
//
// Replaces rustfft_tpu/ops/pallas/conv_radix.py:_kernel's row half at
// every inner length that does not run the cluster passes: K12's row
// kernel (csrc/largepad.cuh largepad_row_kernel) with the sink ConvPadOut,
// csrc/conv_io.cuh's ConvOut over the tile: pass 1 stores conj(. h) in
// natural order; pass 2 [conj] [. post] [+ x0], the Rader output scatter,
// the n_out mask, and with full_out the DC-first layout whose out[0] = x0 +
// the row's partial sums (added in tile order by the block that holds k1 =
// 0), never the core's output.
//
// What bounds it: the bytes ((B, Q, P) read once, the output written
// once) and, with the scatter, 8-byte writes at the permutation.  The
// general kernel it replaces (csrc/large.cuh row_kernel) took tiles that
// divide P (one column a block at P = 243: 8-byte reads P apart) in two
// buffers and ran radices such as 27 as direct sums; here the tile is
// largepad.tile(Q) columns whatever divides P, in one buffer, on K7's
// register and Bluestein stages.
#include "conv_io.cuh"
#include "largepad.cuh"

namespace rf {

// The sink: ConvOut's row of batch row b (output k = k2*P + p0 + t), then
// ConvOut's DC bin.
struct ConvPadOut {
  ConvOut out;
  struct Row {
    ConvOut::Row row;
    int p, p0;
    __device__ void put(int k2, int t, float2 v) const { row.store(k2 * p + p0 + t, v); }
  };
  __device__ Row row(float2*, size_t b, int, int p, int p0) const {
    return Row{out.row(b), p, p0};
  }
  __device__ void finish(size_t b, int p0) const { out.finish(b, p0); }
};

}  // namespace rf

// a: (batch, Q, P) complex64; y: (batch, ld_out); the chain of the
// length-Q FFT (Bluestein lengths up to 512); h, post: (P*Q,) or NULL; x0:
// (batch,) x0_ld apart, or NULL; scatter: (P*Q,) int32 or NULL (needs n_out
// == P*Q); partials: (batch, n_partials) or NULL (full_out: needs x0 and
// ld_out >= n_out + 1); tiles of pt columns, the last one ragged.  Returns a
// cudaError_t code; launches on `stream`.
extern "C" int rf_conv_pad_row_stage(const void* a, void* y, long long batch, int q, int p, int pt,
                                     int k, int r0, int r1, int r2, const void* roots0,
                                     const void* roots1, const void* roots2, const void* tw0,
                                     const void* tw1, int m0, int m1, int m2, const void* h,
                                     const void* post, const void* x0, long long x0_ld,
                                     const void* scatter, const void* partials, int n_partials,
                                     int conj_out, int n_out, long long ld_out, void* stream) {
  using namespace rf;
  const long long m = (long long)p * q;
  const Stages st = pad_chain(k, r0, r1, r2, roots0, roots1, roots2, tw0, tw1, m0, m1, m2);
  if (a == nullptr || y == nullptr || n_out <= 0 || n_out > m ||
      ld_out < n_out + (partials != nullptr ? 1 : 0) || x0_ld < 0 ||
      (scatter != nullptr && n_out != m) ||
      (partials != nullptr && (x0 == nullptr || n_partials <= 0)) ||
      !pad_ok(batch, q, p, pt, st, kPadRowMaxM))
    return cudaErrorInvalidValue;
  const ConvPadOut sink{ConvOut{static_cast<float2*>(y),          static_cast<const float2*>(h),
                                static_cast<const float2*>(post), static_cast<const float2*>(x0),
                                static_cast<const int*>(scatter), static_cast<const float2*>(partials),
                                n_partials, conj_out, n_out, ld_out, x0_ld}};
  const auto* tx = static_cast<const float2*>(a);
  auto* ty = static_cast<float2*>(y);
  const auto s = static_cast<cudaStream_t>(stream);
  if (has_bluestein(st))
    return launch_pad_row<ConvPadOut, kPadRowMaxM, false>(tx, ty, batch, q, p, pt, st, nullptr,
                                                          sink, s);
  return launch_pad_row<ConvPadOut, 0, false>(tx, ty, batch, q, p, pt, st, nullptr, sink, s);
}
