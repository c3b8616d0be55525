// The two-pass convolution core's column stages on K12's ragged in-place
// tiles: K14's four-stage form (ops/kernels/conv_radix.py conv_col_stage).
//
// Replaces rustfft_tpu/ops/pallas/conv_radix.py:_kernel's column half
// (called per pass by _make_pass) at every inner length m = P * Q that
// does not run the cluster passes: K12's column kernel (csrc/largepad.cuh
// largepad_col_kernel) with the source ConvPadIn, which loads [pre .] x or
// the Rader gather x[perm[j]], zero from n_in, rows ld apart (the in_shift
// core's x[:, 1:] of the raw rows, no copy), and sums each tile's raw
// values into partials[b, tile] (block_sum: a fixed order, no atomics; the
// last tile, ragged, has its own).  Pass 2's column stage is plain and
// runs K12's own source (rf_largepad_col_stage).
//
// What bounds it: the bytes (the input read once, (B, Q, P) written once)
// and, with the gather, 8-byte reads at the permutation.  The general
// kernel it replaces (csrc/large.cuh col_kernel) took tiles that divide Q
// (four columns at Q = 2916, one at 729) in two buffers and ran every radix
// without a register stage as a direct sum; here the tile is as wide as
// shared memory allows (largepad.tile(P)) whatever divides Q, in one
// buffer, and radices such as 27 run K7's Bluestein stage.
#include "conv_io.cuh"
#include "largepad.cuh"

namespace rf {

// The source: ConvIn's elements over the (P, T) tile, eight a thread in
// three steps, so that the gather's index reads, then its value reads, then
// pre's reads are each in flight together: the raw values are summed into
// the partials, then multiplied by pre.
struct ConvPadIn {
  static constexpr int kBlocks = kPadColPlainBlocks;
  ConvIn in;
  __device__ float2 load(const float2*, size_t b, int p, int q, int q0, int T,
                         float2* buf) const {
    float2 acc = make_float2(0.f, 0.f);
    const float2* __restrict__ row = in.x + b * in.ld;
    const int elems = p * T, nt = (int)blockDim.x;
    TileWalk w((int)threadIdx.x, T);
    for (int f0 = threadIdx.x; f0 < elems; f0 += kPadIo * nt) {
      int j[kPadIo], at[kPadIo];
#pragma unroll
      for (int u = 0; u < kPadIo; ++u, w.next()) {
        j[u] = w.row * q + q0 + w.col;
        at[u] = f0 + u * nt < elems && j[u] < in.n_in ? j[u] : -1;
      }
      if (in.perm != nullptr) {
#pragma unroll
        for (int u = 0; u < kPadIo; ++u)
          if (at[u] >= 0) at[u] = __ldg(&in.perm[j[u]]);
      }
      float2 v[kPadIo];
#pragma unroll
      for (int u = 0; u < kPadIo; ++u) {
        v[u] = at[u] >= 0 ? row[at[u]] : make_float2(0.f, 0.f);
        acc.x += v[u].x;
        acc.y += v[u].y;
      }
      if (in.pre != nullptr) {
#pragma unroll
        for (int u = 0; u < kPadIo; ++u)
          if (at[u] >= 0) v[u] = cmul(v[u], __ldg(&in.pre[j[u]]));
      }
#pragma unroll
      for (int u = 0; u < kPadIo; ++u) {
        const int f = f0 + u * nt;
        if (f < elems) buf[swz(f)] = v[u];
      }
    }
    return acc;
  }
  __device__ void finish(size_t b, int tile, int tiles, float2 acc) const {
    in.finish(b, tile, tiles, acc);
  }
};

}  // namespace rf

// x: (batch, n_in) complex64, rows ld >= n_in apart, n_in <= P*Q; y:
// (batch, Q, P); partials: (batch, ceil(Q/qt)) or NULL; the chain of DFT_P
// (ops/kernels/fused.py chain_args: Bluestein lengths up to 1024); tw_outer
// (Q, P); pre (P*Q,) or NULL; perm (P*Q,) int32 or NULL (needs n_in ==
// P*Q); tiles of qt columns, the last one ragged.  Returns a cudaError_t
// code; launches on `stream`.
extern "C" int rf_conv_pad_col_stage(const void* x, void* y, void* partials, long long batch,
                                     int n_in, long long ld, int p, int q, int qt, int k, int r0,
                                     int r1, int r2, const void* roots0, const void* roots1,
                                     const void* roots2, const void* tw0, const void* tw1, int m0,
                                     int m1, int m2, const void* tw_outer, const void* pre,
                                     const void* perm, void* stream) {
  using namespace rf;
  const Stages st = pad_chain(k, r0, r1, r2, roots0, roots1, roots2, tw0, tw1, m0, m1, m2);
  if (x == nullptr || tw_outer == nullptr || n_in <= 0 || ld < n_in ||
      (long long)n_in > (long long)p * q || (perm != nullptr && n_in != p * q) ||
      !pad_ok(batch, p, q, qt, st, kPadColMaxM) ||
      pad_smem_bytes(p, qt, st) + 32 * sizeof(float2) > kSmemMax)  // + block_sum's
    return cudaErrorInvalidValue;
  const ConvPadIn src{ConvIn{static_cast<const float2*>(x), static_cast<const float2*>(pre),
                             static_cast<const int*>(perm), static_cast<float2*>(partials), n_in,
                             (size_t)ld}};
  const auto* tx = static_cast<const float2*>(x);
  auto* ty = static_cast<float2*>(y);
  const auto* to = static_cast<const float2*>(tw_outer);
  const auto s = static_cast<cudaStream_t>(stream);
  if (has_bluestein(st))
    return launch_pad_col<ConvPadIn, kPadColMaxM, false>(tx, ty, batch, p, q, qt, st, to, nullptr,
                                                         src, s);
  return launch_pad_col<ConvPadIn, 0, false>(tx, ty, batch, p, q, qt, st, to, nullptr, src, s);
}
