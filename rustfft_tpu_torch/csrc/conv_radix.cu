// Two-pass double-FFT convolution: the port of K14.
//
// Replaces rustfft_tpu/ops/pallas/conv_radix.py:_kernel (called once per
// pass by _make_pass): the Bluestein / Rader core
//
//   out = [post .] maybe_conj( FFT_m( conj( FFT_m([pre .] zeropad(x)) . H ) ) )
//
// for inner lengths whose transform does not fit one block (m = 65536 is
// 512 KiB).  Each FFT_m is the port's two-stage large-n pipeline (the
// column and row stages of csrc/large.cuh) at the split large.choose_pqq(m),
// m = P * Q, with the pointwise work fused into the stages' loads and stores
// (ConvIn and ConvOut below):
//
//   pass 1, column stage: load [pre .] x, or the Rader input gather x[perm[j]],
//                         and emit per-tile partial sums of the raw input;
//   pass 1, row stage:    store conj(. H) in natural order;
//   pass 2, column stage: plain;
//   pass 2, row stage:    store [conj] [. post] [+ x0], scattered by the Rader
//                         output permutation, and with full_out the DC-first
//                         layout: out[0] = x0 + sum(x), out[1 + dst[k]] = z[k].
//
// That is four launches and eight traversals of m, where the TPU made two
// launches and four traversals (one VMEM-resident FFT per pass).
//
// The JAX kernel's two options (off by default there and here):
//  - gauss_mode: every DFT stage as three real products (conv_radix.py:183,
//    :232, :266); here `gauss` runs both stages on large.cuh's general
//    kernels with every radix stage in the Gauss form (fft_tile.cuh
//    gauss_stage), the twiddles staying complex products.
//  - in_shift: pass 1 reads the raw (batch, m + 1) Rader rows instead of a
//    copy of x[:, 1:] (conv_radix.py:161, :327).  Here the column stage's
//    rows are `ld` apart (ld = m + 1 from x[:, 1:] of the raw rows) and pass
//    2 reads x0 = x[:, 0] at a stride of x0_ld; the DC bin stays x0 + the
//    partial sums of the raw input.
//
// What bounds it on this card: 8 traversals of 8 bytes per point, plus the
// radix chains of the column and row stages on the CUDA cores and the outer
// twiddle table.  The Rader gather breaks the column stage's 16-column
// (128-byte) load segments into single 8-byte reads.
//
// The DC bin comes from the f32 sum of the raw input, never from the core's
// output (the JAX package measured a 30x larger error that way).  Each
// pass-1 column block reduces its tile's raw inputs in a fixed order (warp
// shuffles, then one warp over the warp sums) into partials[b, tile]; the
// pass-2 row block that holds k1 = 0 adds the row's partials in tile order.
// No atomics, no extra kernel: the result is deterministic.
//
// The stages' compile-time kernels serve the prime path's shapes (P = 256
// over 16 columns; Q = 256, 128 or 64 over 16 columns), except that the
// Rader output scatter stays on the general row kernel: with the scatter the
// compile-time kernel measured slower (1.216 against 0.924 ms at
// 512 x 65536 on the H100), without it faster (0.410 against 0.748).
#include "large.cuh"

namespace rf {

// Sum of v over the block, valid in thread 0; blockDim.x a multiple of 32.
// Every thread of the block must call it.
static __device__ float2 block_sum(float2 v) {
  __shared__ float2 red[32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_down_sync(0xffffffffu, v.x, o);
    v.y += __shfl_down_sync(0xffffffffu, v.y, o);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : make_float2(0.f, 0.f);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      v.x += __shfl_down_sync(0xffffffffu, v.x, o);
      v.y += __shfl_down_sync(0xffffffffu, v.y, o);
    }
  }
  return v;
}

// Column-stage source: element j of row b is x[b, perm[j]] or x[b, j] (zero
// beyond n_in), times pre[j]; the raw values are summed per tile into
// partials[b, tile].
struct ConvIn {
  const float2* __restrict__ x;  // (batch, n_in), rows ld apart
  const float2* __restrict__ pre;
  const int* __restrict__ perm;
  float2* __restrict__ partials;  // (batch, Q/qt) or NULL
  int n_in;
  size_t ld;
  __device__ float2 load(size_t b, int j, float2& acc) const {
    if (j >= n_in) return make_float2(0.f, 0.f);
    const float2 v = x[b * ld + (perm != nullptr ? __ldg(&perm[j]) : j)];
    acc.x += v.x;
    acc.y += v.y;
    return pre != nullptr ? cmul(v, __ldg(&pre[j])) : v;
  }
  __device__ void finish(size_t b, int tile, int tiles, float2 acc) const {
    if (partials == nullptr) return;
    acc = block_sum(acc);
    if (threadIdx.x == 0) partials[b * tiles + tile] = acc;
  }
};

// Row-stage sink: what the row stage does with FFT_m's natural-order output
// z[k], k < n_out.
struct ConvOut {
  float2* __restrict__ y;   // (batch, ld_out)
  const float2* h;          // pass 1: z = conj(z . h[k])
  const float2* post;       // z = z . post[k]
  const float2* x0;         // (batch,), x0_ld apart: z = z + x0[b]
  const int* scatter;       // z[k] goes to position scatter[k] (else k)
  const float2* partials;   // full_out: (batch, n_partials); out[0] = x0 + sum, rest shifted by 1
  int n_partials;
  int conj_out;             // z = conj(z), after h
  int n_out;
  long long ld_out;
  long long x0_ld;

  struct Row {
    const ConvOut& ep;
    float2* __restrict__ yr;
    float2 c;
    __device__ void store(int k, float2 v) const {
      if (k >= ep.n_out) return;
      if (ep.h != nullptr) {
        v = cmul(v, __ldg(&ep.h[k]));
        v.y = -v.y;
      }
      if (ep.conj_out) v.y = -v.y;
      if (ep.post != nullptr) v = cmul(v, __ldg(&ep.post[k]));
      v.x += c.x;
      v.y += c.y;
      yr[ep.scatter != nullptr ? __ldg(&ep.scatter[k]) : k] = v;
    }
  };

  __device__ Row row(size_t b) const {
    return Row{*this, y + b * (size_t)ld_out + (partials != nullptr ? 1 : 0),
               x0 != nullptr ? x0[b * (size_t)x0_ld] : make_float2(0.f, 0.f)};
  }

  // full_out: out[b, 0] = x0[b] + the row's partial sums, added in tile order.
  __device__ void finish(size_t b, int p0) const {
    if (partials == nullptr || p0 != 0 || threadIdx.x != 0) return;
    const float2* part = partials + b * (size_t)n_partials;
    float2 sum = make_float2(0.f, 0.f);
    for (int i = 0; i < n_partials; ++i) {
      sum.x += part[i].x;
      sum.y += part[i].y;
    }
    const float2 c = x0[b * (size_t)x0_ld];
    y[b * (size_t)ld_out] = make_float2(c.x + sum.x, c.y + sum.y);
  }
};

}  // namespace rf

// x: (batch, n_in) complex64 with rows ld >= n_in apart, n_in <= P*Q; y:
// (batch, Q, P); partials: (batch, Q/qt) or NULL; gauss: roots0..2 are the
// (3, r_s) float32 Gauss tables and the stage runs in the Gauss form;
// tw_outer: (Q, P); pre: (P*Q,) or NULL; perm: (P*Q,) int32 or NULL (needs
// n_in == P*Q).  Returns a cudaError_t code.
extern "C" int rf_conv_col_stage(const void* x, void* y, void* partials, long long batch,
                                 int n_in, long long ld, int p, int q, int qt, int gauss, int k,
                                 int r0, int r1, int r2, const void* roots0, const void* roots1,
                                 const void* roots2, const void* tw0, const void* tw1,
                                 const void* tw_outer, const void* pre, const void* perm,
                                 void* stream) {
  using namespace rf;
  if (batch <= 0 || q <= 0 || qt <= 0 || q % qt != 0 || n_in <= 0 || ld < n_in ||
      (long long)n_in > (long long)p * q || (perm != nullptr && n_in != p * q))
    return cudaErrorInvalidValue;
  const Stages st = gauss ? make_gauss_stages(k, r0, r1, r2, roots0, roots1, roots2, tw0, tw1)
                          : make_stages(k, r0, r1, r2, roots0, roots1, roots2, tw0, tw1);
  if (!stages_ok(st, p, gauss) || tw_outer == nullptr) return cudaErrorInvalidValue;
  const ConvIn src{static_cast<const float2*>(x), static_cast<const float2*>(pre),
                   static_cast<const int*>(perm), static_cast<float2*>(partials), n_in,
                   (size_t)ld};
  const FullOuter outer{static_cast<const float2*>(tw_outer), p};
  float2* out = static_cast<float2*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gauss) return launch_col_gauss(src, out, batch, p, q, qt, st, outer, s);
  return launch_col_stage(src, out, batch, p, q, qt, st, outer, s);
}

// a: (batch, Q, P) complex64; y: (batch, ld_out); gauss: roots0..2 are the
// (3, r_s) float32 Gauss tables and the stage runs in the Gauss form; h,
// post: (P*Q,) or NULL; x0: (batch,) x0_ld apart, or NULL; scatter: (P*Q,)
// int32 or NULL; partials: (batch, n_partials) or NULL (full_out: needs x0
// and ld_out >= n_out + 1).  Returns a cudaError_t code; launches on
// `stream`.
extern "C" int rf_conv_row_stage(const void* a, void* y, long long batch, int q, int p, int pt,
                                 int gauss, int k, int r0, int r1, int r2, const void* roots0,
                                 const void* roots1, const void* roots2, const void* tw0,
                                 const void* tw1, const void* h, const void* post,
                                 const void* x0, long long x0_ld, const void* scatter,
                                 const void* partials, int n_partials, int conj_out, int n_out,
                                 long long ld_out, void* stream) {
  using namespace rf;
  const long long m = (long long)p * q;
  if (batch <= 0 || p <= 0 || pt <= 0 || p % pt != 0 || n_out <= 0 || n_out > m ||
      ld_out < n_out + (partials != nullptr ? 1 : 0) || x0_ld < 0 ||
      (partials != nullptr && (x0 == nullptr || n_partials <= 0)))
    return cudaErrorInvalidValue;
  const Stages st = gauss ? make_gauss_stages(k, r0, r1, r2, roots0, roots1, roots2, tw0, tw1)
                          : make_stages(k, r0, r1, r2, roots0, roots1, roots2, tw0, tw1);
  if (!stages_ok(st, q, gauss)) return cudaErrorInvalidValue;
  const ConvOut dst{static_cast<float2*>(y),           static_cast<const float2*>(h),
                    static_cast<const float2*>(post),  static_cast<const float2*>(x0),
                    static_cast<const int*>(scatter),  static_cast<const float2*>(partials),
                    n_partials, conj_out, n_out, ld_out, x0_ld};
  const float2* in = static_cast<const float2*>(a);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gauss) return launch_row_gauss(in, dst, batch, q, p, pt, st, s);
  return launch_row_stage(in, dst, batch, q, p, pt, st, scatter == nullptr, s);
}
