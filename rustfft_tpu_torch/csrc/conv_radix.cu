// Two-pass double-FFT convolution: the port of K14.
//
// Replaces rustfft_tpu/ops/pallas/conv_radix.py:_kernel (called once per
// pass by _make_pass): the Bluestein / Rader core
//
//   out = [post .] maybe_conj( FFT_m( conj( FFT_m([pre .] zeropad(x)) . H ) ) )
//
// for inner lengths whose transform does not fit one block (m = 65536 is
// 512 KiB), in two of its three forms (ops/kernels/conv_radix.py):
//
//  - the cluster passes (below), at m = r*16384, r = 1, 2, 4, 8, 16: each
//    FFT_m one launch of csrc/radix.cuh's body;
//  - the four stages in the Gauss form (config.conv_radix_gauss, the JAX
//    kernel's gauss_mode: every DFT stage as three real products,
//    conv_radix.py:183, :232, :266): csrc/large.cuh's general column and
//    row kernels with every radix stage in the Gauss form (fft_tile.cuh
//    gauss_stage), the twiddles staying complex products, and the core's
//    source and sink (csrc/conv_io.cuh ConvIn, ConvOut).
//
// The four stages' default form runs K12's ragged in-place tiles with the
// same source and sink (csrc/conv_pad.cu, csrc/conv_pad_row.cu).  The one
// launch of the default form left here is the column stage on
// csrc/large.cuh's kernels (the compile-time kernel at P = 256 over 16
// columns, else the general one; tiles that divide Q), which the fused
// large Bluestein's general form runs as its kernel A at Q below 1536
// (ops/kernels/convlarge.py).  In every form:
//
//   pass 1, column stage: load [pre .] x, or the Rader input gather x[perm[j]],
//                         and emit per-tile partial sums of the raw input;
//   pass 1, row stage:    store conj(. H) in natural order;
//   pass 2, column stage: plain;
//   pass 2, row stage:    store [conj] [. post] [+ x0], scattered by the Rader
//                         output permutation, and with full_out the DC-first
//                         layout: out[0] = x0 + sum(x), out[1 + dst[k]] = z[k].
//
// The JAX kernel's in_shift (off by default there and here): pass 1 reads
// the raw (batch, m + 1) Rader rows instead of a copy of x[:, 1:]
// (conv_radix.py:161, :327).  Here the column stage's rows are `ld` apart
// (ld = m + 1 from x[:, 1:] of the raw rows) and pass 2 reads x0 = x[:, 0]
// at a stride of x0_ld; the DC bin stays x0 + the partial sums of the raw
// input.
//
// The DC bin comes from the f32 sum of the raw input, never from the core's
// output (the JAX package measured a 30x larger error that way).  Each
// pass-1 column block reduces its tile's raw inputs in a fixed order (warp
// shuffles, then one warp over the warp sums) into partials[b, tile]; the
// pass-2 row block that holds k1 = 0 adds the row's partials in tile order.
// No atomics, no extra kernel: the result is deterministic.
#include "conv_io.cuh"
#include "large.cuh"
#include "radix.cuh"
#include "tile_walk.cuh"

namespace rf {

// ---- the cluster passes: the core on the radix body ------------------------
//
// At m = R*16384 (R = 1, 2, 4, 8, 16: K9's sizes, ops/kernels/conv_radix.py
// cluster_form) each FFT_m is one launch of csrc/radix.cuh's body, a
// persistent grid of clusters of R blocks, one transform of m points a
// cluster at a time, with the pointwise work in its load and store, as the
// TPU kernel does in one VMEM-resident FFT a pass:
//   pass 1 (RadixConvIn): the slice lands by 8-byte cp.async of x[perm[j]]
//     or x[j], zero from n_in (rows ld apart, any alignment), the next
//     transform's rows as stage B frees them, as K9's bulk copies do;
//     stage A multiplies by pre as it reads, and block a of a cluster sums
//     its slice's raw values into partials[t, a] (block_sum: fixed order,
//     no atomics); stage B stores conj(. * h[k]) in natural order;
//   pass 2 (RadixConvOut): K9's load (bulk copies, the next transform's
//     under stage B); stage B stores [conj] [. post] [+ x0], with the Rader
//     scatter as 8-byte stores at scatter[k], and with full_out block 0
//     writes out[0] = x0 + the R partials added in order.
// Two launches and four traversals of m, where the column and row stages
// above make four and eight.

struct RadixConvIn {
  static constexpr bool kBulk = false;
  const float2* __restrict__ x;  // (batch, n_in), rows ld apart
  const float2* __restrict__ pre;
  const int* __restrict__ perm;
  const float2* __restrict__ h;   // (m,)
  float2* __restrict__ partials;  // (batch, r) or NULL
  int n_in;
  int r;
  long long ld;
  // The rows b = j0*8 + j1 (j0 < 16, j1 = 2*pair, 2*pair + 1) of slice a:
  // element j = b*r*128 + a*128 + col from x[t, perm[j]] (or x[t, j]) by
  // 8-byte copies, zero from n_in; 8 a thread.
  __device__ void copy_pair(long long t, int a, int pair, float2* buf) const {
    const float2* __restrict__ row = x + t * ld;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int idx = i * kFusedThreads + (int)threadIdx.x;
      const int b = (idx >> 7 & 15) * kChunks + 2 * pair + (idx >> 11);
      const int col = idx & (kSlice - 1);
      const int j = b * r * kSlice + a * kSlice + col;
      float2* dst = buf + b * kSlice + col;
      if (j < n_in) cp_async8(dst, row + (perm != nullptr ? __ldg(&perm[j]) : j));
      else *dst = make_float2(0.f, 0.f);
    }
    cp_async_commit();
  }
  __device__ void wait() const { cp_async_wait<0>(); }
  __device__ float2 take(int j, float2 v, float2& acc) const {
    acc.x += v.x;
    acc.y += v.y;
    return pre != nullptr ? cmul(v, __ldg(&pre[j])) : v;
  }
  __device__ void sum(long long t, int a, float2 acc) const {
    if (partials == nullptr) return;
    acc = block_sum(acc);
    if (threadIdx.x == 0) partials[t * r + a] = acc;
  }
  __device__ void finish(long long, int) const {}
  struct Row {
    float2* __restrict__ z;
    const float2* __restrict__ h;
    int k0;
    __device__ void store(int i, float2 v) const {
      const int k = i + k0;
      v = cmul(v, __ldg(&h[k]));
      z[k] = make_float2(v.x, -v.y);
    }
  };
  template <int N>
  __device__ Row row(float2* y, long long t, int a) const {
    return Row{y + t * N, h, a * kSlice};
  }
};

struct RadixConvOut {
  static constexpr bool kBulk = true;
  float2* __restrict__ out;        // (batch, ld_out)
  const float2* __restrict__ post;  // z = z . post[k]
  const float2* __restrict__ x0;    // (batch,), x0_ld apart: z = z + x0[b]
  const int* __restrict__ scatter;  // z[k] goes to position scatter[k] (else k)
  const float2* __restrict__ partials;  // full_out: (batch, n_partials)
  int n_partials;
  int conj_out;
  int n_out;
  long long ld_out;
  long long x0_ld;
  __device__ void copy_pair(long long, int, int, float2*) const {}
  __device__ void wait() const {}
  __device__ float2 take(int, float2 v, float2&) const { return v; }
  __device__ void sum(long long, int, float2) const {}
  // full_out: out[t, 0] = x0[t] + the row's partial sums, added in order
  __device__ void finish(long long t, int a) const {
    if (partials == nullptr || a != 0 || threadIdx.x != 0) return;
    const float2* part = partials + t * n_partials;
    float2 sum = make_float2(0.f, 0.f);
    for (int i = 0; i < n_partials; ++i) {
      sum.x += part[i].x;
      sum.y += part[i].y;
    }
    const float2 c = x0[t * x0_ld];
    out[t * ld_out] = make_float2(c.x + sum.x, c.y + sum.y);
  }
  struct Row {
    float2* __restrict__ yr;
    const float2* __restrict__ post;
    const int* __restrict__ scatter;
    float2 c;
    int k0, n_out, conj_out;
    __device__ void store(int i, float2 v) const {
      const int k = i + k0;
      if (k >= n_out) return;
      if (conj_out) v.y = -v.y;
      if (post != nullptr) v = cmul(v, __ldg(&post[k]));
      v.x += c.x;
      v.y += c.y;
      yr[scatter != nullptr ? __ldg(&scatter[k]) : k] = v;
    }
  };
  template <int N>
  __device__ Row row(float2*, long long t, int a) const {
    return Row{out + t * ld_out + (partials != nullptr ? 1 : 0), post, scatter,
               x0 != nullptr ? x0[t * x0_ld] : make_float2(0.f, 0.f), a * kSlice, n_out,
               conj_out};
  }
};

template <int R, class Io>
static cudaError_t launch_radix_io(const float2* x, float2* y, long long batch,
                                   long long clusters, const Stages& st, const float2* t1,
                                   const float2* tn, const float2* rroots, const float2* cfac,
                                   const Io& io, cudaStream_t s) {
  if (clusters < 1 || clusters > batch || clusters * R > 0x7fffffffLL ||
      (Io::kBulk && reinterpret_cast<uintptr_t>(x) % 16 != 0))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = radix_config_of<R>(radix_io_kernel<R, Io>, cfg, attr, clusters, s);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, radix_io_kernel<R, Io>, x, y, batch, st, t1, tn, rroots, cfac,
                           io);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// One cluster pass at m = r*16384: the checks and the launch.
template <class Io>
static int radix_pass(const void* x, void* y, long long batch, long long clusters, int r,
                      const Stages& st, const void* t1, const void* tn, const void* rroots,
                      const void* cfac, const Io& io, void* stream) {
  if (batch <= 0 || t1 == nullptr || tn == nullptr || rroots == nullptr || cfac == nullptr ||
      !stages_ok(st, kSlice) || st.k != 2 || st.r[0] != 16 || st.r[1] != 8)
    return cudaErrorInvalidValue;
  const auto* tx = static_cast<const float2*>(x);
  auto* ty = static_cast<float2*>(y);
  const auto* a = static_cast<const float2*>(t1);
  const auto* b = static_cast<const float2*>(tn);
  const auto* c = static_cast<const float2*>(rroots);
  const auto* d = static_cast<const float2*>(cfac);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (r) {
    case 1: return launch_radix_io<1>(tx, ty, batch, clusters, st, a, b, c, d, io, s);
    case 2: return launch_radix_io<2>(tx, ty, batch, clusters, st, a, b, c, d, io, s);
    case 4: return launch_radix_io<4>(tx, ty, batch, clusters, st, a, b, c, d, io, s);
    case 8: return launch_radix_io<8>(tx, ty, batch, clusters, st, a, b, c, d, io, s);
    case 16: return launch_radix_io<16>(tx, ty, batch, clusters, st, a, b, c, d, io, s);
    default: return cudaErrorInvalidValue;
  }
}

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

// The row stage in the Gauss form.  a: (batch, Q, P) complex64; y: (batch,
// ld_out); g0..g2: the (3, r_s) float32 Gauss tables; h, post: (P*Q,) or
// NULL; x0: (batch,) x0_ld apart, or NULL; scatter: (P*Q,) int32 or NULL;
// partials: (batch, n_partials) or NULL (full_out: needs x0 and ld_out >=
// n_out + 1).  Returns a cudaError_t code; launches on `stream`.
extern "C" int rf_conv_row_stage_gauss(const void* a, void* y, long long batch, int q, int p,
                                       int pt, int k, int r0, int r1, int r2, const void* g0,
                                       const void* g1, const void* g2, const void* tw0,
                                       const void* tw1, const void* h, const void* post,
                                       const void* x0, long long x0_ld, const void* scatter,
                                       const void* partials, int n_partials, int conj_out,
                                       int n_out, long long ld_out, void* stream) {
  using namespace rf;
  const long long m = (long long)p * q;
  if (batch <= 0 || p <= 0 || pt <= 0 || p % pt != 0 || n_out <= 0 || n_out > m ||
      ld_out < n_out + (partials != nullptr ? 1 : 0) || x0_ld < 0 ||
      (partials != nullptr && (x0 == nullptr || n_partials <= 0)))
    return cudaErrorInvalidValue;
  const Stages st = make_gauss_stages(k, r0, r1, r2, g0, g1, g2, tw0, tw1);
  if (!stages_ok(st, q, true)) return cudaErrorInvalidValue;
  const ConvOut dst{static_cast<float2*>(y),           static_cast<const float2*>(h),
                    static_cast<const float2*>(post),  static_cast<const float2*>(x0),
                    static_cast<const int*>(scatter),  static_cast<const float2*>(partials),
                    n_partials, conj_out, n_out, ld_out, x0_ld};
  const float2* in = static_cast<const float2*>(a);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch_row_gauss(in, dst, batch, q, p, pt, st, s);
}

// Pass 1 of the cluster form at m = r*16384: x (batch, n_in) complex64,
// rows ld >= n_in apart, any 8-byte alignment; z (batch, m); partials
// (batch, r) or NULL; the DFT_128 chain (16, 8) and K9's t1, tn, rroots,
// cfac (ops/kernels/fused.py radix_tables; at r = 1 only tn is read); h
// (m,); pre (m,) or NULL; perm (m,) int32 or NULL (needs n_in == m);
// `clusters` the persistent grid (fused.radix_grid).  Returns a cudaError_t
// code; launches on `stream`.
extern "C" int rf_conv_radix_pass1(const void* x, void* z, void* partials, long long batch,
                                   int n_in, long long ld, int r, int k, int r0, int r1, int r2,
                                   const void* roots0, const void* roots1, const void* roots2,
                                   const void* tw0, const void* tw1, const void* t1,
                                   const void* tn, const void* rroots, const void* cfac,
                                   const void* h, const void* pre, const void* perm,
                                   long long clusters, void* stream) {
  using namespace rf;
  const long long m = (long long)r * kSliceElems;
  if (n_in <= 0 || ld < n_in || n_in > m || h == nullptr || (perm != nullptr && n_in != m))
    return cudaErrorInvalidValue;
  const RadixConvIn io{static_cast<const float2*>(x),   static_cast<const float2*>(pre),
                       static_cast<const int*>(perm),    static_cast<const float2*>(h),
                       static_cast<float2*>(partials),   n_in,
                       r,                                ld};
  return radix_pass(x, z, batch, clusters, r,
                    make_stages(k, r0, r1, r2, roots0, roots1, roots2, tw0, tw1), t1, tn, rroots,
                    cfac, io, stream);
}

// Pass 2 of the cluster form: z (batch, m) complex64, 16-byte aligned; y
// (batch, ld_out); post (m,) or NULL; x0 (batch,) x0_ld apart or NULL;
// scatter (m,) int32 or NULL; partials (batch, n_partials) or NULL
// (full_out: needs x0 and ld_out >= n_out + 1); the tables and grid as
// pass 1's.  Returns a cudaError_t code; launches on `stream`.
extern "C" int rf_conv_radix_pass2(const void* z, void* y, long long batch, int r, int k, int r0,
                                   int r1, int r2, const void* roots0, const void* roots1,
                                   const void* roots2, const void* tw0, const void* tw1,
                                   const void* t1, const void* tn, const void* rroots,
                                   const void* cfac, const void* post, const void* x0,
                                   long long x0_ld, const void* scatter, const void* partials,
                                   int n_partials, int conj_out, int n_out, long long ld_out,
                                   long long clusters, void* stream) {
  using namespace rf;
  const long long m = (long long)r * kSliceElems;
  if (n_out <= 0 || n_out > m || ld_out < n_out + (partials != nullptr ? 1 : 0) || x0_ld < 0 ||
      (partials != nullptr && (x0 == nullptr || n_partials <= 0)) ||
      (scatter != nullptr && n_out != m))
    return cudaErrorInvalidValue;
  const RadixConvOut io{static_cast<float2*>(y),           static_cast<const float2*>(post),
                        static_cast<const float2*>(x0),    static_cast<const int*>(scatter),
                        static_cast<const float2*>(partials), n_partials,
                        conj_out,                          n_out,
                        ld_out,                            x0_ld};
  return radix_pass(z, y, batch, clusters, r,
                    make_stages(k, r0, r1, r2, roots0, roots1, roots2, tw0, tw1), t1, tn, rroots,
                    cfac, io, stream);
}

#ifdef RF_PHASE_STAMPS
namespace rf {

// The access-pattern probe of the Rader core's gather and scatter: one
// thread an element of (batch, m) complex64.  mode 0: y[b, i] = x[b, i]
// (streaming); 1: y[b, i] = x[b, idx[i]] (8-byte reads at the permutation);
// 2: y[b, idx[i]] = x[b, i] (8-byte writes at it).
__global__ void __launch_bounds__(256)
    gather_probe_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                        const int* __restrict__ idx, int m, int mode) {
  const size_t f = (size_t)blockIdx.x * 256 + threadIdx.x;
  const size_t row = f / m * (size_t)m;
  const int i = (int)(f - row);
  if (mode == 0) y[f] = x[f];
  else if (mode == 1) y[f] = x[row + __ldg(&idx[i])];
  else y[row + __ldg(&idx[i])] = x[f];
}

}  // namespace rf

// The gather probe (gather_probe_kernel): x, y (batch, m) complex64, idx
// (m,) int32 a permutation of [0, m), batch*m a multiple of 256.
extern "C" int rf_gather_probe(const void* x, void* y, const void* idx, long long batch, int m,
                               int mode, void* stream) {
  using namespace rf;
  const long long total = batch * (long long)m;
  if (batch <= 0 || m <= 0 || total % 256 != 0 || total / 256 > 0x7fffffffLL || mode < 0 ||
      mode > 2)
    return cudaErrorInvalidValue;
  gather_probe_kernel<<<(unsigned)(total / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(y), static_cast<const int*>(idx), m,
      mode);
  return cudaGetLastError();
}
#endif
