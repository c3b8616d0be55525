// B_conv of the fused large Bluestein's tile form on columns (K15;
// ops/kernels/convlarge.py bconv_row_tile): the port of
// rustfft_tpu/ops/pallas/convlarge.py:_kernel_bconv at the inner lengths m
// = 256 * Q of convlarge.COLUMN_FORMS.  Q = 8192 has its own kernel
// (csrc/convlarge.cu bconv_tile_kernel), whose design this generalises; the
// forms live in csrc/bconv_cols.cu (Q = 1536 .. 6144 and 12288) and
// csrc/bconv_cols_small.cu (Q = 144 .. 1296), so that the two compile in
// parallel, and Q = 24576 runs the pair of blocks of csrc/bconv_pair.cu on
// the same stages.
//
// The signal is held in columns (B, P, Q) between K15's three kernels
// (csrc/convlarge.cu), so a unit of T consecutive columns k1 of one batch
// row is T*Q consecutive values, and so are its slices of h and outer (held
// the same way, (P, Q)).  Per column, B_conv computes FFT_Q over j2 -> k2,
// z = conj(X[k2] . H), FFT_Q over k2 -> l1 in the same direction, times
// w_m^(l1*k1).  What bounds it: the bytes (the unit read and written once,
// its tables read once; 1.6 GB at 64 x 1572864) and, on the CUDA cores,
// the two chains.  The general kernel it replaces (bconv_row_kernel) read
// (Q, pt) tiles of the row layout (B, Q, P): 16 bytes from each of Q rows
// 2 KiB apart, which a copy alone ran at 3x a streaming copy, and 8 bytes
// from each where pt = 1 (Q = 12288).
//
// Design, per form (BcgForm: the chain (R0, R1[, R2[, R3]]) of register
// radices and T, the most columns whose tile fits two 256-thread blocks an
// SM): a persistent grid, block g walking the units g, g + grid, ...
// (batch rows fastest, ops/kernels/convlarge.py bconv_unit, so that the
// blocks at work share one or two units' slices of h and outer).  The unit
// lands by 16-byte cp.async in plain order, buf[t*Q + e]; then, in place in
// ONE buffer (a stage's column writes its outputs where it read its inputs,
// so a thread computes its columns one after another and a stage needs no
// barrier inside it):
//  - chain 1, the DIF chain (R0, R1, ...) over the natural input, stage s
//    on the position digit of weight W_s = Q / (R0..Rs), leaves X[k], k =
//    k_0 + R0*k_1 + R0*R1*k_2 + ..., digit-reversed at position sum
//    k_s*W_s; its last stage multiplies by h, which the host stores in
//    that order (convlarge.bconv_h_table), and conjugates;
//  - chain 2 takes the radices reversed, the position digits of weight 1,
//    ..., W_0 in turn (its twiddle columns laid out by the digits above the
//    stage, convlarge.bconv_chain_tables), and leaves l at position l,
//    natural order; its last stage stores times outer;
//  - then the next unit's copies start, and the SM's other block computes
//    while they land.
// Every stage runs its radix in registers (dft_column: radix-2 layers for
// 2, 8 and 16, the direct sum for 3, 6, 9, 12).  The first stage reads the
// unit as cp.async wrote it and writes it swizzled: W_0 is a multiple of
// 16, so the 16 values of a swizzle group are read by one warp, before its
// __syncwarp, and written after it.
#pragma once

#include "tile_walk.cuh"

namespace rf {

constexpr int kBcgThreads = 256;

// The tables in device memory: each stage's roots (chain 1's radices in
// order; chain 2 reads the same ones), chain 1's twiddles (R_s, W_s) of
// every stage but the last, and chain 2's (R, REST) with their columns by
// the position digits above the stage (ops/kernels/convlarge.py
// bconv_chain_tables).  Five stages at most (Q = 24576's pair).
struct BcgTables {
  const float2* roots[5];
  const float2* tw1[4];
  const float2* tw2[4];
};

// The chain (R0, R1, R2, R3) of a form, R2 = R3 = 1 for two stages and R3
// = 1 for three: stage s's radix, position weight W_s and the product of
// the radices before it, and where its roots start in shared memory.
template <int R0, int R1, int R2, int R3>
struct BcgChain {
  static constexpr int kQ = R0 * R1 * R2 * R3;
  static constexpr int kStages = R2 == 1 ? 2 : R3 == 1 ? 3 : 4;
  static __host__ __device__ constexpr int radix(int s) {
    return s == 0 ? R0 : s == 1 ? R1 : s == 2 ? R2 : R3;
  }
  static __host__ __device__ constexpr int below(int s) {
    return s == 0 ? 1 : below(s - 1) * radix(s - 1);
  }
  static __host__ __device__ constexpr int weight(int s) { return kQ / (below(s) * radix(s)); }
  static __host__ __device__ constexpr int roots_at(int s) {
    return s == 0 ? 0 : roots_at(s - 1) + radix(s - 1);
  }
  static constexpr int kRoots = R0 + R1 + (R2 > 1 ? R2 : 0) + (R3 > 1 ? R3 : 0);
};

// One in-place stage of radix R over the position digit of weight W of each
// of the unit's T columns of Q: column (t, hi, lo) holds the values at
// t*Q + hi*R*W + j*W + lo, j < R; this thread's columns are c = tid + 256*i.
// Output k goes where input k was read, times tw[k*REST + lo] (chain 1) or
// tw[k*REST + hi0 + hi] (kByHi: chain 2; hi0 the column's digits above
// the Q values this block holds, csrc/bconv_pair.cu) where tw is not null, through
// dst.store(element, v).  The reads are swizzled unless kLanded (the unit as
// cp.async wrote it).
template <int Q, int T, int R, int W, int REST, bool kByHi, bool kLanded, class Dst>
static __device__ __forceinline__ void bcg_stage(int tid, const float2* buf, const Dst& dst,
                                                 const float2* __restrict__ roots,
                                                 const float2* __restrict__ tw, int hi0 = 0) {
  constexpr int kPer = Q / R;
  constexpr int kCols = T * kPer;
  static_assert(Q % (R * W) == 0, "the digit lies in Q");
  static_assert(!kLanded || (W % 16 == 0 && kCols % 32 == 0),
                "a swizzle group within one warp's columns, whole warps a stage");
#pragma unroll 1
  for (int c = tid; c < kCols; c += kBcgThreads) {
    const int t = c / kPer, rem = c - t * kPer;
    const int lo = rem % W, hi = rem / W;
    const int e0 = t * Q + hi * R * W + lo;
    float2 x[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int e = e0 + j * W;
      x[j] = kLanded ? buf[e] : buf[swz(e)];
    }
    if constexpr (kLanded) __syncwarp();
    const int col = kByHi ? hi0 + hi : lo;
    dft_column<R>(x, roots, [&](int k, float2 y) {
      if (tw != nullptr && k > 0) y = cmul(y, __ldg(&tw[k * REST + col]));
      dst.store(e0 + k * W, y);
    });
  }
}

// The unit, swizzled.
struct BcgTile {
  float2* buf;
  __device__ void store(int e, float2 v) const { buf[swz(e)] = v; }
};

// Chain 1's last stage: z = conj(X . h) into the unit, h its slice in
// position order.
struct BcgTimesH {
  float2* buf;
  const float2* __restrict__ h;
  __device__ void store(int e, float2 v) const {
    v = cmul(v, __ldg(&h[e]));
    buf[swz(e)] = make_float2(v.x, -v.y);
  }
};

// Chain 2's last stage: the output times outer, to device memory.
struct BcgStore {
  float2* __restrict__ y;
  const float2* __restrict__ outer;
  __device__ void store(int e, float2 v) const { y[e] = cmul(v, __ldg(&outer[e])); }
};

// Chain 1's stages from S on a unit of T columns of C::kQ values in buf
// (roots: each stage's, back to back as BcgChain::roots_at lays them out):
// stage 0 reads the unit as it landed; the last multiplies by h (its slice
// at h) and conjugates.  A block barrier between stages.
template <class C, int T, int S = 0>
static __device__ __forceinline__ void bcg_chain1(float2* buf, const float2* roots,
                                                  const BcgTables& tb,
                                                  const float2* __restrict__ h) {
  constexpr int R = C::radix(S);
  if constexpr (S == C::kStages - 1) {
    bcg_stage<C::kQ, T, R, 1, 1, false, false>(opaque_int(threadIdx.x), buf, BcgTimesH{buf, h},
                                               roots + C::roots_at(S), nullptr);
  } else {
    constexpr int W = C::weight(S);
    bcg_stage<C::kQ, T, R, W, W, false, S == 0>(opaque_int(threadIdx.x), buf, BcgTile{buf},
                                                roots + C::roots_at(S), opaque_ptr(tb.tw1[S]));
    __syncthreads();
    bcg_chain1<C, T, S + 1>(buf, roots, tb, h);
  }
}

// Chain 2's stages t = S .. kStages - 2 in place, the radices reversed;
// the last stage, radix R0 with the store, is the caller's.  A block
// barrier after each stage.
template <class C, int T, int S = 0>
static __device__ __forceinline__ void bcg_chain2(float2* buf, const float2* roots,
                                                  const BcgTables& tb) {
  if constexpr (S < C::kStages - 1) {
    constexpr int s = C::kStages - 1 - S;  // chain 1's stage of the same radix and digit
    bcg_stage<C::kQ, T, C::radix(s), C::weight(s), C::below(s), true, false>(
        opaque_int(threadIdx.x), buf, BcgTile{buf}, roots + C::roots_at(s),
        opaque_ptr(tb.tw2[S]));
    __syncthreads();
    bcg_chain2<C, T, S + 1>(buf, roots, tb);
  }
}

// Each stage's roots of the chain C into shared memory, back to back.
template <class C>
static __device__ __forceinline__ void bcg_load_roots(float2* roots, const BcgTables& tb) {
#pragma unroll
  for (int s = 0; s < C::kStages; ++s)
    for (int i = threadIdx.x; i < C::radix(s); i += kBcgThreads)
      roots[C::roots_at(s) + i] = tb.roots[s][i];
}

// Unit u: the T columns g*T .. of batch row u % batch, g = u / batch, as an
// offset into (B, P, Q) and (*table) into the tables (P, Q).
template <int kElems>
static __device__ __forceinline__ size_t bcg_offset(unsigned u, unsigned batch, unsigned groups,
                                                    size_t* table) {
  const unsigned g = u / batch;
  *table = (size_t)g * kElems;
  return ((size_t)(u - g * batch) * groups + g) * kElems;
}

// This thread's copies of a unit (kElems values at src) in plain order, one
// group: 16 bytes a copy, the last round only as wide as the copies left
// (Q = 1296: 20.25 rounds).
template <int kElems>
static __device__ __forceinline__ void bcg_copy(float2* buf, const float2* __restrict__ src) {
  static_assert(kElems % 2 == 0, "whole 16-byte copies");
  constexpr int kPieces = kElems / 2;
  const int c = opaque_int(threadIdx.x);
#pragma unroll 4
  for (int i = 0; i < kPieces / kBcgThreads; ++i) {
    const int piece = (c + kBcgThreads * i) * 2;
    cp_async16(buf + piece, src + piece);
  }
  if constexpr (kPieces % kBcgThreads != 0) {
    const int piece = c + kPieces / kBcgThreads * kBcgThreads;
    if (piece < kPieces) cp_async16(buf + 2 * piece, src + 2 * piece);
  }
  cp_async_commit();
}

template <int T, int R0, int R1, int R2, int R3, bool kStamp>
__global__ void __launch_bounds__(kBcgThreads, 2)
    bconv_cols_kernel(const float2* __restrict__ x, float2* __restrict__ y, unsigned batch,
                      unsigned units, unsigned groups, BcgTables tb, const float2* __restrict__ h,
                      const float2* __restrict__ outer, unsigned long long* stamps) {
  using C = BcgChain<R0, R1, R2, R3>;
  constexpr int kElems = T * C::kQ;
  PhaseClock<kStamp, 3> clock;
  clock.begin();
  extern __shared__ float4 bcg_smem[];
  float2* buf = reinterpret_cast<float2*>(bcg_smem);
  float2* roots = buf + kElems;  // each stage's roots, back to back
  unsigned u = blockIdx.x;
  size_t table;
  if (u < units) bcg_copy<kElems>(buf, x + bcg_offset<kElems>(u, batch, groups, &table));
  bcg_load_roots<C>(roots, tb);
  for (; u < units; u += gridDim.x) {
    const size_t at = bcg_offset<kElems>(u, batch, groups, &table);
    cp_async_wait<0>();
    __syncthreads();
    // chain 1: FFT_Q over j2 -> k2 (digit-reversed), then conj(. * h)
    bcg_chain1<C, T>(buf, roots, tb, opaque_ptr(h) + table);
    clock.lap(0);
    __syncthreads();
    // chain 2, in the same direction: FFT_Q over k2 -> l1 (natural order),
    // the radices reversed, the last stage storing times outer
    bcg_chain2<C, T>(buf, roots, tb);
    clock.lap(1);
    bcg_stage<C::kQ, T, R0, C::weight(0), 1, true, false>(
        opaque_int(threadIdx.x), buf, BcgStore{y + at, opaque_ptr(outer) + table}, roots,
        nullptr);
    __syncthreads();  // the buffer is free
    const unsigned next = u + gridDim.x;
    if (next < units) {
      size_t unused;
      bcg_copy<kElems>(buf, x + bcg_offset<kElems>(next, batch, groups, &unused));
    }
    clock.lap(2);
  }
  clock.write(stamps);
}

// One form: the chain (R0, R1[, R2[, R3]]; unused radices 1) and T columns
// a unit.
template <int T, int R0, int R1, int R2, int R3>
struct BcgForm {
  using C = BcgChain<R0, R1, R2, R3>;
  static bool matches(int k, const int* r, int t) {
    const int want[4] = {R0, R1, R2, R3};
    if (k != C::kStages || t != T) return false;
    for (int s = 0; s < k; ++s)
      if (r[s] != want[s]) return false;
    return true;
  }
  static size_t smem() { return (size_t)(T * C::kQ + C::kRoots) * sizeof(float2); }
  template <bool kStamp>
  static auto kernel() {
    return bconv_cols_kernel<T, R0, R1, R2, R3, kStamp>;
  }
};

// A launch of the column forms: the wrapper's arguments, checked by
// bcg_checks.
struct BcgArgs {
  const void* x;
  void* y;
  long long batch;
  int p, q, k;
  int radices[4];
  int t;
  BcgTables tb;
  const void* h;
  const void* outer;
  long long grid;
  unsigned long long* stamps;
  void* stream;
};

// The launch's arguments outside the form: cudaSuccess or
// cudaErrorInvalidValue.
static inline int bcg_checks(const BcgArgs& a) {
  if (a.batch <= 0 || a.p <= 0 || a.t <= 0 || a.p % a.t != 0 || a.h == nullptr ||
      a.outer == nullptr || a.grid < 1 || reinterpret_cast<uintptr_t>(a.x) % 16 != 0 ||
      a.k < 2 || a.k > 4)
    return cudaErrorInvalidValue;
  for (int s = 0; s < a.k; ++s)
    if (a.tb.roots[s] == nullptr ||
        (s + 1 < a.k && (a.tb.tw1[s] == nullptr || a.tb.tw2[s] == nullptr)))
      return cudaErrorInvalidValue;
  const long long units = a.batch * (a.p / a.t);
  if (a.grid > units || units > 0x7fffffffLL) return cudaErrorInvalidValue;
  return cudaSuccess;
}

// The launch of the form Form (the stamped kernel where kStamp).
template <class Form, bool kStamp>
static int bcg_launch(const BcgArgs& a) {
  int err0 = bcg_checks(a);
  if (err0 != cudaSuccess) return err0;
  if (!Form::matches(a.k, a.radices, a.t)) return cudaErrorInvalidValue;
  const auto kernel = Form::template kernel<kStamp>();
  cudaError_t err = allow_smem(kernel, Form::smem());
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)a.grid, kBcgThreads, Form::smem(), static_cast<cudaStream_t>(a.stream)>>>(
      static_cast<const float2*>(a.x), static_cast<float2*>(a.y), (unsigned)a.batch,
      (unsigned)(a.batch * (a.p / a.t)), (unsigned)(a.p / a.t), a.tb,
      static_cast<const float2*>(a.h), static_cast<const float2*>(a.outer), a.stamps);
  return cudaGetLastError();
}

// The launch of Form, stamped where the arguments carry stamps (the
// RF_PHASE_STAMPS library; elsewhere stamps is null).
template <class Form>
static int bcg_run(const BcgArgs& a) {
#ifdef RF_PHASE_STAMPS
  if (a.stamps != nullptr) return bcg_launch<Form, true>(a);
#endif
  return bcg_launch<Form, false>(a);
}

template <class Form>
static int bcg_resident(int* out) {
  return resident_blocks(Form::template kernel<false>(), kBcgThreads, Form::smem(), out);
}

// The forms of csrc/bconv_cols_small.cu (Q = 144 .. 1296): the launch and
// the resident blocks of the form of a.q / q, or cudaErrorInvalidValue
// where q has none there.
int bcg_small_launch(const BcgArgs& a);
int bcg_small_resident(int q, int* out);

// BcgArgs' tables from the host arrays of k roots and 2*(k - 1) twiddles.
static inline BcgTables bcg_tables(int k, const void* roots, const void* tw) {
  const auto* r = static_cast<const float2* const*>(roots);
  const auto* w = static_cast<const float2* const*>(tw);
  BcgTables tb{};
  for (int s = 0; s < k && s < 5; ++s) tb.roots[s] = r[s];
  for (int s = 0; s + 1 < k && s < 4; ++s) {
    tb.tw1[s] = w[s];
    tb.tw2[s] = w[k - 1 + s];
  }
  return tb;
}

}  // namespace rf
