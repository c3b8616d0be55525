// B_conv of the fused large Bluestein's tile form at the inner lengths m =
// 256 * Q, Q in {1536, 1728, 2048, 2304, 3072, 4096, 6144}: the port of
// rustfft_tpu/ops/pallas/convlarge.py:_kernel_bconv there (K15;
// ops/kernels/convlarge.py bconv_row_tile).  Q = 8192 has its own kernel
// (csrc/convlarge.cu bconv_tile_kernel), whose design this generalises.
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
// 2 KiB apart, which a copy alone ran at 3x a streaming copy.
//
// Design, per form (with_form below: the chain (R0, R1, R2[, R3]) of
// register radices and T, the most columns whose tile fits two 256-thread
// blocks an SM): a persistent grid, block g walking the units g, g + grid, ...
// (batch rows fastest, ops/kernels/convlarge.py bconv_unit, so that the
// blocks at work share one or two units' slices of h and outer).  The unit
// lands by 16-byte cp.async in plain order, buf[t*Q + e]; then, in place in
// ONE buffer (a stage's column writes its outputs where it read its inputs,
// so a thread computes its columns one after another and a stage needs no
// barrier inside it):
//  - chain 1, the DIF chain (R0, R1, R2[, R3]) over the natural input, stage
//    s on the position digit of weight W_s = Q / (R0..Rs), leaves X[k], k =
//    k_0 + R0*k_1 + R0*R1*k_2 (+ R0*R1*R2*k_3), digit-reversed at position
//    sum k_s*W_s; its last stage multiplies by h, which the host stores in
//    that order (convlarge.bconv_h_table), and conjugates;
//  - chain 2 takes the radices reversed, the position digits of weight 1,
//    W_{S-2}, ..., W_0 in turn (its twiddle columns laid out by the digits
//    above the stage, convlarge.bconv_chain_tables), and leaves l at
//    position l, natural order; its last stage stores times outer;
//  - then the next unit's copies start, and the SM's other block computes
//    while they land.
// Every stage runs its radix in registers (dft_column: radix-2 layers for
// 8 and 16, the direct sum for 3, 6, 9, 12).  The first stage reads the
// unit as cp.async wrote it and writes it swizzled: W_0 is a multiple of 16,
// so the 16 values of a swizzle group are read by one warp, before its
// __syncwarp, and written after it.
#include "tile_walk.cuh"

namespace rf {

constexpr int kBcgThreads = 256;

// The tables in device memory: each stage's roots (chain 1's radices in
// order; chain 2 reads the same ones), chain 1's twiddles (R_s, W_s) of
// every stage but the last, and chain 2's (R, REST) with their columns by
// the position digits above the stage (ops/kernels/convlarge.py
// bconv_chain_tables).
struct BcgTables {
  const float2* roots[4];
  const float2* tw1[3];
  const float2* tw2[3];
};

// One in-place stage of radix R over the position digit of weight W of each
// of the unit's T columns of Q: column (t, hi, lo) holds the values at
// t*Q + hi*R*W + j*W + lo, j < R; this thread's columns are c = tid + 256*i.
// Output k goes where input k was read, times tw[k*REST + lo] (chain 1) or
// tw[k*REST + hi] (kByHi: chain 2) where tw is not null, through
// dst.store(element, v).  The reads are swizzled unless kLanded (the unit as
// cp.async wrote it).
template <int Q, int T, int R, int W, int REST, bool kByHi, bool kLanded, class Dst>
static __device__ __forceinline__ void bcg_stage(int tid, const float2* buf, const Dst& dst,
                                                 const float2* __restrict__ roots,
                                                 const float2* __restrict__ tw) {
  constexpr int kPer = Q / R;
  constexpr int kCols = T * kPer;
  static_assert(Q % (R * W) == 0 && kCols % 32 == 0, "whole warps a stage");
  static_assert(!kLanded || W % 16 == 0, "a swizzle group within one warp's columns");
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
    const int col = kByHi ? hi : lo;
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
// group.
template <int kElems>
static __device__ __forceinline__ void bcg_copy(float2* buf, const float2* __restrict__ src) {
  static_assert(kElems % (2 * kBcgThreads) == 0, "whole 16-byte copies a thread");
  const int c = opaque_int(threadIdx.x);
#pragma unroll 4
  for (int i = 0; i < kElems / 2 / kBcgThreads; ++i) {
    const int piece = (c + kBcgThreads * i) * 2;
    cp_async16(buf + piece, src + piece);
  }
  cp_async_commit();
}

template <int T, int R0, int R1, int R2, int R3, bool kStamp>
__global__ void __launch_bounds__(kBcgThreads, 2)
    bconv_cols_kernel(const float2* __restrict__ x, float2* __restrict__ y, unsigned batch,
                      unsigned units, unsigned groups, BcgTables tb, const float2* __restrict__ h,
                      const float2* __restrict__ outer, unsigned long long* stamps) {
  constexpr int Q = R0 * R1 * R2 * R3;
  constexpr int kElems = T * Q;
  constexpr int W0 = Q / R0, W1 = W0 / R1, W2 = W1 / R2;
  PhaseClock<kStamp, 3> clock;
  clock.begin();
  extern __shared__ float4 bcg_smem[];
  float2* buf = reinterpret_cast<float2*>(bcg_smem);
  float2* r0 = buf + kElems;  // each stage's roots, back to back
  float2* r1 = r0 + R0;
  float2* r2 = r1 + R1;
  float2* r3 = r2 + R2;
  unsigned u = blockIdx.x;
  size_t table;
  if (u < units) bcg_copy<kElems>(buf, x + bcg_offset<kElems>(u, batch, groups, &table));
  for (int i = threadIdx.x; i < R0; i += kBcgThreads) r0[i] = tb.roots[0][i];
  for (int i = threadIdx.x; i < R1; i += kBcgThreads) r1[i] = tb.roots[1][i];
  for (int i = threadIdx.x; i < R2; i += kBcgThreads) r2[i] = tb.roots[2][i];
  if constexpr (R3 > 1)
    for (int i = threadIdx.x; i < R3; i += kBcgThreads) r3[i] = tb.roots[3][i];
  for (; u < units; u += gridDim.x) {
    const size_t at = bcg_offset<kElems>(u, batch, groups, &table);
    const BcgTile tile{buf};
    cp_async_wait<0>();
    __syncthreads();
    // chain 1: FFT_Q over j2 -> k2 (digit-reversed), then conj(. * h)
    bcg_stage<Q, T, R0, W0, W0, false, true>(opaque_int(threadIdx.x), buf, tile, r0,
                                            opaque_ptr(tb.tw1[0]));
    __syncthreads();
    if constexpr (R3 > 1) {
      bcg_stage<Q, T, R1, W1, W1, false, false>(opaque_int(threadIdx.x), buf, tile, r1,
                                               opaque_ptr(tb.tw1[1]));
      __syncthreads();
      bcg_stage<Q, T, R2, W2, W2, false, false>(opaque_int(threadIdx.x), buf, tile, r2,
                                               opaque_ptr(tb.tw1[2]));
      __syncthreads();
      bcg_stage<Q, T, R3, 1, 1, false, false>(opaque_int(threadIdx.x), buf,
                                             BcgTimesH{buf, opaque_ptr(h) + table}, r3, nullptr);
    } else {
      bcg_stage<Q, T, R1, W1, W1, false, false>(opaque_int(threadIdx.x), buf, tile, r1,
                                               opaque_ptr(tb.tw1[1]));
      __syncthreads();
      bcg_stage<Q, T, R2, 1, 1, false, false>(opaque_int(threadIdx.x), buf,
                                             BcgTimesH{buf, opaque_ptr(h) + table}, r2, nullptr);
    }
    clock.lap(0);
    __syncthreads();
    // chain 2, in the same direction: FFT_Q over k2 -> l1 (natural order),
    // the radices reversed, the last stage storing times outer
    const BcgStore out{y + at, opaque_ptr(outer) + table};
    if constexpr (R3 > 1) {
      bcg_stage<Q, T, R3, 1, Q / R3, true, false>(opaque_int(threadIdx.x), buf, tile, r3,
                                                 opaque_ptr(tb.tw2[0]));
      __syncthreads();
      bcg_stage<Q, T, R2, W2, R0 * R1, true, false>(opaque_int(threadIdx.x), buf, tile, r2,
                                                   opaque_ptr(tb.tw2[1]));
      __syncthreads();
      bcg_stage<Q, T, R1, W1, R0, true, false>(opaque_int(threadIdx.x), buf, tile, r1,
                                              opaque_ptr(tb.tw2[2]));
    } else {
      bcg_stage<Q, T, R2, 1, Q / R2, true, false>(opaque_int(threadIdx.x), buf, tile, r2,
                                                 opaque_ptr(tb.tw2[0]));
      __syncthreads();
      bcg_stage<Q, T, R1, W1, R0, true, false>(opaque_int(threadIdx.x), buf, tile, r1,
                                              opaque_ptr(tb.tw2[1]));
    }
    clock.lap(1);
    __syncthreads();
    bcg_stage<Q, T, R0, W0, 1, true, false>(opaque_int(threadIdx.x), buf, out, r0, nullptr);
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

// One form: the chain (R0, R1, R2[, R3]; R3 = 1 for three stages) and T
// columns a unit.
template <int T, int R0, int R1, int R2, int R3>
struct BcgForm {
  static constexpr int kQ = R0 * R1 * R2 * R3;
  static constexpr int kStages = R3 > 1 ? 4 : 3;
  static bool matches(int k, const int* r, int t) {
    const int want[4] = {R0, R1, R2, R3};
    if (k != kStages || t != T) return false;
    for (int s = 0; s < k; ++s)
      if (r[s] != want[s]) return false;
    return true;
  }
  static size_t smem() {
    return (size_t)(T * kQ + R0 + R1 + R2 + (R3 > 1 ? R3 : 0)) * sizeof(float2);
  }
  template <bool kStamp>
  static auto kernel() {
    return bconv_cols_kernel<T, R0, R1, R2, R3, kStamp>;
  }
};

// The forms, by Q (ops/kernels/convlarge.py COLUMN_FORMS): every first
// radix leaves W_0 a multiple of 16.  f(form) for the form of q, or
// cudaErrorInvalidValue where q has none.
template <class F>
static int with_form(int q, F f) {
  switch (q) {
    case 1536: return f(BcgForm<8, 6, 16, 16, 1>{});
    case 1728: return f(BcgForm<8, 12, 16, 9, 1>{});
    case 2048: return f(BcgForm<4, 8, 16, 16, 1>{});
    case 2304: return f(BcgForm<4, 9, 16, 16, 1>{});
    case 3072: return f(BcgForm<4, 12, 16, 16, 1>{});
    case 4096: return f(BcgForm<2, 16, 16, 16, 1>{});
    case 6144: return f(BcgForm<2, 3, 8, 16, 16>{});
    default: return cudaErrorInvalidValue;
  }
}

// rf_bconv_cols' checks and launch; the stamped form where kStamp.
template <bool kStamp>
static int bconv_cols(const void* x, void* y, long long batch, int p, int q, int k,
                      const int* radices, int t, const BcgTables& tb, const void* h,
                      const void* outer, long long grid, unsigned long long* stamps,
                      void* stream) {
  if (batch <= 0 || p <= 0 || t <= 0 || p % t != 0 || h == nullptr || outer == nullptr ||
      grid < 1 || reinterpret_cast<uintptr_t>(x) % 16 != 0 || k < 3 || k > 4)
    return cudaErrorInvalidValue;
  for (int s = 0; s < k; ++s)
    if (tb.roots[s] == nullptr || (s + 1 < k && (tb.tw1[s] == nullptr || tb.tw2[s] == nullptr)))
      return cudaErrorInvalidValue;
  const long long units = batch * (p / t);
  if (grid > units || units > 0x7fffffffLL) return cudaErrorInvalidValue;
  return with_form(q, [&](auto form) -> int {
    using Form = decltype(form);
    if (!Form::matches(k, radices, t)) return cudaErrorInvalidValue;
    const auto kernel = Form::template kernel<kStamp>();
    cudaError_t err = allow_smem(kernel, Form::smem());
    if (err != cudaSuccess) return err;
    kernel<<<(unsigned)grid, kBcgThreads, Form::smem(), static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(x), static_cast<float2*>(y), (unsigned)batch,
        (unsigned)units, (unsigned)(p / t), tb, static_cast<const float2*>(h),
        static_cast<const float2*>(outer), stamps);
    return cudaGetLastError();
  });
}

static BcgTables bcg_tables(int k, const void* roots, const void* tw) {
  const auto* r = static_cast<const float2* const*>(roots);
  const auto* w = static_cast<const float2* const*>(tw);
  BcgTables tb{};
  for (int s = 0; s < k && s < 4; ++s) tb.roots[s] = r[s];
  for (int s = 0; s + 1 < k && s < 3; ++s) {
    tb.tw1[s] = w[s];
    tb.tw2[s] = w[k - 1 + s];
  }
  return tb;
}

}  // namespace rf

// B_conv of the tile form at Q in the forms above: x, y (batch, P, Q)
// complex64, x 16-byte aligned; the chain (k radices r0..r3, unused 1) and
// t columns a unit, which must be the form's; roots a host array of k
// device pointers (each stage's roots), tw of 2*(k - 1) (chain 1's
// twiddles, then chain 2's); h (P, Q) in chain 1's output positions
// (convlarge.bconv_h_table), outer (P, Q); `grid` persistent blocks
// (convlarge.bconv_grid).  Returns a cudaError_t code; launches on `stream`.
extern "C" int rf_bconv_cols(const void* x, void* y, long long batch, int p, int q, int k, int r0,
                             int r1, int r2, int r3, int t, const void* roots, const void* tw,
                             const void* h, const void* outer, long long grid, void* stream) {
  using namespace rf;
  if (roots == nullptr || tw == nullptr || k < 3 || k > 4) return cudaErrorInvalidValue;
  const int radices[4] = {r0, r1, r2, r3};
  return bconv_cols<false>(x, y, batch, p, q, k, radices, t, bcg_tables(k, roots, tw), h, outer,
                           grid, nullptr, stream);
}

// The blocks of the form of q the card holds at once, into *out.
extern "C" int rf_bconv_cols_resident(int q, int* out) {
  using namespace rf;
  return with_form(q, [&](auto form) -> int {
    using Form = decltype(form);
    return resident_blocks(Form::template kernel<false>(), kBcgThreads, Form::smem(), out);
  });
}

#ifdef RF_PHASE_STAMPS
// rf_bconv_cols through its stamped form: stamps (grid, 4) uint64
// %globaltimer nanoseconds, a block's start and that start plus the running
// sums of its phases (chain 1 with the load and h; chain 2 but its last
// stage; the last stage, the store and the next unit's copies started).
extern "C" int rf_bconv_cols_stamps(const void* x, void* y, long long batch, int p, int q, int k,
                                    int r0, int r1, int r2, int r3, int t, const void* roots,
                                    const void* tw, const void* h, const void* outer,
                                    long long grid, void* stamps, void* stream) {
  using namespace rf;
  if (stamps == nullptr || roots == nullptr || tw == nullptr || k < 3 || k > 4)
    return cudaErrorInvalidValue;
  const int radices[4] = {r0, r1, r2, r3};
  return bconv_cols<true>(x, y, batch, p, q, k, radices, t, bcg_tables(k, roots, tw), h, outer,
                          grid, static_cast<unsigned long long*>(stamps), stream);
}
#endif
