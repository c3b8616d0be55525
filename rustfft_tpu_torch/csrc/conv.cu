// One-pass double-FFT convolution: the port of K13 and K6.
//
// Replaces rustfft_tpu/ops/pallas/conv.py:_kernel (m = p*q with q a multiple
// of 128, m on lanes) and rustfft_tpu/ops/pallas/lanepack.py:_conv_kernel
// (any m with a radix split, m on sublanes).  Both compute the Bluestein /
// Rader core
//
//   out = [post .] maybe_conj( FFT_m( conj( FFT_m([pre .] zeropad(x)) . H ) ) )
//
// with both FFTs in the plan's direction (the conjugation trick).  The two
// TPU kernels differ only in where m sits in a vreg; the card has no
// 128-lane rule, so one kernel serves both.
//
// What bounds it on this card: one read of n_in and one write of n_out
// points per transform, plus two FFT_m chains of FP32 work on the CUDA cores
// (the lanepack chain's cost, twice) and the H table, which every block
// reads from L2.  At the prime path's shapes (m = 1008, 3072) the chains
// dominate, as in K1.
//
// Design: one block owns one transform in shared memory, on fft_tile.cuh's
// two-buffer tile (two m*8-byte buffers and the roots), so the grid is the
// batch and a ragged n_in / n_out is a per-element bound, not a tile mask.
// Load with the pre-multiply (zero beyond n_in), run the fft_tile chain,
// multiply by H and conjugate in place (H is in natural order, the order the
// chain leaves), run the chain again from that buffer, and store the first
// n_out outputs with conj and post.  The TPU kernel's [k1, k2]-transposed H,
// mirrored second factorisation, row-group trims and bf16 tables have no
// counterpart here.
#include "tile_walk.cuh"

namespace rf {

// Phase stamps of the kStamp forms (only in the library built with
// RF_PHASE_STAMPS): %globaltimer read by thread 0 of every block after a
// block barrier, stamp i of the block's row of `per` (tools/torch_phase_times.py).
template <bool kStamp>
static __device__ __forceinline__ void conv_stamp(unsigned long long* stamps, int per, int i) {
  if constexpr (kStamp) {
    __syncthreads();
    if (threadIdx.x == 0) stamps[(size_t)blockIdx.x * per + i] = walk_timer();
  }
}

// The kernel's stamps: its start and the ends of the load, chain 1, the H
// multiply, chain 2 and the store.
constexpr int kConvStamps = 6;

template <bool kStamp>
__global__ void __launch_bounds__(256) conv_fft_kernel(const float2* __restrict__ x,
                                                       float2* __restrict__ y, int n_in,
                                                       int n_out, int m, Stages st,
                                                       const float2* __restrict__ h,
                                                       const float2* __restrict__ pre,
                                                       const float2* __restrict__ post,
                                                       int conj_out,
                                                       unsigned long long* stamps) {
  conv_stamp<kStamp>(stamps, kConvStamps, 0);
  extern __shared__ float2 smem[];
  float2* a = smem;
  float2* b = smem + pad16(m);
  float2* sroots = smem + 2 * pad16(m);
  load_roots(st, sroots);
  const float2* xr = x + (size_t)blockIdx.x * (size_t)n_in;
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    float2 v = make_float2(0.f, 0.f);
    if (i < n_in) {
      v = xr[i];
      if (pre != nullptr) v = cmul(v, __ldg(&pre[i]));
    }
    a[swz(i)] = v;
  }
  __syncthreads();
  conv_stamp<kStamp>(stamps, kConvStamps, 1);
  float2* res = fft_tile(a, b, m, 1, st, sroots);
  conv_stamp<kStamp>(stamps, kConvStamps, 2);
  float2* other = res == a ? b : a;
  // z = conj(Y . H), in place: each element is read and written by one thread
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const float2 v = cmul(res[swz(i)], __ldg(&h[i]));
    res[swz(i)] = make_float2(v.x, -v.y);
  }
  __syncthreads();
  conv_stamp<kStamp>(stamps, kConvStamps, 3);
  res = fft_tile(res, other, m, 1, st, sroots);
  conv_stamp<kStamp>(stamps, kConvStamps, 4);
  float2* yr = y + (size_t)blockIdx.x * (size_t)n_out;
  for (int i = threadIdx.x; i < n_out; i += blockDim.x) {
    float2 v = res[swz(i)];
    if (conj_out) v.y = -v.y;
    if (post != nullptr) v = cmul(v, __ldg(&post[i]));
    yr[i] = v;
  }
  conv_stamp<kStamp>(stamps, kConvStamps, 5);
}

// ---- the chain form ------------------------------------------------------------
//
// conv_chain_kernel computes the same function as the kernel above on the
// chains of ops/kernels/conv.py chain_radices: lanepack.choose_radices(m),
// 1..4 radices, each a register radix or a direct sum (cc_radix_ok), never a
// Bluestein stage.  What held conv_fft_kernel back: a block for each
// transform doing the load, the chain, H, the chain and the store in turn
// (nothing hid HBM within a block), h, pre and post read from L2 by every
// transform (2.2x the signal's bytes at m = 3072), two ping-pong buffers and
// three-stage chains with direct sums of 24 and 32 at m = 6144 and 8192.
// The design follows B_conv's double chain (csrc/bconv_cols.cu):
//  - a block walks units of T = conv.chain_unit(m) transforms (g, g + grid,
//    ...: a persistent grid, conv.chain_grid).  Two buffers: while a unit
//    runs its chains, the next unit's rows land in the other buffer by
//    8-byte cp.async (a row of n_in values is only 8-byte aligned);
//  - transform t of a unit holds value e at t*msp + cc_pad(e), msp =
//    cc_pad(pad16(m)): a pad of 8 bytes every 16 values, so that a warp's
//    columns of any stage meet the banks at most twice (two wavefronts for
//    its 256 bytes) for 2 integer operations an access (the tile's XOR
//    swizzle costs 5);
//  - every stage works in place: a column of radix R over the position
//    digit of weight W holds e = hi*R*W + j*W + lo, j < R, and writes its
//    outputs where it read its inputs, so a thread computes its columns one
//    after another and a stage needs no barrier inside it;
//  - chain 1 is the DIT chain over the natural input, stage s on digit W_s
//    = m / (r_0..r_s), twiddled by (r_s, W_s)[k][lo]; its first stage reads
//    the landed rows times pre (zero from n_in: the pad is never written),
//    its last multiplies by h, which the host stores in chain 1's output
//    positions (conv.chain_h_table), and conjugates;
//  - chain 2 runs the radices reversed over the position digits W_{S-1} =
//    1, ..., W_0, twiddled by its own table's column hi (the digits above
//    the stage, conv.double_chain_tables), and leaves natural order; its
//    last stage conjugates, multiplies by post and stores the first n_out
//    outputs to device memory, lo fastest across a warp (coalesced).  Its
//    first stage runs the same radix over the same digit (weight 1), on the
//    same columns as chain 1's last: where that radix is a register radix
//    one pass does both (kCcHTwHi), so a chain of S stages makes 2S - 1
//    passes over the buffer;
//  - h, pre and post stay in shared memory for the block's life where that
//    costs no resident block (conv.chain_tables_smem), else they are read
//    through L2; the stages' roots always;
//  - the register chains run at a register cap of 80, three blocks an SM
//    where shared memory allows three (it spills a few hundred bytes).
// Every radix runs in registers: dft_column (radix-2 layers for 2, 4, 8,
// 16, the unrolled direct sum for 3, 5, 6, 7, 9, 12), and for the other
// radices of the chains (10, 11, 13 .. 23, 35) a direct sum one output
// after another, in a form of the kernel of its own so that the common
// chains do not carry its registers (kCcForms).  Every stage kind (its
// source and its sink) is a compile-time case; shared memory is addressed
// by 32-bit offsets into the one extern array (LDS / STS, not generic
// loads); columns are split into (t, hi, lo) by multiplying with
// precomputed reciprocals (fdiv), not by dividing.
constexpr int kCcThreads = 256;
constexpr int kCcMaxStages = 4;

// The kernel's forms (ops/kernels/conv.py CHAIN_FORMS): the register radices
// at three blocks an SM (the register cap 80), and the register radices
// with the direct sums at two (128).
constexpr int kCcForms = 2;
static __host__ __device__ constexpr bool cc_form_big(int form) { return form == 1; }
static __host__ __device__ constexpr int cc_form_blocks(int form) { return form == 0 ? 3 : 2; }

// The chain in the kernel's terms: chain 1's stages; chain 2 runs them in
// reverse order with tw2.
struct CcChain {
  int k;                                // stages, 1..4
  int r[kCcMaxStages];                  // radices
  int w[kCcMaxStages];                  // W_s, the digit's weight
  int per[kCcMaxStages];                // columns a transform, m / r_s
  unsigned mw[kCcMaxStages];            // fdiv's reciprocals of w and per
  unsigned mper[kCcMaxStages];
  const float2* roots[kCcMaxStages];    // (r_s,) w_{r_s}^e
  const float2* tw1[kCcMaxStages - 1];  // chain 1's (r_s, W_s)
  const float2* tw2[kCcMaxStages - 1];  // chain 2's stage t: (r, m / (r W)) by hi
};

// c / d for c * d < 2^32, from mg = ceil(2^32 / d) (mg unused at d = 1).
static __device__ __forceinline__ int fdiv(int c, int d, unsigned mg) {
  return d == 1 ? c : (int)__umulhi((unsigned)c, mg);
}

static inline unsigned fdiv_magic(int d) {
  return d <= 1 ? 0u : (unsigned)((0x100000000ULL + (unsigned long long)d - 1) / d);
}

// Value e's place in a padded region: one pad every 16 values.
static __host__ __device__ __forceinline__ int cc_pad(int e) { return e + (e >> 4); }

extern __shared__ float4 cc_smem[];

static __device__ __forceinline__ float2* cc_s() { return reinterpret_cast<float2*>(cc_smem); }

// What a stage reads: the buffer, or (chain 1's first stage) the landed rows
// times pre, zero from n_in.
enum CcIn { kCcBuf, kCcRows };
// What a stage writes: the buffer times the twiddle column lo (chain 1) or
// hi (chain 2), the buffer times h and conjugated (chain 1's last stage), or
// the output rows (chain 2's last stage); kCcHTwHi: chain 1's last stage and
// chain 2's first in one pass (both run the last radix over the digit of
// weight 1, on the same columns): conj(. * h), the DFT again in registers,
// times chain 2's twiddle column hi.
enum CcOut { kCcTwLo, kCcTwHi, kCcH, kCcStore, kCcHTwHi };

// One unit as the stages see it: shared memory by offsets (float2s from
// the start of cc_smem).  h, pre and post are read from shared memory (the
// *_s offsets, padded) where `smem` is set, else from device memory (*_g);
// pre and post are absent where their *_g pointer is null.
struct CcUnit {
  int buf;                      // the unit's buffer, transform t at buf + t*msp
  int msp, tn;                  // the transforms' stride; transforms in the unit
  int n_in, n_out, conj_out, smem;
  int h_s, pre_s, post_s;       // h in chain 1's output positions
  const float2* __restrict__ h_g;
  const float2* __restrict__ pre_g;
  const float2* __restrict__ post_g;
  float2* __restrict__ y;       // the unit's first output row
};

static __device__ __forceinline__ float2 cc_table(int smem, int s, const float2* __restrict__ g,
                                                  int e) {
  return smem ? cc_s()[s + cc_pad(e)] : __ldg(&g[e]);
}

// The direct sum of R values for a radix without a register stage: the
// outputs one after another (the roots' index advanced by k a term), so a
// 35-point column is R terms of code, not R*R; the same terms in the same
// order as dft_column's unrolled sum.
template <int R, class Sink>
static __device__ __forceinline__ void cc_direct(const float2 (&x)[R],
                                                 const float2* __restrict__ roots, Sink sink) {
#pragma unroll 1
  for (int k = 0; k < R; ++k) {
    float re = 0.f, im = 0.f;
    int e = 0;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float2 v = roots[e];
      re = fmaf(x[j].x, v.x, fmaf(-x[j].y, v.y, re));
      im = fmaf(x[j].x, v.y, fmaf(x[j].y, v.x, im));
      e += k;
      if (e >= R) e -= R;
    }
    sink(k, make_float2(re, im));
  }
}

template <int R>
struct CcRadix {
  static constexpr int value = R;
  // a register stage (lanepack.REGISTER_RADICES): dft_column, unrolled
  static constexpr bool kRegister = R <= 9 || R == 12 || R == 16;
};

// One in-place stage of radix R over the digit of weight w of the unit's
// transforms: this thread's columns c = tid, tid + kCcThreads, ... below
// tn * per, column c = (t, hi, lo) with lo fastest.
template <int R, int kIn, int kOut>
static __device__ __forceinline__ void cc_stage(const CcUnit& u, int w, int per, unsigned mw,
                                                unsigned mper, const float2* roots,
                                                const float2* __restrict__ tw, int rest) {
  float2* const sm = cc_s();
  const int cols = u.tn * per;
#pragma unroll 1
  for (int c = opaque_int(threadIdx.x); c < cols; c += kCcThreads) {
    const int t = fdiv(c, per, mper);
    const int rem = c - t * per;
    const int hi = fdiv(rem, w, mw);
    const int lo = rem - hi * w;
    const int e0 = hi * R * w + lo;
    const int col = u.buf + t * u.msp;
    float2 x[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int e = e0 + j * w;
      if constexpr (kIn == kCcBuf) {
        x[j] = sm[col + cc_pad(e)];
      } else if (e < u.n_in) {
        x[j] = sm[col + cc_pad(e)];
        if (u.pre_g != nullptr) x[j] = cmul(x[j], cc_table(u.smem, u.pre_s, u.pre_g, e));
      } else {
        x[j] = make_float2(0.f, 0.f);
      }
    }
    if constexpr (kOut == kCcHTwHi) {
      // chain 1's outputs stay in registers: output k is chain 2's input k
      float2 z[R];
      dft_column<R>(x, roots, [&](int k, float2 v) {
        v = cmul(v, cc_table(u.smem, u.h_s, u.h_g, e0 + k * w));
        z[k] = make_float2(v.x, -v.y);
      });
      dft_column<R>(z, roots, [&](int k, float2 v) {
        if (k > 0) v = cmul(v, __ldg(&tw[k * rest + hi]));
        sm[col + cc_pad(e0 + k * w)] = v;
      });
    } else {
      const auto sink = [&](int k, float2 v) {
        const int e = e0 + k * w;
        if constexpr (kOut == kCcStore) {
          if (e < u.n_out) {
            if (u.conj_out) v.y = -v.y;
            if (u.post_g != nullptr) v = cmul(v, cc_table(u.smem, u.post_s, u.post_g, e));
            u.y[(size_t)t * u.n_out + e] = v;
          }
        } else {
          if constexpr (kOut == kCcH) {
            v = cmul(v, cc_table(u.smem, u.h_s, u.h_g, e));
            v.y = -v.y;
          } else {
            if (k > 0) v = cmul(v, __ldg(&tw[k * rest + (kOut == kCcTwHi ? hi : lo)]));
          }
          sm[col + cc_pad(e)] = v;
        }
      };
      if constexpr (CcRadix<R>::kRegister) {
        dft_column<R>(x, roots, sink);
      } else {
        cc_direct<R>(x, roots, sink);
      }
    }
  }
}

// f(CcRadix<r>{}) for the radix r: the register radices, and with kBig the
// direct sums of CHAIN_RADICES (ops/kernels/conv.py; the host checks r).
template <bool kBig, class F>
static __device__ __forceinline__ void cc_with_radix(int r, F&& f) {
  switch (r) {
    case 2: f(CcRadix<2>{}); return;
    case 3: f(CcRadix<3>{}); return;
    case 4: f(CcRadix<4>{}); return;
    case 5: f(CcRadix<5>{}); return;
    case 6: f(CcRadix<6>{}); return;
    case 7: f(CcRadix<7>{}); return;
    case 8: f(CcRadix<8>{}); return;
    case 9: f(CcRadix<9>{}); return;
    case 12: f(CcRadix<12>{}); return;
    case 16: f(CcRadix<16>{}); return;
    default: break;
  }
  if constexpr (kBig) {
    switch (r) {
      case 10: f(CcRadix<10>{}); return;
      case 11: f(CcRadix<11>{}); return;
      case 13: f(CcRadix<13>{}); return;
      case 14: f(CcRadix<14>{}); return;
      case 15: f(CcRadix<15>{}); return;
      case 17: f(CcRadix<17>{}); return;
      case 18: f(CcRadix<18>{}); return;
      case 19: f(CcRadix<19>{}); return;
      case 21: f(CcRadix<21>{}); return;
      case 23: f(CcRadix<23>{}); return;
      case 35: f(CcRadix<35>{}); return;
      default: break;
    }
  }
}

// The radices of the forms (ops/kernels/conv.py CHAIN_RADICES): the register
// radices in every form, the direct sums in the big form only.
static __host__ __device__ bool cc_register_radix(int r) {
  return (r >= 2 && r <= 9) || r == 12 || r == 16;
}

static bool cc_radix_ok(int r) {
  switch (r) {
    case 10: case 11: case 13: case 14: case 15: case 17: case 18: case 19: case 21: case 23:
    case 35:
      return true;
    default:
      return cc_register_radix(r);
  }
}

// This thread's copies of unit u's rows (tn of n_in values from x) into the
// buffer at `buf`, transform t at buf + t*msp + cc_pad(i), as one cp.async
// group.
static __device__ __forceinline__ void cc_copy(int buf, const float2* __restrict__ x,
                                               long long batch, unsigned u, int T, int n_in,
                                               int msp) {
  const long long b0 = (long long)u * T;
  const int tn = (int)min((long long)T, batch - b0);
  const float2* src = x + (size_t)b0 * n_in;
  const int tid = opaque_int(threadIdx.x);
  for (int t = 0; t < tn; ++t)
    for (int i = tid; i < n_in; i += kCcThreads)
      cp_async8(cc_s() + buf + t * msp + cc_pad(i), src + (size_t)t * n_in + i);
  cp_async_commit();
}

template <int kForm, bool kStamp>
__global__ void __launch_bounds__(kCcThreads, cc_form_blocks(kForm))
    conv_chain_kernel(const float2* __restrict__ x, float2* __restrict__ y, long long batch,
                      unsigned units, int T, int n_in, int n_out, int m, CcChain ch,
                      const float2* __restrict__ h, const float2* __restrict__ pre,
                      const float2* __restrict__ post, int conj_out, int smem_tables,
                      unsigned long long* stamps) {
  constexpr bool kBig = cc_form_big(kForm);
  PhaseClock<kStamp, 3> clock;
  clock.begin();
  const int msp = cc_pad(pad16(m));
  unsigned u = blockIdx.x;
  if (u < units) cc_copy(0, x, batch, u, T, n_in, msp);
  CcUnit cu;
  cu.msp = msp;
  cu.n_in = n_in;
  cu.n_out = n_out;
  cu.conj_out = conj_out;
  cu.smem = smem_tables;
  cu.h_g = h;
  cu.pre_g = pre;
  cu.post_g = post;
  // after the two buffers: h, pre and post (for the block's life, padded as
  // the buffers are) where smem_tables, then every stage's roots
  cu.h_s = 2 * T * msp;
  cu.pre_s = cu.h_s + msp;
  cu.post_s = cu.pre_s + (pre != nullptr ? cc_pad(pad16(n_in)) : 0);
  const int roots_at =
      smem_tables ? cu.post_s + (post != nullptr ? cc_pad(pad16(n_out)) : 0) : cu.h_s;
  float2* const sm = cc_s();
  if (smem_tables) {
    for (int e = threadIdx.x; e < m; e += kCcThreads) sm[cu.h_s + cc_pad(e)] = h[e];
    if (pre != nullptr)
      for (int e = threadIdx.x; e < n_in; e += kCcThreads) sm[cu.pre_s + cc_pad(e)] = pre[e];
    if (post != nullptr)
      for (int e = threadIdx.x; e < n_out; e += kCcThreads)
        sm[cu.post_s + cc_pad(e)] = post[e];
  }
  // stage s's roots at roots_at + (r_0 + .. + r_{s-1})
  for (int s = 0, off = roots_at; s < ch.k; off += ch.r[s], ++s)
    for (int i = threadIdx.x; i < ch.r[s]; i += kCcThreads) sm[off + i] = ch.roots[s][i];
  const auto roots_of = [&](int s) {
    int off = roots_at;
    for (int i = 0; i < s; ++i) off += ch.r[i];
    return sm + off;
  };
  const int k = ch.k;
  // chain 1's last stage also runs chain 2's first where its radix is a
  // register radix and there are two stages or more
  const bool fused = k > 1 && cc_register_radix(ch.r[k - 1]);
  for (int it = 0; u < units; ++it, u += gridDim.x) {
    cp_async_wait<0>();
    // unit u is in its buffer for every thread, and the other buffer (read
    // by the last unit's chain 2) is free
    __syncthreads();
    clock.lap(0);
    const unsigned next = u + gridDim.x;
    if (next < units) cc_copy(((it + 1) & 1) * T * msp, x, batch, next, T, n_in, msp);
    const long long b0 = (long long)u * T;
    cu.buf = (it & 1) * T * msp;
    cu.tn = (int)min((long long)T, batch - b0);
    cu.y = y + (size_t)b0 * n_out;
    // chain 1 over the natural input: pre on the way in, h and conj on the
    // way out, digit-reversed
    for (int s = 0; s < k; ++s) {
      const float2* rs = roots_of(s);
      const int w = ch.w[s], per = ch.per[s];
      const unsigned mw = ch.mw[s], mper = ch.mper[s];
      const bool first = s == 0, last = s + 1 == k;
      const float2* tw = opaque_ptr(last ? ch.tw2[0] : ch.tw1[s]);
      cc_with_radix<kBig>(ch.r[s], [&](auto rc) {
        constexpr int R = decltype(rc)::value;
        if (first && last) {
          cc_stage<R, kCcRows, kCcH>(cu, w, per, mw, mper, rs, nullptr, w);
        } else if (first) {
          cc_stage<R, kCcRows, kCcTwLo>(cu, w, per, mw, mper, rs, tw, w);
        } else if (!last) {
          cc_stage<R, kCcBuf, kCcTwLo>(cu, w, per, mw, mper, rs, tw, w);
        } else if constexpr (CcRadix<R>::kRegister) {
          if (fused) cc_stage<R, kCcBuf, kCcHTwHi>(cu, w, per, mw, mper, rs, tw, per / w);
          else cc_stage<R, kCcBuf, kCcH>(cu, w, per, mw, mper, rs, nullptr, w);
        } else {
          cc_stage<R, kCcBuf, kCcH>(cu, w, per, mw, mper, rs, nullptr, w);
        }
      });
      __syncthreads();
    }
    clock.lap(1);
    // chain 2, the radices reversed over the position digits: natural
    // order, conj and post on the way out to device memory
    for (int t = fused ? 1 : 0; t < k; ++t) {
      const int s = k - 1 - t;
      const float2* rs = roots_of(s);
      const float2* tw = opaque_ptr(ch.tw2[t < kCcMaxStages - 1 ? t : 0]);
      const int w = ch.w[s], per = ch.per[s];
      const unsigned mw = ch.mw[s], mper = ch.mper[s];
      const bool last = t + 1 == k;
      cc_with_radix<kBig>(ch.r[s], [&](auto rc) {
        constexpr int R = decltype(rc)::value;
        if (last) {
          cc_stage<R, kCcBuf, kCcStore>(cu, w, per, mw, mper, rs, nullptr, 0);
        } else {
          cc_stage<R, kCcBuf, kCcTwHi>(cu, w, per, mw, mper, rs, tw, per / w);
        }
      });
      if (!last) __syncthreads();
    }
    clock.lap(2);
  }
  clock.write(stamps);
}

// Shared memory of a block (ops/kernels/conv.py chain_smem_bytes).
static size_t cc_smem_bytes(int m, int T, const CcChain& ch, int n_in, int n_out, bool has_pre,
                            bool has_post, bool smem_tables) {
  size_t values = 2 * (size_t)T * cc_pad(pad16(m));
  for (int s = 0; s < ch.k; ++s) values += ch.r[s];
  if (smem_tables)
    values += cc_pad(pad16(m)) + (has_pre ? cc_pad(pad16(n_in)) : 0) +
              (has_post ? cc_pad(pad16(n_out)) : 0);
  return values * sizeof(float2);
}

template <bool kStamp>
static auto cc_kernel(int form) {
  return form == 1 ? conv_chain_kernel<1, kStamp> : conv_chain_kernel<0, kStamp>;
}

// rf_conv_chain_fft's checks and launch; the stamped form where kStamp.
template <bool kStamp>
static int conv_chain_launch(const void* x, void* y, long long batch, int n_in, int n_out, int T,
                             int k, const int* r, const void* roots, const void* tw,
                             const void* h, const void* pre, const void* post, int conj_out,
                             int smem_tables, int form, long long grid,
                             unsigned long long* stamps, void* stream) {
  if (batch <= 0 || T <= 0 || k < 1 || k > kCcMaxStages || roots == nullptr ||
      tw == nullptr || h == nullptr || form < 0 || form >= kCcForms)
    return cudaErrorInvalidValue;
  CcChain ch{};
  ch.k = k;
  const auto* rp = static_cast<const float2* const*>(roots);
  const auto* wp = static_cast<const float2* const*>(tw);
  long long m = 1;
  for (int s = 0; s < k; ++s) {
    if (!cc_radix_ok(r[s]) || rp[s] == nullptr) return cudaErrorInvalidValue;
    if (!cc_form_big(form) && !cc_register_radix(r[s])) return cudaErrorInvalidValue;
    ch.r[s] = r[s];
    ch.roots[s] = rp[s];
    m *= r[s];
  }
  if (m > 0x7fffffffLL / 16 || n_in <= 0 || n_in > m || n_out <= 0 || n_out > m)
    return cudaErrorInvalidValue;
  long long wgt = m;
  for (int s = 0; s < k; ++s) {
    wgt /= r[s];
    ch.w[s] = (int)wgt;
    ch.per[s] = (int)(m / r[s]);
    ch.mw[s] = fdiv_magic(ch.w[s]);
    ch.mper[s] = fdiv_magic(ch.per[s]);
    if (s + 1 < k) {
      ch.tw1[s] = wp[s];
      ch.tw2[s] = wp[k - 1 + s];
      if (ch.tw1[s] == nullptr || ch.tw2[s] == nullptr) return cudaErrorInvalidValue;
    }
  }
  // fdiv is exact while c * d < 2^32: c < T * m, d <= m
  if ((long long)T * pad16((int)m) * m >= 0x100000000LL) return cudaErrorInvalidValue;
  const long long units = (batch + T - 1) / T;
  if (units > 0x7fffffffLL || grid < 1 || grid > units) return cudaErrorInvalidValue;
  const size_t smem = cc_smem_bytes((int)m, T, ch, n_in, n_out, pre != nullptr,
                                    post != nullptr, smem_tables != 0);
  const auto kernel = cc_kernel<kStamp>(form);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)grid, kCcThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(y), batch, (unsigned)units, T, n_in,
      n_out, (int)m, ch, static_cast<const float2*>(h), static_cast<const float2*>(pre),
      static_cast<const float2*>(post), conj_out, smem_tables != 0 ? 1 : 0, stamps);
  return cudaGetLastError();
}

// rf_conv_fft's checks and launch; the stamped form where kStamp.
template <bool kStamp>
static int conv_fft_launch(const void* x, void* y, long long batch, int n_in, int n_out, int m,
                           const Stages& st, const void* h, const void* pre, const void* post,
                           int conj_out, unsigned long long* stamps, void* stream) {
  if (batch <= 0 || batch > 0x7fffffffLL || n_in <= 0 || n_in > m || n_out <= 0 ||
      n_out > m || h == nullptr)
    return cudaErrorInvalidValue;
  if (!stages_ok(st, m)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* in = static_cast<const float2*>(x);
  float2* out = static_cast<float2*>(y);
  const float2* tab[3] = {static_cast<const float2*>(h), static_cast<const float2*>(pre),
                          static_cast<const float2*>(post)};
  const size_t smem = tile_smem_bytes(m, st);
  cudaError_t err = allow_smem(conv_fft_kernel<kStamp>, smem);
  if (err != cudaSuccess) return err;
  // one thread per column of the stage with the most columns (smallest radix)
  int rmin = st.r[0];
  for (int i = 1; i < st.k; ++i) rmin = st.r[i] < rmin ? st.r[i] : rmin;
  int threads = (m / rmin + 31) / 32 * 32;
  threads = threads < 64 ? 64 : (threads > 256 ? 256 : threads);
  conv_fft_kernel<kStamp><<<(unsigned)batch, threads, smem, s>>>(
      in, out, n_in, n_out, m, st, tab[0], tab[1], tab[2], conj_out, stamps);
  return cudaGetLastError();
}

}  // namespace rf

// x: (batch, n_in), y: (batch, n_out), complex64, n_in, n_out <= m; h: (m,);
// pre: (>= n_in,) or NULL; post: (>= n_out,) or NULL; roots/tw as in Stages
// for the length-m chain.  Returns a cudaError_t code; launches on `stream`.
extern "C" int rf_conv_fft(const void* x, void* y, long long batch, int n_in, int n_out,
                           int m, int k, int r0, int r1, int r2, const void* roots0,
                           const void* roots1, const void* roots2, const void* tw0,
                           const void* tw1, const void* h, const void* pre, const void* post,
                           int conj_out, void* stream) {
  using namespace rf;
  const Stages st = make_stages(k, r0, r1, r2, roots0, roots1, roots2, tw0, tw1);
  return conv_fft_launch<false>(x, y, batch, n_in, n_out, m, st, h, pre, post, conj_out,
                                nullptr, stream);
}

#ifdef RF_PHASE_STAMPS
// rf_conv_fft through its stamped form: stamps (batch, 6) uint64 (start,
// load, chain 1, H, chain 2, store), %globaltimer nanoseconds at each
// phase's end.
extern "C" int rf_conv_fft_stamps(const void* x, void* y, long long batch, int n_in, int n_out,
                                  int m, int k, int r0, int r1, int r2, const void* roots0,
                                  const void* roots1, const void* roots2, const void* tw0,
                                  const void* tw1, const void* h, const void* pre,
                                  const void* post, int conj_out, void* stamps, void* stream) {
  using namespace rf;
  if (stamps == nullptr) return cudaErrorInvalidValue;
  const Stages st = make_stages(k, r0, r1, r2, roots0, roots1, roots2, tw0, tw1);
  return conv_fft_launch<true>(x, y, batch, n_in, n_out, m, st, h, pre, post, conj_out,
                               static_cast<unsigned long long*>(stamps), stream);
}
#endif

// The chain form: x (batch, n_in), y (batch, n_out) complex64, n_in, n_out
// <= m = r0..r[k-1] (unused radices 1), T transforms a unit
// (conv.chain_unit(m)); roots a host array of k device pointers (each
// stage's roots), tw of 2k (chain 1's k - 1 twiddle tables, then chain 2's;
// conv.double_chain_tables); h (m,) in chain 1's output positions; pre
// (>= n_in,) and post (>= n_out,) or NULL; smem_tables: h, pre and post in
// shared memory; form: the kernel's form (conv.chain_kernel_form); `grid`
// persistent blocks (conv.chain_grid).  Returns a cudaError_t code;
// launches on `stream`.
extern "C" int rf_conv_chain_fft(const void* x, void* y, long long batch, int n_in, int n_out,
                                 int T, int k, int r0, int r1, int r2, int r3, const void* roots,
                                 const void* tw, const void* h, const void* pre,
                                 const void* post, int conj_out, int smem_tables, int form,
                                 long long grid, void* stream) {
  using namespace rf;
  const int r[4] = {r0, r1, r2, r3};
  return conv_chain_launch<false>(x, y, batch, n_in, n_out, T, k, r, roots, tw, h, pre, post,
                                  conj_out, smem_tables, form, grid, nullptr, stream);
}

// The blocks of the chain form `form` of `smem` bytes the card holds at
// once, into *out.
extern "C" int rf_conv_chain_resident(int form, long long smem, int* out) {
  using namespace rf;
  if (smem <= 0 || smem > (long long)kSmemMax || form < 0 || form >= kCcForms)
    return cudaErrorInvalidValue;
  return resident_blocks(cc_kernel<false>(form), kCcThreads, (size_t)smem, out);
}

#ifdef RF_PHASE_STAMPS
// rf_conv_chain_fft through its stamped form: stamps (grid, 4) uint64
// %globaltimer nanoseconds, a block's start and that start plus the running
// sums of its phases (waiting for a unit's rows; chain 1 with pre and h;
// chain 2 with the store).
extern "C" int rf_conv_chain_fft_stamps(const void* x, void* y, long long batch, int n_in,
                                        int n_out, int T, int k, int r0, int r1, int r2, int r3,
                                        const void* roots, const void* tw, const void* h,
                                        const void* pre, const void* post, int conj_out,
                                        int smem_tables, int form, long long grid,
                                        void* stamps, void* stream) {
  using namespace rf;
  if (stamps == nullptr) return cudaErrorInvalidValue;
  const int r[4] = {r0, r1, r2, r3};
  return conv_chain_launch<true>(x, y, batch, n_in, n_out, T, k, r, roots, tw, h, pre, post,
                                 conj_out, smem_tables, form, grid,
                                 static_cast<unsigned long long*>(stamps), stream);
}
#endif
