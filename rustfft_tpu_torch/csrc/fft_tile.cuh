// Shared-memory multi-stage DFT used by every kernel of the port.
//
// A block holds T interleaved transforms of length m in shared memory,
// element (i, t) at buf[swz(i*T + t)], and runs the decimation-in-time chain
// of rustfft_tpu/ops/pallas/lanepack.py:_fft_sublane on them: stage s
// contracts the most significant remaining input digit j_s against DFT_{r_s},
// multiplies by the inter-stage twiddle w_{r_s*rest}^(k_s*j') and puts the
// produced digit k_s in front of those produced before it, so that the last
// stage leaves natural frequency order k = k_0 + r_0*k_1 + r_0*r_1*k_2.
//
// Layout and arithmetic, as this card sees them:
//  - Everything is FP32 on the CUDA cores (no tensor cores, no TF32).  The
//    DFT_r entries come from a table of the r roots w_r^e in shared memory:
//    W[j][k] = roots[(j*k) mod r] is the same f64-computed, f32-cast value as
//    the JAX package's dense matrix entry.
//  - Radices with a register stage (run_stage) load one column of r inputs
//    into registers per work item: powers of 2 up to 16 run an unrolled
//    radix-2 FFT (log2 r butterfly layers), 3, 5, 6, 7, 9 and 12 an unrolled
//    direct sum.  Other radices (up to 512) take fft_stage: one work item is
//    a column and a chunk of G outputs, reading its r inputs once per chunk.
//  - The Gauss form (run_stage<true>, the port of the JAX package's Gauss
//    contractions) runs every radix, 2-16 included, as gauss_stage: fft_stage's
//    work items with each output as three real sums instead of a complex one.
//    Its tables are (3, r) float rows Wr, Wi, Ws = Wr + Wi of the roots,
//    held in shared memory as one float4 per root index.  gauss_column is
//    the same arithmetic on one column in registers (the tile kernels'
//    DFT_16, its tables compile-time constants there).
//  - Stages ping-pong between two buffers (the compile-time chains at the
//    end of this file run in place in one); consecutive threads take
//    consecutive (j', t), so writes are contiguous and reads are contiguous
//    runs of rest*T elements.  Where those runs are short (the last stage)
//    the XOR swizzle below spreads the strided reads over the banks.
//  - Offsets into device memory are the callers' business and use size_t.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace rf {

constexpr int kMaxStages = 3;
constexpr int kChunk = 8;                 // outputs per work item (G)
constexpr size_t kSmemMax = 232448;       // bytes a block may use on sm_90

struct Stages {
  int k;                                  // number of stages, 1..3
  int r[kMaxStages];                      // radices, product = m
  const float2* roots[kMaxStages];        // (r_s,) w_{r_s}^e, device memory
  const float2* tw[kMaxStages - 1];       // (r_s, rest_s) twiddles, device memory
  const float* gauss[kMaxStages];         // Gauss form: (3, r_s) Wr, Wi, Ws of w_{r_s}^e
  int bm[kMaxStages];                     // K7's chains (fused.cu): the FFT length of a
                                          // Bluestein stage, whose roots[s] is then its
                                          // table; 0 elsewhere
};

static inline Stages make_stages(int k, int r0, int r1, int r2, const void* roots0,
                                 const void* roots1, const void* roots2,
                                 const void* tw0, const void* tw1) {
  Stages st;
  st.k = k;
  st.r[0] = r0; st.r[1] = r1; st.r[2] = r2;
  st.roots[0] = static_cast<const float2*>(roots0);
  st.roots[1] = static_cast<const float2*>(roots1);
  st.roots[2] = static_cast<const float2*>(roots2);
  st.tw[0] = static_cast<const float2*>(tw0);
  st.tw[1] = static_cast<const float2*>(tw1);
  st.gauss[0] = st.gauss[1] = st.gauss[2] = nullptr;
  st.bm[0] = st.bm[1] = st.bm[2] = 0;
  return st;
}

// The stages of the Gauss form: g_s the (3, r_s) float tables in place of
// the roots.
static inline Stages make_gauss_stages(int k, int r0, int r1, int r2, const void* g0,
                                       const void* g1, const void* g2, const void* tw0,
                                       const void* tw1) {
  Stages st = make_stages(k, r0, r1, r2, nullptr, nullptr, nullptr, tw0, tw1);
  st.gauss[0] = static_cast<const float*>(g0);
  st.gauss[1] = static_cast<const float*>(g1);
  st.gauss[2] = static_cast<const float*>(g2);
  return st;
}

// The stages describe a length-m transform and every table is present (the
// Gauss tables with `gauss`, else the roots).
static inline bool stages_ok(const Stages& st, int m, bool gauss = false) {
  if (st.k < 1 || st.k > kMaxStages) return false;
  long long prod = 1;
  for (int s = 0; s < st.k; ++s) {
    const void* table = gauss ? static_cast<const void*>(st.gauss[s]) : st.roots[s];
    if (st.r[s] < 2 || st.r[s] > 512 || table == nullptr) return false;
    if (s + 1 < st.k && st.tw[s] == nullptr) return false;
    prod *= st.r[s];
  }
  return prod == m;
}

static __host__ __device__ inline int roots_total(const Stages& st) {
  int total = 0;
  for (int s = 0; s < st.k; ++s) total += st.r[s];
  return total;
}

// A buffer of `elems` complex values, rounded up to whole 16-element swizzle
// groups.
static __host__ __device__ inline int pad16(int elems) { return (elems + 15) & ~15; }

// Bytes of dynamic shared memory for a tile: two buffers plus the roots
// (one float2 per root), or the Gauss tables (one float4 per root).
static inline size_t tile_smem_bytes(int elems, const Stages& st, bool gauss = false) {
  return (2 * (size_t)pad16(elems) + (gauss ? 2 : 1) * (size_t)roots_total(st)) * sizeof(float2);
}

// Bank swizzle: permutes the low 4 bits (16 x 8 bytes = one pass over the
// 32 banks) with bits 4-11 of the index, so that sixteen reads at a stride
// of 16 or 64..1024 elements land on distinct banks.  A bijection on every
// 16-aligned group.
static __device__ __forceinline__ int swz(int i) {
  return i ^ (((i >> 4) ^ (i >> 8)) & 15);
}

static __device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// Copy every stage's roots table into shared memory, back to back.
static __device__ void load_roots(const Stages& st, float2* sroots) {
  int off = 0;
  for (int s = 0; s < st.k; ++s) {
    for (int i = threadIdx.x; i < st.r[s]; i += blockDim.x) sroots[off + i] = st.roots[s][i];
    off += st.r[s];
  }
}

// Copy every stage's Gauss tables into shared memory, back to back, as
// {Wr, Wi, Ws, 0} per root index: one 16-byte broadcast read per term.
static __device__ void load_gauss(const Stages& st, float4* sg) {
  int off = 0;
  for (int s = 0; s < st.k; ++s) {
    const int r = st.r[s];
    const float* g = st.gauss[s];
    for (int i = threadIdx.x; i < r; i += blockDim.x)
      sg[off + i] = make_float4(g[i], g[r + i], g[2 * r + i], 0.f);
    off += r;
  }
}

// The stage tables a tile's chain reads: the roots, or with kGauss the
// Gauss tables (2 float2 slots per root).
template <bool kGauss>
static __device__ void load_tables(const Stages& st, float2* stables) {
  if constexpr (kGauss) {
    load_gauss(st, reinterpret_cast<float4*>(stables));
  } else {
    load_roots(st, stables);
  }
}

// One stage: in (lead, r, rest, T) -> out (r, lead, rest, T), times tw[k][j']
// when tw is not null.
static __device__ void fft_stage(const float2* __restrict__ in, float2* __restrict__ out,
                                 int r, int lead, int rest, int T,
                                 const float2* __restrict__ roots,
                                 const float2* __restrict__ tw) {
  const int step = rest * T;              // input stride of digit j
  const int ncols = lead * step;          // columns (l, j', t); also output stride of k
  const int nchunks = (r + kChunk - 1) / kChunk;
  for (int item = threadIdx.x; item < ncols * nchunks; item += blockDim.x) {
    const int chunk = item / ncols;
    const int c = item - chunk * ncols;   // c = l*step + j'*T + t
    const int l = c / step;
    const int rt = c - l * step;
    const int k0 = chunk * kChunk;
    float2 acc[kChunk];
    int e[kChunk], inc[kChunk];
#pragma unroll
    for (int g = 0; g < kChunk; ++g) {
      acc[g] = make_float2(0.f, 0.f);
      e[g] = 0;
      inc[g] = (k0 + g < r) ? k0 + g : 0;
    }
    int idx = l * r * step + rt;
    for (int j = 0; j < r; ++j) {
      const float2 a = in[swz(idx)];
      idx += step;
#pragma unroll
      for (int g = 0; g < kChunk; ++g) {
        const float2 w = roots[e[g]];
        acc[g].x = fmaf(a.x, w.x, fmaf(-a.y, w.y, acc[g].x));
        acc[g].y = fmaf(a.x, w.y, fmaf(a.y, w.x, acc[g].y));
        e[g] += inc[g];
        if (e[g] >= r) e[g] -= r;
      }
    }
    const int jr = rt / T;
#pragma unroll
    for (int g = 0; g < kChunk; ++g) {
      const int k = k0 + g;
      if (k < r) {
        float2 y = acc[g];
        if (tw != nullptr) y = cmul(y, __ldg(&tw[k * rest + jr]));
        out[swz(k * ncols + c)] = y;
      }
    }
  }
}

// fft_stage in the Gauss form (the port of the Gauss stages of
// rustfft_tpu/ops/pallas/large.py:_kernel_a_gauss, fftq_sublane_gauss and
// conv_radix.py:_kernel's gauss_mode): each output is three real sums over
// the column,
//   P1 = sum_j xr*Wr,  P2 = sum_j xi*Wi,  P3 = sum_j (xr + xi)*Ws,
//   re = P1 - P2,      im = P3 - P1 - P2,
// with {Wr, Wi, Ws} = g[(j*k) mod r], three multiply-adds per term where
// fft_stage takes four.  The twiddle after it stays a complex product.
static __device__ void gauss_stage(const float2* __restrict__ in, float2* __restrict__ out,
                                   int r, int lead, int rest, int T,
                                   const float4* __restrict__ g,
                                   const float2* __restrict__ tw) {
  const int step = rest * T;
  const int ncols = lead * step;
  const int nchunks = (r + kChunk - 1) / kChunk;
  for (int item = threadIdx.x; item < ncols * nchunks; item += blockDim.x) {
    const int chunk = item / ncols;
    const int c = item - chunk * ncols;   // c = l*step + j'*T + t
    const int l = c / step;
    const int rt = c - l * step;
    const int k0 = chunk * kChunk;
    float p1[kChunk], p2[kChunk], p3[kChunk];
    int e[kChunk], inc[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      p1[i] = p2[i] = p3[i] = 0.f;
      e[i] = 0;
      inc[i] = (k0 + i < r) ? k0 + i : 0;
    }
    int idx = l * r * step + rt;
    for (int j = 0; j < r; ++j) {
      const float2 a = in[swz(idx)];
      const float s = a.x + a.y;
      idx += step;
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const float4 w = g[e[i]];
        p1[i] = fmaf(a.x, w.x, p1[i]);
        p2[i] = fmaf(a.y, w.y, p2[i]);
        p3[i] = fmaf(s, w.z, p3[i]);
        e[i] += inc[i];
        if (e[i] >= r) e[i] -= r;
      }
    }
    const int jr = rt / T;
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int k = k0 + i;
      if (k < r) {
        float2 y = make_float2(p1[i] - p2[i], p3[i] - p1[i] - p2[i]);
        if (tw != nullptr) y = cmul(y, __ldg(&tw[k * rest + jr]));
        out[swz(k * ncols + c)] = y;
      }
    }
  }
}

// Bit reversal of k in [0, R), R a power of 2.
template <int R>
static __host__ __device__ constexpr int bitrev(int k) {
  int r = 0;
  for (int hi = R >> 1, lo = 1; hi > 0; hi >>= 1, lo <<= 1)
    if (k & lo) r |= hi;
  return r;
}

// In-register radix-2 decimation-in-frequency FFT of R = 2^m values, one
// butterfly layer per instance (HALF = R/2, R/4, ..., 1) so that every loop
// bound is a compile-time constant and x stays in registers: after it,
// x[bitrev(k)] holds X[k].  Butterfly twiddles w_R^e come from the roots
// table in shared memory (warp-broadcast reads); e = 0 multiplies by nothing.
template <int R, int HALF = R / 2>
static __device__ __forceinline__ void fft_pow2_reg(float2 (&x)[R],
                                                    const float2* __restrict__ roots) {
  if constexpr (HALF >= 1) {
#pragma unroll
    for (int blk = 0; blk < R; blk += 2 * HALF) {
#pragma unroll
      for (int i = 0; i < HALF; ++i) {
        const float2 a = x[blk + i];
        const float2 b = x[blk + i + HALF];
        x[blk + i] = make_float2(a.x + b.x, a.y + b.y);
        const float2 d = make_float2(a.x - b.x, a.y - b.y);
        constexpr int kStride = R / (2 * HALF);
        x[blk + i + HALF] = i == 0 ? d : cmul(d, roots[i * kStride]);
      }
    }
    fft_pow2_reg<R, HALF / 2>(x, roots);
  }
}

// DFT of one column of R values in registers, handing each output to
// sink(k, X[k]).  A power-of-2 R runs the radix-2 FFT above (log2 R
// butterfly layers); any other R the unrolled R x R direct sum, indexed by
// (j*k) mod R at compile time.  Either way x is indexed by constants only.
template <int R, class Sink>
static __device__ __forceinline__ void dft_column(float2 (&x)[R],
                                                  const float2* __restrict__ roots,
                                                  Sink sink) {
  if constexpr ((R & (R - 1)) == 0) {
    fft_pow2_reg<R>(x, roots);
#pragma unroll
    for (int p = 0; p < R; ++p) sink(bitrev<R>(p), x[p]);
  } else {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      float re = 0.f, im = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float2 v = roots[(j * k) % R];
        re = fmaf(x[j].x, v.x, fmaf(-x[j].y, v.y, re));
        im = fmaf(x[j].x, v.y, fmaf(x[j].y, v.x, im));
      }
      sink(k, make_float2(re, im));
    }
  }
}

// DFT of one column of R values in registers in the Gauss form, handing each
// output to sink(k, X[k]); g(e) is the float4 {Wr, Wi, Ws, 0} of root index
// e (csrc/gauss16.cuh's constants).  gauss_stage's arithmetic for one column,
// the same floats in the same order (j ascending, one fmaf per term per
// sum, s = xr + xi, re = P1 - P2, im = (P3 - P1) - P2), with the root index
// (j*k) mod R a compile-time constant after unrolling, so that constant
// tables fold into the multiply-adds.  Outputs go one at a time: three sums
// live beside the column and its R sums s.
template <int R, class Tables, class Sink>
static __device__ __forceinline__ void gauss_column(const float2 (&x)[R], const Tables& g,
                                                    Sink sink) {
  float s[R];
#pragma unroll
  for (int j = 0; j < R; ++j) s[j] = x[j].x + x[j].y;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    float p1 = 0.f, p2 = 0.f, p3 = 0.f;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float4 w = g((j * k) % R);
      p1 = fmaf(x[j].x, w.x, p1);
      p2 = fmaf(x[j].y, w.y, p2);
      p3 = fmaf(s[j], w.z, p3);
    }
    sink(k, make_float2(p1 - p2, p3 - p1 - p2));
  }
}

// The same stage for a radix R known at compile time: one work item is one
// column, whose R inputs sit in registers.
template <int R>
static __device__ void fft_stage_reg(const float2* __restrict__ in, float2* __restrict__ out,
                                     int lead, int rest, int T,
                                     const float2* __restrict__ roots,
                                     const float2* __restrict__ tw) {
  const int step = rest * T;
  const int ncols = lead * step;
  for (int c = threadIdx.x; c < ncols; c += blockDim.x) {
    const int l = c / step;
    const int rt = c - l * step;
    const int base = l * R * step + rt;
    float2 x[R];
#pragma unroll
    for (int j = 0; j < R; ++j) x[j] = in[swz(base + j * step)];
    const int jr = rt / T;
    dft_column<R>(x, roots, [&](int k, float2 y) {
      if (tw != nullptr) y = cmul(y, __ldg(&tw[k * rest + jr]));
      out[swz(k * ncols + c)] = y;
    });
  }
}

// Dispatch on the radix: register stages for 2-9, 12 and 16 (mirrored by
// ops/kernels/lanepack.py REGISTER_RADICES), fft_stage for the rest; with
// kGauss, gauss_stage for every radix (`tables` then holds float4s).
template <bool kGauss = false>
static __device__ void run_stage(const float2* in, float2* out, int r, int lead, int rest,
                                 int T, const float2* tables, const float2* tw) {
  if constexpr (kGauss) {
    gauss_stage(in, out, r, lead, rest, T, reinterpret_cast<const float4*>(tables), tw);
  } else {
    const float2* roots = tables;
    switch (r) {
      case 2: fft_stage_reg<2>(in, out, lead, rest, T, roots, tw); break;
      case 3: fft_stage_reg<3>(in, out, lead, rest, T, roots, tw); break;
      case 4: fft_stage_reg<4>(in, out, lead, rest, T, roots, tw); break;
      case 5: fft_stage_reg<5>(in, out, lead, rest, T, roots, tw); break;
      case 6: fft_stage_reg<6>(in, out, lead, rest, T, roots, tw); break;
      case 7: fft_stage_reg<7>(in, out, lead, rest, T, roots, tw); break;
      case 8: fft_stage_reg<8>(in, out, lead, rest, T, roots, tw); break;
      case 9: fft_stage_reg<9>(in, out, lead, rest, T, roots, tw); break;
      case 12: fft_stage_reg<12>(in, out, lead, rest, T, roots, tw); break;
      case 16: fft_stage_reg<16>(in, out, lead, rest, T, roots, tw); break;
      default: fft_stage(in, out, r, lead, rest, T, roots, tw); break;
    }
  }
}

// The whole chain on a tile loaded in `a` (callers __syncthreads() after
// loading), ping-ponging with `b`; `stables` from load_tables<kGauss>.
// Returns the buffer holding the natural-order result; every thread has
// passed a barrier after the last write to it.
template <bool kGauss = false>
static __device__ float2* fft_tile(float2* a, float2* b, int m, int T, const Stages& st,
                                   const float2* stables) {
  int lead = 1, rest = m, off = 0;
  for (int s = 0; s < st.k; ++s) {
    const int r = st.r[s];
    rest /= r;
    run_stage<kGauss>(a, b, r, lead, rest, T, stables + off, s + 1 < st.k ? st.tw[s] : nullptr);
    __syncthreads();
    float2* t = a;
    a = b;
    b = t;
    lead *= r;
    off += kGauss ? 2 * r : r;
  }
  return a;
}

// ---- Compile-time chains for the main-path shapes --------------------------
//
// The chain above with the radices R0, R1[, R2] (R2 = 1: two stages) and the
// tile width T as template constants, so that every stride, division and
// twiddle offset folds at compile time.  One thread per column of the
// smallest radix (the block has M*T/min(R) threads) unless that passes 1024
// threads or the registers a thread has (65536 / threads): then each thread
// takes two or more columns of a stage (kFixedThreads).  Stage 0 reads its
// columns from `src` (device memory), the middle stage runs in place in the
// shared-memory tile, the last stage writes to `dst` (device memory, or the
// tile for a transposed store).  Tiles are addressed by the flat element
// index f = i*T + t.

struct SmemTile {
  float2* buf;
  __device__ float2 load(int f) const { return buf[swz(f)]; }
  __device__ void store(int f, float2 v) const { buf[swz(f)] = v; }
};

// Element (i, t) of a window of T columns whose rows are `ld` apart.
template <int T>
struct GlobalIn {
  const float2* __restrict__ p;
  size_t ld;
  __device__ float2 load(int f) const { return p[(size_t)(f / T) * ld + f % T]; }
};

template <int T>
struct GlobalOut {
  float2* __restrict__ p;
  size_t ld;
  __device__ void store(int f, float2 v) const { p[(size_t)(f / T) * ld + f % T] = v; }
};

// One stage over NT threads, each holding ceil(columns / NT) columns in
// registers.
template <int R, int LEAD, int REST, int T, int NT, class Src, class Dst>
static __device__ __forceinline__ void fixed_stage(const Src& src, const Dst& dst,
                                                   const float2* __restrict__ roots,
                                                   const float2* __restrict__ tw) {
  constexpr int kStep = REST * T;
  constexpr int kCols = LEAD * kStep;
  constexpr int kPer = (kCols + NT - 1) / NT;
  float2 x[kPer][R];
  int rt[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = threadIdx.x + i * NT;
    const int l = c / kStep;
    rt[i] = c - l * kStep;
    if (c < kCols) {
#pragma unroll
      for (int j = 0; j < R; ++j) x[i][j] = src.load(l * R * kStep + j * kStep + rt[i]);
    }
  }
  __syncthreads();  // every column read before any is overwritten in place
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = threadIdx.x + i * NT;
    if (c >= kCols) return;
    const int jr = rt[i] / T;
    dft_column<R>(x[i], roots, [&](int k, float2 y) {
      if (tw != nullptr) y = cmul(y, __ldg(&tw[k * REST + jr]));
      dst.store(k * kCols + c, y);
    });
  }
}

// Complex values a thread of an nt-thread fixed_chain block holds at once:
// the most over the stages of (columns per thread) * radix.
template <int T, int R0, int R1, int R2>
__host__ __device__ constexpr int fixed_held(int nt) {
  constexpr int kElems = R0 * R1 * R2 * T;
  const int h0 = (kElems / R0 + nt - 1) / nt * R0;
  const int h1 = (kElems / R1 + nt - 1) / nt * R1;
  const int h2 = R2 > 1 ? (kElems / R2 + nt - 1) / nt * R2 : 0;
  const int h01 = h0 > h1 ? h0 : h1;
  return h01 > h2 ? h01 : h2;
}

// Threads of a fixed_chain block: one per column of its smallest radix,
// halved while that is above 1024 or leaves a thread fewer registers
// (65536 / threads) than its columns' 2 per complex value plus 32.
template <int T, int R0, int R1, int R2>
__host__ __device__ constexpr int fixed_threads() {
  constexpr int kMin = R2 > 1 && R2 < (R0 < R1 ? R0 : R1) ? R2 : (R0 < R1 ? R0 : R1);
  int nt = R0 * R1 * R2 * T / kMin;
  while (nt > 32 && (nt > 1024 || 2 * fixed_held<T, R0, R1, R2>(nt) + 32 > 65536 / nt)) nt /= 2;
  return nt;
}

template <int T, int R0, int R1, int R2>
constexpr int kFixedThreads = fixed_threads<T, R0, R1, R2>();

template <int T, int R0, int R1, int R2, class Src, class Dst>
static __device__ void fixed_chain(const Src& src, const Dst& dst, float2* buf,
                                   const float2* sroots, const Stages& st) {
  constexpr int M = R0 * R1 * R2;
  constexpr int NT = kFixedThreads<T, R0, R1, R2>;
  const SmemTile tile{buf};
  fixed_stage<R0, 1, M / R0, T, NT>(src, tile, sroots, st.tw[0]);
  __syncthreads();
  if constexpr (R2 > 1) {
    fixed_stage<R1, R0, R2, T, NT>(tile, tile, sroots + R0, st.tw[1]);
    __syncthreads();
    fixed_stage<R2, R0 * R1, 1, T, NT>(tile, dst, sroots + R0 + R1, nullptr);
  } else {
    fixed_stage<R1, R0, 1, T, NT>(tile, dst, sroots + R0, nullptr);
  }
}

// Allow `bytes` of dynamic shared memory for `kernel`, past the 48 KB default.
template <typename K>
static inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes > kSmemMax) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace rf

extern "C" const char* rf_error_string(int code);
