// K7's in-place chain: the DFT stages of csrc/fused.cu's two-stage kernels,
// shared with K12's kernels (csrc/largepad.cu).
//
// A block holds T interleaved transforms of length m in ONE shared buffer,
// element (i, t) at buf[swz(i*T + t)], and runs the decimation-in-time
// chain of csrc/fft_tile.cuh on them in place: a stage's column writes its
// outputs where it read its inputs, so the chain leaves natural output k at
// row place_of(k) (digit k_s at stride m / (r_0..r_s)) and a kernel's store
// reads it from there.  Stages by radix (ops/kernels/fused.py
// bluestein_stage_m): the register radices 2-9, 12 and 16 load one column
// into registers (stage_reg_inplace); every radix for which the Bluestein
// stage takes fewer operations than a direct sum (the primes from 29 to
// 509 and the other radices from 24 up but 33, 34 and 35) runs the
// in-place Bluestein stage, one warp a column (stage_bluestein_inplace);
// the rest (10, 11, 13-15, 17-23, 33-35) a direct sum from a roots table
// (stage_table_inplace).  The outer twiddle of a two-pass split can be
// folded into the last stage (OuterFold).  K7's chains without a
// Bluestein stage (kFact) run the radices 3, 5, 6, 7, 9, 10, 12, 14, 15
// and 20 in the factored register forms of csrc/factored_dft.cuh instead,
// 10, 14, 15 and 20 as register stages too; every other chain keeps the
// forms above.
#pragma once

#include <type_traits>

#include "factored_dft.cuh"

namespace rf {

// The outer twiddle w_n^(k1*j2), folded into the last stage of the DFT_p
// chain: a column whose lead is l (a place over the chain's earlier radices
// r0[, r1]) and whose T-index is j2 gives output k the frequency
// k1 = natural(l) + k*lead.  outer null: no fold.
struct OuterFold {
  const float2* __restrict__ outer;  // (q, p) [j2, k1]
  int p;
  int r1;                            // the second of two earlier radices, else 1
  int r0;                            // the first earlier radix, else 1
  __device__ float2 operator()(float2 v, int l, int lead, int k, int j2) const {
    const int kb = r1 > 1 ? l / r1 + r0 * (l % r1) : l;
    return cmul(v, __ldg(&outer[(size_t)j2 * p + kb + k * lead]));
  }
};

// K7's fold (chain_inplace<0, true>): the same twiddle from a table in
// either layout, w_n^(k1*j2) at outer[j2*sj + k1*sk]: (q, p) at (p, 1), or
// its transpose (p, q) at (1, q), whose reads are coalesced where a stage
// runs neighbouring columns j2 on neighbouring threads (the register and
// direct stages, the only ones of K7's factored chains; a Bluestein stage
// runs a column a warp, neighbouring k1 on neighbouring lanes, and
// OuterFold on the (q, p) table).
struct OuterFoldS {
  const float2* __restrict__ outer;
  int sj, sk;
  int r1, r0;
  __device__ float2 operator()(float2 v, int l, int lead, int k, int j2) const {
    const int kb = r1 > 1 ? l / r1 + r0 * (l % r1) : l;
    return cmul(v, __ldg(&outer[(size_t)j2 * sj + (size_t)(kb + k * lead) * sk]));
  }
};

// One register-radix stage in place: (lead, R, rest, T) -> the same places,
// output k where input k was read, times tw[k][j'] when tw is not null and
// times the outer twiddle when fold.outer is not null; with kFact, the
// column in K7's form (dft_column_k7).
template <int R, bool kFact = false, class Fold = OuterFold>
static __device__ void stage_reg_inplace(float2* buf, int lead, int rest, int T,
                                         const float2* __restrict__ roots,
                                         const float2* __restrict__ tw, const Fold& fold) {
  const int step = rest * T;
  const int ncols = lead * step;
  // the direction, for the factored forms' immediates: the sign of Im w_R
  float sg = 0.f;
  if constexpr (kFact && kFactored<R>) sg = roots[1].y < 0.f ? -1.f : 1.f;
  for (int c = threadIdx.x; c < ncols; c += blockDim.x) {
    const int l = c / step;
    const int rt = c - l * step;
    const int base = l * R * step + rt;
    float2 x[R];
#pragma unroll
    for (int j = 0; j < R; ++j) x[j] = buf[swz(base + j * step)];
    const int jr = rt / T;
    const auto sink = [&](int k, float2 v) {
      if (tw != nullptr) v = cmul(v, __ldg(&tw[k * rest + jr]));
      if (fold.outer != nullptr) v = fold(v, l, lead, k, rt - jr * T);
      buf[swz(base + k * step)] = v;
    };
    if constexpr (kFact) {
      dft_column_k7<R>(x, roots, sg, sink);
    } else {
      dft_column<R>(x, roots, sink);
    }
  }
}

// One roots-table stage in place, a radix r <= 256 with neither a register
// nor a Bluestein stage (the primes 11 to 23 and the composites 10, 14, 15
// and 20 of the band's chains), a direct sum of 8r operations a point, in
// passes over L neighbouring columns: thread t takes column t % L of the
// pass and its chunk t / L of G = kChunk outputs.  A pass costs one run
// over the r inputs however few columns it holds, so the stage takes the
// fewest passes the block's threads allow and spreads the columns evenly
// over them.  A warp reads one or two roots per term (broadcasts; a warp
// whose lanes read 32 different roots replayed on the banks up to ~5x) and
// neighbouring places of the tile.  Every chunk of a pass's columns reads
// them before the block barrier and overwrites them after it.
template <class Fold = OuterFold>
static __device__ void stage_table_inplace(float2* buf, int r, int lead, int rest, int T,
                                           const float2* __restrict__ roots,
                                           const float2* __restrict__ tw, const Fold& fold) {
  constexpr int G = kChunk;
  const int step = rest * T;
  const int ncols = lead * step;
  const int nchunks = (r + G - 1) / G;
  const int per_pass = (int)blockDim.x / nchunks;  // the most columns a pass holds
  const int passes = (ncols + per_pass - 1) / per_pass;
  const int L = (ncols + passes - 1) / passes;
  const int k0 = (int)threadIdx.x / L * G;
  for (int c0 = 0; c0 < ncols; c0 += L) {
    const int c = c0 + (int)threadIdx.x % L;
    const bool active = k0 < r && c < ncols;
    const int l = active ? c / step : 0;
    const int rt = active ? c - l * step : 0;
    const int base = l * r * step + rt;
    float2 acc[G];
    int e[G], inc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      acc[g] = make_float2(0.f, 0.f);
      e[g] = 0;
      inc[g] = (k0 + g < r) ? k0 + g : 0;
    }
    if (active) {
      for (int j = 0; j < r; ++j) {
        const float2 a = buf[swz(base + j * step)];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float2 w = roots[e[g]];
          acc[g].x = fmaf(a.x, w.x, fmaf(-a.y, w.y, acc[g].x));
          acc[g].y = fmaf(a.x, w.y, fmaf(a.y, w.x, acc[g].y));
          e[g] += inc[g];
          if (e[g] >= r) e[g] -= r;
        }
      }
    }
    __syncthreads();
    if (active) {
      const int jr = rt / T;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int k = k0 + g;
        if (k < r) {
          float2 v = acc[g];
          if (tw != nullptr) v = cmul(v, __ldg(&tw[k * rest + jr]));
          if (fold.outer != nullptr) v = fold(v, l, lead, k, rt - jr * T);
          buf[swz(base + k * step)] = v;
        }
      }
    }
  }
}

// ---- the in-place Bluestein stage ---------------------------------------------
//
// DFT_r of a prime r from 29 to 509 (ops/kernels/fused.py bluestein_stage_m)
// as a cyclic convolution of length M, a power of 2 >= 2r - 1, 64 .. 1024:
//   X[k] = w_k * conj(FFT_M(conj(FFT_M(a) * H)))[k],  a_j = x_j * w_j (j < r),
// w_j = exp(-+i pi j^2 / r) the chirp and H = FFT_M(b) / M the spectrum of
// the conjugate chirp b, wrapped cyclically (ops/bluestein.py
// bluestein_tables).  About (M/r)(10 log2 M + 6) + 12 operations a point
// where the direct sum spends 8r: 225 against 4072 at r = 509.
//
// One warp owns one column at a time, in registers: lane l holds the
// values j = l + 32t of the V = M/32 a lane; as M/4 < r <= M/2, t >= V/2
// start at zero and hold no output.  FFT_M runs forward in both directions (the
// spectrum of the symmetric wrapped chirp is the same either way) as the
// chain (V, 32): a radix-V FFT in each lane's registers (fft_fwd_dif,
// bit-reversed out), the twiddle w_M^(k1*l) and five __shfl_xor_sync
// radix-2 steps across the lanes (lanes_dif, bit-reversed lanes out), so
// lane l's register s holds frequency bitrev_V(s) + V*bitrev_32(l); the
// spectrum is stored in that order.  The second FFT_M runs the same steps
// backwards (lanes_dit, the twiddle, fft_fwd_dit), which take that order
// in and give output k = l + 32t back where input j = l + 32t came from.  A warp reads all r
// inputs of its column before it writes any output (the shuffles carry
// every input into every output), and columns are disjoint, so the stage
// is safe in place with no shared scratch and no block barrier.
//
// The stage's table, one array (ops/kernels/fused.py
// bluestein_stage_tables): [0, r) the chirp; [r, r + M) the spectrum in the
// lanes' order; then M entries of the chain's twiddle (V, 32) [k1][l] =
// w_M^(k1*l); V roots w_V^e (immediates here, w32); 32 roots w_32^e; the
// chain's tables are the forward direction's.  The stage reads it from
// device memory (at most 3.6 KiB a stage, L1-resident), never from shared
// memory: a kernel's shared memory holds its buffer and the roots of its
// direct stages only.  The reads are plain loads, not __ldg: with
// ld.global.nc the compiler issued them early and held their values, and
// the cluster kernel spilled 144 bytes instead of 36 (ptxas, sm_90a).

static __host__ __device__ __forceinline__ int bluestein_len(int r, int m) {
  return r + 2 * m + m / 32 + 32;
}

// w_32^e = exp(-2 pi i e / 32) for e < 16, the f64 values rounded to float
// (bit-equal to the stage table's roots, ops/kernels/fused.py), as
// immediates: the stage's FFT_M always runs forward (the spectrum of the
// symmetric wrapped chirp is the same in both directions), so its radix-V
// twiddles w_V^e = w_32^(e*32/V) need no table reads and no registers.
static __device__ __forceinline__ float2 w32(int e) {
  constexpr float kRe[16] = {1.f, 0.980785251f, 0.923879504f, 0.831469595f, 0.707106769f, 0.555570245f, 0.382683426f, 0.195090324f, 6.12323426e-17f, -0.195090324f, -0.382683426f, -0.555570245f, -0.707106769f, -0.831469595f, -0.923879504f, -0.980785251f};
  constexpr float kIm[16] = {-0.f, -0.195090324f, -0.382683426f, -0.555570245f, -0.707106769f, -0.831469595f, -0.923879504f, -0.980785251f, -1.f, -0.980785251f, -0.923879504f, -0.831469595f, -0.707106769f, -0.555570245f, -0.382683426f, -0.195090324f};
  return make_float2(kRe[e], kIm[e]);
}

// In-register radix-2 forward FFT of R = 2^m <= 32 values, decimation in
// frequency: natural order in, x[bitrev(k)] = X[k] out (fft_pow2_reg with
// the twiddles as immediates).
template <int R, int HALF = R / 2>
static __device__ __forceinline__ void fft_fwd_dif(float2 (&x)[R]) {
  if constexpr (HALF >= 1) {
#pragma unroll
    for (int blk = 0; blk < R; blk += 2 * HALF) {
#pragma unroll
      for (int i = 0; i < HALF; ++i) {
        constexpr int kStride = 32 / (2 * HALF);
        const float2 a = x[blk + i];
        const float2 b = x[blk + i + HALF];
        x[blk + i] = make_float2(a.x + b.x, a.y + b.y);
        const float2 d = make_float2(a.x - b.x, a.y - b.y);
        x[blk + i + HALF] = i == 0 ? d : cmul(d, w32(i * kStride));
      }
    }
    fft_fwd_dif<R, HALF / 2>(x);
  }
}

// Decimation in time: bit-reversed order in (x[bitrev(j)] = x_j), x[k] =
// X[k] out.
template <int R, int HALF = 1>
static __device__ __forceinline__ void fft_fwd_dit(float2 (&x)[R]) {
  if constexpr (HALF < R) {
#pragma unroll
    for (int blk = 0; blk < R; blk += 2 * HALF) {
#pragma unroll
      for (int i = 0; i < HALF; ++i) {
        constexpr int kStride = 32 / (2 * HALF);
        const float2 a = x[blk + i];
        const float2 b = i == 0 ? x[blk + i + HALF] : cmul(x[blk + i + HALF], w32(i * kStride));
        x[blk + i] = make_float2(a.x + b.x, a.y + b.y);
        x[blk + i + HALF] = make_float2(a.x - b.x, a.y - b.y);
      }
    }
    fft_fwd_dit<R, 2 * HALF>(x);
  }
}

// Step h = 2^b of the radix-2 FFT across the lanes of a warp pairs lane l
// with l ^ h: the butterfly twiddle w_{2h}^(l mod h) (roots w_32^e in r32)
// in the upper lane of a pair (l & h), 1 in the lower; *sg -1 in the upper
// lane, +1 in the lower.
static __device__ __forceinline__ float2 lane_twiddle(const float2* r32, int lane, int b,
                                                      float* sg) {
  const bool upper = (lane >> b) & 1;
  *sg = upper ? -1.f : 1.f;
  return upper ? r32[(lane & ((1 << b) - 1)) * (16 >> b)] : make_float2(1.f, 0.f);
}

// The radix-2 steps of a 32-point FFT across the lanes, for each of V
// registers.  Decimation in frequency: natural lane order in, bit-reversed
// out.
template <int V>
static __device__ __forceinline__ void lanes_dif(float2 (&x)[V], const float2* r32, int lane) {
#pragma unroll
  for (int b = 4; b >= 0; --b) {
    float sg;
    const float2 w = lane_twiddle(r32, lane, b, &sg);
#pragma unroll
    for (int s = 0; s < V; ++s) {
      const float px = __shfl_xor_sync(0xffffffffu, x[s].x, 1 << b);
      const float py = __shfl_xor_sync(0xffffffffu, x[s].y, 1 << b);
      // lower: x + partner; upper: (partner - x) * w
      const float2 d = make_float2(fmaf(sg, x[s].x, px), fmaf(sg, x[s].y, py));
      x[s] = b > 0 ? cmul(d, w) : d;
    }
  }
}

// Decimation in time: bit-reversed lane order in, natural out.
template <int V>
static __device__ __forceinline__ void lanes_dit(float2 (&x)[V], const float2* r32, int lane) {
#pragma unroll
  for (int b = 0; b < 5; ++b) {
    float sg;
    const float2 w = lane_twiddle(r32, lane, b, &sg);
#pragma unroll
    for (int s = 0; s < V; ++s) {
      const float2 t = b > 0 ? cmul(x[s], w) : x[s];
      const float px = __shfl_xor_sync(0xffffffffu, t.x, 1 << b);
      const float py = __shfl_xor_sync(0xffffffffu, t.y, 1 << b);
      // lower: x + partner * w; upper: partner - x * w
      x[s] = make_float2(fmaf(sg, t.x, px), fmaf(sg, t.y, py));
    }
  }
}

// p itself, as a value the compiler cannot see through: a table read or a
// place computed from it is read or computed anew, not kept live in
// registers from an earlier read of the same address.
template <typename P>
static __device__ __forceinline__ P opaque(P p) {
  asm volatile("" : "+l"(p));
  return p;
}

static __device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

// opaque(p), there only once v is computed: reads through it wait for v
// instead of being issued early and held in registers.
template <typename P>
static __device__ __forceinline__ P opaque_after(P p, float2 v) {
  asm volatile("" : "+l"(p) : "f"(v.x), "f"(v.y));
  return p;
}

static __device__ __forceinline__ int opaque_after(int i, float2 v) {
  asm volatile("" : "+r"(i) : "f"(v.x), "f"(v.y));
  return i;
}

// Half h of the stage's two FFT_M: the registers s = h*H .. h*H + H - 1 (H =
// V/2) of the radix-V chain, from y[t] = the first radix-2 layer's output
// (the upper inputs are zeros) through the twiddle, the lanes, the spectrum
// and back to y[i], block h of the second FFT_M's radix-V DIT before its
// last layer.  The halves are independent until then.
template <int V, int h>
static __device__ __forceinline__ void bluestein_half(float2 (&y)[V / 2], const float2* tab,
                                                      int r, int lane) {
  constexpr int H = V / 2, M = 32 * V;
  // the table past the chirp: the spectrum, the chain's twiddle, its roots
  fft_fwd_dif<H>(y);
  const float2* t = opaque_after(tab, y[H - 1]) + r;
#pragma unroll
  for (int s = 0; s < H; ++s)
    if (bitrev<V>(h * H + s) > 0) y[s] = cmul(y[s], t[M + bitrev<V>(h * H + s) * 32 + lane]);
  lanes_dif<H>(y, t + 2 * M + V, lane);
  // times the spectrum, conjugated: the second FFT_M is then the inverse
  t = opaque_after(tab, y[H - 1]) + r;
#pragma unroll
  for (int s = 0; s < H; ++s) {
    const float2 z = cmul(y[s], t[(h * H + s) * 32 + lane]);
    y[s] = make_float2(z.x, -z.y);
  }
  lanes_dit<H>(y, opaque_after(tab, y[H - 1]) + r + 2 * M + V, lane);
  t = opaque_after(tab, y[H - 1]) + r;
#pragma unroll
  for (int s = 0; s < H; ++s)
    if (bitrev<V>(h * H + s) > 0) y[s] = cmul(y[s], t[M + bitrev<V>(h * H + s) * 32 + lane]);
  fft_fwd_dit<H>(y);
}

// One Bluestein stage in place: (lead, r, rest, T) -> the same places, as
// stage_table_inplace, from the stage's table `tab` in device memory.  The two halves of the radix-V chain run in turn, V/2 values a
// lane each: between them the odd half's inputs come out of the column's
// places and the even half's results go in (only k < r, the outputs), and
// the last layer of the second FFT_M joins them in the store.  So a lane
// holds V/2 values, not V (16 at M = 1024), and reads each table entry
// where it uses it (opaque) rather than keeping it live across the halves.
template <int M>
static __device__ void stage_bluestein_inplace(float2* buf, int r, int lead, int rest, int T,
                                               const float2* tab, const float2* __restrict__ tw,
                                               const OuterFold& fold) {
  constexpr int V = M / 32, H = V / 2;
  const int lane = (int)threadIdx.x & 31;
  const int step = rest * T;
  const int ncols = lead * step;
  for (int c = (int)threadIdx.x >> 5; c < ncols; c += (int)blockDim.x >> 5) {
    const int l = c / step;
    const int rt = c - l * step;
    // input j = lane + 32t is nonzero for t < H only (M/4 < r <= M/2), and
    // always there for t < V/4
    float2 y[H];
    {
      const int base = opaque(l * r * step + rt);
      const float2* chirp = opaque(tab);
#pragma unroll
      for (int t = 0; t < H; ++t) {
        const int j = lane + 32 * t;
        y[t] = make_float2(0.f, 0.f);
        if (t < V / 4 || j < r) y[t] = cmul(buf[swz(base + j * step)], chirp[j]);
      }
    }
    bluestein_half<V, 0>(y, tab, r, lane);
    {
      const int base = opaque_after(l * r * step + rt, y[H - 1]);
      const float2* chirp = opaque_after(tab, y[H - 1]);
#pragma unroll
      for (int t = 0; t < H; ++t) {
        const int j = lane + 32 * t;
        float2 a = make_float2(0.f, 0.f);
        if (t < V / 4 || j < r) {
          const int at = swz(base + j * step);
          a = cmul(buf[at], chirp[j]);
          buf[at] = y[t];
        }
        y[t] = t == 0 ? a : cmul(a, w32(t * 32 / V));
      }
    }
    bluestein_half<V, 1>(y, tab, r, lane);
    // every read of the store waits for the FFTs (the twiddles, the outer
    // fold and the chirp would otherwise be read ahead, V/2 of each)
    const int base = opaque_after(l * r * step + rt, y[H - 1]);
    const float2* chirp = opaque_after(tab, y[H - 1]);
    const float2* tws = opaque_after(tw, y[H - 1]);
    OuterFold out = fold;
    out.outer = opaque_after(fold.outer, y[H - 1]);
    const int jr = rt / T;
#pragma unroll
    for (int t = 0; t < H; ++t) {
      const int k = lane + 32 * t;
      if (t < V / 4 || k < r) {
        const int at = swz(base + k * step);
        const float2 e = buf[at];
        const float2 o = t == 0 ? y[t] : cmul(y[t], w32(t * 32 / V));
        float2 v = cmul(make_float2(e.x + o.x, -(e.y + o.y)), chirp[k]);
        if (tws != nullptr) v = cmul(v, __ldg(&tws[k * rest + jr]));
        if (out.outer != nullptr) v = out(v, l, lead, k, rt - jr * T);
        buf[at] = v;
      }
    }
  }
}

// The largest direct-sum radix of the in-place chains (ops/kernels/fused.py
// MAX_INPLACE_RADIX): a chain's radices above it run a Bluestein stage.
constexpr int kMaxDirectRadix = 32 * kChunk;

// The Bluestein length of radix r, the least power of 2 >= 2r - 1 and 64
// (so that M/4 < r <= M/2), and a kernel of cap max_m runs it.
static __host__ __device__ __forceinline__ bool bluestein_ok(int r, int m, int max_m) {
  return m <= max_m && (m & (m - 1)) == 0 && m >= 2 * r - 1 && (m == 64 || m / 2 < 2 * r - 1);
}

// One stage of the chain by its kind; a kernel of Bluestein cap MaxM
// compiles the Bluestein stages up to MaxM points only.  kFact: K7's
// factored register forms, 10, 14, 15 and 20 among the register stages,
// in chains without a Bluestein stage only (MaxM = 0).
template <int MaxM, bool kFact = false, class Fold = OuterFold>
static __device__ void run_stage_inplace(float2* buf, int r, int bm, int lead, int rest, int T,
                                         const float2* roots, const float2* tw,
                                         const Fold& fold) {
  static_assert(!kFact || MaxM == 0, "K7's factored chains have no Bluestein stage");
  if constexpr (MaxM > 0) {
    switch (bm) {
      case 0: break;
      case 64: stage_bluestein_inplace<64>(buf, r, lead, rest, T, roots, tw, fold); return;
      case 128: stage_bluestein_inplace<128>(buf, r, lead, rest, T, roots, tw, fold); return;
      case 256:
        if constexpr (MaxM >= 256)
          stage_bluestein_inplace<256>(buf, r, lead, rest, T, roots, tw, fold);
        return;
      case 512:
        if constexpr (MaxM >= 512)
          stage_bluestein_inplace<512>(buf, r, lead, rest, T, roots, tw, fold);
        return;
      default:
        if constexpr (MaxM >= 1024)
          stage_bluestein_inplace<1024>(buf, r, lead, rest, T, roots, tw, fold);
        return;
    }
  }
  if constexpr (kFact) {
    switch (r) {
      case 10: stage_reg_inplace<10, true, Fold>(buf, lead, rest, T, roots, tw, fold); return;
      case 14: stage_reg_inplace<14, true, Fold>(buf, lead, rest, T, roots, tw, fold); return;
      case 15: stage_reg_inplace<15, true, Fold>(buf, lead, rest, T, roots, tw, fold); return;
      case 20: stage_reg_inplace<20, true, Fold>(buf, lead, rest, T, roots, tw, fold); return;
      default: break;
    }
  }
  switch (r) {
    case 2: stage_reg_inplace<2, kFact, Fold>(buf, lead, rest, T, roots, tw, fold); break;
    case 3: stage_reg_inplace<3, kFact, Fold>(buf, lead, rest, T, roots, tw, fold); break;
    case 4: stage_reg_inplace<4, kFact, Fold>(buf, lead, rest, T, roots, tw, fold); break;
    case 5: stage_reg_inplace<5, kFact, Fold>(buf, lead, rest, T, roots, tw, fold); break;
    case 6: stage_reg_inplace<6, kFact, Fold>(buf, lead, rest, T, roots, tw, fold); break;
    case 7: stage_reg_inplace<7, kFact, Fold>(buf, lead, rest, T, roots, tw, fold); break;
    case 8: stage_reg_inplace<8, kFact, Fold>(buf, lead, rest, T, roots, tw, fold); break;
    case 9: stage_reg_inplace<9, kFact, Fold>(buf, lead, rest, T, roots, tw, fold); break;
    case 12: stage_reg_inplace<12, kFact, Fold>(buf, lead, rest, T, roots, tw, fold); break;
    case 16: stage_reg_inplace<16, kFact, Fold>(buf, lead, rest, T, roots, tw, fold); break;
    default: stage_table_inplace(buf, r, lead, rest, T, roots, tw, fold); break;
  }
}

// Entries of stage s's table a kernel holds in shared memory: the roots of
// a direct stage; none of a Bluestein stage (read from device memory).
static __host__ __device__ __forceinline__ int stage_smem_len(const Stages& st, int s) {
  return st.bm[s] == 0 ? st.r[s] : 0;
}

static __host__ __device__ inline int chain_smem_len(const Stages& st) {
  int total = 0;
  for (int s = 0; s < st.k; ++s) total += stage_smem_len(st, s);
  return total;
}

// Copy what stage_smem_len counts into shared memory, back to back.
static __device__ void load_chain_tables(const Stages& st, float2* stables) {
  int off = 0;
  for (int s = 0; s < st.k; ++s) {
    const int len = stage_smem_len(st, s);
    for (int i = threadIdx.x; i < len; i += blockDim.x) stables[off + i] = st.roots[s][i];
    off += len;
  }
}

static __host__ __device__ inline bool has_bluestein(const Stages& st) {
  for (int s = 0; s < st.k; ++s)
    if (st.bm[s] != 0) return true;
  return false;
}

// The stages of a chain a kernel of Bluestein cap max_m runs: every
// Bluestein length valid, every other radix a register radix or at most
// kMaxDirectRadix (no direct sum above it).
static bool chain_ok(const Stages& st, int max_m) {
  for (int s = 0; s < st.k; ++s) {
    if (st.bm[s] != 0 ? !bluestein_ok(st.r[s], st.bm[s], max_m) : st.r[s] > kMaxDirectRadix)
      return false;
  }
  return true;
}

// The chain over a length-m axis of `lead` blocks of T interleaved
// transforms, in place, with the outer twiddle `outer` (or null) folded
// into its last stage, w_n^(k1*j2) at outer[j2*p + k1]; every thread has
// passed a barrier after it.  The direct stages' roots from
// load_chain_tables at `stables`; no Bluestein length is above MaxM (none
// at MaxM = 0).  kFact: K7's chains without a Bluestein stage (MaxM = 0),
// its factored radices and its fold (OuterFoldS: the twiddle at
// outer[j2*p + k1*sk]; p = 1, sk = q reads the (p, q) transpose).
template <int MaxM, bool kFact = false>
static __device__ void chain_inplace(float2* buf, int m, int lead, int T, const Stages& st,
                                     const float2* stables, const float2* outer, int p,
                                     int sk = 1) {
  using Fold = typename std::conditional<kFact, OuterFoldS, OuterFold>::type;
  const auto make_fold = [&](const float2* o, int r1, int r0) {
    if constexpr (kFact) {
      return OuterFoldS{o, p, sk, r1, r0};
    } else {
      return OuterFold{o, p, r1, r0};
    }
  };
  int rest = m, off = 0;
  for (int s = 0; s < st.k; ++s) {
    const int r = st.r[s];
    rest /= r;
    const bool last = s + 1 == st.k;
    const Fold fold = make_fold(last ? outer : nullptr, s == 2 ? st.r[1] : 1, s >= 1 ? st.r[0] : 1);
    const float2* tab = st.bm[s] != 0 ? st.roots[s] : stables + off;
    run_stage_inplace<MaxM, kFact, Fold>(buf, r, st.bm[s], lead, rest, T, tab,
                                         last ? nullptr : st.tw[s], fold);
    __syncthreads();
    lead *= r;
    off += stage_smem_len(st, s);
  }
}

// Where the in-place chain leaves natural output k of its length-m axis:
// digit k_s (k = k_0 + r_0*k_1 + r_0*r_1*k_2) at stride m / (r_0..r_s).
static __device__ __forceinline__ int place_of(int k, int m, const Stages& st) {
  int place = 0;
  for (int s = 0; s < st.k; ++s) {
    m /= st.r[s];
    const int ks = k % st.r[s];
    k /= st.r[s];
    place += ks * m;
  }
  return place;
}

// %globaltimer in nanoseconds (the kernels' phase stamps).
static __device__ __forceinline__ unsigned long long global_timer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

}  // namespace rf
