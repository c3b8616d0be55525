// K7's factored register radices: the DFT of one column of R values in
// registers for R = 3, 5 and 7 (butterflies on conjugate pairs) and R = 6,
// 9, 10, 12, 14, 15 and 20 (one Cooley-Tukey step A x B in registers over
// those and the radices 2 and 4), every constant a float immediate times
// the direction's sign.  dft_column runs each of these radices as an
// unrolled R x R sum (radix 12: 144 complex multiply-adds a column, about
// 96 FP32 operations a point; the factored 4 x 3 takes about 14) or, for
// 10, 14, 15 and 20, the in-place chain's roots-table stage does (8R a
// point).  Only K7's two kernels (csrc/fused.cu two_stage_kernel and
// two_stage_cluster_kernel) run these forms, in their forms without a
// Bluestein stage (chain_inplace<0, true>); the other in-place chains (K1's
// chain kernel, K5's chain form, K12's kernels) and the tile kernels keep
// their code.
#pragma once

#include "fft_tile.cuh"

namespace rf {

// (cos, sin) of 2 pi e / R for e < R, the f64 values rounded to float
// (tests/test_torch_two_stage_walk.py reads these tables).
template <int R>
static __device__ __forceinline__ float2 trig(int e) {
  if constexpr (R == 3) {
    constexpr float c[3] = {1.0f, -0.5f, -0.5f};
    constexpr float s[3] = {0.0f, 0.8660253882408142f, -0.8660253882408142f};
    return make_float2(c[e], s[e]);
  } else if constexpr (R == 5) {
    constexpr float c[5] = {1.0f, 0.30901700258255005f, -0.80901700258255f, -0.80901700258255f,
                            0.30901700258255005f};
    constexpr float s[5] = {0.0f, 0.9510565400123596f, 0.5877852439880371f, -0.5877852439880371f,
                            -0.9510565400123596f};
    return make_float2(c[e], s[e]);
  } else if constexpr (R == 7) {
    constexpr float c[7] = {1.0f, 0.6234897971153259f, -0.22252093255519867f,
                            -0.9009688496589661f, -0.9009688496589661f, -0.22252093255519867f,
                            0.6234897971153259f};
    constexpr float s[7] = {0.0f, 0.7818315029144287f, 0.9749279022216797f, 0.4338837265968323f,
                            -0.4338837265968323f, -0.9749279022216797f, -0.7818315029144287f};
    return make_float2(c[e], s[e]);
  } else if constexpr (R == 6) {
    constexpr float c[6] = {1.0f, 0.5f, -0.5f, -1.0f, -0.5f, 0.5f};
    constexpr float s[6] = {0.0f, 0.8660253882408142f, 0.8660253882408142f, 0.0f,
                            -0.8660253882408142f, -0.8660253882408142f};
    return make_float2(c[e], s[e]);
  } else if constexpr (R == 9) {
    constexpr float c[9] = {1.0f, 0.7660444378852844f, 0.1736481785774231f, -0.5f,
                            -0.9396926164627075f, -0.9396926164627075f, -0.5f,
                            0.1736481785774231f, 0.7660444378852844f};
    constexpr float s[9] = {0.0f, 0.6427876353263855f, 0.9848077297210693f, 0.8660253882408142f,
                            0.3420201539993286f, -0.3420201539993286f, -0.8660253882408142f,
                            -0.9848077297210693f, -0.6427876353263855f};
    return make_float2(c[e], s[e]);
  } else if constexpr (R == 10) {
    constexpr float c[10] = {1.0f, 0.80901700258255f, 0.30901700258255005f,
                             -0.30901700258255005f, -0.80901700258255f, -1.0f,
                             -0.80901700258255f, -0.30901700258255005f, 0.30901700258255005f,
                             0.80901700258255f};
    constexpr float s[10] = {0.0f, 0.5877852439880371f, 0.9510565400123596f, 0.9510565400123596f,
                             0.5877852439880371f, 0.0f, -0.5877852439880371f,
                             -0.9510565400123596f, -0.9510565400123596f, -0.5877852439880371f};
    return make_float2(c[e], s[e]);
  } else if constexpr (R == 12) {
    constexpr float c[12] = {1.0f, 0.8660253882408142f, 0.5f, 0.0f, -0.5f, -0.8660253882408142f,
                             -1.0f, -0.8660253882408142f, -0.5f, 0.0f, 0.5f,
                             0.8660253882408142f};
    constexpr float s[12] = {0.0f, 0.5f, 0.8660253882408142f, 1.0f, 0.8660253882408142f, 0.5f,
                             0.0f, -0.5f, -0.8660253882408142f, -1.0f, -0.8660253882408142f,
                             -0.5f};
    return make_float2(c[e], s[e]);
  } else if constexpr (R == 14) {
    constexpr float c[14] = {1.0f, 0.9009688496589661f, 0.6234897971153259f,
                             0.22252093255519867f, -0.22252093255519867f, -0.6234897971153259f,
                             -0.9009688496589661f, -1.0f, -0.9009688496589661f,
                             -0.6234897971153259f, -0.22252093255519867f, 0.22252093255519867f,
                             0.6234897971153259f, 0.9009688496589661f};
    constexpr float s[14] = {0.0f, 0.4338837265968323f, 0.7818315029144287f, 0.9749279022216797f,
                             0.9749279022216797f, 0.7818315029144287f, 0.4338837265968323f, 0.0f,
                             -0.4338837265968323f, -0.7818315029144287f, -0.9749279022216797f,
                             -0.9749279022216797f, -0.7818315029144287f, -0.4338837265968323f};
    return make_float2(c[e], s[e]);
  } else if constexpr (R == 15) {
    constexpr float c[15] = {1.0f, 0.9135454297065735f, 0.6691306233406067f,
                             0.30901700258255005f, -0.10452846437692642f, -0.5f,
                             -0.80901700258255f, -0.9781476259231567f, -0.9781476259231567f,
                             -0.80901700258255f, -0.5f, -0.10452846437692642f,
                             0.30901700258255005f, 0.6691306233406067f, 0.9135454297065735f};
    constexpr float s[15] = {0.0f, 0.4067366421222687f, 0.7431448101997375f, 0.9510565400123596f,
                             0.9945219159126282f, 0.8660253882408142f, 0.5877852439880371f,
                             0.2079116851091385f, -0.2079116851091385f, -0.5877852439880371f,
                             -0.8660253882408142f, -0.9945219159126282f, -0.9510565400123596f,
                             -0.7431448101997375f, -0.4067366421222687f};
    return make_float2(c[e], s[e]);
  } else {
    static_assert(R == 20, "no trig table for this radix");
    constexpr float c[20] = {1.0f, 0.9510565400123596f, 0.80901700258255f, 0.5877852439880371f,
                             0.30901700258255005f, 0.0f, -0.30901700258255005f,
                             -0.5877852439880371f, -0.80901700258255f, -0.9510565400123596f,
                             -1.0f, -0.9510565400123596f, -0.80901700258255f,
                             -0.5877852439880371f, -0.30901700258255005f, 0.0f,
                             0.30901700258255005f, 0.5877852439880371f, 0.80901700258255f,
                             0.9510565400123596f};
    constexpr float s[20] = {0.0f, 0.30901700258255005f, 0.5877852439880371f, 0.80901700258255f,
                             0.9510565400123596f, 1.0f, 0.9510565400123596f, 0.80901700258255f,
                             0.5877852439880371f, 0.30901700258255005f, 0.0f,
                             -0.30901700258255005f, -0.5877852439880371f, -0.80901700258255f,
                             -0.9510565400123596f, -1.0f, -0.9510565400123596f,
                             -0.80901700258255f, -0.5877852439880371f, -0.30901700258255005f};
    return make_float2(c[e], s[e]);
  }
}

static __device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

static __device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// i * sg * v: the product by w_4 = (0, sg).
static __device__ __forceinline__ float2 times_i(float2 v, float sg) {
  return make_float2(-sg * v.y, sg * v.x);
}

// v * w_R^e, w_R^e = (cos, sg * sin) of 2 pi e / R; the quarter turns as
// swaps and signs.
template <int R>
static __device__ __forceinline__ float2 twiddle_k7(float2 v, int e, float sg) {
  if (e == 0) return v;
  if (4 * e == R) return times_i(v, sg);
  if (2 * e == R) return make_float2(-v.x, -v.y);
  if (4 * e == 3 * R) return times_i(v, -sg);
  const float2 w = trig<R>(e);
  const float s = sg * w.y;
  return make_float2(fmaf(v.x, w.x, -v.y * s), fmaf(v.x, s, v.y * w.x));
}

// DFT_N of y in place, natural order in and out, N in {2, 3, 4, 5, 7}; sg
// the sign of Im w_N (-1 forward, +1 inverse).  An odd prime N runs on the
// conjugate pairs t_j = y_j + y_{N-j}, u_j = y_j - y_{N-j}: X_k = y_0 +
// sum_j cos(2 pi jk/N) t_j + i sg sum_j sin(2 pi jk/N) u_j and X_{N-k} the
// same with -i.
template <int N>
static __device__ __forceinline__ void small_dft(float2 (&y)[N], float sg) {
  if constexpr (N == 2) {
    const float2 a = y[0];
    y[0] = cadd(a, y[1]);
    y[1] = csub(a, y[1]);
  } else if constexpr (N == 4) {
    const float2 s02 = cadd(y[0], y[2]), d02 = csub(y[0], y[2]);
    const float2 s13 = cadd(y[1], y[3]), r = times_i(csub(y[1], y[3]), sg);
    y[0] = cadd(s02, s13);
    y[2] = csub(s02, s13);
    y[1] = cadd(d02, r);
    y[3] = csub(d02, r);
  } else {
    static_assert(N == 3 || N == 5 || N == 7, "small_dft takes 2, 3, 4, 5 or 7");
    constexpr int H = (N - 1) / 2;
    float2 t[H], u[H];
#pragma unroll
    for (int j = 1; j <= H; ++j) {
      t[j - 1] = cadd(y[j], y[N - j]);
      u[j - 1] = csub(y[j], y[N - j]);
    }
    const float2 y0 = y[0];
    float2 sum = y0;
#pragma unroll
    for (int j = 0; j < H; ++j) sum = cadd(sum, t[j]);
#pragma unroll
    for (int k = 1; k <= H; ++k) {
      float2 a = y0, b = make_float2(0.f, 0.f);
#pragma unroll
      for (int j = 1; j <= H; ++j) {
        const float2 w = trig<N>((j * k) % N);
        a = make_float2(fmaf(w.x, t[j - 1].x, a.x), fmaf(w.x, t[j - 1].y, a.y));
        b = make_float2(fmaf(w.y, u[j - 1].x, b.x), fmaf(w.y, u[j - 1].y, b.y));
      }
      const float2 ib = times_i(b, sg);
      y[k] = cadd(a, ib);
      y[N - k] = csub(a, ib);
    }
    y[0] = sum;
  }
}

// DFT_R, R = A*B, by one Cooley-Tukey step in registers: j = B*j1 + j2,
// k = k1 + A*k2; DFT_A over j1 for each j2, the twiddle w_R^(j2*k1), DFT_B
// over j2 for each k1, each output to sink(k, X[k]).
template <int A, int B, class Sink>
static __device__ __forceinline__ void dft_factored(const float2 (&x)[A * B], float sg,
                                                    Sink sink) {
  float2 z[A][B];
#pragma unroll
  for (int j2 = 0; j2 < B; ++j2) {
    float2 v[A];
#pragma unroll
    for (int j1 = 0; j1 < A; ++j1) v[j1] = x[B * j1 + j2];
    small_dft<A>(v, sg);
#pragma unroll
    for (int k1 = 0; k1 < A; ++k1) z[k1][j2] = twiddle_k7<A * B>(v[k1], j2 * k1, sg);
  }
#pragma unroll
  for (int k1 = 0; k1 < A; ++k1) {
    small_dft<B>(z[k1], sg);
#pragma unroll
    for (int k2 = 0; k2 < B; ++k2) sink(k1 + A * k2, z[k1][k2]);
  }
}

// The radices K7's chains run in a factored form (ops/kernels/fused.py
// FACTORED_RADICES).
template <int R>
constexpr bool kFactored = R == 3 || R == 5 || R == 6 || R == 7 || R == 9 || R == 10 ||
                           R == 12 || R == 14 || R == 15 || R == 20;

// DFT of one column of R values in registers in K7's form, each output to
// sink(k, X[k]): the factored forms above where kFactored<R> (sg the sign
// of Im w_R, read by the caller from the stage's roots), dft_column
// otherwise (the powers of 2).
template <int R, class Sink>
static __device__ __forceinline__ void dft_column_k7(float2 (&x)[R],
                                                     const float2* __restrict__ roots, float sg,
                                                     Sink sink) {
  if constexpr (R == 3 || R == 5 || R == 7) {
    small_dft<R>(x, sg);
#pragma unroll
    for (int k = 0; k < R; ++k) sink(k, x[k]);
  } else if constexpr (R == 6) {
    dft_factored<2, 3>(x, sg, sink);
  } else if constexpr (R == 9) {
    dft_factored<3, 3>(x, sg, sink);
  } else if constexpr (R == 10) {
    dft_factored<2, 5>(x, sg, sink);
  } else if constexpr (R == 12) {
    dft_factored<4, 3>(x, sg, sink);
  } else if constexpr (R == 14) {
    dft_factored<2, 7>(x, sg, sink);
  } else if constexpr (R == 15) {
    dft_factored<3, 5>(x, sg, sink);
  } else if constexpr (R == 20) {
    dft_factored<4, 5>(x, sg, sink);
  } else {
    dft_column<R>(x, roots, sink);
  }
}

}  // namespace rf
