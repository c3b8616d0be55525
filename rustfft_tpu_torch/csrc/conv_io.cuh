// The two-pass convolution core's column-stage source and row-stage sink
// (K14, csrc/conv_radix.cu): the gather, pre and per-tile partial sums of
// the raw input that pass 1's column stage loads, and the epilogues that
// the row stages store.  csrc/conv_radix.cu runs them on csrc/large.cuh's
// general kernels (the Gauss form), csrc/conv_pad.cu and
// csrc/conv_pad_row.cu on K12's ragged in-place tiles (csrc/largepad.cuh).
#pragma once

#include "fft_tile.cuh"

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
  float2* __restrict__ partials;  // (batch, tiles) or NULL
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
