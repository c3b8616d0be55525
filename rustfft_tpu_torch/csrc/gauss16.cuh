// The constants of the Gauss form's DFT_16 and DFT_8: DFT_16 in the tile
// kernels (csrc/tile_walk.cuh tile_dft16), both in the radix body's Gauss
// form (csrc/radix.cuh gauss_dft), each through csrc/fft_tile.cuh
// gauss_column.  GaussR<kInverse>{}(e) = {Wr, Wi, Ws, 0} at root index e,
// 0 <= e < R, the columns of rustfft_tpu_torch/ops/kernels/large.py
// gauss_tables((R,), direction) (Wr + i Wi = w_R^(+-e), Ws = Wr + Wi, each
// computed in float64 and cast to float32).  Written by large.py
// gauss_header(); tests/test_torch_gauss_tiles.py and
// tests/test_torch_gauss_cluster.py hold this file to it.  Every call in the
// kernels has a constant e after unrolling, so each switch folds to
// immediates.
#pragma once

#include <cuda_runtime.h>

namespace rf {

template <bool kInverse>
struct Gauss16;

template <>
struct Gauss16<false> {
  __device__ __forceinline__ float4 operator()(int e) const {
    switch (e) {
      case 0: return make_float4(1.0f, -0.0f, 1.0f, 0.f);
      case 1: return make_float4(0.9238795f, -0.38268343f, 0.5411961f, 0.f);
      case 2: return make_float4(0.70710677f, -0.70710677f, 1.110223e-16f, 0.f);
      case 3: return make_float4(0.38268343f, -0.9238795f, -0.5411961f, 0.f);
      case 4: return make_float4(6.123234e-17f, -1.0f, -1.0f, 0.f);
      case 5: return make_float4(-0.38268343f, -0.9238795f, -1.306563f, 0.f);
      case 6: return make_float4(-0.70710677f, -0.70710677f, -1.4142135f, 0.f);
      case 7: return make_float4(-0.9238795f, -0.38268343f, -1.306563f, 0.f);
      case 8: return make_float4(-1.0f, -1.2246469e-16f, -1.0f, 0.f);
      case 9: return make_float4(-0.9238795f, 0.38268343f, -0.5411961f, 0.f);
      case 10: return make_float4(-0.70710677f, 0.70710677f, -2.220446e-16f, 0.f);
      case 11: return make_float4(-0.38268343f, 0.9238795f, 0.5411961f, 0.f);
      case 12: return make_float4(-1.8369701e-16f, 1.0f, 1.0f, 0.f);
      case 13: return make_float4(0.38268343f, 0.9238795f, 1.306563f, 0.f);
      case 14: return make_float4(0.70710677f, 0.70710677f, 1.4142135f, 0.f);
      case 15: return make_float4(0.9238795f, 0.38268343f, 1.306563f, 0.f);
      default: return make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
};

template <>
struct Gauss16<true> {
  __device__ __forceinline__ float4 operator()(int e) const {
    switch (e) {
      case 0: return make_float4(1.0f, 0.0f, 1.0f, 0.f);
      case 1: return make_float4(0.9238795f, 0.38268343f, 1.306563f, 0.f);
      case 2: return make_float4(0.70710677f, 0.70710677f, 1.4142135f, 0.f);
      case 3: return make_float4(0.38268343f, 0.9238795f, 1.306563f, 0.f);
      case 4: return make_float4(6.123234e-17f, 1.0f, 1.0f, 0.f);
      case 5: return make_float4(-0.38268343f, 0.9238795f, 0.5411961f, 0.f);
      case 6: return make_float4(-0.70710677f, 0.70710677f, 1.110223e-16f, 0.f);
      case 7: return make_float4(-0.9238795f, 0.38268343f, -0.5411961f, 0.f);
      case 8: return make_float4(-1.0f, 1.2246469e-16f, -1.0f, 0.f);
      case 9: return make_float4(-0.9238795f, -0.38268343f, -1.306563f, 0.f);
      case 10: return make_float4(-0.70710677f, -0.70710677f, -1.4142135f, 0.f);
      case 11: return make_float4(-0.38268343f, -0.9238795f, -1.306563f, 0.f);
      case 12: return make_float4(-1.8369701e-16f, -1.0f, -1.0f, 0.f);
      case 13: return make_float4(0.38268343f, -0.9238795f, -0.5411961f, 0.f);
      case 14: return make_float4(0.70710677f, -0.70710677f, -3.330669e-16f, 0.f);
      case 15: return make_float4(0.9238795f, -0.38268343f, 0.5411961f, 0.f);
      default: return make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
};

template <bool kInverse>
struct Gauss8;

template <>
struct Gauss8<false> {
  __device__ __forceinline__ float4 operator()(int e) const {
    switch (e) {
      case 0: return make_float4(1.0f, -0.0f, 1.0f, 0.f);
      case 1: return make_float4(0.70710677f, -0.70710677f, 1.110223e-16f, 0.f);
      case 2: return make_float4(6.123234e-17f, -1.0f, -1.0f, 0.f);
      case 3: return make_float4(-0.70710677f, -0.70710677f, -1.4142135f, 0.f);
      case 4: return make_float4(-1.0f, -1.2246469e-16f, -1.0f, 0.f);
      case 5: return make_float4(-0.70710677f, 0.70710677f, -2.220446e-16f, 0.f);
      case 6: return make_float4(-1.8369701e-16f, 1.0f, 1.0f, 0.f);
      case 7: return make_float4(0.70710677f, 0.70710677f, 1.4142135f, 0.f);
      default: return make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
};

template <>
struct Gauss8<true> {
  __device__ __forceinline__ float4 operator()(int e) const {
    switch (e) {
      case 0: return make_float4(1.0f, 0.0f, 1.0f, 0.f);
      case 1: return make_float4(0.70710677f, 0.70710677f, 1.4142135f, 0.f);
      case 2: return make_float4(6.123234e-17f, 1.0f, 1.0f, 0.f);
      case 3: return make_float4(-0.70710677f, 0.70710677f, 1.110223e-16f, 0.f);
      case 4: return make_float4(-1.0f, 1.2246469e-16f, -1.0f, 0.f);
      case 5: return make_float4(-0.70710677f, -0.70710677f, -1.4142135f, 0.f);
      case 6: return make_float4(-1.8369701e-16f, -1.0f, -1.0f, 0.f);
      case 7: return make_float4(0.70710677f, -0.70710677f, -3.330669e-16f, 0.f);
      default: return make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
};

}  // namespace rf
