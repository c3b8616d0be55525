// The constants of the pair form (csrc/dense.cu dense_pair_kernel):
// PairRoots<n>::c(m) = cos(2 pi m / n) and ::s(m) = sin(2 pi m / n), 0 <= m
// < n, as the forward twiddles.dft_matrix(n)'s entry W[1, m] = c - i s holds
// them, cast to float32.  Written by
// rustfft_tpu_torch/ops/kernels/dense.py pair_header(); tests/
// test_torch_dense_pair.py holds this file to it.  Every call in the kernel
// has a constant m after unrolling, so each switch folds to an immediate.
#pragma once

namespace rf {

template <int N>
struct PairRoots;

template <>
struct PairRoots<2> {
  static __device__ __forceinline__ float c(int m) {
    switch (m) {
      case 0: return 1.0f;
      case 1: return -1.0f;
      default: return 0.f;
    }
  }
  static __device__ __forceinline__ float s(int m) {
    switch (m) {
      case 0: return 0.0f;
      case 1: return 1.2246469e-16f;
      default: return 0.f;
    }
  }
};

template <>
struct PairRoots<3> {
  static __device__ __forceinline__ float c(int m) {
    switch (m) {
      case 0: return 1.0f;
      case 1: return -0.5f;
      case 2: return -0.5f;
      default: return 0.f;
    }
  }
  static __device__ __forceinline__ float s(int m) {
    switch (m) {
      case 0: return 0.0f;
      case 1: return 0.8660254f;
      case 2: return -0.8660254f;
      default: return 0.f;
    }
  }
};

template <>
struct PairRoots<4> {
  static __device__ __forceinline__ float c(int m) {
    switch (m) {
      case 0: return 1.0f;
      case 1: return 6.123234e-17f;
      case 2: return -1.0f;
      case 3: return -1.8369701e-16f;
      default: return 0.f;
    }
  }
  static __device__ __forceinline__ float s(int m) {
    switch (m) {
      case 0: return 0.0f;
      case 1: return 1.0f;
      case 2: return 1.2246469e-16f;
      case 3: return -1.0f;
      default: return 0.f;
    }
  }
};

template <>
struct PairRoots<5> {
  static __device__ __forceinline__ float c(int m) {
    switch (m) {
      case 0: return 1.0f;
      case 1: return 0.309017f;
      case 2: return -0.809017f;
      case 3: return -0.809017f;
      case 4: return 0.309017f;
      default: return 0.f;
    }
  }
  static __device__ __forceinline__ float s(int m) {
    switch (m) {
      case 0: return 0.0f;
      case 1: return 0.95105654f;
      case 2: return 0.58778524f;
      case 3: return -0.58778524f;
      case 4: return -0.95105654f;
      default: return 0.f;
    }
  }
};

template <>
struct PairRoots<6> {
  static __device__ __forceinline__ float c(int m) {
    switch (m) {
      case 0: return 1.0f;
      case 1: return 0.5f;
      case 2: return -0.5f;
      case 3: return -1.0f;
      case 4: return -0.5f;
      case 5: return 0.5f;
      default: return 0.f;
    }
  }
  static __device__ __forceinline__ float s(int m) {
    switch (m) {
      case 0: return 0.0f;
      case 1: return 0.8660254f;
      case 2: return 0.8660254f;
      case 3: return 1.2246469e-16f;
      case 4: return -0.8660254f;
      case 5: return -0.8660254f;
      default: return 0.f;
    }
  }
};

template <>
struct PairRoots<7> {
  static __device__ __forceinline__ float c(int m) {
    switch (m) {
      case 0: return 1.0f;
      case 1: return 0.6234898f;
      case 2: return -0.22252093f;
      case 3: return -0.90096885f;
      case 4: return -0.90096885f;
      case 5: return -0.22252093f;
      case 6: return 0.6234898f;
      default: return 0.f;
    }
  }
  static __device__ __forceinline__ float s(int m) {
    switch (m) {
      case 0: return 0.0f;
      case 1: return 0.7818315f;
      case 2: return 0.9749279f;
      case 3: return 0.43388373f;
      case 4: return -0.43388373f;
      case 5: return -0.9749279f;
      case 6: return -0.7818315f;
      default: return 0.f;
    }
  }
};

template <>
struct PairRoots<8> {
  static __device__ __forceinline__ float c(int m) {
    switch (m) {
      case 0: return 1.0f;
      case 1: return 0.70710677f;
      case 2: return 6.123234e-17f;
      case 3: return -0.70710677f;
      case 4: return -1.0f;
      case 5: return -0.70710677f;
      case 6: return -1.8369701e-16f;
      case 7: return 0.70710677f;
      default: return 0.f;
    }
  }
  static __device__ __forceinline__ float s(int m) {
    switch (m) {
      case 0: return 0.0f;
      case 1: return 0.70710677f;
      case 2: return 1.0f;
      case 3: return 0.70710677f;
      case 4: return 1.2246469e-16f;
      case 5: return -0.70710677f;
      case 6: return -1.0f;
      case 7: return -0.70710677f;
      default: return 0.f;
    }
  }
};

template <>
struct PairRoots<9> {
  static __device__ __forceinline__ float c(int m) {
    switch (m) {
      case 0: return 1.0f;
      case 1: return 0.76604444f;
      case 2: return 0.17364818f;
      case 3: return -0.5f;
      case 4: return -0.9396926f;
      case 5: return -0.9396926f;
      case 6: return -0.5f;
      case 7: return 0.17364818f;
      case 8: return 0.76604444f;
      default: return 0.f;
    }
  }
  static __device__ __forceinline__ float s(int m) {
    switch (m) {
      case 0: return 0.0f;
      case 1: return 0.64278764f;
      case 2: return 0.9848077f;
      case 3: return 0.8660254f;
      case 4: return 0.34202015f;
      case 5: return -0.34202015f;
      case 6: return -0.8660254f;
      case 7: return -0.9848077f;
      case 8: return -0.64278764f;
      default: return 0.f;
    }
  }
};

template <>
struct PairRoots<10> {
  static __device__ __forceinline__ float c(int m) {
    switch (m) {
      case 0: return 1.0f;
      case 1: return 0.809017f;
      case 2: return 0.309017f;
      case 3: return -0.309017f;
      case 4: return -0.809017f;
      case 5: return -1.0f;
      case 6: return -0.809017f;
      case 7: return -0.309017f;
      case 8: return 0.309017f;
      case 9: return 0.809017f;
      default: return 0.f;
    }
  }
  static __device__ __forceinline__ float s(int m) {
    switch (m) {
      case 0: return 0.0f;
      case 1: return 0.58778524f;
      case 2: return 0.95105654f;
      case 3: return 0.95105654f;
      case 4: return 0.58778524f;
      case 5: return 1.2246469e-16f;
      case 6: return -0.58778524f;
      case 7: return -0.95105654f;
      case 8: return -0.95105654f;
      case 9: return -0.58778524f;
      default: return 0.f;
    }
  }
};

template <>
struct PairRoots<11> {
  static __device__ __forceinline__ float c(int m) {
    switch (m) {
      case 0: return 1.0f;
      case 1: return 0.8412535f;
      case 2: return 0.41541502f;
      case 3: return -0.14231484f;
      case 4: return -0.65486073f;
      case 5: return -0.959493f;
      case 6: return -0.959493f;
      case 7: return -0.65486073f;
      case 8: return -0.14231484f;
      case 9: return 0.41541502f;
      case 10: return 0.8412535f;
      default: return 0.f;
    }
  }
  static __device__ __forceinline__ float s(int m) {
    switch (m) {
      case 0: return 0.0f;
      case 1: return 0.54064083f;
      case 2: return 0.90963197f;
      case 3: return 0.98982143f;
      case 4: return 0.7557496f;
      case 5: return 0.28173256f;
      case 6: return -0.28173256f;
      case 7: return -0.7557496f;
      case 8: return -0.98982143f;
      case 9: return -0.90963197f;
      case 10: return -0.54064083f;
      default: return 0.f;
    }
  }
};

template <>
struct PairRoots<12> {
  static __device__ __forceinline__ float c(int m) {
    switch (m) {
      case 0: return 1.0f;
      case 1: return 0.8660254f;
      case 2: return 0.5f;
      case 3: return 6.123234e-17f;
      case 4: return -0.5f;
      case 5: return -0.8660254f;
      case 6: return -1.0f;
      case 7: return -0.8660254f;
      case 8: return -0.5f;
      case 9: return -1.8369701e-16f;
      case 10: return 0.5f;
      case 11: return 0.8660254f;
      default: return 0.f;
    }
  }
  static __device__ __forceinline__ float s(int m) {
    switch (m) {
      case 0: return 0.0f;
      case 1: return 0.5f;
      case 2: return 0.8660254f;
      case 3: return 1.0f;
      case 4: return 0.8660254f;
      case 5: return 0.5f;
      case 6: return 1.2246469e-16f;
      case 7: return -0.5f;
      case 8: return -0.8660254f;
      case 9: return -1.0f;
      case 10: return -0.8660254f;
      case 11: return -0.5f;
      default: return 0.f;
    }
  }
};

template <>
struct PairRoots<13> {
  static __device__ __forceinline__ float c(int m) {
    switch (m) {
      case 0: return 1.0f;
      case 1: return 0.885456f;
      case 2: return 0.56806475f;
      case 3: return 0.12053668f;
      case 4: return -0.3546049f;
      case 5: return -0.7485108f;
      case 6: return -0.97094184f;
      case 7: return -0.97094184f;
      case 8: return -0.7485108f;
      case 9: return -0.3546049f;
      case 10: return 0.12053668f;
      case 11: return 0.56806475f;
      case 12: return 0.885456f;
      default: return 0.f;
    }
  }
  static __device__ __forceinline__ float s(int m) {
    switch (m) {
      case 0: return 0.0f;
      case 1: return 0.46472317f;
      case 2: return 0.82298386f;
      case 3: return 0.99270886f;
      case 4: return 0.9350162f;
      case 5: return 0.66312265f;
      case 6: return 0.23931566f;
      case 7: return -0.23931566f;
      case 8: return -0.66312265f;
      case 9: return -0.9350162f;
      case 10: return -0.99270886f;
      case 11: return -0.82298386f;
      case 12: return -0.46472317f;
      default: return 0.f;
    }
  }
};

template <>
struct PairRoots<14> {
  static __device__ __forceinline__ float c(int m) {
    switch (m) {
      case 0: return 1.0f;
      case 1: return 0.90096885f;
      case 2: return 0.6234898f;
      case 3: return 0.22252093f;
      case 4: return -0.22252093f;
      case 5: return -0.6234898f;
      case 6: return -0.90096885f;
      case 7: return -1.0f;
      case 8: return -0.90096885f;
      case 9: return -0.6234898f;
      case 10: return -0.22252093f;
      case 11: return 0.22252093f;
      case 12: return 0.6234898f;
      case 13: return 0.90096885f;
      default: return 0.f;
    }
  }
  static __device__ __forceinline__ float s(int m) {
    switch (m) {
      case 0: return 0.0f;
      case 1: return 0.43388373f;
      case 2: return 0.7818315f;
      case 3: return 0.9749279f;
      case 4: return 0.9749279f;
      case 5: return 0.7818315f;
      case 6: return 0.43388373f;
      case 7: return 1.2246469e-16f;
      case 8: return -0.43388373f;
      case 9: return -0.7818315f;
      case 10: return -0.9749279f;
      case 11: return -0.9749279f;
      case 12: return -0.7818315f;
      case 13: return -0.43388373f;
      default: return 0.f;
    }
  }
};

template <>
struct PairRoots<15> {
  static __device__ __forceinline__ float c(int m) {
    switch (m) {
      case 0: return 1.0f;
      case 1: return 0.9135454f;
      case 2: return 0.6691306f;
      case 3: return 0.309017f;
      case 4: return -0.104528464f;
      case 5: return -0.5f;
      case 6: return -0.809017f;
      case 7: return -0.9781476f;
      case 8: return -0.9781476f;
      case 9: return -0.809017f;
      case 10: return -0.5f;
      case 11: return -0.104528464f;
      case 12: return 0.309017f;
      case 13: return 0.6691306f;
      case 14: return 0.9135454f;
      default: return 0.f;
    }
  }
  static __device__ __forceinline__ float s(int m) {
    switch (m) {
      case 0: return 0.0f;
      case 1: return 0.40673664f;
      case 2: return 0.7431448f;
      case 3: return 0.95105654f;
      case 4: return 0.9945219f;
      case 5: return 0.8660254f;
      case 6: return 0.58778524f;
      case 7: return 0.20791169f;
      case 8: return -0.20791169f;
      case 9: return -0.58778524f;
      case 10: return -0.8660254f;
      case 11: return -0.9945219f;
      case 12: return -0.95105654f;
      case 13: return -0.7431448f;
      case 14: return -0.40673664f;
      default: return 0.f;
    }
  }
};

template <>
struct PairRoots<16> {
  static __device__ __forceinline__ float c(int m) {
    switch (m) {
      case 0: return 1.0f;
      case 1: return 0.9238795f;
      case 2: return 0.70710677f;
      case 3: return 0.38268343f;
      case 4: return 6.123234e-17f;
      case 5: return -0.38268343f;
      case 6: return -0.70710677f;
      case 7: return -0.9238795f;
      case 8: return -1.0f;
      case 9: return -0.9238795f;
      case 10: return -0.70710677f;
      case 11: return -0.38268343f;
      case 12: return -1.8369701e-16f;
      case 13: return 0.38268343f;
      case 14: return 0.70710677f;
      case 15: return 0.9238795f;
      default: return 0.f;
    }
  }
  static __device__ __forceinline__ float s(int m) {
    switch (m) {
      case 0: return 0.0f;
      case 1: return 0.38268343f;
      case 2: return 0.70710677f;
      case 3: return 0.9238795f;
      case 4: return 1.0f;
      case 5: return 0.9238795f;
      case 6: return 0.70710677f;
      case 7: return 0.38268343f;
      case 8: return 1.2246469e-16f;
      case 9: return -0.38268343f;
      case 10: return -0.70710677f;
      case 11: return -0.9238795f;
      case 12: return -1.0f;
      case 13: return -0.9238795f;
      case 14: return -0.70710677f;
      case 15: return -0.38268343f;
      default: return 0.f;
    }
  }
};

template <>
struct PairRoots<17> {
  static __device__ __forceinline__ float c(int m) {
    switch (m) {
      case 0: return 1.0f;
      case 1: return 0.9324722f;
      case 2: return 0.7390089f;
      case 3: return 0.44573835f;
      case 4: return 0.09226836f;
      case 5: return -0.27366298f;
      case 6: return -0.6026346f;
      case 7: return -0.85021716f;
      case 8: return -0.9829731f;
      case 9: return -0.9829731f;
      case 10: return -0.85021716f;
      case 11: return -0.6026346f;
      case 12: return -0.27366298f;
      case 13: return 0.09226836f;
      case 14: return 0.44573835f;
      case 15: return 0.7390089f;
      case 16: return 0.9324722f;
      default: return 0.f;
    }
  }
  static __device__ __forceinline__ float s(int m) {
    switch (m) {
      case 0: return 0.0f;
      case 1: return 0.36124167f;
      case 2: return 0.6736956f;
      case 3: return 0.8951633f;
      case 4: return 0.99573416f;
      case 5: return 0.96182567f;
      case 6: return 0.7980172f;
      case 7: return 0.52643216f;
      case 8: return 0.18374951f;
      case 9: return -0.18374951f;
      case 10: return -0.52643216f;
      case 11: return -0.7980172f;
      case 12: return -0.96182567f;
      case 13: return -0.99573416f;
      case 14: return -0.8951633f;
      case 15: return -0.6736956f;
      case 16: return -0.36124167f;
      default: return 0.f;
    }
  }
};

template <>
struct PairRoots<18> {
  static __device__ __forceinline__ float c(int m) {
    switch (m) {
      case 0: return 1.0f;
      case 1: return 0.9396926f;
      case 2: return 0.76604444f;
      case 3: return 0.5f;
      case 4: return 0.17364818f;
      case 5: return -0.17364818f;
      case 6: return -0.5f;
      case 7: return -0.76604444f;
      case 8: return -0.9396926f;
      case 9: return -1.0f;
      case 10: return -0.9396926f;
      case 11: return -0.76604444f;
      case 12: return -0.5f;
      case 13: return -0.17364818f;
      case 14: return 0.17364818f;
      case 15: return 0.5f;
      case 16: return 0.76604444f;
      case 17: return 0.9396926f;
      default: return 0.f;
    }
  }
  static __device__ __forceinline__ float s(int m) {
    switch (m) {
      case 0: return 0.0f;
      case 1: return 0.34202015f;
      case 2: return 0.64278764f;
      case 3: return 0.8660254f;
      case 4: return 0.9848077f;
      case 5: return 0.9848077f;
      case 6: return 0.8660254f;
      case 7: return 0.64278764f;
      case 8: return 0.34202015f;
      case 9: return 1.2246469e-16f;
      case 10: return -0.34202015f;
      case 11: return -0.64278764f;
      case 12: return -0.8660254f;
      case 13: return -0.9848077f;
      case 14: return -0.9848077f;
      case 15: return -0.8660254f;
      case 16: return -0.64278764f;
      case 17: return -0.34202015f;
      default: return 0.f;
    }
  }
};

template <>
struct PairRoots<19> {
  static __device__ __forceinline__ float c(int m) {
    switch (m) {
      case 0: return 1.0f;
      case 1: return 0.94581723f;
      case 2: return 0.7891405f;
      case 3: return 0.54694813f;
      case 4: return 0.24548548f;
      case 5: return -0.082579345f;
      case 6: return -0.40169543f;
      case 7: return -0.67728156f;
      case 8: return -0.87947375f;
      case 9: return -0.9863613f;
      case 10: return -0.9863613f;
      case 11: return -0.87947375f;
      case 12: return -0.67728156f;
      case 13: return -0.40169543f;
      case 14: return -0.082579345f;
      case 15: return 0.24548548f;
      case 16: return 0.54694813f;
      case 17: return 0.7891405f;
      case 18: return 0.94581723f;
      default: return 0.f;
    }
  }
  static __device__ __forceinline__ float s(int m) {
    switch (m) {
      case 0: return 0.0f;
      case 1: return 0.32469946f;
      case 2: return 0.6142127f;
      case 3: return 0.8371665f;
      case 4: return 0.9694003f;
      case 5: return 0.9965845f;
      case 6: return 0.91577333f;
      case 7: return 0.7357239f;
      case 8: return 0.47594738f;
      case 9: return 0.16459459f;
      case 10: return -0.16459459f;
      case 11: return -0.47594738f;
      case 12: return -0.7357239f;
      case 13: return -0.91577333f;
      case 14: return -0.9965845f;
      case 15: return -0.9694003f;
      case 16: return -0.8371665f;
      case 17: return -0.6142127f;
      case 18: return -0.32469946f;
      default: return 0.f;
    }
  }
};

template <>
struct PairRoots<20> {
  static __device__ __forceinline__ float c(int m) {
    switch (m) {
      case 0: return 1.0f;
      case 1: return 0.95105654f;
      case 2: return 0.809017f;
      case 3: return 0.58778524f;
      case 4: return 0.309017f;
      case 5: return 6.123234e-17f;
      case 6: return -0.309017f;
      case 7: return -0.58778524f;
      case 8: return -0.809017f;
      case 9: return -0.95105654f;
      case 10: return -1.0f;
      case 11: return -0.95105654f;
      case 12: return -0.809017f;
      case 13: return -0.58778524f;
      case 14: return -0.309017f;
      case 15: return -1.8369701e-16f;
      case 16: return 0.309017f;
      case 17: return 0.58778524f;
      case 18: return 0.809017f;
      case 19: return 0.95105654f;
      default: return 0.f;
    }
  }
  static __device__ __forceinline__ float s(int m) {
    switch (m) {
      case 0: return 0.0f;
      case 1: return 0.309017f;
      case 2: return 0.58778524f;
      case 3: return 0.809017f;
      case 4: return 0.95105654f;
      case 5: return 1.0f;
      case 6: return 0.95105654f;
      case 7: return 0.809017f;
      case 8: return 0.58778524f;
      case 9: return 0.309017f;
      case 10: return 1.2246469e-16f;
      case 11: return -0.309017f;
      case 12: return -0.58778524f;
      case 13: return -0.809017f;
      case 14: return -0.95105654f;
      case 15: return -1.0f;
      case 16: return -0.95105654f;
      case 17: return -0.809017f;
      case 18: return -0.58778524f;
      case 19: return -0.309017f;
      default: return 0.f;
    }
  }
};

template <>
struct PairRoots<21> {
  static __device__ __forceinline__ float c(int m) {
    switch (m) {
      case 0: return 1.0f;
      case 1: return 0.9555728f;
      case 2: return 0.82623875f;
      case 3: return 0.6234898f;
      case 4: return 0.36534104f;
      case 5: return 0.07473009f;
      case 6: return -0.22252093f;
      case 7: return -0.5f;
      case 8: return -0.7330519f;
      case 9: return -0.90096885f;
      case 10: return -0.9888308f;
      case 11: return -0.9888308f;
      case 12: return -0.90096885f;
      case 13: return -0.7330519f;
      case 14: return -0.5f;
      case 15: return -0.22252093f;
      case 16: return 0.07473009f;
      case 17: return 0.36534104f;
      case 18: return 0.6234898f;
      case 19: return 0.82623875f;
      case 20: return 0.9555728f;
      default: return 0.f;
    }
  }
  static __device__ __forceinline__ float s(int m) {
    switch (m) {
      case 0: return 0.0f;
      case 1: return 0.29475516f;
      case 2: return 0.56332004f;
      case 3: return 0.7818315f;
      case 4: return 0.93087375f;
      case 5: return 0.9972038f;
      case 6: return 0.9749279f;
      case 7: return 0.8660254f;
      case 8: return 0.68017274f;
      case 9: return 0.43388373f;
      case 10: return 0.14904226f;
      case 11: return -0.14904226f;
      case 12: return -0.43388373f;
      case 13: return -0.68017274f;
      case 14: return -0.8660254f;
      case 15: return -0.9749279f;
      case 16: return -0.9972038f;
      case 17: return -0.93087375f;
      case 18: return -0.7818315f;
      case 19: return -0.56332004f;
      case 20: return -0.29475516f;
      default: return 0.f;
    }
  }
};

template <>
struct PairRoots<22> {
  static __device__ __forceinline__ float c(int m) {
    switch (m) {
      case 0: return 1.0f;
      case 1: return 0.959493f;
      case 2: return 0.8412535f;
      case 3: return 0.65486073f;
      case 4: return 0.41541502f;
      case 5: return 0.14231484f;
      case 6: return -0.14231484f;
      case 7: return -0.41541502f;
      case 8: return -0.65486073f;
      case 9: return -0.8412535f;
      case 10: return -0.959493f;
      case 11: return -1.0f;
      case 12: return -0.959493f;
      case 13: return -0.8412535f;
      case 14: return -0.65486073f;
      case 15: return -0.41541502f;
      case 16: return -0.14231484f;
      case 17: return 0.14231484f;
      case 18: return 0.41541502f;
      case 19: return 0.65486073f;
      case 20: return 0.8412535f;
      case 21: return 0.959493f;
      default: return 0.f;
    }
  }
  static __device__ __forceinline__ float s(int m) {
    switch (m) {
      case 0: return 0.0f;
      case 1: return 0.28173256f;
      case 2: return 0.54064083f;
      case 3: return 0.7557496f;
      case 4: return 0.90963197f;
      case 5: return 0.98982143f;
      case 6: return 0.98982143f;
      case 7: return 0.90963197f;
      case 8: return 0.7557496f;
      case 9: return 0.54064083f;
      case 10: return 0.28173256f;
      case 11: return 1.2246469e-16f;
      case 12: return -0.28173256f;
      case 13: return -0.54064083f;
      case 14: return -0.7557496f;
      case 15: return -0.90963197f;
      case 16: return -0.98982143f;
      case 17: return -0.98982143f;
      case 18: return -0.90963197f;
      case 19: return -0.7557496f;
      case 20: return -0.54064083f;
      case 21: return -0.28173256f;
      default: return 0.f;
    }
  }
};

template <>
struct PairRoots<23> {
  static __device__ __forceinline__ float c(int m) {
    switch (m) {
      case 0: return 1.0f;
      case 1: return 0.96291727f;
      case 2: return 0.8544194f;
      case 3: return 0.6825532f;
      case 4: return 0.46006504f;
      case 5: return 0.20345601f;
      case 6: return -0.068242416f;
      case 7: return -0.3348796f;
      case 8: return -0.5766803f;
      case 9: return -0.7757113f;
      case 10: return -0.9172113f;
      case 11: return -0.99068594f;
      case 12: return -0.99068594f;
      case 13: return -0.9172113f;
      case 14: return -0.7757113f;
      case 15: return -0.5766803f;
      case 16: return -0.3348796f;
      case 17: return -0.068242416f;
      case 18: return 0.20345601f;
      case 19: return 0.46006504f;
      case 20: return 0.6825532f;
      case 21: return 0.8544194f;
      case 22: return 0.96291727f;
      default: return 0.f;
    }
  }
  static __device__ __forceinline__ float s(int m) {
    switch (m) {
      case 0: return 0.0f;
      case 1: return 0.26979676f;
      case 2: return 0.51958394f;
      case 3: return 0.730836f;
      case 4: return 0.8878852f;
      case 5: return 0.9790841f;
      case 6: return 0.99766874f;
      case 7: return 0.9422609f;
      case 8: return 0.8169699f;
      case 9: return 0.63108796f;
      case 10: return 0.39840108f;
      case 11: return 0.13616665f;
      case 12: return -0.13616665f;
      case 13: return -0.39840108f;
      case 14: return -0.63108796f;
      case 15: return -0.8169699f;
      case 16: return -0.9422609f;
      case 17: return -0.99766874f;
      case 18: return -0.9790841f;
      case 19: return -0.8878852f;
      case 20: return -0.730836f;
      case 21: return -0.51958394f;
      case 22: return -0.26979676f;
      default: return 0.f;
    }
  }
};

}  // namespace rf
