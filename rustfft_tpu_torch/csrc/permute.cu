// Fixed permutation of batched rows: the port of K16.
//
// Replaces rustfft_tpu/ops/pallas/permute.py:_kernel (with _apply_phases):
// out[b, i] = x[b, idx[i]] over (batch, m) complex64, the Rader root-order
// gathers and the Good-Thomas index maps.  The TPU kernel runs five Benes
// phases because a Mosaic gather stays inside one 128-lane vreg; a CUDA
// thread loads from any address, so this is one gather.
//
// What bounds it on this card: one read and one write of 8 bytes per point.
// Writes are contiguous; reads land anywhere in the row, so a warp touches
// up to 32 sectors per load instead of 8.  Rows of up to a few MB stay in the
// 50 MB L2, which absorbs most of that.
//
// Design: blockIdx.x covers 256 consecutive outputs i of a row, blockIdx.y
// strides over the batch; each thread loads its index once and reuses it for
// every row it visits.  Offsets into device memory are size_t.
#include <cuda_runtime.h>
#include <stddef.h>

namespace rf {

constexpr int kPermuteThreads = 256;

__global__ void __launch_bounds__(kPermuteThreads)
    permute_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                   const int* __restrict__ idx, long long batch, int m) {
  const int i = blockIdx.x * kPermuteThreads + threadIdx.x;
  if (i >= m) return;
  const size_t src = (size_t)__ldg(&idx[i]);
  for (long long b = blockIdx.y; b < batch; b += gridDim.y) {
    const size_t row = (size_t)b * (size_t)m;
    y[row + i] = __ldg(&x[row + src]);
  }
}

}  // namespace rf

// x, y: (batch, m) complex64; idx: (m,) int32, a permutation of range(m)
// (checked by the caller).  Returns a cudaError_t code; launches on `stream`.
extern "C" int rf_permute(const void* x, void* y, const void* idx, long long batch, int m,
                          void* stream) {
  using namespace rf;
  if (batch <= 0 || m <= 0 || x == nullptr || y == nullptr || idx == nullptr)
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((m + kPermuteThreads - 1) / kPermuteThreads),
                  (unsigned)(batch < 65535 ? batch : 65535));
  permute_kernel<<<grid, kPermuteThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(y), static_cast<const int*>(idx),
      batch, m);
  return cudaGetLastError();
}
