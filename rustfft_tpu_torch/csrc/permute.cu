// Fixed permutation of batched rows: the port of K16.
//
// Replaces rustfft_tpu/ops/pallas/permute.py:_kernel (with _apply_phases):
// out[b, i] = x[b, idx[i]] over (batch, m) complex64, the Rader root-order
// gathers and the Good-Thomas index maps.  The TPU kernel runs five Benes
// phases because a Mosaic gather stays inside one 128-lane vreg; a CUDA
// thread loads from any address, so this is one gather.
//
// What bounds it on this card: one read and one write of 8 bytes per point.
// A gather straight from device memory writes contiguously but reads
// anywhere in the row, so a warp's load touches up to 32 sectors instead
// of 8 and leans on the 50 MB L2 to absorb the rest.
//
// Design: rows that fit shared memory (`rows` > 0, ops/kernels/permute.py
// smem_rows) are read whole.  A block takes a group of `rows` consecutive
// rows, one contiguous run of rows*m values: it copies them into shared
// memory with cp.async (16 bytes a thread where every row starts 16-byte
// aligned, else 8), then gathers y[b, i] = s[b][idx[i]] from shared memory,
// its stores as contiguous as its loads (16 bytes a thread where m is even).
// The index table (m ints) is read through the read-only cache for every
// row.  Several blocks an SM overlap one block's copy with another's gather
// (a persistent block that copied its next group while it gathered read
// slower on the H100).  Longer rows keep the direct gather (`rows` =
// 0): blockIdx.x covers 256 consecutive outputs i of a row, blockIdx.y
// strides over the batch, each thread loading its index once for every row
// it visits.  Offsets into device memory are size_t.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace rf {

constexpr int kPermuteThreads = 256;
// bytes of shared memory a block may take (csrc/fft_tile.cuh kSmemMax)
constexpr size_t kPermuteSmemMax = 232448;

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

// kVec values (8 bytes each) a copy: 2 where the rows start 16-byte aligned.
template <int kVec>
static __device__ __forceinline__ void cp_async_vals(float2* dst, const float2* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  if constexpr (kVec == 2) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
  }
}

// Start the copy of the n values at x + off into s, as one cp.async group.
template <int kVec>
static __device__ __forceinline__ void copy_group(float2* s, const float2* __restrict__ x,
                                                  size_t off, int n) {
  for (int e = threadIdx.x * kVec; e < n; e += kPermuteThreads * kVec)
    cp_async_vals<kVec>(s + e, x + off + e);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Block g copies group g (rows g*rows ..) into shared memory and gathers
// it.  With kVec = 2 (m even, x and y 16-byte aligned) a thread gathers two
// neighbouring outputs and stores them as one 16-byte value.
template <int kVec>
__global__ void __launch_bounds__(kPermuteThreads)
    permute_smem_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                        const int* __restrict__ idx, long long batch, int m, int rows) {
  extern __shared__ float2 s[];
  const int stage = rows * m;
  const long long g = blockIdx.x;
  const int n = (int)(batch - g * rows < rows ? batch - g * rows : rows) * m;
  copy_group<kVec>(s, x, (size_t)g * (size_t)stage, n);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  constexpr int kStep = kVec * kPermuteThreads;
  const int drow = kStep / m, di = kStep % m;
  float2* out = y + (size_t)g * (size_t)stage;
  int row = (int)threadIdx.x * kVec / m, i = (int)threadIdx.x * kVec % m;
  for (int e = threadIdx.x * kVec; e < n; e += kStep) {
    const float2* src = s + row * m;
    if constexpr (kVec == 2) {
      const int2 j = __ldg(reinterpret_cast<const int2*>(idx + i));
      const float2 a = src[j.x], b = src[j.y];
      *reinterpret_cast<float4*>(out + e) = make_float4(a.x, a.y, b.x, b.y);
    } else {
      out[e] = src[__ldg(&idx[i])];
    }
    row += drow;
    i += di;
    if (i >= m) {
      i -= m;
      ++row;
    }
  }
}

}  // namespace rf

// x, y: (batch, m) complex64; idx: (m,) int32, a permutation of range(m)
// (checked by the caller); rows: the rows of a group, which a block reads
// whole into shared memory (ops/kernels/permute.py smem_rows; rows*m values
// at most 227 KB), 0 for the direct gather.
// Returns a cudaError_t code; launches on `stream`.
extern "C" int rf_permute(const void* x, void* y, const void* idx, long long batch, int m,
                          int rows, void* stream) {
  using namespace rf;
  if (batch <= 0 || m <= 0 || rows < 0 || x == nullptr || y == nullptr || idx == nullptr)
    return cudaErrorInvalidValue;
  const auto* tx = static_cast<const float2*>(x);
  auto* ty = static_cast<float2*>(y);
  const auto* ti = static_cast<const int*>(idx);
  const auto s = static_cast<cudaStream_t>(stream);
  if (rows == 0) {
    const dim3 grid((unsigned)((m + kPermuteThreads - 1) / kPermuteThreads),
                    (unsigned)(batch < 65535 ? batch : 65535));
    permute_kernel<<<grid, kPermuteThreads, 0, s>>>(tx, ty, ti, batch, m);
    return cudaGetLastError();
  }
  const size_t smem = (size_t)rows * (size_t)m * sizeof(float2);
  const long long blocks = (batch + rows - 1) / rows;
  if (smem > kPermuteSmemMax || blocks > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(x) % alignof(float2) != 0 ||
      reinterpret_cast<uintptr_t>(y) % alignof(float2) != 0)
    return cudaErrorInvalidValue;
  const bool vec2 = m % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(idx) % 8 == 0;
  const auto kernel = vec2 ? permute_smem_kernel<2> : permute_smem_kernel<1>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(unsigned)blocks, kPermuteThreads, smem, s>>>(tx, ty, ti, batch, m, rows);
  return cudaGetLastError();
}
