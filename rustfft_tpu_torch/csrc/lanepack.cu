// Whole small transforms, one per block: the port of K1.
//
// Replaces rustfft_tpu/ops/pallas/lanepack.py:_kernel (with _fft_sublane and
// _stage_consts): a batch of length-n transforms, n = r0*r1[*r2] with every
// radix <= 256, each computed as 2-3 DFT stages with twiddles between them,
// in one read and one write of device memory.
//
// What bounds it on this card: one read and one write of 8 bytes per point
// is 16 bytes / 3.35 TB/s per point, the floor.  Arithmetic is FP32 on the
// CUDA cores.  The reference's split (256, 16) costs 272 complex
// multiply-adds per point as dense stages, which makes the kernel
// compute-bound here (measured 15x slower than (16, 16, 16)); the port
// picks the split with the least per-radix cost
// (ops/kernels/lanepack.py:choose_radices) and runs radices up to 16 as
// register stages (radix-2 FFTs for powers of 2: ~14 FLOPs per point per
// radix-16 stage).  What is left between it and the floor is latency: a
// block's global loads, stages and stores run in turn.
//
// Design: one block owns one whole transform in shared memory (two n*8-byte
// buffers), so the batch needs no padding and a ragged batch needs no mask:
// the grid is the batch.  Loads and stores are contiguous 8-byte accesses
// over the transform.  The main-path chain (16, 16, 16) has a compile-time
// kernel (fixed_chain: 52 registers, one buffer, stage 0 read from and the
// last stage written to device memory).  The TPU kernel's lane<->sublane
// transposes, 128-row batch groups, lane padding and bf16 hi/lo tables have
// no counterpart here.
#include "fft_tile.cuh"

namespace rf {

__global__ void __launch_bounds__(256) lanepack_kernel(const float2* __restrict__ x,
                                                       float2* __restrict__ y, int n,
                                                       Stages st) {
  extern __shared__ float2 smem[];
  float2* a = smem;
  float2* b = smem + pad16(n);
  float2* sroots = smem + 2 * pad16(n);
  load_roots(st, sroots);
  const size_t base = (size_t)blockIdx.x * (size_t)n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) a[swz(i)] = x[base + i];
  __syncthreads();
  const float2* res = fft_tile(a, b, n, 1, st, sroots);
  for (int i = threadIdx.x; i < n; i += blockDim.x) y[base + i] = res[swz(i)];
}

// lanepack_kernel for one compile-time chain (fixed_chain): stage 0 reads
// the transform from device memory, the last stage writes it back.
template <int R0, int R1, int R2>
__global__ void __launch_bounds__(kFixedThreads<1, R0, R1, R2>)
    lanepack_fixed_kernel(const float2* __restrict__ x, float2* __restrict__ y, Stages st) {
  constexpr int N = R0 * R1 * R2;
  __shared__ float2 buf[N];
  __shared__ float2 sroots[R0 + R1 + R2];
  load_roots(st, sroots);
  __syncthreads();
  const size_t base = (size_t)blockIdx.x * N;
  fixed_chain<1, R0, R1, R2>(GlobalIn<1>{x + base, 1}, GlobalOut<1>{y + base, 1}, buf,
                             sroots, st);
}

}  // namespace rf

extern "C" const char* rf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, y: (batch, n) complex64 on the current device; roots/tw as in Stages.
// Returns a cudaError_t code (0 on success); launches on `stream`.
extern "C" int rf_lanepack_fft(const void* x, void* y, long long batch, int n, int k, int r0,
                               int r1, int r2, const void* roots0, const void* roots1,
                               const void* roots2, const void* tw0, const void* tw1,
                               void* stream) {
  using namespace rf;
  if (batch <= 0 || batch > 0x7fffffffLL) return cudaErrorInvalidValue;
  const Stages st = make_stages(k, r0, r1, r2, roots0, roots1, roots2, tw0, tw1);
  if (!stages_ok(st, n)) return cudaErrorInvalidValue;
  if (k == 3 && r0 == 16 && r1 == 16 && r2 == 16) {  // n = 4096, the main path
    lanepack_fixed_kernel<16, 16, 16><<<(unsigned)batch, kFixedThreads<1, 16, 16, 16>, 0,
                                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(x), static_cast<float2*>(y), st);
    return cudaGetLastError();
  }
  const size_t smem = tile_smem_bytes(n, st);
  cudaError_t err = allow_smem(lanepack_kernel, smem);
  if (err != cudaSuccess) return err;
  int threads = (n / 16 + 31) / 32 * 32;
  threads = threads < 64 ? 64 : (threads > 256 ? 256 : threads);
  lanepack_kernel<<<(unsigned)batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(y), n, st);
  return cudaGetLastError();
}
