// The two-pass large-n pipeline: the ports of K2 (column stage) and K3 (row
// stage).  n = P * Q, input x viewed as (B, P, Q) [j1, j2].
//
// large_col_kernel replaces rustfft_tpu/ops/pallas/large.py:_kernel_a:
//   a[b, j2, k1] = w_n^(k1*j2) * sum_j1 x[b, j1, j2] * w_P^(j1*k1),
// written as (B, Q, P).  large_row_kernel replaces large.py:_kernel_b (with
// fftq_sublane): a length-Q FFT over j2 for every k1, written in natural
// order X[b, k2*P + k1].  Two reads and two writes of the signal in device
// memory, as on the TPU.
//
// What bounds them on this card: memory alone is 32 bytes per point over the
// two passes.  Arithmetic is FP32 on the CUDA cores.  The TPU kernels
// contract a dense DFT_P (256 multiply-adds per point at P = 256) and split
// Q as q1 x q2 (128 at Q = 64 x 64), which their matrix unit absorbs; here
// both stages instead compute their DFT in the cheapest radix stages (16 x 16
// for P = 256, 16 x 16 x 16 for Q = 4096) as register FFTs, an exact DFT
// either way, and latency (loads, stages and stores of a block in turn;
// one 1024-thread row-stage block per SM) is what remains.
//
// Design: the column stage's block loads a (P, qt) tile, 16 consecutive j2
// per row (128-byte segments), runs DFT_P on its qt columns in shared memory,
// and stores the transposed (qt, P) tile with the outer twiddle, so both the
// loads and the stores are contiguous.  The row stage's block holds a
// (Q, pt) tile in shared memory: at Q = 4096 the TPU's 128-lane tile would
// be 4 MiB; the main path's compile-time kernel takes pt = 4 (32-byte row
// segments, one sector; 1024 threads, 128 KiB in place), the general kernel
// pt = 2 or 1.  The main-path chains (P = 16 x 16 over qt = 16 columns,
// Q = 16 x 16 x 16 over pt = 4) have compile-time kernels (fixed_chain) that
// also read stage 0 from, and the row stage's last stage write to, device
// memory directly.  Grids are one-dimensional over (batch, tile) and every
// offset into device memory is size_t: batch 1024 at n = 2^20 is 2^31
// floats.
#include "fft_tile.cuh"

namespace rf {

__global__ void __launch_bounds__(256) large_col_kernel(const float2* __restrict__ x,
                                                        float2* __restrict__ y, int p, int q,
                                                        int qt, Stages st,
                                                        const float2* __restrict__ tw_outer) {
  extern __shared__ float2 smem[];
  const int elems = p * qt;
  float2* a = smem;
  float2* b = smem + pad16(elems);
  float2* sroots = smem + 2 * pad16(elems);
  load_roots(st, sroots);
  const int tiles = q / qt;
  const size_t batch_idx = blockIdx.x / tiles;
  const int q0 = (int)(blockIdx.x % tiles) * qt;
  const size_t base = batch_idx * (size_t)p * (size_t)q;
  for (int f = threadIdx.x; f < elems; f += blockDim.x) {
    const int j1 = f / qt, t = f - j1 * qt;
    a[swz(f)] = x[base + (size_t)j1 * q + q0 + t];
  }
  __syncthreads();
  const float2* res = fft_tile(a, b, p, qt, st, sroots);
  for (int f = threadIdx.x; f < elems; f += blockDim.x) {
    const int t = f / p, k1 = f - t * p;
    const size_t at = (size_t)(q0 + t) * p + k1;
    y[base + at] = cmul(res[swz(k1 * qt + t)], __ldg(&tw_outer[at]));
  }
}

__global__ void __launch_bounds__(512) large_row_kernel(const float2* __restrict__ x,
                                                        float2* __restrict__ y, int q, int p,
                                                        int pt, Stages st) {
  extern __shared__ float2 smem[];
  const int elems = q * pt;
  float2* a = smem;
  float2* b = smem + pad16(elems);
  float2* sroots = smem + 2 * pad16(elems);
  load_roots(st, sroots);
  const int tiles = p / pt;
  const size_t batch_idx = blockIdx.x / tiles;
  const int p0 = (int)(blockIdx.x % tiles) * pt;
  const size_t base = batch_idx * (size_t)q * (size_t)p;
  for (int f = threadIdx.x; f < elems; f += blockDim.x) {
    const int j2 = f / pt, t = f - j2 * pt;
    a[swz(f)] = x[base + (size_t)j2 * p + p0 + t];
  }
  __syncthreads();
  const float2* res = fft_tile(a, b, q, pt, st, sroots);
  for (int f = threadIdx.x; f < elems; f += blockDim.x) {
    const int k2 = f / pt, t = f - k2 * pt;
    y[base + (size_t)k2 * p + p0 + t] = res[swz(f)];
  }
}

// large_col_kernel for one compile-time DFT_P chain and tile width T.
template <int T, int R0, int R1, int R2>
__global__ void __launch_bounds__(kFixedThreads<T, R0, R1, R2>)
    large_col_fixed_kernel(const float2* __restrict__ x, float2* __restrict__ y, int q,
                           Stages st, const float2* __restrict__ tw_outer) {
  constexpr int P = R0 * R1 * R2;
  __shared__ float2 buf[P * T];
  __shared__ float2 sroots[R0 + R1 + R2];
  load_roots(st, sroots);
  __syncthreads();
  const int tiles = q / T;
  const size_t batch_idx = blockIdx.x / tiles;
  const int q0 = (int)(blockIdx.x % tiles) * T;
  const size_t base = batch_idx * (size_t)P * (size_t)q;
  fixed_chain<T, R0, R1, R2>(GlobalIn<T>{x + base + q0, (size_t)q}, SmemTile{buf}, buf,
                             sroots, st);
  __syncthreads();
  for (int f = threadIdx.x; f < P * T; f += blockDim.x) {
    const int t = f / P, k1 = f % P;
    const size_t at = (size_t)(q0 + t) * P + k1;
    y[base + at] = cmul(buf[swz(k1 * T + t)], __ldg(&tw_outer[at]));
  }
}

// large_row_kernel for one compile-time length-Q chain and tile width T:
// stage 0 reads the (Q, T) window from device memory, the last stage
// writes it back.
template <int T, int R0, int R1, int R2>
__global__ void __launch_bounds__(kFixedThreads<T, R0, R1, R2>)
    large_row_fixed_kernel(const float2* __restrict__ x, float2* __restrict__ y, int p,
                           Stages st) {
  constexpr int Q = R0 * R1 * R2;
  extern __shared__ float2 smem[];
  float2* buf = smem;
  float2* sroots = smem + Q * T;
  load_roots(st, sroots);
  __syncthreads();
  const int tiles = p / T;
  const size_t batch_idx = blockIdx.x / tiles;
  const int p0 = (int)(blockIdx.x % tiles) * T;
  const size_t base = batch_idx * (size_t)Q * (size_t)p + p0;
  fixed_chain<T, R0, R1, R2>(GlobalIn<T>{x + base, (size_t)p}, GlobalOut<T>{y + base, (size_t)p},
                             buf, sroots, st);
}

}  // namespace rf

// x: (batch, P, Q), y: (batch, Q, P), complex64; P = product of the radices
// of `st`, qt divides Q.  Returns a cudaError_t code; launches on `stream`.
extern "C" int rf_large_col_stage(const void* x, void* y, long long batch, int p, int q,
                                  int qt, int k, int r0, int r1, int r2, const void* roots0,
                                  const void* roots1, const void* roots2, const void* tw0,
                                  const void* tw1, const void* tw_outer, void* stream) {
  using namespace rf;
  if (batch <= 0 || q <= 0 || qt <= 0 || q % qt != 0) return cudaErrorInvalidValue;
  const long long blocks = batch * (q / qt);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const Stages st = make_stages(k, r0, r1, r2, roots0, roots1, roots2, tw0, tw1);
  if (!stages_ok(st, p) || tw_outer == nullptr) return cudaErrorInvalidValue;
  if (k == 2 && r0 == 16 && r1 == 16 && qt == 16) {  // P = 256, the main path
    large_col_fixed_kernel<16, 16, 16, 1><<<(unsigned)blocks, kFixedThreads<16, 16, 16, 1>, 0,
                                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(x), static_cast<float2*>(y), q, st,
        static_cast<const float2*>(tw_outer));
    return cudaGetLastError();
  }
  const size_t smem = tile_smem_bytes(p * qt, st);
  cudaError_t err = allow_smem(large_col_kernel, smem);
  if (err != cudaSuccess) return err;
  large_col_kernel<<<(unsigned)blocks, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(y), p, q, qt, st,
      static_cast<const float2*>(tw_outer));
  return cudaGetLastError();
}

// x, y: (batch, Q, P) complex64, Q = product of the radices of `st`, pt
// divides P.  Returns a cudaError_t code; launches on `stream`.
extern "C" int rf_large_row_stage(const void* x, void* y, long long batch, int q, int p,
                                  int pt, int k, int r0, int r1, int r2, const void* roots0,
                                  const void* roots1, const void* roots2, const void* tw0,
                                  const void* tw1, void* stream) {
  using namespace rf;
  if (batch <= 0 || p <= 0 || pt <= 0 || p % pt != 0) return cudaErrorInvalidValue;
  const long long blocks = batch * (p / pt);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const Stages st = make_stages(k, r0, r1, r2, roots0, roots1, roots2, tw0, tw1);
  if (!stages_ok(st, q)) return cudaErrorInvalidValue;
  if (k == 3 && r0 == 16 && r1 == 16 && r2 == 16 && pt == 4) {  // Q = 4096: large.py FIXED_ROW
    const size_t smem = (4096 * 4 + 48) * sizeof(float2);
    cudaError_t err = allow_smem(large_row_fixed_kernel<4, 16, 16, 16>, smem);
    if (err != cudaSuccess) return err;
    large_row_fixed_kernel<4, 16, 16, 16><<<(unsigned)blocks, kFixedThreads<4, 16, 16, 16>, smem,
                                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(x), static_cast<float2*>(y), p, st);
    return cudaGetLastError();
  }
  const size_t smem = tile_smem_bytes(q * pt, st);
  cudaError_t err = allow_smem(large_row_kernel, smem);
  if (err != cudaSuccess) return err;
  large_row_kernel<<<(unsigned)blocks, 512, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(y), q, p, pt, st);
  return cudaGetLastError();
}
