// The fused large Bluestein convolution: the port of K15.
//
// Replaces rustfft_tpu/ops/pallas/convlarge.py:_kernel_bconv (B_conv) and
// _kernel_a2 (A2); its kernel A (large._kernel_a after an XLA prologue) is
// the port's two-pass core column stage (csrc/conv_radix.cu), which loads
// the zero-padded, chirped input itself.  For a Bluestein of length n on an
// inner m = P * Q, in three launches:
//
//   A       (conv_col_stage): a[j2, k1] = w_m^(k1*j2) DFT_P(chirp . x)[k1],
//           written as (B, Q, P);
//   B_conv  (bconv_row_kernel): per (Q, pt) tile, FFT_Q over j2 -> k2 (the
//           first FFT's natural-order X[k2*P + k1]), z = conj(X . H[k2, k1]),
//           FFT_Q over k2 -> l1 in the same direction, times w_m^(l1*k1) (the
//           mirrored factorisation of the second FFT, convlarge.py:13-32),
//           written as (B, Q, P) [l1, k1];
//   A2      (bconv_out_kernel): per (qt, P) tile of rows l1, DFT_P over k1 ->
//           l2, out[l2*Q + l1] = chirp[l] . conj(.) for l < n, straight into
//           the (B, n) output.
//
// So the JAX package's `pkeep` row slice of DFT_P becomes the store mask
// l < n and its epilogue slice pass disappears.  Traversals: A reads n and
// writes m, B_conv reads and writes m, A2 reads m and writes n; the two-pass
// core makes four launches and eight traversals of m.
//
// What bounds it: memory (each kernel's bytes, tables included) and, in
// B_conv, two length-Q chains per tile on the CUDA cores in FP32.  B_conv
// holds one (Q, pt) tile in shared memory for both chains
// (ops/kernels/convlarge.py:bconv_tile).  The general kernel ping-pongs
// between two buffers, so at Q = 8192 only one column fits and its loads
// read 8 bytes per 32-byte sector (175 GB/s, PERF.md); there a compile-time
// chain runs both FFTs in place in one buffer instead, two columns per
// tile.  A2 stores 16 consecutive l1 per l2 (128-byte segments).
#include "large.cuh"

namespace rf {

// B_conv over (batch, P/pt) blocks: x, y (batch, Q, P); h, outer (Q, P).
__global__ void __launch_bounds__(512) bconv_row_kernel(const float2* __restrict__ x,
                                                        float2* __restrict__ y, int q, int p,
                                                        int pt, Stages st,
                                                        const float2* __restrict__ h,
                                                        const float2* __restrict__ outer) {
  extern __shared__ float2 smem[];
  const int elems = q * pt;
  float2* a = smem;
  float2* b = smem + pad16(elems);
  float2* sroots = smem + 2 * pad16(elems);
  load_roots(st, sroots);
  const int tiles = p / pt;
  const size_t batch_idx = blockIdx.x / tiles;
  const int p0 = (int)(blockIdx.x % tiles) * pt;
  const size_t base = batch_idx * (size_t)q * (size_t)p + p0;
  for (int f = threadIdx.x; f < elems; f += blockDim.x) {
    const int j2 = f / pt, t = f - j2 * pt;
    a[swz(f)] = x[base + (size_t)j2 * p + t];
  }
  __syncthreads();
  float2* res = fft_tile(a, b, q, pt, st, sroots);  // [k2, k1]
  for (int f = threadIdx.x; f < elems; f += blockDim.x) {
    const int k2 = f / pt, t = f - k2 * pt;
    float2 v = cmul(res[swz(f)], __ldg(&h[(size_t)k2 * p + p0 + t]));
    v.y = -v.y;
    res[swz(f)] = v;
  }
  __syncthreads();
  const float2* out = fft_tile(res, res == a ? b : a, q, pt, st, sroots);  // [l1, k1]
  for (int f = threadIdx.x; f < elems; f += blockDim.x) {
    const int l1 = f / pt, t = f - l1 * pt;
    const size_t i = (size_t)l1 * p + p0 + t;
    y[base + (size_t)l1 * p + t] = cmul(out[swz(f)], __ldg(&outer[i]));
  }
}

// B_conv for one compile-time length-Q chain and tile width T: both chains
// in place in one (Q, T) buffer (fixed_chain), so a tile of T = 2 columns
// fits at Q = 8192, where the general kernel's two buffers hold one.  Chain
// 1 reads the tile from device memory, conj(. * H) is a pass over the tile,
// chain 2 runs in the tile, and the store multiplies by the outer twiddle.
// At <2, 32, 16, 16> (512 threads, 128 registers) ptxas reports 316 bytes
// of spill stores (tools/torch_ptxas.py on the H100's toolkit).
template <int T, int R0, int R1, int R2>
__global__ void __launch_bounds__(kFixedThreads<T, R0, R1, R2>)
    bconv_fixed_kernel(const float2* __restrict__ x, float2* __restrict__ y, int p, Stages st,
                       const float2* __restrict__ h, const float2* __restrict__ outer) {
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
  fixed_chain<T, R0, R1, R2>(GlobalIn<T>{x + base, (size_t)p}, SmemTile{buf}, buf, sroots, st);
  __syncthreads();
  for (int f = threadIdx.x; f < Q * T; f += blockDim.x) {  // [k2, t]
    const float2 v = cmul(buf[swz(f)], __ldg(&h[(size_t)(f / T) * p + p0 + f % T]));
    buf[swz(f)] = make_float2(v.x, -v.y);
  }
  __syncthreads();
  fixed_chain<T, R0, R1, R2>(SmemTile{buf}, SmemTile{buf}, buf, sroots, st);
  __syncthreads();
  for (int f = threadIdx.x; f < Q * T; f += blockDim.x) {  // [l1, t]
    const size_t i = (size_t)(f / T) * p + f % T;
    y[base + i] = cmul(buf[swz(f)], __ldg(&outer[p0 + i]));
  }
}

template <int T, int R0, int R1, int R2>
static cudaError_t launch_bconv_fixed(const float2* x, float2* y, long long blocks, int p,
                                      const Stages& st, const float2* h, const float2* outer,
                                      cudaStream_t s) {
  const size_t smem = (size_t)(R0 * R1 * R2 * T + R0 + R1 + R2) * sizeof(float2);
  cudaError_t err = allow_smem(bconv_fixed_kernel<T, R0, R1, R2>, smem);
  if (err != cudaSuccess) return err;
  bconv_fixed_kernel<T, R0, R1, R2>
      <<<(unsigned)blocks, kFixedThreads<T, R0, R1, R2>, smem, s>>>(x, y, p, st, h, outer);
  return cudaGetLastError();
}

// A2 over (batch, Q/qt) blocks: x (batch, Q, P) [l1, k1]; y (batch, n);
// chirp (n,).
__global__ void __launch_bounds__(256) bconv_out_kernel(const float2* __restrict__ x,
                                                        float2* __restrict__ y, int p, int q,
                                                        int qt, int n, Stages st,
                                                        const float2* __restrict__ chirp) {
  extern __shared__ float2 smem[];
  const int elems = p * qt;
  float2* a = smem;
  float2* b = smem + pad16(elems);
  float2* sroots = smem + 2 * pad16(elems);
  load_roots(st, sroots);
  const int tiles = q / qt;
  const size_t batch_idx = blockIdx.x / tiles;
  const int q0 = (int)(blockIdx.x % tiles) * qt;
  const float2* xb = x + batch_idx * (size_t)q * (size_t)p + (size_t)q0 * p;
  for (int f = threadIdx.x; f < elems; f += blockDim.x) {
    const int t = f / p, k1 = f - t * p;
    a[swz(k1 * qt + t)] = xb[(size_t)t * p + k1];
  }
  __syncthreads();
  const float2* res = fft_tile(a, b, p, qt, st, sroots);  // [l2, t]
  float2* yb = y + batch_idx * (size_t)n;
  for (int f = threadIdx.x; f < elems; f += blockDim.x) {
    const int l2 = f / qt, t = f - l2 * qt;
    const long long l = (long long)l2 * q + q0 + t;
    if (l >= n) continue;
    const float2 d = res[swz(f)];
    const float2 c = __ldg(&chirp[l]);
    yb[l] = make_float2(d.x * c.x + d.y * c.y, d.x * c.y - d.y * c.x);  // chirp . conj(d)
  }
}

}  // namespace rf

// x, y: (batch, Q, P) complex64 (not the same buffer), Q = product of the
// radices of `st`, pt divides P; h, outer: (Q, P).  Returns a cudaError_t
// code; launches on `stream`.
extern "C" int rf_bconv_row_stage(const void* x, void* y, long long batch, int q, int p, int pt,
                                  int k, int r0, int r1, int r2, const void* roots0,
                                  const void* roots1, const void* roots2, const void* tw0,
                                  const void* tw1, const void* h, const void* outer,
                                  void* stream) {
  using namespace rf;
  if (batch <= 0 || p <= 0 || pt <= 0 || p % pt != 0 || h == nullptr || outer == nullptr)
    return cudaErrorInvalidValue;
  const Stages st = make_stages(k, r0, r1, r2, roots0, roots1, roots2, tw0, tw1);
  if (!stages_ok(st, q)) return cudaErrorInvalidValue;
  const long long blocks = batch * (p / pt);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const auto* xp = static_cast<const float2*>(x);
  auto* yp = static_cast<float2*>(y);
  const auto* hp = static_cast<const float2*>(h);
  const auto* op = static_cast<const float2*>(outer);
  auto s = static_cast<cudaStream_t>(stream);
  // the compile-time chain of the 1000003 path, Q = 8192 (m = 2^21;
  // ops/kernels/convlarge.py FIXED_BCONV)
  if (k == 3 && r0 == 32 && r1 == 16 && r2 == 16 && pt == 2)
    return launch_bconv_fixed<2, 32, 16, 16>(xp, yp, blocks, p, st, hp, op, s);
  const size_t smem = tile_smem_bytes(q * pt, st);
  cudaError_t err = allow_smem(bconv_row_kernel, smem);
  if (err != cudaSuccess) return err;
  bconv_row_kernel<<<(unsigned)blocks, 512, smem, s>>>(xp, yp, q, p, pt, st, hp, op);
  return cudaGetLastError();
}

// x: (batch, Q, P) complex64, P = product of the radices of `st`, qt
// divides Q; y: (batch, n) with n <= P*Q; chirp: (n,).  Returns a
// cudaError_t code; launches on `stream`.
extern "C" int rf_bconv_out_stage(const void* x, void* y, long long batch, int p, int q, int qt,
                                  int n, int k, int r0, int r1, int r2, const void* roots0,
                                  const void* roots1, const void* roots2, const void* tw0,
                                  const void* tw1, const void* chirp, void* stream) {
  using namespace rf;
  if (batch <= 0 || q <= 0 || qt <= 0 || q % qt != 0 || n <= 0 ||
      (long long)n > (long long)p * q || chirp == nullptr)
    return cudaErrorInvalidValue;
  const Stages st = make_stages(k, r0, r1, r2, roots0, roots1, roots2, tw0, tw1);
  if (!stages_ok(st, p)) return cudaErrorInvalidValue;
  const long long blocks = batch * (q / qt);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = tile_smem_bytes(p * qt, st);
  cudaError_t err = allow_smem(bconv_out_kernel, smem);
  if (err != cudaSuccess) return err;
  bconv_out_kernel<<<(unsigned)blocks, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(y), p, q, qt, n, st,
      static_cast<const float2*>(chirp));
  return cudaGetLastError();
}
