// One-pass double-FFT convolution: the port of K13 and K6.
//
// Replaces rustfft_tpu/ops/pallas/conv.py:_kernel (m = p*q with q a multiple
// of 128, m on lanes) and rustfft_tpu/ops/pallas/lanepack.py:_conv_kernel
// (any m with a radix split, m on sublanes).  Both compute the Bluestein /
// Rader core
//
//   out = [post .] maybe_conj( FFT_m( conj( FFT_m([pre .] zeropad(x)) . H ) ) )
//
// with both FFTs in the plan's direction (the conjugation trick).  The two
// TPU kernels differ only in where m sits in a vreg; the card has no
// 128-lane rule, so one kernel serves both.
//
// What bounds it on this card: one read of n_in and one write of n_out
// points per transform, plus two FFT_m chains of FP32 work on the CUDA cores
// (the lanepack chain's cost, twice) and the H table, which every block
// reads from L2.  At the prime path's shapes (m = 1008, 3072) the chains
// dominate, as in K1.
//
// Design: one block owns one transform in shared memory, on fft_tile.cuh's
// two-buffer tile (two m*8-byte buffers and the roots), so the grid is the
// batch and a ragged n_in / n_out is a per-element bound, not a tile mask.
// Load with the pre-multiply (zero beyond n_in), run the fft_tile chain,
// multiply by H and conjugate in place (H is in natural order, the order the
// chain leaves), run the chain again from that buffer, and store the first
// n_out outputs with conj and post.  The TPU kernel's [k1, k2]-transposed H,
// mirrored second factorisation, row-group trims and bf16 tables have no
// counterpart here.  The Bluestein 1234 chain (m = 3072) has a compile-time
// kernel (fixed_chain: one buffer, the first chain reading from and the
// second writing to device memory): at 8192 rows on the H100 it was faster
// than the general kernel in 10 of 10 alternated rounds (median 0.553
// against 0.583 ms).  At m = 1008 it was faster in 2 of 10 (0.299 against
// 0.287), so that chain runs the general kernel.
#include "fft_tile.cuh"

namespace rf {

__global__ void __launch_bounds__(256) conv_fft_kernel(const float2* __restrict__ x,
                                                       float2* __restrict__ y, int n_in,
                                                       int n_out, int m, Stages st,
                                                       const float2* __restrict__ h,
                                                       const float2* __restrict__ pre,
                                                       const float2* __restrict__ post,
                                                       int conj_out) {
  extern __shared__ float2 smem[];
  float2* a = smem;
  float2* b = smem + pad16(m);
  float2* sroots = smem + 2 * pad16(m);
  load_roots(st, sroots);
  const float2* xr = x + (size_t)blockIdx.x * (size_t)n_in;
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    float2 v = make_float2(0.f, 0.f);
    if (i < n_in) {
      v = xr[i];
      if (pre != nullptr) v = cmul(v, __ldg(&pre[i]));
    }
    a[swz(i)] = v;
  }
  __syncthreads();
  float2* res = fft_tile(a, b, m, 1, st, sroots);
  float2* other = res == a ? b : a;
  // z = conj(Y . H), in place: each element is read and written by one thread
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const float2 v = cmul(res[swz(i)], __ldg(&h[i]));
    res[swz(i)] = make_float2(v.x, -v.y);
  }
  __syncthreads();
  res = fft_tile(res, other, m, 1, st, sroots);
  float2* yr = y + (size_t)blockIdx.x * (size_t)n_out;
  for (int i = threadIdx.x; i < n_out; i += blockDim.x) {
    float2 v = res[swz(i)];
    if (conj_out) v.y = -v.y;
    if (post != nullptr) v = cmul(v, __ldg(&post[i]));
    yr[i] = v;
  }
}

// Stage-0 source of the compile-time core: x[i] (zero beyond n_in) times pre[i].
struct ConvLoad {
  const float2* __restrict__ xr;
  const float2* __restrict__ pre;
  int n_in;
  __device__ float2 load(int i) const {
    if (i >= n_in) return make_float2(0.f, 0.f);
    return pre != nullptr ? cmul(xr[i], __ldg(&pre[i])) : xr[i];
  }
};

// Last-stage sink of the compile-time core: outputs i < n_out, [conj] [. post].
struct ConvStore {
  float2* __restrict__ yr;
  const float2* __restrict__ post;
  int n_out, conj_out;
  __device__ void store(int i, float2 v) const {
    if (i >= n_out) return;
    if (conj_out) v.y = -v.y;
    yr[i] = post != nullptr ? cmul(v, __ldg(&post[i])) : v;
  }
};

// conv_fft_kernel for one compile-time chain (fixed_chain): one buffer, the
// first chain reading from device memory, the second writing to it.
template <int R0, int R1, int R2>
__global__ void __launch_bounds__(kFixedThreads<1, R0, R1, R2>)
    conv_fft_fixed_kernel(const float2* __restrict__ x, float2* __restrict__ y, int n_in,
                          int n_out, Stages st, const float2* __restrict__ h,
                          const float2* __restrict__ pre, const float2* __restrict__ post,
                          int conj_out) {
  constexpr int M = R0 * R1 * R2;
  __shared__ float2 buf[M];
  __shared__ float2 sroots[R0 + R1 + R2];
  load_roots(st, sroots);
  __syncthreads();
  const SmemTile tile{buf};
  fixed_chain<1, R0, R1, R2>(ConvLoad{x + (size_t)blockIdx.x * (size_t)n_in, pre, n_in}, tile,
                             buf, sroots, st);
  __syncthreads();
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    const float2 v = cmul(buf[swz(i)], __ldg(&h[i]));
    buf[swz(i)] = make_float2(v.x, -v.y);
  }
  __syncthreads();
  fixed_chain<1, R0, R1, R2>(
      tile, ConvStore{y + (size_t)blockIdx.x * (size_t)n_out, post, n_out, conj_out}, buf,
      sroots, st);
}

}  // namespace rf

// x: (batch, n_in), y: (batch, n_out), complex64, n_in, n_out <= m; h: (m,);
// pre: (>= n_in,) or NULL; post: (>= n_out,) or NULL; roots/tw as in Stages
// for the length-m chain.  Returns a cudaError_t code; launches on `stream`.
extern "C" int rf_conv_fft(const void* x, void* y, long long batch, int n_in, int n_out,
                           int m, int k, int r0, int r1, int r2, const void* roots0,
                           const void* roots1, const void* roots2, const void* tw0,
                           const void* tw1, const void* h, const void* pre, const void* post,
                           int conj_out, void* stream) {
  using namespace rf;
  if (batch <= 0 || batch > 0x7fffffffLL || n_in <= 0 || n_in > m || n_out <= 0 ||
      n_out > m || h == nullptr)
    return cudaErrorInvalidValue;
  const Stages st = make_stages(k, r0, r1, r2, roots0, roots1, roots2, tw0, tw1);
  if (!stages_ok(st, m)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* in = static_cast<const float2*>(x);
  float2* out = static_cast<float2*>(y);
  const float2* tab[3] = {static_cast<const float2*>(h), static_cast<const float2*>(pre),
                          static_cast<const float2*>(post)};
  if (k == 3 && r0 == 16 && r1 == 16 && r2 == 12) {  // m = 3072: Bluestein 1234
    conv_fft_fixed_kernel<16, 16, 12><<<(unsigned)batch, kFixedThreads<1, 16, 16, 12>, 0, s>>>(
        in, out, n_in, n_out, st, tab[0], tab[1], tab[2], conj_out);
    return cudaGetLastError();
  }
  const size_t smem = tile_smem_bytes(m, st);
  cudaError_t err = allow_smem(conv_fft_kernel, smem);
  if (err != cudaSuccess) return err;
  // one thread per column of the stage with the most columns (smallest radix)
  int rmin = st.r[0];
  for (int i = 1; i < st.k; ++i) rmin = st.r[i] < rmin ? st.r[i] : rmin;
  int threads = (m / rmin + 31) / 32 * 32;
  threads = threads < 64 ? 64 : (threads > 256 ? 256 : threads);
  conv_fft_kernel<<<(unsigned)batch, threads, smem, s>>>(in, out, n_in, n_out, m, st, tab[0],
                                                         tab[1], tab[2], conj_out);
  return cudaGetLastError();
}
