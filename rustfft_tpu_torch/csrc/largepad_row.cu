// The row kernel of K12 (largepad.py:_kernel_b_pad): csrc/largepad.cuh has
// the design.
#include "largepad.cuh"

namespace rf {

// 256 threads where two blocks of smem bytes fit an SM, else 512.
static int pad_threads(size_t smem) {
  return 2 * (smem + kBlockReserved) <= (size_t)kSmShared ? 256 : 512;
}

// Row stage: block (b, tile) loads a[b, :, p0 .. p0 + T) as (Q, T) (T = pt
// but in the last tile), runs the length-Q FFT in place and writes
// X[b, k2*P + p0 + t], T values a row.
template <int MaxM, bool kStamp>
__global__ void __launch_bounds__(kPadMaxThreads)
    largepad_row_kernel(const float2* __restrict__ x, float2* __restrict__ y, int q, int p,
                        int pt, Stages st, unsigned long long* stamps) {
  extern __shared__ float2 smem[];
  pad_stamp<kStamp>(stamps, 0);
  float2* buf = smem;
  float2* stables = smem + pad16(q * pt);
  auto* place = reinterpret_cast<unsigned short*>(stables + chain_smem_len(st));
  load_chain_tables(st, stables);
  load_places(q, st, place);
  const int tiles = (p + pt - 1) / pt;
  const size_t b = blockIdx.x / tiles;
  const int p0 = (int)(blockIdx.x % tiles) * pt;
  const int T = min(pt, p - p0);
  load_tile(x + b * (size_t)q * (size_t)p + p0, (size_t)p, q, T, buf);
  __syncthreads();
  pad_stamp<kStamp>(stamps, 1);
  chain_inplace<MaxM>(buf, q, 1, T, st, stables, nullptr, 0);
  pad_stamp<kStamp>(stamps, 2);
  float2* dst = y + b * (size_t)q * (size_t)p + p0;
  const int elems = q * T, nt = (int)blockDim.x;
  TileWalk w((int)threadIdx.x, T);
  for (int f0 = threadIdx.x; f0 < elems; f0 += kPadIo * nt) {
    float2 v[kPadIo];
    TileWalk r = w;
#pragma unroll
    for (int u = 0; u < kPadIo; ++u, r.next())
      if (f0 + u * nt < elems) v[u] = buf[swz(place[r.row] * T + r.col)];
#pragma unroll
    for (int u = 0; u < kPadIo; ++u, w.next())
      if (f0 + u * nt < elems) dst[(size_t)w.row * p + w.col] = v[u];
  }
  pad_stamp<kStamp>(stamps, 3);
}

template <int MaxM, bool kStamp>
static cudaError_t launch_row(const float2* x, float2* y, long long batch, int q, int p, int pt,
                              const Stages& st, unsigned long long* stamps,
                              cudaStream_t s) {
  const size_t smem = pad_smem_bytes(q, pt, st);
  cudaError_t err = allow_smem(largepad_row_kernel<MaxM, kStamp>, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = batch * ((p + pt - 1) / pt);
  largepad_row_kernel<MaxM, kStamp>
      <<<(unsigned)blocks, pad_threads(smem), smem, s>>>(x, y, q, p, pt, st, stamps);
  return cudaGetLastError();
}

template <bool kStamp>
static int row_stage(const void* x, void* y, long long batch, int q, int p, int pt,
                     const Stages& st, unsigned long long* stamps, void* stream) {
  if (!pad_ok(batch, q, p, pt, st, kPadRowMaxM)) return cudaErrorInvalidValue;
  const auto* tx = static_cast<const float2*>(x);
  auto* ty = static_cast<float2*>(y);
  const auto s = static_cast<cudaStream_t>(stream);
  if (has_bluestein(st))
    return launch_row<kPadRowMaxM, kStamp>(tx, ty, batch, q, p, pt, st, stamps, s);
  return launch_row<0, kStamp>(tx, ty, batch, q, p, pt, st, stamps, s);
}

}  // namespace rf

// x: (batch, Q, P), y: (batch, Q*P) complex64; the chain of the length-Q
// FFT (Bluestein lengths up to 512); tiles of pt columns (any pt >= 1, the
// last one ragged).  Returns a cudaError_t code; launches on `stream`.
extern "C" int rf_largepad_row_stage(const void* x, void* y, long long batch, int q, int p,
                                     int pt, int k, int r0, int r1, int r2,
                                     const void* roots0, const void* roots1, const void* roots2,
                                     const void* tw0, const void* tw1, int m0, int m1, int m2,
                                     void* stream) {
  using namespace rf;
  return row_stage<false>(
      x, y, batch, q, p, pt,
      pad_chain(k, r0, r1, r2, roots0, roots1, roots2, tw0, tw1, m0, m1, m2), nullptr, stream);
}

#ifdef RF_PHASE_STAMPS
// The row stage through its stamped form, as the column stage's
// (csrc/largepad.cu).
extern "C" int rf_largepad_row_phase_stamps(const void* x, void* y, long long batch, int q, int p,
                                            int pt, int k, int r0, int r1, int r2,
                                            const void* roots0, const void* roots1,
                                            const void* roots2, const void* tw0, const void* tw1,
                                            int m0, int m1, int m2, void* stamps, void* stream) {
  using namespace rf;
  if (stamps == nullptr) return cudaErrorInvalidValue;
  return row_stage<true>(
      x, y, batch, q, p, pt,
      pad_chain(k, r0, r1, r2, roots0, roots1, roots2, tw0, tw1, m0, m1, m2),
      static_cast<unsigned long long*>(stamps), stream);
}
#endif
