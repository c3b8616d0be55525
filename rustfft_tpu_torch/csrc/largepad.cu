// The column kernel of K12 (largepad.py:_kernel_a_pad): csrc/largepad.cuh
// has the design.
#include "largepad.cuh"

namespace rf {

// Column stage: block (b, tile) loads x[b, :, q0 .. q0 + T) as (P, T) (T =
// qt but in the last tile), runs DFT_P in place with the outer twiddle of
// its columns (rows q0 .. of the (Q, P) table) folded in, and writes the
// rows q0 .. q0 + T of y[b] (Q, P), T*P contiguous values.
template <int MaxM, bool kStamp>
__global__ void __launch_bounds__(kPadColThreads, MaxM == 0 ? kPadColPlainBlocks : 2)
    largepad_col_kernel(const float2* __restrict__ x, float2* __restrict__ y, int p, int q,
                        int qt, Stages st, const float2* __restrict__ outer,
                        unsigned long long* stamps) {
  extern __shared__ float2 smem[];
  pad_stamp<kStamp>(stamps, 0);
  float2* buf = smem;
  float2* stables = smem + pad16(p * qt);
  auto* place = reinterpret_cast<unsigned short*>(stables + chain_smem_len(st));
  load_chain_tables(st, stables);
  load_places(p, st, place);
  const int tiles = (q + qt - 1) / qt;
  const size_t b = blockIdx.x / tiles;
  const int q0 = (int)(blockIdx.x % tiles) * qt;
  const int T = min(qt, q - q0);
  load_tile(x + b * (size_t)p * (size_t)q + q0, (size_t)q, p, T, buf);
  __syncthreads();
  pad_stamp<kStamp>(stamps, 1);
  chain_inplace<MaxM>(buf, p, 1, T, st, stables, outer + (size_t)q0 * p, p);
  pad_stamp<kStamp>(stamps, 2);
  // y[b, q0 + t, k1] = row place[k1], column t of the tile
  float2* dst = y + b * (size_t)p * (size_t)q + (size_t)q0 * p;
  const int elems = T * p, nt = (int)blockDim.x;
  TileWalk w((int)threadIdx.x, p);
  for (int f0 = threadIdx.x; f0 < elems; f0 += kPadIo * nt) {
    float2 v[kPadIo];
#pragma unroll
    for (int u = 0; u < kPadIo; ++u, w.next())
      if (f0 + u * nt < elems) v[u] = buf[swz(place[w.col] * T + w.row)];
#pragma unroll
    for (int u = 0; u < kPadIo; ++u) {
      const int f = f0 + u * nt;
      if (f < elems) dst[f] = v[u];
    }
  }
  pad_stamp<kStamp>(stamps, 3);
}

template <int MaxM, bool kStamp>
static cudaError_t launch_col(const float2* x, float2* y, long long batch, int p, int q, int qt,
                              const Stages& st, const float2* outer,
                              unsigned long long* stamps, cudaStream_t s) {
  const size_t smem = pad_smem_bytes(p, qt, st);
  cudaError_t err = allow_smem(largepad_col_kernel<MaxM, kStamp>, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = batch * ((q + qt - 1) / qt);
  largepad_col_kernel<MaxM, kStamp>
      <<<(unsigned)blocks, kPadColThreads, smem, s>>>(x, y, p, q, qt, st, outer, stamps);
  return cudaGetLastError();
}

// The column stage's checks and launch: the form without a Bluestein stage
// where the chain has none; the stamped form where kStamp.
template <bool kStamp>
static int col_stage(const void* x, void* y, long long batch, int p, int q, int qt,
                     const Stages& st, const void* outer, unsigned long long* stamps,
                     void* stream) {
  if (outer == nullptr || !pad_ok(batch, p, q, qt, st, kPadColMaxM))
    return cudaErrorInvalidValue;
  const auto* tx = static_cast<const float2*>(x);
  auto* ty = static_cast<float2*>(y);
  const auto* to = static_cast<const float2*>(outer);
  const auto s = static_cast<cudaStream_t>(stream);
  if (has_bluestein(st))
    return launch_col<kPadColMaxM, kStamp>(tx, ty, batch, p, q, qt, st, to, stamps, s);
  return launch_col<0, kStamp>(tx, ty, batch, p, q, qt, st, to, stamps, s);
}

}  // namespace rf

// x: (batch, P, Q), y: (batch, Q, P), complex64; the chain of DFT_P (the
// chain_args of ops/kernels/fused.py: Bluestein lengths up to 1024);
// tw_outer: (Q, P) w_n^(k1*j2); tiles of qt columns (any qt >= 1, the last
// one ragged).  Returns a cudaError_t code; launches on `stream`.
extern "C" int rf_largepad_col_stage(const void* x, void* y, long long batch, int p, int q,
                                     int qt, int k, int r0, int r1, int r2,
                                     const void* roots0, const void* roots1, const void* roots2,
                                     const void* tw0, const void* tw1, int m0, int m1, int m2,
                                     const void* tw_outer, void* stream) {
  using namespace rf;
  return col_stage<false>(
      x, y, batch, p, q, qt,
      pad_chain(k, r0, r1, r2, roots0, roots1, roots2, tw0, tw1, m0, m1, m2), tw_outer, nullptr,
      stream);
}

#ifdef RF_PHASE_STAMPS
// The column stage through its stamped form: stamps (blocks, kPadStamps)
// uint64 %globaltimer nanoseconds, blocks = batch * tiles.  Only the library
// built with RF_PHASE_STAMPS has it (ops/kernels/_build.py
// load(phase_stamps=True); tools/torch_phase_times.py).
extern "C" int rf_largepad_col_phase_stamps(const void* x, void* y, long long batch, int p, int q,
                                            int qt, int k, int r0, int r1, int r2,
                                            const void* roots0, const void* roots1,
                                            const void* roots2, const void* tw0, const void* tw1,
                                            int m0, int m1, int m2, const void* tw_outer,
                                            void* stamps, void* stream) {
  using namespace rf;
  if (stamps == nullptr) return cudaErrorInvalidValue;
  return col_stage<true>(
      x, y, batch, p, q, qt,
      pad_chain(k, r0, r1, r2, roots0, roots1, roots2, tw0, tw1, m0, m1, m2), tw_outer,
      static_cast<unsigned long long*>(stamps), stream);
}
#endif
