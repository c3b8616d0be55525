// B_conv of the fused large Bluestein's tile form at Q = 24576 (m = 3 *
// 2^21 at K15's own split P = 256 x Q = 24576: the 70469 Bluesteins of
// (2^20, 2^22] on that inner length): the port of
// rustfft_tpu/ops/pallas/convlarge.py:_kernel_bconv there (K15;
// ops/kernels/convlarge.py bconv_row_tile).  The general form ran that
// inner length at P = 512 x Q = 12288 with 8-byte reads of the row layout
// (csrc/convlarge.cu bconv_row_kernel) and kernel A and A2 on the general
// csrc/large.cuh bodies; at P = 256 kernel A and A2 run their tile kernels.
//
// One column is 192 KiB, more than a block holds beside another on an SM,
// so a cluster of two 256-thread blocks holds one, each block the half of
// 12288 values it loaded (96 KiB; two blocks an SM, as the column forms of
// csrc/bconv_cols.cuh).  Chain 1 is (2, 3, 16, 16, 16): its first stage, a
// radix 2 over the digit of weight 12288, pairs the values the two blocks
// hold at the same place, so it runs across the pair through distributed
// shared memory, each block computing both outputs of half of the places
// and writing one into the other block's half; then each block runs the
// chain (3, 16, 16, 16) of csrc/bconv_cols.cu's Q = 12288 form on its half,
// with the same twiddles, h in its half's positions and the conjugate.
// Chain 2 runs the radices reversed on each half (the twiddle columns of
// its stages count the block's half among the digits above them: hi0) and
// ends with the radix 2 across the pair again, which stores both outputs
// times the outer twiddle straight to device memory.  Four cluster
// barriers a unit: after the loads land, after the first cross stage's
// writes, before the last stage's reads and after them (the next unit's
// copies overwrite what the other block read).  The units (one column of a
// batch row) walk persistently, cluster g taking g, g + clusters, ... in
// bconv_unit's order, the next unit's copies landing while the SM's other
// block computes.
#include "bconv_cols.cuh"
#include "radix.cuh"

namespace rf {

constexpr int kBpHalf = 12288;
constexpr int kBpQ = 2 * kBpHalf;
// the places of the cross stages each block computes
constexpr int kBpShare = kBpHalf / 2;

template <bool kStamp>
__global__ void __launch_bounds__(kBcgThreads, 2)
    bconv_pair_kernel(const float2* __restrict__ x, float2* __restrict__ y, unsigned batch,
                      unsigned units, unsigned cols, BcgTables tb, const float2* __restrict__ h,
                      const float2* __restrict__ outer, unsigned long long* stamps) {
  PhaseClock<kStamp, 3> clock;
  clock.begin();
  extern __shared__ float4 bp_smem[];
  float2* buf = reinterpret_cast<float2*>(bp_smem);
  float2* r3 = buf + kBpHalf;  // the roots of w_3, then w_16
  float2* r16 = r3 + 3;
  const int rank = (int)cg::this_cluster().block_rank();
  const uint32_t local = (uint32_t)__cvta_generic_to_shared(buf);
  const unsigned clusters = gridDim.x / 2;
  unsigned u = blockIdx.x / 2;
  size_t table;
  if (u < units)
    bcg_copy<kBpHalf>(buf, x + bcg_offset<kBpQ>(u, batch, cols, &table) + rank * kBpHalf);
  for (int i = threadIdx.x; i < 3; i += kBcgThreads) r3[i] = tb.roots[1][i];
  for (int i = threadIdx.x; i < 16; i += kBcgThreads) r16[i] = tb.roots[2][i];
  for (; u < units; u += clusters) {
    const size_t at = bcg_offset<kBpQ>(u, batch, cols, &table);
    cp_async_wait<0>();
    cluster_barrier<2>();  // both halves have landed
    // chain 1's radix 2 across the pair: places e of this block's share,
    // as they landed, to (a + b, (a - b) w) at swz(e) of the two halves
    {
      const int c0 = opaque_int(threadIdx.x);
      const uint32_t half0 = peer_addr(local, 0), half1 = peer_addr(local, 1);
      const float2* __restrict__ tw = opaque_ptr(tb.tw1[0]) + kBpHalf;
#pragma unroll 1
      for (int c = c0; c < kBpShare; c += kBcgThreads) {
        const int e = rank * kBpShare + c;
        const float2 a = peer_load(half0 + 8 * e), b = peer_load(half1 + 8 * e);
        __syncwarp();  // the warp's reads of its swizzle groups before its writes
        peer_store(half0 + 8 * swz(e), make_float2(a.x + b.x, a.y + b.y));
        peer_store(half1 + 8 * swz(e), cmul(make_float2(a.x - b.x, a.y - b.y), __ldg(&tw[e])));
      }
    }
    cluster_barrier<2>();  // the other block's writes into this half
    // chain 1's other stages on this half (3, 16, 16, 16 over the digits of
    // weight 4096, 256, 16, 1), the last times h and conjugated
    const BcgTile tile{buf};
    bcg_stage<kBpHalf, 1, 3, 4096, 4096, false, false>(opaque_int(threadIdx.x), buf, tile, r3,
                                                      opaque_ptr(tb.tw1[1]));
    __syncthreads();
    bcg_stage<kBpHalf, 1, 16, 256, 256, false, false>(opaque_int(threadIdx.x), buf, tile, r16,
                                                     opaque_ptr(tb.tw1[2]));
    __syncthreads();
    bcg_stage<kBpHalf, 1, 16, 16, 16, false, false>(opaque_int(threadIdx.x), buf, tile, r16,
                                                   opaque_ptr(tb.tw1[3]));
    __syncthreads();
    bcg_stage<kBpHalf, 1, 16, 1, 1, false, false>(
        opaque_int(threadIdx.x), buf, BcgTimesH{buf, opaque_ptr(h) + table + rank * kBpHalf}, r16,
        nullptr);
    clock.lap(0);
    __syncthreads();
    // chain 2 on this half (16, 16, 16, 3 over the digits of weight 1, 16,
    // 256, 4096), each stage's twiddle columns (REST of them) counting the
    // half among the digits above the stage
    bcg_stage<kBpHalf, 1, 16, 1, 1536, true, false>(opaque_int(threadIdx.x), buf, tile, r16,
                                                    opaque_ptr(tb.tw2[0]), rank * 768);
    __syncthreads();
    bcg_stage<kBpHalf, 1, 16, 16, 96, true, false>(opaque_int(threadIdx.x), buf, tile, r16,
                                                   opaque_ptr(tb.tw2[1]), rank * 48);
    __syncthreads();
    bcg_stage<kBpHalf, 1, 16, 256, 6, true, false>(opaque_int(threadIdx.x), buf, tile, r16,
                                                   opaque_ptr(tb.tw2[2]), rank * 3);
    __syncthreads();
    bcg_stage<kBpHalf, 1, 3, 4096, 2, true, false>(opaque_int(threadIdx.x), buf, tile, r3,
                                                  opaque_ptr(tb.tw2[3]), rank);
    clock.lap(1);
    cluster_barrier<2>();  // both halves of chain 2 but its last stage
    // chain 2's radix 2 across the pair: places e of this block's share to
    // l = e and e + 12288, times outer
    {
      const int c0 = opaque_int(threadIdx.x);
      const uint32_t half0 = peer_addr(local, 0), half1 = peer_addr(local, 1);
      float2* __restrict__ yt = y + at;
      const float2* __restrict__ ot = opaque_ptr(outer) + table;
#pragma unroll 1
      for (int c = c0; c < kBpShare; c += kBcgThreads) {
        const int e = rank * kBpShare + c;
        const float2 a = peer_load(half0 + 8 * swz(e)), b = peer_load(half1 + 8 * swz(e));
        yt[e] = cmul(make_float2(a.x + b.x, a.y + b.y), __ldg(&ot[e]));
        yt[e + kBpHalf] = cmul(make_float2(a.x - b.x, a.y - b.y), __ldg(&ot[e + kBpHalf]));
      }
    }
    cluster_barrier<2>();  // the other block has read this half
    const unsigned next = u + clusters;
    if (next < units) {
      size_t unused;
      bcg_copy<kBpHalf>(buf, x + bcg_offset<kBpQ>(next, batch, cols, &unused) + rank * kBpHalf);
    }
    clock.lap(2);
  }
  clock.write(stamps);
}

static size_t bp_smem_bytes() { return (size_t)(kBpHalf + 3 + 16) * sizeof(float2); }

// The launch configuration of `clusters` clusters of two blocks.
template <bool kStamp>
static cudaError_t bp_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                             long long clusters, cudaStream_t s) {
  cudaError_t err = allow_smem(bconv_pair_kernel<kStamp>, bp_smem_bytes());
  if (err != cudaSuccess) return err;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3((unsigned)(2 * clusters), 1, 1);
  cfg.blockDim = dim3(kBcgThreads, 1, 1);
  cfg.dynamicSmemBytes = bp_smem_bytes();
  cfg.stream = s;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 2;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

// rf_bconv_pair's checks and launch; the stamped form where kStamp.
template <bool kStamp>
static int bconv_pair(const void* x, void* y, long long batch, int p, const void* roots,
                      const void* tw, const void* h, const void* outer, long long clusters,
                      unsigned long long* stamps, void* stream) {
  if (roots == nullptr || tw == nullptr || batch <= 0 || p <= 0 || h == nullptr ||
      outer == nullptr || clusters < 1 || reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return cudaErrorInvalidValue;
  const BcgTables tb = bcg_tables(5, roots, tw);
  for (int s = 0; s < 5; ++s)
    if (tb.roots[s] == nullptr || (s < 4 && (tb.tw1[s] == nullptr || tb.tw2[s] == nullptr)))
      return cudaErrorInvalidValue;
  const long long units = batch * p;
  if (clusters > units || units > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = bp_config<kStamp>(cfg, attr, clusters, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, bconv_pair_kernel<kStamp>, static_cast<const float2*>(x),
                           static_cast<float2*>(y), (unsigned)batch, (unsigned)units, (unsigned)p,
                           tb, static_cast<const float2*>(h), static_cast<const float2*>(outer),
                           stamps);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace rf

// B_conv of the tile form at Q = 24576: x, y (batch, P, 24576) complex64,
// x 16-byte aligned; roots a host array of 5 device pointers (each stage's
// roots of the chain (2, 3, 16, 16, 16)), tw of 8 (chain 1's twiddles, then
// chain 2's: convlarge.bconv_chain_tables); h (P, 24576) in chain 1's output
// positions, outer (P, 24576); `clusters` persistent clusters of two
// blocks (convlarge.bconv_grid over rf_bconv_pair_clusters).  Returns a
// cudaError_t code; launches on `stream`.
extern "C" int rf_bconv_pair(const void* x, void* y, long long batch, int p, const void* roots,
                             const void* tw, const void* h, const void* outer, long long clusters,
                             void* stream) {
  using namespace rf;
  return bconv_pair<false>(x, y, batch, p, roots, tw, h, outer, clusters, nullptr, stream);
}

// The clusters of rf_bconv_pair the card runs at once, into *out.
extern "C" int rf_bconv_pair_clusters(int* out) {
  using namespace rf;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = bp_config<false>(cfg, attr, 1, 0);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(out, bconv_pair_kernel<false>, &cfg);
}

#ifdef RF_PHASE_STAMPS
// rf_bconv_pair through its stamped form: stamps (2 * clusters, 4) uint64
// %globaltimer nanoseconds, a block's start and that start plus the running
// sums of its phases (the loads, both chain 1 stages across the pair and
// chain 1 with h; chain 2 but its last stage; the last stage across the
// pair with the store and the next unit's copies started).
extern "C" int rf_bconv_pair_stamps(const void* x, void* y, long long batch, int p,
                                    const void* roots, const void* tw, const void* h,
                                    const void* outer, long long clusters, void* stamps,
                                    void* stream) {
  using namespace rf;
  if (stamps == nullptr) return cudaErrorInvalidValue;
  return bconv_pair<true>(x, y, batch, p, roots, tw, h, outer, clusters,
                          static_cast<unsigned long long*>(stamps), stream);
}
#endif
