// The fused column stage of the top power-of-two band: the port of K10.
//
// Replaces rustfft_tpu/ops/pallas/large2f.py:_kernel_a12 (and its
// reduced-rank twin _kernel_a12_2d).  n = P1 * P2 * Q, the input viewed as
// (B, P, Q) with P = P1 * P2 and row J = j1*P2 + j2:
//
//   a[b, j3, K] = w_n^(K*j3) * sum_J x[b, J, j3] * w_P^(J*K),
//   w_n^(K*j3) = wob[j3, k1] * wm[j3, k2],   K = k2*P1 + k1,
//
// written as (B, Q, P): the layout K3's row stage reads, so the second and
// last pass is large_row_stage at (Q, P), the port of the TPU's Q-FFT pass
// (large2f.py:_kernel_q_2d, large3.py:_kernel_q), giving X[k3*P + K] in
// natural order.  One read of x and one write of the intermediate.
//
// The TPU kernel contracts DFT_P1 on its matrix unit, twiddles by
// w_{P1P2}^(k1*j2) and runs the P2 chain on its vector unit.  Here the whole
// length-P DFT is one radix chain in registers (large.stage_radices(P):
// (16,16,4), (16,16,8), (16,16,16), (32,16,16) at P = 1024 .. 8192), the same
// DFT: w_{P1P2}^(k1*j2) is one of the chain's inter-stage twiddles.  The
// outer twiddle is large.cuh's FactoredOuter, two tables of Q*P1 and Q*P2
// entries (6 MB at 2^25) where a (Q, P) table would hold n.
//
// What bounds it on this card: one read and one write of the signal, 16
// bytes per point (1.07 GB at 2^23 x 8: 0.32 ms at 3.35 TB/s); the chain's
// FP32 work is well under the card's peak.  A whole (P, T) tile in one
// block's 128 KiB leaves T = 16384/P columns: 64-, 32- and 16-byte row
// pieces at P = 2048, 4096 and 8192, which copy alone in 1.1x, 1.4x and
// 3.6x the time of 128-byte pieces on an H100 (PERF.md, PR 15 step 0).
// col_cluster_kernel gives every row piece 16 columns (128 bytes) at every
// P = 512*C, C = 2, 4, 8, 16:
//
//  - A thread-block cluster of C blocks holds one (P, 16) tile, 64 KiB a
//    block, two blocks an SM: block r the rows J = C*rho + r, rho < 512,
//    landing by 16-byte cp.async in plain order.
//  - With P's radices (R0, R1, R2) and C dividing R2, J = j0*R1*R2 + j1*R2
//    + j2 and j2 = r + C*u (u < M = R2/C): block r runs the chain's stage 0
//    (DFT_R0 over j0, times tw0[k0, j1*R2 + j2]) and stage 1 (DFT_R1 over
//    j1, times tw1[k1, j2]) on its rows, which hold only its own j2, with
//    the chain's own tables; the twiddles its rows take, 4 KiB, sit in
//    shared memory for the whole walk.  Stage 1 leaves Z_r[u, h], h = k0 +
//    R0*k1, column-major (k10_z).
//  - The last stage, DFT_R2 over j2, runs across the cluster: after a
//    cluster barrier, block s takes h in [s*H, (s+1)*H), H = R0*R1/C, and
//    pulls for each (h, t) its R2 values j2 = r + C*u from every peer r's
//    Z_r[u, h] through distributed shared memory (a warp's reads 256
//    consecutive bytes, 32 values a thread all in flight), arrives at the
//    cluster barrier, runs DFT_R2 in registers, waits, starts the copies of
//    its next unit into its tile (no peer reads it any more), then applies
//    the factored outer twiddle (one wob read per h, one wm read per value)
//    and stores X[h + R0*R1*k2] from registers: runs of H contiguous K per
//    column, a warp 256 consecutive bytes a store.
//  - A persistent grid of clusters walks the units (b, tile), unit u =
//    b*Q/16 + tile, cluster g taking g, g + clusters, ... (ops/kernels/
//    large2f.py cluster_grid, cluster_walk), so the clusters at work at one
//    time read neighbouring 128-byte pieces of the same rows; where a
//    cluster walks several units it starts (g % 4)*kK10StaggerNs late; the
//    next unit's loads are in flight under the twiddle and the stores.
//  - 256 threads a block; each stage, the exchange and the store hold 32
//    complex values a thread.  C = 16 (P = 8192) is a non-portable cluster
//    size, which the H100 allows.
#include <stdint.h>

#include <type_traits>

#include "large.cuh"
#include "tile_walk.cuh"

namespace rf {

constexpr int kK10T = 16;       // columns of a unit: 128-byte row pieces
constexpr int kK10Rows = 512;   // rows a block holds: P / C (64 KiB)
constexpr int kK10Threads = 256;
// the start stagger of cluster g: (g % 4) times this many nanoseconds (of
// 0, 2, 4 and 8 us, 4 read best or level at every P on an H100)
constexpr unsigned kK10StaggerNs = 4000;

static __device__ __forceinline__ unsigned k10_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

static __device__ __forceinline__ void k10_cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

static __device__ __forceinline__ void k10_cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The value at the shared-memory address `local` of block `rank` of the
// cluster (distributed shared memory).
static __device__ __forceinline__ float2 k10_peer_load(const float2* local, unsigned rank) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(addr) : "r"((uint32_t)__cvta_generic_to_shared(local)), "r"(rank));
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

// This thread's copies of a block's (512, 16) tile, rows `ld` values apart
// from src, into buf in plain order (element rho*16 + t), one group: copy
// i = thread + 256*k is row i/8, 16 bytes at column 2*(i % 8).
static __device__ __forceinline__ void k10_tile_in(float2* buf, const float2* __restrict__ src,
                                                   size_t ld) {
  const int c = opaque_int(threadIdx.x);
#pragma unroll
  for (int k = 0; k < kK10Rows * kK10T / 2 / kK10Threads; ++k) {
    const int i = c + kK10Threads * k;
    const int rho = i >> 3, piece = (i & 7) * 2;
    cp_async16(buf + rho * kK10T + piece, src + rho * ld + piece);
  }
  cp_async_commit();
}

// Where Z[g, t] (g < 512, t < 16) lies in the tile after stage 1:
// column-major, g permuted within its group of 16 by t, so that the
// stage's writes (16 t of one g a half-warp) fall on 16 bank pairs and the
// exchange's reads (32 g of one t a warp) are 256 consecutive bytes.
static __device__ __forceinline__ int k10_z(int g, int t) { return t * kK10Rows + (g ^ t); }

// One stage in place over the tile: each thread reads its kCols / 256
// columns of R values (value j of column c at in(c, j)), the block passes a
// barrier, then each column's DFT_R output k, through tw(c, k, z), goes to
// out(c, k).
template <int R, int kCols, class In, class Out, class Tw>
static __device__ __forceinline__ void k10_stage(float2* buf, const float2* roots, In in, Out out,
                                                 Tw tw) {
  constexpr int kPer = kCols / kK10Threads;
  static_assert(kPer * kK10Threads == kCols && kPer * R == 32, "32 values a thread");
  const int c0 = opaque_int(threadIdx.x);
  float2 v[kPer][R];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
#pragma unroll
    for (int j = 0; j < R; ++j) v[i][j] = buf[in(c0 + kK10Threads * i, j)];
  }
  __syncthreads();  // every column read before any is overwritten
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = c0 + kK10Threads * i;
    dft_column<R>(v[i], roots, [&](int k, float2 z) { buf[out(c, k)] = tw(c, k, z); });
  }
}

// Phases of the kernel's stamped form (ops/kernels/large2f.py K10_PHASES):
// the wait for the unit's tile, the two local stages, the exchange with
// the last stage, the next unit's copies with the twiddled stores.
constexpr int kK10Phases = 4;

// K10's fused column stage on clusters of C blocks (the header above).  The
// chain (R0, R1, R2) is DFT_P's, P = R0*R1*R2 = 512*C, C divides R2 and
// R0*R1; x (B, P, Q) and y (B, Q, P); units = B*Q/16, clusters = gridDim.x
// / C.  kStamp: the stamped form (stamps (blocks, kK10Phases + 1),
// tools/torch_phase_times.py).
template <bool kStamp, int C, int R0, int R1, int R2>
__global__ void __launch_bounds__(kK10Threads, 2)
    col_cluster_kernel(const float2* __restrict__ x, float2* __restrict__ y, unsigned units,
                       int q, Stages st, FactoredOuter outer, unsigned long long* stamps) {
  constexpr int P = R0 * R1 * R2;
  constexpr int M = R2 / C;             // this block's values of the last digit
  constexpr int H = R0 * R1 / C;        // h a block stores
  constexpr int kPairs = H * kK10T / kK10Threads;  // (h, t) a thread takes
  static_assert(M * C == R2 && R0 * R1 * M == kK10Rows && kPairs * R2 == 32,
                "P = 512*C, C divides R2");
  extern __shared__ float4 k10_smem[];
  float2* buf = reinterpret_cast<float2*>(k10_smem);
  float2* sroots = buf + kK10Rows * kK10T;  // w_R0, w_R1, w_R2
  // the slices of the chain's twiddles this block's rows take:
  // stw0[k0*R1*M + jr] = tw0[k0, j1*R2 + r + C*u'] (jr = j1*M + u') and
  // stw1[k1*M + u'] = tw1[k1, r + C*u']
  float2* stw0 = sroots + R0 + R1 + R2;
  float2* stw1 = stw0 + kK10Rows;
  const unsigned r = k10_rank();
  const unsigned clusters = gridDim.x / C;
  const unsigned tiles = (unsigned)q / kK10T;
  const size_t plane = (size_t)P * (size_t)q;
  const size_t ld = (size_t)C * (size_t)q;  // between this block's rows
  // block r's rows of unit u start at row r of batch row u / tiles
  const auto rows_of = [&](unsigned u) {
    return x + (u / tiles) * plane + r * (size_t)q + (u % tiles) * kK10T;
  };
  unsigned u = blockIdx.x / C;
  // where a cluster walks several units, cluster g starts (g % 4) *
  // kK10StaggerNs late, so that the clusters' memory phases spread over
  // their stages
  if (units > clusters) {
    const unsigned long long t0 = walk_timer();
    const unsigned long long wait = (unsigned long long)(u % 4) * kK10StaggerNs;
    while (walk_timer() - t0 < wait) {
    }
  }
  PhaseClock<kStamp, kK10Phases> clock;
  clock.begin();
  if (u < units) k10_tile_in(buf, rows_of(u), ld);
  load_roots(st, sroots);
  for (int i = threadIdx.x; i < kK10Rows; i += kK10Threads) {
    const int k = i / (R1 * M), jr = i % (R1 * M);
    stw0[i] = st.tw[0][k * (R1 * R2) + (jr / M) * R2 + (int)r + C * (jr % M)];
  }
  for (int i = threadIdx.x; i < R1 * M; i += kK10Threads)
    stw1[i] = st.tw[1][(i / M) * R2 + (int)r + C * (i % M)];
  for (; u < units; u += clusters) {
    const unsigned b = u / tiles, tile = u % tiles;
    cp_async_wait<0>();
    __syncthreads();  // the tile (every thread's copies) and the roots
    clock.lap(0);
    // stage 0: DFT_R0 over j0; column c = jr*16 + t, jr = j1*M + u'
    {
      constexpr int kCols = R1 * M * kK10T;
      k10_stage<R0, kCols>(
          buf, sroots, [](int c, int j) { return j * kCols + c; },
          [](int c, int k) { return swz(k * kCols + c); },
          [&](int c, int k, float2 z) {
            return k == 0 ? z : cmul(z, stw0[k * (R1 * M) + c / kK10T]);
          });
    }
    __syncthreads();
    // stage 1: DFT_R1 over j1; column c = k0*M*16 + u'*16 + t; output k1 to
    // Z[g, t], g = u'*R0*R1 + k1*R0 + k0
    {
      constexpr int kCols = R0 * M * kK10T;
      constexpr int kRt = M * kK10T;
      k10_stage<R1, kCols>(
          buf, sroots + R0,
          [](int c, int j) { return swz((c / kRt) * R1 * kRt + j * kRt + c % kRt); },
          [](int c, int k) {
            return k10_z((c % kRt) / kK10T * (R0 * R1) + k * R0 + c / kRt, c % kK10T);
          },
          [&](int c, int k, float2 z) {
            return k == 0 ? z : cmul(z, stw1[k * M + (c % kRt) / kK10T]);
          });
    }
    clock.lap(1);
    // the last stage across the cluster: pair e = thread + 256*i is (t, h) =
    // (e / H, r*H + e % H); value j2 = p + C*u' of peer p's Z[u'*R0*R1 + h, t]
    float2 v[kPairs][R2];
    const int c0 = opaque_int(threadIdx.x);
    k10_cluster_arrive();
    k10_cluster_wait();  // every block's Z
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int e = c0 + kK10Threads * i;
      const int h = (int)r * H + e % H, t = e / H;
#pragma unroll
      for (int j = 0; j < R2; ++j)
        v[i][j] = k10_peer_load(buf + k10_z((j / C) * (R0 * R1) + h, t), j % C);
    }
    k10_cluster_arrive();  // this block's peer reads are done
#pragma unroll
    for (int i = 0; i < kPairs; ++i) fft_pow2_reg<R2>(v[i], sroots + R0 + R1);
    k10_cluster_wait();  // no peer reads this tile any more
    clock.lap(2);
    const unsigned next = u + clusters;
    if (next < units) k10_tile_in(buf, rows_of(next), ld);
    // the outer twiddle w_n^(K*j3) = wob[j3, K mod P1] * wm[j3, K / P1] and
    // the stores y[b, j3, K], K = h + R0*R1*k2 (v[i][bitrev(k2)] = X[k2])
    float2* __restrict__ yb = y + b * plane;
    const float2* __restrict__ wob = opaque_ptr(outer.wob);
    const float2* __restrict__ wm = opaque_ptr(outer.wm);
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int e = c0 + kK10Threads * i;
      const int h = (int)r * H + e % H;
      const int j3 = (int)tile * kK10T + e / H;
      const float2 wo = __ldg(&wob[(size_t)j3 * outer.p1 + h % outer.p1]);
      float2* __restrict__ yr = yb + (size_t)j3 * P;
#pragma unroll
      for (int k2 = 0; k2 < R2; ++k2) {
        const int k = h + R0 * R1 * k2;
        const float2 tw = cmul(wo, __ldg(&wm[(size_t)j3 * outer.p2 + k / outer.p1]));
        yr[k] = cmul(v[i][bitrev<R2>(k2)], tw);
      }
    }
    clock.lap(3);
  }
  clock.write(stamps);
}

static size_t col_cluster_smem(int r0, int r1, int r2) {
  const int m = r2 / (r0 * r1 * r2 / kK10Rows);
  return (size_t)(kK10Rows * kK10T + r0 + r1 + r2 + kK10Rows + r1 * m) * sizeof(float2);
}

// The launch of col_cluster_kernel<kStamp, C, R0, R1, R2> on `clusters`
// clusters.
template <bool kStamp, int C, int R0, int R1, int R2>
static cudaError_t col_cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                                      long long clusters, cudaStream_t s) {
  const size_t smem = col_cluster_smem(R0, R1, R2);
  cudaError_t err = allow_smem(col_cluster_kernel<kStamp, C, R0, R1, R2>, smem);
  if (err != cudaSuccess) return err;
  if constexpr (C > 8) {
    err = cudaFuncSetAttribute(col_cluster_kernel<kStamp, C, R0, R1, R2>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3((unsigned)(clusters * C), 1, 1);
  cfg.blockDim = dim3(kK10Threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <bool kStamp, int C, int R0, int R1, int R2>
static cudaError_t launch_col_cluster(const float2* x, float2* y, long long batch, int q,
                                      long long clusters, const Stages& st,
                                      const FactoredOuter& outer, unsigned long long* stamps,
                                      cudaStream_t s) {
  const long long units = batch * (q / kK10T);
  if (q % kK10T != 0 || clusters < 1 || clusters > units || units > 0xffffffffLL ||
      clusters * C > 0x7fffffffLL || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      (R0 * R1) % outer.p1 != 0)
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = col_cluster_config<kStamp, C, R0, R1, R2>(cfg, attr, clusters, s);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, col_cluster_kernel<kStamp, C, R0, R1, R2>, x, y,
                           (unsigned)units, q, st, outer, stamps);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The chains with a cluster kernel (ops/kernels/large2f.py CLUSTER_CHAINS):
// (16, 16, 4), (16, 16, 8), (16, 16, 16), (32, 16, 16), P = 1024 .. 8192,
// on clusters of c = P/512 blocks.
static bool col_cluster_chain(const Stages& st, int c) {
  const int r0 = st.r[0], r2 = st.r[2];
  return st.k == 3 && st.r[1] == 16 &&
         ((r0 == 16 && (r2 == 4 || r2 == 8 || r2 == 16)) || (r0 == 32 && r2 == 16)) &&
         c == r0 * 16 * r2 / kK10Rows;
}

// f(C, R0, R2) as integral constants for a col_cluster_chain.
template <class F>
static cudaError_t col_cluster_dispatch(const Stages& st, F f) {
  using std::integral_constant;
  using I = int;
  const int r0 = st.r[0], r2 = st.r[2];
  if (r0 == 32)
    return f(integral_constant<I, 16>{}, integral_constant<I, 32>{}, integral_constant<I, 16>{});
  if (r2 == 4)
    return f(integral_constant<I, 2>{}, integral_constant<I, 16>{}, integral_constant<I, 4>{});
  if (r2 == 8)
    return f(integral_constant<I, 4>{}, integral_constant<I, 16>{}, integral_constant<I, 8>{});
  return f(integral_constant<I, 8>{}, integral_constant<I, 16>{}, integral_constant<I, 16>{});
}

// rf_large2f_col_stage's checks and launch; the stamped form where kStamp.
template <bool kStamp>
static int large2f_col(const void* x, void* y, long long batch, int p1, int p2, int q, int qt,
                       int k, int r0, int r1, int r2, const void* roots0, const void* roots1,
                       const void* roots2, const void* tw0, const void* tw1, const void* wob,
                       const void* wm, int c, long long clusters, unsigned long long* stamps,
                       void* stream) {
  if (batch <= 0 || p1 <= 0 || p2 <= 0 || q <= 0 || qt <= 0 || q % qt != 0)
    return cudaErrorInvalidValue;
  const int p = p1 * p2;
  const Stages st = make_stages(k, r0, r1, r2, roots0, roots1, roots2, tw0, tw1);
  if (!stages_ok(st, p) || wob == nullptr || wm == nullptr) return cudaErrorInvalidValue;
  const auto* xp = static_cast<const float2*>(x);
  auto* yp = static_cast<float2*>(y);
  const FactoredOuter outer{static_cast<const float2*>(wob), static_cast<const float2*>(wm), p1,
                            p2};
  auto s = static_cast<cudaStream_t>(stream);
  if (c > 0) {
    if (qt != kK10T || !col_cluster_chain(st, c)) return cudaErrorInvalidValue;
    return col_cluster_dispatch(st, [&](auto cc, auto a, auto b) {
      return launch_col_cluster<kStamp, decltype(cc)::value, decltype(a)::value, 16,
                                decltype(b)::value>(xp, yp, batch, q, clusters, st, outer,
                                                    stamps, s);
    });
  }
  if (kStamp) return cudaErrorInvalidValue;
  return launch_col_stage(RowsIn{xp, (size_t)p * (size_t)q}, yp, batch, p, q, qt, st, outer, s);
}

}  // namespace rf

// x: (batch, P1*P2*Q), y: (batch, Q, P1*P2), complex64; the radices of `st`
// split P1*P2, qt divides Q; wob: (Q, P1), wm: (Q, P2).  With c > 0 (qt
// = 16, col_cluster_chain(st, c), P1 dividing R0*R1): the cluster kernel on
// `clusters` clusters of c blocks (1 <= clusters <= the batch*Q/16 units;
// ops/kernels/large2f.py cluster_grid), x 16-byte aligned; with c = 0
// large.cuh's column stage, clusters not read.  Returns a cudaError_t code;
// launches on `stream`.
extern "C" int rf_large2f_col_stage(const void* x, void* y, long long batch, int p1, int p2,
                                    int q, int qt, int k, int r0, int r1, int r2,
                                    const void* roots0, const void* roots1, const void* roots2,
                                    const void* tw0, const void* tw1, const void* wob,
                                    const void* wm, int c, long long clusters, void* stream) {
  return rf::large2f_col<false>(x, y, batch, p1, p2, q, qt, k, r0, r1, r2, roots0, roots1,
                                roots2, tw0, tw1, wob, wm, c, clusters, nullptr, stream);
}

#ifdef RF_PHASE_STAMPS
// rf_large2f_col_stage through the cluster kernel's stamped form (c > 0
// only): stamps (clusters*c, kK10Phases + 1) uint64 %globaltimer
// nanoseconds, a block's start and that start plus the running sums of its
// phases.  Only the library built with RF_PHASE_STAMPS has it.
extern "C" int rf_large2f_col_phase_stamps(const void* x, void* y, long long batch, int p1,
                                           int p2, int q, int qt, int k, int r0, int r1, int r2,
                                           const void* roots0, const void* roots1,
                                           const void* roots2, const void* tw0, const void* tw1,
                                           const void* wob, const void* wm, int c,
                                           long long clusters, void* stamps, void* stream) {
  if (stamps == nullptr || c <= 0) return cudaErrorInvalidValue;
  return rf::large2f_col<true>(x, y, batch, p1, p2, q, qt, k, r0, r1, r2, roots0, roots1, roots2,
                               tw0, tw1, wob, wm, c, clusters,
                               static_cast<unsigned long long*>(stamps), stream);
}
#endif

// The clusters of P/512 blocks of the cluster kernel at P = 1024, 2048,
// 4096 or 8192 the card holds at once (cudaOccupancyMaxActiveClusters),
// into *out.
extern "C" int rf_large2f_max_active_clusters(int p, int* out) {
  using namespace rf;
  if (p != 1024 && p != 2048 && p != 4096 && p != 8192) return cudaErrorInvalidValue;
  const Stages st = make_stages(3, p == 8192 ? 32 : 16, 16, p == 1024 ? 4 : p == 2048 ? 8 : 16,
                                nullptr, nullptr, nullptr, nullptr, nullptr);
  return col_cluster_dispatch(st, [&](auto cc, auto a, auto b) -> cudaError_t {
    constexpr int C = decltype(cc)::value, R0 = decltype(a)::value, R2 = decltype(b)::value;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t err = col_cluster_config<false, C, R0, 16, R2>(cfg, attr, 1, 0);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveClusters(out, col_cluster_kernel<false, C, R0, 16, R2>, &cfg);
  });
}
