// K9's radix kernel (csrc/fused.cu radix_fft; its design is described
// there): a persistent grid of clusters of R blocks, each cluster computing
// one transform of R*128*128 points at a time in distributed shared memory.
// The kernel body is a template on its input and output: K9's own
// (RadixPlain: the slice by bulk copies, natural-order stores) and the
// two-pass convolution core's cluster passes (csrc/conv_radix.cu: the
// Rader gather or the chirp on the load, the partial sums, the epilogue on
// the store).
#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

#include "gauss16.cuh"
#include "inplace_chain.cuh"

namespace cg = cooperative_groups;

namespace rf {

constexpr int kSlice = 128;                 // p = q of the radix split
constexpr int kSliceElems = kSlice * kSlice;
constexpr int kSliceRoots = 16 + 8;         // the DFT_128 chain (16, 8)
constexpr int kFusedThreads = 512;

// The form of the body's DFT_128 chains (stages A and B), a template
// argument of radix_body: radix-2 register FFTs on the roots in shared
// memory (kRadixRoots: K9, K7's 16384, K8 there and K14's default cluster
// passes), or K14's gauss_mode (kRadixGauss: each radix 16 and radix 8 as
// gauss_column, three multiply-adds a term with the DFT_16 and DFT_8
// tables as compile-time constants, csrc/gauss16.cuh, the outputs in
// natural order, the direction read from the Gauss table the caller
// passes).  In both forms the inter-stage twiddle stays a complex product
// and the radix-r exchange a radix-2 FFT: the JAX kernel's gauss_mode
// changes only its DFT_p and DFT_q contractions
// (rustfft_tpu/ops/pallas/conv_radix.py:183, :232, :266).
enum RadixForm { kRadixRoots = 0, kRadixGauss = 1 };

template <int R, bool kInverse>
struct GaussConstants;
template <bool kInverse>
struct GaussConstants<16, kInverse> {
  using T = Gauss16<kInverse>;
};
template <bool kInverse>
struct GaussConstants<8, kInverse> {
  using T = Gauss8<kInverse>;
};

// DFT_R (R = 16 or 8) of one column in the Gauss form, each output to
// sink(k, X[k]) in natural order.  The branch on the direction is the same
// for every thread of the launch.
template <int R, class Sink>
static __device__ __forceinline__ void gauss_dft(const float2 (&v)[R], bool inverse, Sink sink) {
  if (inverse) {
    gauss_column<R>(v, typename GaussConstants<R, true>::T{}, sink);
  } else {
    gauss_column<R>(v, typename GaussConstants<R, false>::T{}, sink);
  }
}

// The DFT_128 chain (16, 8) of the port (fft_tile.cuh: DIT, the top digit
// first, the inter-stage twiddle tw[k0][j1] = w_128^(k0*j1)) over one axis
// of the 128 x 128 tile, one column per thread at a time.  A stage that
// reads the tile writes a column's outputs where it read its inputs (or to
// device memory), so no stage needs a barrier inside it: the chain over the
// rows b leaves frequency d = k0 + 16*k1 at row k0*8 + k1 (place_row), not
// at row d.

// Phase stamps of the radix kernel (its kStamp form, built only into the
// library compiled with RF_PHASE_STAMPS, which no route loads): per block,
// its start and that start plus the running sums of the time in each of its
// kRadixPhases phases (stage A's load and radix 16, stage A's radix 8, the
// wait at the cluster barrier before the exchange, the exchange, the wait at
// the barrier after it, stage B's radix 16, stage B's radix 8 with the
// store), each lap read by thread 0 after a block barrier
// (tools/torch_phase_times.py).
constexpr int kRadixPhases = 7;

template <bool kStamp>
struct RadixClock {
  unsigned long long start = 0, mark = 0, sum[kRadixPhases] = {};
  __device__ void begin() {
    if constexpr (kStamp) {
      __syncthreads();
      start = mark = global_timer();
    }
  }
  __device__ void lap(int phase) {
    if constexpr (kStamp) {
      __syncthreads();
      const unsigned long long now = global_timer();
      sum[phase] += now - mark;
      mark = now;
    }
  }
  __device__ void write(unsigned long long* stamps) const {
    if constexpr (kStamp) {
      if (threadIdx.x == 0) {
        unsigned long long* out = stamps + (size_t)blockIdx.x * (kRadixPhases + 1);
        out[0] = start;
        for (int i = 0; i < kRadixPhases; ++i) out[i + 1] = out[i] + sum[i];
      }
    }
  }
};

// Row of the tile that holds frequency d after stage A.
static __device__ __forceinline__ int place_row(int d) { return (d & 15) * 8 + (d >> 4); }

// ---- stage A's input, asynchronously, by chunks ----------------------------
//
// The slice's rows b = j0*8 + j1 fall into kChunks chunks by j1 = b & 7, 16
// rows (16 KiB) each.  Stage A's radix 16 over j0 reads and writes only the
// rows of its own j1, so it starts on a chunk as soon as that chunk lands;
// its radix 8 reads every chunk.  Stage B's radix 8 reads row place_row(d)
// for frequency d, and (place_row(d) & 7) == d >> 4: run in the order of
// d >> 4, it frees the rows of chunk d >> 4, which the next transform's
// chunk fills.  A chunk is 16 bulk copies (cp.async.bulk, the TMA unit, no
// thread's loads) of 1 KiB row segments, one mbarrier each chunk that
// counts its bytes: it completes once per transform, so a transform waits
// on the parity of its count in the block's walk.  The copies land in
// plain row order (a bulk copy writes contiguous bytes); the radix 16
// reads them so, and writes its outputs in the tile's bank swizzle.
constexpr int kChunks = 8;
constexpr int kChunkRows = kSlice / kChunks;            // 16
constexpr int kRowBytes = kSlice * (int)sizeof(float2);  // 1 KiB

static __device__ __forceinline__ void chunk_bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` of the mbarrier at `bar` has
// completed: every byte of that chunk has landed and is visible to this
// thread.
static __device__ __forceinline__ void chunk_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Chunks 2*pair and 2*pair + 1 of the slice at src (rows kLd apart in
// device memory) into their rows of buf, in plain order, by the 32 lanes
// of the calling warp: lane l copies row (l & 15)*8 + j1 of chunk j1 =
// 2*pair + (l >> 4), and lanes 0 and 16 first arm their chunk's mbarrier
// for its 16 KiB.  Generic accesses to those rows must be ordered before
// the call (a barrier); the proxy fence then orders them before the
// copies.  Reads x only.
template <int kLd>
static __device__ __forceinline__ void load_chunk_pair(const float2* __restrict__ src,
                                                       float2* buf, int pair, uint32_t bar0) {
  const int lane = (int)threadIdx.x & 31;
  const int j1 = 2 * pair + (lane >> 4);
  const int row = (lane & 15) * kChunks + j1;
  const uint32_t bar = bar0 + 8 * j1;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if ((lane & 15) == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(kChunkRows * kRowBytes)
                 : "memory");
  }
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(buf + row * kSlice);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src + row * kLd), "r"(kRowBytes), "r"(bar)
      : "memory");
}

// Stage A: DFT_128 over the rows b = j0*8 + j1 of the slice in the tile,
// chunk by chunk as the copies land (the mbarriers from bar0, 8 bytes
// apart, at `parity`), in the form kForm (`inverse`: the Gauss form's
// direction).
template <int kLd, bool kStamp, int kForm, class Io>
static __device__ __forceinline__ void slice_dft_rows(float2* buf, uint32_t bar0, uint32_t parity,
                                                      const float2* __restrict__ sroots,
                                                      const float2* __restrict__ tw,
                                                      RadixClock<kStamp>& clock, const Io& io,
                                                      long long t, int a, bool inverse) {
  // radix 16 over j0 for each (j1, t): row j0*8 + j1 in plain order to row
  // k0*8 + j1 in the swizzle.  The swizzle moves values within a row, so a
  // chunk's 128 threads (warps 4g .. 4g + 3) read all of its rows before any
  // writes (named barrier 1 + g).
  const int group = (int)threadIdx.x >> 7;
  float2 acc = make_float2(0.f, 0.f);
  for (int c = threadIdx.x; c < 1024; c += kFusedThreads) {
    if constexpr (Io::kBulk) chunk_wait(bar0 + 8 * (c >> 7), parity);
    float2 v[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      v[j] = buf[j * 1024 + c];
      if constexpr (!Io::kBulk)  // element (row j*8 + c/128, column c % 128) of slice a
        v[j] = io.take((j * 8 + (c >> 7)) * kLd + a * kSlice + (c & (kSlice - 1)), v[j], acc);
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + group) : "memory");
    if constexpr (kForm == kRadixRoots) {
      fft_pow2_reg<16>(v, sroots);
#pragma unroll
      for (int i = 0; i < 16; ++i) buf[swz(bitrev<16>(i) * 1024 + c)] = v[i];
    } else {
      gauss_dft<16>(v, inverse, [&](int k, float2 y) { buf[swz(k * 1024 + c)] = y; });
    }
  }
  io.sum(t, a, acc);
  __syncthreads();
  clock.lap(0);
  // twiddle and radix 8 over j1 for each (k0, t), in place
  for (int c = threadIdx.x; c < 2048; c += kFusedThreads) {
    const int k0 = c >> 7;
    const int base = k0 * 1024 + (c & (kSlice - 1));
    float2 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = buf[swz(base + j * kSlice)];
      if (j > 0) v[j] = cmul(v[j], tw[k0 * 8 + j]);
    }
    if constexpr (kForm == kRadixRoots) {
      fft_pow2_reg<8>(v, sroots + 16);
#pragma unroll
      for (int i = 0; i < 8; ++i) buf[swz(base + bitrev<8>(i) * kSlice)] = v[i];
    } else {
      gauss_dft<8>(v, inverse, [&](int k, float2 y) { buf[swz(base + k * kSlice)] = y; });
    }
  }
}

// Stage B: DFT_128 over the columns j2 = j0*8 + j1 of the tile for every
// frequency d, stored in natural order y[k2*kLd + d].  The radix 8 runs in
// the order of d >> 4, a pair of chunks' rows a pass (a warp on one k0 and
// 32 neighbouring d, as stores of 256 bytes); after each pass the block
// barrier frees those rows and, where `next` is not null, warp 0 starts the
// copies of the same two chunks of the next slice.  In the form kForm, as
// stage A.
template <int kLd, bool kStamp, int kForm, class Io, class Row>
static __device__ __forceinline__ void slice_dft_cols(float2* buf, const Io& io, long long next_t,
                                                      int a, const Row& y,
                                                      const float2* __restrict__ next,
                                                      uint32_t bar0,
                                                      const float2* __restrict__ sroots,
                                                      const float2* __restrict__ tw,
                                                      RadixClock<kStamp>& clock, bool inverse) {
  // radix 16 over j0 for each (row, j1), in place
  for (int c = threadIdx.x; c < 1024; c += kFusedThreads) {
    const int base = (c & (kSlice - 1)) * kSlice + (c >> 7);
    float2 v[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = buf[swz(base + j * 8)];
    if constexpr (kForm == kRadixRoots) {
      fft_pow2_reg<16>(v, sroots);
#pragma unroll
      for (int i = 0; i < 16; ++i) buf[swz(base + bitrev<16>(i) * 8)] = v[i];
    } else {
      gauss_dft<16>(v, inverse, [&](int k, float2 u) { buf[swz(base + k * 8)] = u; });
    }
  }
  __syncthreads();
  clock.lap(5);
  // twiddle and radix 8 over j1 for each (d, k0), to k2 = k0 + 16*k1
  const int k0 = threadIdx.x >> 5;
#pragma unroll 1
  for (int pass = 0; pass < kChunks / 2; ++pass) {
    const int d = pass * 32 + (threadIdx.x & 31);
    const int base = place_row(d) * kSlice + k0 * 8;
    float2 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = buf[swz(base + j)];
      if (j > 0) v[j] = cmul(v[j], tw[k0 * 8 + j]);
    }
    if constexpr (kForm == kRadixRoots) {
      fft_pow2_reg<8>(v, sroots + 16);
#pragma unroll
      for (int i = 0; i < 8; ++i) y.store((k0 + 16 * bitrev<8>(i)) * kLd + d, v[i]);
    } else {
      gauss_dft<8>(v, inverse, [&](int k, float2 u) { y.store((k0 + 16 * k) * kLd + d, u); });
    }
    __syncthreads();
    if constexpr (Io::kBulk) {
      if (next != nullptr && threadIdx.x < 32) load_chunk_pair<kLd>(next, buf, pass, bar0);
    } else {
      if (next_t >= 0) io.copy_pair(next_t, a, pass, buf);
    }
  }
}

// Distributed shared memory by 32-bit shared::cluster addresses, mapped
// once per access, so that no 64-bit pointer to a peer's tile stays live.
static __device__ __forceinline__ uint32_t peer_addr(uint32_t local, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(local), "r"(rank));
  return out;
}

static __device__ __forceinline__ float2 peer_load(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

static __device__ __forceinline__ void peer_store(uint32_t addr, float2 v) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};"
               :: "r"(addr), "f"(v.x), "f"(v.y) : "memory");
}

template <int R>
static __device__ __forceinline__ void cluster_barrier() {
  if constexpr (R > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

constexpr int kStaggerGroups = 4;
constexpr unsigned long long kStaggerNs = 5000;

// The radix kernel: a persistent grid of clusters of R blocks (R = 1: of
// single blocks, K7's 16384), cluster g computing the transforms g, g +
// clusters, ...  The walk is the cluster's, never the block's, so every
// block of a cluster passes the same cluster barriers.  While a transform
// runs stage B, the next one's chunks are copied into the rows stage B has
// read; peers write into this tile only in a transform's exchange, after
// the cluster barrier that follows every block's stage A, so those copies
// (issued after this block's exchange of the transform before) never meet
// a peer's access.
// K9's input and output: the slice by bulk copies (stage A), the stores in
// natural order y[t*N + k] (stage B).  An Io provides kBulk (bulk copies
// of x; else its own copies: copy_pair(t, a, pair, buf), every thread,
// the rows of chunks 2*pair and 2*pair + 1 of transform t's slice a into
// buf in plain order, one cp.async group, and wait() for this thread's
// groups; then take(j, v, acc) turns the value v of element j as it landed
// into stage A's input and adds its raw value to acc), row<N>(y, t, a)
// with store(i, v) for the value of frequency a*128 + i of transform t (i
// = k2*R*128 + d), sum(t, a, acc) (every thread, once per transform, after
// stage A's reads) and finish(t, a) (every thread, once per transform,
// before stage B).
struct RadixPlain {
  static constexpr bool kBulk = true;
  struct Row {
    float2* __restrict__ p;
    __device__ void store(int i, float2 v) const { p[i] = v; }
  };
  template <int N>
  __device__ Row row(float2* y, long long t, int a) const {
    return Row{y + t * N + a * kSlice};
  }
  __device__ void copy_pair(long long, int, int, float2*) const {}
  __device__ void wait() const {}
  __device__ float2 take(int, float2 v, float2&) const { return v; }
  __device__ void sum(long long, int, float2) const {}
  __device__ void finish(long long, int) const {}
};

// The DFT_128 chains run in the form kForm; the Gauss form reads its
// direction from st.gauss[0], DFT_16's Gauss table: the sign of Wi(1) =
// Im w_16^(+-1) (negative forward, positive inverse).
template <int R, bool kStamp, class Io, int kForm = kRadixRoots>
static __device__ __forceinline__ void radix_body(
    const float2* __restrict__ x, float2* __restrict__ y, long long batch, const Stages& st,
    const float2* __restrict__ t1, const float2* __restrict__ tn,
    const float2* __restrict__ rroots, const float2* __restrict__ cfac,
    unsigned long long* stamps, const Io& io) {
  constexpr int N = R * kSliceElems;
  constexpr int kShare = kSliceElems / R;
  constexpr int kLd = R * kSlice;
  // points a thread takes a pass in the exchange: at least 8 peer loads in
  // flight
  constexpr int kPoints = R >= 8 ? 1 : 8 / R;
  RadixClock<kStamp> clock;
  clock.begin();
  extern __shared__ float2 smem[];
  float2* buf = smem;
  // the small tables in shared memory: the chain's roots, w_R^e, the
  // chain's twiddle (16, 8), t1 (R, 128) and cfac (R, 128); then the
  // chunks' mbarriers
  float2* sroots = smem + kSliceElems;
  float2* stw = sroots + kSliceRoots + R;
  float2* st1 = stw + kSlice;
  float2* scfac = st1 + R * kSlice;
  const uint32_t bar0 = (uint32_t)__cvta_generic_to_shared(scfac + R * kSlice);
  bool inverse = false;
  if constexpr (kForm == kRadixGauss) inverse = __ldg(&st.gauss[0][16 + 1]) > 0.f;
  int a = 0;
  if constexpr (R > 1) a = (int)cg::this_cluster().block_rank();
  const long long clusters = gridDim.x / R;
  long long t = blockIdx.x / R;
  const float2* src = x + a * kSlice;
  if (threadIdx.x == 0) {
    for (int j = 0; j < kChunks; ++j) chunk_bar_init(bar0 + 8 * j);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (Io::kBulk && t < batch && threadIdx.x < 32) {
    for (int pair = 0; pair < kChunks / 2; ++pair)
      load_chunk_pair<kLd>(src + t * N, buf, pair, bar0);
  }
  if constexpr (!Io::kBulk) {
    if (t < batch) {
      for (int pair = 0; pair < kChunks / 2; ++pair) io.copy_pair(t, a, pair, buf);
    }
  }
  load_roots(st, sroots);
  for (int i = threadIdx.x; i < R; i += blockDim.x) sroots[kSliceRoots + i] = rroots[i];
  for (int i = threadIdx.x; i < kSlice; i += blockDim.x) stw[i] = st.tw[0][i];
  if constexpr (R > 1) {
    for (int i = threadIdx.x; i < R * kSlice; i += blockDim.x) {
      st1[i] = t1[i];
      scfac[i] = cfac[i];
    }
  }
  __syncthreads();
  // Where a cluster walks more than one transform, stagger the clusters:
  // cluster g starts (g % kStaggerGroups) * kStaggerNs late, so that one
  // cluster's store and next load (stage B) meet another's exchange, which
  // asks device memory for nothing, rather than every SM asking for its
  // bytes at once.  A batch of at most one transform a cluster has no next
  // load to overlap and starts at once.
  if (batch > clusters) {
    const unsigned long long t0 = global_timer();
    const unsigned long long wait = (unsigned long long)(t % kStaggerGroups) * kStaggerNs;
    while (global_timer() - t0 < wait) {
    }
  }

  for (uint32_t parity = 0; t < batch; t += clusters, parity ^= 1) {
    // stage A: DFT_128 over b of the slice x[b, a, :]
    if constexpr (!Io::kBulk) {  // the element copies, all landed
      io.wait();
      __syncthreads();
    }
    slice_dft_rows<kLd, kStamp, kForm>(buf, bar0, parity, sroots, stw, clock, io, t, a, inverse);
    clock.lap(1);
    cluster_barrier<R>();
    clock.lap(2);

    // the twiddles and the DFT_r across the cluster, on this block's share,
    // kPoints points a pass with all their peer loads in flight
    for (int f0 = a * kShare + threadIdx.x; f0 < (a + 1) * kShare;
         f0 += kPoints * kFusedThreads) {
      float2 v[kPoints][R];
#pragma unroll
      for (int u = 0; u < kPoints; ++u) {
        const int s = swz(f0 + u * kFusedThreads);
        const uint32_t local = (uint32_t)__cvta_generic_to_shared(buf + s);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if constexpr (R > 1) {
            v[u][r] = peer_load(peer_addr(local, r));
          } else {
            v[u][r] = buf[s];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kPoints; ++u) {
        const int f = f0 + u * kFusedThreads;
        const int i = f >> 7, j2 = f & (kSlice - 1);
        const int d = (i >> 3) + 16 * (i & 7);  // row i = place_row(d)
        const int s = swz(f);
        const uint32_t local = (uint32_t)__cvta_generic_to_shared(buf + s);
#pragma unroll
        for (int r = 1; r < R; ++r) v[u][r] = cmul(v[u][r], st1[r * kSlice + d]);
        fft_pow2_reg<R>(v[u], sroots + kSliceRoots);  // v[bitrev(c)] = C[c]
        const float2 w = __ldg(&tn[j2 * kSlice + d]);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int c = bitrev<R>(r);
          float2 z = cmul(v[u][r], w);
          if (c > 0) z = cmul(z, scfac[c * kSlice + j2]);
          if constexpr (R > 1) {
            peer_store(peer_addr(local, c), z);
          } else {
            buf[s] = z;
          }
        }
      }
    }
    clock.lap(3);
    cluster_barrier<R>();
    clock.lap(4);

    // stage B: DFT_128 over j2 for every d, stored at k2*rp + c*p + d (c =
    // a), the next transform's copies started as its rows free up
    const long long next = t + clusters;
    io.finish(t, a);
    slice_dft_cols<kLd, kStamp, kForm>(buf, io, next < batch ? next : -1, a,
                                       io.template row<N>(y, t, a),
                                       Io::kBulk && next < batch ? src + next * N : nullptr, bar0,
                                       sroots, stw, clock, inverse);
    clock.lap(6);
  }
  clock.write(stamps);
}

template <int R, bool kStamp>
__global__ void __launch_bounds__(kFusedThreads)
    radix_kernel(const float2* __restrict__ x, float2* __restrict__ y, long long batch, Stages st,
                 const float2* __restrict__ t1, const float2* __restrict__ tn,
                 const float2* __restrict__ rroots, const float2* __restrict__ cfac,
                 unsigned long long* stamps) {
  radix_body<R, kStamp>(x, y, batch, st, t1, tn, rroots, cfac, stamps, RadixPlain{});
}

// The radix body on another input and output (csrc/conv_radix.cu), in the
// form kForm.
template <int R, class Io, int kForm = kRadixRoots>
__global__ void __launch_bounds__(kFusedThreads)
    radix_io_kernel(const float2* __restrict__ x, float2* __restrict__ y, long long batch,
                    Stages st, const float2* __restrict__ t1, const float2* __restrict__ tn,
                    const float2* __restrict__ rroots, const float2* __restrict__ cfac, Io io) {
  radix_body<R, false, Io, kForm>(x, y, batch, st, t1, tn, rroots, cfac, nullptr, io);
}

static size_t radix_smem_bytes(int r) {
  return (size_t)(kSliceElems + kSliceRoots + r + kSlice + 2 * r * kSlice) * sizeof(float2) +
         kChunks * sizeof(uint64_t);
}

// The launch of `kernel`, a radix kernel of clusters of R blocks, on
// `clusters` clusters.
template <int R, typename K>
static cudaError_t radix_config_of(K kernel, cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                                   long long clusters, cudaStream_t s) {
  const size_t smem = radix_smem_bytes(R);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  if constexpr (R > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3((unsigned)(clusters * R), 1, 1);
  cfg.blockDim = dim3(kFusedThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = R;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = R > 1 ? 1 : 0;
  return cudaSuccess;
}

template <int R, bool kStamp>
static cudaError_t radix_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                                long long clusters, cudaStream_t s) {
  return radix_config_of<R>(radix_kernel<R, kStamp>, cfg, attr, clusters, s);
}

// One launch of `clusters` clusters (1 <= clusters <= batch; the caller's
// persistent grid, ops/kernels/fused.py radix_grid) over the batch.  Rows
// are read by bulk copies, so x must be 16-byte aligned.
template <int R, bool kStamp = false>
static cudaError_t launch_radix(const float2* x, float2* y, long long batch, long long clusters,
                                const Stages& st, const float2* t1, const float2* tn,
                                const float2* rroots, const float2* cfac,
                                unsigned long long* stamps, cudaStream_t s) {
  if (clusters < 1 || clusters > batch || clusters * R > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = radix_config<R, kStamp>(cfg, attr, clusters, s);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, radix_kernel<R, kStamp>, x, y, batch, st, t1, tn, rroots, cfac,
                           stamps);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int R>
static cudaError_t max_active_clusters(int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = radix_config<R, false>(cfg, attr, 1, 0);
  if (err != cudaSuccess) return err;
  if constexpr (R > 1) {
    return cudaOccupancyMaxActiveClusters(out, radix_kernel<R, false>, &cfg);
  } else {
    // single blocks: the blocks an SM holds (one: the tile fills it) times the SMs
    int dev = 0, sms = 0, per_sm = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, radix_kernel<1, false>,
                                                          kFusedThreads, radix_smem_bytes(1));
    *out = sms * per_sm;
    return err;
  }
}

}  // namespace rf
