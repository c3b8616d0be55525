// The one-pass mid band: the ports of K9 (radix_fft), K7 (two_stage_fft,
// two_stage_cluster_fft) and, on K9's and K7's bodies, K8
// (three_stage_fft, ops/kernels/fused.py three_stage_form).
//
// Replaces rustfft_tpu/ops/pallas/fused.py.  Each kernel makes one read and
// one write of the signal in device memory, 16 bytes per point (1.07 GB at
// 65536 x 1024: 0.32 ms at 3.35 TB/s); the FP32 work, 5*n*log2(n) plus the
// twiddles, is far under the card's peak.  What is left between them and
// that bound is latency: one 512-thread block per SM (the tile fills its
// shared memory), whose loads, stages and stores run in turn in the
// two-stage kernels (the radix kernel overlaps a transform's load with the
// stage B of the one before, below).  Every stage
// holds at most 16 values a thread at a time (the cluster kernel's exchange
// 32); tools/torch_ptxas.py prints each form's registers and spills.
//
// radix_fft (K9: fused.py _fused_kernel_vpur, _ctw, _ctwg, _ctwgn, _ctwgx,
// one function in five TPU layouts; its body is csrc/radix.cuh, which the
// two-pass convolution core's cluster passes share).  n = r * 128 * 128 is 256 KiB .. 2 MiB
// at r = 2 .. 16, more than one SM's 227 KB of shared memory, so one
// transform is one thread-block cluster of r blocks (cudaLaunchKernelEx with
// a cluster dimension; r = 16 is a non-portable cluster size), block a
// holding the 128 x 128 slice x[b, a, j2] (128 KiB), j = b*rq + a*q + j2:
//   1. stage A: DFT_128 over b for every j2 (the chain (16, 8)), A[d, j2]
//      in the tile (row place_row(d)).  The slice arrives by bulk copies
//      (TMA) in eight chunks of 16 rows, one mbarrier each, and the radix
//      16 of a chunk starts as soon as it lands;
//   2. cluster barrier, then the DFT_r across the cluster through
//      distributed shared memory: block t takes the points (d, j2) of its
//      1/r share, reads A_a[d, j2] from every block a, multiplies by
//      w_rp^(a*d), runs the radix-2 chain in registers (fft_pow2_reg<R>),
//      multiplies output c by w_n^(j2*d) * w_rq^(c*j2) and writes it into
//      block c's tile at the same place, several points a pass so that a
//      thread keeps at least 8 peer loads in flight.  The shares are
//      disjoint, so this is safe in place.  The TPU kernels' merged table
//      w_n^((a*q+j2)*d) of n entries is factored into t1 (r, 128) and tn
//      (128, 128);
//   3. cluster barrier again (no block leaves while a peer reads it), then
//      stage B: DFT_128 over j2 for every d (the tile read transposed) and
//      the store in natural order at k2*rp + c*p + d, 1 KiB segments; the
//      radix 8 walks the chunks in order and starts the next transform's
//      copies into each pair of chunks it has read.
// The grid is persistent: as many clusters as the card holds at once
// (cudaOccupancyMaxActiveClusters; 7 of 16 blocks fill 112 of 132 SMs), at
// most one a transform, each walking the batch, so that one transform's
// load overlaps the one before's stage B and store.  The bound is the
// bytes, 16 a point (0.32 ms at 2^28 points); the exchange, whose remote
// loads and stores move as many bytes through distributed shared memory as
// the transform moves through device memory, takes the largest share of a
// block's time.  With R = 1 the same body, without a cluster, is the
// two-stage kernel at 16384 = 128 x 128 (tn is then its outer twiddle
// w_n^(k1*j2)); it runs the persistent body too, which read faster there
// than one transform a block (PERF.md, PR 11).
//
// two_stage_fft and two_stage_cluster_fft (K7: fused.py _fused_kernel,
// _fused_kernel_gauss, _fused_kernel_twodot), n = p * q: DFT_p over j1
// for every j2, the outer twiddle w_n^(k1*j2), DFT_q over j2 for every k1,
// the output at k = k2*p + k1.  Register radices load one column into
// registers; a prime radix from 29 up runs a Bluestein stage, one warp per
// column in registers (stage_bluestein_inplace); the primes 11 to 23 a
// direct sum (stage_table_inplace, 8r operations a point).  Each kernel has
// two forms: MaxM = 0 for chains without a Bluestein stage, which run K7's
// chains (chain_inplace<0, true>: the register radices in K7's factored
// forms, csrc/factored_dft.cuh, 3, 5 and 7 as butterflies on conjugate
// pairs, 6, 9, 10, 12, 14, 15 and 20 as one Cooley-Tukey step over those
// and 2 and 4; the outer twiddle from its transpose (p, q) where the caller
// gives one, whose neighbouring entries neighbouring threads read,
// OuterFoldS); and the Bluestein form, whose chains are the in-place
// chain's own, the (q, p) table folded as before (the factored forms there
// measured 2-7% slower at 28544 and 260608, PERF.md, PR 28).
//
// two_stage_fft (the one-block band, 14464 .. 28800 but 16384, which runs
// the radix body at R = 1): one block a transform, the whole transform in
// place in its shared memory (two_stage_kernel below).
//
// two_stage_cluster_fft (the cluster band, the aligned n from 28928 to
// 261632: 226 KiB .. 2 MiB a transform, p = 129 .. 511, q = 128 .. 512;
// and K8 at p = 128, q = 256 .. 2048, its DFT_q as the register chain of
// q): a transform does not fit one SM, so one thread-block cluster of c =
// 2, 4, 8 or 16 blocks computes it, in one read and one write of device
// memory:
//   1. block b loads the columns j2 = b*q/c .. (b+1)*q/c - 1 of every row j1
//      (segments of 8q/c bytes, 16 bytes a thread in the form without a
//      Bluestein stage) and runs DFT_p on them in place, the outer twiddle
//      folded into the last stage;
//   2. cluster barrier; block b pulls its rows k1 = b*p/c .. (b+1)*p/c - 1
//      (balanced shares, ragged where c does not divide p) of every peer's
//      columns through distributed shared memory into registers, 32 values
//      a thread at 512 threads; cluster barrier; it writes them into its
//      buffer as rows of q.  There is no room for a second buffer (a share
//      is up to 128 KiB), so registers carry the exchange, and that sets
//      the share cap of 16384 values and with it c (ops/kernels/fused.py
//      choose_cluster);
//   3. DFT_q over j2 on each of its rows in place, then the store at
//      k = k2*p + k1, rows of p/c values a k2 (16 bytes a thread in that
//      form where p and the share's first row and width are even).
// A persistent walk of the batch with the next transform's share copied in
// during DFT_q and the store (a share and the row share in one buffer) was
// measured on the card and dropped: it ran 13-20% slower at 28928 and
// 260608 and level or 4% faster at the register-radix sizes (PERF.md,
// PR 28).  The function's bound is its bytes (0.24-0.57 ms for
// chip_smoke.py's paths).  921 of the cluster band's 1009 sizes have a radix
// without a register stage: 665 a prime from 29 to 509 (the Bluestein
// stage, M up to 1024, about 190-440 operations a point), 256 a direct sum
// of 11 to 23.
//
// The in-place chain (its stages, the Bluestein stage, chain_inplace and
// place_of) is csrc/inplace_chain.cuh, which K12's kernels
// (csrc/largepad.cu) and K1's chain kernel share in their own forms.
#include "radix.cuh"

namespace rf {

// ---- the one-block band (K7's two_stage_fft) ----------------------------------

constexpr int kBlockThreads = 512;
// The one-block band's radices stay under 256: Bluestein lengths up to 512
constexpr int kBlockMaxM = 512;
constexpr int kBlockIo = 4;  // pairs of values a thread loads or stores in flight

// Phase stamps of K7's kernels (their kStamp forms, built only into the
// library compiled with RF_PHASE_STAMPS, which no route loads):
// %globaltimer at a block's start and at the end of each phase, read by
// thread 0 after a block barrier (tools/torch_phase_times.py): the load,
// DFT_p, DFT_q and the store of the one-block kernel (kBlockStamps); the
// load, DFT_p, the exchange, DFT_q and the store of the cluster kernel
// (kClusterStamps).
constexpr int kBlockStamps = 5;
constexpr int kClusterStamps = 6;

template <bool kStamp>
static __device__ __forceinline__ void stamp(unsigned long long* stamps, int per_block, int i) {
  if constexpr (kStamp) {
    if (threadIdx.x == 0) stamps[(size_t)blockIdx.x * per_block + i] = global_timer();
  }
}

// One block a transform of n = p*q up to 28800 (225 KiB) with the whole
// transform in one shared buffer, so every stage runs in place; the store
// reads each natural index from its digit-reversed place through two small
// index tables (p + q ints).  Loads and stores move two values a thread
// (16 bytes: n is even and x and y 16-byte aligned).  The two-stage walk
// on two blocks, measured on this band, took 1.3-1.5x the time of one
// block a transform (PERF.md, PR 28).
template <int MaxM, bool kStamp>
__global__ void __launch_bounds__(kBlockThreads)
    two_stage_kernel(const float2* __restrict__ x, float2* __restrict__ y, int p, int q,
                     Stages sp, Stages sq, const float2* __restrict__ outer, int outer_t,
                     unsigned long long* stamps) {
  extern __shared__ float2 smem[];
  stamp<kStamp>(stamps, kBlockStamps, 0);
  const int n = p * q, half = n / 2;
  float2* buf = smem;
  float2* tabs_p = smem + pad16(n);
  float2* tabs_q = tabs_p + chain_smem_len(sp);
  int* prow = reinterpret_cast<int*>(tabs_q + chain_smem_len(sq));
  int* qcol = prow + p;
  load_chain_tables(sp, tabs_p);
  load_chain_tables(sq, tabs_q);
  for (int k = threadIdx.x; k < p; k += blockDim.x) prow[k] = place_of(k, p, sp) * q;
  for (int k = threadIdx.x; k < q; k += blockDim.x) qcol[k] = place_of(k, q, sq);
  const float4* src = reinterpret_cast<const float4*>(x + (size_t)blockIdx.x * n);
  float4* dst = reinterpret_cast<float4*>(y + (size_t)blockIdx.x * n);
  const int stride = kBlockIo * (int)blockDim.x;
  for (int h0 = threadIdx.x; h0 < half; h0 += stride) {
    float4 v[kBlockIo];
#pragma unroll
    for (int u = 0; u < kBlockIo; ++u) {
      const int h = h0 + u * (int)blockDim.x;
      if (h < half) v[u] = src[h];
    }
#pragma unroll
    for (int u = 0; u < kBlockIo; ++u) {
      const int h = h0 + u * (int)blockDim.x;
      if (h < half) {
        buf[swz(2 * h)] = make_float2(v[u].x, v[u].y);
        buf[swz(2 * h + 1)] = make_float2(v[u].z, v[u].w);
      }
    }
  }
  __syncthreads();
  stamp<kStamp>(stamps, kBlockStamps, 1);
  // DFT_p over j1 for every j2 (the rows j1 of q interleaved transforms),
  // its last stage times the outer twiddle; then DFT_q over j2 for every
  // k1 (p contiguous rows of q)
  chain_inplace<MaxM, MaxM == 0>(buf, p, 1, q, sp, tabs_p, outer, outer_t ? 1 : p,
                                 outer_t ? q : 1);
  stamp<kStamp>(stamps, kBlockStamps, 2);
  chain_inplace<MaxM, MaxM == 0>(buf, q, p, 1, sq, tabs_q, nullptr, 0);
  stamp<kStamp>(stamps, kBlockStamps, 3);
  // k = k2*p + k1 from row prow[k1], column qcol[k2], two k a thread;
  // (k1, k2) advance without a division
  const int step = 2 * (int)blockDim.x;
  const int dq = step / p, dr = step - dq * p;
  int k2 = 2 * (int)threadIdx.x / p, k1 = 2 * (int)threadIdx.x - k2 * p;
  for (int h0 = threadIdx.x; h0 < half; h0 += stride) {
    float4 v[kBlockIo];
#pragma unroll
    for (int u = 0; u < kBlockIo; ++u) {
      if (h0 + u * (int)blockDim.x < half) {
        const float2 e = buf[swz(prow[k1] + qcol[k2])];
        const bool wrap = k1 + 1 == p;
        const float2 o = buf[swz(prow[wrap ? 0 : k1 + 1] + qcol[wrap ? k2 + 1 : k2])];
        v[u] = make_float4(e.x, e.y, o.x, o.y);
      }
      k1 += dr;
      k2 += dq;
      if (k1 >= p) {
        k1 -= p;
        ++k2;
      }
    }
#pragma unroll
    for (int u = 0; u < kBlockIo; ++u) {
      const int h = h0 + u * (int)blockDim.x;
      if (h < half) dst[h] = v[u];
    }
  }
  if constexpr (kStamp) {
    __syncthreads();
    stamp<kStamp>(stamps, kBlockStamps, 4);
  }
}

// ---- the cluster band (K7's two_stage_cluster_fft) -----------------------------

constexpr int kClusterThreads = 512;
constexpr int kHold = 32;                                // values a thread holds in the exchange
constexpr int kClusterIo = 8;                            // loads and stores a thread has in flight
constexpr int kClusterShare = kClusterThreads * kHold;   // 16384: the most values of a block
// The cluster kernel's primes p up to 509 take Bluestein lengths up to 1024
// (16 values a lane in each half of the stage)
constexpr int kClusterMaxM = 1024;

// First row k1 of block b's share of the p rows (balanced: the shares of a
// cluster of c blocks differ by at most one row).
static __host__ __device__ __forceinline__ int share_lo(int b, int p, int c) { return b * p / c; }

// Values a block's buffer holds: its column share (p rows of q/c columns)
// or its widest row share (ceil(p/c) rows of q), whichever is more.
static __host__ __device__ __forceinline__ int cluster_share(int p, int q, int c) {
  const int cols = p * (q / c), rows = (p + c - 1) / c * q;
  return cols > rows ? cols : rows;
}

// The (row, column) of f = f0 + u*kClusterThreads in rows of width w, for
// u = 0, 1, ..., advanced without a division.
struct Walk {
  int row, col;
  const int w, drow, dcol;
  __device__ Walk(int f0, int w_)
      : row(f0 / w_), col(f0 % w_), w(w_), drow(kClusterThreads / w_), dcol(kClusterThreads % w_) {}
  __device__ void next() {
    row += drow;
    col += dcol;
    if (col >= w) {
      col -= w;
      ++row;
    }
  }
};

// One cluster of c blocks a transform (the design at the top of this file).
// The form without a Bluestein stage (kFact) runs K7's factored chains and
// moves two values a thread in its loads and stores; the Bluestein form
// keeps the in-place chain's own radices and one value a thread, which
// measured faster there (PERF.md, PR 28).
template <int MaxM, bool kStamp>
__global__ void __launch_bounds__(kClusterThreads)
    two_stage_cluster_kernel(const float2* __restrict__ x, float2* __restrict__ y, int p, int q,
                             int c, Stages sp, Stages sq, const float2* __restrict__ outer,
                             int outer_t, unsigned long long* stamps) {
  constexpr bool kFact = MaxM == 0;
  extern __shared__ float2 smem[];
  stamp<kStamp>(stamps, kClusterStamps, 0);
  const int b = (int)cg::this_cluster().block_rank();
  const int tid = threadIdx.x;
  const int qs = q / c;
  const int lo = share_lo(b, p, c);
  const int rb = share_lo(b + 1, p, c) - lo;
  float2* buf = smem;
  float2* tabs_p = smem + pad16(cluster_share(p, q, c));
  float2* tabs_q = tabs_p + chain_smem_len(sp);
  int* prow = reinterpret_cast<int*>(tabs_q + chain_smem_len(sq));
  int* qcol = prow + p;
  int* peer_col = qcol + q;  // (a << 16) | t: column j2 = a*qs + t of block a
  load_chain_tables(sp, tabs_p);
  load_chain_tables(sq, tabs_q);
  for (int k = tid; k < p; k += kClusterThreads) prow[k] = place_of(k, p, sp) * qs;
  for (int k = tid; k < q; k += kClusterThreads) {
    qcol[k] = place_of(k, q, sq);
    peer_col[k] = (k / qs) << 16 | (k % qs);
  }
  const size_t base = (size_t)(blockIdx.x / c) * (size_t)p * (size_t)q;

  // 1. the share's columns j2 = b*qs + t of every row j1, (j1, t) at j1*qs
  //    + t; two a thread in the form without a Bluestein stage (qs, q and
  //    b*qs are even, x 16-byte aligned)
  const int ncol = p * qs;
  const float2* src = x + base + (size_t)b * qs;
  if constexpr (kFact) {
    const int hs = qs / 2, npair = ncol / 2;
    Walk w(tid, hs);
    for (int g0 = tid; g0 < npair; g0 += kClusterIo * kClusterThreads) {
      float4 v[kClusterIo];
#pragma unroll
      for (int u = 0; u < kClusterIo; ++u, w.next())
        if (g0 + u * kClusterThreads < npair)
          v[u] = *reinterpret_cast<const float4*>(src + (size_t)w.row * q + 2 * w.col);
#pragma unroll
      for (int u = 0; u < kClusterIo; ++u) {
        const int g = g0 + u * kClusterThreads;
        if (g < npair) {
          buf[swz(2 * g)] = make_float2(v[u].x, v[u].y);
          buf[swz(2 * g + 1)] = make_float2(v[u].z, v[u].w);
        }
      }
    }
  } else {
    Walk w(tid, qs);
    for (int f0 = tid; f0 < ncol; f0 += kClusterIo * kClusterThreads) {
      float2 v[kClusterIo];
#pragma unroll
      for (int u = 0; u < kClusterIo; ++u, w.next())
        if (f0 + u * kClusterThreads < ncol) v[u] = src[(size_t)w.row * q + w.col];
#pragma unroll
      for (int u = 0; u < kClusterIo; ++u) {
        const int f = f0 + u * kClusterThreads;
        if (f < ncol) buf[swz(f)] = v[u];
      }
    }
  }
  __syncthreads();
  stamp<kStamp>(stamps, kClusterStamps, 1);

  // 2. DFT_p over j1 for each of the share's columns, the outer twiddle
  //    w_n^(k1*j2) (the share's rows b*qs .. of the (q, p) table, or its
  //    columns of the (p, q) one) folded into its last stage: row k1 then
  //    sits at prow[k1]
  const int sj = kFact && outer_t ? 1 : p, sk = kFact && outer_t ? q : 1;
  chain_inplace<MaxM, kFact>(buf, p, 1, qs, sp, tabs_p, outer + (size_t)b * qs * sj, sj, sk);
  stamp<kStamp>(stamps, kClusterStamps, 2);

  // 3. the exchange: every block's DFT_p is done (barrier), this block pulls
  //    its rows lo .. lo + rb of every peer's columns into registers, every
  //    peer has read this block's columns (barrier), and the rows go into
  //    the buffer as rb rows of q, (i, j2) at i*q + j2
  cg::this_cluster().sync();
  const uint32_t buf_addr = (uint32_t)__cvta_generic_to_shared(buf);
  const int nrow = rb * q;
  float2 hold[kHold];
  {
    Walk w(tid, q);
#pragma unroll
    for (int u = 0; u < kHold; ++u, w.next()) {
      if (u * kClusterThreads + tid < nrow) {
        const int m = peer_col[w.col];
        const int s = swz(prow[lo + w.row] + (m & 0xffff));
        hold[u] = peer_load(peer_addr(buf_addr + (uint32_t)(s * sizeof(float2)), m >> 16));
      }
    }
  }
  cg::this_cluster().sync();
#pragma unroll
  for (int u = 0; u < kHold; ++u) {
    const int f = u * kClusterThreads + tid;
    if (f < nrow) buf[swz(f)] = hold[u];
  }
  __syncthreads();
  stamp<kStamp>(stamps, kClusterStamps, 3);

  // 4. DFT_q over j2 for each of the share's rows
  chain_inplace<MaxM, kFact>(buf, q, rb, 1, sq, tabs_q, nullptr, 0);
  stamp<kStamp>(stamps, kClusterStamps, 4);

  // 5. the store at k = k2*p + lo + i, rb values per k2 in a row; two a
  //    thread (16 bytes) in the form without a Bluestein stage where every
  //    row of the share starts even and is of even width
  float2* dst = y + base + lo;
  if (kFact && p % 2 == 0 && lo % 2 == 0 && rb % 2 == 0) {
    const int hb = rb / 2, npair = hb * q;
    Walk w(tid, hb);
    for (int g0 = tid; g0 < npair; g0 += kClusterIo * kClusterThreads) {
      float4 v[kClusterIo];
      Walk r = w;
#pragma unroll
      for (int u = 0; u < kClusterIo; ++u, r.next()) {
        if (g0 + u * kClusterThreads < npair) {
          const int col = qcol[r.row];
          const float2 e = buf[swz(2 * r.col * q + col)];
          const float2 o = buf[swz((2 * r.col + 1) * q + col)];
          v[u] = make_float4(e.x, e.y, o.x, o.y);
        }
      }
#pragma unroll
      for (int u = 0; u < kClusterIo; ++u, w.next())
        if (g0 + u * kClusterThreads < npair)
          *reinterpret_cast<float4*>(dst + (size_t)w.row * p + 2 * w.col) = v[u];
    }
  } else {
    Walk w(tid, rb);
    for (int f0 = tid; f0 < nrow; f0 += kClusterIo * kClusterThreads) {
      float2 v[kClusterIo];
      Walk r = w;
#pragma unroll
      for (int u = 0; u < kClusterIo; ++u, r.next())
        if (f0 + u * kClusterThreads < nrow) v[u] = buf[swz(r.col * q + qcol[r.row])];
#pragma unroll
      for (int u = 0; u < kClusterIo; ++u, w.next())
        if (f0 + u * kClusterThreads < nrow) dst[(size_t)w.row * p + w.col] = v[u];
    }
  }
  if constexpr (kStamp) {
    __syncthreads();
    stamp<kStamp>(stamps, kClusterStamps, 5);
  }
}

// Shared memory of a kernel whose fixed part (its buffer and index tables)
// takes `fixed` bytes, with the roots of the direct stages of chains a and b.
static size_t with_chain_tables(size_t fixed, const Stages& a, const Stages& b) {
  return fixed + (size_t)(chain_smem_len(a) + chain_smem_len(b)) * sizeof(float2);
}

static size_t cluster_smem_fixed(int p, int q, int c) {
  return (size_t)pad16(cluster_share(p, q, c)) * sizeof(float2) + (size_t)(p + 2 * q) * sizeof(int);
}

template <int MaxM, bool kStamp>
static cudaError_t cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                                  long long batch, int c, size_t smem, cudaStream_t s) {
  cudaError_t err = allow_smem(two_stage_cluster_kernel<MaxM, kStamp>, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(two_stage_cluster_kernel<MaxM, kStamp>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3((unsigned)(batch * c), 1, 1);
  cfg.blockDim = dim3(kClusterThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = c;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <int MaxM, bool kStamp>
static cudaError_t launch_cluster(const float2* x, float2* y, long long batch, int p, int q, int c,
                                  const Stages& sp, const Stages& sq, const float2* outer,
                                  int outer_t, unsigned long long* stamps, cudaStream_t s) {
  const size_t smem = with_chain_tables(cluster_smem_fixed(p, q, c), sp, sq);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<MaxM, kStamp>(cfg, attr, batch, c, smem, s);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, two_stage_cluster_kernel<MaxM, kStamp>, x, y, p, q, c, sp, sq,
                           outer, outer_t, stamps);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

static bool cluster_size_ok(int c) { return c == 2 || c == 4 || c == 8 || c == 16; }

static bool aligned16(const void* a) { return reinterpret_cast<uintptr_t>(a) % 16 == 0; }

// The outer twiddle's layout fits the kernel's form: the (p, q) table only
// in the form without a Bluestein stage (K7's factored chains).
static bool outer_layout_ok(const Stages& sp, const Stages& sq, int outer_t) {
  return !outer_t || !(has_bluestein(sp) || has_bluestein(sq));
}

// rf_two_stage_cluster_fft's checks and launch: the kernel's form without a
// Bluestein stage where neither chain has one; its stamped form (`stamps`
// (batch*c, kClusterStamps)) where kStamp.
template <bool kStamp>
static int cluster_fft(const void* x, void* y, long long batch, int p, int q, int c,
                       const Stages& sp, const Stages& sq, const void* outer, int outer_t,
                       unsigned long long* stamps, void* stream) {
  if (batch <= 0 || p < c || q <= 0 || outer == nullptr || !cluster_size_ok(c) || q % c ||
      (q / c) % 2 || batch * c > 0x7fffffffLL || cluster_share(p, q, c) > kClusterShare ||
      !aligned16(x) || !aligned16(y))
    return cudaErrorInvalidValue;
  if (!stages_ok(sp, p) || !stages_ok(sq, q) || !chain_ok(sp, kClusterMaxM) ||
      !chain_ok(sq, kClusterMaxM) || !outer_layout_ok(sp, sq, outer_t))
    return cudaErrorInvalidValue;
  const auto* tx = static_cast<const float2*>(x);
  auto* ty = static_cast<float2*>(y);
  const auto* to = static_cast<const float2*>(outer);
  const auto s = static_cast<cudaStream_t>(stream);
  if (has_bluestein(sp) || has_bluestein(sq))
    return launch_cluster<kClusterMaxM, kStamp>(tx, ty, batch, p, q, c, sp, sq, to, outer_t,
                                                stamps, s);
  return launch_cluster<0, kStamp>(tx, ty, batch, p, q, c, sp, sq, to, outer_t, stamps, s);
}

// The chain st with the Bluestein lengths of its stages (0: none).
static Stages with_bluestein(Stages st, int m0, int m1, int m2) {
  st.bm[0] = m0;
  st.bm[1] = m1;
  st.bm[2] = m2;
  return st;
}

static bool is_chain(const Stages& st, int r0, int r1) {
  return st.k == 2 && st.r[0] == r0 && st.r[1] == r1;
}

// rf_radix_fft's checks and launch; its stamped form where kStamp.
template <bool kStamp>
static int radix_fft(const void* x, void* y, long long batch, long long clusters, int r,
                     const Stages& st, const void* t1, const void* tn, const void* rroots,
                     const void* cfac, unsigned long long* stamps, void* stream) {
  if (batch <= 0 || t1 == nullptr || tn == nullptr || rroots == nullptr || cfac == nullptr)
    return cudaErrorInvalidValue;
  if (!stages_ok(st, kSlice) || !is_chain(st, 16, 8)) return cudaErrorInvalidValue;
  const auto* tx = static_cast<const float2*>(x);
  auto* ty = static_cast<float2*>(y);
  const auto* a = static_cast<const float2*>(t1);
  const auto* b = static_cast<const float2*>(tn);
  const auto* c = static_cast<const float2*>(rroots);
  const auto* d = static_cast<const float2*>(cfac);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (r) {
    case 2: return launch_radix<2, kStamp>(tx, ty, batch, clusters, st, a, b, c, d, stamps, s);
    case 4: return launch_radix<4, kStamp>(tx, ty, batch, clusters, st, a, b, c, d, stamps, s);
    case 8: return launch_radix<8, kStamp>(tx, ty, batch, clusters, st, a, b, c, d, stamps, s);
    case 16: return launch_radix<16, kStamp>(tx, ty, batch, clusters, st, a, b, c, d, stamps, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace rf

// x, y: (batch, r*128*128) complex64, x 16-byte aligned; `clusters` the
// persistent grid's clusters of r blocks (1 .. batch); `st` the DFT_128
// chain (16, 8); t1: (r, 128) w_{128r}^(a*d), tn: (128, 128) w_n^(j2*d),
// rroots: (r,) w_r^e, cfac: (r, 128) w_{128r}^(c*j2).  r in {2, 4, 8, 16}.
// Returns a cudaError_t code; launches on `stream`.
extern "C" int rf_radix_fft(const void* x, void* y, long long batch, long long clusters, int r,
                            int k, int r0, int r1, int r2, const void* roots0, const void* roots1,
                            const void* roots2, const void* tw0, const void* tw1, const void* t1,
                            const void* tn, const void* rroots, const void* cfac, void* stream) {
  using namespace rf;
  return radix_fft<false>(x, y, batch, clusters, r, make_stages(k, r0, r1, r2, roots0, roots1, roots2, tw0,
                                                      tw1),
                          t1, tn, rroots, cfac, nullptr, stream);
}

#ifdef RF_PHASE_STAMPS
// rf_radix_fft through the kernel's stamped form: stamps (clusters*r,
// kRadixPhases + 1) uint64 %globaltimer nanoseconds, a block's start and that
// start plus the running sums of its phases over its transforms.  Only the
// library built with RF_PHASE_STAMPS has it (ops/kernels/_build.py
// load(phase_stamps=True); tools/torch_phase_times.py).
extern "C" int rf_radix_phase_stamps(const void* x, void* y, long long batch, long long clusters,
                                     int r, int k, int r0, int r1, int r2, const void* roots0,
                                     const void* roots1, const void* roots2, const void* tw0,
                                     const void* tw1, const void* t1, const void* tn,
                                     const void* rroots, const void* cfac, void* stamps,
                                     void* stream) {
  using namespace rf;
  if (stamps == nullptr) return cudaErrorInvalidValue;
  return radix_fft<true>(x, y, batch, clusters, r, make_stages(k, r0, r1, r2, roots0, roots1, roots2, tw0,
                                                     tw1),
                         t1, tn, rroots, cfac, static_cast<unsigned long long*>(stamps), stream);
}
#endif

// cudaOccupancyMaxActiveClusters of rf_radix_fft's kernel at r into *out;
// at r = 1 (K7's 16384) the blocks the card holds at once.
extern "C" int rf_radix_max_active_clusters(int r, int* out) {
  using namespace rf;
  switch (r) {
    case 1: return max_active_clusters<1>(out);
    case 2: return max_active_clusters<2>(out);
    case 4: return max_active_clusters<4>(out);
    case 8: return max_active_clusters<8>(out);
    case 16: return max_active_clusters<16>(out);
    default: return cudaErrorInvalidValue;
  }
}

namespace rf {

// rf_two_stage_fft's checks and launch at every split but 16384: the
// one-block kernel's form without a Bluestein stage where neither chain
// has one; its stamped form (`stamps` (batch, kBlockStamps)) where kStamp.
template <bool kStamp>
static int one_block_fft(const float2* x, float2* y, long long batch, int p, int q,
                         const Stages& sp, const Stages& sq, const float2* outer, int outer_t,
                         unsigned long long* stamps, cudaStream_t s) {
  const size_t smem = with_chain_tables(
      (size_t)pad16(p * q) * sizeof(float2) + (size_t)(p + q) * sizeof(int), sp, sq);
  if (smem > kSmemMax || (p * q) % 2 || !aligned16(x) || !aligned16(y))
    return cudaErrorInvalidValue;
  const auto kernel = has_bluestein(sp) || has_bluestein(sq)
                          ? two_stage_kernel<kBlockMaxM, kStamp>
                          : two_stage_kernel<0, kStamp>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)batch, kBlockThreads, smem, s>>>(x, y, p, q, sp, sq, outer, outer_t, stamps);
  return cudaGetLastError();
}

// Whether rf_two_stage_fft's arguments and both chains fit the one-block
// kernel.
static bool one_block_chains(const Stages& sp, const Stages& sq, long long batch, int p, int q,
                             const void* outer, int outer_t) {
  return batch > 0 && batch <= 0x7fffffffLL && p > 0 && q > 0 && outer != nullptr &&
         stages_ok(sp, p) && stages_ok(sq, q) && chain_ok(sp, kBlockMaxM) &&
         chain_ok(sq, kBlockMaxM) && outer_layout_ok(sp, sq, outer_t);
}

}  // namespace rf

// x, y: (batch, p*q) complex64, both 16-byte aligned; sp / sq the chains
// of DFT_p and DFT_q (the chain_args of each: padded_stage_args and the
// Bluestein length M of each stage, 0 for the others, whose roots slot
// then holds the stage's Bluestein table); outer: w_n^(k1*j2) as (q, p),
// or as its transpose (p, q) where outer_t (not at 16384).  One
// block per transform, in place in shared memory (two_stage_kernel); p =
// q = 128 with both chains (16, 8) runs the radix kernel's body at R = 1
// on `clusters` blocks, the caller's persistent grid (ops/kernels/fused.py
// radix_grid; ignored at every other n).  Returns a cudaError_t code;
// launches on `stream`.
extern "C" int rf_two_stage_fft(const void* x, void* y, long long batch, int p, int q, int kp,
                                int rp0, int rp1, int rp2, const void* rootsp0,
                                const void* rootsp1, const void* rootsp2, const void* twp0,
                                const void* twp1, int mp0, int mp1, int mp2, int kq, int rq0,
                                int rq1, int rq2, const void* rootsq0, const void* rootsq1,
                                const void* rootsq2, const void* twq0, const void* twq1, int mq0,
                                int mq1, int mq2, const void* outer, int outer_t,
                                long long clusters, void* stream) {
  using namespace rf;
  const Stages sp = with_bluestein(
      make_stages(kp, rp0, rp1, rp2, rootsp0, rootsp1, rootsp2, twp0, twp1), mp0, mp1, mp2);
  const Stages sq = with_bluestein(
      make_stages(kq, rq0, rq1, rq2, rootsq0, rootsq1, rootsq2, twq0, twq1), mq0, mq1, mq2);
  if (!one_block_chains(sp, sq, batch, p, q, outer, outer_t)) return cudaErrorInvalidValue;
  const auto* tx = static_cast<const float2*>(x);
  auto* ty = static_cast<float2*>(y);
  const auto* to = static_cast<const float2*>(outer);
  const auto s = static_cast<cudaStream_t>(stream);
  if (p == kSlice && q == kSlice && is_chain(sp, 16, 8) && is_chain(sq, 16, 8)) {
    // the rows of the identity DFT_1: t1 and cfac are never read at R = 1;
    // tn is the (q, p) table
    if (outer_t) return cudaErrorInvalidValue;
    return launch_radix<1>(tx, ty, batch, clusters, sp, to, to, to, to, nullptr, s);
  }
  return one_block_fft<false>(tx, ty, batch, p, q, sp, sq, to, outer_t, nullptr, s);
}

#ifdef RF_PHASE_STAMPS
// rf_two_stage_fft through the one-block kernel's stamped form (not at
// 16384, whose stamps are rf_radix_phase_stamps'): stamps (batch,
// kBlockStamps) uint64 %globaltimer nanoseconds.  Only the library built
// with RF_PHASE_STAMPS has it (ops/kernels/_build.py load(phase_stamps=True);
// tools/torch_phase_times.py).
extern "C" int rf_two_stage_phase_stamps(
    const void* x, void* y, long long batch, int p, int q, int kp, int rp0, int rp1, int rp2,
    const void* rootsp0, const void* rootsp1, const void* rootsp2, const void* twp0,
    const void* twp1, int mp0, int mp1, int mp2, int kq, int rq0, int rq1, int rq2,
    const void* rootsq0, const void* rootsq1, const void* rootsq2, const void* twq0,
    const void* twq1, int mq0, int mq1, int mq2, const void* outer, int outer_t, void* stamps,
    void* stream) {
  using namespace rf;
  const Stages sp = with_bluestein(
      make_stages(kp, rp0, rp1, rp2, rootsp0, rootsp1, rootsp2, twp0, twp1), mp0, mp1, mp2);
  const Stages sq = with_bluestein(
      make_stages(kq, rq0, rq1, rq2, rootsq0, rootsq1, rootsq2, twq0, twq1), mq0, mq1, mq2);
  if (stamps == nullptr || !one_block_chains(sp, sq, batch, p, q, outer, outer_t) ||
      (p == kSlice && q == kSlice))
    return cudaErrorInvalidValue;
  return one_block_fft<true>(static_cast<const float2*>(x), static_cast<float2*>(y), batch, p, q,
                             sp, sq, static_cast<const float2*>(outer), outer_t,
                             static_cast<unsigned long long*>(stamps),
                             static_cast<cudaStream_t>(stream));
}
#endif

// x, y: (batch, p*q) complex64, both 16-byte aligned; sp / sq the chains
// of DFT_p and DFT_q (the chain_args of each, as rf_two_stage_fft's;
// Bluestein lengths up to 1024); outer: w_n^(k1*j2) as (q, p), or as its
// transpose (p, q) where outer_t.  One thread-block cluster of c blocks
// (2, 4, 8 or 16) per transform, block b holding the columns b*q/c .. of
// DFT_p and then the rows b*p/c .. of DFT_q; c must divide q into an even
// width and each share fit kClusterShare values.  Returns a cudaError_t
// code; launches on `stream`.
extern "C" int rf_two_stage_cluster_fft(const void* x, void* y, long long batch, int p, int q,
                                        int c, int kp, int rp0, int rp1, int rp2,
                                        const void* rootsp0, const void* rootsp1,
                                        const void* rootsp2, const void* twp0, const void* twp1,
                                        int mp0, int mp1, int mp2, int kq, int rq0, int rq1,
                                        int rq2, const void* rootsq0, const void* rootsq1,
                                        const void* rootsq2, const void* twq0, const void* twq1,
                                        int mq0, int mq1, int mq2, const void* outer, int outer_t,
                                        void* stream) {
  using namespace rf;
  return cluster_fft<false>(
      x, y, batch, p, q, c,
      with_bluestein(make_stages(kp, rp0, rp1, rp2, rootsp0, rootsp1, rootsp2, twp0, twp1), mp0,
                     mp1, mp2),
      with_bluestein(make_stages(kq, rq0, rq1, rq2, rootsq0, rootsq1, rootsq2, twq0, twq1), mq0,
                     mq1, mq2),
      outer, outer_t, nullptr, stream);
}

#ifdef RF_PHASE_STAMPS
// rf_two_stage_cluster_fft through the kernel's stamped form: stamps
// (batch*c, kClusterStamps) uint64 %globaltimer nanoseconds.  Only the
// library built with RF_PHASE_STAMPS has it (ops/kernels/_build.py
// load(phase_stamps=True); tools/torch_phase_times.py).
extern "C" int rf_two_stage_cluster_phase_stamps(
    const void* x, void* y, long long batch, int p, int q, int c, int kp, int rp0, int rp1,
    int rp2, const void* rootsp0, const void* rootsp1, const void* rootsp2, const void* twp0,
    const void* twp1, int mp0, int mp1, int mp2, int kq, int rq0, int rq1, int rq2,
    const void* rootsq0, const void* rootsq1, const void* rootsq2, const void* twq0,
    const void* twq1, int mq0, int mq1, int mq2, const void* outer, int outer_t, void* stamps,
    void* stream) {
  using namespace rf;
  if (stamps == nullptr) return cudaErrorInvalidValue;
  return cluster_fft<true>(
      x, y, batch, p, q, c,
      with_bluestein(make_stages(kp, rp0, rp1, rp2, rootsp0, rootsp1, rootsp2, twp0, twp1), mp0,
                     mp1, mp2),
      with_bluestein(make_stages(kq, rq0, rq1, rq2, rootsq0, rootsq1, rootsq2, twq0, twq1), mq0,
                     mq1, mq2),
      outer, outer_t, static_cast<unsigned long long*>(stamps), stream);
}
#endif

// cudaOccupancyMaxActiveClusters of rf_two_stage_cluster_fft's kernel (its
// form with the Bluestein stage) in clusters of c blocks at the most shared
// memory it takes (a share of kClusterShare values, the index tables of p
// <= 512 and q <= 2048 (K8's p + 2q = 4224 ints at 262144, K7's 1536 at
// 512 x 512) and the roots of two 512-point chains of direct stages, an
// upper bound) into *out.
extern "C" int rf_two_stage_cluster_max_active_clusters(int c, int* out) {
  using namespace rf;
  if (!cluster_size_ok(c)) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const size_t smem =
      ((size_t)kClusterShare + 2 * 512) * sizeof(float2) + (512 + 2 * 2048) * sizeof(int);
  cudaError_t err = cluster_config<kClusterMaxM, false>(cfg, attr, 1, c, smem, 0);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(out, two_stage_cluster_kernel<kClusterMaxM, false>, &cfg);
}

// The registers a thread and the local memory (spills) of K7's kernels
// into *regs and *local_bytes (cudaFuncGetAttributes; chip_smoke.py prints
// them): form 0 and 1 the cluster kernel without and with the Bluestein
// stage, 2 and 3 the one-block kernel without and with it.
extern "C" int rf_two_stage_attrs(int form, int* regs, int* local_bytes) {
  using namespace rf;
  cudaFuncAttributes a;
  cudaError_t err;
  switch (form) {
    case 0: err = cudaFuncGetAttributes(&a, two_stage_cluster_kernel<0, false>); break;
    case 1: err = cudaFuncGetAttributes(&a, two_stage_cluster_kernel<kClusterMaxM, false>); break;
    case 2: err = cudaFuncGetAttributes(&a, two_stage_kernel<0, false>); break;
    case 3: err = cudaFuncGetAttributes(&a, two_stage_kernel<kBlockMaxM, false>); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return cudaSuccess;
}
