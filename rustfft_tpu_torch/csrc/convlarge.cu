// The fused large Bluestein convolution: the port of K15.
//
// Replaces rustfft_tpu/ops/pallas/convlarge.py:_kernel_bconv (B_conv) and
// _kernel_a2 (A2) and its kernel A (large._kernel_a after an XLA
// prologue), which loads the zero-padded, chirped input itself.  For a
// Bluestein of length n on an inner m = P * Q, in three launches:
//
//   A       a[j2, k1] = w_m^(k1*j2) DFT_P(chirp . x)[k1];
//   B_conv  per column k1, FFT_Q over j2 -> k2 (the first FFT's
//           natural-order X[k2*P + k1]), z = conj(X . H[k2, k1]), FFT_Q over
//           k2 -> l1 in the same direction, times w_m^(l1*k1) (the mirrored
//           factorisation of the second FFT, convlarge.py:13-32);
//   A2      per tile of rows l1, DFT_P over k1 -> l2, out[l2*Q + l1] =
//           chirp[l] . conj(.) for l < n, straight into the (B, n) output.
//
// So the JAX package's `pkeep` row slice of DFT_P becomes the store mask
// l < n and its epilogue slice pass disappears.  Traversals: A reads n and
// writes m, B_conv reads and writes m, A2 reads m and writes n; the two-pass
// core makes four launches and eight traversals of m.  What bounds them on
// this card is memory (each kernel's bytes, tables included); B_conv also
// runs two length-Q chains per column in FP32 on the CUDA cores.
//
// Two forms:
//  - the tile form (P = 16 x 16, Q = 8192: the 1000003 path; below),
//    three persistent tile walks on the column layout (B, P, Q): kernel A
//    (K2's column-tile kernel, csrc/col_tile.cuh, with the chirp source
//    ColChirp), B_conv (bconv_tile_kernel, one column a unit) and A2
//    (bconv_out_tile_kernel).  In (B, Q, P) a B_conv tile of two columns
//    read 16 bytes from each of Q rows 2 KiB apart: a
//    compile-time body took 5.37 ms at 64 x 2^21, and a copy in that
//    pattern alone 2.22 ms against 0.73 for a streaming copy of the same
//    bytes (tools/torch_ab.py --only K15; H100 80GB HBM3, 700 W);
//  - the general form (every other split: 24571 at Q = 192, the Bluestein
//    746497 at Q = 6144): kernel A is the two-pass core's column stage
//    (csrc/conv_radix.cu), bconv_row_kernel holds a (Q, pt) tile in two
//    buffers for both chains, bconv_out_kernel stores 16 consecutive l1 per
//    l2 (128-byte segments).
#include "col_tile.cuh"

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

// ---- the tile form: P = 16 x 16, Q = 8192 (the 1000003 path) ---------------
//
// Between the three kernels the signal is held in columns, (B, P, Q):
// element (j2, k1) of a batch row at k1*Q + j2, so that B_conv's tile, one
// column of Q values, is 64 KiB of consecutive values, and so are the
// slices of its tables h and outer (held the same way, (P, Q)).

// Kernel A's input and output on csrc/col_tile.cuh's kernel: x (B, n) rows
// ld apart (8-byte aligned: 1000003's odd rows are), element j = j1*Q + j2
// of the zero-padded input, times pre[j] (zero from n) in stage 0; the
// output in columns.
struct ColChirp {
  const float2* __restrict__ x;
  const float2* __restrict__ pre;
  size_t ld;
  unsigned n;
  // Warp w copies the rows j*16 + 2w and j*16 + 2w + 1 (j < 16), 16 bytes a
  // copy where the pair lies below n and the row is 16-byte aligned, else
  // 8 bytes an element below n; zeros from n are stored, not copied.
  __device__ void copy(float2* buf, unsigned b, unsigned t, unsigned q) const {
    const int c = opaque_int(threadIdx.x);
    const int warp = c >> 5, lane = c & 31;
    const float2* __restrict__ src = x + (size_t)b * ld;
    const bool wide = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int idx = i * 32 + lane;
      const int row = (idx >> 4) * 16 + 2 * warp + ((idx >> 3) & 1);
      const int piece = (idx & 7) * 2;
      const unsigned j = (unsigned)row * q + t * kColT + piece;
      float2* dst = buf + row * kColT + piece;
      if (wide && j + 1 < n) {
        cp_async16(dst, src + j);
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (j + e < n) cp_async8(dst + e, src + j + e);
          else dst[e] = make_float2(0.f, 0.f);
        }
      }
    }
    cp_async_commit();
  }
  __device__ void scale(float2 (&v)[16], int c, unsigned t, unsigned q) const {
    const float2* __restrict__ p = opaque_ptr(pre) + t * kColT + (c & 15) + (c >> 4) * q;
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = cmul(v[j], __ldg(&p[j * 16 * q]));
  }
  // y[b] in columns (P, Q): the 16 j2 of a k1 are 128 consecutive bytes,
  // two j2 a thread
  __device__ void store(const float2* buf, float2* __restrict__ yb, unsigned t, unsigned q,
                        int c) const {
    yb += (size_t)t * kColT;
    for (int i = c; i < kColElems / 2; i += kColThreads) {
      const int j2 = (i & 7) * 2, k1 = i >> 3;
      const float2 a0 = buf[swz(k1 * kColT + j2)], a1 = buf[swz(k1 * kColT + j2 + 1)];
      *reinterpret_cast<float4*>(yb + (size_t)k1 * q + j2) = make_float4(a0.x, a0.y, a1.x, a1.y);
    }
  }
  bool aligned() const { return reinterpret_cast<uintptr_t>(x) % 8 == 0; }
};

// B_conv's tile: one column of Q = 8192 values, 64 KiB, two 256-thread
// blocks an SM at up to 128 registers (with two columns, 128 KiB, one
// 512-thread block an SM ran 2.67 ms at 64 x 2^21 on an H100 80GB HBM3 at
// 700 W: its barriers and table reads stalled all the SM's warps at once;
// one column ran 2.04-2.13 ms there, at three blocks an SM with 68 bytes
// of spill at 80 registers as at two without).  Both FFT_Q run in
// place with every column of a stage writing its outputs where it read its
// inputs, so a stage needs no barrier between its reads and its writes and
// a thread computes its columns one after another (16 values and their
// twiddles in registers).  Chains whose stages write elsewhere (the
// fixed_stage order) must read every column of a stage before any write:
// with a radix-32 stage, or two radix-16 columns and their twiddles and
// tables, a thread held too much, and ptxas spilled 1.5-2.5 KB at 128
// registers.
//  - Chain 1 is the DIT chain (2, 16, 16, 16) over the natural input j =
//    4096*j0 + 256*j1 + 16*j2 + j3, stage s on the position digit of
//    weight 4096, 256, 16, 1 in turn, so it leaves X[k], k = k0 + 2*k1 +
//    32*k2 + 512*k3, at the digit-reversed position 4096*k0 + 256*k1 +
//    16*k2 + k3; its last stage multiplies by h, which the host stores in
//    that order (ops/kernels/convlarge.py bconv_h_table).
//  - Chain 2 is the DIT chain (16, 16, 16, 2) over k, whose most
//    significant digit k3 sits at weight 1: it takes the position digits of
//    weight 1, 16, 256, 4096 in turn and leaves its output l = l0 + 16*l1
//    + 256*l2 + 4096*l3 at position l, natural order.
constexpr int kBcT = 1;
constexpr int kBcQ = 8192;
constexpr int kBcElems = kBcQ * kBcT;
constexpr int kBcThreads = 256;

// The tables in device memory: the roots of w_2 and w_16, and the twiddles
// of the two chains, chain 1's (r_s, rest_s) of (2, 16, 16, 16) and chain
// 2's of (16, 16, 16, 2) with their columns in the order of the digits
// above the stage (ops/kernels/convlarge.py bconv_chain_tables).
struct BcChain {
  const float2* roots2;
  const float2* roots16;
  const float2* tw1[3];
  const float2* tw2[3];
};

// One in-place stage: radix R over the position digit of weight W of the
// tile, column (lo, hi) = the values at positions hi*R*W + j*W + lo, j < R;
// this thread's columns c = tid + 256*i, c = hi*W + lo (kBcT = 1: t = 0),
// one after another.  Output k goes where input k was read,
// times tw[k*REST + lo] (chain 1) or tw[k*REST + hi] (kByHi: chain 2, whose
// twiddle columns the host lays out by hi) where tw is not null, through
// dst.store(element, v).  The tile reads are swizzled (swz) unless kLanded
// (the tile as cp.async wrote it; the swizzled writes then move values
// within 16-element groups, which the threads of one warp read).
template <int R, int W, int REST, bool kByHi, bool kLanded, class Dst>
static __device__ __forceinline__ void bc_stage(int tid, const float2* buf, const Dst& dst,
                                                const float2* __restrict__ roots,
                                                const float2* __restrict__ tw) {
  constexpr int kCols = kBcElems / R;
#pragma unroll 1
  for (int c = tid; c < kCols; c += kBcThreads) {
    const int t = c % kBcT, lo = (c / kBcT) % W, hi = (c / kBcT) / W;
    const int e0 = (hi * R * W + lo) * kBcT + t;
    float2 x[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int e = e0 + j * W * kBcT;
      x[j] = kLanded ? buf[e] : buf[swz(e)];
    }
    if constexpr (kLanded) __syncwarp();
    const int col = kByHi ? hi : lo;
    dft_column<R>(x, roots, [&](int k, float2 y) {
      if (tw != nullptr && k > 0) y = cmul(y, __ldg(&tw[k * REST + col]));
      dst.store(e0 + k * W * kBcT, y);
    });
  }
}

// The tile, swizzled.
struct BcTile {
  float2* buf;
  __device__ void store(int e, float2 v) const { buf[swz(e)] = v; }
};

// Chain 1's last stage: z = conj(X . h) into the tile, h the tile's slice
// in position order.
struct BcTimesH {
  float2* buf;
  const float2* __restrict__ h;
  __device__ void store(int e, float2 v) const {
    v = cmul(v, __ldg(&h[e]));
    buf[swz(e)] = make_float2(v.x, -v.y);
  }
};

// Unit u of B_conv's walk: the column u / batch of the batch row u % batch
// (ops/kernels/convlarge.py bconv_unit), as an offset into (B, P, Q) and
// into the tables (P, Q).
static __device__ __forceinline__ size_t bc_offset(unsigned u, unsigned batch, unsigned tiles,
                                                   size_t* table) {
  const unsigned t = u / batch;
  *table = (size_t)t * kBcElems;
  return ((size_t)(u - t * batch) * tiles + t) * kBcElems;
}

// This thread's copies of a tile (64 KiB at src) in plain order, one group.
static __device__ __forceinline__ void bc_copy(float2* buf, const float2* __restrict__ src) {
  const int c = opaque_int(threadIdx.x);
#pragma unroll
  for (int i = 0; i < kBcElems / 2 / kBcThreads; ++i) {
    const int piece = (c + kBcThreads * i) * 2;
    cp_async16(buf + piece, src + piece);
  }
  cp_async_commit();
}

// B_conv at Q = 8192 on columns: a persistent grid, block g walking the
// units g, g + grid, ... (batch rows fastest, so that the blocks at work at
// one time share one or two columns' slices of h and outer in L2).  The
// tile lands by cp.async in plain order; chain 1 runs in place from it, its
// last stage multiplying by h and conjugating from registers; chain 2 runs
// in place, its last stage storing times the outer twiddle; then the next
// unit's copies start, and the SM's other block computes while they land.
template <bool kStamp>
__global__ void __launch_bounds__(kBcThreads, 2)
    bconv_tile_kernel(const float2* __restrict__ x, float2* __restrict__ y, unsigned batch,
                      unsigned units, unsigned tiles, BcChain ch, const float2* __restrict__ h,
                      const float2* __restrict__ outer, unsigned long long* stamps) {
  PhaseClock<kStamp, 3> clock;
  clock.begin();
  extern __shared__ float4 bc_smem[];
  float2* buf = reinterpret_cast<float2*>(bc_smem);
  float2* r2 = buf + kBcElems;  // w_2^e, then w_16^e
  float2* r16 = r2 + 2;
  unsigned u = blockIdx.x;
  size_t table;
  if (u < units) bc_copy(buf, x + bc_offset(u, batch, tiles, &table));
  if (threadIdx.x < 2) r2[threadIdx.x] = ch.roots2[threadIdx.x];
  if (threadIdx.x < 16) r16[threadIdx.x] = ch.roots16[threadIdx.x];
  for (; u < units; u += gridDim.x) {
    const size_t at = bc_offset(u, batch, tiles, &table);
    const BcTile tile{buf};
    cp_async_wait<0>();
    __syncthreads();
    // chain 1: FFT_Q over j2 -> k2 (digit-reversed), then conj(. * h)
    bc_stage<2, 4096, 4096, false, true>(opaque_int(threadIdx.x), buf, tile, r2,
                                      opaque_ptr(ch.tw1[0]));
    __syncthreads();
    bc_stage<16, 256, 256, false, false>(opaque_int(threadIdx.x), buf, tile, r16,
                                      opaque_ptr(ch.tw1[1]));
    __syncthreads();
    bc_stage<16, 16, 16, false, false>(opaque_int(threadIdx.x), buf, tile, r16,
                                    opaque_ptr(ch.tw1[2]));
    __syncthreads();
    bc_stage<16, 1, 1, false, false>(opaque_int(threadIdx.x), buf,
                                  BcTimesH{buf, opaque_ptr(h) + table}, r16, nullptr);
    clock.lap(0);
    __syncthreads();
    // chain 2, in the same direction: FFT_Q over k2 -> l1 (natural order)
    bc_stage<16, 1, 512, true, false>(opaque_int(threadIdx.x), buf, tile, r16,
                                   opaque_ptr(ch.tw2[0]));
    __syncthreads();
    bc_stage<16, 16, 32, true, false>(opaque_int(threadIdx.x), buf, tile, r16,
                                   opaque_ptr(ch.tw2[1]));
    __syncthreads();
    bc_stage<16, 256, 2, true, false>(opaque_int(threadIdx.x), buf, tile, r16,
                                   opaque_ptr(ch.tw2[2]));
    clock.lap(1);
    __syncthreads();
    // the last stage, radix 2 over the digit of weight 4096, stored times
    // outer four columns at a time; then the next unit's copies (the SM's
    // other block computes while they land)
    {
      const int c0 = opaque_int(threadIdx.x);
      float2* __restrict__ yt = y + at;
      const float2* __restrict__ ot = opaque_ptr(outer) + table;
#pragma unroll 1
      for (int i0 = 0; i0 < kBcElems / 2; i0 += 4 * kBcThreads) {
        float2 v[4][2], w[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = c0 + i0 + kBcThreads * i;  // a column's first value; its other at + Q/2
          v[i][0] = buf[swz(e)];
          v[i][1] = buf[swz(e + kBcElems / 2)];
          w[i][0] = __ldg(&ot[e]);
          w[i][1] = __ldg(&ot[e + kBcElems / 2]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = c0 + i0 + kBcThreads * i;
          const float2 a = v[i][0], b = v[i][1];
          yt[e] = cmul(make_float2(a.x + b.x, a.y + b.y), w[i][0]);
          yt[e + kBcElems / 2] = cmul(make_float2(a.x - b.x, a.y - b.y), w[i][1]);
        }
      }
      __syncthreads();
      const unsigned next = u + gridDim.x;
      if (next < units) {
        size_t unused;
        bc_copy(buf, x + bc_offset(next, batch, tiles, &unused));
      }
    }
    clock.lap(2);
  }
  clock.write(stamps);
}

static size_t bc_tile_smem() { return (size_t)(kBcElems + 2 + 16) * sizeof(float2); }

// A2 at P = 16 x 16 on columns: a (256, 16) tile of rows l1 = q0 ..
// q0 + 15, 32 KiB, 256 threads, three blocks an SM.  A persistent grid,
// block g walking the contiguous units [g*per, min((g + 1)*per, units)) of
// (tile, batch), batch fastest (ops/kernels/large.py col_walk), so that a
// block keeps one slice of the output chirp hot; the next unit's tile lands
// by cp.async in a second buffer while the current one computes and stores.
constexpr int kOutT = 16;
constexpr int kOutP = 256;
constexpr int kOutElems = kOutP * kOutT;
constexpr int kOutThreads = 256;

// This thread's copies of a unit's tile at src (its q0 in column 0 of the
// batch row), one group: the 16 l1 of a k1 are 128 consecutive bytes of
// x; they land in plain order, element (r, k1) at k1*16 + r, warp w
// copying the k1 = 16*j0 + 2w + e (j0 < 16, e < 2) its stage-0 columns
// read.
static __device__ __forceinline__ void out_copy(float2* buf, const float2* __restrict__ src,
                                                unsigned q) {
  const int c = opaque_int(threadIdx.x);
  const int warp = c >> 5, lane = c & 31;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int idx = i * 32 + lane;
    const int k1 = 16 * (idx >> 4) + 2 * warp + ((idx >> 3) & 1);
    const int piece = (idx & 7) * 2;
    cp_async16(buf + k1 * kOutT + piece, src + (size_t)k1 * q + piece);
  }
  cp_async_commit();
}

template <bool kStamp>
__global__ void __launch_bounds__(kOutThreads, 3)
    bconv_out_tile_kernel(const float2* __restrict__ x, float2* __restrict__ y, unsigned batch,
                          unsigned units, unsigned per, int q, int n, size_t ld, Stages st,
                          const float2* __restrict__ chirp, unsigned long long* stamps) {
  PhaseClock<kStamp, 3> clock;
  clock.begin();
  extern __shared__ float4 out_smem[];
  float2* bufs = reinterpret_cast<float2*>(out_smem);  // two tiles
  float2* stw = bufs + 2 * kOutElems;                  // DFT_P's twiddle (16, 16)
  float2* sroots = stw + 256;
  const size_t row_elems = (size_t)kOutP * (size_t)q;
  const unsigned u0 = blockIdx.x * per;
  const unsigned u1 = min(u0 + per, units);
  if (u0 < u1) out_copy(bufs, x + (size_t)(u0 % batch) * row_elems + (u0 / batch) * kOutT, q);
  load_roots(st, sroots);
  for (int i = threadIdx.x; i < 256; i += kOutThreads) stw[i] = st.tw[0][i];
  __syncthreads();
  int cur = 0;
  for (unsigned u = u0; u < u1; ++u, cur ^= 1) {
    const int c = opaque_int(threadIdx.x);
    const unsigned t = u / batch;
    float2* buf = bufs + cur * kOutElems;
    if (u + 1 < u1) {
      const unsigned v = u + 1;
      out_copy(bufs + (cur ^ 1) * kOutElems,
               x + (size_t)(v % batch) * row_elems + (v / batch) * kOutT, q);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    // stage 0: radix 16 over the top digit j0 of k1 = 16*j0 + j' for the
    // row r and the column j' = 2*(c >> 5) + ((c >> 4) & 1) (warp w: j' =
    // 2w, 2w + 1 of every row), in place, swizzled within the 16 rows of a
    // k1, which one half-warp reads
    const int r = c & 15, jp = 2 * (c >> 5) + ((c >> 4) & 1);
    {
      float2 v[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) v[j] = buf[(16 * j + jp) * kOutT + r];
      __syncwarp();
      dft_column<16>(v, sroots, [&](int k, float2 z) {
        buf[swz((16 * k + jp) * kOutT + r)] = cmul(z, stw[k * 16 + jp]);
      });
    }
    clock.lap(0);
    __syncthreads();
    // stage 1: radix 16 over j' for the row r and k0 = jp, to the tile
    // [l2, r] with l2 = k0 + 16*k1
    {
      const int k0 = jp;
      float2 v[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) v[j] = buf[swz((16 * k0 + j) * kOutT + r)];
      __syncthreads();
      dft_column<16>(v, sroots + 16, [&](int k, float2 z) { buf[swz((k0 + 16 * k) * 16 + r)] = z; });
    }
    clock.lap(1);
    __syncthreads();
    // the store: out[b, l2*Q + q0 + r] = chirp[l] . conj(.) for l < n, 16
    // consecutive l a row l2
    float2* __restrict__ yb = y + (size_t)(u % batch) * ld;
    const float2* __restrict__ ch = opaque_ptr(chirp);
#pragma unroll
    for (int f = c; f < kOutElems; f += kOutThreads) {
      const unsigned l = (unsigned)(f >> 4) * (unsigned)q + t * kOutT + (f & 15);
      if (l < (unsigned)n) {
        const float2 d = buf[swz(f)];
        const float2 w = __ldg(&ch[l]);
        yb[l] = make_float2(d.x * w.x + d.y * w.y, d.x * w.y - d.y * w.x);
      }
    }
    clock.lap(2);
    __syncthreads();  // this buffer is free
  }
  clock.write(stamps);
}

static size_t out_tile_smem() { return (size_t)(2 * kOutElems + 256 + 32) * sizeof(float2); }

static bool out_tile_chain(const Stages& st, int q) {
  return st.k == 2 && st.r[0] == 16 && st.r[1] == 16 && q % kOutT == 0;
}

// ---- checks and launches -----------------------------------------------------

// rf_bconv_col_tile's checks and launch; the stamped form where kStamp.
template <bool kStamp>
static int bconv_col_tile(const void* x, void* y, long long batch, int n, long long ld, int p,
                          int q, const Stages& st, const void* tw_outer, const void* pre,
                          long long grid, long long per, unsigned long long* stamps,
                          void* stream) {
  if (batch <= 0 || n <= 0 || ld < n || (long long)p * q < n || p != kColP || tw_outer == nullptr ||
      pre == nullptr || !stages_ok(st, p) || !col_tile_chain(st.k, st.r[0], st.r[1], kColT))
    return cudaErrorInvalidValue;
  const ColChirp io{static_cast<const float2*>(x), static_cast<const float2*>(pre), (size_t)ld,
                    (unsigned)n};
  return launch_col_tile<kStamp>(io, static_cast<float2*>(y), batch, q, grid, per, st,
                                 static_cast<const float2*>(tw_outer), stamps,
                                 static_cast<cudaStream_t>(stream));
}

// rf_bconv_row_tile's checks and launch; the stamped form where kStamp.
template <bool kStamp>
static int bconv_row_tile(const void* x, void* y, long long batch, int p, const BcChain& ch,
                          const void* h, const void* outer, long long grid,
                          unsigned long long* stamps, void* stream) {
  const long long units = batch * (p / kBcT);
  bool tables = h != nullptr && outer != nullptr && ch.roots2 != nullptr && ch.roots16 != nullptr;
  for (int s = 0; s < 3; ++s) tables = tables && ch.tw1[s] != nullptr && ch.tw2[s] != nullptr;
  if (batch <= 0 || p <= 0 || p % kBcT != 0 || !tables || grid < 1 || grid > units ||
      units > 0x7fffffffLL || reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(bconv_tile_kernel<kStamp>, bc_tile_smem());
  if (err != cudaSuccess) return err;
  bconv_tile_kernel<kStamp><<<(unsigned)grid, kBcThreads, bc_tile_smem(),
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(y), (unsigned)batch, (unsigned)units,
      (unsigned)(p / kBcT), ch, static_cast<const float2*>(h), static_cast<const float2*>(outer),
      stamps);
  return cudaGetLastError();
}

static BcChain bc_chain(const void* roots2, const void* roots16, const void* const* tw) {
  const auto* t = reinterpret_cast<const float2* const*>(tw);
  return BcChain{static_cast<const float2*>(roots2), static_cast<const float2*>(roots16),
                 {t[0], t[1], t[2]}, {t[3], t[4], t[5]}};
}

// rf_bconv_out_tile's checks and launch; the stamped form where kStamp.
template <bool kStamp>
static int bconv_out_tile(const void* x, void* y, long long batch, int q, int n, long long ld,
                          const Stages& st, const void* chirp, long long grid, long long per,
                          unsigned long long* stamps, void* stream) {
  const long long units = batch * (q / kOutT);
  if (batch <= 0 || n <= 0 || ld < n || (long long)kOutP * q < n || chirp == nullptr ||
      !stages_ok(st, kOutP) || !out_tile_chain(st, q) || grid < 1 || per < 1 ||
      units > 0x7fffffffLL || grid * per < units || (grid - 1) * per >= units ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(bconv_out_tile_kernel<kStamp>, out_tile_smem());
  if (err != cudaSuccess) return err;
  bconv_out_tile_kernel<kStamp><<<(unsigned)grid, kOutThreads, out_tile_smem(),
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(y), (unsigned)batch, (unsigned)units,
      (unsigned)per, q, n, (size_t)ld, st, static_cast<const float2*>(chirp), stamps);
  return cudaGetLastError();
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
  const size_t smem = tile_smem_bytes(q * pt, st);
  cudaError_t err = allow_smem(bconv_row_kernel, smem);
  if (err != cudaSuccess) return err;
  bconv_row_kernel<<<(unsigned)blocks, 512, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(y), q, p, pt, st,
      static_cast<const float2*>(h), static_cast<const float2*>(outer));
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

// The tile form.  Kernel A: x (batch, n) complex64, rows ld apart, 8-byte
// aligned; y (batch, P, Q); the DFT_P chain (16, 16); tw_outer (Q, P);
// pre (P*Q,) zero from n; `grid` blocks of `per` units (large.col_walk).
extern "C" int rf_bconv_col_tile(const void* x, void* y, long long batch, int n, long long ld,
                                 int p, int q, int k, int r0, int r1, const void* roots0,
                                 const void* roots1, const void* tw0, const void* tw_outer,
                                 const void* pre, long long grid, long long per, void* stream) {
  using namespace rf;
  return bconv_col_tile<false>(x, y, batch, n, ld, p, q,
                               make_stages(k, r0, r1, 1, roots0, roots1, nullptr, tw0, nullptr),
                               tw_outer, pre, grid, per, nullptr, stream);
}

// B_conv: x, y (batch, P, 8192) complex64, x 16-byte aligned; roots2,
// roots16 the roots of w_2 and w_16; tw the six twiddle tables, chain 1's
// three of (2, 16, 16, 16) and chain 2's of (16, 16, 16, 2); h (P, 8192)
// in chain 1's output positions (convlarge.bconv_h_table), outer (P,
// 8192); `grid` persistent blocks (convlarge.bconv_grid).
extern "C" int rf_bconv_row_tile(const void* x, void* y, long long batch, int p,
                                 const void* roots2, const void* roots16, const void* tw,
                                 const void* h, const void* outer, long long grid,
                                 void* stream) {
  using namespace rf;
  if (tw == nullptr) return cudaErrorInvalidValue;
  return bconv_row_tile<false>(x, y, batch, p,
                               bc_chain(roots2, roots16, static_cast<const void* const*>(tw)), h,
                               outer, grid, nullptr, stream);
}

// A2: x (batch, 256, Q) complex64, 16-byte aligned; y (batch, n) rows ld
// apart; the DFT_P chain (16, 16); chirp (n,); `grid` blocks of `per` units
// (large.col_walk).
extern "C" int rf_bconv_out_tile(const void* x, void* y, long long batch, int q, int n,
                                 long long ld, int k, int r0, int r1, const void* roots0,
                                 const void* roots1, const void* tw0, const void* chirp,
                                 long long grid, long long per, void* stream) {
  using namespace rf;
  return bconv_out_tile<false>(x, y, batch, q, n, ld,
                               make_stages(k, r0, r1, 1, roots0, roots1, nullptr, tw0, nullptr),
                               chirp, grid, per, nullptr, stream);
}

// The blocks of kernel A's (which = 0), B_conv's (1) or A2's (2) tile
// kernel the card holds at once, into *out.
extern "C" int rf_bconv_resident_blocks(int which, int* out) {
  using namespace rf;
  if (which == 0)
    return resident_blocks(col_tile_kernel<ColChirp, false>, kColThreads, col_tile_smem(), out);
  if (which == 1)
    return resident_blocks(bconv_tile_kernel<false>, kBcThreads, bc_tile_smem(), out);
  if (which == 2)
    return resident_blocks(bconv_out_tile_kernel<false>, kOutThreads, out_tile_smem(), out);
  return cudaErrorInvalidValue;
}

#ifdef RF_PHASE_STAMPS
// The tile form's kernels through their stamped forms: stamps (grid, 4)
// uint64 %globaltimer nanoseconds, a block's start and that start plus the
// running sums of its phases over its units.  Only the library built with
// RF_PHASE_STAMPS has them (ops/kernels/_build.py load(phase_stamps=True);
// tools/torch_phase_times.py).
extern "C" int rf_bconv_col_tile_stamps(const void* x, void* y, long long batch, int n,
                                        long long ld, int p, int q, int k, int r0, int r1,
                                        const void* roots0, const void* roots1, const void* tw0,
                                        const void* tw_outer, const void* pre, long long grid,
                                        long long per, void* stamps, void* stream) {
  using namespace rf;
  if (stamps == nullptr) return cudaErrorInvalidValue;
  return bconv_col_tile<true>(x, y, batch, n, ld, p, q,
                              make_stages(k, r0, r1, 1, roots0, roots1, nullptr, tw0, nullptr),
                              tw_outer, pre, grid, per, static_cast<unsigned long long*>(stamps),
                              stream);
}

extern "C" int rf_bconv_row_tile_stamps(const void* x, void* y, long long batch, int p,
                                        const void* roots2, const void* roots16, const void* tw,
                                        const void* h, const void* outer, long long grid,
                                        void* stamps, void* stream) {
  using namespace rf;
  if (stamps == nullptr || tw == nullptr) return cudaErrorInvalidValue;
  return bconv_row_tile<true>(x, y, batch, p,
                              bc_chain(roots2, roots16, static_cast<const void* const*>(tw)), h,
                              outer, grid, static_cast<unsigned long long*>(stamps), stream);
}

extern "C" int rf_bconv_out_tile_stamps(const void* x, void* y, long long batch, int q, int n,
                                        long long ld, int k, int r0, int r1, const void* roots0,
                                        const void* roots1, const void* tw0, const void* chirp,
                                        long long grid, long long per, void* stamps,
                                        void* stream) {
  using namespace rf;
  if (stamps == nullptr) return cudaErrorInvalidValue;
  return bconv_out_tile<true>(x, y, batch, q, n, ld,
                              make_stages(k, r0, r1, 1, roots0, roots1, nullptr, tw0, nullptr),
                              chirp, grid, per, static_cast<unsigned long long*>(stamps), stream);
}
#endif
