// The two-pass large-n pipeline on ragged tiles: the port of K12, its
// column kernel in csrc/largepad.cu and its row kernel in
// csrc/largepad_row.cu (two sources, so that nvcc compiles them in
// parallel), their shared pieces here.
//
// Replaces rustfft_tpu/ops/pallas/largepad.py:_kernel_a_pad (column stage)
// and _kernel_b_pad (row stage).  n = P * Q, the input viewed as
// (B, P, Q) [j1, j2]:
//
//   column stage: a[b, j2, k1] = w_n^(k1*j2) * sum_j1 x[b, j1, j2] * w_P^(j1*k1),
//                 written as (B, Q, P);
//   row stage:    a length-Q FFT over j2 for every k1, X[b, k2*P + k1].
//
// The TPU kernels pad Q and P to multiples of 128 lanes in device memory
// and slice after; here the tiles need not divide Q or P: the last tile on
// each axis is as wide as the columns left, so nothing is loaded past the
// edge and nothing is stored there, and the intermediate stays (B, Q, P).
//
// The stages run K7's in-place chain (csrc/inplace_chain.cuh) on ONE
// shared buffer:
//   column kernel: a (P, qt) tile of qt consecutive columns j2 (128-byte
//     row segments at qt = 16), DFT_P over j1 in place with the outer
//     twiddle folded into its last stage, then the transposed (qt, P) tile
//     from the chain's places, rows of P contiguous in device memory;
//   row kernel: a (Q, pt) tile of pt consecutive columns k1, the length-Q
//     FFT over j2 in place, then X[k2*P + p0 + t] for its columns.
// A chain's radices are large.stage_radices' and each stage runs as K7's
// do: the register radices in registers, a Bluestein stage (one warp a
// column, M = 64 .. 1024; the column stage's prime P up to 509 takes M =
// 1024, the row stage's radices at most 256 take M <= 512) where it takes
// fewer operations than a direct sum, and a direct sum from a roots table
// for the rest (11-23 and a few composites).
//
// What bounds it: the bytes, 16 a point a stage (each reads and writes the
// signal once).  The general kernels of csrc/large.cuh that this replaces
// ran every radix without a register stage as a direct sum (8r operations
// a point: 2984 at P = 373, where the stage's bytes need 16 bytes' worth)
// and kept two buffers, which halved the tile: four columns (32-byte row
// segments) at Q = 2187 and one 512-thread block an SM.  One buffer gives
// twice the width in the same shared memory; each kernel has a form
// without a Bluestein stage (MaxM = 0), which the launchers take where the
// chain has none, so that register-radix chains keep their registers.
//
// Both kernels are templates on what they load and store (below): the
// column kernel on a source policy, the row kernel on a sink policy.  K12's
// own are plain rows (PadRowsIn, PadRowsOut); the two-pass convolution
// core's four stages (K14, csrc/conv_pad.cu and csrc/conv_pad_row.cu) run
// the same kernels with its gather, partial sums and epilogues.
#pragma once

#include "inplace_chain.cuh"

namespace rf {

// The Bluestein caps of the two kernels: the column stage's chain may be
// one prime P up to 509 (M = 1024); the row stage's radices stay at or
// below 256 (large.choose_pqq: q1, q2 <= 256), M <= 512.
constexpr int kPadColMaxM = 1024;
constexpr int kPadRowMaxM = 512;
// The column kernel has 256 threads a block (at P <= 512 two blocks or
// more of 16 columns fit an SM's shared memory).  Its form without a
// Bluestein stage is compiled for three blocks an SM, 80 registers a
// thread, and spills a little (the chain alone needs more than 80): at
// 128 registers and two blocks, without a spill, its register and
// direct-sum chains took 15-20% longer than large.cuh's two-buffer kernel,
// which keeps three (tools/torch_ab.py; tools/torch_largepad_caps.py
// times the caps).  Its Bluestein form takes two blocks, 128 registers.
// The row kernel has 256 threads where two blocks fit shared memory, else
// 512, at 128 registers a thread (__launch_bounds__(512)), where its form
// without a Bluestein stage does not spill.
constexpr int kPadColThreads = 256;
constexpr int kPadColPlainBlocks = 3;
constexpr int kPadMaxThreads = 512;
constexpr int kSmShared = 233472;      // shared memory of one SM (bytes)
constexpr int kBlockReserved = 1024;   // what the card reserves for each block
// Loads and stores a thread has in flight.
constexpr int kPadIo = 8;

// Phase stamps (the kStamp forms, only in the library built with
// RF_PHASE_STAMPS): %globaltimer at the kernel's start and after the load,
// the chain and the store, read by thread 0 of every block after a block
// barrier (tools/torch_phase_times.py).
constexpr int kPadStamps = 4;

template <bool kStamp>
static __device__ __forceinline__ void pad_stamp(unsigned long long* stamps, int i) {
  if constexpr (kStamp) {
    __syncthreads();
    if (threadIdx.x == 0) stamps[(size_t)blockIdx.x * kPadStamps + i] = global_timer();
  }
}

// The (row, column) of f = f0 + u*blockDim.x in rows of width w, for u =
// 0, 1, ..., advanced without a division.
struct TileWalk {
  int row, col;
  int w, drow, dcol;
  __device__ TileWalk(int f0, int w_)
      : row(f0 / w_), col(f0 % w_), w(w_), drow((int)blockDim.x / w_),
        dcol((int)blockDim.x % w_) {}
  __device__ void next() {
    row += drow;
    col += dcol;
    if (col >= w) {
      col -= w;
      ++row;
    }
  }
};

// Shared memory: the buffer (width columns of m), the direct stages' roots
// and the place of each natural output (m 16-bit indices).
static size_t pad_smem_bytes(int m, int width, const Stages& st) {
  return (size_t)(pad16(m * width) + chain_smem_len(st)) * sizeof(float2) +
         (((size_t)m * sizeof(unsigned short) + 15) & ~(size_t)15);
}

// The tile's rows: elems = rows * T values from src, row r at src + r*ld,
// into buf[swz(r*T + t)].
static __device__ __forceinline__ void load_tile(const float2* __restrict__ src, size_t ld,
                                                 int rows, int T, float2* buf) {
  const int elems = rows * T, nt = (int)blockDim.x;
  TileWalk w((int)threadIdx.x, T);
  for (int f0 = threadIdx.x; f0 < elems; f0 += kPadIo * nt) {
    float2 v[kPadIo];
#pragma unroll
    for (int u = 0; u < kPadIo; ++u, w.next())
      if (f0 + u * nt < elems) v[u] = src[(size_t)w.row * ld + w.col];
#pragma unroll
    for (int u = 0; u < kPadIo; ++u) {
      const int f = f0 + u * nt;
      if (f < elems) buf[swz(f)] = v[u];
    }
  }
}

// The place of every natural output of the length-m chain st.
static __device__ void load_places(int m, const Stages& st, unsigned short* place) {
  for (int k = threadIdx.x; k < m; k += blockDim.x) place[k] = (unsigned short)place_of(k, m, st);
}

// The checks both launchers share: the chain describes a length-m axis and
// the kernel of Bluestein cap max_m runs it, the tile fits shared memory
// and the grid fits.
static bool pad_ok(long long batch, int m, int other, int width, const Stages& st, int max_m) {
  if (batch <= 0 || other <= 0 || width <= 0) return false;
  if (!stages_ok(st, m) || !chain_ok(st, max_m) || m > 65535) return false;
  if (batch * ((other + width - 1) / width) > 0x7fffffffLL) return false;
  return pad_smem_bytes(m, width, st) <= kSmemMax;
}

// The chain of a length-m axis from a launcher's arguments (ops/kernels/
// fused.py chain_args: a Bluestein stage's table in its roots slot).
static Stages pad_chain(int k, int r0, int r1, int r2, const void* roots0, const void* roots1,
                        const void* roots2, const void* tw0, const void* tw1, int m0, int m1,
                        int m2) {
  Stages st = make_stages(k, r0, r1, r2, roots0, roots1, roots2, tw0, tw1);
  st.bm[0] = m0;
  st.bm[1] = m1;
  st.bm[2] = m2;
  return st;
}

// ---- the kernels, on a source and a sink policy --------------------------------
//
// The column kernel reads its tile through a source policy `Src`:
//   static constexpr int kBlocks;  // blocks an SM of the form without a
//                                  // Bluestein stage (its register cap)
//   float2 load(const float2* x, size_t b, int p, int q, int q0, int T,
//               float2* buf) const
//     // rows j1 < P, columns q0 .. q0 + T of batch row b into
//     // buf[swz(j1*T + t)]; returns this thread's sum of the values it read
//   void finish(size_t b, int tile, int tiles, float2 acc) const
//     // every thread, once, after the loads
// and the row kernel stores through a sink policy `Sink`:
//   Row row(float2* y, size_t b, int q, int p, int p0) const
//     // the block's outputs, Row providing
//     //   void put(int k2, int t, float2 v) const  // natural output
//     //                                            // k = k2*P + p0 + t
//   void finish(size_t b, int p0) const  // every thread, after the stores

// K12's source: x (B, P, Q) rows of P*Q values.
struct PadRowsIn {
  static constexpr int kBlocks = kPadColPlainBlocks;
  __device__ float2 load(const float2* __restrict__ x, size_t b, int p, int q, int q0, int T,
                         float2* buf) const {
    load_tile(x + b * (size_t)p * (size_t)q + q0, (size_t)q, p, T, buf);
    return make_float2(0.f, 0.f);
  }
  __device__ void finish(size_t, int, int, float2) const {}
};

// K12's sink: y (B, Q*P) in natural order, T values a row k2.
struct PadRowsOut {
  struct Row {
    float2* __restrict__ dst;
    int p;
    __device__ void put(int k2, int t, float2 v) const { dst[(size_t)k2 * p + t] = v; }
  };
  __device__ Row row(float2* __restrict__ y, size_t b, int q, int p, int p0) const {
    return Row{y + b * (size_t)q * (size_t)p + p0, p};
  }
  __device__ void finish(size_t, int) const {}
};

// Column stage: block (b, tile) loads x[b, :, q0 .. q0 + T) as (P, T) (T =
// qt but in the last tile) through the source, runs DFT_P in place with the
// outer twiddle of its columns (rows q0 .. of the (Q, P) table) folded in,
// and writes the rows q0 .. q0 + T of y[b] (Q, P), T*P contiguous values.
template <class Src, int MaxM, bool kStamp>
__global__ void __launch_bounds__(kPadColThreads, MaxM == 0 ? Src::kBlocks : 2)
    largepad_col_kernel(const float2* __restrict__ x, float2* __restrict__ y, int p, int q,
                        int qt, Stages st, const float2* __restrict__ outer,
                        unsigned long long* stamps, Src src) {
  extern __shared__ float2 smem[];
  pad_stamp<kStamp>(stamps, 0);
  float2* buf = smem;
  float2* stables = smem + pad16(p * qt);
  auto* place = reinterpret_cast<unsigned short*>(stables + chain_smem_len(st));
  load_chain_tables(st, stables);
  load_places(p, st, place);
  const int tiles = (q + qt - 1) / qt;
  const size_t b = blockIdx.x / tiles;
  const int tile = (int)(blockIdx.x % tiles);
  const int q0 = tile * qt;
  const int T = min(qt, q - q0);
  src.finish(b, tile, tiles, src.load(x, b, p, q, q0, T, buf));
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

// Row stage: block (b, tile) loads a[b, :, p0 .. p0 + T) as (Q, T) (T = pt
// but in the last tile), runs the length-Q FFT in place and stores its
// natural outputs through the sink.
template <class Sink, int MaxM, bool kStamp>
__global__ void __launch_bounds__(kPadMaxThreads)
    largepad_row_kernel(const float2* __restrict__ x, float2* __restrict__ y, int q, int p,
                        int pt, Stages st, unsigned long long* stamps, Sink sink) {
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
  const auto out = sink.row(y, b, q, p, p0);
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
      if (f0 + u * nt < elems) out.put(w.row, w.col, v[u]);
  }
  sink.finish(b, p0);
  pad_stamp<kStamp>(stamps, 3);
}

// 256 threads where two blocks of smem bytes fit an SM, else 512.
static inline int pad_threads(size_t smem) {
  return 2 * (smem + kBlockReserved) <= (size_t)kSmShared ? 256 : 512;
}

template <class Src, int MaxM, bool kStamp>
static cudaError_t launch_pad_col(const float2* x, float2* y, long long batch, int p, int q,
                                  int qt, const Stages& st, const float2* outer,
                                  unsigned long long* stamps, const Src& src, cudaStream_t s) {
  const size_t smem = pad_smem_bytes(p, qt, st);
  cudaError_t err = allow_smem(largepad_col_kernel<Src, MaxM, kStamp>, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = batch * ((q + qt - 1) / qt);
  largepad_col_kernel<Src, MaxM, kStamp>
      <<<(unsigned)blocks, kPadColThreads, smem, s>>>(x, y, p, q, qt, st, outer, stamps, src);
  return cudaGetLastError();
}

template <class Sink, int MaxM, bool kStamp>
static cudaError_t launch_pad_row(const float2* x, float2* y, long long batch, int q, int p,
                                  int pt, const Stages& st, unsigned long long* stamps,
                                  const Sink& sink, cudaStream_t s) {
  const size_t smem = pad_smem_bytes(q, pt, st);
  cudaError_t err = allow_smem(largepad_row_kernel<Sink, MaxM, kStamp>, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = batch * ((p + pt - 1) / pt);
  largepad_row_kernel<Sink, MaxM, kStamp>
      <<<(unsigned)blocks, pad_threads(smem), smem, s>>>(x, y, q, p, pt, st, stamps, sink);
  return cudaGetLastError();
}

}  // namespace rf
