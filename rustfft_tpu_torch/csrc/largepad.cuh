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

}  // namespace rf
