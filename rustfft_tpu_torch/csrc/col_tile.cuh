// K2's persistent column-tile kernel (P = 16 x 16 over 16 columns), on an
// input and output: csrc/large.cu runs it on plain rows (K2, ColRows),
// csrc/large3.cu on plain rows with the modular outer twiddle of the
// three-pass pipeline's pass 1 (K11), csrc/convlarge.cu on the zero-padded,
// chirped input of the fused large Bluestein and its column-pair output
// layout (K15's kernel A, ColChirp), csrc/large_gauss.cu on plain rows with
// its two radix-16 stages in the Gauss form (K4's column stage, kForm =
// kTileGauss: tile_walk.cuh tile_dft16; everything else as K2).  The design is large.cu's header's
// (K2): a persistent grid of blocks each walking contiguous units of
// (tile, batch), batch fastest (ops/kernels/large.py col_walk), the outer
// twiddle's (16, 256) slice in shared memory once per slice, the next
// unit's tile landing by cp.async in a second buffer while the current one
// computes and stores.
//
// The walk's order: the Q/16 tiles of a row fall into `groups` groups of
// S = Q/(16*groups) consecutive tiles, tile t = g*S + s reading slice s
// (rows 16s .. 16s + 15 of the outer table), and unit u is batch row u %
// batch of the s-th tile of group g with (s, g) = divmod(u / batch,
// groups): slice slowest, so a block keeps one slice over groups*batch
// units.  K2 and K15 take one group (t = s = u / batch, the slices of the
// whole (Q, P) table); K11's pass 1 takes P2 groups over M = P2*Q columns
// (ops/kernels/large3.py col_walk, col_unit), its outer table the (Q, P1)
// j3 factor wob, slice s = t mod Q/16.
//
// Its input and output `Io` provide
//   void copy(float2* buf, unsigned b, unsigned t, unsigned q) const
//     // this thread's copies of unit (t, b)'s (256, 16) tile into buf in
//     // plain order, one cp.async group: warp w the rows j*16 + 2w and
//     // j*16 + 2w + 1 (j < 16), which its stage-0 columns read
//   void scale(float2 (&v)[16], int c, unsigned t, unsigned q) const
//     // stage 0's inputs of column c, v[j] the tile's element
//     // (c/16 + 16j, c % 16), after they are read
//   void store(const float2* buf, float2* yb, unsigned t, unsigned q, int c) const
//     // thread c's part of the unit's store from the tile [k1, j2] (at
//     // buf[swz(k1*16 + j2)], the outer twiddle applied) into its output
//     // row yb of P*Q values
//   bool aligned() const  // (host) the copies' alignment holds
#pragma once

#include "large.cuh"
#include "tile_walk.cuh"

namespace rf {

constexpr int kColT = 16;
constexpr int kColP = 256;
constexpr int kColElems = kColP * kColT;
constexpr int kColThreads = kFixedThreads<kColT, 16, 16, 1>;  // 256
static_assert(kColThreads == 256, "one thread per column of a radix-16 stage");

// This thread's copies of the (256, 16) tile at src (rows q apart) into buf
// in plain order, one group: warp w copies the rows j*16 + 2w and j*16 + 2w
// + 1 (j < 16), 128 bytes a row as eight 16-byte copies.
static __device__ __forceinline__ void col_tile_copy(float2* buf, const float2* __restrict__ src,
                                                     unsigned q) {
  const int c = opaque_int(threadIdx.x);
  const int warp = c >> 5, lane = c & 31;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int idx = i * 32 + lane;
    const int row = (idx >> 4) * 16 + 2 * warp + ((idx >> 3) & 1);
    const int piece = (idx & 7) * 2;
    cp_async16(buf + row * kColT + piece, src + (size_t)row * q + piece);
  }
  cp_async_commit();
}

// The walk's unit order (above): unit u's batch row, tile and slice.
struct ColUnits {
  unsigned batch, groups, slices;
  __device__ unsigned row(unsigned u) const { return u % batch; }
  __device__ unsigned slice(unsigned u) const { return u / batch / groups; }
  __device__ unsigned tile(unsigned u) const {
    const unsigned w = u / batch, s = w / groups;
    return (w - s * groups) * slices + s;
  }
};

template <class Io, bool kStamp, int kForm = kTileRoots>
__global__ void __launch_bounds__(kColThreads, 2)
    col_tile_kernel(Io io, float2* __restrict__ y, ColUnits walk, unsigned units,
                    unsigned per, int q, Stages st, const float2* __restrict__ outer,
                    unsigned long long* stamps) {
  PhaseClock<kStamp, 3> clock;
  clock.begin();
  extern __shared__ float4 col_smem[];
  float2* bufs = reinterpret_cast<float2*>(col_smem);  // two tiles
  float2* souter = bufs + 2 * kColElems;
  float2* sroots = souter + kColElems;  // the stages' tables (tile_table_slots)
  const size_t row_elems = (size_t)kColP * (size_t)q;
  const unsigned u0 = blockIdx.x * per;
  const unsigned u1 = min(u0 + per, units);
  if (u0 < u1) io.copy(bufs, walk.row(u0), walk.tile(u0), (unsigned)q);
  load_tile_tables<kForm>(st, sroots);
  const bool inverse = tile_inverse<kForm>(st);
  __syncthreads();
  unsigned slice = ~0u;  // the slice souter holds
  int cur = 0;
  for (unsigned u = u0; u < u1; ++u, cur ^= 1) {
    const int c = opaque_int(threadIdx.x);
    const unsigned t = walk.tile(u), s = walk.slice(u);
    float2* buf = bufs + cur * kColElems;
    if (s != slice) {  // the (16, 256) slice [j2 - q0, k1] at its tile place swz(k1*16 + j2 - q0)
      const float2* __restrict__ src = outer + (size_t)s * kColElems;
      for (int i = c; i < kColElems; i += kColThreads)
        souter[swz((i & (kColP - 1)) * kColT + (i >> 8))] = __ldg(&src[i]);
      slice = s;
    }
    if (u + 1 < u1) {
      const unsigned v = u + 1;
      io.copy(bufs + (cur ^ 1) * kColElems, walk.row(v), walk.tile(v), (unsigned)q);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    // stage 0, radix 16 over the top digit of j1 for column c, in place
    {
      float2 v[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) v[j] = buf[c + 256 * j];
      __syncwarp();
      io.scale(v, c, t, (unsigned)q);
      const float2* __restrict__ tw = opaque_ptr(st.tw[0]);
      tile_dft16<kForm>(v, sroots, 0, inverse, [&](int k, float2 z) {
        z = cmul(z, __ldg(&tw[k * 16 + (c >> 4)]));
        buf[swz(k * 256 + c)] = z;
      });
    }
    clock.lap(0);
    __syncthreads();  // stage 0's outputs and the slice, for every thread
    // stage 1, radix 16 over the low digit, times the outer twiddle, in place
    {
      const int base = (c >> 4) * 256 + (c & 15);
      float2 v[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) v[j] = buf[swz(base + 16 * j)];
      __syncthreads();
      tile_dft16<kForm>(v, sroots, 1, inverse, [&](int k, float2 z) {
        const int f = swz(k * 256 + c);
        buf[f] = cmul(z, souter[f]);
      });
    }
    clock.lap(1);
    __syncthreads();
    // the transposed store of [k1, j2], two k1 a thread
    io.store(buf, y + (size_t)walk.row(u) * row_elems, t, (unsigned)q, c);
    clock.lap(2);
    __syncthreads();  // this buffer and the slice are free
  }
  clock.write(stamps);
}

template <int kForm = kTileRoots>
static size_t col_tile_smem() {
  return (size_t)(3 * kColElems + tile_table_slots(kForm, 2)) * sizeof(float2);
}

// One launch of `grid` persistent blocks over the units (tile, batch) in
// the walk's order with `groups` groups of tiles a row (above), `per` units
// a block (grid*per >= units > (grid - 1)*per).
template <bool kStamp, int kForm = kTileRoots, class Io>
static cudaError_t launch_col_tile(const Io& io, float2* y, long long batch, int q,
                                   long long grid, long long per, const Stages& st,
                                   const float2* outer, unsigned long long* stamps,
                                   cudaStream_t s, int groups = 1) {
  const long long units = batch * (q / kColT);
  if (q % kColT != 0 || groups < 1 || (q / kColT) % groups != 0 || grid < 1 || per < 1 ||
      units > 0x7fffffffLL || grid * per < units || (grid - 1) * per >= units || !io.aligned() ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(col_tile_kernel<Io, kStamp, kForm>, col_tile_smem<kForm>());
  if (err != cudaSuccess) return err;
  const ColUnits walk{(unsigned)batch, (unsigned)groups, (unsigned)(q / kColT / groups)};
  col_tile_kernel<Io, kStamp, kForm><<<(unsigned)grid, kColThreads, col_tile_smem<kForm>(), s>>>(
      io, y, walk, (unsigned)units, (unsigned)per, q, st, outer, stamps);
  return cudaGetLastError();
}

// K2's input and output: x (B, P, Q) [j1, j2] contiguous, 16-byte aligned.
struct ColRows {
  const float2* __restrict__ x;
  __device__ void copy(float2* buf, unsigned b, unsigned t, unsigned q) const {
    col_tile_copy(buf, x + (size_t)b * ((size_t)kColP * (size_t)q) + t * kColT, q);
  }
  __device__ void scale(float2 (&)[16], int, unsigned, unsigned) const {}
  // y[b, q0 + j2, k1], (B, Q, P)
  __device__ void store(const float2* buf, float2* __restrict__ yb, unsigned t, unsigned,
                        int c) const {
    yb += (size_t)t * kColElems;
    for (int i = c; i < kColElems / 2; i += kColThreads) {
      const int j2 = i >> 7, k1 = (i & 127) * 2;
      const float2 a0 = buf[swz(k1 * kColT + j2)], a1 = buf[swz((k1 + 1) * kColT + j2)];
      *reinterpret_cast<float4*>(yb + j2 * kColP + k1) = make_float4(a0.x, a0.y, a1.x, a1.y);
    }
  }
  bool aligned() const { return reinterpret_cast<uintptr_t>(x) % 16 == 0; }
};

static bool col_tile_chain(int k, int r0, int r1, int qt) {
  return k == 2 && r0 == 16 && r1 == 16 && qt == kColT;
}

}  // namespace rf
