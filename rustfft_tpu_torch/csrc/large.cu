// The two-pass large-n pipeline: the ports of K2 (column stage) and K3 (row
// stage), the stages of csrc/large.cuh with plain loads and stores.
//
// The column stage replaces rustfft_tpu/ops/pallas/large.py:_kernel_a, the
// row stage large.py:_kernel_b (with fftq_sublane); large.cuh holds the
// general kernels, their design and what bounds them on this card.  The
// chains of the 2^20 main path, P = 16 x 16 and Q = 16 x 16 x 16, run the
// persistent kernels below; every other chain runs large.cuh's.
//
// What bounds both on this card is the bytes, 16 a point a stage (0.32 ms
// at 64 x 2^20 at 3.35 TB/s); large.cuh's compile-time bodies load, compute
// and store a tile in turn, so an SM asks device memory for nothing while
// its block computes.  The kernels below keep the same arithmetic (the
// same stages on the same values: their outputs are those of large.cuh's
// bodies) and change how a block meets device memory:
//
// K3, row_tile_kernel (Q = 4096, a (Q, 4) tile of 128 KiB, one block an
// SM, 512 threads of two columns each).  A persistent grid, block g walking
// the tiles g, g + grid, ... (ops/kernels/large.py row_grid), so that the
// blocks at work at one time hold neighbouring tiles: the 32-byte row
// segments of tile u and u + 1 are read and written at about the same time.
//  - The tile lands in shared memory by cp.async (16 bytes a copy, 16 a
//    thread) in plain row order, and stage 0 runs in place there instead
//    of from device memory.  Stage 0's column col (col < 1024) reads
//    elements col + 1024*j and writes col + 1024*k, the rows col/4 + 256*j:
//    the four threads of its quad copy exactly those rows, so the copies a
//    warp reads are the warp's own.  A thread's cp.async group and a
//    __syncwarp then do what a chunk's mbarrier would (a chunk k, the rows
//    (r mod 256) in [16k, 16k + 16), is the stage-0 columns of two warps):
//    each warp starts stage 0 as soon as its own rows land.  swz moves an
//    element only within its group of 16 (four rows), and the groups of col
//    + 1024*j and of col + 1024*k are those of the same 16 threads, so the
//    re-swizzle stage 0's writes make stays inside the warp, behind that
//    __syncwarp.
//  - Stage 2's column col reads the rows 16*(col/4) .. + 15 and keeps them
//    in registers; after the block barrier that follows those reads no
//    thread reads the tile again, so every thread there starts its copies
//    of the block's next tile into it, and stage 2's DFT and its stores to
//    device memory run while they land.  (Freeing chunk by chunk would need
//    16 more barriers: stage 2's rows of chunk k are read by threads of 16
//    warps.)  A first tile lands the same way as every other: 2^20 x 1 and
//    x 4 took 0.032 and 0.080 ms against the compile-time body's 0.048 and
//    0.120 (H100 80GB HBM3, 700 W).
//  - Its stage-0 columns read the tile in 32-byte row segments, as the
//    compile-time body reads device memory; tools/torch_ab.py's probe copies
//    64 x 2^20 in that pattern in 0.525 ms against 0.416 in consecutive
//    128 KiB (same card), the floor this kernel (0.58-0.61 ms there) works
//    against.
//  - It takes RowsOut only (K14's sinks run K12's ragged kernels,
//    csrc/conv_pad_row.cu).
//
// K2, col_tile_kernel (P = 256, a (256, 16) tile of 32 KiB, 256 threads,
// two blocks an SM at 96 KiB).  A persistent grid, block g walking the
// units [g*per, min((g + 1)*per, units)) of (tile, batch), batch fastest
// (ops/kernels/large.py col_walk), so that a block keeps one q0 over many
// rows:
//  - the block's (16, 256) slice of the outer twiddle (32 KiB, contiguous in
//    the (Q, P) table) is read into shared memory once per q0, in the
//    tile's swizzled order, and applied in registers as stage 1 writes its
//    outputs, so the transposed store reads the tile once and multiplies
//    nothing (large.cuh's body reads the slice by __ldg for every row);
//  - the next unit's tile lands by cp.async in a second buffer while the
//    current unit computes and stores; warp w copies the rows j*16 + 2w,
//    j*16 + 2w + 1 that its stage 0 reads, in plain order, and stage 0
//    re-swizzles in place behind a __syncwarp, as in K3;
//  - the store writes 16 bytes a thread (two k1), 2 KiB runs per j2.
//
// Both read their input by 16-byte copies, so x must be 16-byte aligned
// (the wrappers copy a misaligned view first).  Every offset into device
// memory is size_t.
#include <stdint.h>

#include "col_tile.cuh"

namespace rf {

// Phase stamps of the two kernels (their kStamp forms; ops/kernels/large.py
// COL_PHASES, ROW_PHASES).
constexpr int kLargePhases = 3;

template <bool kStamp>
using LargeClock = PhaseClock<kStamp, kLargePhases>;

// ---- K3 at Q = 4096 ---------------------------------------------------------

constexpr int kRowT = 4;
constexpr int kRowQ = 4096;
constexpr int kRowElems = kRowQ * kRowT;
constexpr int kRowCols = kRowElems / 16;  // the columns of a radix-16 stage
// Two columns a thread: at 1024 threads (one a column) the 64 registers a
// thread may hold cover a column's 16 values and little else (ptxas, sm_90a:
// 276 bytes of spill; 0.90-0.93 ms at 64 x 2^20 against 0.58-0.61 at 512
// threads, 128 registers and no spill, on an H100 80GB HBM3 at 700 W).
constexpr int kRowThreads = 512;
constexpr int kRowPer = kRowCols / kRowThreads;

// This thread's copies of the (4096, 4) window at src into buf in plain
// order, one group: for each of its stage-0 columns col = c + 512*i, the
// rows col/4 + 256*j, j = 8*(c & 1) .. + 7, columns (c & 2) and (c & 2) + 1,
// the rows that column reads.  `at` is the first copy's offset, (c/4 +
// 2048*(c & 1))*P + (c & 2), and `step` 256*P (every offset of a (4096, P)
// row fits 32 bits: P <= 16384).
static __device__ __forceinline__ void row_tile_copy(float2* buf, const float2* __restrict__ src,
                                                     unsigned at, unsigned step) {
  const int c = opaque_int(threadIdx.x);
  float2* dst = buf + ((c >> 2) + 2048 * (c & 1)) * kRowT + (c & 2);
#pragma unroll
  for (int i = 0; i < kRowPer; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      cp_async16(dst + kRowThreads * i + 1024 * j,
                 src + at + i * (kRowThreads / 4) * (step / 256) + j * step);
  }
  cp_async_commit();
}

template <bool kStamp>
__global__ void __launch_bounds__(kRowThreads, 1)
    row_tile_kernel(const float2* __restrict__ x, float2* __restrict__ y, unsigned tiles, int p,
                    Stages st, unsigned long long* stamps) {
  LargeClock<kStamp> clock;
  clock.begin();
  extern __shared__ float4 row_smem[];
  float2* buf = reinterpret_cast<float2*>(row_smem);
  float2* sroots = buf + kRowElems;
  const unsigned per_row = (unsigned)p / kRowT;
  const size_t row_elems = (size_t)kRowQ * (size_t)p;
  const unsigned step = 256u * (unsigned)p;
  unsigned u = blockIdx.x;
  if (u < tiles) {
    const int c = threadIdx.x;
    row_tile_copy(buf, x + (size_t)(u / per_row) * row_elems + (u % per_row) * kRowT,
                  (unsigned)((c >> 2) + 2048 * (c & 1)) * (unsigned)p + (c & 2), step);
  }
  load_roots(st, sroots);
  __syncthreads();
  for (; u < tiles; u += gridDim.x) {
    const int c = opaque_int(threadIdx.x);
    // stage 0, radix 16 over the top digit of columns c + 512*i, in place:
    // the groups of 16 a warp reads and writes are its own
    {
      cp_async_wait<0>();
      __syncwarp();
      float2 v[kRowPer][16];
#pragma unroll
      for (int i = 0; i < kRowPer; ++i) {
#pragma unroll
        for (int j = 0; j < 16; ++j) v[i][j] = buf[c + kRowThreads * i + 1024 * j];
      }
      __syncwarp();
      const float2* __restrict__ tw = opaque_ptr(st.tw[0]);
#pragma unroll
      for (int i = 0; i < kRowPer; ++i) {
        const int col = c + kRowThreads * i;
        dft_column<16>(v[i], sroots, [&](int k, float2 z) {
          z = cmul(z, __ldg(&tw[k * 256 + (col >> 2)]));
          buf[swz(k * 1024 + col)] = z;
        });
      }
    }
    clock.lap(0);
    __syncthreads();
    // stage 1, radix 16 over the middle digit, in place (large.cuh's
    // fixed_stage<16, 16, 16, 4, kRowThreads> with this unit's column index)
    {
      float2 v[kRowPer][16];
#pragma unroll
      for (int i = 0; i < kRowPer; ++i) {
        const int col = c + kRowThreads * i;
        const int base = (col >> 6) * 1024 + (col & 63);
#pragma unroll
        for (int j = 0; j < 16; ++j) v[i][j] = buf[swz(base + 64 * j)];
      }
      __syncthreads();
      const float2* __restrict__ tw = opaque_ptr(st.tw[1]);
#pragma unroll
      for (int i = 0; i < kRowPer; ++i) {
        const int col = c + kRowThreads * i;
        dft_column<16>(v[i], sroots + 16, [&](int k, float2 z) {
          z = cmul(z, __ldg(&tw[k * 16 + ((col & 63) >> 2)]));
          buf[swz(k * 1024 + col)] = z;
        });
      }
    }
    clock.lap(1);
    __syncthreads();
    // stage 2 over the rows 16*(col/4) .. + 15 of each column, the next
    // tile's copies started once every thread holds its rows, then the
    // stores
    {
      float2 v[kRowPer][16];
#pragma unroll
      for (int i = 0; i < kRowPer; ++i) {
        const int col = c + kRowThreads * i;
        const int base = (col >> 2) * 64 + (col & 3);
#pragma unroll
        for (int j = 0; j < 16; ++j) v[i][j] = buf[swz(base + 4 * j)];
      }
      __syncthreads();
      const unsigned next = u + gridDim.x;
      if (next < tiles)
        row_tile_copy(buf, x + (size_t)(next / per_row) * row_elems + (next % per_row) * kRowT,
                      (unsigned)((c >> 2) + 2048 * (c & 1)) * (unsigned)p + (c & 2), step);
      float2* __restrict__ yr =
          y + (size_t)(u / per_row) * row_elems + (u % per_row) * kRowT + (c & 3);
#pragma unroll
      for (int i = 0; i < kRowPer; ++i) {
        const unsigned out = (unsigned)((c + kRowThreads * i) >> 2) * (unsigned)p;
        dft_column<16>(v[i], sroots + 32, [&](int k, float2 z) { yr[out + k * step] = z; });
      }
    }
    clock.lap(2);
  }
  clock.write(stamps);
}

static size_t row_tile_smem() { return (size_t)(kRowElems + 48) * sizeof(float2); }

// One launch of `grid` persistent blocks (1 <= grid <= tiles) over the
// batch*P/4 tiles.
template <bool kStamp>
static cudaError_t launch_row_tile(const float2* x, float2* y, long long batch, int p,
                                   long long grid, const Stages& st, unsigned long long* stamps,
                                   cudaStream_t s) {
  const long long tiles = batch * (p / kRowT);
  if (p % kRowT != 0 || p > 16384 || grid < 1 || grid > tiles || tiles > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(row_tile_kernel<kStamp>, row_tile_smem());
  if (err != cudaSuccess) return err;
  row_tile_kernel<kStamp><<<(unsigned)grid, kRowThreads, row_tile_smem(), s>>>(
      x, y, (unsigned)tiles, p, st, stamps);
  return cudaGetLastError();
}

static bool row_tile_chain(int k, int r0, int r1, int r2, int pt) {
  return k == 3 && r0 == 16 && r1 == 16 && r2 == 16 && pt == kRowT;
}

// rf_large_col_stage's checks and launch; the stamped form where kStamp.
template <bool kStamp>
static int col_stage(const void* x, void* y, long long batch, int p, int q, int qt, int k,
                     int r0, int r1, int r2, const void* roots0, const void* roots1,
                     const void* roots2, const void* tw0, const void* tw1, const void* tw_outer,
                     long long grid, long long per, unsigned long long* stamps, void* stream) {
  if (batch <= 0 || q <= 0 || qt <= 0 || q % qt != 0) return cudaErrorInvalidValue;
  const Stages st = make_stages(k, r0, r1, r2, roots0, roots1, roots2, tw0, tw1);
  if (!stages_ok(st, p) || tw_outer == nullptr) return cudaErrorInvalidValue;
  const float2* tx = static_cast<const float2*>(x);
  const float2* to = static_cast<const float2*>(tw_outer);
  float2* ty = static_cast<float2*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (col_tile_chain(k, r0, r1, qt))
    return launch_col_tile<kStamp>(ColRows{tx}, ty, batch, q, grid, per,
                                   st, to, stamps, s);
  if (kStamp) return cudaErrorInvalidValue;
  return launch_col_stage(RowsIn{tx, (size_t)p * (size_t)q}, ty, batch, p, q, qt, st,
                          FullOuter{to, p}, s);
}

// rf_large_row_stage's checks and launch; the stamped form where kStamp.
template <bool kStamp>
static int row_stage(const void* x, void* y, long long batch, int q, int p, int pt, int k,
                     int r0, int r1, int r2, const void* roots0, const void* roots1,
                     const void* roots2, const void* tw0, const void* tw1, long long grid,
                     unsigned long long* stamps, void* stream) {
  if (batch <= 0 || p <= 0 || pt <= 0 || p % pt != 0) return cudaErrorInvalidValue;
  const Stages st = make_stages(k, r0, r1, r2, roots0, roots1, roots2, tw0, tw1);
  if (!stages_ok(st, q)) return cudaErrorInvalidValue;
  const float2* tx = static_cast<const float2*>(x);
  float2* ty = static_cast<float2*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (row_tile_chain(k, r0, r1, r2, pt))
    return launch_row_tile<kStamp>(tx, ty, batch, p, grid, st, stamps, s);
  if (kStamp) return cudaErrorInvalidValue;
  return launch_row_stage(tx, RowsOut{ty, (size_t)q * (size_t)p}, batch, q, p, pt, st, true, s);
}

}  // namespace rf

// x: (batch, P, Q), y: (batch, Q, P), complex64; P = product of the radices
// of `st`, qt divides Q.  At P = 16 x 16, qt = 16: col_tile_kernel on
// `grid` blocks of `per` units (ops/kernels/large.py col_walk), x and y
// 16-byte aligned; grid and per are not read otherwise.  Returns a
// cudaError_t code; launches on `stream`.
extern "C" int rf_large_col_stage(const void* x, void* y, long long batch, int p, int q,
                                  int qt, int k, int r0, int r1, int r2, const void* roots0,
                                  const void* roots1, const void* roots2, const void* tw0,
                                  const void* tw1, const void* tw_outer, long long grid,
                                  long long per, void* stream) {
  return rf::col_stage<false>(x, y, batch, p, q, qt, k, r0, r1, r2, roots0, roots1, roots2, tw0,
                              tw1, tw_outer, grid, per, nullptr, stream);
}

// x, y: (batch, Q, P) complex64, Q = product of the radices of `st`, pt
// divides P.  At Q = 16 x 16 x 16, pt = 4: row_tile_kernel on `grid`
// blocks (ops/kernels/large.py row_grid), x 16-byte aligned; grid is not
// read otherwise.  Returns a cudaError_t code; launches on `stream`.
extern "C" int rf_large_row_stage(const void* x, void* y, long long batch, int q, int p,
                                  int pt, int k, int r0, int r1, int r2, const void* roots0,
                                  const void* roots1, const void* roots2, const void* tw0,
                                  const void* tw1, long long grid, void* stream) {
  return rf::row_stage<false>(x, y, batch, q, p, pt, k, r0, r1, r2, roots0, roots1, roots2, tw0,
                              tw1, grid, nullptr, stream);
}

// The blocks of the column (which = 0) or row (which = 1) tile kernel the
// card holds at once, into *out.
extern "C" int rf_large_resident_blocks(int which, int* out) {
  using namespace rf;
  if (which == 0)
    return resident_blocks(col_tile_kernel<ColRows, false>, kColThreads, col_tile_smem(), out);
  if (which == 1)
    return resident_blocks(row_tile_kernel<false>, kRowThreads, row_tile_smem(), out);
  return cudaErrorInvalidValue;
}

#ifdef RF_PHASE_STAMPS
// rf_large_col_stage and rf_large_row_stage through the tile kernels'
// stamped forms (their chains only): stamps (grid, 4) uint64 %globaltimer
// nanoseconds, a block's start and that start plus the running sums of its
// phases.  Only the library built with RF_PHASE_STAMPS has them
// (ops/kernels/_build.py load(phase_stamps=True); tools/torch_phase_times.py).
extern "C" int rf_large_col_phase_stamps(const void* x, void* y, long long batch, int p, int q,
                                         int qt, int k, int r0, int r1, int r2,
                                         const void* roots0, const void* roots1,
                                         const void* roots2, const void* tw0, const void* tw1,
                                         const void* tw_outer, long long grid, long long per,
                                         void* stamps, void* stream) {
  if (stamps == nullptr) return cudaErrorInvalidValue;
  return rf::col_stage<true>(x, y, batch, p, q, qt, k, r0, r1, r2, roots0, roots1, roots2, tw0,
                             tw1, tw_outer, grid, per,
                             static_cast<unsigned long long*>(stamps), stream);
}

extern "C" int rf_large_row_phase_stamps(const void* x, void* y, long long batch, int q, int p,
                                         int pt, int k, int r0, int r1, int r2,
                                         const void* roots0, const void* roots1,
                                         const void* roots2, const void* tw0, const void* tw1,
                                         long long grid, void* stamps, void* stream) {
  if (stamps == nullptr) return cudaErrorInvalidValue;
  return rf::row_stage<true>(x, y, batch, q, p, pt, k, r0, r1, r2, roots0, roots1, roots2, tw0,
                             tw1, grid, static_cast<unsigned long long*>(stamps), stream);
}

namespace rf {

// The access-pattern probe of K3's tile: a copy of (batch, 4096, P)
// complex64 by the grid and threads of large.cuh's row_fixed_kernel<4, 16,
// 16, 16>, 16 values a thread loaded, then stored.  strided: block (b, p0)
// moves the (4096, 4) window at column p0, 32 bytes from each of 4096 rows
// P*8 bytes apart, as that body's stage 0 loads and its stage 2 stores;
// else it moves 128 KiB of consecutive values.
__global__ void __launch_bounds__(1024)
    copy_probe_kernel(const float2* __restrict__ x, float2* __restrict__ y, int p, int strided) {
  const int tiles = p / kRowT;
  const size_t b = blockIdx.x / tiles;
  const int p0 = (int)(blockIdx.x % tiles) * kRowT;
  size_t at[16];
  float2 v[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int f = j * 1024 + (int)threadIdx.x;
    at[j] = strided ? b * (size_t)kRowQ * (size_t)p + (size_t)(f / kRowT) * p + p0 + f % kRowT
                    : (size_t)blockIdx.x * kRowElems + f;
    v[j] = x[at[j]];
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) y[at[j]] = v[j];
}

}  // namespace rf

// The access-pattern probe (copy_probe_kernel): x, y (batch, 4096, P)
// complex64, P a multiple of 4.
extern "C" int rf_large_copy_probe(const void* x, void* y, long long batch, int p, int strided,
                                   void* stream) {
  using namespace rf;
  if (batch <= 0 || p <= 0 || p % kRowT != 0 || batch * (p / kRowT) > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  copy_probe_kernel<<<(unsigned)(batch * (p / kRowT)), 1024, 0,
                      static_cast<cudaStream_t>(stream)>>>(static_cast<const float2*>(x),
                                                           static_cast<float2*>(y), p, strided);
  return cudaGetLastError();
}
#endif
