// Passes 1 and 2 of the three-pass top-band pipeline: the port of K11.
//
// Replaces rustfft_tpu/ops/pallas/large3.py.  n = P1 * P2 * Q, input index
// j = j1*(P2*Q) + j2*Q + j3, output X[k3*(P1*P2) + k2*P1 + k1]:
//
//   pass 1 (rf_large3_col_stage): K2's column stage (large.py:_kernel_a, as
//       large3.py calls it with the factored table's modular block map) at
//       P = P1 over M = P2*Q columns jr = j2*Q + j3, with only the j3 factor
//       of the outer twiddle, wob[jr mod Q, k1] = w_n^(k1*j3): (B, M, P1)
//       [jr, k1].  Unfactored, pass 1 is K2 itself (rf_large_col_stage with
//       the (M, P1) table of n entries).
//   pass 2 (rf_large3_p2, large3.py:_kernel_p2f; _kernel_p2 with wos NULL):
//       b[b, j3, k2, k1] = w_M^(k2*j3) * sum_j2 wos[j2, k1] * a[b, j2, j3, k1]
//       * w_P2^(j2*k2), wos[j2, k1] = w_{P1P2}^(k1*j2), written as
//       (B, Q, P2, P1) = (B, Q, P) [j3, K]: the layout K3's row stage reads;
//   pass 3: large_row_stage at (Q, P1*P2) (large3.py:_kernel_q).
//
// What bounds both passes on this card: one read and one write, 16 bytes a
// point (2.1 GB at 2^26 x 2: 0.64 ms at 3.35 TB/s); their operations
// (5*log2(P) + 6 flops a point and less) are far under the FP32 peak.  So
// the design is about how a block meets device memory:
//
// Pass 1 at P1 = 16 x 16 runs K2's persistent column-tile kernel
// (csrc/col_tile.cuh: a (256, 16) tile of 32 KiB a unit, two blocks an SM,
// the next unit's tile landing by cp.async while the current one computes
// and stores, the outer twiddle's (16, 256) slice in shared memory).  Two
// things differ from K2: the slice of tile t is wob's rows 16*(t mod Q/16)
// .. + 15, and the units run in the order (j3 tile, j2, batch), batch
// fastest (col_tile.cuh's walk with P2 groups; ops/kernels/large3.py
// col_walk, col_unit), so that a block keeps one slice over P2*B units
// (128 at 2^26 x 2) instead of B.  Its rows are M*8 bytes apart (2 MiB at
// 2^26 against K2's 32 KiB at 2^20), so a tile's 256 row pieces of 128
// bytes lie in 256 different 2 MiB pages.  Other chains of P1 take
// large.cuh's column stage with the modular twiddle (ModOuter).
//
// Pass 2, p2_ring_kernel: a persistent grid of the blocks the card holds
// (two an SM, 512 threads) walks contiguous ranges of units (k1 chunk, b,
// j3), j3 fastest and the chunk slowest (ops/kernels/large3.py p2_walk,
// p2_unit).  A unit is W consecutive k1 of one (b, j3): P2 row pieces of
// W*8 bytes, Q*P1*8 bytes apart (8 MiB at 2^26 and 2^27), 32 KiB a unit:
// W = 64 (512-byte pieces) up to P2 = 64, W = 32 (256-byte pieces) at P2 =
// 128 (2^27), so that two buffers and the wos slice stay at 96 KiB and
// two blocks an SM at every P2 (256-byte pieces read within 1% of 512-byte
// ones in a copy probe of pass 1's tiles on an H100, PERF.md).  Where W does not
// divide P1 (an even P1: the pieces are 16-byte copies) the last chunk is
// narrower and the columns past it idle.
//  - The next unit's pieces land by cp.async in the second of two buffers
//    while the current unit computes and stores.  Warp w copies exactly the
//    rows and columns its stage A reads, so a warp starts as soon as its
//    own copies land (cp.async.wait_group and __syncwarp, no block barrier).
//  - The DFT over j2 is split P2 = RA x RB (8 x 8 at 64, 16 x 8 at 128;
//    p2_split): j2 =
//    jb + RB*ja, k2 = ka + RA*kb.  Stage A: thread (col, jb) takes the RA
//    values of rows jb + RB*ja into registers (times wos from the chunk's
//    (P2, W) slice in shared memory), runs DFT_RA over ja, multiplies by
//    w_P2^(jb*ka) and writes them back in place to rows jb + RB*ka.  After
//    a block barrier, stage B: thread (col, ka) takes rows jb + RB*ka, a
//    second barrier frees the buffer, then DFT_RB over jb gives X[ka +
//    RA*kb], times wm[j3, k2] (read by __ldg, one address a warp), stored
//    to row k2 of the unit's output: P2 rows of 512 bytes, 2 KiB apart.
//    A thread holds RA or RB values (8 at P2 = 64), not P2.  At 128 stage
//    A's 256 threads hold 16 each (the other 256 idle through it), whose
//    outputs go to shared memory, and stage B's 512 threads 8 each, which
//    store to device memory: 64 registers and no spill.  Consecutive
//    threads take consecutive columns at every step, so shared memory is
//    read and written without bank conflicts and without a swizzle.
//  - The wos slice (P2, W), 32 KiB, is read once per chunk of a block's
//    range, which holds at most two chunks where per <= B*Q (125 units
//    against 8192 at 2^26 x 2, 125 against 4096 at 2^27 x 1).
//  - Without wos (the unfactored pipeline) the slice is neither read nor
//    applied.
// The TPU kernel ran the P2 chain as whole-tile butterflies on its vector
// unit (fused.py:_vpu_fft_list).
#include "col_tile.cuh"

namespace rf {

// Pass 1's rows: K2's ColRows under a name of its own, so that the tile
// kernel this source instantiates is a symbol of its own and not a second
// definition of csrc/large.cu's col_tile_kernel<ColRows>.
struct Pass1Rows : ColRows {};

constexpr int kP2Threads = 512;

// Pass 2's split of P2 = RA x RB (ops/kernels/large3.py p2_split) and its
// unit's width W, k1 a unit (p2_cols).
template <int P2>
struct P2Split {
  static constexpr int RA = P2 == 16 ? 4 : P2 == 128 ? 16 : P2 >= 8 ? 8 : P2;
  static constexpr int RB = P2 / RA;
  static constexpr int W = P2 > 64 ? 32 : 64;
};

// The slots of w_RA^e and of w_RB^e in shared memory: at least 8 each.
template <int R>
constexpr int kRootSlots = R > 8 ? R : 8;

// Two units, the wos slice, w_P2^e, w_RA^e and w_RB^e.
template <int P2>
static size_t p2_smem() {
  using Split = P2Split<P2>;
  return (size_t)(3 * P2 * Split::W + P2 + kRootSlots<Split::RA> + kRootSlots<Split::RB>) *
         sizeof(float2);
}

// Pass 2's unit order (above): unit u is j3 = u mod Q of batch row (u / Q)
// mod B in k1 chunk u / (B*Q).
struct P2Units {
  unsigned q, rows;  // Q, B*Q
  __device__ unsigned chunk(unsigned u) const { return u / rows; }
  __device__ unsigned row(unsigned u) const { return u % rows; }  // b*Q + j3
};

// The columns of chunk c: W, or what is left of P1 in the last chunk.
template <int W>
static __device__ __forceinline__ int p2_width(unsigned c, int p1) {
  return min(W, p1 - (int)c * W);
}

// Warp w's copies of unit (r = b*Q + j3, chunk)'s P2 row pieces into buf
// (row j2 at buf[j2*W]): the rows jb + RB*ja (ja < RA) and the 32 columns
// its stage A reads (warp w takes jb = w / (W/32)), those below the chunk's
// width, RA/2 16-byte copies a lane, one cp.async group (empty for the
// threads stage A leaves idle).
template <int RA, int RB, int W>
static __device__ __forceinline__ void p2_copy(float2* buf, const float2* __restrict__ a,
                                               unsigned r, unsigned chunk, unsigned q, int p1,
                                               int tid) {
  const int width = p2_width<W>(chunk, p1);
  if (tid < W * RB) {
    static_assert(W == 32 || W == 64, "a row piece of one or two warps");
    const int warp = tid >> 5, lane = tid & 31;
    const int jb = warp >> (W / 64), col0 = (warp & (W / 64)) * 32;
    const unsigned b = r / q, j3 = r - b * q;
    const size_t ld = (size_t)q * (size_t)p1;  // j2 rows apart
    const float2* src = a + ((size_t)b * (RA * RB) * q + j3) * (size_t)p1 + chunk * W;
#pragma unroll
    for (int i = 0; i < RA / 2; ++i) {
      const int idx = i * 32 + lane;
      const int row = jb + RB * (idx >> 4), col = col0 + (idx & 15) * 2;
      if (col < width) cp_async16(buf + row * W + col, src + row * ld + col);
    }
  }
  cp_async_commit();
}

template <int RA, int RB, int W>
__global__ void __launch_bounds__(kP2Threads, 2)
    p2_ring_kernel(const float2* __restrict__ a, float2* __restrict__ y, P2Units walk,
                   unsigned units, unsigned per, int p1, const float2* __restrict__ roots,
                   const float2* __restrict__ wos, const float2* __restrict__ wm) {
  constexpr int P2 = RA * RB;
  constexpr int kElems = P2 * W;
  extern __shared__ float4 p2_smem_raw[];
  float2* bufs = reinterpret_cast<float2*>(p2_smem_raw);  // two units
  float2* swos = bufs + 2 * kElems;                        // the chunk's (P2, W) slice
  float2* sroots = swos + kElems;                          // w_P2^e
  float2* roots_a = sroots + P2;                           // w_RA^e = w_P2^(e*RB)
  float2* roots_b = roots_a + kRootSlots<RA>;              // w_RB^e = w_P2^(e*RA)
  const unsigned q = walk.q;
  const unsigned u0 = blockIdx.x * per;
  const unsigned u1 = min(u0 + per, units);
  if (u0 < u1) p2_copy<RA, RB, W>(bufs, a, walk.row(u0), walk.chunk(u0), q, p1, threadIdx.x);
  for (int i = threadIdx.x; i < P2; i += blockDim.x) sroots[i] = roots[i];
  if (threadIdx.x < RA) roots_a[threadIdx.x] = roots[threadIdx.x * RB];
  if (threadIdx.x < RB) roots_b[threadIdx.x] = roots[threadIdx.x * RA];
  __syncthreads();
  int cur = 0;
  for (unsigned u = u0; u < u1; ++u, cur ^= 1) {
    const int tid = opaque_int(threadIdx.x);
    const unsigned r = walk.row(u), chunk = walk.chunk(u);
    const int width = p2_width<W>(chunk, p1);
    float2* buf = bufs + cur * kElems;
    // the chunk's wos slice at the range's first unit and where the chunk
    // changes (r = 0): the chunk never falls along a range, so no register
    // carries the chunk that swos holds (at P2 = 128 ptxas spilled it)
    if (wos != nullptr && (u == blockIdx.x * per || r == 0)) {  // block-uniform
      const float2* __restrict__ src = wos + chunk * W;
      for (int i = tid; i < kElems; i += kP2Threads)
        if (i % W < width) swos[i] = __ldg(&src[(i / W) * p1 + (i % W)]);
      __syncthreads();
    }
    if (u + 1 < u1) {
      p2_copy<RA, RB, W>(bufs + (cur ^ 1) * kElems, a, walk.row(u + 1), walk.chunk(u + 1), q, p1,
                         tid);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    // stage A: DFT_RA over ja of column col at jb, in place
    if (tid < W * RB && tid % W < width) {
      const int col = tid % W, jb = tid / W;
      float2 v[RA];
#pragma unroll
      for (int ja = 0; ja < RA; ++ja) v[ja] = buf[(jb + RB * ja) * W + col];
      if (wos != nullptr) {
#pragma unroll
        for (int ja = 0; ja < RA; ++ja) v[ja] = cmul(v[ja], swos[(jb + RB * ja) * W + col]);
      }
      dft_column<RA>(v, roots_a, [&](int ka, float2 z) {
        if (RB > 1 && ka != 0) z = cmul(z, sroots[jb * ka]);
        buf[(jb + RB * ka) * W + col] = z;
      });
    }
    __syncthreads();  // stage A's outputs, for every thread
    // stage B: DFT_RB over jb of column col at ka, times wm, to row k2
    const int col = tid % W, ka = tid / W;
    const bool active = tid < W * RA && col < width;
    float2 v[RB];
    if (active) {
#pragma unroll
      for (int jb = 0; jb < RB; ++jb) v[jb] = buf[(jb + RB * ka) * W + col];
    }
    __syncthreads();  // this buffer is free
    if (active) {
      float2* __restrict__ yo = y + (size_t)r * P2 * (size_t)p1 + chunk * W + col;
      const float2* __restrict__ wmj = opaque_ptr(wm) + (size_t)(r % q) * P2;
      dft_column<RB>(v, roots_b, [&](int kb, float2 z) {
        const int k2 = ka + RA * kb;
        yo[(size_t)k2 * p1] = cmul(z, __ldg(&wmj[k2]));
      });
    }
  }
}

template <int P2>
static cudaError_t launch_p2(const float2* a, float2* y, long long batch, int p1, int q,
                             long long grid, long long per, const float2* roots,
                             const float2* wos, const float2* wm, cudaStream_t s) {
  using Split = P2Split<P2>;
  // stage A's W*RB threads and stage B's W*RA fit the block; RA <= 16
  // values a thread (stage A at P2 = 128) and RB <= 8 (stage B, which
  // stores to device memory), under the 64 registers of two blocks an SM
  static_assert(Split::RA * Split::RB == P2 && Split::RA >= 2 && Split::RA <= 16 &&
                    Split::RB <= 8 && Split::W * Split::RB <= kP2Threads &&
                    Split::W * Split::RA <= kP2Threads,
                "pass 2's split");
  const long long units = batch * (long long)q * ((p1 + Split::W - 1) / Split::W);
  if (grid < 1 || per < 1 || units > 0x7fffffffLL || grid * per < units ||
      (grid - 1) * per >= units)
    return cudaErrorInvalidValue;
  const auto kernel = p2_ring_kernel<Split::RA, Split::RB, Split::W>;
  cudaError_t err = allow_smem(kernel, p2_smem<P2>());
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)grid, kP2Threads, p2_smem<P2>(), s>>>(
      a, y, P2Units{(unsigned)q, (unsigned)(batch * q)}, (unsigned)units, (unsigned)per, p1,
      roots, wos, wm);
  return cudaGetLastError();
}

template <int P2>
static cudaError_t p2_resident(int* out) {
  using Split = P2Split<P2>;
  return resident_blocks(p2_ring_kernel<Split::RA, Split::RB, Split::W>, kP2Threads,
                         p2_smem<P2>(), out);
}

}  // namespace rf

// x: (batch, P*M) complex64, y: (batch, M, P); the radices of `st` split P,
// qt divides M and Q divides M; wob: (Q, P).  At P = 16 x 16, qt = 16 and
// 16 | Q: col_tile_kernel on `grid` blocks of `per` units
// (ops/kernels/large3.py col_walk), x and y 16-byte aligned; grid and per
// are not read otherwise.
// Returns a cudaError_t code; launches on `stream`.
extern "C" int rf_large3_col_stage(const void* x, void* y, long long batch, int p, int m, int q,
                                   int qt, int k, int r0, int r1, int r2, const void* roots0,
                                   const void* roots1, const void* roots2, const void* tw0,
                                   const void* tw1, const void* wob, long long grid,
                                   long long per, void* stream) {
  using namespace rf;
  if (batch <= 0 || m <= 0 || q <= 0 || m % q != 0 || qt <= 0 || m % qt != 0)
    return cudaErrorInvalidValue;
  const Stages st = make_stages(k, r0, r1, r2, roots0, roots1, roots2, tw0, tw1);
  if (!stages_ok(st, p) || wob == nullptr) return cudaErrorInvalidValue;
  const auto* tx = static_cast<const float2*>(x);
  const auto* tw = static_cast<const float2*>(wob);
  auto* ty = static_cast<float2*>(y);
  const auto s = static_cast<cudaStream_t>(stream);
  if (col_tile_chain(k, r0, r1, qt) && q % kColT == 0)
    return launch_col_tile<false>(Pass1Rows{{tx}}, ty, batch, m, grid, per, st, tw, nullptr, s,
                                  m / q);
  return launch_col_stage(RowsIn{tx, (size_t)p * (size_t)m}, ty, batch, p, m, qt, st,
                          ModOuter{tw, p, q}, s);
}

// a: (batch, P2, Q, P1), y: (batch, Q, P2, P1), complex64; roots: (P2,)
// w_P2^e; wos: (P2, P1) or NULL; wm: (Q, P2).  P2 a power of 2 from 2 to
// 128, P1 even, a and y 16-byte aligned; p2_ring_kernel on
// `grid` blocks of `per` units (ops/kernels/large3.py p2_walk).  Returns a
// cudaError_t code; launches on `stream`.
extern "C" int rf_large3_p2(const void* a, void* y, long long batch, int p1, int p2, int q,
                            const void* roots, const void* wos, const void* wm, long long grid,
                            long long per, void* stream) {
  using namespace rf;
  if (batch <= 0 || p1 <= 0 || p1 % 2 != 0 || q <= 0 || roots == nullptr || wm == nullptr ||
      reinterpret_cast<uintptr_t>(a) % 16 != 0 || reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return cudaErrorInvalidValue;
  const auto* ta = static_cast<const float2*>(a);
  auto* ty = static_cast<float2*>(y);
  const auto* tr = static_cast<const float2*>(roots);
  const auto* tos = static_cast<const float2*>(wos);
  const auto* tm = static_cast<const float2*>(wm);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (p2) {
    case 2: return launch_p2<2>(ta, ty, batch, p1, q, grid, per, tr, tos, tm, s);
    case 4: return launch_p2<4>(ta, ty, batch, p1, q, grid, per, tr, tos, tm, s);
    case 8: return launch_p2<8>(ta, ty, batch, p1, q, grid, per, tr, tos, tm, s);
    case 16: return launch_p2<16>(ta, ty, batch, p1, q, grid, per, tr, tos, tm, s);
    case 32: return launch_p2<32>(ta, ty, batch, p1, q, grid, per, tr, tos, tm, s);
    case 64: return launch_p2<64>(ta, ty, batch, p1, q, grid, per, tr, tos, tm, s);
    case 128: return launch_p2<128>(ta, ty, batch, p1, q, grid, per, tr, tos, tm, s);
    default: return cudaErrorInvalidValue;
  }
}

// The blocks the card holds at once, into *out: of pass 1's tile kernel
// (which = 0) or of pass 2's kernel at P2 = which.
extern "C" int rf_large3_resident_blocks(int which, int* out) {
  using namespace rf;
  switch (which) {
    case 0:
      return resident_blocks(col_tile_kernel<Pass1Rows, false>, kColThreads, col_tile_smem(),
                             out);
    case 2: return p2_resident<2>(out);
    case 4: return p2_resident<4>(out);
    case 8: return p2_resident<8>(out);
    case 16: return p2_resident<16>(out);
    case 32: return p2_resident<32>(out);
    case 64: return p2_resident<64>(out);
    case 128: return p2_resident<128>(out);
    default: return cudaErrorInvalidValue;
  }
}
