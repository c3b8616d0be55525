// The Gauss forms of the two-pass pipeline's stages: the port of K4's
// rustfft_tpu/ops/pallas/large.py:76 _kernel_a_gauss (column stage) and
// :131 _kernel_b_gauss with :104 fftq_sublane_gauss (row stage).
//
// The JAX bodies contract every DFT as three real products, P1 = xr.Wr,
// P2 = xi.Wi, P3 = (xr + xi).(Wr + Wi), re = P1 - P2, im = P3 - P1 - P2, which
// saves a quarter of the matrix unit's passes.  Here every radix stage takes
// that form, three multiply-adds per term where the default kernels run
// radix-2 register butterflies; the inter-stage and outer twiddles stay
// complex products, as in the JAX bodies.
//
// What bounds them on this card: the same 16 bytes per point per stage as
// K2 and K3 (0.32 ms at 64 x 2^20 at 3.35 TB/s), and the Gauss arithmetic,
// about 6r FP32 operations per point per radix-r stage (at 64 x 2^20 about
// 0.21 ms for the column stage and 0.31 ms for the row stage at 67
// TFLOP/s).  The general bodies (large.cuh col_kernel / row_kernel with
// kGauss, fft_tile.cuh gauss_stage) add to every three multiply-adds a
// 16-byte shared-memory read of {Wr, Wi, Ws} and a modular index update,
// ping-pong every stage through a second buffer, load, compute and store a
// tile in turn, and fit only two columns of Q = 4096 a block: 1.72 and
// 3.01 ms at 64 x 2^20 (H100 80GB HBM3, 700 W).
//
// The design: where K2 and K3 run their persistent tile kernels (P = 16 x
// 16 over 16 columns; Q = 16 x 16 x 16 over 4 columns, P <= 32768), the
// Gauss forms run the same kernels (csrc/col_tile.cuh col_tile_kernel,
// csrc/row_tile.cuh row_tile_kernel at kForm = kTileGauss) with each
// radix-16 stage's DFT_16 as gauss_column on the column in registers: the
// root index (j*k) mod 16 is a compile-time constant and the tables are
// constants (csrc/gauss16.cuh), so each term is three FFMAs with immediate
// operands and nothing else, and the multiply-adds run under the tile
// walks' cp.async lookahead.  A Gauss column needs 48 registers (xr, xi
// and the 16 sums xr + xi) where the radix-2 FFT needs 32, so the row form
// runs a thread's two columns one after the other: stage 0 in place
// (warp-local), stages 1 and 2 with the second column stashed in 64 KiB of
// shared memory beside the tile (row_tile.cuh row_gauss_read); holding
// both spilled 108 bytes at 128 registers.  Every other split, and K14's
// gauss_mode, stay on the general bodies.  The tile forms compute the
// general bodies' floats (the same sums in the same order, bit for bit on
// the card): `grid` = 0 launches the general body at any shape (the
// wrappers' general=True, for that check).
//
// Measured at 64 x 2^20 (tools/torch_ab.py K4; NVIDIA H100 80GB HBM3,
// 700 W): the column stage 1.72-1.73 -> 0.51-0.55 ms (K2 on the same input
// 0.50-0.51), the row stage 3.05-3.08 -> 0.71-0.72 ms (K3 0.60-0.64,
// torch.fft over the same rows 1.04-1.05); 2^20 x 1024 under large_gauss
// 72.8-73.6 -> 17.9 ms.
#include "col_tile.cuh"
#include "row_tile.cuh"

namespace rf {

static int col_stage_gauss(const void* x, void* y, long long batch, int p, int q, int qt, int k,
                           int r0, int r1, int r2, const void* g0, const void* g1,
                           const void* g2, const void* tw0, const void* tw1,
                           const void* tw_outer, long long grid, long long per, void* stream) {
  if (batch <= 0 || q <= 0 || qt <= 0 || q % qt != 0) return cudaErrorInvalidValue;
  const Stages st = make_gauss_stages(k, r0, r1, r2, g0, g1, g2, tw0, tw1);
  if (!stages_ok(st, p, true) || tw_outer == nullptr) return cudaErrorInvalidValue;
  const float2* tx = static_cast<const float2*>(x);
  const float2* to = static_cast<const float2*>(tw_outer);
  float2* ty = static_cast<float2*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid > 0) {
    if (!col_tile_chain(k, r0, r1, qt)) return cudaErrorInvalidValue;
    return launch_col_tile<false, kTileGauss>(ColRows{tx}, ty, batch, q, grid, per, st, to,
                                              nullptr, s);
  }
  return launch_col_gauss(RowsIn{tx, (size_t)p * (size_t)q}, ty, batch, p, q, qt, st,
                          FullOuter{to, p}, s);
}

static int row_stage_gauss(const void* x, void* y, long long batch, int q, int p, int pt, int k,
                           int r0, int r1, int r2, const void* g0, const void* g1,
                           const void* g2, const void* tw0, const void* tw1, long long grid,
                           void* stream) {
  if (batch <= 0 || p <= 0 || pt <= 0 || p % pt != 0) return cudaErrorInvalidValue;
  const Stages st = make_gauss_stages(k, r0, r1, r2, g0, g1, g2, tw0, tw1);
  if (!stages_ok(st, q, true)) return cudaErrorInvalidValue;
  const float2* tx = static_cast<const float2*>(x);
  float2* ty = static_cast<float2*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid > 0) {
    if (!row_tile_chain(k, r0, r1, r2, pt)) return cudaErrorInvalidValue;
    return launch_row_tile<false, kTileGauss>(tx, ty, batch, p, grid, st, nullptr, s);
  }
  return launch_row_gauss(tx, RowsOut{ty, (size_t)q * (size_t)p}, batch, q, p, pt, st, s);
}

}  // namespace rf

// x: (batch, P, Q), y: (batch, Q, P), complex64; g0..g2: (3, r_s) float32
// Gauss tables of the radices of P; qt divides Q.  grid > 0: the Gauss form
// of col_tile_kernel (P = 16 x 16, qt = 16) on `grid` blocks of `per` units
// (ops/kernels/large.py col_walk), x and y 16-byte aligned; grid = 0: the
// general body.  Returns a cudaError_t code; launches on `stream`.
extern "C" int rf_large_col_stage_gauss(const void* x, void* y, long long batch, int p, int q,
                                        int qt, int k, int r0, int r1, int r2, const void* g0,
                                        const void* g1, const void* g2, const void* tw0,
                                        const void* tw1, const void* tw_outer, long long grid,
                                        long long per, void* stream) {
  return rf::col_stage_gauss(x, y, batch, p, q, qt, k, r0, r1, r2, g0, g1, g2, tw0, tw1, tw_outer,
                             grid, per, stream);
}

// x, y: (batch, Q, P) complex64; g0..g2: (3, r_s) float32 Gauss tables of
// the radices of Q; pt divides P.  grid > 0: the Gauss form of
// row_tile_kernel (Q = 16 x 16 x 16, pt = 4, P <= 32768) on `grid` blocks
// (ops/kernels/large.py row_grid), x 16-byte aligned; grid = 0: the general
// body.  Returns a cudaError_t code; launches on `stream`.
extern "C" int rf_large_row_stage_gauss(const void* x, void* y, long long batch, int q, int p,
                                        int pt, int k, int r0, int r1, int r2, const void* g0,
                                        const void* g1, const void* g2, const void* tw0,
                                        const void* tw1, long long grid, void* stream) {
  return rf::row_stage_gauss(x, y, batch, q, p, pt, k, r0, r1, r2, g0, g1, g2, tw0, tw1, grid,
                             stream);
}

// The blocks of the Gauss column (which = 0) or row (which = 1) tile kernel
// the card holds at once, into *out.
extern "C" int rf_large_gauss_resident_blocks(int which, int* out) {
  using namespace rf;
  if (which == 0)
    return resident_blocks(col_tile_kernel<ColRows, false, kTileGauss>, kColThreads,
                           col_tile_smem<kTileGauss>(), out);
  if (which == 1)
    return resident_blocks(row_tile_kernel<false, kTileGauss>, kRowThreads,
                           row_tile_smem<kTileGauss>(), out);
  return cudaErrorInvalidValue;
}
