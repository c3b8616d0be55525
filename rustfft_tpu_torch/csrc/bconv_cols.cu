// B_conv of the fused large Bluestein's tile form at the inner lengths m =
// 256 * Q, Q in {1536, 1728, 2048, 2304, 3072, 4096, 6144, 12288}, and the
// C entry points of every column form (the Q of 144 .. 1296 are in
// csrc/bconv_cols_small.cu): the port of
// rustfft_tpu/ops/pallas/convlarge.py:_kernel_bconv there (K15;
// ops/kernels/convlarge.py bconv_row_tile).  The kernel and its design are
// csrc/bconv_cols.cuh's.
//
// Q = 12288 (3 * 2^12: m = 3 * 2^20, the 36885 Bluesteins of (2^20, 2^22]
// on that inner length) is one column of 96 KiB a unit on the chain (3,
// 16, 16, 16): two blocks still fit an SM.
#include "bconv_cols.cuh"

namespace rf {

constexpr int kNoForm = -1;

// The forms, by Q (ops/kernels/convlarge.py COLUMN_FORMS): every first
// radix leaves W_0 a multiple of 16.  f(form) for the form of q, or
// kNoForm where q has none here.
template <class F>
static int with_form(int q, F f) {
  switch (q) {
    case 1536: return f(BcgForm<8, 6, 16, 16, 1>{});
    case 1728: return f(BcgForm<8, 12, 16, 9, 1>{});
    case 2048: return f(BcgForm<4, 8, 16, 16, 1>{});
    case 2304: return f(BcgForm<4, 9, 16, 16, 1>{});
    case 3072: return f(BcgForm<4, 12, 16, 16, 1>{});
    case 4096: return f(BcgForm<2, 16, 16, 16, 1>{});
    case 6144: return f(BcgForm<2, 3, 8, 16, 16>{});
    case 12288: return f(BcgForm<1, 3, 16, 16, 16>{});
    default: return kNoForm;
  }
}

// The launch of a.q's form, here or in csrc/bconv_cols_small.cu.
static int bconv_cols(const BcgArgs& a) {
  const int code = with_form(a.q, [&](auto form) -> int { return bcg_run<decltype(form)>(a); });
  return code == kNoForm ? bcg_small_launch(a) : code;
}

static BcgArgs bcg_args(const void* x, void* y, long long batch, int p, int q, int k, int r0,
                        int r1, int r2, int r3, int t, const void* roots, const void* tw,
                        const void* h, const void* outer, long long grid, void* stamps,
                        void* stream) {
  return BcgArgs{x, y, batch, p, q, k, {r0, r1, r2, r3}, t, bcg_tables(k, roots, tw), h, outer,
                 grid, static_cast<unsigned long long*>(stamps), stream};
}

}  // namespace rf

// B_conv of the tile form at Q in the column forms: x, y (batch, P, Q)
// complex64, x 16-byte aligned; the chain (k radices r0..r3, unused 1) and
// t columns a unit, which must be the form's; roots a host array of k
// device pointers (each stage's roots), tw of 2*(k - 1) (chain 1's
// twiddles, then chain 2's); h (P, Q) in chain 1's output positions
// (convlarge.bconv_h_table), outer (P, Q); `grid` persistent blocks
// (convlarge.bconv_grid).  Returns a cudaError_t code; launches on `stream`.
extern "C" int rf_bconv_cols(const void* x, void* y, long long batch, int p, int q, int k, int r0,
                             int r1, int r2, int r3, int t, const void* roots, const void* tw,
                             const void* h, const void* outer, long long grid, void* stream) {
  using namespace rf;
  if (roots == nullptr || tw == nullptr || k < 2 || k > 4) return cudaErrorInvalidValue;
  return bconv_cols(bcg_args(x, y, batch, p, q, k, r0, r1, r2, r3, t, roots, tw, h, outer, grid,
                             nullptr, stream));
}

// The blocks of the form of q the card holds at once, into *out.
extern "C" int rf_bconv_cols_resident(int q, int* out) {
  using namespace rf;
  const int code = with_form(q, [&](auto form) -> int { return bcg_resident<decltype(form)>(out); });
  return code == kNoForm ? bcg_small_resident(q, out) : code;
}

#ifdef RF_PHASE_STAMPS
// rf_bconv_cols through its stamped form: stamps (grid, 4) uint64
// %globaltimer nanoseconds, a block's start and that start plus the running
// sums of its phases (chain 1 with the load and h; chain 2 but its last
// stage; the last stage, the store and the next unit's copies started).
extern "C" int rf_bconv_cols_stamps(const void* x, void* y, long long batch, int p, int q, int k,
                                    int r0, int r1, int r2, int r3, int t, const void* roots,
                                    const void* tw, const void* h, const void* outer,
                                    long long grid, void* stamps, void* stream) {
  using namespace rf;
  if (stamps == nullptr || roots == nullptr || tw == nullptr || k < 2 || k > 4)
    return cudaErrorInvalidValue;
  return bconv_cols(bcg_args(x, y, batch, p, q, k, r0, r1, r2, r3, t, roots, tw, h, outer, grid,
                             stamps, stream));
}
#endif
