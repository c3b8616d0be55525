// B_conv of the fused large Bluestein's tile form at the ten Q of 144 ..
// 1296 (m = 256 * Q: the 3432 primes of [8192, 2^20] whose Bluestein
// inner left the tile form below Q = 1536, 24571 at Q = 192 among them):
// the port of rustfft_tpu/ops/pallas/convlarge.py:_kernel_bconv there (K15;
// ops/kernels/convlarge.py bconv_row_tile).  The kernel and its design are
// csrc/bconv_cols.cuh's; csrc/bconv_cols.cu's entry points reach these
// forms.  A unit holds the most columns that divide 256 and leave two
// blocks an SM: 64 at Q = 144 and 192, down to 8 at 1152 and 1296.  The
// chains are register radices, the first leaving W_0 a multiple of 16.
#include "bconv_cols.cuh"

namespace rf {

template <class F>
static int with_small_form(int q, F f) {
  switch (q) {
    case 144: return f(BcgForm<64, 9, 16, 1, 1>{});
    case 192: return f(BcgForm<64, 12, 16, 1, 1>{});
    case 288: return f(BcgForm<32, 2, 9, 16, 1>{});
    case 384: return f(BcgForm<32, 3, 8, 16, 1>{});
    case 432: return f(BcgForm<32, 3, 9, 16, 1>{});
    case 576: return f(BcgForm<16, 6, 6, 16, 1>{});
    case 768: return f(BcgForm<16, 3, 16, 16, 1>{});
    case 864: return f(BcgForm<16, 6, 9, 16, 1>{});
    case 1152: return f(BcgForm<8, 9, 8, 16, 1>{});
    case 1296: return f(BcgForm<8, 9, 9, 16, 1>{});
    default: return cudaErrorInvalidValue;
  }
}

int bcg_small_launch(const BcgArgs& a) {
  return with_small_form(a.q, [&](auto form) -> int { return bcg_run<decltype(form)>(a); });
}

int bcg_small_resident(int q, int* out) {
  return with_small_form(q, [&](auto form) -> int { return bcg_resident<decltype(form)>(out); });
}

}  // namespace rf
