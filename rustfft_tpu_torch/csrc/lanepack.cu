// Whole small transforms, many to a block: the port of K1.
//
// Replaces rustfft_tpu/ops/pallas/lanepack.py:_kernel (with _fft_sublane and
// _stage_consts): a batch of length-n transforms, each a decimation-in-time
// chain of DFT stages with twiddles between them, in one read and one
// write of device memory.
//
// What bounds it on this card: one read and one write of 8 bytes a point,
// 16 bytes / 3.35 TB/s a point.  Arithmetic is FP32 on the CUDA cores; the
// reference's split (256, 16) as dense stages costs 272 complex
// multiply-adds a point and made the first port compute-bound (15x slower
// than (16, 16, 16)).  So each stage runs as K7's in-place chain runs its
// radix (csrc/inplace_chain.cuh): registers for 2-9, 12 and 16, the
// in-place Bluestein stage (one warp a column, M <= 512) for the primes
// from 29 and most radices from 24 up, a direct sum for the rest, and the
// chain is the cheapest by that cost (ops/kernels/lanepack.py stage_cost):
// any n that is a product of at most four register radices runs register
// stages only.  Two kernels:
//
//  - lanepack_chain_kernel, every chain but the main path's: ONE shared
//    buffer holds T = chain_width(n) interleaved transforms (element (i, t)
//    at swz(i*T + t); T = 64 at n = 64, 1 from 4097 up), so that a small
//    n fills a block (the card's form of the TPU kernel's lane packing) and
//    the direct stages' roots are loaded once for T transforms.  A
//    block loads T whole rows (one contiguous span of device memory), runs
//    up to four in-place stages and stores the rows from the chain's output
//    places; the last block of the batch holds the transforms left and
//    runs the chain at that width.  Its form without a Bluestein stage
//    (MaxM = 0) serves chains that have none.
//  - lanepack_pipe_kernel, n = 4096 as (16, 16, 16), the main path: one
//    persistent block an SM slot (three an SM) walks the batch and keeps
//    the next transform's load in flight (cp.async into a second buffer)
//    while it computes the current one, so that HBM does not wait on the
//    stages (the first port loaded, computed and stored in turn in each of
//    16384 blocks: the load and stage 0 took 59% of a block's span).  The
//    twiddles sit in shared memory, loaded once a block: stage 0's
//    w_4096^(k*j') as the product of two (16, 16) tables (the first port
//    read it per output from a (16, 256) table in device memory, 32 KB for
//    each 32 KB transform); the radix-16 FFTs take their roots as
//    immediates.  Stages 0 and 1 run in the buffer; stage 2 writes natural
//    order to device memory, 256 consecutive points per output digit.
//
// The TPU kernel's lane<->sublane transposes, 128-row batch groups, lane
// padding and bf16 hi/lo tables have no counterpart here.
#include "largepad.cuh"

namespace rf {

// ---- the chain kernel ---------------------------------------------------------

constexpr int kLpMaxStages = 4;
// The most threads a block has (ops/kernels/lanepack.py chain_threads picks
// 128 or 256).
constexpr int kLpThreads = 256;
// The Bluestein cap: lanepack's radices are at most 256 (MAX_STAGE), M <= 512.
constexpr int kLpMaxM = 512;

// A chain of 1..4 stages: a Bluestein stage's table (bm[s] != 0) or a
// direct stage's roots in tab[s], device memory.
struct LpChain {
  int k;
  int r[kLpMaxStages];
  int bm[kLpMaxStages];
  const float2* tab[kLpMaxStages];
  const float2* tw[kLpMaxStages - 1];
};

// Roots a block holds in shared memory: those of the direct stages.
static __host__ __device__ inline int lp_roots_len(const LpChain& ch) {
  int total = 0;
  for (int s = 0; s < ch.k; ++s) total += ch.bm[s] == 0 ? ch.r[s] : 0;
  return total;
}

// Shared memory: the buffer (T transforms of n) and the direct stages'
// roots.
static size_t lp_smem_bytes(int n, int T, const LpChain& ch) {
  return (size_t)(pad16(n * T) + lp_roots_len(ch)) * sizeof(float2);
}

// Element f = f0, f0 + blockDim.x, ... of T rows of m values: its row t =
// f / m and the place where the in-place chain leaves natural output k =
// f % m of a row (digit k_s of k = k_0 + r_0*k_1 + r_0*r_1*k_2 + ... at
// stride m / (r_0..r_s)).  The digits of k are found once and advanced by
// those of blockDim.x % m with carries; a carry out of the last digit is
// the wrap to the next row.  No division per element and no table: at n =
// 8192 a table of the places took a fifth of a block's shared memory, and
// dividing the digits out per output most of its load phase.
struct PlaceWalk {
  int row, drow;
  int d[kLpMaxStages], inc[kLpMaxStages], r[kLpMaxStages], stride[kLpMaxStages];
  __device__ PlaceWalk(int f0, int m, const LpChain& ch) {
    row = f0 / m;
    drow = (int)blockDim.x / m;
    int k = f0 % m, step = (int)blockDim.x % m, rest = m;
#pragma unroll
    for (int s = 0; s < kLpMaxStages; ++s) {
      r[s] = s < ch.k ? ch.r[s] : 1;
      rest /= r[s];
      stride[s] = rest;
      d[s] = k % r[s];
      k /= r[s];
      inc[s] = step % r[s];
      step /= r[s];
    }
  }
  __device__ int place() const {
    int at = 0;
#pragma unroll
    for (int s = 0; s < kLpMaxStages; ++s) at += d[s] * stride[s];
    return at;
  }
  __device__ void next() {
    int carry = 0;
#pragma unroll
    for (int s = 0; s < kLpMaxStages; ++s) {
      d[s] += inc[s] + carry;
      carry = d[s] >= r[s];
      if (carry) d[s] -= r[s];
    }
    row += drow + carry;
  }
};

static __device__ __forceinline__ void cp_async8(float2* dst, const float2* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}

static __device__ __forceinline__ void cp_async_commit_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Block b holds transforms b*T .. b*T + tn - 1 (tn = T but in the last
// block): load them (cp.async, every copy of the block in flight at once),
// run the chain in place at width tn, store them.  Three blocks an SM but
// in the form for Bluestein lengths up to 512, which needs 128 registers.
template <int MaxM, bool kStamp>
__global__ void __launch_bounds__(kLpThreads, MaxM > 128 ? 2 : 3)
    lanepack_chain_kernel(const float2* __restrict__ x, float2* __restrict__ y, long long batch,
                          int n, int T, LpChain ch, unsigned long long* stamps) {
  extern __shared__ float2 smem[];
  pad_stamp<kStamp>(stamps, 0);
  const long long b0 = (long long)blockIdx.x * T;
  const int tn = (int)min((long long)T, batch - b0);
  float2* buf = smem;
  float2* sroots = smem + pad16(n * T);
  for (int s = 0, off = 0; s < ch.k; ++s) {
    if (ch.bm[s] != 0) continue;
    for (int i = threadIdx.x; i < ch.r[s]; i += blockDim.x) sroots[off + i] = ch.tab[s][i];
    off += ch.r[s];
  }
  // the rows, one contiguous span: f = t*n + i to (i, t)
  const float2* src = x + (size_t)b0 * n;
  const int elems = tn * n, nt = (int)blockDim.x;
  {
    TileWalk w((int)threadIdx.x, n);
    for (int f = threadIdx.x; f < elems; f += nt, w.next())
      cp_async8(buf + swz(w.col * tn + w.row), src + f);
  }
  cp_async_commit_wait();
  __syncthreads();
  pad_stamp<kStamp>(stamps, 1);
  const OuterFold none{nullptr, 0, 1, 1};
  for (int s = 0, lead = 1, rest = n, off = 0; s < ch.k; ++s) {
    const int r = ch.r[s];
    rest /= r;
    const float2* tab = ch.bm[s] != 0 ? ch.tab[s] : sroots + off;
    run_stage_inplace<MaxM>(buf, r, ch.bm[s], lead, rest, tn, tab,
                            s + 1 < ch.k ? ch.tw[s] : nullptr, none);
    __syncthreads();
    lead *= r;
    if (ch.bm[s] == 0) off += r;
  }
  pad_stamp<kStamp>(stamps, 2);
  // y[b0 + t, k] = row place(k), column t
  float2* dst = y + (size_t)b0 * n;
  {
    PlaceWalk w((int)threadIdx.x, n, ch);
    for (int f0 = threadIdx.x; f0 < elems; f0 += kPadIo * nt) {
      float2 v[kPadIo];
#pragma unroll
      for (int u = 0; u < kPadIo; ++u, w.next())
        if (f0 + u * nt < elems) v[u] = buf[swz(w.place() * tn + w.row)];
#pragma unroll
      for (int u = 0; u < kPadIo; ++u)
        if (f0 + u * nt < elems) dst[f0 + u * nt] = v[u];
    }
  }
  pad_stamp<kStamp>(stamps, 3);
}

// The chain describes a length-n transform, every table is there, every
// stage is one the kernel runs (a Bluestein length up to kLpMaxM, a direct
// sum up to kMaxDirectRadix), and the block and the grid fit.
static bool lp_ok(long long batch, int n, int T, int threads, const LpChain& ch) {
  if (threads < 32 || threads > kLpThreads || threads % 32 != 0) return false;
  if (batch <= 0 || T <= 0 || n <= 0 || ch.k < 1 || ch.k > kLpMaxStages)
    return false;
  long long prod = 1;
  for (int s = 0; s < ch.k; ++s) {
    const int r = ch.r[s];
    if (r < 2 || ch.tab[s] == nullptr || (s + 1 < ch.k && ch.tw[s] == nullptr)) return false;
    if (ch.bm[s] != 0 ? !bluestein_ok(r, ch.bm[s], kLpMaxM) : r > kMaxDirectRadix) return false;
    prod *= r;
  }
  if (prod != n || (long long)n * T > 0x7fffffffLL) return false;
  if ((batch + T - 1) / T > 0x7fffffffLL) return false;
  return lp_smem_bytes(n, T, ch) <= kSmemMax;
}

template <int MaxM, bool kStamp>
static cudaError_t launch_chain(const float2* x, float2* y, long long batch, int n, int T,
                                int threads, const LpChain& ch, unsigned long long* stamps,
                                cudaStream_t s) {
  const size_t smem = lp_smem_bytes(n, T, ch);
  cudaError_t err = allow_smem(lanepack_chain_kernel<MaxM, kStamp>, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (batch + T - 1) / T;
  lanepack_chain_kernel<MaxM, kStamp>
      <<<(unsigned)blocks, threads, smem, s>>>(x, y, batch, n, T, ch, stamps);
  return cudaGetLastError();
}

// The form for the chain's longest Bluestein stage: none (MaxM = 0), up to
// 128 points (the radices up to 64; three blocks an SM), up to 512.
template <bool kStamp>
static int chain_fft(const void* x, void* y, long long batch, int n, int T, int threads,
                     const LpChain& ch, unsigned long long* stamps, void* stream) {
  if (!lp_ok(batch, n, T, threads, ch)) return cudaErrorInvalidValue;
  const auto* tx = static_cast<const float2*>(x);
  auto* ty = static_cast<float2*>(y);
  const auto s = static_cast<cudaStream_t>(stream);
  int max_m = 0;
  for (int i = 0; i < ch.k; ++i) max_m = ch.bm[i] > max_m ? ch.bm[i] : max_m;
  if (max_m > 128)
    return launch_chain<kLpMaxM, kStamp>(tx, ty, batch, n, T, threads, ch, stamps, s);
  if (max_m > 0) return launch_chain<128, kStamp>(tx, ty, batch, n, T, threads, ch, stamps, s);
  return launch_chain<0, kStamp>(tx, ty, batch, n, T, threads, ch, stamps, s);
}

static LpChain make_chain(int k, int r0, int r1, int r2, int r3, const void* tab0,
                          const void* tab1, const void* tab2, const void* tab3, const void* tw0,
                          const void* tw1, const void* tw2, int m0, int m1, int m2, int m3) {
  LpChain ch;
  ch.k = k;
  const int r[4] = {r0, r1, r2, r3}, m[4] = {m0, m1, m2, m3};
  const void* tab[4] = {tab0, tab1, tab2, tab3};
  const void* tw[3] = {tw0, tw1, tw2};
  for (int s = 0; s < kLpMaxStages; ++s) {
    ch.r[s] = r[s];
    ch.bm[s] = m[s];
    ch.tab[s] = static_cast<const float2*>(tab[s]);
    if (s < kLpMaxStages - 1) ch.tw[s] = static_cast<const float2*>(tw[s]);
  }
  return ch;
}

// ---- the main path's kernel: n = 4096 as (16, 16, 16) ------------------------

constexpr int kPipeN = 4096;
constexpr int kPipeThreads = 256;  // one radix-16 column a thread
// Shared memory: two buffers and the twiddles (16, 16) w_256^(k*a)
// (stage 1's table, also half of stage 0's) and (16, 16) w_4096^(k*b) (the
// first 16 columns of stage 0's table): 69632 bytes, three blocks an SM.
constexpr int kPipeTw1 = 2 * kPipeN, kPipeTw0 = kPipeTw1 + 256;
constexpr size_t kPipeSmem = (kPipeTw0 + 256) * sizeof(float2);

// w_16^e, e < 8, in the direction sg (+1 forward, -1 inverse): the forward
// roots as immediates (w32), the imaginary part times sg.
static __device__ __forceinline__ float2 w16(int e, float sg) {
  const float2 w = w32(2 * e);
  return make_float2(w.x, sg * w.y);
}

// In-register radix-2 DIF FFT of 16 values, the twiddles as immediates
// (fft_pow2_reg reads them from a roots table): x[bitrev(k)] = X[k].
template <int HALF = 8>
static __device__ __forceinline__ void fft16(float2 (&x)[16], float sg) {
  if constexpr (HALF >= 1) {
#pragma unroll
    for (int blk = 0; blk < 16; blk += 2 * HALF) {
#pragma unroll
      for (int i = 0; i < HALF; ++i) {
        const float2 a = x[blk + i];
        const float2 b = x[blk + i + HALF];
        x[blk + i] = make_float2(a.x + b.x, a.y + b.y);
        const float2 d = make_float2(a.x - b.x, a.y - b.y);
        // w_16^4 = -+i: a swap and two signs, not a complex product (the
        // table's root has a real part of 6e-17, which the product rounds
        // away unless one component is ~1e-17 of the other)
        x[blk + i + HALF] = i == 0                  ? d
                            : i * (8 / HALF) == 4 ? make_float2(sg * d.y, -sg * d.x)
                                                  : cmul(d, w16(i * (8 / HALF), sg));
      }
    }
    fft16<HALF / 2>(x, sg);
  }
}

// Copy one transform into buf (element e at swz(e)) as one cp.async group.
static __device__ __forceinline__ void pipe_load(const float2* __restrict__ src, float2* buf) {
#pragma unroll
  for (int u = 0; u < kPipeN / kPipeThreads; ++u) {
    const int e = (int)threadIdx.x + u * kPipeThreads;
    cp_async8(buf + swz(e), src + e);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// A radix-16 stage over the 256 columns (l, j') of (LEAD, 16, REST), one a
// thread: output k, times tw(o, k, j'), to (k, l, j') of the next stage's
// input, k in front.  Where LEAD > 1 and REST > 1 the outputs go to other
// places than the inputs: every column is read before any is written.
template <int LEAD, int REST, class Src, class Dst, class Tw>
static __device__ __forceinline__ void pipe_stage(const Src& src, const Dst& dst, float sg,
                                                  Tw tw) {
  const int c = (int)threadIdx.x;
  const int l = c / REST, jr = c % REST;
  float2 v[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) v[j] = src.load(l * 16 * REST + j * REST + jr);
  if constexpr (LEAD > 1 && REST > 1) __syncthreads();
  fft16(v, sg);
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    const int k = bitrev<16>(p);
    dst.store(k * kPipeThreads + c, tw(v[p], k, jr));
  }
}

// Phase stamps of the pipelined kernel: per block, its start and that start
// plus the running sums of the time waiting for loads (the tables' load
// included), in stages 0-1, and in stage 2 with the store.
template <bool kStamp>
struct PipeClock {
  unsigned long long start = 0, mark = 0, sum[3] = {0, 0, 0};
  __device__ void begin() {
    if constexpr (kStamp) {
      __syncthreads();
      start = mark = global_timer();
    }
  }
  __device__ void lap(int phase) {
    if constexpr (kStamp) {
      __syncthreads();
      const unsigned long long now = global_timer();
      sum[phase] += now - mark;
      mark = now;
    }
  }
  __device__ void write(unsigned long long* stamps) const {
    if constexpr (kStamp) {
      if (threadIdx.x == 0) {
        unsigned long long* out = stamps + (size_t)blockIdx.x * kPadStamps;
        out[0] = start;
        out[1] = start + sum[0];
        out[2] = out[1] + sum[1];
        out[3] = out[2] + sum[2];
      }
    }
  }
};

// Block g takes transforms g, g + grid, ...: wait for transform b, start
// the copy of b + grid into the other buffer, run the three stages on b.
template <bool kStamp>
__global__ void __launch_bounds__(kPipeThreads, 3)
    lanepack_pipe_kernel(const float2* __restrict__ x, float2* __restrict__ y, long long batch,
                         Stages st, unsigned long long* stamps) {
  extern __shared__ float2 smem[];
  float2* tw1 = smem + kPipeTw1;
  float2* tw0 = smem + kPipeTw0;
  // the direction, from w_16^4 = -+i
  const float sg = -st.roots[0][4].y;
  PipeClock<kStamp> clock;
  clock.begin();
  long long b = blockIdx.x;
  if (b < batch) pipe_load(x + b * kPipeN, smem);
  const int t = (int)threadIdx.x;
  tw1[t] = st.tw[1][t];
  tw0[t] = st.tw[0][(t >> 4) * 256 + (t & 15)];
  const auto tw_none = [](float2 o, int, int) { return o; };
  // stage 0's twiddle w_4096^(k*j'), j' = 16a + b: w_256^(k*a) * w_4096^(k*b)
  const auto tw_0 = [&](float2 o, int k, int jr) {
    return cmul(o, cmul(tw1[k * 16 + (jr >> 4)], tw0[k * 16 + (jr & 15)]));
  };
  const auto tw_1 = [&](float2 o, int k, int jr) { return cmul(o, tw1[k * 16 + jr]); };
  for (int it = 0; b < batch; ++it, b += gridDim.x) {
    const SmemTile cur{smem + (it & 1) * kPipeN};
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // transform b is in cur for every thread, and the other buffer (read by
    // the last transform's stage 2) is free
    __syncthreads();
    clock.lap(0);
    if (b + gridDim.x < batch)
      pipe_load(x + (b + gridDim.x) * kPipeN, smem + ((it + 1) & 1) * kPipeN);
    pipe_stage<1, 256>(cur, cur, sg, tw_0);  // in place: each column its own places
    __syncthreads();
    pipe_stage<16, 16>(cur, cur, sg, tw_1);
    __syncthreads();
    clock.lap(1);
    pipe_stage<256, 1>(cur, GlobalOut<1>{y + b * kPipeN, 1}, sg, tw_none);
    clock.lap(2);
  }
  clock.write(stamps);
}

// The grid: every block the card holds at once, at most one a transform.
static cudaError_t pipe_grid(int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = allow_smem(lanepack_pipe_kernel<false>, kPipeSmem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lanepack_pipe_kernel<false>,
                                                        kPipeThreads, kPipeSmem);
  *blocks = sms * per_sm;
  return err == cudaSuccess && *blocks <= 0 ? cudaErrorInvalidConfiguration : err;
}

template <bool kStamp>
static int pipe_fft(const void* x, void* y, long long batch, const void* roots0,
                    const void* roots1, const void* roots2, const void* tw0, const void* tw1,
                    unsigned long long* stamps, void* stream) {
  const Stages st = make_stages(3, 16, 16, 16, roots0, roots1, roots2, tw0, tw1);
  if (batch <= 0 || !stages_ok(st, kPipeN)) return cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t err = pipe_grid(&grid);
  if (err == cudaSuccess) err = allow_smem(lanepack_pipe_kernel<kStamp>, kPipeSmem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)(batch < grid ? batch : grid);
  lanepack_pipe_kernel<kStamp>
      <<<blocks, kPipeThreads, kPipeSmem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float2*>(x), static_cast<float2*>(y), batch, st, stamps);
  return cudaGetLastError();
}

}  // namespace rf

extern "C" const char* rf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, y: (batch, n) complex64 on the current device; the chain of 1..4
// stages (ops/kernels/lanepack.py chain_args at four slots: a Bluestein
// stage's table in its tab slot, its length m_s, else 0); T transforms a
// block of `threads` (a multiple of 32 up to 256).  Returns a cudaError_t
// code (0 on success); launches on `stream`.
extern "C" int rf_lanepack_chain(const void* x, void* y, long long batch, int n, int T,
                                 int threads, int k,
                                 int r0, int r1, int r2, int r3, const void* tab0,
                                 const void* tab1, const void* tab2, const void* tab3,
                                 const void* tw0, const void* tw1, const void* tw2, int m0,
                                 int m1, int m2, int m3, void* stream) {
  using namespace rf;
  return chain_fft<false>(x, y, batch, n, T, threads,
                          make_chain(k, r0, r1, r2, r3, tab0, tab1, tab2, tab3, tw0, tw1, tw2,
                                     m0, m1, m2, m3),
                          nullptr, stream);
}

// x, y: (batch, 4096) complex64; the chain (16, 16, 16)'s roots and
// twiddles (ops/kernels/lanepack.py stage_tables).
extern "C" int rf_lanepack_pipe(const void* x, void* y, long long batch, const void* roots0,
                                const void* roots1, const void* roots2, const void* tw0,
                                const void* tw1, void* stream) {
  using namespace rf;
  return pipe_fft<false>(x, y, batch, roots0, roots1, roots2, tw0, tw1, nullptr, stream);
}

#ifdef RF_PHASE_STAMPS
// The two kernels through their stamped forms: stamps (blocks, 4) uint64
// nanoseconds of %globaltimer.  Only the library built with
// RF_PHASE_STAMPS has them (tools/torch_phase_times.py).
extern "C" int rf_lanepack_chain_phase_stamps(const void* x, void* y, long long batch, int n,
                                              int T, int threads, int k, int r0, int r1,
                                              int r2, int r3, const void* tab0, const void* tab1,
                                              const void* tab2, const void* tab3,
                                              const void* tw0, const void* tw1, const void* tw2,
                                              int m0, int m1, int m2, int m3, void* stamps,
                                              void* stream) {
  using namespace rf;
  if (stamps == nullptr) return cudaErrorInvalidValue;
  return chain_fft<true>(x, y, batch, n, T, threads,
                         make_chain(k, r0, r1, r2, r3, tab0, tab1, tab2, tab3, tw0, tw1, tw2,
                                    m0, m1, m2, m3),
                         static_cast<unsigned long long*>(stamps), stream);
}

extern "C" int rf_lanepack_pipe_phase_stamps(const void* x, void* y, long long batch,
                                             const void* roots0, const void* roots1,
                                             const void* roots2, const void* tw0,
                                             const void* tw1, void* stamps, void* stream) {
  using namespace rf;
  if (stamps == nullptr) return cudaErrorInvalidValue;
  return pipe_fft<true>(x, y, batch, roots0, roots1, roots2, tw0, tw1,
                        static_cast<unsigned long long*>(stamps), stream);
}
#endif
