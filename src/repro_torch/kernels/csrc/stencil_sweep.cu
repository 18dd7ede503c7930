// T valid-mode stencil steps in one kernel on Hopper (sm_90a): in-kernel
// temporal blocking with register-blocked tap runs over shared-memory
// intermediates, reading a periodic halo through wrapped indices.
//
// Replaces the Pallas TPU kernel src/repro/kernels/stencil_mxu.py
// ::sweep_pallas_call (body _make_sweep_kernel).  There each grid instance
// owns one output tile plus its T*r-deep haloed slab, runs T steps of the
// base operator on it (each step's Toeplitz set sized to the shrinking live
// extent, each step rescaled by the field/mask sub-slice at offset (s+1)*r),
// keeps the intermediates in VMEM scratch (a ping-pong pair, or one buffer
// under scratch="single"), and writes only the final state.
//
// What bounds it on this card: one T*r-haloed read and one write per chunk
// of T steps, with T base steps of work (2*taps flops per live output per
// step, ~10-20 flop per byte moved on the paper's stencils at T = 3-4):
// device-memory bytes in principle, but the per-tap shared-memory traffic
// of a naive design (one dependent table load, one shared load and one FMA
// per tap, this kernel's first design) made it ~15x slower than that.  The
// design, after the step kernel's (csrc/stencil_step.cu):
//   * one CUDA block owns one output tile of one state (blockIdx.y is the
//     state of a batch) and keeps ONE frame for all steps: step s reads the
//     live window at slab offset s*r and writes its output at offset
//     (s+1)*r, so every tap has the same offset relative to its output at
//     every step and the live region shrinks by r per side;
//   * the slab load uses cp.async: 16-byte copies where the input's rows
//     are 16-byte aligned (f32, last extents multiples of 4), 4-byte copies
//     otherwise; bf16 converts to f32 on the way in with plain loads.  The
//     slab row is stored `lead` words into its pitch so that storage
//     columns and input columns agree modulo 4;
//   * boundary "periodic" (wrap mode): the input is the UNPADDED state and
//     each slab element is read at its index modulo the extent along every
//     axis, so no padded copy of the state is ever made.  Rows and 16-byte
//     units that lie inside the state take the straight path; only the
//     units that straddle an edge compute a modulo.  Halo mode (valid, and
//     zero through the engine's strip splice) reads a haloed input as-is;
//   * output extents need not be multiples of the tile: the last tiles'
//     slab rows past the input are wrapped (periodic) or zero-filled, and
//     their outputs past the state are never stored;
//   * tap runs in registers: the host groups the taps into runs of up to
//     kMaxRun consecutive taps along the last axis (stencil_mxu.tap_runs);
//     the run table (4-word headers: offset relative to the output, width,
//     first coefficient, offset mod 4; then the coefficients) is built once
//     per plan and device and copied into shared memory by each block.
//     A thread computes kV consecutive outputs along the last axis: per run
//     it loads the kV + w - 1 slab values it needs as aligned 16-byte shared
//     loads and does kV * w FMAs;
//   * work items of kTy rows x kTx chunks of kV outputs are dealt to warps
//     in turn (a warp is kTy = 8 rows of kTx = 4 chunks; the row pitch is
//     4 mod 8 words, so each quarter-warp's 16-byte loads cover all 32
//     banks).  The item index is advanced by a constant stride in mixed
//     radix (plane, row block, chunk group): the stride's digits are found
//     once per step, so no output pays a divide or modulo;
//   * scratch "pingpong": two slab buffers, step s reads one and writes the
//     other, one barrier between steps;
//   * scratch "single": one buffer.  Each warp computes its (at most
//     kSlots) items of a step into registers, the block syncs, then writes
//     them back in place and syncs again, so no read of a step sees a value
//     of the same step.  matrixization.sweep_feasible prices the slots;
//   * the last step scales by the aux operands and stores straight to
//     device memory in the state's type, 16-byte stores where rows allow.
// Per output the sum runs over the runs in order and over each run's taps
// in order (the plan's row order, which stencil_mxu.sweep_plain follows
// too), then the field, then the mask; f32 throughout, one cast at the end.
//
// 2-D launches walk axis 0 (stencil_sweep_kernel_walk): one block streams
// a strip of `walk` tiles down the rows (matrixization.sweep_walk), and
// only 3-D launches keep the slab.  What bounds the slab on this card, by
// variants at the star2d_r2 cell's launch (32768^2, T = 3, 64x128; PERF.md
// §6): 10.4 ms, of which its loads and stores alone take 5.4 and its taps
// and stores alone 8.3.  Each block waits for its whole 76-row slab before
// any tap, two blocks fit an SM, and the taps are latency-bound: a run's
// dispatch (its header, a switch on its width and offset) precedes its
// loads and FMAs, for every run of every item.  What the walk does:
//   * bytes and work: each row of each level is loaded or computed once
//     along the walk; only the strip's 2 T r halo columns are re-read and
//     recomputed (9.22 GB a launch at k = 4 against 9.89);
//   * schedule: rings of rows instead of a slab (108 rows of the slab's
//     pitch at that tile, 67 KB: three blocks an SM).  At step j level L
//     computes its j - L + 1-th group of q rows, so the levels of a step
//     are independent: one barrier a step, and the next group of input
//     rows loads (cp.async) while the step computes;
//   * taps without dispatch: the table is laid out by position in the
//     (2r + 1)^2 square, and a thread reads its output's window row by row
//     into registers and applies each position's taps with compile-time
//     register indices; a row holding only the output's own column (a
//     star's) loads just that column, a full row tests no position.
// Measured there: 7.2 ms a launch (loads and stores alone about 5.0, taps
// and stores alone 6.3; they overlap).
//
// A 2-D problem is passed as 3-D with a leading extent of 1 and no halo on
// it.  The aux operands are slab-aligned: extents ceil(o / b) * b + 2*T*r
// per axis, so every tile's slab window lies inside them.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;  // == matrixization.SWEEP_THREADS
constexpr int kSlots = 6;      // == matrixization.SINGLE_SLOTS (items a warp parks)
constexpr int kV = 8;          // == matrixization.STEP_V
constexpr int kMaxRun = 9;     // == matrixization.STEP_MAX_RUN
constexpr int kTx = 4;         // == matrixization.SWEEP_ITEM_CHUNKS
constexpr int kTy = 8;         // == matrixization.SWEEP_ITEM_ROWS
constexpr int kWarps = kThreads / 32;
static_assert((kWarps & (kWarps - 1)) == 0, "warps a block: a power of two");
static_assert(kTx * kTy == 32, "a work item is one warp");
// the axis-0 walk (2-D): rows a level computes a step of the walk, and
// groups of that many input rows loading while a step computes
constexpr int kWalkRows = 16;  // == matrixization.SWEEP_WALK_ROWS
constexpr int kWalkAhead = 1;  // == matrixization.SWEEP_WALK_AHEAD
constexpr int kWalkMaxOrder = 4;  // == matrixization.SWEEP_WALK_MAX_ORDER

struct Geom {
  int o0, o1, o2;          // output extents (the state's)
  int b0, b1, b2;          // tile
  int h0, h1, h2;          // base radius per axis
  int s0, s1, s2;          // slab extents: b + 2 * steps * h
  int n0, n1, n2;          // input extents: o (wrap) or o + 2 * steps * h
  int a1, a2;              // aux extents of axes 1 and 2
  int pitch;               // slab row pitch, f32 words, 4 (mod 8)
  int lead;                // storage column of slab column 0
  int tiles1, tiles2;
  int slab_words;          // one slab buffer, rounded up to 4 words
  int steps;
  int wrap;                // input is the unpadded periodic state
  int aligned;             // 16-byte copies (f32 only)
  int vec;                 // 16-byte output stores
  int walk;                // tiles a block walks along the rows (0: one slab a block)
  int walks1;              // walks along the rows of a strip
  int ring0, ring1;        // rows of the walk's input ring and of each step's ring
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// every group but the kWalkAhead - 1 committed last
__device__ __forceinline__ void cp_async_wait_ahead() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kWalkAhead - 1) : "memory");
}

// Input index of coordinate c along an axis of n points: c itself inside,
// c modulo n in wrap mode, -1 (a zero) past a haloed input's end.
__device__ __forceinline__ int source_index(int c, int n, int wrap) {
  if (c >= 0 && c < n) return c;
  if (!wrap) return -1;
  c %= n;
  return c < 0 ? c + n : c;
}

// One slab row into its storage: `dst` is the row's storage column 0, `src`
// the input row it reads (null past a haloed input's end: zeros), org2
// the input column of slab column 0 (wrapped).  A row is `per_row` units
// of 4 words when 16-byte copies are on (`wide`), else of 1; this lane
// copies units sub, sub + lanes, ...
template <typename T>
__device__ __forceinline__ void copy_row(float* dst, const T* __restrict__ src, const Geom& g,
                                         int org2, int sub, int lanes, int per_row, bool wide) {
  const int unit = wide ? 4 : 1;
  if (src == nullptr) {
    for (int c = sub; c < per_row * unit; c += lanes) dst[(wide ? 0 : g.lead) + c] = 0.f;
    return;
  }
  if (!wide) dst += g.lead;
  for (int u = sub; u < per_row; u += lanes) {
    // input column of the unit's first word
    const int c0 = org2 - (wide ? g.lead : 0) + unit * u;
    if constexpr (sizeof(T) == 4) {
      const float* fsrc = reinterpret_cast<const float*>(src);
      if (wide && c0 >= 0 && c0 + 4 <= g.n2) {
        cp_async16(dst + 4 * u, fsrc + c0);
        continue;
      }
      for (int j = 0; j < unit; ++j) {
        const int c = source_index(c0 + j, g.n2, g.wrap);
        if (c >= 0) cp_async4(dst + unit * u + j, fsrc + c);
        else dst[unit * u + j] = 0.f;
      }
    } else {
      const int c = source_index(c0, g.n2, g.wrap);
      dst[u] = c >= 0 ? to_f32(src[c]) : 0.f;
    }
  }
}

// A row's copy spread over the fewest lanes (a power of two, 2^lg): a
// warp handles 32 >> lg rows at a time.
struct RowLanes {
  int per_row, lg, sub, first_row, row_step;
  bool wide;
  template <typename T>
  __device__ __forceinline__ void init(const Geom& g) {
    wide = sizeof(T) == 4 && g.aligned;
    per_row = wide ? (g.lead + g.s2 + 3) / 4 : g.s2;
    lg = 0;
    while (lg < 5 && (1 << lg) < per_row) ++lg;
    const int lane = threadIdx.x & 31;
    sub = lane & ((1 << lg) - 1);
    first_row = ((threadIdx.x >> 5) << (5 - lg)) + (lane >> lg);
    row_step = (kThreads / 32) << (5 - lg);
  }
};

// Start (f32: cp.async) or do (bf16: plain loads) the copy of the tile's
// slab at origin (g0, g1, g2) into buf.  Slab column i of a row sits at
// storage column lead + i, and reads input column org2 + i (wrapped).
template <typename T>
__device__ __forceinline__ void load_slab(float* buf, const T* __restrict__ xs,
                                          const Geom& g, int g0, int g1, int g2) {
  const int w0 = g.steps * g.h0, w1 = g.steps * g.h1, w2 = g.steps * g.h2;
  const int org0 = g.wrap ? g0 - w0 : g0;
  const int org1 = g.wrap ? g1 - w1 : g1;
  const int org2 = g.wrap ? g2 - w2 : g2;
  RowLanes rl;
  rl.init<T>(g);
  int i0 = 0, i1 = rl.first_row;
  while (i1 >= g.s1) { i1 -= g.s1; ++i0; }
  while (i0 < g.s0) {
    const int r0 = source_index(org0 + i0, g.n0, g.wrap);
    const int r1 = source_index(org1 + i1, g.n1, g.wrap);
    const T* src = (r0 < 0 || r1 < 0) ? nullptr : xs + ((long long)r0 * g.n1 + r1) * g.n2;
    copy_row<T>(buf + (i0 * g.s1 + i1) * g.pitch, src, g, org2, rl.sub, 1 << rl.lg, rl.per_row,
                rl.wide);
    i1 += rl.row_step;
    while (i1 >= g.s1) { i1 -= g.s1; ++i0; }
  }
}

// One run of W consecutive taps applied to every item of a batch: the
// run's coefficients come in once, then for each item (its first output at
// slab word base[j], the run's first value `off` words further and SH words
// past a 16-byte boundary) the kV + W - 1 values it needs as N aligned
// 16-byte loads and kV * W FMAs, taps in order for every output.  The items
// are independent, so their loads overlap each other's FMAs.
template <int W, int SH>
__device__ __forceinline__ void apply_run(const float* slab, const int (&base)[kSlots],
                                          int off, const float* c,
                                          float (&acc)[kSlots][kV]) {
  constexpr int N = (SH + kV + W - 1 + 3) / 4;
  float ck[W];
#pragma unroll
  for (int k = 0; k < W; ++k) ck[k] = c[k];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    float v[4 * N];
    const float4* p4 = reinterpret_cast<const float4*>(slab + base[j] + off - SH);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float4 f = p4[n];
      v[4 * n] = f.x;
      v[4 * n + 1] = f.y;
      v[4 * n + 2] = f.z;
      v[4 * n + 3] = f.w;
    }
#pragma unroll
    for (int k = 0; k < W; ++k)
#pragma unroll
      for (int i = 0; i < kV; ++i) acc[j][i] = fmaf(ck[k], v[SH + i + k], acc[j][i]);
  }
}

template <int W>
__device__ __forceinline__ void apply_run(const float* slab, const int (&base)[kSlots], int off,
                                          const float* c, int sh, float (&acc)[kSlots][kV]) {
  switch (sh) {
    case 0: apply_run<W, 0>(slab, base, off, c, acc); break;
    case 1: apply_run<W, 1>(slab, base, off, c, acc); break;
    case 2: apply_run<W, 2>(slab, base, off, c, acc); break;
    default: apply_run<W, 3>(slab, base, off, c, acc); break;
  }
}

// The tap sums of a batch of kSlots items (item j's kV outputs start at slab
// word base[j]; `sh` = the live row's first output column modulo 4), over
// every run in table order.
__device__ __forceinline__ void tap_sums(const float* slab, const int (&base)[kSlots], int sh,
                                         const int4* runs, int n_runs, const float* coefs,
                                         float (&acc)[kSlots][kV]) {
#pragma unroll
  for (int j = 0; j < kSlots; ++j)
#pragma unroll
    for (int i = 0; i < kV; ++i) acc[j][i] = 0.f;
  for (int k = 0; k < n_runs; ++k) {
    const int4 run = runs[k];  // (offset from the output, width, first coefficient, offset % 4)
    const float* cw = coefs + run.z;
    const int s = (sh + run.w) & 3;
    switch (run.y) {
      case 1: apply_run<1>(slab, base, run.x, cw, s, acc); break;
      case 2: apply_run<2>(slab, base, run.x, cw, s, acc); break;
      case 3: apply_run<3>(slab, base, run.x, cw, s, acc); break;
      case 4: apply_run<4>(slab, base, run.x, cw, s, acc); break;
      case 5: apply_run<5>(slab, base, run.x, cw, s, acc); break;
      case 6: apply_run<6>(slab, base, run.x, cw, s, acc); break;
      case 7: apply_run<7>(slab, base, run.x, cw, s, acc); break;
      case 8: apply_run<8>(slab, base, run.x, cw, s, acc); break;
      default: apply_run<kMaxRun>(slab, base, run.x, cw, s, acc); break;
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_chunk(T* dst, const float (&acc)[kV], int n_valid,
                                            bool vec);

template <>
__device__ __forceinline__ void store_chunk<float>(float* dst, const float (&acc)[kV],
                                                   int n_valid, bool vec) {
  if (vec && n_valid == kV) {
#pragma unroll
    for (int i = 0; i < kV; i += 4)
      *reinterpret_cast<float4*>(dst + i) = make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < kV; ++i)
      if (i < n_valid) dst[i] = acc[i];
  }
}

template <>
__device__ __forceinline__ void store_chunk<__nv_bfloat16>(__nv_bfloat16* dst,
                                                           const float (&acc)[kV],
                                                           int n_valid, bool vec) {
  if (vec && n_valid == kV) {
    uint32_t w[kV / 2];
#pragma unroll
    for (int i = 0; i < kV / 2; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
#pragma unroll
    for (int i = 0; i < kV / 2; i += 4)
      *reinterpret_cast<uint4*>(dst + 2 * i) = make_uint4(w[i], w[i + 1], w[i + 2], w[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < kV; ++i)
      if (i < n_valid) dst[i] = __float2bfloat16(acc[i]);
  }
}

// A step's work items in mixed radix (plane p0, row block rb, chunk group
// cg), walked by one warp from item `warp` with stride kWarps.
struct Items {
  int p0, rb, cg;          // the current item
  int dp0, drb, dcg;       // the stride's digits
  int nrb, ncg;
  __device__ __forceinline__ void start(int warp, int n_rb, int n_cg) {
    nrb = n_rb;
    ncg = n_cg;
    cg = warp % ncg;
    rb = (warp / ncg) % nrb;
    p0 = warp / ncg / nrb;
    dcg = kWarps % ncg;
    drb = (kWarps / ncg) % nrb;
    dp0 = kWarps / ncg / nrb;
  }
  __device__ __forceinline__ void next() {
    cg += dcg;
    int carry = cg >= ncg;
    if (carry) cg -= ncg;
    rb += drb + carry;
    carry = rb >= nrb;
    if (carry) rb -= nrb;
    p0 += dp0 + carry;
  }
};

template <typename T, bool kSingle>
__global__ void __launch_bounds__(kThreads, 2) stencil_sweep_kernel(
    const T* __restrict__ x, T* __restrict__ out, const float* __restrict__ aux0,
    const float* __restrict__ aux1, int n_aux, const int* __restrict__ table, int n_runs,
    int n_taps, Geom g) {
  extern __shared__ __align__(16) float smem[];
  float* bufs[2] = {smem, kSingle ? smem : smem + g.slab_words};
  int4* runs = reinterpret_cast<int4*>(smem + (kSingle ? 1 : 2) * g.slab_words);
  const float* coefs = reinterpret_cast<const float*>(runs + n_runs);
  {
    int* tbl = reinterpret_cast<int*>(runs);
    for (int i = threadIdx.x; i < 4 * n_runs + n_taps; i += kThreads) tbl[i] = __ldg(table + i);
  }
  const int tile = blockIdx.x;
  const int g2 = (tile % g.tiles2) * g.b2;
  const int g1 = ((tile / g.tiles2) % g.tiles1) * g.b1;
  const int g0 = (tile / (g.tiles2 * g.tiles1)) * g.b0;
  const long long x_state = (long long)g.n0 * g.n1 * g.n2;
  const long long o_state = (long long)g.o0 * g.o1 * g.o2;
  const T* xs = x + (long long)blockIdx.y * x_state;
  T* os = out + (long long)blockIdx.y * o_state;

  load_slab<T>(bufs[0], xs, g, g0, g1, g2);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lx = lane % kTx, ly = lane / kTx;
  const bool vec = g.vec != 0;
  for (int s = 0; s < g.steps; ++s) {
    const float* src = bufs[s & 1];
    float* dst = bufs[(s + 1) & 1];
    const bool last = s == g.steps - 1;
    // live output extents of step s and the slab position of their origin
    const int k = g.steps - 1 - s;
    const int e0 = g.b0 + 2 * k * g.h0, e1 = g.b1 + 2 * k * g.h1, e2 = g.b2 + 2 * k * g.h2;
    const int q0 = (s + 1) * g.h0, q1 = (s + 1) * g.h1, q2 = (s + 1) * g.h2;
    const int col0 = g.lead + q2;  // storage column of live column 0
    const int sh = col0 & 3;       // chunks start kV-aligned past col0
    const int nch = (e2 + kV - 1) / kV;
    const int origin = (q0 * g.s1 + q1) * g.pitch + col0;  // a live output's word
    Items it;
    it.start(warp, (e1 + kTy - 1) / kTy, (nch + kTx - 1) / kTx);

    // The warp's next kSlots items: their tap sums into acc.  An item past
    // the live extent computes at a live position and is never stored.
    auto compute = [&](float (&acc)[kSlots][kV]) {
      int base[kSlots];
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        const int p1 = it.rb * kTy + ly, c = it.cg * kTx + lx;
        base[j] = (it.p0 < e0 && p1 < e1 && c < nch)
                      ? ((q0 + it.p0) * g.s1 + (q1 + p1)) * g.pitch + col0 + c * kV
                      : origin;
        it.next();
      }
      tap_sums(src, base, sh, runs, n_runs, coefs, acc);
    };
    // The same items from `at`: field and mask, then the store (last step,
    // to device memory) or the write-back into the slab.
    auto finish = [&](Items at, float (&acc)[kSlots][kV]) {
#pragma unroll
      for (int j = 0; j < kSlots; ++j, at.next()) {
        const int p0 = at.p0, p1 = at.rb * kTy + ly, c = at.cg * kTx + lx;
        if (p0 >= e0 || p1 >= e1 || c >= nch) continue;
        int n_valid = min(kV, e2 - c * kV);
        if (last) {
          if (g0 + p0 >= g.o0 || g1 + p1 >= g.o1) continue;
          n_valid = min(n_valid, g.o2 - g2 - c * kV);
        }
        if (n_aux > 0) {
          const long long a = ((long long)(g0 + q0 + p0) * g.a1 + (g1 + q1 + p1)) * g.a2 +
                              (g2 + q2 + c * kV);
#pragma unroll
          for (int i = 0; i < kV; ++i)
            if (i < n_valid) {
              acc[j][i] *= __ldg(aux0 + a + i);
              if (n_aux > 1) acc[j][i] *= __ldg(aux1 + a + i);
            }
        }
        if (last) {
          store_chunk<T>(os + ((long long)(g0 + p0) * g.o1 + (g1 + p1)) * g.o2 + g2 + c * kV,
                         acc[j], n_valid, vec);
        } else {
          // scalar stores: 16-byte ones where the column allows measured
          // no faster on the card (PERF.md §6)
          float* d = dst + ((q0 + p0) * g.s1 + (q1 + p1)) * g.pitch + col0 + c * kV;
#pragma unroll
          for (int i = 0; i < kV; ++i)
            if (i < n_valid) d[i] = acc[j][i];
        }
      }
    };

    float acc[kSlots][kV];
    if (kSingle && !last) {
      // one batch (the host guarantees at most kSlots items a warp):
      // every read of this step is done before any write-back
      const Items first = it;
      compute(acc);
      __syncthreads();
      finish(first, acc);
    } else {
      while (it.p0 < e0) {
        const Items first = it;
        compute(acc);
        finish(first, acc);
      }
    }
    if (!last) __syncthreads();
  }
}

// N aligned 16-byte shared loads from p into v.
template <int N>
__device__ __forceinline__ void load_words(const float* p, float (&v)[4 * N]) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const float4 f = p4[n];
    v[4 * n] = f.x;
    v[4 * n + 1] = f.y;
    v[4 * n + 2] = f.z;
    v[4 * n + 3] = f.w;
  }
}

// n mod d for 0 <= n < 2^16 by a multiply: m = ceil(2^32 / d), d < 2^16.
struct SmallMod {
  unsigned d, m;
  __device__ __forceinline__ void init(int div) {
    d = div;
    m = 0xffffffffu / d + 1;
  }
  __device__ __forceinline__ int operator()(int n) const {
    return n - (int)(__umulhi((unsigned)n, m) * d);
  }
};

// The taps of one window row for one thread's kV outputs (the walk): the
// row's values from p (16-byte aligned, SH words before the column R left
// of the first output) into registers, then each position pos of the
// row's 2R + 1 whose bit is set in `mask`, in order: kV FMAs with its
// coefficient c[at + pos] (c: registers or shared memory).  Positions are
// compile-time, so every value sits in a register.  A row that holds only
// the output's own column (a star's) loads just that column's kV values,
// and a full row (a box's) tests no position.
template <int R, int SH, typename C>
__device__ __forceinline__ void row_taps(const float* p, unsigned mask, const C& c, int at,
                                         float (&acc)[kV]) {
  constexpr unsigned kFull = (1u << (2 * R + 1)) - 1, kCenter = 1u << R;
  if (mask == 0) return;
  if (mask == kCenter) {
    // the kV values from the 16-byte boundary at or before column R
    constexpr int S = (SH + R) & 3, B = SH + R - S, N = (S + kV + 3) / 4;
    float v[4 * N];
    load_words<N>(p + B, v);
    const float ck = c[at + R];
#pragma unroll
    for (int i = 0; i < kV; ++i) acc[i] = fmaf(ck, v[S + i], acc[i]);
    return;
  }
  constexpr int N = (SH + kV + 2 * R + 3) / 4;
  float v[4 * N];
  load_words<N>(p, v);
  if (mask == kFull) {
#pragma unroll
    for (int pos = 0; pos <= 2 * R; ++pos) {
      const float ck = c[at + pos];
#pragma unroll
      for (int i = 0; i < kV; ++i) acc[i] = fmaf(ck, v[SH + pos + i], acc[i]);
    }
    return;
  }
#pragma unroll
  for (int pos = 0; pos <= 2 * R; ++pos) {
    if (mask & (1u << pos)) {
      const float ck = c[at + pos];
#pragma unroll
      for (int i = 0; i < kV; ++i) acc[i] = fmaf(ck, v[SH + pos + i], acc[i]);
    }
  }
}

// The axis-0 walk of a 2-D sweep: one block a strip of b2 output columns
// (blockIdx.x: walk, then strip), walking g.walk tiles down its rows.
// Level 0 is the input and level L the state after L steps; level L's
// local row p is row g1 - (T - L) R + p of the state, so it reads the
// level-(L-1) rows p .. p + 2R.  Level L's group G is its rows
// [hi(L, G - 1), hi(L, G)), hi(L, G) = (G + 1) q + 2 (T - L) R clipped to
// [0, len + 2 (T - L) R]: up to q rows, which read exactly the level
// below's groups up to G.  At step j of the walk every level L computes
// its group j - L + 1, from rows the level below computed at earlier
// steps, so a step's levels are independent: one barrier a step, and the
// warps deal the items of all levels among them.  Input row p sits in
// slot p mod ring0 of the input ring (the 2R + q rows a step reads and
// kWalkAhead groups of q loading); level-L row p (0 < L < T) in slot p mod
// ring1 of level L's ring (the 2R + q rows level L + 1 reads and the q rows
// level L writes at the same step).
// The taps: the slab path's table sums each output's runs in order, taps
// in order: its rows in ascending order, each row's taps by ascending
// column, at most one tap a position (stencil_mxu.sweep_walk_of walks no
// plan with two).  Each block first lays the table out by position (a mask
// of each row's taps in the 2R + 1 square, and their coefficients), and a
// thread then reads its output's window row by row and applies each
// position's tap from registers, in that same order: every output sums
// the same taps in the same order on the same values as on the slab path,
// bit for bit, with no dispatch on a run's width or offset.  Ring L > 0
// stores slab column X at storage column lead_of(L) + X, so that at every
// level a window row starts SH = lead (mod 4) words past a 16-byte
// boundary, as in the input ring.
// At most 64 registers a thread (left alone, ptxas chose 48 and spilled:
// 7.7 ms a launch at the star2d_r2 cell, against 7.2).
template <typename T, int R, int SH>
__global__ void __launch_bounds__(kThreads, 4) stencil_sweep_kernel_walk(
    const T* __restrict__ x, T* __restrict__ out, const float* __restrict__ aux0,
    const float* __restrict__ aux1, int n_aux, const int* __restrict__ table, int n_runs,
    int n_taps, Geom g) {
  extern __shared__ __align__(16) float smem[];
  constexpr int P = 2 * R + 1;
  unsigned* masks = reinterpret_cast<unsigned*>(smem + g.slab_words);
  float* cdense = smem + g.slab_words + P;  // coefficients by position
  const int steps = g.steps, q = kWalkRows;
  const int w = blockIdx.x / g.tiles2;
  const int g2 = (blockIdx.x - w * g.tiles2) * g.b2;
  const int g1 = w * g.walk * g.b1;  // the walk's first output row
  // the rows of its whole tiles (those past the state are computed, never
  // stored), and the input rows they read
  const int len = min(g.walk * g.b1, g.tiles1 * g.b1 - g1);
  const int n_in = len + 2 * steps * R;
  const T* xs = x + (long long)blockIdx.y * ((long long)g.n1 * g.n2);
  T* os = out + (long long)blockIdx.y * ((long long)g.o1 * g.o2);
  const int org1 = g.wrap ? g1 - steps * R : g1;
  const int org2 = g.wrap ? g2 - steps * R : g2;
  RowLanes rl;
  rl.init<T>(g);
  SmallMod mod0, mod1;  // slots of the input ring and of the step rings
  mod0.init(g.ring0);
  mod1.init(g.ring1);
  // input rows [p, p + n) of the walk into their slots (f32: start the copies)
  auto load = [&](int p, int n) {
    n = min(n, n_in - p);
    for (int i = rl.first_row; i < n; i += rl.row_step) {
      const int r1 = source_index(org1 + p + i, g.n1, g.wrap);
      copy_row<T>(smem + mod0(p + i) * g.pitch, r1 < 0 ? nullptr : xs + (long long)r1 * g.n2,
                  g, org2, rl.sub, 1 << rl.lg, rl.per_row, rl.wide);
    }
  };
  auto hi = [&](int level, int j) {
    const int extra = 2 * (steps - level) * R;
    return max(0, min((j + 1) * q + extra, len + extra));
  };
  // the first step at which level 1 computes a row, and the step past the
  // last step of level T
  const int j0 = -((2 * (steps - 1) * R + q - 1) / q);
  const int j_end = (len + q - 1) / q + steps - 1;
  // input group G is the rows [hi(0, G - 1), hi(0, G)), group j0 all rows
  // before hi(0, j0): the first kWalkAhead groups load before the walk
  auto load_group = [&](int G) {
    const int from = G == j0 ? 0 : hi(0, G - 1);
    load(from, hi(0, G) - from);
    cp_async_commit();
  };
  for (int a = 0; a < kWalkAhead; ++a) load_group(j0 + a);

  // the table by position, while the first rows load: run k holds the
  // coefficients run.z, ... of row dr's columns dc, dc + 1, ...
  for (int i = threadIdx.x; i < P; i += kThreads) masks[i] = 0;
  for (int i = threadIdx.x; i < P * P; i += kThreads) cdense[i] = 0.f;
  __syncthreads();
  for (int k = threadIdx.x; k < n_runs; k += kThreads) {
    const int4 run = __ldg(reinterpret_cast<const int4*>(table) + k);
    const int dr = (run.x + R * g.pitch + (g.pitch >> 1)) / g.pitch - R;
    const int dc = run.x - dr * g.pitch;
    for (int t = 0; t < run.y; ++t) {
      cdense[(dr + R) * P + dc + R + t] = __int_as_float(__ldg(table + 4 * n_runs + run.z + t));
      atomicOr(masks + dr + R, 1u << (dc + R + t));
    }
  }
  __syncthreads();
  unsigned row_mask[P];
#pragma unroll
  for (int d = 0; d < P; ++d) row_mask[d] = masks[d];
  // the coefficients in registers up to order 2, else read from shared memory
  float creg[R <= 2 ? P * P : 1];
  if constexpr (R <= 2) {
#pragma unroll
    for (int i = 0; i < P * P; ++i) creg[i] = cdense[i];
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lx = lane % kTx, ly = lane / kTx;
  const bool vec = g.vec != 0;
  auto lead_of = [&](int ring) { return (g.lead - ring * R) & 3; };
  // level `level`'s rows [lo, top): items of kTy rows x kTx chunks, dealt
  // to the warps in turn from item `first` on; a thread computes one chunk
  // of one row (a row or chunk past the level computes at row lo, chunk 0,
  // and is never stored).  The last level scales and stores to device
  // memory, the others into their ring.  Returns the warp's first item of
  // the next level.
  auto compute = [&](int level, int lo, int top, int first) {
    const int e2 = g.b2 + 2 * (steps - level) * R;  // live columns
    const int nch = (e2 + kV - 1) / kV;
    const int ncg = (nch + kTx - 1) / kTx;
    const int rows = top - lo;
    const int n_items = (rows + kTy - 1) / kTy * ncg;
    const bool last = level == steps;
    const int src_ring = level == 1 ? g.ring0 : g.ring1;
    const float* src = smem + (level == 1 ? 0 : g.ring0 + (level - 2) * g.ring1) * g.pitch;
    // storage column of chunk 0's window, 16-byte aligned
    const int col = lead_of(level - 1) + (level - 1) * R - SH;
    const int src_lo = level == 1 ? mod0(lo) : mod1(lo);  // slot of row lo's first window row
    const int dst_lo = mod1(lo);
    int rb = 0, cg = first;
    while (cg >= ncg) { cg -= ncg; ++rb; }
    for (int item = first; item < n_items; item += kWarps) {
      const int row = rb * kTy + ly, c = cg * kTx + lx;
      const bool live = row < rows && c < nch;
      int slot = src_lo + (live ? row : 0);
      if (slot >= src_ring) slot -= src_ring;
      const float* base = src + col + (live ? c : 0) * kV;
      float acc[kV];
#pragma unroll
      for (int i = 0; i < kV; ++i) acc[i] = 0.f;
#pragma unroll
      for (int d = 0; d < P; ++d) {
        if constexpr (R <= 2) {
          row_taps<R, SH>(base + slot * g.pitch, row_mask[d], creg, d * P, acc);
        } else {
          row_taps<R, SH>(base + slot * g.pitch, row_mask[d], cdense, d * P, acc);
        }
        if (++slot == src_ring) slot = 0;
      }
      cg += kWarps;
      while (cg >= ncg) { cg -= ncg; ++rb; }
      if (!live) continue;
      const int pr = lo + row;  // the level's local row
      int n_valid = min(kV, e2 - c * kV);
      if (last) n_valid = (g1 + pr < g.o1) ? min(n_valid, g.o2 - g2 - c * kV) : 0;
      if (n_aux > 0) {
        const long long a = (long long)(g1 + level * R + pr) * g.a2 + (g2 + level * R + c * kV);
#pragma unroll
        for (int i = 0; i < kV; ++i)
          if (i < n_valid) {
            acc[i] *= __ldg(aux0 + a + i);
            if (n_aux > 1) acc[i] *= __ldg(aux1 + a + i);
          }
      }
      if (last) {
        if (n_valid > 0)
          store_chunk<T>(os + (long long)(g1 + pr) * g.o2 + g2 + c * kV, acc, n_valid, vec);
      } else {
        int dst = dst_lo + row;
        if (dst >= g.ring1) dst -= g.ring1;
        float* d = smem + (g.ring0 + (level - 1) * g.ring1 + dst) * g.pitch + lead_of(level) +
                   level * R + c * kV;
#pragma unroll
        for (int i = 0; i < kV; ++i)
          if (i < n_valid) d[i] = acc[i];
      }
    }
    return (first - n_items) & (kWarps - 1);
  };

  for (int j = j0; j < j_end; ++j) {
    cp_async_wait_ahead();  // input group j has landed
    // and every row of step j - 1: the input rows step j - 1 read and step
    // j does not are free, and group j + kWalkAhead goes there
    __syncthreads();
    load_group(j + kWalkAhead);
    for (int level = 1, first = warp; level <= steps; ++level) {
      const int G = j - level + 1;
      const int lo = hi(level, G - 1), top = hi(level, G);
      if (top > lo) first = compute(level, lo, top, first);
    }
  }
}

template <typename T, bool kSingle>
cudaError_t launch(const void* x, void* out, const float* aux0, const float* aux1,
                   int n_aux, const int* table, int n_taps, int batch, const Geom& g,
                   int n_runs, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(kSingle ? 1 : 2) * g.slab_words + 4 * n_runs + n_taps);
  auto kernel = stencil_sweep_kernel<T, kSingle>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)((g.o0 + g.b0 - 1) / g.b0) * g.tiles1 * g.tiles2;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)batch);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), static_cast<T*>(out), aux0,
                                           aux1, n_aux, table, n_runs, n_taps, g);
  return cudaGetLastError();
}

// The walk: its rings (g.slab_words) and the taps laid out by position
// (a mask a row, a coefficient a position), one block a walk of a strip;
// one kernel for each order and each offset modulo 4 of the window rows
// (the rows' lead).
template <typename T, int R>
cudaError_t launch_walk(const void* x, void* out, const float* aux0, const float* aux1,
                        int n_aux, const int* table, int n_taps, int batch, const Geom& g,
                        int n_runs, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)g.slab_words + (2 * R + 1) * (2 * R + 2));
  void (*kernel)(const T*, T*, const float*, const float*, int, const int*, int, int, Geom);
  if constexpr (sizeof(T) == 2) {
    kernel = stencil_sweep_kernel_walk<T, R, 0>;  // bf16 rows: plain loads, no lead
  } else {
    switch (g.lead) {
      case 0: kernel = stencil_sweep_kernel_walk<T, R, 0>; break;
      case 1: kernel = stencil_sweep_kernel_walk<T, R, 1>; break;
      case 2: kernel = stencil_sweep_kernel_walk<T, R, 2>; break;
      default: kernel = stencil_sweep_kernel_walk<T, R, 3>; break;
    }
  }
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)g.walks1 * g.tiles2;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)batch);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), static_cast<T*>(out), aux0,
                                           aux1, n_aux, table, n_runs, n_taps, g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_walk(const void* x, void* out, const float* aux0, const float* aux1,
                        int n_aux, const int* table, int n_taps, int batch, const Geom& g,
                        int n_runs, cudaStream_t stream) {
  switch (g.h1) {
    case 1: return launch_walk<T, 1>(x, out, aux0, aux1, n_aux, table, n_taps, batch, g, n_runs, stream);
    case 2: return launch_walk<T, 2>(x, out, aux0, aux1, n_aux, table, n_taps, batch, g, n_runs, stream);
    case 3: return launch_walk<T, 3>(x, out, aux0, aux1, n_aux, table, n_taps, batch, g, n_runs, stream);
    case 4: return launch_walk<T, 4>(x, out, aux0, aux1, n_aux, table, n_taps, batch, g, n_runs, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// table: 4*n_runs + n_taps int32 words — per run (slab offset of its first
// tap relative to the output, at row pitch `pitch`; width <= kMaxRun; index
// of its first coefficient; that offset modulo 4), then the f32
// coefficients' bits.  x: the unpadded state (wrap = 1, o per axis) or the
// haloed input (wrap = 0, o + 2*steps*h per axis); out: o per axis; the aux
// arrays: ceil(o / b) * b + 2*steps*h per axis.  lead: storage column of
// slab column 0 (input columns and storage columns agree modulo 4 when
// aligned = 1, which turns on 16-byte copies; f32 only).  vec: rows of kV
// outputs are 16-byte aligned in out.  walk: tiles a block walks along
// the rows of a 2-D problem (matrixization.sweep_walk; `single` is then
// moot), 0 for one slab a block.  Returns the cudaError_t of the launch
// (0 = cudaSuccess).
extern "C" int stencil_sweep_launch(const void* x, void* out, const float* aux0,
                                    const float* aux1, int n_aux, const int* table,
                                    int n_taps, int is_bf16, int batch, int o0, int o1,
                                    int o2, int b0, int b1, int b2, int h0, int h1,
                                    int h2, int n_runs, int steps, int single, int wrap,
                                    int pitch, int lead, int vec, int aligned, int walk,
                                    void* stream) {
  Geom g;
  g.o0 = o0; g.o1 = o1; g.o2 = o2;
  g.b0 = b0; g.b1 = b1; g.b2 = b2;
  g.h0 = h0; g.h1 = h1; g.h2 = h2;
  g.s0 = b0 + 2 * steps * h0; g.s1 = b1 + 2 * steps * h1; g.s2 = b2 + 2 * steps * h2;
  g.n0 = wrap ? o0 : o0 + 2 * steps * h0;
  g.n1 = wrap ? o1 : o1 + 2 * steps * h1;
  g.n2 = wrap ? o2 : o2 + 2 * steps * h2;
  g.tiles1 = (o1 + b1 - 1) / b1; g.tiles2 = (o2 + b2 - 1) / b2;
  g.a1 = g.tiles1 * b1 + 2 * steps * h1;
  g.a2 = g.tiles2 * b2 + 2 * steps * h2;
  g.pitch = pitch;
  g.lead = lead;
  g.slab_words = (g.s0 * g.s1 * pitch + 3) / 4 * 4;
  g.steps = steps;
  g.wrap = wrap;
  g.aligned = aligned && !is_bf16;
  g.vec = vec;
  // the walk (== matrixization.sweep_walk_rings): the input ring holds the
  // 2 h1 + q rows a step reads and kWalkAhead groups of q loading, each
  // level's ring the 2 h1 + q rows the next level reads and the q it writes
  g.walk = walk;
  g.walks1 = walk > 0 ? (g.tiles1 + walk - 1) / walk : 0;
  g.ring0 = 2 * h1 + (1 + kWalkAhead) * kWalkRows;
  g.ring1 = 2 * h1 + 2 * kWalkRows;
  if (walk) g.slab_words = ((g.ring0 + (steps - 1) * g.ring1) * pitch + 3) / 4 * 4;
  // (a walk's rows index its rings through SmallMod: fewer than 2^16)
  if (walk < 0 || (walk > 0 && (o0 != 1 || b0 != 1 || h0 != 0 || h1 != h2 || h1 < 1 ||
                                 h1 > kWalkMaxOrder || walk * b1 + 2 * steps * h1 >= 65536)))
    return (int)cudaErrorInvalidValue;
  // the over-read of a step's last chunk (kV outputs, the run's radius and
  // a 16-byte load's rounding) stays inside the row's pitch
  if (steps < 1 || lead < 0 || lead > 3 || pitch % 8 != 4 || pitch < lead + g.s2 + kV + 2)
    return (int)cudaErrorInvalidValue;
  // 16-byte copies: input rows and tiles of 4-word multiples, and storage
  // column k holding an input column equal to k modulo 4
  const int skew = (wrap ? -steps * h2 : 0) - lead;
  if (g.aligned && (b2 % 4 != 0 || g.n2 % 4 != 0 || (skew % 4 + 4) % 4 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (walk) {
    err = is_bf16 ? launch_walk<__nv_bfloat16>(x, out, aux0, aux1, n_aux, table, n_taps, batch,
                                               g, n_runs, s)
                  : launch_walk<float>(x, out, aux0, aux1, n_aux, table, n_taps, batch, g,
                                       n_runs, s);
  } else if (is_bf16) {
    err = single ? launch<__nv_bfloat16, true>(x, out, aux0, aux1, n_aux, table, n_taps, batch,
                                               g, n_runs, s)
                 : launch<__nv_bfloat16, false>(x, out, aux0, aux1, n_aux, table, n_taps,
                                                batch, g, n_runs, s);
  } else {
    err = single ? launch<float, true>(x, out, aux0, aux1, n_aux, table, n_taps, batch, g,
                                       n_runs, s)
                 : launch<float, false>(x, out, aux0, aux1, n_aux, table, n_taps, batch, g,
                                        n_runs, s);
  }
  return (int)err;
}
