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
static_assert(kTx * kTy == 32, "a work item is one warp");

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

// Input index of coordinate c along an axis of n points: c itself inside,
// c modulo n in wrap mode, -1 (a zero) past a haloed input's end.
__device__ __forceinline__ int source_index(int c, int n, int wrap) {
  if (c >= 0 && c < n) return c;
  if (!wrap) return -1;
  c %= n;
  return c < 0 ? c + n : c;
}

// Start (f32: cp.async) or do (bf16: plain loads) the copy of the tile's
// slab at origin (g0, g1, g2) into buf.  Slab column i of a row sits at
// storage column lead + i, and reads input column org2 + i (wrapped).  A
// row is `per_row` units of `unit` words (4 when 16-byte copies are on,
// else 1), spread over 2^lg lanes.
template <typename T>
__device__ __forceinline__ void load_slab(float* buf, const T* __restrict__ xs,
                                          const Geom& g, int g0, int g1, int g2) {
  const int w0 = g.steps * g.h0, w1 = g.steps * g.h1, w2 = g.steps * g.h2;
  const int org0 = g.wrap ? g0 - w0 : g0;
  const int org1 = g.wrap ? g1 - w1 : g1;
  const int org2 = g.wrap ? g2 - w2 : g2;
  const bool wide = sizeof(T) == 4 && g.aligned;
  const int unit = wide ? 4 : 1;
  const int first = wide ? 0 : g.lead;          // storage column of unit 0
  const int per_row = wide ? (g.lead + g.s2 + 3) / 4 : g.s2;
  int lg = 0;
  while (lg < 5 && (1 << lg) < per_row) ++lg;
  const int lane = threadIdx.x & 31, sub = lane & ((1 << lg) - 1);
  const int row_step = (kThreads / 32) << (5 - lg);
  int i0 = 0, i1 = ((threadIdx.x >> 5) << (5 - lg)) + (lane >> lg);
  while (i1 >= g.s1) { i1 -= g.s1; ++i0; }
  while (i0 < g.s0) {
    float* dst = buf + (i0 * g.s1 + i1) * g.pitch + first;
    const int r0 = source_index(org0 + i0, g.n0, g.wrap);
    const int r1 = source_index(org1 + i1, g.n1, g.wrap);
    if (r0 < 0 || r1 < 0) {
      for (int c = sub; c < per_row * unit; c += 1 << lg) dst[c] = 0.f;
    } else {
      const T* src = xs + ((long long)r0 * g.n1 + r1) * g.n2;
      for (int u = sub; u < per_row; u += 1 << lg) {
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
    i1 += row_step;
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

}  // namespace

// table: 4*n_runs + n_taps int32 words — per run (slab offset of its first
// tap relative to the output, at row pitch `pitch`; width <= kMaxRun; index
// of its first coefficient; that offset modulo 4), then the f32
// coefficients' bits.  x: the unpadded state (wrap = 1, o per axis) or the
// haloed input (wrap = 0, o + 2*steps*h per axis); out: o per axis; the aux
// arrays: ceil(o / b) * b + 2*steps*h per axis.  lead: storage column of
// slab column 0 (input columns and storage columns agree modulo 4 when
// aligned = 1, which turns on 16-byte copies; f32 only).  vec: rows of kV
// outputs are 16-byte aligned in out.  Returns the cudaError_t of the
// launch (0 = cudaSuccess).
extern "C" int stencil_sweep_launch(const void* x, void* out, const float* aux0,
                                    const float* aux1, int n_aux, const int* table,
                                    int n_taps, int is_bf16, int batch, int o0, int o1,
                                    int o2, int b0, int b1, int b2, int h0, int h1,
                                    int h2, int n_runs, int steps, int single, int wrap,
                                    int pitch, int lead, int vec, int aligned,
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
  if (is_bf16) {
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
