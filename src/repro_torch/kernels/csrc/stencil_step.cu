// One matrixized stencil step on Hopper (sm_90a): register-blocked tap runs
// over a haloed shared-memory slab, on a haloed input (valid mode) or on the
// unpadded periodic state, whose halo it reads through wrapped indices (wrap
// mode).
//
// Replaces the Pallas TPU kernel src/repro/kernels/stencil_mxu.py
// ::stencil_pallas_call (body _make_kernel -> _apply_step).  There each grid
// instance owns one output tile, reads an overlapping haloed window of the
// input (pl.Element BlockSpecs), contracts one stacked Toeplitz operator per
// axis against it on the MXU, adds the single-tap lines as scaled shifts,
// accumulates in f32, multiplies by the scenario field and mask, and casts.
//
// What bounds it on this card: a step reads one haloed input and writes one
// output per point and does 2*taps flops per point; for the paper's stencils
// (9-125 taps) that is 4-60 flop per 8 bytes, below the ridge of 67 TFLOP/s
// f32 over 3.35 TB/s (~20 flop/byte), so device-memory bytes bound it.  The
// design's aim is to keep the memory system busy and keep the per-output
// work inside the block small enough to hide under it:
//   * one block per output tile (the batch is folded into the tile index),
//     one f32 slab in shared memory: with a single slab more blocks fit on
//     an SM, and the hardware overlaps one block's slab load with another's
//     arithmetic.  Persistent blocks that walked several tiles through two
//     or three slab buffers (this kernel's first design) measured slower on
//     the card at every tile tried (PERF.md, PR 13), likely because fewer
//     resident warps hide the shared-memory latency of the tap loops;
//   * the slab is loaded with cp.async copies: 16 bytes each where the
//     input's rows are 16-byte aligned (its last extent and the tile's a
//     multiple of 4 f32), 4 bytes each otherwise; a row's copies spread over
//     the fewest lanes (a power of two) so that short 3-D rows still keep a
//     warp busy.  bf16 inputs are converted to f32 on the way in, so they
//     are loaded with plain loads;
//   * wrap mode (boundary "periodic", a template parameter, so the valid
//     path's code is untouched): the input is the UNPADDED state, and the
//     slab of the tile at (g0, g1, g2) starts at (g0 - h0, g1 - h1, g2 - h2)
//     in it, every element read at its index modulo the extent along each
//     axis.  No padded copy of the state is made: on a 3-D state a padded
//     copy costs one full read and write of the state an axis, more than
//     the step itself moves.  The slab origin sits h2 columns before a
//     16-byte aligned tile origin, so each slab row is stored `lead` =
//     -h2 mod 4 words into its row of the pitch: storage columns and input
//     columns then agree modulo 4, and 16-byte copies stay aligned on both
//     sides.  The pitch is the valid mode's (a wider one would halve the
//     blocks an SM holds at the 3-D tile), so a row's words may run into
//     the next row's first `lead` storage words: a row is its head (the
//     words before its first whole unit), its whole 16-byte units and its
//     tail, and the slab takes one 16-byte unit more for the last row's
//     tail.  The loader copies every row's units first, one 16-byte copy a
//     lane, then every row's head and tail, one 8- or 4-byte copy a lane:
//     done row by row, the few lanes with short copies held up each warp,
//     and the 3-D step took 1.5x the valid mode's time (PERF.md §6).
//     Only a unit or piece that crosses the state's edge computes a
//     modulo, word by word (as csrc/stencil_sweep.cu does).  The tap
//     table's offsets carry the lead (stencil_mxu.step_lead).  Output
//     extents need not be multiples of the tile: outputs past the state
//     are never stored;
//   * tap runs in registers: the host groups the plan's taps into runs of up
//     to kMaxRun consecutive taps along the last axis with the same offsets on
//     the leading axes (stencil_mxu.tap_runs, in the plan's row order).  Each
//     thread computes kV consecutive outputs along the last axis; per run it
//     loads the kV + w - 1 slab values it needs into registers once, as
//     aligned 16-byte shared loads (the run's offset modulo 4 is a template
//     parameter, like its width, so every register index is a constant), and
//     does kV * w FMAs: a 5-wide row costs 3 vector loads per 8 outputs
//     instead of 40 scalar ones.  The run's width and offset modulo 4 are
//     dispatched to a fully unrolled body (a switch on values that are
//     uniform across the block);
//   * the tap table (one 4-word header per run, then the f32 coefficients) is
//     copied from device memory into shared memory by each block and read
//     with uniform, broadcast loads; the host builds it once per plan and
//     device (stencil_mxu.tap_table), never per call;
//   * bank-conflict-free reads: a warp is 32/kV threads along a row times kV
//     rows, and the slab's row pitch is 4 (mod 8) words
//     (matrixization.step_slab_pitch): rows stay 16-byte aligned for the
//     copies, and the 8 lanes of each quarter-warp phase of a 16-byte load
//     (4 along a row, 2 rows) cover all 32 banks;
//   * a 2-D thread layout (tx along the last axis, ty over the rows): no
//     integer division in the loops over rows, chunks and taps;
//   * whole chunks store (and read the field and mask) as 16-byte vectors
//     when the wrapper finds the rows aligned.
// 3-D runs the same kernel.  The usual GPU 3-D stencil walks each thread
// along axis 0 with the 2r+1 planes it needs in registers, which would also
// cut the halo reads along that axis; it was not picked because one kernel
// then serves every rank and tap pattern the planner can hand it (stars,
// boxes, fused operators), while the 3-D star's 13 taps are mostly
// one-tap runs, where register blocking saves little anyway.  The axis-0
// walk is open work (PERF.md §7).
// Per output the sum runs over the runs in order and over each run's taps in
// order: the plan's row order, which stencil_step_plain follows too.  f32
// accumulation, then the field, then the mask, then the cast.  Both modes
// put the same values in the same slab positions, so a wrap-mode output
// equals the valid-mode output on the padded state bit for bit.
//
// A 2-D problem is passed as 3-D with a leading extent of 1 and no halo on
// it.  In valid mode the output extents are multiples of the tile (the
// wrapper pads); the tile's last extent need not be a multiple of kV (the
// pitch then leaves room for the over-read of the last, partial chunk, whose
// extra outputs are never stored).  The slab's padding columns are never
// written and are read only into registers that no stored output uses.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;  // == matrixization.STEP_THREADS
constexpr int kV = 8;          // == matrixization.STEP_V
constexpr int kMaxRun = 9;     // == matrixization.STEP_MAX_RUN
constexpr int kTx = 32 / kV;   // threads of a warp along the last axis
constexpr int kTy = kThreads / kTx;

struct Geom {
  int o0, o1, o2;          // output extents
  int b0, b1, b2;          // tile
  int h0, h1, h2;          // halo per axis
  int s0, s1, s2;          // haloed tile (slab) extents
  int pitch;               // slab row pitch, f32 words
  int lead;                // storage column of slab column 0 (wrap mode)
  long long x0, x1, x2;    // input extents: o + 2h (valid) or o (wrap)
  int tiles1, tiles2, tiles_per_state;
  int slab_words;          // the slab (and the lead), rounded up to 4 words
  int aligned;             // input rows are 16-byte aligned: 16-byte copies
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
// 16 bytes, of which the first `bytes` are read and the rest zero-filled
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Tile t of the whole batch -> its state and its origin (the same index in
// the output and in the haloed input; the slab's origin in the unpadded
// state is h before it in wrap mode).
struct Tile {
  int state, g0, g1, g2;
};
__device__ __forceinline__ Tile tile_of(const Geom& g, int t) {
  Tile r;
  r.state = t / g.tiles_per_state;
  int rem = t - r.state * g.tiles_per_state;
  const int q = rem / g.tiles2;
  r.g2 = (rem - q * g.tiles2) * g.b2;
  const int t0 = q / g.tiles1;
  r.g1 = (q - t0 * g.tiles1) * g.b1;
  r.g0 = t0 * g.b0;
  return r;
}

// Start (f32: cp.async) or do (bf16: plain loads) the copy of tile t's
// haloed slab into buf: each slab row is `per_row` copies of `unit` floats
// (4 when the rows are 16-byte aligned, else 1), spread over 2^lg lanes, so
// a warp handles 32 >> lg rows at a time.
template <typename T>
__device__ __forceinline__ void load_slab(float* buf, const T* __restrict__ x,
                                          const Geom& g, int t) {
  const Tile tl = tile_of(g, t);
  const long long x_state = g.x0 * g.x1 * g.x2;
  const T* xs = x + (long long)tl.state * x_state;
  const int unit = (sizeof(T) == 4 && g.aligned) ? 4 : 1;
  const int per_row = (g.s2 + unit - 1) / unit;
  int lg = 0;
  while (lg < 5 && (1 << lg) < per_row) ++lg;
  const int lane = threadIdx.x & 31, sub = lane & ((1 << lg) - 1);
  const int row_step = (kThreads / 32) << (5 - lg);
  int i0 = 0, i1 = ((threadIdx.x >> 5) << (5 - lg)) + (lane >> lg);
  while (i1 >= g.s1) { i1 -= g.s1; ++i0; }
  while (i0 < g.s0) {
    const T* src = xs + ((long long)(tl.g0 + i0) * g.x1 + (tl.g1 + i1)) * g.x2 + tl.g2;
    float* dst = buf + (i0 * g.s1 + i1) * g.pitch;
    for (int c = sub; c < per_row; c += 1 << lg) {
      if constexpr (sizeof(T) == 4) {
        const float* fsrc = reinterpret_cast<const float*>(src);
        if (unit == 4) {
          cp_async16(dst + 4 * c, fsrc + 4 * c, 4 * min(4, g.s2 - 4 * c));
        } else {
          cp_async4(dst + c, fsrc + c);
        }
      } else {
        dst[c] = to_f32(src[c]);
      }
    }
    i1 += row_step;
    while (i1 >= g.s1) { i1 -= g.s1; ++i0; }
  }
}

// Index c of an axis of n points, wrapped into [0, n).
__device__ __forceinline__ int wrap_index(int c, int n) {
  if (c >= 0 && c < n) return c;
  c %= n;
  return c < 0 ? c + n : c;
}

// 8 bytes, both addresses 8-byte aligned
__device__ __forceinline__ void cp_async8(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}

// Copy slab columns [i, i + n) of a row (n <= 4, the words of one storage
// unit) from state columns org2 + i on: straight where they lie inside the
// state (an 8-byte copy for each aligned pair; storage and state columns
// agree modulo 4), wrapped word by word where they do not.
__device__ __forceinline__ void copy_words(float* row, const float* src, int i, int n,
                                           int org2, int x2) {
  const int c0 = org2 + i;
  if (c0 < 0 || c0 + n > x2) {
    for (int j = 0; j < n; ++j) cp_async4(row + i + j, src + wrap_index(c0 + j, x2));
    return;
  }
  int j = 0;
  if (c0 & 1) { cp_async4(row + i, src + c0); ++j; }
  for (; j + 2 <= n; j += 2) cp_async8(row + i + j, src + c0 + j);
  if (j < n) cp_async4(row + i + j, src + c0 + j);
}

// fn(row, src, p) for piece p of every slab row of a tile: `per_row`
// pieces a row spread over the fewest lanes (a power of two), so a warp
// handles 32 >> lg rows at a time.  row is the row's slab column 0 in buf,
// src the state's row it reads (rows wrapped).
template <typename T, typename F>
__device__ __forceinline__ void each_piece(float* buf, const T* __restrict__ xs,
                                           const Geom& g, int org0, int org1, int per_row,
                                           F fn) {
  if (per_row == 0) return;
  int lg = 0;
  while (lg < 5 && (1 << lg) < per_row) ++lg;
  const int lane = threadIdx.x & 31, sub = lane & ((1 << lg) - 1);
  const int row_step = (kThreads / 32) << (5 - lg);
  int i0 = 0, i1 = ((threadIdx.x >> 5) << (5 - lg)) + (lane >> lg);
  while (i1 >= g.s1) { i1 -= g.s1; ++i0; }
  while (i0 < g.s0) {
    float* row = buf + (i0 * g.s1 + i1) * g.pitch + g.lead;
    const int r0 = wrap_index(org0 + i0, (int)g.x0), r1 = wrap_index(org1 + i1, (int)g.x1);
    const T* src = xs + ((long long)r0 * g.x1 + r1) * g.x2;
    for (int p = sub; p < per_row; p += 1 << lg) fn(row, src, p);
    i1 += row_step;
    while (i1 >= g.s1) { i1 -= g.s1; ++i0; }
  }
}

// Wrap mode: start (f32) or do (bf16) the copy of tile t's slab out of the
// unpadded state.  Slab element (i0, i1, i) reads the state at (g0 - h0 +
// i0, g1 - h1 + i1, g2 - h2 + i), each modulo its extent, and slab column i
// sits at storage column lead + i of its row.  With 16-byte copies a row is
// its head (the words before its first whole storage unit), `full` whole
// units, and its tail: first every row's units, one 16-byte copy a lane,
// then every row's head and tail, one short copy a lane, so no warp waits
// on a few lanes' short copies row by row.  A unit or a short piece across
// the state's edge copies word by word, wrapped.  Otherwise (bf16, or rows
// not 16-byte aligned) a row is s2 single words.
template <typename T>
__device__ __forceinline__ void load_slab_wrap(float* buf, const T* __restrict__ x,
                                               const Geom& g, int t) {
  const Tile tl = tile_of(g, t);
  const T* xs = x + (long long)tl.state * (g.x0 * g.x1 * g.x2);
  const int org0 = tl.g0 - g.h0, org1 = tl.g1 - g.h1, org2 = tl.g2 - g.h2;
  const int x2 = (int)g.x2;
  if constexpr (sizeof(T) == 4) {
    if (g.aligned) {
      const int head = (4 - g.lead) & 3;  // slab columns before the first unit
      const int full = (g.s2 - head) / 4;
      const int tail = g.s2 - head - 4 * full;
      each_piece(buf, xs, g, org0, org1, full, [&](float* row, const T* src, int p) {
        const int i = head + 4 * p, c0 = org2 + i;
        if (c0 >= 0 && c0 + 4 <= x2) {
          cp_async16(row + i, src + c0, 16);
        } else {
          copy_words(row, src, i, 4, org2, x2);
        }
      });
      each_piece(buf, xs, g, org0, org1, (head > 0) + (tail > 0),
                 [&](float* row, const T* src, int p) {
                   const bool first = p == 0 && head > 0;
                   copy_words(row, src, first ? 0 : head + 4 * full, first ? head : tail,
                              org2, x2);
                 });
    } else {
      each_piece(buf, xs, g, org0, org1, g.s2, [&](float* row, const T* src, int p) {
        cp_async4(row + p, src + wrap_index(org2 + p, x2));
      });
    }
  } else {
    each_piece(buf, xs, g, org0, org1, g.s2, [&](float* row, const T* src, int p) {
      row[p] = to_f32(src[wrap_index(org2 + p, x2)]);
    });
  }
}

// One run of W consecutive taps whose first slab value sits SH words past a
// 16-byte boundary: the kV + W - 1 values it needs come in as N aligned
// 16-byte loads, then kV * W FMAs, taps in order for every output.
template <int W, int SH>
__device__ __forceinline__ void apply_run(const float* p, const float* c, float (&acc)[kV]) {
  constexpr int N = (SH + kV + W - 1 + 3) / 4;
  float v[4 * N];
  const float4* p4 = reinterpret_cast<const float4*>(p - SH);
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const float4 f = p4[n];
    v[4 * n] = f.x;
    v[4 * n + 1] = f.y;
    v[4 * n + 2] = f.z;
    v[4 * n + 3] = f.w;
  }
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const float ck = c[k];
#pragma unroll
    for (int i = 0; i < kV; ++i) acc[i] = fmaf(ck, v[SH + i + k], acc[i]);
  }
}

template <int W>
__device__ __forceinline__ void apply_run(const float* p, const float* c, int sh,
                                          float (&acc)[kV]) {
  switch (sh) {
    case 0: apply_run<W, 0>(p, c, acc); break;
    case 1: apply_run<W, 1>(p, c, acc); break;
    case 2: apply_run<W, 2>(p, c, acc); break;
    default: apply_run<W, 3>(p, c, acc); break;
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

__device__ __forceinline__ void scale_chunk(float (&acc)[kV], const float* __restrict__ a,
                                            int n_valid, bool vec) {
  if (vec && n_valid == kV) {
#pragma unroll
    for (int i = 0; i < kV; i += 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(a + i));
      acc[i] *= f.x;
      acc[i + 1] *= f.y;
      acc[i + 2] *= f.z;
      acc[i + 3] *= f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kV; ++i)
      if (i < n_valid) acc[i] *= __ldg(a + i);
  }
}

template <typename T, bool kWrap>
__global__ void __launch_bounds__(kThreads) stencil_step_kernel(
    const T* __restrict__ x, T* __restrict__ out, const float* __restrict__ aux0,
    const float* __restrict__ aux1, int n_aux, const int* __restrict__ table, int n_runs,
    int n_taps, Geom g, int vec_ok) {
  extern __shared__ __align__(16) float smem[];
  int4* runs = reinterpret_cast<int4*>(smem + g.slab_words);
  const float* coefs = reinterpret_cast<const float*>(runs + n_runs);
  {
    int* tbl = reinterpret_cast<int*>(runs);
    for (int i = threadIdx.x; i < 4 * n_runs + n_taps; i += kThreads) tbl[i] = __ldg(table + i);
  }
  const bool vec = vec_ok != 0;
  const long long o_state = (long long)g.o0 * g.o1 * g.o2;
  const int lane = threadIdx.x & 31;
  const int tx = lane % kTx;
  const int ty = (threadIdx.x >> 5) * (32 / kTx) + lane / kTx;
  const int rows = g.b0 * g.b1;
  const int chunks = (g.b2 + kV - 1) / kV;
  // the first row of this thread, as (p0, p1); later rows step by kTy
  const int p0_first = ty / g.b1, p1_first = ty - (ty / g.b1) * g.b1;

  const int t = blockIdx.x;
  if constexpr (kWrap) {
    load_slab_wrap<T>(smem, x, g, t);
  } else {
    load_slab<T>(smem, x, g, t);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  const Tile tl = tile_of(g, t);
  T* os = out + (long long)tl.state * o_state;
  // wrap mode: the tile's outputs inside the state (ragged last tiles)
  const int e0 = kWrap ? min(g.b0, g.o0 - tl.g0) : g.b0;
  const int e1 = kWrap ? min(g.b1, g.o1 - tl.g1) : g.b1;
  const int e2 = kWrap ? min(g.b2, g.o2 - tl.g2) : g.b2;
  const int live_chunks = kWrap ? (e2 + kV - 1) / kV : chunks;
  int p0 = p0_first, p1 = p1_first;
  for (int r = ty; r < rows; r += kTy) {
    const float* row = smem + (p0 * g.s1 + p1) * g.pitch;
    const long long orow = ((long long)(tl.g0 + p0) * g.o1 + (tl.g1 + p1)) * g.o2 + tl.g2;
    const int row_chunks = (!kWrap || (p0 < e0 && p1 < e1)) ? live_chunks : 0;
    for (int c = tx; c < row_chunks; c += kTx) {
      const float* base = row + c * kV;
      float acc[kV];
#pragma unroll
      for (int i = 0; i < kV; ++i) acc[i] = 0.f;
      for (int k = 0; k < n_runs; ++k) {
        const int4 run = runs[k];  // (slab offset, width, first coefficient, offset % 4)
        const float* p = base + run.x;
        const float* cw = coefs + run.z;
        switch (run.y) {
          case 1: apply_run<1>(p, cw, run.w, acc); break;
          case 2: apply_run<2>(p, cw, run.w, acc); break;
          case 3: apply_run<3>(p, cw, run.w, acc); break;
          case 4: apply_run<4>(p, cw, run.w, acc); break;
          case 5: apply_run<5>(p, cw, run.w, acc); break;
          case 6: apply_run<6>(p, cw, run.w, acc); break;
          case 7: apply_run<7>(p, cw, run.w, acc); break;
          case 8: apply_run<8>(p, cw, run.w, acc); break;
          default: apply_run<kMaxRun>(p, cw, run.w, acc); break;
        }
      }
      const int n_valid = min(kV, e2 - c * kV);
      const long long o = orow + c * kV;
      if (n_aux > 0) scale_chunk(acc, aux0 + o, n_valid, vec);
      if (n_aux > 1) scale_chunk(acc, aux1 + o, n_valid, vec);
      store_chunk<T>(os + o, acc, n_valid, vec);
    }
    p1 += kTy;
    while (p1 >= g.b1) { p1 -= g.b1; ++p0; }
  }
}

template <typename T>
cudaError_t launch(const void* x, void* out, const float* aux0, const float* aux1,
                   int n_aux, const int* table, int n_taps, int batch, int o0, int o1,
                   int o2, int b0, int b1, int b2, int h0, int h1, int h2, int n_runs,
                   int pitch, int vec, int aligned, int wrap, int lead,
                   cudaStream_t stream) {
  Geom g;
  g.o0 = o0; g.o1 = o1; g.o2 = o2;
  g.b0 = b0; g.b1 = b1; g.b2 = b2;
  g.h0 = h0; g.h1 = h1; g.h2 = h2;
  g.s0 = b0 + 2 * h0; g.s1 = b1 + 2 * h1; g.s2 = b2 + 2 * h2;
  g.pitch = pitch;
  g.lead = wrap ? lead : 0;
  g.x0 = wrap ? o0 : o0 + 2 * h0;
  g.x1 = wrap ? o1 : o1 + 2 * h1;
  g.x2 = wrap ? o2 : o2 + 2 * h2;
  g.tiles1 = (o1 + b1 - 1) / b1; g.tiles2 = (o2 + b2 - 1) / b2;
  g.tiles_per_state = ((o0 + b0 - 1) / b0) * g.tiles1 * g.tiles2;
  g.slab_words = (g.s0 * g.s1 * pitch + g.lead + 3) / 4 * 4;
  g.aligned = aligned;
  if (pitch < (g.s2 + 3) / 4 * 4 + (b2 % kV ? kV : 0) || pitch % 8 != 4)
    return cudaErrorInvalidValue;
  // valid mode: whole tiles; wrap mode: a lead in [0, 4), and with 16-byte
  // copies, input columns equal to their storage columns modulo 4
  if (!wrap && (o0 % b0 || o1 % b1 || o2 % b2)) return cudaErrorInvalidValue;
  if (wrap && (lead < 0 || lead > 3 || (aligned && (b2 % 4 || o2 % 4 || (lead + h2) % 4))))
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)g.slab_words + 4 * n_runs + n_taps);
  auto kernel = wrap ? stencil_step_kernel<T, true> : stencil_step_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const long long n_tiles = (long long)g.tiles_per_state * batch;
  if (n_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = (int)n_tiles;
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), static_cast<T*>(out), aux0,
                                           aux1, n_aux, table, n_runs, n_taps, g, vec);
  return cudaGetLastError();
}

}  // namespace

// table: 4*n_runs + n_taps int32 words — per run (storage offset of its
// first tap from the slab's row 0, at row pitch `pitch`, `lead` included;
// width <= kMaxRun; index of its first coefficient; that offset % 4), then
// the f32 coefficients' bits.  x: the haloed input (wrap = 0, o + 2h per
// axis, o a multiple of the tile) or the unpadded periodic state (wrap = 1,
// o per axis, any extents); out and the aux arrays: o per axis.  lead:
// storage column of slab column 0 in wrap mode (-h2 mod 4 for 16-byte
// copies).  vec: rows of kV outputs are 16-byte aligned in out and the aux
// arrays.  aligned: the input's rows at the tiles' origins are 16-byte
// aligned (f32 only).  Returns the cudaError_t of the launch (0 =
// cudaSuccess).
extern "C" int stencil_step_launch(const void* x, void* out, const float* aux0,
                                   const float* aux1, int n_aux, const int* table,
                                   int n_taps, int is_bf16, int batch, int o0, int o1,
                                   int o2, int b0, int b1, int b2, int h0, int h1,
                                   int h2, int n_runs, int pitch, int vec, int aligned,
                                   int wrap, int lead, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(x, out, aux0, aux1, n_aux, table, n_taps, batch, o0,
                                      o1, o2, b0, b1, b2, h0, h1, h2, n_runs, pitch, vec,
                                      aligned, wrap, lead, s)
              : launch<float>(x, out, aux0, aux1, n_aux, table, n_taps, batch, o0, o1, o2,
                              b0, b1, b2, h0, h1, h2, n_runs, pitch, vec, aligned, wrap,
                              lead, s);
  return (int)err;
}
