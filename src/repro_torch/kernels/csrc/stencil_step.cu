// One matrixized stencil step on Hopper (sm_90a): register-blocked tap runs
// over a haloed shared-memory slab (in 3-D, a ring of slab planes walked
// along axis 0), on a haloed input (valid mode) or on the unpadded periodic
// state, whose halo it reads through wrapped indices (wrap mode).
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
//   * 2-D: one block per output tile (the batch is folded into the tile
//     index), one f32 slab in shared memory: with a single slab more blocks
//     fit on an SM, and the hardware overlaps one block's slab load with another's
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
// 3-D launches walk axis 0 (stencil_step_kernel_walk): one block owns a
// column of outputs, the plan's tile on axes 1-2, and walks `walk`
// consecutive tiles of it along axis 0 (matrixization.step_walk: deep
// enough that the walk re-reads at most 1/16 of its planes, shallow enough
// to leave 16 blocks an SM).  What it does about the two bounds of the slab:
//   * bytes: a slab re-reads the 2 h0 halo planes of every tile along axis
//     0 (at 16x32x32 and r = 2, 20 planes for 16); a walk reads each input
//     plane of its column once, and only the 2 h0 planes at its two ends
//     twice (68 planes for 64 at a walk of 4 tiles): 11.10 -> 10.07 GB a
//     launch at 1024^3;
//   * schedule: a 103.7 KB slab leaves two blocks an SM, each idle until its
//     whole slab has landed.  The walk keeps a ring of slab planes (at that
//     tile 10 planes of 36 rows at a pitch of 36, 52 KB): a step computes q
//     output planes from the 2 h0 + q planes they read while the next two
//     groups of q planes load (cp.async commit groups; one group where two
//     would make the ring larger than the slab).  q * b1 >= kTy rows, so
//     that every thread row has a row, and 2q <= b0.  Registers (64 a
//     thread) allow four blocks an SM.  One group ahead measured 5% slower
//     than two: the loads queued while a step computes keep the memory
//     system busy.
// Input plane p of a walk sits in ring slot p mod ring, and the walk reads
// the slab's tap table: a run's offset is its plane times the plane's words
// plus its offset inside the plane, and a run whose plane lies past the
// ring's last slot reads the ring's words earlier (row_outputs).  So every
// output sums the same runs in the same order on the same values as on the
// slab path, bit for bit, in both input modes.  The walk's rows are fetched
// with the L2's 256-byte prefetch (the neighbouring columns read the rest)
// and its outputs are stored as streaming (evict-first), so that they do
// not push the planes the neighbouring columns and the next walk re-read
// out of the L2.  Measured on an H100 (PERF.md §6): the walk takes 5.6 ms
// a launch at 1024^3 where the slab took 6.9 (54% of HBM bandwidth against
// 48%); its loads and stores alone take about 4 ms and its taps alone about
// 1.5 (they are issue-bound), and the two overlap only partly.
// A 2-D problem (leading extent 1, no halo on it) and a tile one plane deep
// keep the slab path.
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
  int slab_words;          // the slab or the ring (and the lead), rounded up to 4 words
  int aligned;             // input rows are 16-byte aligned: 16-byte copies
  int walk;                // tiles a block walks along axis 0 (0: one slab a block)
  int q;                   // output planes a step of the walk computes
  int ahead;               // groups of q planes loading while a step computes
  int ring;                // the walk's ring of slab planes: 2 h0 + q read, ahead * q loading
  int walks0;              // walks along axis 0 a state
};

// Where plane i0 of a load is stored: slot (slot0 + i0) of a ring of
// `ring` slab planes (a block's whole slab: slot0 = 0, ring = s0).  org0 is
// the input plane of load plane 0 (before wrapping, in wrap mode).
struct Planes {
  int org0, n, slot0, ring;
  __device__ __forceinline__ int slot(int i0) const {
    const int s = slot0 + i0;
    return s < ring ? s : s - ring;
  }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
// 16 bytes, of which the first `bytes` are read and the rest zero-filled;
// kFetch256: the L2 fetches the 256-byte span around them (the walk's rows:
// the neighbouring columns' blocks read the rest of it)
template <bool kFetch256 = false>
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kFetch256) {
    asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// every group but the `ahead` (1 or 2) committed last
__device__ __forceinline__ void cp_async_wait_ahead(int ahead) {
  if (ahead > 1) {
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  }
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

// Start (f32: cp.async) or do (bf16: plain loads) the copy of the slab
// planes `pl` of a haloed input xs (one state) whose rows start at (org1,
// org2): each slab row is `per_row` copies of `unit` floats (4 when the rows
// are 16-byte aligned, else 1), spread over 2^lg lanes, so a warp handles
// 32 >> lg rows at a time.
template <typename T, bool kRing>
__device__ __forceinline__ void load_slab(float* buf, const T* __restrict__ xs,
                                          const Geom& g, const Planes& pl, int org1,
                                          int org2) {
  const int unit = (sizeof(T) == 4 && g.aligned) ? 4 : 1;
  const int per_row = (g.s2 + unit - 1) / unit;
  int lg = 0;
  while (lg < 5 && (1 << lg) < per_row) ++lg;
  const int lane = threadIdx.x & 31, sub = lane & ((1 << lg) - 1);
  const int row_step = (kThreads / 32) << (5 - lg);
  int i0 = 0, i1 = ((threadIdx.x >> 5) << (5 - lg)) + (lane >> lg);
  while (i1 >= g.s1) { i1 -= g.s1; ++i0; }
  while (i0 < pl.n) {
    const T* src = xs + ((long long)(pl.org0 + i0) * g.x1 + (org1 + i1)) * g.x2 + org2;
    float* dst = buf + (pl.slot(i0) * g.s1 + i1) * g.pitch;
    for (int c = sub; c < per_row; c += 1 << lg) {
      if constexpr (sizeof(T) == 4) {
        const float* fsrc = reinterpret_cast<const float*>(src);
        if (unit == 4) {
          cp_async16<kRing>(dst + 4 * c, fsrc + 4 * c, 4 * min(4, g.s2 - 4 * c));
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

// fn(row, src, p) for piece p of every slab row of the planes `pl`:
// `per_row` pieces a row spread over the fewest lanes (a power of two), so a
// warp handles 32 >> lg rows at a time.  row is the row's slab column 0 in
// buf, src the state's row it reads (rows wrapped).
template <typename T, typename F>
__device__ __forceinline__ void each_piece(float* buf, const T* __restrict__ xs,
                                           const Geom& g, const Planes& pl, int org1,
                                           int per_row, F fn) {
  if (per_row == 0) return;
  int lg = 0;
  while (lg < 5 && (1 << lg) < per_row) ++lg;
  const int lane = threadIdx.x & 31, sub = lane & ((1 << lg) - 1);
  const int row_step = (kThreads / 32) << (5 - lg);
  int i0 = 0, i1 = ((threadIdx.x >> 5) << (5 - lg)) + (lane >> lg);
  while (i1 >= g.s1) { i1 -= g.s1; ++i0; }
  while (i0 < pl.n) {
    float* row = buf + (pl.slot(i0) * g.s1 + i1) * g.pitch + g.lead;
    const int r0 = wrap_index(pl.org0 + i0, (int)g.x0), r1 = wrap_index(org1 + i1, (int)g.x1);
    const T* src = xs + ((long long)r0 * g.x1 + r1) * g.x2;
    for (int p = sub; p < per_row; p += 1 << lg) fn(row, src, p);
    i1 += row_step;
    while (i1 >= g.s1) { i1 -= g.s1; ++i0; }
  }
}

// Wrap mode: start (f32) or do (bf16) the copy of the slab planes `pl` out
// of the unpadded state xs (one state).  Slab element (i0, i1, i) reads the
// state at (pl.org0 + i0, org1 + i1, org2 + i), each modulo its extent, and
// slab column i sits at storage column lead + i of its row.  With 16-byte
// copies a row is its head (the words before its first whole storage unit),
// `full` whole units, and its tail: first every row's units, one 16-byte
// copy a lane, then every row's head and tail, one short copy a lane, so no
// warp waits on a few lanes' short copies row by row.  A unit or a short
// piece across the state's edge copies word by word, wrapped.  Otherwise
// (bf16, or rows not 16-byte aligned) a row is s2 single words.
template <typename T, bool kRing>
__device__ __forceinline__ void load_slab_wrap(float* buf, const T* __restrict__ xs,
                                               const Geom& g, const Planes& pl, int org1,
                                               int org2) {
  const int x2 = (int)g.x2;
  if constexpr (sizeof(T) == 4) {
    if (g.aligned) {
      const int head = (4 - g.lead) & 3;  // slab columns before the first unit
      const int full = (g.s2 - head) / 4;
      const int tail = g.s2 - head - 4 * full;
      each_piece(buf, xs, g, pl, org1, full, [&](float* row, const T* src, int p) {
        const int i = head + 4 * p, c0 = org2 + i;
        if (c0 >= 0 && c0 + 4 <= x2) {
          cp_async16<kRing>(row + i, src + c0, 16);
        } else {
          copy_words(row, src, i, 4, org2, x2);
        }
      });
      each_piece(buf, xs, g, pl, org1, (head > 0) + (tail > 0),
                 [&](float* row, const T* src, int p) {
                   const bool first = p == 0 && head > 0;
                   copy_words(row, src, first ? 0 : head + 4 * full, first ? head : tail,
                              org2, x2);
                 });
    } else {
      each_piece(buf, xs, g, pl, org1, g.s2, [&](float* row, const T* src, int p) {
        cp_async4(row + p, src + wrap_index(org2 + p, x2));
      });
    }
  } else {
    each_piece(buf, xs, g, pl, org1, g.s2, [&](float* row, const T* src, int p) {
      row[p] = to_f32(src[wrap_index(org2 + p, x2)]);
    });
  }
}

// The slab planes `pl` of state xs, in the launch's input mode, for a tile
// whose outputs start at (g1, g2) on axes 1 and 2 (kRing: into the walk's
// ring).
template <typename T, bool kWrap, bool kRing>
__device__ __forceinline__ void load_planes(float* buf, const T* __restrict__ xs,
                                            const Geom& g, const Planes& pl, int g1, int g2) {
  if constexpr (kWrap) {
    load_slab_wrap<T, kRing>(buf, xs, g, pl, g1 - g.h1, g2 - g.h2);
  } else {
    load_slab<T, kRing>(buf, xs, g, pl, g1, g2);
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

// 16 bytes to device memory; kStream: marked as read by no one soon (the
// walk's outputs), so that they do not push its input planes out of the L2
template <bool kStream, typename V>
__device__ __forceinline__ void store16(V* dst, V v) {
  if constexpr (kStream) {
    __stcs(dst, v);
  } else {
    *dst = v;
  }
}

template <bool kStream>
__device__ __forceinline__ void store_chunk(float* dst, const float (&acc)[kV], int n_valid,
                                            bool vec) {
  if (vec && n_valid == kV) {
#pragma unroll
    for (int i = 0; i < kV; i += 4)
      store16<kStream>(reinterpret_cast<float4*>(dst + i),
                       make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]));
  } else {
#pragma unroll
    for (int i = 0; i < kV; ++i)
      if (i < n_valid) dst[i] = acc[i];
  }
}

template <bool kStream>
__device__ __forceinline__ void store_chunk(__nv_bfloat16* dst, const float (&acc)[kV],
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
      store16<kStream>(reinterpret_cast<uint4*>(dst + 2 * i),
                       make_uint4(w[i], w[i + 1], w[i + 2], w[i + 3]));
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

// The outputs of one tile row: chunks tx, tx + kTx, ... of its row_chunks,
// the row's slab values at `row` (storage column 0 of the row of its first
// output), stored at os + orow.  Per output the sum runs over the runs in
// table order.  In a ring (kRing) a run whose table offset reaches wrap_at
// lies on a plane past the ring's last slot and reads ring_words earlier.
template <typename T, bool kRing>
__device__ __forceinline__ void row_outputs(const float* row, const int4* runs,
                                            const float* coefs, int n_runs, int wrap_at,
                                            int ring_words, int tx, int row_chunks, int e2,
                                            long long orow, T* os,
                                            const float* __restrict__ aux0,
                                            const float* __restrict__ aux1, int n_aux,
                                            bool vec) {
  for (int c = tx; c < row_chunks; c += kTx) {
    const float* base = row + c * kV;
    float acc[kV];
#pragma unroll
    for (int i = 0; i < kV; ++i) acc[i] = 0.f;
    for (int k = 0; k < n_runs; ++k) {
      const int4 run = runs[k];  // (slab offset, width, first coefficient, offset % 4)
      int off = run.x;
      if constexpr (kRing) off = off < wrap_at ? off : off - ring_words;
      const float* p = base + off;
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
    store_chunk<kRing>(os + o, acc, n_valid, vec);
  }
}

// The tap table into shared memory, after the slab (or the ring).
__device__ __forceinline__ int4* copy_table(float* smem, const Geom& g,
                                            const int* __restrict__ table, int n_runs,
                                            int n_taps) {
  int4* runs = reinterpret_cast<int4*>(smem + g.slab_words);
  int* tbl = reinterpret_cast<int*>(runs);
  for (int i = threadIdx.x; i < 4 * n_runs + n_taps; i += kThreads) tbl[i] = __ldg(table + i);
  return runs;
}

// One block a tile: its whole slab, then its outputs.
template <typename T, bool kWrap>
__global__ void __launch_bounds__(kThreads) stencil_step_kernel(
    const T* __restrict__ x, T* __restrict__ out, const float* __restrict__ aux0,
    const float* __restrict__ aux1, int n_aux, const int* __restrict__ table, int n_runs,
    int n_taps, Geom g, int vec_ok) {
  extern __shared__ __align__(16) float smem[];
  const int4* runs = copy_table(smem, g, table, n_runs, n_taps);
  const float* coefs = reinterpret_cast<const float*>(runs + n_runs);
  const bool vec = vec_ok != 0;
  const long long o_state = (long long)g.o0 * g.o1 * g.o2;
  const int lane = threadIdx.x & 31;
  const int tx = lane % kTx;
  const int ty = (threadIdx.x >> 5) * (32 / kTx) + lane / kTx;
  const int rows = g.b0 * g.b1;
  const int chunks = (g.b2 + kV - 1) / kV;
  // the first row of this thread, as (p0, p1); later rows step by kTy
  const int p0_first = ty / g.b1, p1_first = ty - (ty / g.b1) * g.b1;

  const Tile tl = tile_of(g, blockIdx.x);
  const T* xs = x + (long long)tl.state * (g.x0 * g.x1 * g.x2);
  const Planes slab{kWrap ? tl.g0 - g.h0 : tl.g0, g.s0, 0, g.s0};
  load_planes<T, kWrap, false>(smem, xs, g, slab, tl.g1, tl.g2);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
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
    row_outputs<T, false>(row, runs, coefs, n_runs, 0, 0, tx, row_chunks, e2, orow, os, aux0,
                          aux1, n_aux, vec);
    p1 += kTy;
    while (p1 >= g.b1) { p1 -= g.b1; ++p0; }
  }
}

// The axis-0 walk: one block a column of g.walk tiles along axis 0 (their
// common tile on axes 1-2), through a ring of g.ring slab planes.  A step
// computes g.q output planes from the 2 h0 + q planes they read while the
// next g.ahead groups of q planes load; input plane p of the walk sits in
// slot p mod ring.
// The tap table is the slab's: a run's offset is its plane times the
// plane's words (s1 rows at the pitch) plus its offset inside the plane, so
// only a run whose plane lies past the ring's last slot moves, by the
// ring's words (row_outputs).
template <typename T, bool kWrap>
__global__ void __launch_bounds__(kThreads) stencil_step_kernel_walk(
    const T* __restrict__ x, T* __restrict__ out, const float* __restrict__ aux0,
    const float* __restrict__ aux1, int n_aux, const int* __restrict__ table, int n_runs,
    int n_taps, Geom g, int vec_ok) {
  extern __shared__ __align__(16) float smem[];
  const int4* runs = copy_table(smem, g, table, n_runs, n_taps);
  const float* coefs = reinterpret_cast<const float*>(runs + n_runs);
  const bool vec = vec_ok != 0;
  const int lane = threadIdx.x & 31;
  const int tx = lane % kTx;
  const int ty = (threadIdx.x >> 5) * (32 / kTx) + lane / kTx;
  const int rows = g.q * g.b1;
  const int chunks = (g.b2 + kV - 1) / kV;
  const int p0_first = ty / g.b1, p1_first = ty - (ty / g.b1) * g.b1;
  const int plane_words = g.s1 * g.pitch;
  const int ring_words = g.ring * plane_words;

  // block -> (state, walk, column), the column's tiles in order along axis 0
  const int per_state = g.walks0 * g.tiles1 * g.tiles2;
  const int state = blockIdx.x / per_state;
  const int rem = blockIdx.x - state * per_state;
  const int q12 = rem / g.tiles2;
  const int w = q12 / g.tiles1;
  const int g0 = w * g.walk * g.b0;
  const int g1 = (q12 - w * g.tiles1) * g.b1;
  const int g2 = (rem - q12 * g.tiles2) * g.b2;
  // the walk's planes of whole tiles (wrap mode: those past the state are
  // neither computed nor stored), and the input planes they read
  const int len = min(g.walk * g.b0, (g.o0 + g.b0 - 1) / g.b0 * g.b0 - g0);
  const int n_in = len + 2 * g.h0;
  const T* xs = x + (long long)state * (g.x0 * g.x1 * g.x2);
  T* os = out + (long long)state * ((long long)g.o0 * g.o1 * g.o2);
  const int e1 = kWrap ? min(g.b1, g.o1 - g1) : g.b1;
  const int e2 = kWrap ? min(g.b2, g.o2 - g2) : g.b2;
  const int live_chunks = kWrap ? (e2 + kV - 1) / kV : chunks;
  const int org0 = kWrap ? g0 - g.h0 : g0;
  // input planes [p, p + n) of the walk into their slots (f32: start the copies)
  auto load = [&](int p, int n) {
    n = min(n, n_in - p);
    if (n > 0)
      load_planes<T, kWrap, true>(smem, xs, g, Planes{org0 + p, n, p % g.ring, g.ring}, g1, g2);
  };
  const int first = g.q + 2 * g.h0;  // the planes of the first step
  load(0, first);
  cp_async_commit();
  for (int a = 0; a < g.ahead; ++a) {
    load(first + a * g.q, g.q);
    cp_async_commit();
  }
  int slot = 0;  // the slot of the step's first input plane
  for (int j = 0; j * g.q < len; ++j) {
    cp_async_wait_ahead(g.ahead);
    __syncthreads();
    int p0 = p0_first, p1 = p1_first;
    for (int r = ty; r < rows; r += kTy) {
      const int plane = j * g.q + p0;
      if (plane < len && (!kWrap || (g0 + plane < g.o0 && p1 < e1))) {
        const int s = slot + p0 < g.ring ? slot + p0 : slot + p0 - g.ring;
        const float* row = smem + s * plane_words + p1 * g.pitch;
        const long long orow = ((long long)(g0 + plane) * g.o1 + (g1 + p1)) * g.o2 + g2;
        row_outputs<T, true>(row, runs, coefs, n_runs, (g.ring - s) * plane_words, ring_words,
                             tx, live_chunks, e2, orow, os, aux0, aux1, n_aux, vec);
      }
      p1 += kTy;
      while (p1 >= g.b1) { p1 -= g.b1; ++p0; }
    }
    __syncthreads();  // the step's first q slots are free: the planes a ring ahead go there
    load(first + (j + g.ahead) * g.q, g.q);
    cp_async_commit();
    slot = slot + g.q < g.ring ? slot + g.q : slot + g.q - g.ring;
  }
}

template <typename T>
cudaError_t launch(const void* x, void* out, const float* aux0, const float* aux1,
                   int n_aux, const int* table, int n_taps, int batch, int o0, int o1,
                   int o2, int b0, int b1, int b2, int h0, int h1, int h2, int n_runs,
                   int pitch, int vec, int aligned, int wrap, int lead, int walk,
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
  const int tiles0 = (o0 + b0 - 1) / b0;
  g.tiles_per_state = tiles0 * g.tiles1 * g.tiles2;
  g.slab_words = (g.s0 * g.s1 * pitch + g.lead + 3) / 4 * 4;
  g.aligned = aligned;
  // the walk (== matrixization.step_walk_planes): a step's rows give every
  // thread row a row (q * b1 >= kTy), two groups load ahead where the ring
  // then holds no more planes than the slab (3 q <= b0), one otherwise
  // (2 q <= b0)
  g.walk = walk;
  g.q = min((kTy + b1 - 1) / b1, b0 / 2);
  g.ahead = b0 >= 3 * g.q ? 2 : 1;
  g.ring = 2 * h0 + (1 + g.ahead) * g.q;
  g.walks0 = walk > 0 ? (tiles0 + walk - 1) / walk : 0;
  if (walk) g.slab_words = (g.ring * g.s1 * pitch + g.lead + 3) / 4 * 4;
  if (pitch < (g.s2 + 3) / 4 * 4 + (b2 % kV ? kV : 0) || pitch % 8 != 4)
    return cudaErrorInvalidValue;
  // valid mode: whole tiles; wrap mode: a lead in [0, 4), and with 16-byte
  // copies, input columns equal to their storage columns modulo 4
  if (!wrap && (o0 % b0 || o1 % b1 || o2 % b2)) return cudaErrorInvalidValue;
  if (wrap && (lead < 0 || lead > 3 || (aligned && (b2 % 4 || o2 % 4 || (lead + h2) % 4))))
    return cudaErrorInvalidValue;
  if (walk < 0 || (walk > 0 && g.q < 1)) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)g.slab_words + 4 * n_runs + n_taps);
  auto kernel = walk ? (wrap ? stencil_step_kernel_walk<T, true>
                             : stencil_step_kernel_walk<T, false>)
                     : (wrap ? stencil_step_kernel<T, true> : stencil_step_kernel<T, false>);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const long long n_blocks =
      (long long)(walk ? g.walks0 * g.tiles1 * g.tiles2 : g.tiles_per_state) * batch;
  if (n_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(int)n_blocks, kThreads, smem, stream>>>(static_cast<const T*>(x), static_cast<T*>(out),
                                                    aux0, aux1, n_aux, table, n_runs, n_taps, g,
                                                    vec);
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
// aligned (f32 only).  walk: tiles a block walks along axis 0
// (matrixization.step_walk), 0 for one slab a block.  Returns the
// cudaError_t of the launch (0 = cudaSuccess).
extern "C" int stencil_step_launch(const void* x, void* out, const float* aux0,
                                   const float* aux1, int n_aux, const int* table,
                                   int n_taps, int is_bf16, int batch, int o0, int o1,
                                   int o2, int b0, int b1, int b2, int h0, int h1,
                                   int h2, int n_runs, int pitch, int vec, int aligned,
                                   int wrap, int lead, int walk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(x, out, aux0, aux1, n_aux, table, n_taps, batch, o0,
                                      o1, o2, b0, b1, b2, h0, h1, h2, n_runs, pitch, vec,
                                      aligned, wrap, lead, walk, s)
              : launch<float>(x, out, aux0, aux1, n_aux, table, n_taps, batch, o0, o1, o2,
                              b0, b1, b2, h0, h1, h2, n_runs, pitch, vec, aligned, wrap,
                              lead, walk, s);
  return (int)err;
}
