// Causal or full flash-attention forward on Hopper (sm_90a), on the tensor
// cores: FlashAttention-2's schedule with mma.sync.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// ::flash_attention_pallas (body _kernel): grid (batch*heads, S/block_q);
// each instance scales its (block_q, Dh) query block, walks the KV blocks
// in order with the online-softmax update (m_new = max(m, max s);
// p = exp(s - m_new); corr = exp(m - m_new); l = l*corr + sum p;
// acc = acc*corr + p @ v), masks k_pos > q_pos to -1e30 when causal,
// accumulates in f32 and writes acc / max(l, 1e-30) in q's type.
//
// What bounds it on this card: per (b, h) it reads Q, K, V once and writes
// O once (S*Dh each) but does 4*S^2*Dh flops (half that when causal), so at
// Hymba's widths (S = 1536, Dh = 64) it is bound by operations, on the
// tensor cores: in bf16 at 989 TFLOP/s; in f32 at the repo's rule for f32 on
// tensor cores, 3xTF32 (three TF32 products per f32 product, 495/3 TFLOP/s),
// since plain TF32 (about three decimal digits) does not hold the f32 bars.
// mma.sync is used, not wgmma: it takes its A operand from registers in the
// m16n8 fragment layout that the online softmax produces, so P never goes
// through shared memory, and its fragment layouts are fixed and documented;
// wgmma's descriptor-addressed shared-memory operands and warpgroup-wide
// accumulators are later work.  The design:
//   * one CUDA block of kThreads = 128 (4 warps) owns kRows = 64 query rows of
//     one (b, h), 16 rows per warp; each warp keeps its Q fragment in
//     registers for the whole KV walk (f32 at Dh = 128, where the hi/lo
//     fragments would take 128 registers a thread, keeps the scaled Q block
//     in shared memory and splits each fragment when it is used);
//   * K and V tiles of kBk rows (64; 32 for f32 at Dh = 128) stream through
//     a ring of kStages = 2 buffers in shared memory with 16-byte cp.async
//     copies: tile t+1 loads while tile t is computed, and one barrier per
//     tile both publishes tile t and frees tile t-1's buffer (3 and 4
//     buffers measured no faster).  Rows are padded (4 f32 or 8 bf16
//     elements) so every fragment load below hits 32 distinct banks.  Q is
//     staged in the ring's last K buffer;
//   * S = Q K^T: bf16 as mma m16n8k16 (bf16 in, f32 accumulate; the K
//     fragment is one 32-bit load of two neighbouring elements); f32 as mma
//     m16n8k8.tf32 in 3xTF32: each operand is split a = hi + lo with
//     hi = tf32(a), lo = tf32(a - hi) (rounded by integer operations), and
//     a_lo*b_hi + a_hi*b_lo + a_hi*b_hi is accumulated (the lo*lo term,
//     ~2^-22 relative, is dropped).  At
//     Dh = 8 in bf16 the k dimension is padded to 16 with zero columns in
//     shared memory;
//   * the online softmax runs once per tile on the accumulator fragment:
//     each thread holds rows g and g+8 of the warp's 16 (g = lane/4) at
//     columns 2*(lane%4) + {0, 1} of every n8 tile, so the row max and row
//     sum finish with two quad shuffles; exp2 of log2e-scaled scores;
//     masked scores are -inf (m starts at -inf; tile 0 holds key 0, valid
//     for every row, so m is finite from the first tile on);
//   * P stays in registers as the A operand of P V.  bf16: the m16n8 C
//     layout of two neighbouring n8 tiles is the m16n8k16 A layout, and P
//     enters as two bf16 terms, hi = bf16(p) and lo = bf16(p - hi), so P V
//     keeps the f32 reference's accuracy before the output cast (a third more
//     products than bf16 P alone); V's fragment comes from ldmatrix.trans.
//     f32: P and V are split into TF32 hi/lo and P V is 3xTF32 as above; the
//     A layout of m16n8k8.tf32 wants columns t and t+4 where the C layout has
//     2t and 2t+1, so the key index is permuted inside each 8-key step (A
//     column t <-> key 2t, t+4 <-> 2t+1, and V's B rows alike): no shuffles;
//   * O accumulates in f32 registers (in f32, each tile's P V goes to a fresh
//     accumulator that is added to O by FMA: the tensor cores' f32 sums
//     round toward zero, and over a 1536-key walk that drift reached ~1e-5);
//     the epilogue writes acc / max(l, 1e-30) in q's type, masking rows past
//     S;
//   * causal: blocks start from the last query block (the longest KV walks
//     first), the KV walk stops after the tile holding the block's last
//     query, a warp skips the tiles wholly after its own last query (there
//     p = 0 and corr = 1 exactly), and the mask is evaluated only on the
//     tiles the diagonal or the end of the sequence crosses;
//   * a sequence that is not a multiple of the tiles is zero-filled on load
//     (cp.async with a source size of 0) and masked on store.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 128;      // == flash_attention.THREADS
constexpr int kRows = 64;          // == flash_attention.BLOCK_ROWS (16 per warp)
constexpr int kStages = 2;         // == flash_attention.STAGES
constexpr int kKvTileWide = 64;    // == flash_attention.KV_TILE
constexpr int kKvTileNarrow = 32;  // f32 at Dh = 128
constexpr int kPadF32 = 4;         // row padding, elements
constexpr int kPadBf16 = 8;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int DH>
struct Cfg {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kBk = (kF32 && DH == 128) ? kKvTileNarrow : kKvTileWide;
  static constexpr int kDk = kF32 ? DH : (DH < 16 ? 16 : DH);  // k extent of Q K^T
  static constexpr int kPad = kF32 ? kPadF32 : kPadBf16;
  static constexpr int kKs = kDk + kPad;  // K (and Q) row stride, elements
  static constexpr int kVs = DH + kPad;   // V row stride
  static constexpr bool kQReg = !(kF32 && DH == 128);
  static constexpr int kStageElems = kBk * (kKs + kVs);
  static constexpr int kSmemElems = kStages * kStageElems + (kQReg ? 0 : kRows * kKs);
  static constexpr int kSmemBytes = kSmemElems * (int)sizeof(T);
  static_assert(!kQReg || kRows <= kBk, "Q is staged in the last stage's K buffer");
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// round to TF32 (10 mantissa bits), to nearest with ties away from zero as
// cvt.rna.tf32.f32 does, in two integer operations at full rate (the
// conversion instruction runs at a quarter of that)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// 3xTF32: d += a_lo*b_hi + a_hi*b_lo + a_hi*b_hi
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// p = hi + lo in bf16 terms: the packed hi pair and the packed residual pair
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// rows [row0, row0 + ROWS) of a (s_len, DH) matrix into dst (row stride
// STRIDE elements) by 16-byte cp.async; rows past s_len are zero-filled.
template <typename T, int DH, int ROWS, int STRIDE>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int row0, int s_len) {
  constexpr int kElems = 16 / (int)sizeof(T);
  constexpr int kChunks = DH / kElems;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;  // powers of two
    const int row = row0 + r;
    const bool ok = row < s_len;
    cp_async16(dst + r * STRIDE + c * kElems, src + (long long)(ok ? row : 0) * DH + c * kElems,
               ok);
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int s_len, float scale, int causal) {
  using C = Cfg<T, DH>;
  constexpr int kBk = C::kBk, kKs = C::kKs, kVs = C::kVs, kDk = C::kDk;
  constexpr int kNt = kBk / 8;  // n8 tiles of S per KV tile
  constexpr int kOt = DH / 8;   // n8 tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  // stage s: K at smem + s*kStageElems, V right after it
  T* q_sm = smem + (C::kQReg ? kStages - 1 : kStages) * C::kStageElems;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int qb = causal ? (int)gridDim.x - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int q0 = qb * kRows;
  const int wq0 = q0 + warp * 16;
  const long long base = (long long)blockIdx.y * s_len * DH;
  const T* kb = k + base;
  const T* vb = v + base;

  if constexpr (kDk != DH) {  // bf16 at Dh < 16: zero the k padding of K and Q
    for (int i = threadIdx.x; i < (kStages * kBk + (C::kQReg ? 0 : kRows)) * (kDk - DH);
         i += kThreads) {
      const int r = i / (kDk - DH), c = DH + i % (kDk - DH);
      T* row = r < kStages * kBk ? smem + (r / kBk) * C::kStageElems + (r % kBk) * kKs
                                 : q_sm + (r - kStages * kBk) * kKs;
      row[c] = __float2bfloat16(0.f);
    }
  }

  const int n_kv = (s_len + kBk - 1) / kBk;
  const int n_run = causal ? min(n_kv, (q0 + kRows - 1) / kBk + 1) : n_kv;

  // prologue: Q with tile 0, then tiles 1 .. kStages-2, one group each
  load_rows<T, DH, kRows, kKs>(q_sm, q + base, q0, s_len);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_run) {
      T* st = smem + t * C::kStageElems;
      load_rows<T, DH, kBk, kKs>(st, kb, t * kBk, s_len);
      load_rows<T, DH, kBk, kVs>(st + kBk * kKs, vb, t * kBk, s_len);
    }
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();
  __syncthreads();

  // this warp's Q fragment: rows wq0 + g and wq0 + g + 8
  const T* qw = q_sm + warp * 16 * kKs;
  constexpr int kQFrag = C::kF32 ? DH / 8 : kDk / 16;  // k steps of Q K^T
  uint32_t qh[C::kQReg ? kQFrag : 1][4], ql[C::kF32 && C::kQReg ? kQFrag : 1][4];
  if constexpr (C::kQReg) {
    if constexpr (C::kF32) {
#pragma unroll
      for (int ks = 0; ks < DH / 8; ++ks) {
        const float* a = reinterpret_cast<const float*>(qw) + ks * 8 + tq;
        split_tf32(a[g * kKs] * scale, qh[ks][0], ql[ks][0]);
        split_tf32(a[(g + 8) * kKs] * scale, qh[ks][1], ql[ks][1]);
        split_tf32(a[g * kKs + 4] * scale, qh[ks][2], ql[ks][2]);
        split_tf32(a[(g + 8) * kKs + 4] * scale, qh[ks][3], ql[ks][3]);
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < kDk / 16; ++ks) {
        const T* a = qw + ks * 16 + 2 * tq;
        qh[ks][0] = *reinterpret_cast<const uint32_t*>(a + g * kKs);
        qh[ks][1] = *reinterpret_cast<const uint32_t*>(a + (g + 8) * kKs);
        qh[ks][2] = *reinterpret_cast<const uint32_t*>(a + g * kKs + 8);
        qh[ks][3] = *reinterpret_cast<const uint32_t*>(a + (g + 8) * kKs + 8);
      }
    }
  }

  float acc[kOt][4];
#pragma unroll
  for (int n = 0; n < kOt; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  // f32: Q is pre-scaled as in the reference; bf16: scale the f32 scores
  const float sl2 = (C::kF32 ? 1.f : scale) * kLog2e;

  for (int t = 0; t < n_run; ++t) {
    // tile t has landed, and every warp is done with tile t-1 (and with Q,
    // staged in the last stage): refill that stage with tile t+kStages-1
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (t + kStages - 1 < n_run) {
      T* nxt = smem + ((t + kStages - 1) % kStages) * C::kStageElems;
      load_rows<T, DH, kBk, kKs>(nxt, kb, (t + kStages - 1) * kBk, s_len);
      load_rows<T, DH, kBk, kVs>(nxt + kBk * kKs, vb, (t + kStages - 1) * kBk, s_len);
    }
    cp_async_commit();

    const int kbase = t * kBk;
    if (!(causal && kbase > wq0 + 15)) {  // else every p of this warp is 0
      const T* ks_t = smem + (t % kStages) * C::kStageElems;
      const T* vs_t = ks_t + kBk * kKs;

      // ---- S = Q K^T ------------------------------------------------------
      float s[kNt][4];
#pragma unroll
      for (int j = 0; j < kNt; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      if constexpr (C::kF32) {
        const float* kf = reinterpret_cast<const float*>(ks_t);
#pragma unroll
        for (int ks = 0; ks < DH / 8; ++ks) {
          uint32_t ah[4], al[4];
          if constexpr (C::kQReg) {
#pragma unroll
            for (int i = 0; i < 4; ++i) { ah[i] = qh[ks][i]; al[i] = ql[ks][i]; }
          } else {
            const float* a = reinterpret_cast<const float*>(qw) + ks * 8 + tq;
            split_tf32(a[g * kKs] * scale, ah[0], al[0]);
            split_tf32(a[(g + 8) * kKs] * scale, ah[1], al[1]);
            split_tf32(a[g * kKs + 4] * scale, ah[2], al[2]);
            split_tf32(a[(g + 8) * kKs + 4] * scale, ah[3], al[3]);
          }
#pragma unroll
          for (int j = 0; j < kNt; ++j) {
            const float* b = kf + (j * 8 + g) * kKs + ks * 8 + tq;
            uint32_t bh[2], bl[2];
            split_tf32(b[0], bh[0], bl[0]);
            split_tf32(b[4], bh[1], bl[1]);
            mma_3xtf32(s[j], ah, al, bh, bl);
          }
        }
      } else {
#pragma unroll
        for (int ks = 0; ks < kDk / 16; ++ks) {
#pragma unroll
          for (int j = 0; j < kNt; ++j) {
            const T* b = ks_t + (j * 8 + g) * kKs + ks * 16 + 2 * tq;
            const uint32_t bf[2] = {*reinterpret_cast<const uint32_t*>(b),
                                    *reinterpret_cast<const uint32_t*>(b + 8)};
            mma_bf16(s[j], qh[ks], bf);
          }
        }
      }

      // ---- online softmax, rows g (h = 0) and g + 8 (h = 1) ---------------
      const bool need_mask = kbase + kBk > s_len || (causal && kbase + kBk - 1 > wq0);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * sl2;
          if (need_mask) {
            const int key = kbase + j * 8 + 2 * tq + (e & 1);
            const int row = wq0 + g + (e >> 1) * 8;
            if (key >= s_len || (causal && key > row)) x = -INFINITY;
          }
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float corr[2], m_use[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        m_use[h] = m_new == -INFINITY ? 0.f : m_new;
        corr[h] = exp2f(m[h] - m_use[h]);
        m[h] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[j][e] - m_use[e >> 1]);
          s[j][e] = p;
          rs[e >> 1] += p;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + rs[h];

      // ---- O = O * corr + P V -----------------------------------------------
      if constexpr (C::kF32) {
        // this tile's P V in a fresh accumulator, added to O by FMA: the
        // tensor cores' f32 accumulation rounds toward zero, and a chain of
        // 3 products per 8 keys over a whole sequence would drift
        float pv[kOt][4];
#pragma unroll
        for (int n = 0; n < kOt; ++n) pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.f;
        const float* vf = reinterpret_cast<const float*>(vs_t);
#pragma unroll
        for (int j = 0; j < kNt; ++j) {
          // A column tq <-> key 2tq, column tq + 4 <-> key 2tq + 1
          uint32_t ah[4], al[4];
          split_tf32(s[j][0], ah[0], al[0]);
          split_tf32(s[j][2], ah[1], al[1]);
          split_tf32(s[j][1], ah[2], al[2]);
          split_tf32(s[j][3], ah[3], al[3]);
#pragma unroll
          for (int n = 0; n < kOt; ++n) {
            const float* b = vf + (j * 8 + 2 * tq) * kVs + n * 8 + g;
            uint32_t bh[2], bl[2];
            split_tf32(b[0], bh[0], bl[0]);
            split_tf32(b[kVs], bh[1], bl[1]);
            mma_3xtf32(pv[n], ah, al, bh, bl);
          }
        }
#pragma unroll
        for (int n = 0; n < kOt; ++n) {
          acc[n][0] = fmaf(acc[n][0], corr[0], pv[n][0]);
          acc[n][1] = fmaf(acc[n][1], corr[0], pv[n][1]);
          acc[n][2] = fmaf(acc[n][2], corr[1], pv[n][2]);
          acc[n][3] = fmaf(acc[n][3], corr[1], pv[n][3]);
        }
      } else {
#pragma unroll
        for (int n = 0; n < kOt; ++n) {
          acc[n][0] *= corr[0];
          acc[n][1] *= corr[0];
          acc[n][2] *= corr[1];
          acc[n][3] *= corr[1];
        }
#pragma unroll
        for (int kk = 0; kk < kBk / 16; ++kk) {
          uint32_t ph[4], pl[4];
          split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
          split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
          split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
          split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
          const T* vrow = vs_t + (kk * 16 + (lane & 15)) * kVs;
#pragma unroll
          for (int n = 0; n < kOt; ++n) {
            uint32_t b[2];
            ldmatrix_x2_trans(b, vrow + n * 8);
            mma_bf16(acc[n], pl, b);
            mma_bf16(acc[n], ph, b);
          }
        }
      }
    }
  }

  // ---- epilogue -------------------------------------------------------------
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = wq0 + g + 8 * h;
    if (row < s_len) {
      const float den = fmaxf(l[h], 1e-30f);
      T* orow = o + base + (long long)row * DH + 2 * tq;
#pragma unroll
      for (int n = 0; n < kOt; ++n) store2(orow + n * 8, acc[n][2 * h] / den, acc[n][2 * h + 1] / den);
    }
  }
}

template <typename T, int DH>
cudaError_t launch_dh(const void* q, const void* k, const void* v, void* o, int bh,
                      int s_len, float scale, int causal, cudaStream_t stream) {
  using C = Cfg<T, DH>;
  auto kernel = flash_attention_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         C::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((s_len + kRows - 1) / kRows), (unsigned)bh);
  kernel<<<grid, kThreads, C::kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), s_len, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh, int s_len,
                   int dh, float scale, int causal, cudaStream_t stream) {
  switch (dh) {
    case 8: return launch_dh<T, 8>(q, k, v, o, bh, s_len, scale, causal, stream);
    case 16: return launch_dh<T, 16>(q, k, v, o, bh, s_len, scale, causal, stream);
    case 64: return launch_dh<T, 64>(q, k, v, o, bh, s_len, scale, causal, stream);
    case 128: return launch_dh<T, 128>(q, k, v, o, bh, s_len, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: (bh, s_len, dh) contiguous and 16-byte aligned, f32 or bf16
// (is_bf16); dh in {8, 16, 64, 128}; any s_len >= 1 (the kernel masks the
// ragged end).  Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, int is_bf16, int bh, int s_len, int dh,
                                      float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_bf16
                        ? launch<__nv_bfloat16>(q, k, v, o, bh, s_len, dh, scale, causal, s)
                        : launch<float>(q, k, v, o, bh, s_len, dh, scale, causal, s);
  return (int)err;
}
