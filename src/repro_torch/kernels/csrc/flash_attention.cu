// Causal or full flash-attention forward on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// ::flash_attention_pallas (body _kernel): grid (batch*heads, S/block_q);
// each instance scales its (block_q, Dh) query block, walks the KV blocks
// in order with the online-softmax update (m_new = max(m, max s);
// p = exp(s - m_new); corr = exp(m - m_new); l = l*corr + sum p;
// acc = acc*corr + p @ v), masks k_pos > q_pos to -1e30 when causal,
// accumulates in f32 and writes acc / max(l, 1e-30) in q's type.
//
// Here one CUDA block owns one (b*h, q-block) pair, the same grid:
//   * each query row belongs to G = Dh/64 threads (1 for Dh <= 64), each
//     holding its contiguous share of the scaled row and of the f32
//     accumulator in registers; partial dot products meet by warp shuffle;
//   * the block streams each (block_k, Dh) K and V tile through shared
//     memory as f32 (contiguous, coalesced loads);
//   * per tile, in _kernel's order: a first pass over the tile's scores
//     finds the tile maximum, then m, l and acc are rescaled by
//     corr = exp(m - m_new), and a second pass recomputes each score,
//     forms p = exp(s - m_new) and accumulates l and p * v.  Recomputing
//     the scores keeps no (block_q, block_k) score tile in shared memory;
//   * in causal mode the KV tiles wholly after the block's last query are
//     skipped: there every p is exp(-1e30 - m) = 0 and corr = 1 (tile 0
//     holds key 0, so m is finite from the first tile on), so skipping
//     them leaves every sum unchanged.
// All arithmetic is f32 FMAs on the CUDA cores (no TF32, no tensor cores).
//
// What bounds it on this card: per (b, h) it reads Q, K, V once and writes
// O once (S*Dh each) but does 4*S^2*Dh flops (half that when causal), so
// at Hymba's widths (S = 1536, Dh = 64) it is bound by operations, 67
// TFLOP/s f32, not bytes.  This first version is further bound by
// shared-memory loads: every FMA of the two products reads one K or V
// element from shared memory (a broadcast across the warp), and the score
// pass runs twice.  wgmma on bf16/TF32 tiles and TMA loads are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kMaxThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Shared-memory layout of one (block_k, DH) tile: row j, thread share g,
// element i at j*stride + g*(DPT + pad) + i; the pad of one float between
// shares keeps the G threads of a row on different banks.
template <int DH, int G>
struct TileLayout {
  static constexpr int kDpt = DH / G;
  static constexpr int kPad = G > 1 ? 1 : 0;
  static constexpr int kStride = G * (kDpt + kPad);
};

template <int DH, int G>
__device__ __forceinline__ float row_score(const float* qr, const float* krow) {
  constexpr int kDpt = DH / G;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kDpt; ++i) s = fmaf(qr[i], krow[i], s);
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

template <typename T, int DH, int G>
__global__ void __launch_bounds__(kMaxThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int s_len, int bq, int bk, float scale, int causal) {
  using L = TileLayout<DH, G>;
  constexpr int kDpt = L::kDpt;
  extern __shared__ float smem[];
  float* ks = smem;                      // (bk, stride)
  float* vs = smem + bk * L::kStride;    // (bk, stride)

  const int row = threadIdx.x / G, g = threadIdx.x % G;
  const int q_pos = blockIdx.x * bq + row;
  const long long base = (long long)blockIdx.y * s_len * DH;
  const int share = g * (kDpt + L::kPad);

  float qr[kDpt], acc[kDpt];
  const T* qrow = q + base + (long long)q_pos * DH + g * kDpt;
#pragma unroll
  for (int i = 0; i < kDpt; ++i) {
    qr[i] = to_f32(qrow[i]) * scale;
    acc[i] = 0.f;
  }
  float m = kNeg, l = 0.f;

  const int nk = s_len / bk;
  const int last_q = blockIdx.x * bq + bq - 1;
  const int nk_run = causal ? min(nk, last_q / bk + 1) : nk;
  for (int kj = 0; kj < nk_run; ++kj) {
    __syncthreads();  // every thread is done with the previous tile
    const long long tile = base + (long long)kj * bk * DH;
    for (int e = threadIdx.x; e < bk * DH; e += blockDim.x) {
      const int j = e / DH, dd = e % DH;
      const int at = j * L::kStride + (dd / kDpt) * (kDpt + L::kPad) + dd % kDpt;
      ks[at] = to_f32(k[tile + e]);
      vs[at] = to_f32(v[tile + e]);
    }
    __syncthreads();

    const int k0 = kj * bk;
    float m_tile = kNeg;
    for (int j = 0; j < bk; ++j) {
      float s = row_score<DH, G>(qr, ks + j * L::kStride + share);
      if (causal && k0 + j > q_pos) s = kNeg;
      m_tile = fmaxf(m_tile, s);
    }
    const float m_new = fmaxf(m, m_tile);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int i = 0; i < kDpt; ++i) acc[i] *= corr;
    for (int j = 0; j < bk; ++j) {
      float s = row_score<DH, G>(qr, ks + j * L::kStride + share);
      if (causal && k0 + j > q_pos) s = kNeg;
      const float p = expf(s - m_new);
      l += p;
      const float* vrow = vs + j * L::kStride + share;
#pragma unroll
      for (int i = 0; i < kDpt; ++i) acc[i] = fmaf(p, vrow[i], acc[i]);
    }
    m = m_new;
  }

  const float denom = fmaxf(l, 1e-30f);
  T* orow = o + base + (long long)q_pos * DH + g * kDpt;
#pragma unroll
  for (int i = 0; i < kDpt; ++i) from_f32(orow + i, acc[i] / denom);
}

template <typename T, int DH>
cudaError_t launch_dh(const void* q, const void* k, const void* v, void* o, int bh,
                      int s_len, int bq, int bk, float scale, int causal,
                      cudaStream_t stream) {
  constexpr int G = DH > 64 ? DH / 64 : 1;
  using L = TileLayout<DH, G>;
  const int threads = bq * G;
  if (threads > kMaxThreads || (G > 1 && threads % 32 != 0)) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 2 * (size_t)bk * L::kStride;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, DH, G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(s_len / bq), (unsigned)bh);
  flash_attention_kernel<T, DH, G><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), s_len, bq, bk, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh,
                   int s_len, int dh, int bq, int bk, float scale, int causal,
                   cudaStream_t stream) {
  switch (dh) {
    case 8: return launch_dh<T, 8>(q, k, v, o, bh, s_len, bq, bk, scale, causal, stream);
    case 16: return launch_dh<T, 16>(q, k, v, o, bh, s_len, bq, bk, scale, causal, stream);
    case 64: return launch_dh<T, 64>(q, k, v, o, bh, s_len, bq, bk, scale, causal, stream);
    case 128: return launch_dh<T, 128>(q, k, v, o, bh, s_len, bq, bk, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: (bh, s_len, dh) contiguous, f32 or bf16 (is_bf16); s_len a
// multiple of bq and bk; dh in {8, 16, 64, 128}; bq * max(1, dh/64) <=
// 256 threads.  Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, int is_bf16, int bh, int s_len, int dh,
                                      int bq, int bk, float scale, int causal,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(q, k, v, o, bh, s_len, dh, bq, bk, scale, causal, s)
              : launch<float>(q, k, v, o, bh, s_len, dh, bq, bk, scale, causal, s);
  return (int)err;
}
