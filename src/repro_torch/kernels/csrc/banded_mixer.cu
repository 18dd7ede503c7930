// Causal banded sequence mixer on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/banded_mixer.py
// ::banded_mixer_pallas_call (bodies _shared_kernel and _depthwise_kernel):
//
//     y[b, t, d] = sum_{s < W} band[s(, d)] * x[b, t - s, d],  x[b, <0, d] = 0
//
// There a (W,) band shared by all channels becomes a (bt, bt+W-1) Toeplitz
// matrix contracted on the MXU per (bt, bd) tile, and a (W, D) depthwise
// band W scaled shifts on the VPU; the caller pads T and D to tile
// multiples and maps the batch.  Here both modes are one kernel: the
// Toeplitz product with one band IS the same W-tap FMA chain as the
// depthwise case with the band broadcast over channels, so no Toeplitz
// matrix is built on the card.
//
// One CUDA block owns one (bt, bd) output tile of one sequence:
//   * blockIdx.x walks channel tiles, blockIdx.y time tiles, blockIdx.z the
//     batch (a grid dimension, not a host loop);
//   * it stages the (bt + W - 1, bd) input slab — W - 1 rows of history in
//     front — in shared memory as f32, with zeros before t = 0 and past the
//     ragged ends of T and D (no pad copy in device memory), and the band's
//     (W, bd) slice (or its W shared taps) beside it;
//   * each thread accumulates its outputs over s = 0..W-1 in f32 with fused
//     multiply-adds, the order of the plain version
//     (banded_mixer.banded_mixer_plain), and casts to x's type on the store.
//
// What bounds it on this card: per output it reads one input and writes
// one, and does 2W flops (W = 4 on the path), so at 3.35 TB/s against
// 67 TFLOP/s f32 it is bound by device-memory bytes by a wide margin.  The
// design reads each input once per tile (the W - 1 history rows are the
// only re-read), coalesces every load and store along the contiguous
// channel axis, and keeps all reuse in shared memory.  A decode step's
// input (W rows) is a few hundred KB, so there the launch itself bounds it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads) banded_mixer_kernel(
    const T* __restrict__ x, T* __restrict__ out, const float* __restrict__ band,
    int depthwise, int w, int t_len, int d, int bt, int bd) {
  extern __shared__ float smem[];
  const int rows = bt + w - 1;
  float* slab = smem;                  // (bt + w - 1, bd)
  float* taps = smem + rows * bd;      // (w, bd) depthwise, (w,) shared

  const int d0 = blockIdx.x * bd;
  const int t0 = blockIdx.y * bt;
  const long long seq = (long long)t_len * d;
  const T* xs = x + blockIdx.z * seq;
  T* os = out + blockIdx.z * seq;

  for (int i = threadIdx.x; i < rows * bd; i += blockDim.x) {
    const int r = i / bd, c = i % bd;
    const int t = t0 - (w - 1) + r, dd = d0 + c;
    slab[i] = (t >= 0 && t < t_len && dd < d) ? to_f32(xs[(long long)t * d + dd]) : 0.f;
  }
  if (depthwise) {
    for (int i = threadIdx.x; i < w * bd; i += blockDim.x) {
      const int s = i / bd, dd = d0 + i % bd;
      taps[i] = dd < d ? band[(long long)s * d + dd] : 0.f;
    }
  } else {
    for (int i = threadIdx.x; i < w; i += blockDim.x) taps[i] = band[i];
  }
  __syncthreads();

  for (int j = threadIdx.x; j < bt * bd; j += blockDim.x) {
    const int r = j / bd, c = j % bd;
    const int t = t0 + r, dd = d0 + c;
    if (t >= t_len || dd >= d) continue;
    float acc = 0.f;
    for (int s = 0; s < w; ++s) {
      const float b = depthwise ? taps[s * bd + c] : taps[s];
      acc = fmaf(b, slab[(r + w - 1 - s) * bd + c], acc);
    }
    from_f32(os + (long long)t * d + dd, acc);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* out, const float* band, int depthwise, int w,
                   int batch, int t_len, int d, int bt, int bd, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)(bt + w - 1) * bd + (size_t)w * bd);
  cudaError_t err = cudaFuncSetAttribute(banded_mixer_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((d + bd - 1) / bd), (unsigned)((t_len + bt - 1) / bt),
                  (unsigned)batch);
  banded_mixer_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), band, depthwise, w, t_len, d, bt,
      bd);
  return cudaGetLastError();
}

}  // namespace

// x, out: (batch, t_len, d) contiguous, f32 or bf16 (is_bf16); band: f32,
// (w, d) when depthwise else (w,).  Returns the cudaError_t of the launch
// (0 = cudaSuccess).
extern "C" int banded_mixer_launch(const void* x, void* out, const float* band,
                                   int depthwise, int w, int is_bf16, int batch,
                                   int t_len, int d, int bt, int bd, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(x, out, band, depthwise, w, batch, t_len, d, bt, bd, s)
              : launch<float>(x, out, band, depthwise, w, batch, t_len, d, bt, bd, s);
  return (int)err;
}
