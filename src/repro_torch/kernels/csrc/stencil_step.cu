// One valid-mode matrixized stencil step on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/stencil_mxu.py
// ::stencil_pallas_call (body _make_kernel -> _apply_step).  There each grid
// instance owns one output tile, reads an overlapping haloed window of the
// input (pl.Element BlockSpecs), contracts one stacked Toeplitz operator per
// axis against it on the MXU, adds the single-tap lines as scaled shifts,
// accumulates in f32, multiplies by the scenario field and mask, and casts.
//
// Here one CUDA block owns one output tile of one state:
//   * it computes its tile origin from blockIdx.x and the extents it is given
//     (blockIdx.y is the state of a batch: the states are independent grids
//     and do not share a block's shared memory);
//   * it loads the haloed slab, converted to f32, into shared memory;
//   * each thread accumulates its outputs over the plan's flat tap list —
//     every coefficient line's band with its zero entries skipped (the
//     banded-Toeplitz contraction's arithmetic without its structural zeros),
//     then the point taps — in f32 with fused multiply-adds, in the same
//     order as the port's plain version (stencil_mxu.stencil_step_plain);
//   * it multiplies by the output-aligned field, then the mask, and casts to
//     the state's type on the store.
//
// What bounds it on this card: a stencil step moves one haloed read and one
// write per point and does 2*taps flops per point, so for the paper's
// stencils it sits far below the ridge of 67 TFLOP/s f32 over 3.35 TB/s
// (~20 flop/byte): device-memory bytes bound it.  The design reads every
// input byte once per tile (halo re-reads are the only overhead, set by the
// planner's tile choice), keeps every reuse in shared memory, and coalesces
// loads and stores along the contiguous axis.  Inside the block each tap is
// one shared-memory load and one FMA, so a deep fused operator with many taps
// becomes bound by shared-memory bandwidth instead; tensor cores, TMA and a
// persistent schedule are later work.
//
// A 2-D problem is passed as 3-D with a leading extent of 1 and no halo on
// it.  The output extents are multiples of the tile (the wrapper pads).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads) stencil_step_kernel(
    const T* __restrict__ x, T* __restrict__ out,
    const float* __restrict__ aux0, const float* __restrict__ aux1, int n_aux,
    const float* __restrict__ coef, const int* __restrict__ off, int n_taps,
    int o0, int o1, int o2, int b0, int b1, int b2, int h0, int h1, int h2,
    int tiles1, int tiles2) {
  extern __shared__ float slab[];
  const int s0 = b0 + 2 * h0, s1 = b1 + 2 * h1, s2 = b2 + 2 * h2;
  const long long x1 = o1 + 2 * h1, x2 = o2 + 2 * h2;
  const long long x_state = (long long)(o0 + 2 * h0) * x1 * x2;
  const long long o_state = (long long)o0 * o1 * o2;

  // tile origin: the same index in the output and in the haloed input
  const int tile = blockIdx.x;
  const int g2 = (tile % tiles2) * b2;
  const int g1 = ((tile / tiles2) % tiles1) * b1;
  const int g0 = (tile / (tiles2 * tiles1)) * b0;
  const T* xs = x + (long long)blockIdx.y * x_state;
  T* os = out + (long long)blockIdx.y * o_state;

  const int n_slab = s0 * s1 * s2;
  for (int i = threadIdx.x; i < n_slab; i += blockDim.x) {
    const int i2 = i % s2, i1 = (i / s2) % s1, i0 = i / (s2 * s1);
    slab[i] = to_f32(xs[((g0 + i0) * x1 + (g1 + i1)) * x2 + (g2 + i2)]);
  }
  __syncthreads();

  const int n_out = b0 * b1 * b2;
  for (int j = threadIdx.x; j < n_out; j += blockDim.x) {
    const int p2 = j % b2, p1 = (j / b2) % b1, p0 = j / (b2 * b1);
    const float* base = slab + (p0 * s1 + p1) * s2 + p2;
    float acc = 0.f;
    for (int t = 0; t < n_taps; ++t) acc = fmaf(__ldg(coef + t), base[__ldg(off + t)], acc);
    const long long o = ((long long)(g0 + p0) * o1 + (g1 + p1)) * o2 + (g2 + p2);
    if (n_aux > 0) acc *= __ldg(aux0 + o);
    if (n_aux > 1) acc *= __ldg(aux1 + o);
    from_f32(os + o, acc);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* out, const float* aux0, const float* aux1,
                   int n_aux, const int* taps, int n_taps, int batch, int o0, int o1,
                   int o2, int b0, int b1, int b2, int h0, int h1, int h2,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(b0 + 2 * h0) * (b1 + 2 * h1) * (b2 + 2 * h2);
  cudaError_t err = cudaFuncSetAttribute(stencil_step_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles1 = o1 / b1, tiles2 = o2 / b2;
  const dim3 grid((unsigned)((o0 / b0) * tiles1 * tiles2), (unsigned)batch);
  const float* coef = reinterpret_cast<const float*>(taps);
  stencil_step_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), aux0, aux1, n_aux, coef,
      taps + n_taps, n_taps, o0, o1, o2, b0, b1, b2, h0, h1, h2, tiles1, tiles2);
  return cudaGetLastError();
}

}  // namespace

// taps: 2*n_taps int32 words — the f32 coefficients' bits, then each tap's
// offset into the shared-memory slab (strides of the haloed tile).
// Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int stencil_step_launch(const void* x, void* out, const float* aux0,
                                   const float* aux1, int n_aux, const int* taps,
                                   int n_taps, int is_bf16, int batch, int o0, int o1,
                                   int o2, int b0, int b1, int b2, int h0, int h1,
                                   int h2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(x, out, aux0, aux1, n_aux, taps, n_taps, batch,
                                      o0, o1, o2, b0, b1, b2, h0, h1, h2, s)
              : launch<float>(x, out, aux0, aux1, n_aux, taps, n_taps, batch, o0, o1,
                              o2, b0, b1, b2, h0, h1, h2, s);
  return (int)err;
}
