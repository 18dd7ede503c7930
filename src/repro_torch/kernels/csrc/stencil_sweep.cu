// T valid-mode stencil steps in one kernel on Hopper (sm_90a): in-kernel
// temporal blocking with shared-memory intermediates.
//
// Replaces the Pallas TPU kernel src/repro/kernels/stencil_mxu.py
// ::sweep_pallas_call (body _make_sweep_kernel).  There each grid instance
// owns one output tile plus its T*r-deep haloed slab, runs T steps of the
// base operator on it (each step's Toeplitz set sized to the shrinking live
// extent, each step rescaled by the field/mask sub-slice at offset (s+1)*r),
// keeps the intermediates in VMEM scratch (a ping-pong pair, or one buffer
// under scratch="single"), and writes only the final state.
//
// Here one CUDA block owns one output tile of one state (blockIdx.y is the
// state of a batch):
//   * it loads the T*r-deep haloed slab, converted to f32, into shared memory;
//   * the slab keeps ONE frame for all steps: step s reads the live window at
//     offset s*r and writes its output at offset (s+1)*r, so every tap has the
//     same slab offset at every step and the live region shrinks by r per side;
//   * each step applies the plan's flat tap list (the bands with zeros skipped,
//     then the point taps) in f32 with FMAs, scales by the slab-aligned field
//     and mask at the step's output position, and stores the result;
//   * scratch "pingpong": two slab buffers, step s reads one and writes the
//     other, with __syncthreads() between steps;
//   * scratch "single": one buffer.  Each thread first computes all of its
//     outputs of the step into registers, then all threads sync, then they
//     write back in place, then sync again.  Without that ordering a thread
//     would overwrite inputs another thread has not read yet.  A thread holds
//     at most kSlots outputs, so the live extent is bounded by
//     kThreads * kSlots (matrixization.sweep_feasible prices this);
//   * the last step stores straight to device memory in the state's type.
//
// What bounds it on this card: one T*r-haloed read and one write per chunk
// of T steps, the same device-memory traffic as the operator-fused step, but
// with T base-radius steps of work instead of one (2Tr+1)-wide operator, so
// up to ~20 flop/byte of arithmetic intensity it stays bound by device-memory
// bytes; beyond it, by the per-tap shared-memory loads.  The design trades
// halo recompute (the shrinking live extent) for T-fold less traffic, and
// keeps the working set in shared memory, which caps the tile:
// matrixization.sweep_smem_bytes is the planner's feasibility bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 512;  // == matrixization.SWEEP_THREADS
constexpr int kSlots = 32;     // == matrixization.SINGLE_SLOTS

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

struct Frame {
  int s0, s1, s2;           // slab extents (tile + 2*steps*halo)
  long long x1, x2;         // input / aux extents of axes 1, 2
  int g0, g1, g2;           // tile origin
};

// One output of step s at live position p: the tap sum over the input window
// at slab offset s*h, then the field and mask at the output's slab position.
__device__ __forceinline__ float step_value(const float* src, const Frame& f, int p0,
                                            int p1, int p2, int in0, int in1, int in2,
                                            int out0, int out1, int out2,
                                            const float* __restrict__ coef,
                                            const int* __restrict__ off, int n_taps,
                                            const float* __restrict__ aux0,
                                            const float* __restrict__ aux1, int n_aux) {
  const float* base = src + ((p0 + in0) * f.s1 + (p1 + in1)) * f.s2 + (p2 + in2);
  float acc = 0.f;
  for (int t = 0; t < n_taps; ++t) acc = fmaf(__ldg(coef + t), base[__ldg(off + t)], acc);
  if (n_aux > 0) {
    const long long a = ((long long)(f.g0 + out0 + p0) * f.x1 + (f.g1 + out1 + p1)) * f.x2 +
                        (f.g2 + out2 + p2);
    acc *= __ldg(aux0 + a);
    if (n_aux > 1) acc *= __ldg(aux1 + a);
  }
  return acc;
}

template <typename T, bool kSingle>
__global__ void __launch_bounds__(kThreads) stencil_sweep_kernel(
    const T* __restrict__ x, T* __restrict__ out,
    const float* __restrict__ aux0, const float* __restrict__ aux1, int n_aux,
    const float* __restrict__ coef, const int* __restrict__ off, int n_taps,
    int o0, int o1, int o2, int b0, int b1, int b2, int h0, int h1, int h2,
    int steps, int tiles1, int tiles2) {
  extern __shared__ float smem[];
  Frame f;
  f.s0 = b0 + 2 * steps * h0;
  f.s1 = b1 + 2 * steps * h1;
  f.s2 = b2 + 2 * steps * h2;
  f.x1 = o1 + 2 * steps * h1;
  f.x2 = o2 + 2 * steps * h2;
  const long long x_state = (long long)(o0 + 2 * steps * h0) * f.x1 * f.x2;
  const long long o_state = (long long)o0 * o1 * o2;
  const int tile = blockIdx.x;
  f.g2 = (tile % tiles2) * b2;
  f.g1 = ((tile / tiles2) % tiles1) * b1;
  f.g0 = (tile / (tiles2 * tiles1)) * b0;
  const T* xs = x + (long long)blockIdx.y * x_state;
  T* os = out + (long long)blockIdx.y * o_state;

  const int n_slab = f.s0 * f.s1 * f.s2;
  float* bufs[2] = {smem, kSingle ? smem : smem + n_slab};
  for (int i = threadIdx.x; i < n_slab; i += blockDim.x) {
    const int i2 = i % f.s2, i1 = (i / f.s2) % f.s1, i0 = i / (f.s2 * f.s1);
    bufs[0][i] = to_f32(xs[((f.g0 + i0) * f.x1 + (f.g1 + i1)) * f.x2 + (f.g2 + i2)]);
  }
  __syncthreads();

  for (int s = 0; s < steps; ++s) {
    const float* src = bufs[s & 1];
    float* dst = bufs[(s + 1) & 1];
    // live output extent of step s and the slab offsets of its input / output
    const int e0 = b0 + 2 * (steps - 1 - s) * h0;
    const int e1 = b1 + 2 * (steps - 1 - s) * h1;
    const int e2 = b2 + 2 * (steps - 1 - s) * h2;
    const int in0 = s * h0, in1 = s * h1, in2 = s * h2;
    const int out0 = in0 + h0, out1 = in1 + h1, out2 = in2 + h2;
    const int n_live = e0 * e1 * e2;
    if (s == steps - 1) {
      for (int j = threadIdx.x; j < n_live; j += blockDim.x) {
        const int p2 = j % e2, p1 = (j / e2) % e1, p0 = j / (e2 * e1);
        const float v = step_value(src, f, p0, p1, p2, in0, in1, in2, out0, out1, out2,
                                   coef, off, n_taps, aux0, aux1, n_aux);
        from_f32(os + ((long long)(f.g0 + p0) * o1 + (f.g1 + p1)) * o2 + (f.g2 + p2), v);
      }
    } else if (!kSingle) {
      for (int j = threadIdx.x; j < n_live; j += blockDim.x) {
        const int p2 = j % e2, p1 = (j / e2) % e1, p0 = j / (e2 * e1);
        dst[((p0 + out0) * f.s1 + (p1 + out1)) * f.s2 + (p2 + out2)] =
            step_value(src, f, p0, p1, p2, in0, in1, in2, out0, out1, out2, coef, off,
                       n_taps, aux0, aux1, n_aux);
      }
      __syncthreads();
    } else {
      float vals[kSlots];
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        const int j = threadIdx.x + k * kThreads;
        if (j < n_live) {
          const int p2 = j % e2, p1 = (j / e2) % e1, p0 = j / (e2 * e1);
          vals[k] = step_value(src, f, p0, p1, p2, in0, in1, in2, out0, out1, out2, coef,
                               off, n_taps, aux0, aux1, n_aux);
        }
      }
      __syncthreads();  // every read of this step is done before any write-back
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        const int j = threadIdx.x + k * kThreads;
        if (j < n_live) {
          const int p2 = j % e2, p1 = (j / e2) % e1, p0 = j / (e2 * e1);
          dst[((p0 + out0) * f.s1 + (p1 + out1)) * f.s2 + (p2 + out2)] = vals[k];
        }
      }
      __syncthreads();
    }
  }
}

template <typename T, bool kSingle>
cudaError_t launch(const void* x, void* out, const float* aux0, const float* aux1,
                   int n_aux, const int* taps, int n_taps, int batch, int o0, int o1,
                   int o2, int b0, int b1, int b2, int h0, int h1, int h2, int steps,
                   cudaStream_t stream) {
  const size_t n_slab = (size_t)(b0 + 2 * steps * h0) * (b1 + 2 * steps * h1) *
                        (b2 + 2 * steps * h2);
  const size_t smem = sizeof(float) * n_slab * (kSingle ? 1 : 2);
  cudaError_t err = cudaFuncSetAttribute(stencil_sweep_kernel<T, kSingle>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles1 = o1 / b1, tiles2 = o2 / b2;
  const dim3 grid((unsigned)((o0 / b0) * tiles1 * tiles2), (unsigned)batch);
  const float* coef = reinterpret_cast<const float*>(taps);
  stencil_sweep_kernel<T, kSingle><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), aux0, aux1, n_aux, coef,
      taps + n_taps, n_taps, o0, o1, o2, b0, b1, b2, h0, h1, h2, steps, tiles1, tiles2);
  return cudaGetLastError();
}

}  // namespace

// taps: 2*n_taps int32 words — the f32 coefficients' bits, then each tap's
// offset into the shared-memory slab (strides of the T*r-haloed tile).
// x and the aux arrays are (o + 2*steps*h) per axis; out is o per axis.
// Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int stencil_sweep_launch(const void* x, void* out, const float* aux0,
                                    const float* aux1, int n_aux, const int* taps,
                                    int n_taps, int is_bf16, int batch, int o0, int o1,
                                    int o2, int b0, int b1, int b2, int h0, int h1,
                                    int h2, int steps, int single, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    err = single ? launch<__nv_bfloat16, true>(x, out, aux0, aux1, n_aux, taps, n_taps,
                                               batch, o0, o1, o2, b0, b1, b2, h0, h1, h2,
                                               steps, s)
                 : launch<__nv_bfloat16, false>(x, out, aux0, aux1, n_aux, taps, n_taps,
                                                batch, o0, o1, o2, b0, b1, b2, h0, h1, h2,
                                                steps, s);
  } else {
    err = single ? launch<float, true>(x, out, aux0, aux1, n_aux, taps, n_taps, batch, o0,
                                       o1, o2, b0, b1, b2, h0, h1, h2, steps, s)
                 : launch<float, false>(x, out, aux0, aux1, n_aux, taps, n_taps, batch, o0,
                                        o1, o2, b0, b1, b2, h0, h1, h2, steps, s);
  }
  return (int)err;
}
