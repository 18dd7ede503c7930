// Causal banded sequence mixer on Hopper (sm_90a): a streaming design with
// the band and the history in registers.
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
// What bounds it on this card: per output it reads one input and writes
// one, and does 2W flops (W = 4 on the path): ~1 flop per byte, far under
// the ridge of 67 TFLOP/s f32 over 3.35 TB/s, so device-memory bytes bound
// it, and a decode step's few hundred KB are bound by the launch itself.
// The design streams, with no shared memory and no barrier:
//   * one thread owns one group of kGroup = 16 bytes of consecutive channels
//     (4 f32 or 8 bf16) of one sequence and walks a run of `rows`
//     consecutive time steps (the tile's T extent); a block holds
//     block_d / kGroup threads along D, blockIdx.x walks (channel block,
//     time run) pairs and blockIdx.y the batch;
//   * it reads its band entries once into registers, and keeps the W - 1
//     previous inputs of its channels in registers: the run starts W - 1
//     rows early to fill them (zeros before t = 0), then every row is one
//     16-byte load, W FMAs per channel and one 16-byte store; the loads of
//     kRowsInFlight rows are issued before the first of them is used;
//   * loads and stores are 16 bytes wide where D is a multiple of kGroup
//     and the tensors are 16-byte aligned, neighbouring threads on
//     neighbouring addresses; otherwise (a D that is not a multiple, and
//     the ragged end of D) they are scalar and masked;
//   * the band width is a template parameter for W <= kMaxW, so the
//     history is a register array indexed by constants; a wider band takes
//     a generic path that reads its window straight from device memory
//     (the L1 cache holds it);
//   * a decode call (T = W rows) launches one thread per channel group of
//     each sequence, none idle but the ragged end of D.
// Per output the sum runs over s = 0..W-1 with f32 FMAs, the order of the
// plain version (banded_mixer.banded_mixer_plain), and casts to x's type on
// the store.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int kMaxThreads = 256;   // == banded_mixer.MAX_THREADS
constexpr int kMaxW = 8;           // == banded_mixer.MAX_REGISTER_W
constexpr int kRowsInFlight = 4;   // rows a thread loads before using them

template <typename T>
struct Group {
  static constexpr int kGroup = 16 / sizeof(T);  // == banded_mixer.group(dtype)
};

// Channels [d0, d0 + n) of one row into v (zeros past n): one 16-byte load
// when `wide`, else scalar loads.
__device__ __forceinline__ void load_group(const float* __restrict__ p, float (&v)[4], int n,
                                           bool wide) {
  if (wide) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = i < n ? __ldg(p + i) : 0.f;
  }
}

__device__ __forceinline__ void load_group(const __nv_bfloat16* __restrict__ p, float (&v)[8],
                                           int n, bool wide) {
  if (wide) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = i < n ? __bfloat162float(p[i]) : 0.f;
  }
}

__device__ __forceinline__ void store_group(float* p, const float (&v)[4], int n, bool wide) {
  if (wide) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < n) p[i] = v[i];
  }
}

__device__ __forceinline__ void store_group(__nv_bfloat16* p, const float (&v)[8], int n,
                                            bool wide) {
  if (wide) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < n) p[i] = __float2bfloat16(v[i]);
  }
}

// Band entry s of channel d0 + i (0 past the ragged end of D).
__device__ __forceinline__ float band_at(const float* __restrict__ band, int depthwise, int s,
                                         int d, int d0, int i, int n) {
  if (!depthwise) return __ldg(band + s);
  return i < n ? __ldg(band + (long long)s * d + d0 + i) : 0.f;
}

// W > 0: the band and the W - 1 previous rows in registers.  W == 0: any
// band width `w`, its window read from device memory.
template <typename T, int W>
__global__ void __launch_bounds__(kMaxThreads) banded_mixer_kernel(
    const T* __restrict__ x, T* __restrict__ out, const float* __restrict__ band,
    int depthwise, int w, int t_len, int d, int rows, int channel_blocks, int vec) {
  constexpr int G = Group<T>::kGroup;
  const int cb = blockIdx.x % channel_blocks;
  const int t0 = (blockIdx.x / channel_blocks) * rows;
  const int d0 = (cb * blockDim.x + threadIdx.x) * G;
  if (d0 >= d) return;
  const int t1 = min(t0 + rows, t_len);
  const int n = min(G, d - d0);
  const bool wide = vec && n == G;
  const long long seq = (long long)t_len * d;
  const T* xs = x + blockIdx.y * seq + d0;
  T* os = out + blockIdx.y * seq + d0;

  if constexpr (W > 0) {
    float b[W][G];
#pragma unroll
    for (int s = 0; s < W; ++s)
#pragma unroll
      for (int i = 0; i < G; ++i) b[s][i] = band_at(band, depthwise, s, d, d0, i, n);
    // hist[k] holds row t - 1 - k of the current row t
    float hist[W > 1 ? W - 1 : 1][G];
#pragma unroll
    for (int k = 0; k < W - 1; ++k) {
      const int t = t0 - 1 - k;
      if (t >= 0) {
        load_group(xs + (long long)t * d, hist[k], n, wide);
      } else {
#pragma unroll
        for (int i = 0; i < G; ++i) hist[k][i] = 0.f;
      }
    }
    // kRowsInFlight rows are loaded before any of them is used, so a short
    // run (a decode call) waits on memory about once
    for (int t = t0; t < t1; t += kRowsInFlight) {
      float rows[kRowsInFlight][G];
#pragma unroll
      for (int r = 0; r < kRowsInFlight; ++r)
        if (t + r < t1) load_group(xs + (long long)(t + r) * d, rows[r], n, wide);
#pragma unroll
      for (int r = 0; r < kRowsInFlight; ++r) {
        if (t + r >= t1) break;
        float acc[G];
#pragma unroll
        for (int i = 0; i < G; ++i) acc[i] = fmaf(b[0][i], rows[r][i], 0.f);
#pragma unroll
        for (int s = 1; s < W; ++s)
#pragma unroll
          for (int i = 0; i < G; ++i) acc[i] = fmaf(b[s][i], hist[s - 1][i], acc[i]);
        store_group(os + (long long)(t + r) * d, acc, n, wide);
#pragma unroll
        for (int k = W - 2; k > 0; --k)
#pragma unroll
          for (int i = 0; i < G; ++i) hist[k][i] = hist[k - 1][i];
        if constexpr (W > 1) {
#pragma unroll
          for (int i = 0; i < G; ++i) hist[0][i] = rows[r][i];
        }
      }
    }
  } else {
    for (int t = t0; t < t1; ++t) {
      float acc[G];
#pragma unroll
      for (int i = 0; i < G; ++i) acc[i] = 0.f;
      for (int s = 0; s < w && s <= t; ++s) {
        float v[G];
        load_group(xs + (long long)(t - s) * d, v, n, wide);
#pragma unroll
        for (int i = 0; i < G; ++i)
          acc[i] = fmaf(band_at(band, depthwise, s, d, d0, i, n), v[i], acc[i]);
      }
      store_group(os + (long long)t * d, acc, n, wide);
    }
  }
}

template <typename T, int W>
cudaError_t launch_w(const void* x, void* out, const float* band, int depthwise, int w,
                     int batch, int t_len, int d, int rows, int threads, int vec,
                     cudaStream_t stream) {
  constexpr int G = Group<T>::kGroup;
  const long long groups = (d + G - 1) / G;
  const long long channel_blocks = (groups + threads - 1) / threads;
  const long long runs = (t_len + rows - 1) / rows;
  if (channel_blocks * runs > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)(channel_blocks * runs), (unsigned)batch);
  banded_mixer_kernel<T, W><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), band, depthwise, w, t_len, d, rows,
      (int)channel_blocks, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, void* out, const float* band, int depthwise, int w,
                   int batch, int t_len, int d, int rows, int block_d, cudaStream_t stream) {
  constexpr int G = Group<T>::kGroup;
  if (rows < 1 || block_d < G || block_d % G != 0 || block_d / G > kMaxThreads || w < 1)
    return cudaErrorInvalidValue;
  const int threads = block_d / G;
  // 16-byte accesses: every row starts on a 16-byte boundary
  const int vec = d % G == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
#define BANDED_MIXER_W(N)                                                                     \
  case N:                                                                                     \
    return launch_w<T, N>(x, out, band, depthwise, w, batch, t_len, d, rows, threads, vec,    \
                          stream);
  static_assert(kMaxW == 8, "the cases below instantiate W = 1..kMaxW");
  switch (w) {
    BANDED_MIXER_W(1)
    BANDED_MIXER_W(2)
    BANDED_MIXER_W(3)
    BANDED_MIXER_W(4)
    BANDED_MIXER_W(5)
    BANDED_MIXER_W(6)
    BANDED_MIXER_W(7)
    BANDED_MIXER_W(8)
    default:
      return launch_w<T, 0>(x, out, band, depthwise, w, batch, t_len, d, rows, threads, vec,
                            stream);
  }
#undef BANDED_MIXER_W
}

}  // namespace

// x, out: (batch, t_len, d) contiguous, f32 or bf16 (is_bf16); band: f32,
// (w, d) when depthwise else (w,).  The tile: `rows` time steps a thread,
// `block_d` channels a block (a multiple of 16 bytes of channels).  Uses no
// shared memory.  Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int banded_mixer_launch(const void* x, void* out, const float* band,
                                   int depthwise, int w, int is_bf16, int batch,
                                   int t_len, int d, int rows, int block_d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(x, out, band, depthwise, w, batch, t_len, d, rows,
                                      block_d, s)
              : launch<float>(x, out, band, depthwise, w, batch, t_len, d, rows, block_d, s);
  return (int)err;
}
