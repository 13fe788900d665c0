// Exact forward bilinear lookup of V per-view feature maps (border clamp,
// align_corners), for Hopper (sm_90a).
//
// Replaces: keypointnerf_tpu/ops/pallas/onehot_bilinear.py
//   onehot_bilinear_sample / multiview_onehot_bilinear_sample (`_kernel`).
// The TPU kernel reaches the lookup through one-hot MXU contractions
// (row weights x map, column weights, channel selector). Their zero terms
// are exact zeros, so the same function is the 2x2-corner form computed
// here, with the TPU kernel's rounding order kept step by step:
//   yw, xw          rounded to the map dtype                    (:61-68)
//   t_x  = rnd(f32(yw0) * M[y0, x, c] + f32(yw1) * M[y0+1, x, c])  (:70-73)
//   g_x  = rnd(xw_x * t_x)                                       (:76)
//   out  = rnd(f32(g_x0) + f32(g_x1))                            (:77-80)
// for x in {x0, x0+1}; rnd() rounds to the map dtype (nearest even). The
// __fmul_rn / __fadd_rn intrinsics keep nvcc from contracting a product
// and a sum into one FMA, which would change a rounding.
//
// What bounds it: memory. Per point it reads 8 bytes of coordinates and
// writes C map-dtype values (16 bytes for the 8-ch bf16 tex map); the
// maps (V x 256^2 x 8 bf16, about 1 MB per view on the strict path) stay
// in the 50 MB L2, so the corner reads are L2 hits. There are ~20 flops
// per output value, far below the card's compute rate.
// Design: one launch for all V views; one thread per (view, point) that
// loops over the channels, so the clamp and weights are computed once per
// point and the corner reads of a pixel's C channels are contiguous.
// The kernel allocates nothing and runs on the caller's stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// round an f32 value to T and back
template <typename T>
__device__ __forceinline__ float rnd(float v) { return to_f32(from_f32<T>(v)); }

template <typename T>
__global__ void onehot_bilinear_kernel(const T* __restrict__ maps,
                                       const float* __restrict__ xy,
                                       T* __restrict__ out, int64_t n_points,
                                       int N, int H, int W, int C) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_points) return;
  const int64_t v = i / N;

  // NDC -> pixel, border clamp (onehot_bilinear.py:48-53)
  float x = __fmul_rn(__fmul_rn(__fadd_rn(xy[2 * i], 1.0f), 0.5f),
                      static_cast<float>(W - 1));
  float y = __fmul_rn(__fmul_rn(__fadd_rn(xy[2 * i + 1], 1.0f), 0.5f),
                      static_cast<float>(H - 1));
  x = fminf(fmaxf(x, 0.0f), static_cast<float>(W - 1));
  y = fminf(fmaxf(y, 0.0f), static_cast<float>(H - 1));
  const float x0 = fminf(floorf(x), static_cast<float>(W - 2));
  const float y0 = fminf(floorf(y), static_cast<float>(H - 2));
  const float wx = __fsub_rn(x, x0);
  const float wy = __fsub_rn(y, y0);
  const float yw0 = rnd<T>(__fsub_rn(1.0f, wy));
  const float yw1 = rnd<T>(wy);
  const float xw0 = rnd<T>(__fsub_rn(1.0f, wx));
  const float xw1 = rnd<T>(wx);

  const int64_t row0 =
      ((v * H + static_cast<int64_t>(y0)) * W + static_cast<int64_t>(x0)) * C;
  const int64_t row1 = row0 + static_cast<int64_t>(W) * C;
  const T* m00 = maps + row0;      // (y0,   x0)
  const T* m01 = m00 + C;          // (y0,   x0+1)
  const T* m10 = maps + row1;      // (y0+1, x0)
  const T* m11 = m10 + C;          // (y0+1, x0+1)
  T* o = out + i * C;
  for (int c = 0; c < C; ++c) {
    const float t0 = rnd<T>(__fadd_rn(__fmul_rn(yw0, to_f32(m00[c])),
                                      __fmul_rn(yw1, to_f32(m10[c]))));
    const float t1 = rnd<T>(__fadd_rn(__fmul_rn(yw0, to_f32(m01[c])),
                                      __fmul_rn(yw1, to_f32(m11[c]))));
    const float g0 = rnd<T>(__fmul_rn(xw0, t0));
    const float g1 = rnd<T>(__fmul_rn(xw1, t1));
    o[c] = from_f32<T>(__fadd_rn(g0, g1));
  }
}

template <typename T>
int launch(const void* maps, const float* xy, void* out, int V, int N, int H,
           int W, int C, cudaStream_t stream) {
  const int64_t n_points = static_cast<int64_t>(V) * N;
  if (n_points == 0) return static_cast<int>(cudaSuccess);
  const int threads = 256;
  const int64_t blocks = (n_points + threads - 1) / threads;
  onehot_bilinear_kernel<T><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const T*>(maps), xy, static_cast<T*>(out), n_points, N, H, W,
      C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// maps: (V, H, W, C) contiguous, dtype 0 = f32, 1 = bf16; xy: (V, N, 2)
// f32 contiguous; out: (V, N, C) in the map dtype. Returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int kpn_onehot_bilinear(const void* maps, const float* xy,
                                   void* out, int V, int N, int H, int W,
                                   int C, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(maps, xy, out, V, N, H, W, C, s);
  if (dtype == 1) return launch<__nv_bfloat16>(maps, xy, out, V, N, H, W, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
