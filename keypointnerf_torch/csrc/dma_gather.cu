// Patch-gather bilinear lookup of V per-view feature maps (border clamp,
// align_corners), for Hopper (sm_90a): kernel K3 of the port.
//
// Replaces: keypointnerf_tpu/ops/pallas/dma_gather.py dma_bilinear_sample
//   (`_kernel`), which fetches each point's (2, 2, C) patch with a ring of
//   async DMAs and blends it with three lerps (:72-77):
//     top = p00 + wx (p01 - p00);  bot = p10 + wx (p11 - p10);
//     out = top + wy (bot - top)
//   with wx, wy rounded to the map dtype (:99-104). Rounding, as the plain
//   version (ops/dma_gather.py) has it: for bf16 maps every difference,
//   product and sum is rounded to bf16 (f32 op, then round to nearest
//   even; the _rn intrinsics keep nvcc from contracting them); for f32
//   maps `a + w * d` is formed in f64 (the product of two f32 values is
//   exact there) and rounded once to f32, the fused multiply-add of the
//   JAX package's CPU program.
//
// What bounds it: memory. Per point it reads 8 bytes of coordinates and
// four C-channel corner rows and writes one row; on the render path the
// fused map (V x 512^2 x 84 bf16, 44 MB a view) is larger than L2, but a
// ray's samples land on neighbouring pixels, so its corner rows are read
// from L2 or L1 more often than from HBM. ~4 flops per output value, far
// below the card's compute rate.
// Design: one warp per (view, point); the lanes split the channels, so a
// corner row is read as contiguous, coalesced bytes. Every lane computes
// the point's clamp and weights itself (a broadcast load of its xy). No
// channel padding is needed. One launch for all V views; the kernel
// allocates nothing and runs on the caller's stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;

// a + w * (b - a) with K3's rounding in the map dtype
__device__ __forceinline__ float lerp(float a, float w, float b) {
  const float d = __fsub_rn(b, a);
  return static_cast<float>(static_cast<double>(a) +
                            static_cast<double>(w) * static_cast<double>(d));
}

__device__ __forceinline__ __nv_bfloat16 lerp(__nv_bfloat16 a, __nv_bfloat16 w,
                                              __nv_bfloat16 b) {
  const float d = __bfloat162float(__float2bfloat16_rn(
      __fsub_rn(__bfloat162float(b), __bfloat162float(a))));
  const float p = __bfloat162float(
      __float2bfloat16_rn(__fmul_rn(__bfloat162float(w), d)));
  return __float2bfloat16_rn(__fadd_rn(__bfloat162float(a), p));
}

__device__ __forceinline__ float to_map(float v, float) { return v; }
__device__ __forceinline__ __nv_bfloat16 to_map(float v, __nv_bfloat16) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    dma_gather_kernel(const T* __restrict__ maps, const float* __restrict__ xy,
                      T* __restrict__ out, int64_t n_points, int N, int H,
                      int W, int C) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                    threadIdx.x / 32;
  if (i >= n_points) return;
  const int lane = threadIdx.x % 32;
  const int64_t v = i / N;

  // NDC -> pixel, border clamp, patch base clamped to S-2 (dma_gather.py:99-104)
  float x = __fmul_rn(__fmul_rn(__fadd_rn(xy[2 * i], 1.0f), 0.5f),
                      static_cast<float>(W - 1));
  float y = __fmul_rn(__fmul_rn(__fadd_rn(xy[2 * i + 1], 1.0f), 0.5f),
                      static_cast<float>(H - 1));
  x = fminf(fmaxf(x, 0.0f), static_cast<float>(W - 1));
  y = fminf(fmaxf(y, 0.0f), static_cast<float>(H - 1));
  const float x0 = fminf(floorf(x), static_cast<float>(W - 2));
  const float y0 = fminf(floorf(y), static_cast<float>(H - 2));
  const T wx = to_map(__fsub_rn(x, x0), T());
  const T wy = to_map(__fsub_rn(y, y0), T());

  const int64_t row0 =
      ((v * H + static_cast<int64_t>(y0)) * W + static_cast<int64_t>(x0)) * C;
  const T* p00 = maps + row0;                              // (y0,   x0)
  const T* p01 = p00 + C;                                  // (y0,   x0+1)
  const T* p10 = p00 + static_cast<int64_t>(W) * C;        // (y0+1, x0)
  const T* p11 = p10 + C;                                  // (y0+1, x0+1)
  T* o = out + i * C;
  for (int c = lane; c < C; c += 32) {
    const T top = lerp(p00[c], wx, p01[c]);
    const T bot = lerp(p10[c], wx, p11[c]);
    o[c] = lerp(top, wy, bot);
  }
}

template <typename T>
int launch(const void* maps, const float* xy, void* out, int V, int N, int H,
           int W, int C, cudaStream_t stream) {
  const int64_t n_points = static_cast<int64_t>(V) * N;
  if (n_points == 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (n_points + kWarpsPerBlock - 1) / kWarpsPerBlock;
  dma_gather_kernel<T><<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                         stream>>>(static_cast<const T*>(maps), xy,
                                   static_cast<T*>(out), n_points, N, H, W, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// maps: (V, H, W, C) contiguous, dtype 0 = f32, 1 = bf16; xy: (V, N, 2)
// f32 contiguous; out: (V, N, C) in the map dtype. Returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int kpn_dma_gather(const void* maps, const float* xy, void* out,
                              int V, int N, int H, int W, int C, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(maps, xy, out, V, N, H, W, C, s);
  if (dtype == 1) return launch<__nv_bfloat16>(maps, xy, out, V, N, H, W, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
