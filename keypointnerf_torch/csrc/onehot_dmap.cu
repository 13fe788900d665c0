// Map gradient of the border-clamped bilinear lookup (align_corners) of V
// per-view feature maps, for Hopper (sm_90a): kernel K1 of the port.
//
// Replaces: keypointnerf_tpu/ops/pallas/onehot_dmap.py
//   bilinear_dmap_onehot (`_kernel`), which the JAX training step calls for
//   the 64-channel coarse geometry map (feat_sample.py:_mm_bwd_impl with
//   pallas_dmap and >= 32 gradient channels).
// The TPU kernel accumulates dmap(H, W*C) += Yw^T @ (XwE * tile(g)) over
// sequential point tiles, with the accumulator resident in VMEM. Only two
// rows of Yw and two columns of XwE are nonzero per point, so the same sum
// is, per point n, channel c < C and corner (y, x) in {y0, y0+1} x
// {x0, x0+1}:
//   dmap[v, y, x, c] += f32(rnd(yw_y)) * f32(rnd(xw_x * g[v, n, c]))
// with rnd() the round to the map dtype (bf16 or f32) and the xw * g
// product formed in f32 and rounded once (onehot_dmap.py:75-106); the
// coordinate math copies onehot_dmap.py:63-70. __fmul_rn / __fadd_rn keep
// nvcc from contracting a product and a sum into one FMA, which would
// change a rounding. Blocks on Hopper run in no order, so the cross-point
// sum is taken with atomics into an f32 (V, H, W, C) buffer that the
// wrapper allocates and zeroes; its sum order (and last bits) change from
// run to run.
//
// What bounds it: at the fine query of a zju training step (V = 3,
// N = 524,288 points per view, C = 64, a 128 x 128 map) the inputs are 8
// bytes of coordinates and 256 bytes of f32 cotangent per point, ~415 MB,
// plus a 12.6 MB dmap: ~128 us at 3.35 TB/s. The 4 * C * V * N = 403 M f32
// atomic adds (101 M as float4 vector atomics) are the likelier limit; the
// (V, 128, 128, 64) f32 accumulator is 12.6 MB and stays in the 50 MB L2,
// so the atomics resolve there.
// Design: one launch for all views; one thread per (view, point, group of
// 4 channels). A warp covers 8 points x 32 channels (at C = 64), so its
// cotangent reads are contiguous, and each thread issues one 16-byte
// vector atomicAdd per corner (sm_90) when C % 4 == 0, else up to 4 scalar
// ones. The kernel allocates nothing and runs on the caller's stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

template <typename T>
__device__ __forceinline__ float rnd(float v);
template <>
__device__ __forceinline__ float rnd<float>(float v) { return v; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__global__ void onehot_dmap_kernel(const float* __restrict__ xy,
                                   const float* __restrict__ g,
                                   float* __restrict__ dmap, int64_t n_items,
                                   int N, int H, int W, int C, int groups) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_items) return;
  const int64_t p = i / groups;            // (view, point) row
  const int c0 = static_cast<int>(i - p * groups) * 4;
  const int64_t v = p / N;

  // NDC -> pixel, border clamp, base clamped to S-2 (onehot_dmap.py:63-70)
  float x = __fmul_rn(__fmul_rn(__fadd_rn(xy[2 * p], 1.0f), 0.5f),
                      static_cast<float>(W - 1));
  float y = __fmul_rn(__fmul_rn(__fadd_rn(xy[2 * p + 1], 1.0f), 0.5f),
                      static_cast<float>(H - 1));
  x = fminf(fmaxf(x, 0.0f), static_cast<float>(W - 1));
  y = fminf(fmaxf(y, 0.0f), static_cast<float>(H - 1));
  const float x0 = fminf(floorf(x), static_cast<float>(W - 2));
  const float y0 = fminf(floorf(y), static_cast<float>(H - 2));
  const float wx = __fsub_rn(x, x0);
  const float wy = __fsub_rn(y, y0);
  const float xw[2] = {__fsub_rn(1.0f, wx), wx};          // f32, as XwE
  const float yw[2] = {rnd<T>(__fsub_rn(1.0f, wy)), rnd<T>(wy)};

  const int nc = min(4, C - c0);
  float gv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const float* gp = g + p * C + c0;
  for (int k = 0; k < nc; ++k) gv[k] = gp[k];

  const int64_t base =
      ((v * H + static_cast<int64_t>(y0)) * W + static_cast<int64_t>(x0)) * C + c0;
  for (int dy = 0; dy < 2; ++dy) {
    for (int dx = 0; dx < 2; ++dx) {
      float t[4];
      for (int k = 0; k < 4; ++k)
        t[k] = __fmul_rn(yw[dy], rnd<T>(__fmul_rn(xw[dx], gv[k])));
      float* dst = dmap + base + (static_cast<int64_t>(dy) * W + dx) * C;
      if (nc == 4 && (C & 3) == 0) {
        atomicAdd(reinterpret_cast<float4*>(dst), make_float4(t[0], t[1], t[2], t[3]));
      } else {
        for (int k = 0; k < nc; ++k) atomicAdd(dst + k, t[k]);
      }
    }
  }
}

template <typename T>
int launch(const float* xy, const float* g, float* dmap, int V, int N, int H,
           int W, int C, cudaStream_t stream) {
  const int groups = (C + 3) / 4;
  const int64_t n_items = static_cast<int64_t>(V) * N * groups;
  if (n_items == 0) return static_cast<int>(cudaSuccess);
  const int threads = 256;
  const int64_t blocks = (n_items + threads - 1) / threads;
  onehot_dmap_kernel<T><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      xy, g, dmap, n_items, N, H, W, C, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xy: (V, N, 2) f32 contiguous; g: (V, N, C) f32 contiguous; dmap: (V, H, W,
// C) f32 contiguous, zeroed by the caller (the kernel adds into it).
// dtype 0 = f32 map, 1 = bf16 map (the rounding of the terms). Returns the
// launch's cudaGetLastError() (0 on success).
extern "C" int kpn_onehot_dmap(const float* xy, const float* g, float* dmap,
                               int V, int N, int H, int W, int C, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(xy, g, dmap, V, N, H, W, C, s);
  if (dtype == 1) return launch<__nv_bfloat16>(xy, g, dmap, V, N, H, W, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
