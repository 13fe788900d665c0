// Exact forward bilinear lookup of V per-view feature maps (border clamp,
// align_corners), for Hopper (sm_90a): kernel K2 of the port.
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
// and a sum into one FMA, which would change a rounding. Each channel's
// steps are its own, so moving several channels at once changes none.
//
// What bounds it: memory. Per point it reads 8 bytes of coordinates and
// writes C map-dtype values (16 bytes for the 8-ch bf16 tex map); the
// maps (V x 256^2 x 8 bf16, about 1 MB per view on the strict path) stay
// in the 50 MB L2, so the corner reads are L2 hits. There are ~20 flops
// per output value, far below the card's compute rate.
// Design: one launch for all V views; one thread per (view, point), which
// loads its xy as one 8-byte pair, computes the clamp and the rounded
// weights once, and moves its point's channels in pieces of 16 or 8 bytes
// (the widest that the row's bytes and both pointers' alignment allow,
// chosen by the caller before the launch; single channels where neither
// does): the 8-ch bf16 tex map is one 16-byte load a corner and one
// 16-byte store a point, so a warp's stores fill 512 contiguous bytes.
// Blocks of 128 threads. On the render's points (a ray's samples on
// neighbouring pixels) a warp's corner loads share cache lines; a lane pair
// a point (each lane one column of the patch) served uniform points faster
// but these slower, and two points a thread served neither faster
// (NVIDIA H100 80GB HBM3, development builds). The kernel allocates
// nothing and runs on the caller's stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;

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

// VEC channels moved as one load or store
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Piece {
  T v[VEC];
};

// `xy_pairs`: xy is 8-byte aligned
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    onehot_bilinear_kernel(const T* __restrict__ maps, const float* __restrict__ xy,
                           T* __restrict__ out, int64_t n_points, int N, int H, int W,
                           int C, bool xy_pairs) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_points) return;
  // (a 64-bit division costs several times a 32-bit one)
  const int64_t v = n_points <= UINT32_MAX
                        ? static_cast<uint32_t>(i) / static_cast<uint32_t>(N)
                        : i / N;

  // NDC -> pixel, border clamp (onehot_bilinear.py:48-53)
  float2 q;
  if (xy_pairs) {
    q = reinterpret_cast<const float2*>(xy)[i];
  } else {
    q.x = xy[2 * i];
    q.y = xy[2 * i + 1];
  }
  float x = __fmul_rn(__fmul_rn(__fadd_rn(q.x, 1.0f), 0.5f), static_cast<float>(W - 1));
  float y = __fmul_rn(__fmul_rn(__fadd_rn(q.y, 1.0f), 0.5f), static_cast<float>(H - 1));
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

  using P = Piece<T, VEC>;
  const int G = C / VEC;                    // pieces a row
  const int64_t row0 =
      ((v * H + static_cast<int64_t>(y0)) * W + static_cast<int64_t>(x0)) * C;
  const P* m00 = reinterpret_cast<const P*>(maps + row0);   // (y0,   x0)
  const P* m01 = m00 + G;                                    // (y0,   x0+1)
  const P* m10 = m00 + static_cast<int64_t>(W) * G;          // (y0+1, x0)
  const P* m11 = m10 + G;                                    // (y0+1, x0+1)
  P* o = reinterpret_cast<P*>(out + i * C);
  for (int k = 0; k < G; ++k) {
    const P a = m00[k], b = m01[k], c = m10[k], d = m11[k];
    P r;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float t0 = rnd<T>(__fadd_rn(__fmul_rn(yw0, to_f32(a.v[e])),
                                        __fmul_rn(yw1, to_f32(c.v[e]))));
      const float t1 = rnd<T>(__fadd_rn(__fmul_rn(yw0, to_f32(b.v[e])),
                                        __fmul_rn(yw1, to_f32(d.v[e]))));
      const float g0 = rnd<T>(__fmul_rn(xw0, t0));
      const float g1 = rnd<T>(__fmul_rn(xw1, t1));
      r.v[e] = from_f32<T>(__fadd_rn(g0, g1));
    }
    o[k] = r;
  }
}

template <typename T, int VEC>
int launch(const void* maps, const float* xy, void* out, int V, int N, int H,
           int W, int C, cudaStream_t stream) {
  const int64_t n_points = static_cast<int64_t>(V) * N;
  const int64_t blocks = (n_points + kThreads - 1) / kThreads;
  const bool xy_pairs = (reinterpret_cast<uintptr_t>(xy) & 7) == 0;
  onehot_bilinear_kernel<T, VEC><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(maps), xy, static_cast<T*>(out), n_points, N, H, W, C,
      xy_pairs);
  return static_cast<int>(cudaGetLastError());
}

// the launch for `piece_bytes` (16, 8 or the element size); invalid-value
// if the row or a pointer does not allow it
template <typename T>
int launch_pieces(const void* maps, const float* xy, void* out, int V, int N, int H,
                  int W, int C, int piece_bytes, cudaStream_t stream) {
  const int64_t row = static_cast<int64_t>(C) * sizeof(T);
  if (piece_bytes < static_cast<int>(sizeof(T)) || row % piece_bytes != 0 ||
      reinterpret_cast<uintptr_t>(maps) % piece_bytes != 0 ||
      reinterpret_cast<uintptr_t>(out) % piece_bytes != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(V) * N == 0) return static_cast<int>(cudaSuccess);
  constexpr int kWide = 16 / sizeof(T), kHalf = 8 / sizeof(T);
  if (piece_bytes == 16) return launch<T, kWide>(maps, xy, out, V, N, H, W, C, stream);
  if (piece_bytes == 8) return launch<T, kHalf>(maps, xy, out, V, N, H, W, C, stream);
  if (piece_bytes == static_cast<int>(sizeof(T)))
    return launch<T, 1>(maps, xy, out, V, N, H, W, C, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// maps: (V, H, W, C) contiguous, dtype 0 = f32, 1 = bf16; xy: (V, N, 2)
// f32 contiguous; out: (V, N, C) in the map dtype; piece_bytes: the bytes
// a thread moves at once (16, 8 or one element: ops/feat_sample.py
// `piece_bytes`). Returns the launch's cudaGetLastError() (0 on success).
extern "C" int kpn_onehot_bilinear(const void* maps, const float* xy,
                                   void* out, int V, int N, int H, int W,
                                   int C, int dtype, int piece_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_pieces<float>(maps, xy, out, V, N, H, W, C, piece_bytes, s);
  if (dtype == 1)
    return launch_pieces<__nv_bfloat16>(maps, xy, out, V, N, H, W, C, piece_bytes, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
