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
//   JAX package's CPU program. Each channel's three lerps are its own, so
//   moving several channels at once changes no rounding.
//
// What bounds it: memory. Per point it reads 8 bytes of coordinates and
// four C-channel corner rows and writes one row; on the render path the
// fused map (V x 512^2 x 84 bf16, 44 MB a view) is larger than L2, but a
// ray's samples land on neighbouring pixels, so its corner rows are read
// from L2 or L1 more often than from HBM. ~4 flops per output value, far
// below the card's compute rate.
// Design: a row is cut into G pieces of 16 or 8 bytes (the widest that the
// row's bytes and both pointers' alignment allow, chosen by the caller
// before the launch; single channels where neither does), and thread t of
// a block handles piece t mod G of point t div G: four vector loads (the
// corners), the lerps of its channels, one vector store. Consecutive
// threads own consecutive output bytes, and the points keep the caller's
// order, so a ray's samples (neighbouring pixels) share cache lines. An
// 84-channel bf16 row is 168 bytes: 21 pieces of 8 bytes (f32: 21 of 16),
// 12 points a block of 252 threads. Every thread computes its point's
// clamp and weights itself from one 8-byte load of its xy (~14 flops), and
// bf16 channels are blended two at a time by the bf16x2 instructions (see
// lerp2). One launch for all V views; the kernel allocates nothing and
// runs on the caller's stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 256;

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

// The same on bf16 pairs, with the native bf16x2 instructions: each one
// rounds its exact result once to bf16 (nearest even), which is what the
// f32 operation followed by the round to bf16 gives. A difference or sum of
// two bf16 values is exact in f32 unless their exponents lie more than 16
// apart, and then the exact and the f32 result round to the same bf16 (the
// smaller term is far below half a bf16 ulp of the larger); a product of
// two bf16 values is always exact in f32. So lerp2 is bit-equal to lerp on
// each half, with a third of its instructions.
__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t b, uint32_t a) {
  uint32_t r;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(b), "r"(a));
  return r;
}
__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t bf16x2_add(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t lerp2(uint32_t a, uint32_t w, uint32_t b) {
  return bf16x2_add(a, bf16x2_mul(w, bf16x2_sub(b, a)));
}

__device__ __forceinline__ float to_map(float v, float) { return v; }
__device__ __forceinline__ __nv_bfloat16 to_map(float v, __nv_bfloat16) {
  return __float2bfloat16_rn(v);
}

// VEC channels moved as one load or store
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Piece {
  T v[VEC];
};

// the three lerps of a piece's channels: bf16 pairs two at a time, else one
// channel at a time
template <typename T, int VEC>
__device__ __forceinline__ Piece<T, VEC> lerp_piece(const Piece<T, VEC>& a,
                                                    const Piece<T, VEC>& b,
                                                    const Piece<T, VEC>& c,
                                                    const Piece<T, VEC>& d, T wx, T wy) {
  Piece<T, VEC> r;
  if constexpr (sizeof(T) == 2 && VEC % 2 == 0) {
    const uint32_t* A = reinterpret_cast<const uint32_t*>(a.v);
    const uint32_t* B = reinterpret_cast<const uint32_t*>(b.v);
    const uint32_t* C = reinterpret_cast<const uint32_t*>(c.v);
    const uint32_t* D = reinterpret_cast<const uint32_t*>(d.v);
    uint32_t* R = reinterpret_cast<uint32_t*>(r.v);
    const uint32_t wx_bits = *reinterpret_cast<const uint16_t*>(&wx);
    const uint32_t wy_bits = *reinterpret_cast<const uint16_t*>(&wy);
    const uint32_t wx2 = wx_bits | (wx_bits << 16), wy2 = wy_bits | (wy_bits << 16);
#pragma unroll
    for (int e = 0; e < VEC / 2; ++e)
      R[e] = lerp2(lerp2(A[e], wx2, B[e]), wy2, lerp2(C[e], wx2, D[e]));
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      r.v[e] = lerp(lerp(a.v[e], wx, b.v[e]), wy, lerp(c.v[e], wx, d.v[e]));
  }
  return r;
}

// G pieces of VEC channels a row; `threads_pp` threads a point (G, or 256
// for a row of more pieces, each thread then taking every threads_pp-th),
// `ppb` points a block. `xy_pairs`: xy is 8-byte aligned.
template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
    dma_gather_kernel(const T* __restrict__ maps, const float* __restrict__ xy,
                      T* __restrict__ out, int64_t n_points, int N, int H, int W,
                      int C, int G, int threads_pp, int ppb, bool xy_pairs) {
  const int local = threadIdx.x / threads_pp;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * ppb + local;
  if (local >= ppb || i >= n_points) return;
  // (a 64-bit division costs several times a 32-bit one, in every thread)
  const int64_t v = n_points <= UINT32_MAX
                        ? static_cast<uint32_t>(i) / static_cast<uint32_t>(N)
                        : i / N;

  // NDC -> pixel, border clamp, patch base clamped to S-2 (dma_gather.py:99-104)
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
  const T wx = to_map(__fsub_rn(x, x0), T());
  const T wy = to_map(__fsub_rn(y, y0), T());

  using P = Piece<T, VEC>;
  const int64_t row0 =
      ((v * H + static_cast<int64_t>(y0)) * W + static_cast<int64_t>(x0)) * C;
  const P* p00 = reinterpret_cast<const P*>(maps + row0);   // (y0,   x0)
  const P* p01 = p00 + G;                                    // (y0,   x0+1)
  const P* p10 = p00 + static_cast<int64_t>(W) * G;          // (y0+1, x0)
  const P* p11 = p10 + G;                                    // (y0+1, x0+1)
  P* o = reinterpret_cast<P*>(out + i * C);
  for (int k = threadIdx.x - local * threads_pp; k < G; k += threads_pp)
    o[k] = lerp_piece<T, VEC>(p00[k], p01[k], p10[k], p11[k], wx, wy);
}

template <typename T, int VEC>
int launch(const void* maps, const float* xy, void* out, int V, int N, int H,
           int W, int C, cudaStream_t stream) {
  const int64_t n_points = static_cast<int64_t>(V) * N;
  const int G = C / VEC;
  const int threads_pp = G < kMaxThreads ? G : kMaxThreads;
  const int ppb = kMaxThreads / threads_pp;
  const int64_t blocks = (n_points + ppb - 1) / ppb;
  const bool xy_pairs = (reinterpret_cast<uintptr_t>(xy) & 7) == 0;
  dma_gather_kernel<T, VEC><<<static_cast<unsigned>(blocks), ppb * threads_pp, 0, stream>>>(
      static_cast<const T*>(maps), xy, static_cast<T*>(out), n_points, N, H, W, C, G,
      threads_pp, ppb, xy_pairs);
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
extern "C" int kpn_dma_gather(const void* maps, const float* xy, void* out,
                              int V, int N, int H, int W, int C, int dtype,
                              int piece_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_pieces<float>(maps, xy, out, V, N, H, W, C, piece_bytes, s);
  if (dtype == 1)
    return launch_pieces<__nv_bfloat16>(maps, xy, out, V, N, H, W, C, piece_bytes, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
