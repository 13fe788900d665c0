// Fused coarse composite + inverse-CDF importance placement of the fine
// depths, for Hopper (sm_90a): kernel K6 of the port.
//
// Replaces: keypointnerf_tpu/ops/pallas/composite_kernel.py
//   composite_importance_pallas (`_kernel`, math in `_body` :42-105). Per
//   ray of S samples: alpha from the z spacing with a 1e10 tail; the
//   exclusive transmittance exp(cumsum(max(log1p(-a), -80))); contrib,
//   acc, color, depth and sdf; then F fine depths by the inverse CDF of
//   the interior contribs (+1e-5), where the enclosing interval of u is
//   (max of {cdf_j <= u}, min of {cdf_j > u}) taken literally as masked
//   reductions (a reassociated cumsum need not be monotone, so a binary
//   search could pick another interval), u beyond the last edge takes the
//   top bin, and an interval narrower than 1e-5 takes den = 1. The TPU
//   kernel scans along lanes with triangular matmuls on the MXU; a warp
//   scans with shuffles instead. The sums run in another order than the
//   plain version's (ops/composite_importance.py), so the two agree to
//   rounding; a fine depth can still move inside its bin where an empty
//   bin's den sits at the 1e-5 switch, or to the next bin where a u lands
//   on a cdf edge.
//
// What bounds it: memory, at the render's shape (S = F = 64): per ray it
// reads 6S + F floats and writes S + F + 6; the F x (S-1) comparisons of
// the search (~25 k operations a ray) are far below the card's f32 rate.
// Design: one warp per ray. Lane l holds samples [l*P, l*P + P), P =
// ceil(S/32) <= 8, in registers: lane-local prefix sums plus a shuffle scan
// of the lane totals give both cumsums, shuffle butterflies the sums. The
// cdf edges and z_mid go to shared memory, and each lane then places fine
// samples l, l+32, ... by walking all S-1 edges (broadcast reads). Ragged
// R needs no padding: a warp past the last ray returns. Default IEEE
// division and expf / log1pf (no fast math). The kernel allocates nothing
// and runs on the caller's stream.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxPerLane = 8;                 // S <= 256
constexpr int kMaxS = 32 * kMaxPerLane;
constexpr float kBig = 1e30f;
constexpr float kLogFloor = -80.0f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// exclusive prefix of the lane totals `t` across the warp: the inclusive
// scan shifted up one lane (not inclusive - t, whose cancellation costs
// ~1e-5 of contrib once the log sums reach the -80 floor)
__device__ __forceinline__ float warp_exclusive(float t, int lane) {
  float inc = t;
  for (int o = 1; o < 32; o <<= 1) {
    const float n = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += n;
  }
  const float prev = __shfl_up_sync(kFull, inc, 1);
  return lane == 0 ? 0.0f : prev;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32) composite_importance_kernel(
    const float* __restrict__ z_in, const float* __restrict__ alpha_in,
    const float* __restrict__ sdf_in, const float* __restrict__ rgb_in,
    const float* __restrict__ u_in, float* __restrict__ color_out,
    float* __restrict__ depth_out, float* __restrict__ acc_out,
    float* __restrict__ sdf_out, float* __restrict__ contrib_out,
    float* __restrict__ zf_out, int R, int S, int F) {
  __shared__ float s_z[kWarpsPerBlock][kMaxS];
  __shared__ float s_cdf[kWarpsPerBlock][kMaxS];
  __shared__ float s_zm[kWarpsPerBlock][kMaxS];
  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + w;
  if (r >= R) return;                          // whole warps leave together
  const int P = (S + 31) / 32;
  const int j0 = lane * P;
  const float* z = z_in + r * S;
  float* sz = s_z[w];
  float* scdf = s_cdf[w];
  float* szm = s_zm[w];

  for (int j = lane; j < S; j += 32) sz[j] = z[j];
  __syncwarp();

  // alpha and the log transmittance terms; the lane-local exclusive prefix
  float a[kMaxPerLane], excl[kMaxPerLane];
  float lsum = 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxPerLane; ++k) {
    const int j = j0 + k;
    a[k] = 0.0f;
    excl[k] = 0.0f;
    if (k < P && j < S) {
      const float dist = j + 1 < S ? sz[j + 1] - sz[j] : 1e10f;
      a[k] = 1.0f - expf(-alpha_in[r * S + j] * dist);
      excl[k] = lsum;
      lsum += fmaxf(log1pf(-a[k]), kLogFloor);
    }
  }
  const float off = warp_exclusive(lsum, lane);

  // contrib and the weighted sums
  float c_acc = 0.0f, c_r = 0.0f, c_g = 0.0f, c_b = 0.0f, c_z = 0.0f, c_s = 0.0f;
  float cint_sum = 0.0f;
  float contrib[kMaxPerLane];
#pragma unroll
  for (int k = 0; k < kMaxPerLane; ++k) {
    const int j = j0 + k;
    contrib[k] = 0.0f;
    if (k < P && j < S) {
      const float c = a[k] * expf(off + excl[k]);
      contrib[k] = c;
      contrib_out[r * S + j] = c;
      const float* rgb = rgb_in + (r * S + j) * 3;
      c_acc += c;
      c_r += rgb[0] * c;
      c_g += rgb[1] * c;
      c_b += rgb[2] * c;
      c_z += sz[j] * c;
      c_s += sdf_in[r * S + j] * c;
      if (j >= 1 && j <= S - 2) cint_sum += c + 1e-5f;
    }
  }
  c_acc = warp_sum(c_acc);
  c_r = warp_sum(c_r);
  c_g = warp_sum(c_g);
  c_b = warp_sum(c_b);
  c_z = warp_sum(c_z);
  c_s = warp_sum(c_s);
  cint_sum = warp_sum(cint_sum);
  if (lane == 0) {
    color_out[r * 3] = c_r;
    color_out[r * 3 + 1] = c_g;
    color_out[r * 3 + 2] = c_b;
    acc_out[r] = c_acc;
    depth_out[r] = c_z / (c_acc + 1e-8f);
    sdf_out[r] = c_s / (c_acc + 1e-8f);
  }

  // cdf edges: cdf[0] = 0, cdf[m] = sum of pdf over interior samples 1..m
  float pdf[kMaxPerLane];
  float psum = 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxPerLane; ++k) {
    const int j = j0 + k;
    pdf[k] = 0.0f;
    if (k < P && j >= 1 && j <= S - 2) {
      pdf[k] = (contrib[k] + 1e-5f) / cint_sum;
      psum += pdf[k];
    }
  }
  float run = warp_exclusive(psum, lane);
#pragma unroll
  for (int k = 0; k < kMaxPerLane; ++k) {
    const int j = j0 + k;
    if (k < P && j >= 1 && j <= S - 2) {
      run += pdf[k];
      scdf[j] = run;
    }
  }
  if (lane == 0) scdf[0] = 0.0f;
  const int E = S - 1;                         // bin edges z_mid
  for (int m = lane; m < E; m += 32) szm[m] = 0.5f * (sz[m + 1] + sz[m]);
  __syncwarp();

  // inverse CDF: each lane places fine samples lane, lane + 32, ...
  const float last_cdf = scdf[E - 1];
  const float last_z = szm[E - 1];
  for (int k = lane; k < F; k += 32) {
    const float u = u_in[r * F + k];
    float cdf_prev = -kBig, z_prev = -kBig, cdf_next = kBig, z_next = kBig;
    for (int m = 0; m < E; ++m) {
      const float c = scdf[m];
      const float zm = szm[m];
      if (c <= u) {
        cdf_prev = fmaxf(cdf_prev, c);
        z_prev = fmaxf(z_prev, zm);
      } else {
        cdf_next = fminf(cdf_next, c);
        z_next = fminf(z_next, zm);
      }
    }
    if (cdf_next >= 0.5f * kBig) {            // u beyond the last edge
      cdf_next = last_cdf;
      z_next = last_z;
    }
    float den = __fsub_rn(cdf_next, cdf_prev);
    if (den < 1e-5f) den = 1.0f;
    const float t = __fdiv_rn(__fsub_rn(u, cdf_prev), den);
    zf_out[r * F + k] = __fadd_rn(z_prev, __fmul_rn(t, __fsub_rn(z_next, z_prev)));
  }
}

}  // namespace

// z, alpha, sdf: (R, S); rgb: (R, S, 3); u: (R, F), all f32 contiguous,
// z sorted; outputs f32 color (R, 3), depth / acc / sdf (R,), contrib
// (R, S), z_fine (R, F). S in [3, 256]. Returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int kpn_composite_importance(
    const float* z, const float* alpha, const float* sdf, const float* rgb,
    const float* u, float* color, float* depth, float* acc, float* sdf_out,
    float* contrib, float* z_fine, int R, int S, int F, void* stream) {
  if (S < 3 || S > kMaxS || F < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return static_cast<int>(cudaSuccess);
  const int blocks = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  composite_importance_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      z, alpha, sdf, rgb, u, color, depth, acc, sdf_out, contrib, z_fine, R, S, F);
  return static_cast<int>(cudaGetLastError());
}
