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
//   search could pick another interval: this kernel searches only edges
//   it has seen rise), u beyond the last edge takes the
//   top bin, and an interval narrower than 1e-5 takes den = 1. The TPU
//   kernel scans along lanes with triangular matmuls on the MXU; a warp
//   scans with shuffles instead. The sums run in another order than the
//   plain version's (ops/composite_importance.py), so the two agree to
//   rounding; a fine depth can still move inside its bin where an empty
//   bin's den sits at the 1e-5 switch, or to the next bin where a u lands
//   on a cdf edge.
//
// What bounds it: not bytes. At the render's shape (R = 2048 rays, S = F =
// 64) it reads 6S + F floats a ray and writes S + F + 6 (4.8 MB, ~1.4 us at
// 3.35 TB/s, under an empty launch's ~0.8 us of device time plus a load's
// latency); the time is each warp's chain of dependent steps (loads,
// expf / log1pf, two scans, the sums' butterflies) and the F x (S-1)
// comparisons of the placement, on only ~16 warps an SM. A walk over the
// edges costs a lane ~7 instructions an edge, and the warp reductions of
// the masked extrema ~25 instructions a fine sample for the whole warp:
// neither is latency the few warps can hide.
// Design: one warp per ray, every input loaded up front (float2 / float4
// where the row and the pointers allow it). Lane l holds samples [l*P,
// l*P + P), P = 1, 2, 4 or 8 (S <= 256), in registers: lane-local prefix
// sums plus a shuffle scan of the lane totals give both cumsums, shuffle
// butterflies the sums, and a lane's last sample reads its neighbour's
// first depth by a shuffle. The placement takes the literal definition
// two ways. Where the edges' cdf and z_mid both rise, edge by edge (a warp
// vote; the scan of positive pdfs over sorted depths gives that), {cdf_j
// <= u} is a prefix of the edges, so its max and its complement's min are
// the edges either side of the prefix's end: each lane finds that end for
// its own fine samples by a binary search over the edges in shared memory.
// Any other ray keeps its edges in registers as order-preserving u32 keys
// (the sign-flip map of f32, so negative depths order right; the
// sentinels the mapped +-1e30) and, for each fine sample, the warp takes
// the four masked extrema with __reduce_max_sync / __reduce_min_sync. Both
// are exact, so the depths equal a walk's given the same cdf. Ragged R
// needs no padding: a warp past the last ray leaves whole. Default IEEE
// division and expf / log1pf (no fast math). The kernel allocates nothing
// and runs on the caller's stream.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxS = 256;
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

// f32 -> u32 with the same order (negative values flipped whole, positive
// ones above them), and back
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned b = __float_as_uint(f);
  return b ^ (static_cast<unsigned>(static_cast<int>(b) >> 31) | 0x80000000u);
}
__device__ __forceinline__ float from_key(unsigned k) {
  return __uint_as_float(k ^ (static_cast<unsigned>(static_cast<int>(~k) >> 31) | 0x80000000u));
}

// the fine depth at u in the interval (cdf_prev, z_prev) .. (cdf_next,
// z_next): u beyond the last edge (no next) takes the top bin, an
// interval narrower than 1e-5 takes den = 1
__device__ __forceinline__ float place(float u, float cp, float zp, float cn, float zn,
                                       float last_c, float last_z) {
  if (cn >= 0.5f * kBig) {
    cn = last_c;
    zn = last_z;
  }
  float den = __fsub_rn(cn, cp);
  if (den < 1e-5f) den = 1.0f;
  const float t = __fdiv_rn(__fsub_rn(u, cp), den);
  return __fadd_rn(zp, __fmul_rn(t, __fsub_rn(zn, zp)));
}

// n floats [i, i + n) of a row into v[0..n); `vec`: the lane's P values
// are one aligned piece (the wrapper's and the row's alignment allow it)
template <int P, int M>
__device__ __forceinline__ void load_run(const float* __restrict__ row, int i, int n,
                                         bool vec, float (&v)[P * M]) {
  if (vec && n == P * M) {
    if constexpr ((P * M) % 4 == 0) {
#pragma unroll
      for (int q = 0; q < P * M / 4; ++q) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(row + i) + q);
        v[4 * q] = t.x, v[4 * q + 1] = t.y, v[4 * q + 2] = t.z, v[4 * q + 3] = t.w;
      }
      return;
    } else if constexpr ((P * M) % 2 == 0) {
#pragma unroll
      for (int q = 0; q < P * M / 2; ++q) {
        const float2 t = __ldg(reinterpret_cast<const float2*>(row + i) + q);
        v[2 * q] = t.x, v[2 * q + 1] = t.y;
      }
      return;
    }
  }
#pragma unroll
  for (int q = 0; q < P * M; ++q) v[q] = q < n ? __ldg(row + i + q) : 0.0f;
}

template <int P>
__global__ void __launch_bounds__(kWarpsPerBlock * 32) composite_importance_kernel(
    const float* __restrict__ z_in, const float* __restrict__ alpha_in,
    const float* __restrict__ sdf_in, const float* __restrict__ rgb_in,
    const float* __restrict__ u_in, float* __restrict__ color_out,
    float* __restrict__ depth_out, float* __restrict__ acc_out,
    float* __restrict__ sdf_out, float* __restrict__ contrib_out,
    float* __restrict__ zf_out, int R, int S, int F, bool vec) {
  const int lane = threadIdx.x % 32;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  if (r >= R) return;                          // whole warps leave together
  const int j0 = lane * P;
  const int nj = max(0, min(P, S - j0));       // this lane's samples
  const int E = S - 1;                         // bin edges z_mid

  // every input of the ray first, so their latencies overlap
  float z[P], al[P], sd[P], rgb[3 * P];
  load_run<P, 1>(z_in + r * S, j0, nj, vec, z);
  load_run<P, 1>(alpha_in + r * S, j0, nj, vec, al);
  load_run<P, 1>(sdf_in + r * S, j0, nj, vec, sd);
  load_run<P, 3>(rgb_in + 3 * r * S, 3 * j0, 3 * nj, vec, rgb);
  const float u_first = lane < F ? __ldg(u_in + r * F + lane) : 0.0f;
  const float z_right = __shfl_down_sync(kFull, z[0], 1);  // the next lane's first

  // alpha and the log transmittance terms; the lane-local exclusive prefix
  float a[P], excl[P], z_up[P];
  float lsum = 0.0f;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int j = j0 + k;
    z_up[k] = k + 1 < P ? z[k + 1] : z_right;
    a[k] = 0.0f;
    excl[k] = 0.0f;
    if (k < nj) {
      const float dist = j + 1 < S ? z_up[k] - z[k] : 1e10f;
      a[k] = 1.0f - expf(-al[k] * dist);
      excl[k] = lsum;
      lsum += fmaxf(log1pf(-a[k]), kLogFloor);
    }
  }
  const float off = warp_exclusive(lsum, lane);

  // contrib and the weighted sums
  float c_acc = 0.0f, c_r = 0.0f, c_g = 0.0f, c_b = 0.0f, c_z = 0.0f, c_s = 0.0f;
  float cint_sum = 0.0f;
  float contrib[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int j = j0 + k;
    contrib[k] = 0.0f;
    if (k < nj) {
      const float c = a[k] * expf(off + excl[k]);
      contrib[k] = c;
      c_acc += c;
      c_r += rgb[3 * k] * c;
      c_g += rgb[3 * k + 1] * c;
      c_b += rgb[3 * k + 2] * c;
      c_z += z[k] * c;
      c_s += sd[k] * c;
      if (j >= 1 && j <= S - 2) cint_sum += c + 1e-5f;
    }
  }
#pragma unroll
  for (int k = 0; k < P; ++k)
    if (k < nj) contrib_out[r * S + j0 + k] = contrib[k];
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
  float pdf[P];
  float psum = 0.0f;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int j = j0 + k;
    pdf[k] = 0.0f;
    if (k < nj && j >= 1 && j <= S - 2) {
      pdf[k] = (contrib[k] + 1e-5f) / cint_sum;
      psum += pdf[k];
    }
  }
  float run = warp_exclusive(psum, lane);
  // this lane's edges as order keys; a slot that is no edge compares
  // false against every u (NaN) and takes the high sentinel
  const unsigned lo = order_key(-kBig), hi = order_key(kBig);
  float cdf[P];
  unsigned key_c[P], key_z[P];
  float last_c = 0.0f, last_z = 0.0f;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int j = j0 + k;
    if (j >= 1 && j <= S - 2) run += pdf[k];
    const bool edge = j < E;
    const float c = j == 0 ? 0.0f : run;
    const float zm = 0.5f * (z_up[k] + z[k]);
    cdf[k] = edge ? c : __int_as_float(0x7fffffff);
    key_c[k] = edge ? order_key(c) : hi;
    key_z[k] = edge ? order_key(zm) : hi;
    if (j == E - 1) last_c = c, last_z = zm;
  }
  const int last_lane = (E - 1) / P;
  last_c = __shfl_sync(kFull, last_c, last_lane);
  last_z = __shfl_sync(kFull, last_z, last_lane);

  // inverse CDF. Where the edges' cdf and z_mid both rise (as the scan
  // of positive pdfs and sorted depths give them; checked, edge by edge,
  // by one warp vote) the literal sets are a prefix and its complement,
  // so each lane places its own fine samples by a binary search for the
  // prefix length: the same extrema, so the same depths. Any other ray
  // takes the warp reductions.
  bool rising = true;
  const float c_right = __shfl_down_sync(kFull, cdf[0], 1);
  const unsigned kz_right = __shfl_down_sync(kFull, key_z[0], 1);
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int j = j0 + k;
    if (j + 1 < E) {
      const float c_next = k + 1 < P ? cdf[k + 1] : c_right;
      const unsigned z_next = k + 1 < P ? key_z[k + 1] : kz_right;
      rising = rising && cdf[k] <= c_next && key_z[k] <= z_next;
    }
  }
  float u_own = u_first;
  if (__all_sync(kFull, rising)) {
    __shared__ float s_cdf[kWarpsPerBlock][kMaxS], s_zm[kWarpsPerBlock][kMaxS];
    float* sc = s_cdf[threadIdx.x / 32];
    float* sz = s_zm[threadIdx.x / 32];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (j0 + k < E) {
        sc[j0 + k] = cdf[k];
        sz[j0 + k] = from_key(key_z[k]);
      }
    }
    __syncwarp();
    for (int k0 = 0; k0 < F; k0 += 32) {
      if (k0 > 0) u_own = k0 + lane < F ? __ldg(u_in + r * F + k0 + lane) : 0.0f;
      if (k0 + lane >= F) continue;
      int lo_m = 0, hi_m = E;                  // the count of edges <= u
      while (lo_m < hi_m) {
        const int mid = (lo_m + hi_m) >> 1;
        if (sc[mid] <= u_own) lo_m = mid + 1;
        else hi_m = mid;
      }
      zf_out[r * F + k0 + lane] =
          place(u_own, lo_m > 0 ? sc[lo_m - 1] : -kBig, lo_m > 0 ? sz[lo_m - 1] : -kBig,
                lo_m < E ? sc[lo_m] : kBig, lo_m < E ? sz[lo_m] : kBig, last_c, last_z);
    }
    return;
  }
  for (int k0 = 0; k0 < F; k0 += 32) {
    if (k0 > 0) u_own = k0 + lane < F ? __ldg(u_in + r * F + k0 + lane) : 0.0f;
    const int kn = min(32, F - k0);
    unsigned cdf_prev = lo, z_prev = lo, cdf_next = hi, z_next = hi;
#pragma unroll 4
    for (int i = 0; i < kn; ++i) {
      const float u = __shfl_sync(kFull, u_own, i);
      unsigned pc = lo, pz = lo, nc = hi, nz = hi;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const bool le = cdf[k] <= u;
        pc = max(pc, le ? key_c[k] : lo);
        pz = max(pz, le ? key_z[k] : lo);
        nc = min(nc, le ? hi : key_c[k]);
        nz = min(nz, le ? hi : key_z[k]);
      }
      pc = __reduce_max_sync(kFull, pc);
      pz = __reduce_max_sync(kFull, pz);
      nc = __reduce_min_sync(kFull, nc);
      nz = __reduce_min_sync(kFull, nz);
      if (lane == i) cdf_prev = pc, z_prev = pz, cdf_next = nc, z_next = nz;
    }
    if (lane < kn)
      zf_out[r * F + k0 + lane] = place(u_own, from_key(cdf_prev), from_key(z_prev),
                                        from_key(cdf_next), from_key(z_next), last_c, last_z);
  }
}

template <int P>
void launch(const float* const* in, float* const* out, int R, int S, int F, bool vec,
            cudaStream_t s) {
  const int blocks = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  composite_importance_kernel<P><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
      in[0], in[1], in[2], in[3], in[4], out[0], out[1], out[2], out[3], out[4], out[5], R,
      S, F, vec);
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
  const float* in[5] = {z, alpha, sdf, rgb, u};
  float* out[6] = {color, depth, acc, sdf_out, contrib, z_fine};
  const int P = S <= 32 ? 1 : S <= 64 ? 2 : S <= 128 ? 4 : 8;
  // a lane's run of P samples is one aligned piece when every row starts
  // on a multiple of P floats and every base pointer on 16 bytes
  const uintptr_t bases = reinterpret_cast<uintptr_t>(z) | reinterpret_cast<uintptr_t>(alpha) |
                          reinterpret_cast<uintptr_t>(sdf) | reinterpret_cast<uintptr_t>(rgb);
  const bool vec = S % P == 0 && bases % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P == 1) launch<1>(in, out, R, S, F, vec, s);
  else if (P == 2) launch<2>(in, out, R, S, F, vec, s);
  else if (P == 4) launch<4>(in, out, R, S, F, vec, s);
  else launch<8>(in, out, R, S, F, vec, s);
  return static_cast<int>(cudaGetLastError());
}
