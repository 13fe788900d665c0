// The relative spatial encoding `rel_z_decay` at inference, one launch:
//
//   dz  = scale (p_z - k_z),   w = exp(-|p - k|^2 / (2 sigma^2)),
//   out = [dz w | sin(pi dz) w | cos(pi dz) w | sin(2 pi dz) w | ... ]
//
// for every (view, point) row against K keypoints and L levels, stored as
// the (V, N, (1 + 2 L) K) bf16 operand that the geometry MLP's first dense
// layer (dense_act.cu) reads; each block of the row is K wide. Levels after
// the first come from the double-angle recursion s, c = (2 s) c, 1 - (2 s) s,
// as models/spatial_encoding.py `positional_encoding` computes them.
//
// Replaces no Pallas kernel: it is the counterpart of XLA's fusion of the
// JAX model's module-path encoding, which the port composed from ~29
// elementwise launches and a concatenation in f32 before the bf16 cast. The
// port's module path (models/keypoint_nerf.py `query_head`) calls it through
// the registered op `kpnerf::rel_z_decay` (ops/rel_z_decay.py) when no
// gradient is needed, the compute dtype is bf16 and the tensors are on the
// card; K5 (fused_geo_mlp.cu) builds its own encoding with other numerics.
//
// Numerics: the composition's bits. Every step is the f32 operation torch's
// CUDA kernels perform, in registers and in their order: __fsub_rn /
// __fmul_rn / __fadd_rn, so that nothing contracts into an FMA; the squared
// distance summed as torch's sum over a last dimension of 3 sums it, lanes
// 0 and 2 first (two threads of a reduction, the first holding elements 0
// and 2), then lane 1; the division by 2 sigma^2 as the product with its f32
// reciprocal, as torch divides by a host scalar; expf, sinf and cosf of the
// CUDA math library, no fast-math intrinsics. One rounding to bf16 (nearest
// even) at the store, where the composition's cast rounded.
//
// What bounds it: bytes, with the arithmetic close behind. A row reads 12
// bytes of points and writes 2 (1 + 2 L) K bytes (336 at K = 24, L = 3);
// per (row, keypoint) the library's expf, sinf and cosf and the rest come
// to ~100 f32 instructions, so on an H100 the arithmetic alone takes ~90%
// of the stores' time and has to overlap them (a coarse render query: the
// kernel ~1.2x its byte bound, chip_smoke.py). The design: a block takes up
// to 64 rows of one view (as many as fit a 44 KB tile); the view's
// keypoints and the rows' points are staged in shared memory; a thread a
// (row, keypoint pair) computes both keypoints' 1 + 2 L values and writes
// each pair, rounded to bf16 by one packed conversion, into the tile (one
// value a thread, converted and written alone, cost ~24% more); the tile is
// one contiguous run of the output, which one bulk asynchronous copy (TMA)
// stores, so no thread spends instructions on them (16-byte stores a thread
// cost ~10% more). No intermediate reaches device memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 64;         // rows (points of one view) a block
constexpr int kTileBytes = 44 * 1024;   // with the static arrays, under 48 KB
constexpr int kMaxK = 64;            // keypoints; K a multiple of 8 (16-byte rows)
constexpr int kMaxL = 5;             // levels (the model's default is 3)
constexpr float kPi = 3.14159265358979323846f;   // Python's math.pi as f32

__global__ void __launch_bounds__(kThreads)
rel_z_decay_kernel(const float* __restrict__ pts, const float* __restrict__ kpt,
                   __nv_bfloat16* __restrict__ out, long long N, int K, int L, int block_rows,
                   float scale, float inv_two_sigma2) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem);
  __shared__ __align__(8) float s_kpt[3][kMaxK];     // x, y, z rows: pairs read as float2
  __shared__ float s_pts[kMaxRows * 3];

  const int v = blockIdx.y;
  const long long n0 = static_cast<long long>(blockIdx.x) * block_rows;
  const int rows = static_cast<int>(min(static_cast<long long>(block_rows), N - n0));
  const int D = (1 + 2 * L) * K;
  const long long row0 = static_cast<long long>(v) * N + n0;

  for (int i = threadIdx.x; i < 3 * K; i += kThreads)
    s_kpt[i % 3][i / 3] = kpt[static_cast<long long>(v) * K * 3 + i];
  for (int i = threadIdx.x; i < 3 * rows; i += kThreads) s_pts[i] = pts[row0 * 3 + i];
  __syncthreads();

  const int P = K / 2;
  for (int i = threadIdx.x; i < rows * P; i += kThreads) {
    const int r = i / P, k = 2 * (i - r * P);
    const float kx[2] = {s_kpt[0][k], s_kpt[0][k + 1]};
    const float ky[2] = {s_kpt[1][k], s_kpt[1][k + 1]};
    const float kz[2] = {s_kpt[2][k], s_kpt[2][k + 1]};
    float dz[2], w[2], s[2], c[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float dx = __fsub_rn(s_pts[3 * r], kx[j]);
      const float dy = __fsub_rn(s_pts[3 * r + 1], ky[j]);
      const float dzr = __fsub_rn(s_pts[3 * r + 2], kz[j]);
      dz[j] = __fmul_rn(dzr, scale);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dzr, dzr)),
                                 __fmul_rn(dy, dy));
      w[j] = expf(__fmul_rn(-d2, inv_two_sigma2));
      const float y = __fmul_rn(dz[j], kPi);
      s[j] = sinf(y);
      c[j] = cosf(y);
    }
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(tile + r * D + k);
    o[0] = __floats2bfloat162_rn(__fmul_rn(dz[0], w[0]), __fmul_rn(dz[1], w[1]));
    for (int lvl = 0; lvl < L; ++lvl) {
      if (lvl) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float s2 = __fmul_rn(2.0f, s[j]);
          const float sn = __fmul_rn(s2, c[j]);
          c[j] = __fsub_rn(1.0f, __fmul_rn(s2, s[j]));
          s[j] = sn;
        }
      }
      o[(1 + 2 * lvl) * P] = __floats2bfloat162_rn(__fmul_rn(s[0], w[0]), __fmul_rn(s[1], w[1]));
      o[(2 + 2 * lvl) * P] = __floats2bfloat162_rn(__fmul_rn(c[0], w[0]), __fmul_rn(c[1], w[1]));
    }
  }
  // the tile's writes made visible to the bulk copy's (async) proxy
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  // the tile is rows x D contiguous bf16 of the output: one bulk copy; the
  // block ends once the copy has read the tile
  if (threadIdx.x == 0) {
    const unsigned src = static_cast<unsigned>(__cvta_generic_to_shared(tile));
    const unsigned bytes = static_cast<unsigned>(rows * D * 2);
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                 :: "l"(out + row0 * D), "r"(src), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

}  // namespace

// pts (V, N, 3) and kpt (V, K, 3) f32, contiguous; out (V, N, (1 + 2 L) K)
// bf16, contiguous and 16-byte aligned. `scale` and `inv_two_sigma2` are the
// f32 values torch multiplies by: float(scale) and 1 / float(2 sigma^2).
// Returns a cudaError_t: invalid-value for shapes the kernel does not take.
extern "C" int kpn_rel_z_decay(const float* pts, const float* kpt, void* out, long long V,
                               long long N, int K, int L, float scale, float inv_two_sigma2,
                               void* stream) {
  if (V < 1 || V > 65535 || N < 1 || K < 8 || K > kMaxK || K % 8 != 0 || L < 0 ||
      L > kMaxL || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int row_bytes = (1 + 2 * L) * K * 2;
  const int block_rows = min(kMaxRows, kTileBytes / row_bytes);
  const long long blocks = (N + block_rows - 1) / block_rows;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(V));
  rel_z_decay_kernel<<<grid, kThreads, static_cast<size_t>(block_rows) * row_bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      pts, kpt, static_cast<__nv_bfloat16*>(out), N, K, L, block_rows, scale, inv_two_sigma2);
  return static_cast<int>(cudaGetLastError());
}
