// The empty-ray cull's scores at inference, one launch for every ray of a
// frame: per ray the renderer's own sample depths (stratified, and the fine
// depths an all-zero-weight ray gets), their projection into every source
// view, the bf16-rounded maximum of the view's mask over the map cell that
// holds the projection, and the reduction of those values that bounds what
// the model's validity test can see (render/empty_cull.py):
//
//   TIGHT  (gather-lerp, coarse and fine looked up at their anchors): per
//          group max over anchors of min over views of a window-3 max
//          along the anchors (-inf beyond the ends); the max of the groups;
//   LOOSE  min over views of the max over all the ray's samples;
//   PLAIN  max over samples of the min over views.
//
// Replaces no Pallas kernel: it is the counterpart of XLA's fusion of the
// JAX package's `empty_ray_scores`, which the port composed from ~130
// PyTorch calls a 4,096-ray score chunk (ops/empty_cull.py
// `empty_ray_scores_plain`). render/empty_cull.py calls it through the
// registered op `kpnerf::empty_ray_scores` for every frame on the card,
// after computing the frame's cell table, projection matrices and
// AABB-clamped near / far in PyTorch.
//
// Numerics: the composition's bits. Every step is the f32 operation torch's
// CUDA kernels perform, in their order: __fmul_rn / __fadd_rn / __fsub_rn,
// so that nothing contracts into an FMA, and __fdiv_rn. The stratified
// depth near + (far - near) lin[s], lin[s] = s * f32(1 / (S - 1)) and
// lin[S - 1] = 1 (geometry/sampling.py `linspace01`); the midpoints
// 0.5 (z[m + 1] + z[m]); a fine depth z_prev + frac (z_next - z_prev) with
// the edge index j and the fraction frac per sample from a table that every
// all-zero-weight ray shares (ops/empty_cull.py `_fine_bins`, which the
// composition reads too). The projection's 3-term sums in the order of
// torch's reduction over a non-innermost dimension of 3, one thread adding
// ((x0 + x1) + x2) onto its zero, then the translation; the NDC scale as
// the product with the f32 host scalar; the division by the cell size as
// the product with its f32 reciprocal, as torch divides by a host scalar.
// The cell maxima rounded to bf16 (nearest even) as the composition's cast
// rounds them. The reductions are max / min: exact in any order.
//
// What bounds it: the f32 issue. A ray reads 20 bytes and writes 4; the
// fast preset's ray projects 66 anchors into 3 views, 8,382 of the
// composition's f32 operations a ray (chip_smoke.py `cull_ops_per_ray`;
// each IEEE division takes several instructions). The design: a thread a
// ray, everything in registers; the cell table (f32, V x Hc x Wc, any size:
// a few KB to a few hundred, held by L1 and L2), the projection matrices
// and the fine depths' table read through the read-only cache. The views
// go in blocks of kViewBlock, whose values along the anchors a TIGHT
// window keeps in registers; with one block (V <= kViewBlock) the window
// slides, each anchor projected once; with more, each block recomputes its
// anchors' neighbours. No intermediate reaches device memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;     // a grid-stride loop past this
constexpr int kViewBlock = 8;        // views whose TIGHT window sits in registers
enum { kPlain = 0, kLoose = 1, kTight = 2 };

struct Frame {
  const float* __restrict__ cmax;    // (V, Hc, Wc)
  const float* __restrict__ krt;     // (V, 4, 4)
  const float* __restrict__ origin;  // (3,)
  const float* __restrict__ dirs;    // (R, 3)
  const float* __restrict__ near;    // (R,)
  const float* __restrict__ far;     // (R,)
  const int* __restrict__ j_tab;     // (n_fine,) the fine depths' edges
  const float* __restrict__ f_tab;   // (n_fine,) their in-bin fractions
  float* __restrict__ out;           // (R,)
  long long R;
  int V, hc, wc, n_coarse, n_fine, stride, mode;
  float inv_lin, sx, sy, wm1, hm1, inv_cell;
};

// One ray: its origin and direction, and its stratified depths z[s], the
// coarse midpoints and the fine depths.
struct Ray {
  float o[3], d[3];
  float nr, span;

  __device__ float z(const Frame& f, int s) const {
    const float lin = s == f.n_coarse - 1 ? 1.0f : __fmul_rn(static_cast<float>(s), f.inv_lin);
    return __fadd_rn(nr, __fmul_rn(span, lin));
  }
  __device__ float mid(const Frame& f, int m) const {
    return __fmul_rn(0.5f, __fadd_rn(z(f, m + 1), z(f, m)));
  }
  // fine sample s: the zero-weight ray's bin j and fraction
  __device__ float fine(const Frame& f, int s) const {
    const int j = __ldg(f.j_tab + s);
    const float zp = mid(f, j);
    const float zn = mid(f, min(j + 1, f.n_coarse - 2));
    return __fadd_rn(zp, __fmul_rn(__ldg(f.f_tab + s), __fsub_rn(zn, zp)));
  }
  // sample s of the coarse group, then the fine one
  __device__ float sample(const Frame& f, int s) const {
    return s < f.n_coarse ? z(f, s) : fine(f, s - f.n_coarse);
  }
  __device__ void point(float z, float* p) const {
#pragma unroll
    for (int k = 0; k < 3; ++k) p[k] = __fadd_rn(o[k], __fmul_rn(d[k], z));
  }
};

// The bf16 cell value of view i at world point p.
__device__ __forceinline__ float cell_value(const Frame& f, int i, const float* p) {
  const float* a = f.krt + 16 * i;
  float vh[3];
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const float s = __fadd_rn(__fadd_rn(__fmul_rn(p[0], __ldg(a + 4 * m)),
                                        __fmul_rn(p[1], __ldg(a + 4 * m + 1))),
                              __fmul_rn(p[2], __ldg(a + 4 * m + 2)));
    vh[m] = __fadd_rn(__fadd_rn(s, 0.0f), __ldg(a + 4 * m + 3));
  }
  const float x = __fdiv_rn(vh[0], vh[2]);
  const float y = __fdiv_rn(vh[1], vh[2]);
  const float nx = __fsub_rn(__fmul_rn(x, f.sx), 1.0f);
  const float ny = __fsub_rn(__fmul_rn(y, f.sy), 1.0f);
  // torch's clamp keeps a NaN, which its indexing would then refuse;
  // fmaxf sends it to cell 0
  const float mx = __fmul_rn(__fmul_rn(__fadd_rn(nx, 1.0f), 0.5f), f.wm1);
  const float my = __fmul_rn(__fmul_rn(__fadd_rn(ny, 1.0f), 0.5f), f.hm1);
  const float px = fminf(fmaxf(mx, 0.0f), f.wm1);
  const float py = fminf(fmaxf(my, 0.0f), f.hm1);
  const int cx = min(static_cast<int>(floorf(__fmul_rn(px, f.inv_cell))), f.wc - 1);
  const int cy = min(static_cast<int>(floorf(__fmul_rn(py, f.inv_cell))), f.hc - 1);
  return __bfloat162float(__float2bfloat16_rn(__ldg(f.cmax + (i * f.hc + cy) * f.wc + cx)));
}

// The cell values of views v0 .. v0 + kViewBlock - 1 (those below V) at
// depth z into v[].
__device__ __forceinline__ void block_values(const Frame& f, const Ray& ray, float z, int v0,
                                             float* v) {
  float p[3];
  ray.point(z, p);
#pragma unroll
  for (int k = 0; k < kViewBlock; ++k)
    if (v0 + k < f.V) v[k] = cell_value(f, v0 + k, p);
}

__device__ __forceinline__ void fill(float* v, float x) {
#pragma unroll
  for (int k = 0; k < kViewBlock; ++k) v[k] = x;
}

// TIGHT: one group's max over anchors of min over views of the window-3
// max along the anchors.
template <bool kFine>
__device__ float tight_group(const Frame& f, const Ray& ray) {
  const int S = kFine ? f.n_fine : f.n_coarse;
  const int n_anchor = (S + f.stride - 1) / f.stride + 1;
  auto depth = [&](int a) {
    const int s = a < n_anchor - 1 ? a * f.stride : S - 1;
    return kFine ? ray.fine(f, s) : ray.z(f, s);
  };
  const bool slide = f.V <= kViewBlock;
  float prev[kViewBlock], cur[kViewBlock], next[kViewBlock];
  fill(prev, -INFINITY);
  fill(cur, -INFINITY);
  fill(next, -INFINITY);
  float best = -INFINITY;
  for (int a = 0; a < n_anchor; ++a) {
    float m = INFINITY;
    for (int v0 = 0; v0 < f.V; v0 += kViewBlock) {
      if (slide && a > 0) {
#pragma unroll
        for (int k = 0; k < kViewBlock; ++k) {
          prev[k] = cur[k];
          cur[k] = next[k];
        }
      } else {
        if (a > 0) block_values(f, ray, depth(a - 1), v0, prev);
        else fill(prev, -INFINITY);
        block_values(f, ray, depth(a), v0, cur);
      }
      if (a + 1 < n_anchor) block_values(f, ray, depth(a + 1), v0, next);
      else fill(next, -INFINITY);
#pragma unroll
      for (int k = 0; k < kViewBlock; ++k)
        if (v0 + k < f.V) m = fminf(m, fmaxf(fmaxf(prev[k], cur[k]), next[k]));
    }
    best = fmaxf(best, m);
  }
  return best;
}

__global__ void __launch_bounds__(kThreads)
empty_ray_scores_kernel(const Frame f) {
  const int S = f.n_coarse + f.n_fine;
  for (long long r = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; r < f.R;
       r += static_cast<long long>(gridDim.x) * kThreads) {
    Ray ray;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      ray.o[k] = __ldg(f.origin + k);
      ray.d[k] = f.dirs[3 * r + k];
    }
    ray.nr = f.near[r];
    ray.span = __fsub_rn(f.far[r], ray.nr);

    float score;
    if (f.mode == kTight) {
      score = fmaxf(tight_group<false>(f, ray), tight_group<true>(f, ray));
    } else if (f.mode == kLoose) {
      score = INFINITY;
      for (int i = 0; i < f.V; ++i) {
        float acc = -INFINITY;
        for (int s = 0; s < S; ++s) {
          float p[3];
          ray.point(ray.sample(f, s), p);
          acc = fmaxf(acc, cell_value(f, i, p));
        }
        score = fminf(score, acc);
      }
    } else {
      score = -INFINITY;
      for (int s = 0; s < S; ++s) {
        float p[3];
        ray.point(ray.sample(f, s), p);
        float m = INFINITY;
        for (int i = 0; i < f.V; ++i) m = fminf(m, cell_value(f, i, p));
        score = fmaxf(score, m);
      }
    }
    f.out[r] = score;
  }
}

}  // namespace

// cmax (V, Hc, Wc), krt (V, 4, 4), origin (3,), dirs (R, 3), near and far
// (R, 1) f32, contiguous; j_tab (n_fine,) int32 and f_tab (n_fine,) f32 the
// fine depths' table; out (R,) f32. `inv_lin` = f32(1 / (n_coarse - 1));
// sx, sy the NDC scales f32(2 / (W - 1)), f32(2 / (H - 1)); wm1, hm1 the
// map grid's Wm - 1, Hm - 1; inv_cell = 1 / f32(cell). Returns a
// cudaError_t: invalid-value for inputs no cull has (fewer than 3 coarse
// or 1 fine sample, TIGHT below stride 2, a table past int indexing).
extern "C" int kpn_empty_ray_scores(const float* cmax, const float* krt, const float* origin,
                                    const float* dirs, const float* near, const float* far,
                                    const int* j_tab, const float* f_tab, float* out,
                                    long long R, int V, int hc, int wc, int n_coarse,
                                    int n_fine, int stride, int mode, float inv_lin, float sx,
                                    float sy, float wm1, float hm1, float inv_cell,
                                    void* stream) {
  if (R < 1 || V < 1 || hc < 1 || wc < 1 || static_cast<long long>(V) * hc * wc > INT_MAX ||
      n_coarse < 3 || n_fine < 1 || mode < kPlain || mode > kTight ||
      (mode == kTight && stride < 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const Frame f{cmax, krt, origin, dirs, near, far, j_tab, f_tab, out, R,
                V, hc, wc, n_coarse, n_fine, stride, mode,
                inv_lin, sx, sy, wm1, hm1, inv_cell};
  const long long need = (R + kThreads - 1) / kThreads;
  const long long blocks = need < kMaxBlocks ? need : kMaxBlocks;
  empty_ray_scores_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(f);
  return static_cast<int>(cudaGetLastError());
}
