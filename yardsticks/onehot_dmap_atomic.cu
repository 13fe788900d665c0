// The earlier design of the port's K1 (keypointnerf_torch/csrc/onehot_dmap.cu
// before it summed in a fixed order), kept unchanged below this note as the
// yardstick of K1's time: chip_smoke.py builds it beside the port's kernels
// and holds K1 to at most 1.25x its time at the training steps' own points,
// both timed in one run. The port never builds or calls it. Its cell runs
// are added into dmap with float atomics, so its last bits change from run
// to run.
//
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
// change a rounding. The cotangent comes in f32 or bf16 (as autograd hands
// over a bf16 lookup's) and is widened in registers, which is exact.
//
// What bounds it: bytes. At the fine query of a zju training step (V = 3,
// N = 524,288 points a view, C = 64, a 128 x 128 map) the inputs are 8
// bytes of coordinates and 128 bytes of bf16 cotangent a point, 214 MB,
// plus a 12.6 MB dmap: ~68 us at 3.35 TB/s (~128 us with an f32
// cotangent). One f32 atomic add a term (4 * C * V * N = 403 M at that
// query) is what held the earlier one-thread-a-term design at ~5x that,
// and at the training step's points, which a 64 x 64 patch of rays
// projects into ~2,800 of the 48,387 cells, same-address atomics
// serialised it further (1.68 ms there against 0.68 at uniform points).
// Design: the points are binned by their base cell (v, y0, x0) and summed
// cell by cell in registers, so global atomics happen only where a run of
// one cell ends. Four kernels on the caller's stream, all launched here:
//   1. count: a block bins 2048 points in a shared-memory hash of cells
//      (lanes of a warp that share a cell update it once), then adds one
//      count a distinct cell into the global histogram, so a hot cell
//      takes one global atomic a block; each point keeps its rank;
//   2. scan: one block turns the V*H*W counts into cell offsets in place,
//      a warp a contiguous run of int4s;
//   3. scatter: each point writes its index to offset + rank, so the
//      indices lie in cell order;
//   4. accumulate: a warp a segment of kSegment sorted points. Each lane
//      finds the cell and weights of one of 32 points and leaves them in
//      shared memory; lanes own channels, two a lane (one 8-byte f32 or
//      4-byte bf16 load of a point's row, a coalesced row a warp), with
//      the rows of 8 (f32) or 16 (bf16) points loaded ahead. While the
//      cell stays the same the four corners' terms add up in registers (8
//      floats a lane); where it changes, and at the segment's end, each
//      lane adds them into dmap with four vector atomics.
// The rows are gathered in cell order, so the cotangent is read once but
// not in sequence: the accumulate pass takes most of the time. The
// segment cap bounds the terms one register sums in order (a hot cell
// holds thousands of points). Rows of other widths take a loop over
// 64-channel chunks; an odd width or an unaligned pointer takes single
// channels. The sum order within a cell depends on the atomics of pass 1,
// so the last bits change from run to run. The wrapper passes one scratch
// buffer (histogram, indices, ranks: 8 bytes a point and 4 a cell) and the
// output; the kernel allocates nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kCountThreads = 512;
constexpr int kCountPerThread = 4;            // a count block bins 2048 points
constexpr int kSlots = 4096;                  // its shared hash of cells
constexpr int kScanThreads = 1024;
constexpr int kSegment = 128;                 // sorted points a warp sums

template <typename T>
__device__ __forceinline__ float2 rnd2(float a, float b);
template <>
__device__ __forceinline__ float2 rnd2<float>(float a, float b) { return make_float2(a, b); }
template <>
__device__ __forceinline__ float2 rnd2<__nv_bfloat16>(float a, float b) {
  return __bfloat1622float2(__floats2bfloat162_rn(a, b));   // each rounded once
}

struct Cell {
  int key;    // (v * H + y0) * W + x0
  float wx, wy;
};

// NDC -> pixel, border clamp, base clamped to S-2 (onehot_dmap.py:63-70)
__device__ __forceinline__ Cell cell_of(const float* __restrict__ xy, int p, int N,
                                        int H, int W) {
  const float2 q = __ldg(reinterpret_cast<const float2*>(xy) + p);
  float x = __fmul_rn(__fmul_rn(__fadd_rn(q.x, 1.0f), 0.5f), static_cast<float>(W - 1));
  float y = __fmul_rn(__fmul_rn(__fadd_rn(q.y, 1.0f), 0.5f), static_cast<float>(H - 1));
  x = fminf(fmaxf(x, 0.0f), static_cast<float>(W - 1));
  y = fminf(fmaxf(y, 0.0f), static_cast<float>(H - 1));
  const float x0 = fminf(floorf(x), static_cast<float>(W - 2));
  const float y0 = fminf(floorf(y), static_cast<float>(H - 2));
  Cell c;
  c.key = ((p / N) * H + static_cast<int>(y0)) * W + static_cast<int>(x0);
  c.wx = __fsub_rn(x, x0);
  c.wy = __fsub_rn(y, y0);
  return c;
}

// pass 1: per-cell counts and each point's rank in its cell. A block bins
// its 2048 points in a shared hash table (lanes of a warp that share a
// cell update it once), then adds one count a distinct cell to the global
// histogram, so a hot cell takes one global atomic a block.
__global__ void __launch_bounds__(kCountThreads) count_kernel(
    const float* __restrict__ xy, int* __restrict__ hist, int* __restrict__ rank,
    int total, int N, int H, int W) {
  __shared__ int s_key[kSlots];
  __shared__ int s_cnt[kSlots];
  for (int i = threadIdx.x; i < kSlots; i += kCountThreads) s_key[i] = -1, s_cnt[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int first = blockIdx.x * kCountThreads * kCountPerThread + threadIdx.x;
  int slot[kCountPerThread], local[kCountPerThread];
#pragma unroll
  for (int q = 0; q < kCountPerThread; ++q) {
    const int p = first + q * kCountThreads;
    const int key = p < total ? cell_of(xy, p, N, H, W).key : -1;
    const unsigned peers = __match_any_sync(kFull, key);
    const int leader = __ffs(peers) - 1;
    int at = 0, base = 0;
    if (key >= 0 && lane == leader) {
      at = (static_cast<unsigned>(key) * 0x9E3779B1u) >> 20;   // 12 bits: kSlots
      for (;;) {
        const int prev = atomicCAS(s_key + at, -1, key);
        if (prev == -1 || prev == key) break;
        at = (at + 1) & (kSlots - 1);
      }
      base = atomicAdd(s_cnt + at, __popc(peers));
    }
    slot[q] = __shfl_sync(kFull, at, leader);
    local[q] = __shfl_sync(kFull, base, leader) + __popc(peers & ((1u << lane) - 1u));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kSlots; i += kCountThreads)
    if (s_key[i] >= 0) s_cnt[i] = atomicAdd(hist + s_key[i], s_cnt[i]);   // the block's base
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kCountPerThread; ++q) {
    const int p = first + q * kCountThreads;
    if (p < total) rank[p] = s_cnt[slot[q]] + local[q];
  }
}

// pass 2: exclusive scan of the 4 * n4 counts in place, one block; warp w
// scans its contiguous run of int4s, after a first pass for the runs'
// totals
__global__ void __launch_bounds__(kScanThreads) scan_kernel(int* __restrict__ data, int n4) {
  __shared__ int warp_base[kScanThreads / 32];
  int4* d = reinterpret_cast<int4*>(data);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (n4 + 31) / 32;
  const int begin = min(warp * per, n4), end = min(begin + per, n4);
  int sum = 0;
#pragma unroll 4
  for (int i = begin + lane; i < end; i += 32) {
    const int4 v = d[i];
    sum += v.x + v.y + v.z + v.w;
  }
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
  if (lane == 0) warp_base[warp] = sum;
  __syncthreads();
  if (warp == 0) {
    const int t = warp_base[lane];
    int inc = t;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc += u;
    }
    warp_base[lane] = inc - t;
  }
  __syncthreads();
  int carry = warp_base[warp];
  int4 next = begin + lane < end ? d[begin + lane] : make_int4(0, 0, 0, 0);
  for (int i0 = begin; i0 < end; i0 += 32) {
    const int4 v = next;
    if (i0 + 32 + lane < end) next = d[i0 + 32 + lane];
    const int s = v.x + v.y + v.z + v.w;
    int inc = s;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc += u;
    }
    const int e = carry + inc - s;
    if (i0 + lane < end) d[i0 + lane] = make_int4(e, e + v.x, e + v.x + v.y, e + v.x + v.y + v.z);
    carry += __shfl_sync(kFull, inc, 31);
  }
}

// pass 3: the point indices in cell order
__global__ void __launch_bounds__(kThreads) scatter_kernel(
    const float* __restrict__ xy, const int* __restrict__ offsets,
    const int* __restrict__ rank, int* __restrict__ order, int total, int N, int H, int W) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= total) return;
  order[offsets[cell_of(xy, p, N, H, W).key] + rank[p]] = p;
}

// a lane's (up to) two channels c0, c0 + 1 of a cotangent row, loaded as
// stored (Raw) and widened to f32 where used
template <typename G, bool kPair>
struct Row;
template <>
struct Row<float, true> {
  using Raw = float2;
  static __device__ __forceinline__ Raw load(const float* __restrict__ g, int64_t at, int nc) {
    return nc ? __ldg(reinterpret_cast<const float2*>(g + at)) : make_float2(0.0f, 0.0f);
  }
  static __device__ __forceinline__ float2 wide(Raw r) { return r; }
};
template <>
struct Row<float, false> {
  using Raw = float2;
  static __device__ __forceinline__ Raw load(const float* __restrict__ g, int64_t at, int nc) {
    return make_float2(nc > 0 ? __ldg(g + at) : 0.0f, nc > 1 ? __ldg(g + at + 1) : 0.0f);
  }
  static __device__ __forceinline__ float2 wide(Raw r) { return r; }
};
template <>
struct Row<__nv_bfloat16, true> {
  using Raw = __nv_bfloat162;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* __restrict__ g, int64_t at,
                                             int nc) {
    return nc ? __ldg(reinterpret_cast<const __nv_bfloat162*>(g + at))
              : __floats2bfloat162_rn(0.0f, 0.0f);
  }
  static __device__ __forceinline__ float2 wide(Raw r) { return __bfloat1622float2(r); }
};
template <>
struct Row<__nv_bfloat16, false> {
  using Raw = __nv_bfloat162;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* __restrict__ g, int64_t at,
                                             int nc) {
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
    return __halves2bfloat162(nc > 0 ? g[at] : zero, nc > 1 ? g[at + 1] : zero);
  }
  static __device__ __forceinline__ float2 wide(Raw r) { return __bfloat1622float2(r); }
};

// add a cell's four corners (acc[dy * 2 + dx]) into dmap
template <bool kPair>
__device__ __forceinline__ void flush(float* __restrict__ dmap, int key, int W, int C,
                                      int c0, int nc, const float2 (&acc)[4]) {
  if (!nc) return;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float* dst = dmap + (static_cast<int64_t>(key) + (q >> 1) * W + (q & 1)) * C + c0;
    if (kPair) {
      atomicAdd(reinterpret_cast<float2*>(dst), acc[q]);
    } else {
      atomicAdd(dst, acc[q].x);
      if (nc > 1) atomicAdd(dst + 1, acc[q].y);
    }
  }
}

// pass 4: a warp sums the terms of kSegment sorted points, cell by cell.
// Each lane finds the cell and weights of one of 32 points and leaves them
// in shared memory; then, for kBatch points at a time, the warp loads
// their rows and adds their terms.
template <typename T, typename G, bool kPair>
__global__ void __launch_bounds__(kThreads) accumulate_kernel(
    const int* __restrict__ order, const float* __restrict__ xy, const G* __restrict__ g,
    float* __restrict__ dmap, int total, int N, int H, int W, int C) {
  using R = Row<G, kPair>;
  constexpr int kBatch = sizeof(G) == 2 ? 16 : 8;   // rows loaded ahead
  const int lane = threadIdx.x & 31;
  const int start = ((blockIdx.x * kThreads + threadIdx.x) >> 5) * kSegment;
  if (start >= total) return;                       // whole warps leave together
  const int end = min(start + kSegment, total);
  __shared__ int4 s_pt[kThreads / 32][32];      // {p, key, yw0, yw1} of 32 points
  __shared__ float2 s_xw[kThreads / 32][32];
  const int w = threadIdx.x >> 5;
  for (int cbase = 0; cbase < C; cbase += 64) {
    const int c0 = cbase + 2 * lane;
    const int nc = max(0, min(2, C - c0));
    float2 acc[4] = {};
    int cur = -1;
    for (int i0 = start; i0 < end; i0 += 32) {
      const int n = min(32, end - i0);
      {
        const int p = order[i0 + min(lane, n - 1)];
        const Cell own = cell_of(xy, p, N, H, W);
        const float2 yw = rnd2<T>(__fsub_rn(1.0f, own.wy), own.wy);
        s_pt[w][lane] = make_int4(p, own.key, __float_as_int(yw.x), __float_as_int(yw.y));
        s_xw[w][lane] = make_float2(__fsub_rn(1.0f, own.wx), own.wx);   // f32, as XwE
      }
      __syncwarp();
      for (int k0 = 0; k0 < n; k0 += kBatch) {
        typename R::Raw gv[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int p = s_pt[w][(k0 + b) & 31].x;
          gv[b] = R::load(g, static_cast<int64_t>(p) * C + c0, k0 + b < n ? nc : 0);
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          if (k0 + b >= n) break;                   // the same in every lane
          const int4 pt = s_pt[w][k0 + b];
          const float2 xw = s_xw[w][k0 + b];
          if (pt.y != cur) {
            if (cur >= 0) flush<kPair>(dmap, cur, W, C, c0, nc, acc);
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[q] = make_float2(0.0f, 0.0f);
            cur = pt.y;
          }
          const float2 gw = R::wide(gv[b]);
          const float ywa = __int_as_float(pt.z), ywb = __int_as_float(pt.w);
#pragma unroll
          for (int dx = 0; dx < 2; ++dx) {
            const float x = dx ? xw.y : xw.x;
            const float2 t = rnd2<T>(__fmul_rn(x, gw.x), __fmul_rn(x, gw.y));
            acc[dx].x = __fadd_rn(acc[dx].x, __fmul_rn(ywa, t.x));
            acc[dx].y = __fadd_rn(acc[dx].y, __fmul_rn(ywa, t.y));
            acc[2 + dx].x = __fadd_rn(acc[2 + dx].x, __fmul_rn(ywb, t.x));
            acc[2 + dx].y = __fadd_rn(acc[2 + dx].y, __fmul_rn(ywb, t.y));
          }
        }
      }
      __syncwarp();
    }
    flush<kPair>(dmap, cur, W, C, c0, nc, acc);
  }
}

int grid_for(int64_t threads, int per_block) {
  return static_cast<int>((threads + per_block - 1) / per_block);
}

// the histogram's entries: the cells, padded to whole int4s
int64_t hist_entries(int64_t cells) { return (cells + 3) / 4 * 4; }

template <typename T, typename G>
int launch(const float* xy, const G* g, float* dmap, char* scratch, int V, int N, int H,
           int W, int C, cudaStream_t s) {
  const int total = V * N;
  const int cells = V * H * W;
  const int64_t entries = hist_entries(cells);
  int* hist = reinterpret_cast<int*>(scratch);
  int* order = hist + entries;
  int* rank = order + total;
  cudaError_t err = cudaMemsetAsync(
      dmap, 0, static_cast<size_t>(cells) * C * sizeof(float), s);
  if (err != cudaSuccess || total == 0) return static_cast<int>(err);
  err = cudaMemsetAsync(hist, 0, static_cast<size_t>(entries) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  count_kernel<<<grid_for(total, kCountThreads * kCountPerThread), kCountThreads, 0, s>>>(
      xy, hist, rank, total, N, H, W);
  scan_kernel<<<1, kScanThreads, 0, s>>>(hist, static_cast<int>(entries / 4));
  scatter_kernel<<<grid_for(total, kThreads), kThreads, 0, s>>>(
      xy, hist, rank, order, total, N, H, W);
  const int64_t warps = (total + kSegment - 1) / kSegment;
  const bool pair = C % 2 == 0 && reinterpret_cast<uintptr_t>(g) % (2 * sizeof(G)) == 0;
  if (pair) {
    accumulate_kernel<T, G, true><<<grid_for(warps * 32, kThreads), kThreads, 0, s>>>(
        order, xy, g, dmap, total, N, H, W, C);
  } else {
    accumulate_kernel<T, G, false><<<grid_for(warps * 32, kThreads), kThreads, 0, s>>>(
        order, xy, g, dmap, total, N, H, W, C);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_map(const float* xy, const void* g, int g_dtype, float* dmap, char* scratch,
               int V, int N, int H, int W, int C, cudaStream_t s) {
  if (g_dtype == 0)
    return launch<T>(xy, static_cast<const float*>(g), dmap, scratch, V, N, H, W, C, s);
  if (g_dtype == 1)
    return launch<T>(xy, static_cast<const __nv_bfloat16*>(g), dmap, scratch, V, N, H, W,
                     C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Scratch bytes the kernel needs: a count a map cell (padded to a multiple
// of 4), an index and a rank a point (the wrapper mirrors this as
// onehot_dmap.scratch_bytes).
extern "C" int64_t kpn_onehot_dmap_scratch_bytes(int V, int N, int H, int W) {
  return 4 * hist_entries(static_cast<int64_t>(V) * H * W) + 8 * static_cast<int64_t>(V) * N;
}

// xy: (V, N, 2) f32 contiguous; g: (V, N, C) contiguous, f32 (g_dtype 0)
// or bf16 (1); dmap: (V, H, W, C) f32 contiguous, written whole (zeroed
// here first); scratch: at least kpn_onehot_dmap_scratch_bytes(V, N, H, W)
// bytes, 16-byte aligned. dtype 0 = f32 map, 1 = bf16 map (the rounding of
// the terms). V * N and V * H * W must fit an int. Returns the first CUDA
// error of the memsets and launches (0 on success).
extern "C" int kpn_onehot_dmap(const float* xy, const void* g, float* dmap, void* scratch,
                               int64_t scratch_size, int V, int N, int H, int W, int C,
                               int dtype, int g_dtype, void* stream) {
  const int64_t total = static_cast<int64_t>(V) * N;
  const int64_t cells = static_cast<int64_t>(V) * H * W;
  if (V < 0 || N < 0 || H < 2 || W < 2 || C < 1 || total > INT32_MAX ||
      cells > INT32_MAX || scratch_size < kpn_onehot_dmap_scratch_bytes(V, N, H, W) ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(xy) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* buf = static_cast<char*>(scratch);
  if (dtype == 0) return launch_map<float>(xy, g, g_dtype, dmap, buf, V, N, H, W, C, s);
  if (dtype == 1)
    return launch_map<__nv_bfloat16>(xy, g, g_dtype, dmap, buf, V, N, H, W, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
