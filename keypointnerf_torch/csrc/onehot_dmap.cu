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
// The TPU kernel's grid runs in order, so its sums have a fixed order and
// the JAX step is bit-reproducible. This kernel keeps that: no float is
// summed in an order that depends on scheduling, and two launches on the
// same inputs give the same bits. Integer atomics only count.
//
// What bounds it: bytes. At the fine query of a zju training step (V = 3,
// N = 524,288 points a view, C = 64, a 128 x 128 map) the inputs are 8
// bytes of coordinates and 128 bytes of bf16 cotangent a point, 214 MB,
// plus a 12.6 MB dmap: ~68 us at 3.35 TB/s (~128 us with an f32
// cotangent). The points of a training step fall into few cells (a 64 x 64
// patch of rays projects into ~2,800 of the 48,387 cells), so the terms
// are summed cell by cell in registers after the points are sorted by
// cell; atomics on dmap (the earlier designs) serialised on hot cells and
// summed in scheduling order.
//
// Design, all on the caller's stream from one C call:
//   1. keys: each point's cell, keyed by its corner's texel (v * H + y0) *
//      W + x0, and the histograms of the sort's digits; every cell's run
//      start set to "none";
//   2. sort: an LSD radix sort of (key, point index), 8 bits or fewer a
//      pass, stable: each tile's count of each digit (from the keys pass,
//      or counted by the pass before) is scanned, digit-major, into the
//      tile's offsets; a block then ranks its tile's kTile points (a warp
//      its share in index order, lanes of one digit counted by
//      __match_any_sync, the warps' counts scanned in warp order), lays
//      them out in shared memory in digit order and writes each digit's
//      run to consecutive places (coalesced stores: scattered ones took
//      most of a pass). Each cell's points end up in point-index order;
//   3. accumulate: a warp sums a segment of kSegment sorted points, cell by
//      cell. Its lanes find the cells and weights of all the segment's
//      points and leave them in shared memory; lanes own channels, two a
//      lane (one 8-byte f32 or 4-byte bf16 load of a point's row, a
//      coalesced row a warp), the rows of the next 4 (f32) or 8 (bf16)
//      points loading while these are summed.
//      While the cell stays the same the four corners' terms add up in
//      registers (8 floats a lane) in point order. A run that lies whole in
//      the segment stores its four corner sums, each in the plane of its
//      corner (corner (0, 0) in dmap itself, the other three in scratch),
//      so no two stores meet; a run cut by a segment's edge (a hot cell
//      holds thousands of points) stores its piece, two slots a segment.
//      Each run's bounds in the sorted order are recorded;
//   4. pieces: a cut run's pieces are summed in segment order, by the warp
//      of the segment it starts in, into the planes;
//   5. combine: a warp writes 32 texels, each once: zero where no point
//      reaches it, else the sum in corner order of its (up to) four cells'
//      corner sums, read from the planes.
// So each texel is summed by cell, each cell by segment, each piece by
// point, in an order fixed by the inputs alone. Rows of other widths take a
// loop over 64-channel chunks; an odd width or an unaligned pointer takes
// single channels. The wrapper passes one scratch buffer
// (kpn_onehot_dmap_scratch_bytes: three corner planes of dmap's size, the
// sort's buffers, the pieces) and the output; the kernel allocates
// nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;                    // every kernel's block
constexpr int kWarps = kThreads / 32;
constexpr int kSortItems = 8;                    // points a thread ranks
constexpr int kTile = kThreads * kSortItems;     // points a sort block ranks
constexpr int kRadixBits = 8;                    // most bits a sort pass takes
constexpr int kBins = 1 << kRadixBits;
constexpr int kMaxPasses = 4;                    // keys of up to 31 bits
constexpr int kSegment = 128;                    // sorted points a warp sums
constexpr int kPieceBatch = 4;                   // pieces a sum loads at a time
constexpr int kCombineBatch = 8;                 // texels a combine step loads at a time
static_assert(kThreads == kBins, "a sort block's thread d owns digit d");

template <typename T>
__device__ __forceinline__ float2 rnd2(float a, float b);
template <>
__device__ __forceinline__ float2 rnd2<float>(float a, float b) { return make_float2(a, b); }
template <>
__device__ __forceinline__ float2 rnd2<__nv_bfloat16>(float a, float b) {
  return __bfloat1622float2(__floats2bfloat162_rn(a, b));   // each rounded once
}

struct Cell {
  int key;    // (v * H + y0) * W + x0: the texel of its corner (y0, x0)
  float wx, wy;
};

// NDC -> pixel, border clamp, base clamped to S-2 (onehot_dmap.py:63-70)
__device__ __forceinline__ Cell cell_of(const float* __restrict__ xy, int p, int N, int H,
                                        int W) {
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

// adds one to s[slot] for every lane of the warp with that slot (-1: none),
// one shared atomic a distinct slot
__device__ __forceinline__ void count_in(int* s, int slot) {
  const unsigned peers = __match_any_sync(kFull, slot);
  if (slot >= 0 && static_cast<int>(threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(s + slot, __popc(peers));
}

// Passes after the first are launched as programmatic dependents of the one
// before (Hopper's programmatic dependent launch): a pass lets the next one
// launch once all its blocks run, and the next one waits here, before it
// reads anything, until the pass before it has finished and its writes are
// visible. The launch overlaps the pass before; the order stays the
// stream's.
__device__ __forceinline__ void follow() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;" :::);
}

// pass 1: the keys, the digit histograms of every sort pass, each tile's
// count of every first digit (digit-major), and every cell's run start set
// to -1 (no point)
__global__ void __launch_bounds__(kThreads) keys_kernel(
    const float* __restrict__ xy, int* __restrict__ keys, int* __restrict__ hist,
    int* __restrict__ counts, int* __restrict__ first, int total, int cells, int N, int H,
    int W, int passes, int bits) {
  __shared__ int s_hist[kMaxPasses * kBins];
  follow();
  for (int i = threadIdx.x; i < kMaxPasses * kBins; i += kThreads) s_hist[i] = 0;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < cells; i += gridDim.x * kThreads)
    first[i] = -1;
  __syncthreads();
  const int mask = (1 << bits) - 1;
#pragma unroll
  for (int q = 0; q < kSortItems; ++q) {
    const int p = blockIdx.x * kTile + q * kThreads + threadIdx.x;
    const bool ok = p < total;
    const int key = ok ? cell_of(xy, p, N, H, W).key : -1;
    if (ok) keys[p] = key;
    for (int s = 0; s < passes; ++s)
      count_in(s_hist + s * kBins, ok ? (key >> (s * bits)) & mask : -1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < passes * kBins; i += kThreads)
    if (s_hist[i]) atomicAdd(hist + i, s_hist[i]);
  // this tile's count of each first digit: the first sort pass's tiles are
  // these blocks' points
  counts[threadIdx.x * gridDim.x + blockIdx.x] = s_hist[threadIdx.x];
}

// pass 2a, once a digit: digit d's block turns its row of per-tile counts
// (digit-major, T tiles) into each tile's offset for the digit: the points
// of every smaller digit (the pass's histogram) and of this digit in the
// tiles before it
__global__ void __launch_bounds__(kThreads) scan_kernel(int* __restrict__ counts,
                                                        const int* __restrict__ hist, int T) {
  __shared__ int s_sum[kWarps];
  __shared__ int s_carry;
  follow();
  const int d = blockIdx.x, lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  // the points of the digits before d
  int v = static_cast<int>(threadIdx.x) < d ? hist[threadIdx.x] : 0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  if (lane == 0) s_sum[w] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    int base = 0;
    for (int i = 0; i < kWarps; ++i) base += s_sum[i];
    s_carry = base;
  }
  __syncthreads();
  int* row = counts + static_cast<int64_t>(d) * T;
  for (int c0 = 0; c0 < T; c0 += kThreads) {
    const int t = c0 + threadIdx.x;
    const int x = t < T ? row[t] : 0;
    int inc = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc += u;
    }
    if (lane == 31) s_sum[w] = inc;
    __syncthreads();
    int before = s_carry;
    for (int i = 0; i < w; ++i) before += s_sum[i];
    if (t < T) row[t] = before + inc - x;
    __syncthreads();
    if (threadIdx.x == kThreads - 1) s_carry = before + inc;
    __syncthreads();
  }
}

// pass 2b, once a digit: a stable scatter of (key, index) by the digit
// (key >> shift) & (2^bits - 1). Block t ranks tile t's kTile points: warp
// w its share in index order, 32 at a time, lanes of one digit counted by
// __match_any_sync; the warps' counts are scanned in warp order. The tile
// is then laid out in shared memory sorted by digit and written out in
// that order, so consecutive threads write each digit's run to
// consecutive places from the tile's offset for it (scan_kernel). Where a
// pass follows, each point's count goes to its tile there and its next
// digit (integer atomics: they only count). vals_in == nullptr on the first
// pass: the index is the position.
__global__ void __launch_bounds__(kThreads) sort_pass_kernel(
    const int* __restrict__ keys_in, const int* __restrict__ vals_in,
    int* __restrict__ keys_out, int* __restrict__ vals_out,
    const int* __restrict__ offsets, int* __restrict__ next_counts, int T, int total,
    int shift, int bits, int next_shift) {
  __shared__ int s_warp[kWarps][kBins];
  __shared__ int s_start[kBins];                    // the digit's first place in the tile
  __shared__ int s_offset[kBins];                   // ... and among all points
  __shared__ int s_sum[kWarps];
  __shared__ int s_key[kTile], s_val[kTile];
  follow();
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int d = lane; d < kBins; d += 32) s_warp[w][d] = 0;
  __syncthreads();
  const int tile = blockIdx.x;
  const int mask = (1 << bits) - 1;
  const unsigned lower = (1u << lane) - 1u;
  const int first = tile * kTile + w * (32 * kSortItems) + lane;
  int key[kSortItems], val[kSortItems], rank[kSortItems];
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) {
    const int e = first + r * 32;
    const bool ok = e < total;
    key[r] = ok ? keys_in[e] : 0;
    val[r] = ok ? (vals_in ? vals_in[e] : e) : 0;
  }
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) {
    const bool ok = first + r * 32 < total;
    const int d = ok ? (key[r] >> shift) & mask : -1;
    const unsigned peers = __match_any_sync(kFull, d);
    const int before = ok ? s_warp[w][d] : 0;
    __syncwarp();
    if (ok && lane == __ffs(peers) - 1) s_warp[w][d] = before + __popc(peers);
    __syncwarp();
    rank[r] = before + __popc(peers & lower);
  }
  __syncthreads();
  // thread d: its digit's offset in each warp, the tile's count of it, and
  // (an exclusive scan over the digits) its first place in the tile
  const int d = threadIdx.x;
  int count = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    const int t = s_warp[i][d];
    s_warp[i][d] = count;
    count += t;
  }
  int inc = count;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += u;
  }
  if (lane == 31) s_sum[w] = inc;
  __syncthreads();
  int start = inc - count;
  for (int i = 0; i < w; ++i) start += s_sum[i];
  s_start[d] = start;
  s_offset[d] = d <= mask ? offsets[static_cast<int64_t>(d) * T + tile] : 0;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) {
    if (first + r * 32 < total) {
      const int dr = (key[r] >> shift) & mask;
      const int at = s_start[dr] + s_warp[w][dr] + rank[r];
      s_key[at] = key[r];
      s_val[at] = val[r];
    }
  }
  __syncthreads();
  const int n = min(kTile, total - tile * kTile);
  for (int i0 = 0; i0 < kTile; i0 += kThreads) {
    const int i = i0 + threadIdx.x;
    const bool ok = i < n;
    const int k = ok ? s_key[i] : 0;
    const int dk = (k >> shift) & mask;
    const int at = ok ? s_offset[dk] + i - s_start[dk] : 0;
    if (ok) {
      keys_out[at] = k;
      vals_out[at] = s_val[i];
    }
    if (next_counts) {
      const int slot = ok ? ((k >> next_shift) & mask) * T + at / kTile : -1;
      const unsigned peers = __match_any_sync(kFull, slot);
      if (ok && lane == __ffs(peers) - 1) atomicAdd(next_counts + slot, __popc(peers));
    }
  }
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

// a lane's (up to) two floats of a row at c0: loaded and stored in one
// 8-byte access, or one by one
template <bool kPair>
__device__ __forceinline__ float2 load2(const float* src, int nc) {
  if (kPair) return nc ? *reinterpret_cast<const float2*>(src) : make_float2(0.0f, 0.0f);
  return make_float2(nc > 0 ? src[0] : 0.0f, nc > 1 ? src[1] : 0.0f);
}

template <bool kPair>
__device__ __forceinline__ void store2(float* dst, int nc, float2 v) {
  if (!nc) return;
  if (kPair) {
    *reinterpret_cast<float2*>(dst) = v;
  } else {
    dst[0] = v.x;
    if (nc > 1) dst[1] = v.y;
  }
}

// the plane of corner q of a cell (q = dy * 2 + dx): dmap itself for q = 0,
// else planes[q - 1]; texel-major like dmap
__device__ __forceinline__ float* corner_plane(float* dmap, float* planes, int q,
                                               int64_t plane) {
  return q ? planes + (q - 1) * plane : dmap;
}

// a whole run's corner sums, each at its texel in its corner's plane (no
// other cell writes that place)
template <bool kPair>
__device__ __forceinline__ void store_corners(float* __restrict__ dmap, float* planes,
                                              int64_t plane, int key, int W, int C, int c0,
                                              int nc, const float2 (&acc)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
    store2<kPair>(corner_plane(dmap, planes, q, plane) +
                      (static_cast<int64_t>(key) + (q >> 1) * W + (q & 1)) * C + c0,
                  nc, acc[q]);
}

// a piece: the four corners' sums of one run in one segment, (4, C) floats
template <bool kPair>
__device__ __forceinline__ void store_piece(float* __restrict__ piece, int C, int c0, int nc,
                                            const float2 (&acc)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) store2<kPair>(piece + q * C + c0, nc, acc[q]);
}

// pass 3: a warp sums the terms of kSegment sorted points, cell by cell.
// Its lanes first find the cells and weights of all the segment's points
// and leave them in shared memory; then, for kBatch points at a time, the
// warp loads their rows and adds their terms. A run that lies whole in the
// segment stores its corner sums in the planes; a run cut by an edge
// stores its piece (slot 2 * segment for the segment's first run, + 1 for
// its last). Each run's bounds [first, end) are recorded where they fall.
template <typename T, typename G, bool kPair>
__global__ void __launch_bounds__(kThreads) accumulate_kernel(
    const int* __restrict__ keys, const int* __restrict__ order, int* __restrict__ first,
    int* __restrict__ end, const float* __restrict__ xy, const G* __restrict__ g,
    float* __restrict__ dmap, float* __restrict__ planes, float* __restrict__ pieces,
    int64_t plane, int total, int N, int H, int W, int C) {
  using R = Row<G, kPair>;
  constexpr int kBatch = sizeof(G) == 2 ? 8 : 4;    // rows loaded at once
  follow();
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int j = blockIdx.x * kWarps + w;            // segment j
  const int a = j * kSegment;
  if (a >= total) return;                           // whole warps leave together
  const int n = min(kSegment, total - a);
  const bool cut_a = a > 0 && keys[a - 1] == keys[a];         // the first run began before a
  const bool cut_b = a + n < total && keys[a + n] == keys[a + n - 1];   // the last goes on
  __shared__ int4 s_pt[kWarps][kSegment];           // {p, key, yw0, yw1} of each point
  __shared__ float2 s_xw[kWarps][kSegment];
  {
    int p[kSegment / 32];
#pragma unroll
    for (int k = 0; k < kSegment / 32; ++k) p[k] = order[a + min(k * 32 + lane, n - 1)];
#pragma unroll
    for (int k = 0; k < kSegment / 32; ++k) {
      const Cell own = cell_of(xy, p[k], N, H, W);
      const float2 yw = rnd2<T>(__fsub_rn(1.0f, own.wy), own.wy);
      s_pt[w][k * 32 + lane] =
          make_int4(p[k], own.key, __float_as_int(yw.x), __float_as_int(yw.y));
      s_xw[w][k * 32 + lane] = make_float2(__fsub_rn(1.0f, own.wx), own.wx);   // f32, as XwE
    }
  }
  __syncwarp();
  for (int cbase = 0; cbase < C; cbase += 64) {
    const int c0 = cbase + 2 * lane;
    const int nc = max(0, min(2, C - c0));
    float2 acc[4] = {};
    int cur = -1;
    bool first_run = true;
    // the rows of the next kBatch points load while these are summed
    typename R::Raw next[kBatch];
#pragma unroll
    for (int t = 0; t < kBatch; ++t) {
      const int p = s_pt[w][min(t, n - 1)].x;
      next[t] = R::load(g, static_cast<int64_t>(p) * C + c0, t < n ? nc : 0);
    }
    for (int k0 = 0; k0 < n; k0 += kBatch) {
      typename R::Raw gv[kBatch];
#pragma unroll
      for (int t = 0; t < kBatch; ++t) gv[t] = next[t];
      if (k0 + kBatch < n) {
#pragma unroll
        for (int t = 0; t < kBatch; ++t) {
          const int k = k0 + kBatch + t;
          const int p = s_pt[w][min(k, n - 1)].x;
          next[t] = R::load(g, static_cast<int64_t>(p) * C + c0, k < n ? nc : 0);
        }
      }
#pragma unroll
      for (int t = 0; t < kBatch; ++t) {
        if (k0 + t >= n) break;                     // the same in every lane
        const int4 pt = s_pt[w][k0 + t];
        const float2 xw = s_xw[w][k0 + t];
        if (pt.y != cur) {
          const int at = a + k0 + t;
          if (cur >= 0) {                           // a run ends; it is not the last
            if (first_run && cut_a)
              store_piece<kPair>(pieces + static_cast<int64_t>(2 * j) * 4 * C, C, c0, nc, acc);
            else
              store_corners<kPair>(dmap, planes, plane, cur, W, C, c0, nc, acc);
            if (cbase == 0 && lane == 0) end[cur] = at;
            first_run = false;
          }
          if (cbase == 0 && lane == 0 && !(first_run && cut_a)) first[pt.y] = at;
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[q] = make_float2(0.0f, 0.0f);
          cur = pt.y;
        }
        const float2 gw = R::wide(gv[t]);
        const float ywa = __int_as_float(pt.z), ywb = __int_as_float(pt.w);
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const float x = dx ? xw.y : xw.x;
          const float2 tv = rnd2<T>(__fmul_rn(x, gw.x), __fmul_rn(x, gw.y));
          acc[dx].x = __fadd_rn(acc[dx].x, __fmul_rn(ywa, tv.x));
          acc[dx].y = __fadd_rn(acc[dx].y, __fmul_rn(ywa, tv.y));
          acc[2 + dx].x = __fadd_rn(acc[2 + dx].x, __fmul_rn(ywb, tv.x));
          acc[2 + dx].y = __fadd_rn(acc[2 + dx].y, __fmul_rn(ywb, tv.y));
        }
      }
    }
    // the last run
    if ((first_run && cut_a) || cut_b)
      store_piece<kPair>(pieces + static_cast<int64_t>(2 * j + (first_run ? 0 : 1)) * 4 * C,
                         C, c0, nc, acc);
    else
      store_corners<kPair>(dmap, planes, plane, cur, W, C, c0, nc, acc);
    if (cbase == 0 && lane == 0 && !cut_b) end[cur] = a + n;
  }
}

// pass 4: a warp whose segment ends inside a run that starts in it (a run
// cut by segment edges is the last run of the segment it starts in) sums
// that run's pieces in segment order, kPieceBatch pieces loaded at a time
// (in its first segment the run is the last run, slot 1, unless it starts
// there), and stores its four corner sums in the planes as a whole run's.
template <bool kPair>
__global__ void __launch_bounds__(kThreads) pieces_kernel(
    const int* __restrict__ keys, const int* __restrict__ first, const int* __restrict__ end,
    float* __restrict__ dmap, float* __restrict__ planes, const float* __restrict__ pieces,
    int64_t plane, int total, int W, int C) {
  follow();
  const int lane = threadIdx.x & 31;
  const int a = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kSegment;
  if (a >= total) return;
  const int b = min(a + kSegment, total);
  if (b == total || keys[b] != keys[b - 1]) return;      // no run goes on after b
  const int key = keys[b - 1], f = first[key];
  if (f < a) return;                                     // the segment it starts in sums it
  const int sa = f / kSegment, sb = (end[key] - 1) / kSegment;
  for (int cbase = 0; cbase < C; cbase += 64) {
    const int c0 = cbase + 2 * lane;
    const int nc = max(0, min(2, C - c0));
    float2 acc[4] = {};
    for (int s0 = sa; s0 <= sb; s0 += kPieceBatch) {
      float2 v[kPieceBatch][4];
#pragma unroll
      for (int k = 0; k < kPieceBatch; ++k) {
        const int s = s0 + k;
        const int slot = 2 * s + (s == sa && f > s * kSegment);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          v[k][q] = s <= sb
                        ? load2<kPair>(pieces + (static_cast<int64_t>(slot) * 4 + q) * C + c0, nc)
                        : make_float2(0.0f, 0.0f);
      }
#pragma unroll
      for (int k = 0; k < kPieceBatch; ++k) {
        if (s0 + k > sb) break;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[q].x = __fadd_rn(acc[q].x, v[k][q].x);
          acc[q].y = __fadd_rn(acc[q].y, v[k][q].y);
        }
      }
    }
    store_corners<kPair>(dmap, planes, plane, key, W, C, c0, nc, acc);
  }
}

// pass 5: a warp writes 32 texels of dmap. A texel no point reaches (none
// of its cells holds a run) is zero; each other one, kCombineBatch at a
// time, is the sum in corner order of its cells' corner sums, read from
// their planes (the cell (y - dy, x - dx) holds texel (y, x) as corner
// q = dy * 2 + dx; corner 0's plane is dmap itself, read and rewritten
// here by the texel's own lane group only).
template <bool kPair>
__global__ void __launch_bounds__(kThreads) combine_kernel(
    const int* __restrict__ first, float* dmap, const float* planes, int64_t plane,
    int cells, int H, int W, int C) {
  follow();
  const int lane = threadIdx.x & 31;
  const int t0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * 32;
  if (t0 >= cells) return;
  const int n = min(32, cells - t0);
  unsigned held = 0;                                 // bit q: the texel's cell q holds a run
  if (lane < n) {
    const int t = t0 + lane, x = t % W, y = (t / W) % H;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int dy = q >> 1, dx = q & 1;
      if (y - dy >= 0 && y - dy <= H - 2 && x - dx >= 0 && x - dx <= W - 2 &&
          first[t - dy * W - dx] >= 0)
        held |= 1u << q;
    }
  }
  unsigned todo = __ballot_sync(kFull, held != 0);
  if (!todo) {                                        // zeros, 16 bytes a lane a step
    float4* rows = reinterpret_cast<float4*>(dmap + static_cast<int64_t>(t0) * C);
    for (int k = lane; k < n * C / 4; k += 32) rows[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int k = n * C / 4 * 4 + lane; k < n * C; k += 32)
      dmap[static_cast<int64_t>(t0) * C + k] = 0.0f;
    return;
  }
  for (int k = 0; k < n; ++k) {                       // zeros, a row a step
    if (!(todo >> k & 1)) {
      float* row = dmap + static_cast<int64_t>(t0 + k) * C;
      for (int c = lane; c < C; c += 32) row[c] = 0.0f;
    }
  }
  while (todo) {
    int tex[kCombineBatch];
    unsigned mask[kCombineBatch];
#pragma unroll
    for (int k = 0; k < kCombineBatch; ++k) {
      const int src = todo ? __ffs(todo) - 1 : 0;
      tex[k] = todo ? t0 + src : -1;
      mask[k] = __shfl_sync(kFull, held, src) & (todo ? 0xfu : 0u);
      todo &= todo - 1;
    }
    for (int cbase = 0; cbase < C; cbase += 64) {
      const int c0 = cbase + 2 * lane;
      const int nc = max(0, min(2, C - c0));
      float2 v[kCombineBatch][4];
#pragma unroll
      for (int k = 0; k < kCombineBatch; ++k)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          v[k][q] = mask[k] >> q & 1
                        ? load2<kPair>((q ? planes + (q - 1) * plane : dmap) +
                                           static_cast<int64_t>(tex[k]) * C + c0, nc)
                        : make_float2(0.0f, 0.0f);
#pragma unroll
      for (int k = 0; k < kCombineBatch; ++k) {
        if (tex[k] < 0) break;
        float2 sum = make_float2(0.0f, 0.0f);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (mask[k] >> q & 1) {
            sum.x = __fadd_rn(sum.x, v[k][q].x);
            sum.y = __fadd_rn(sum.y, v[k][q].y);
          }
        }
        store2<kPair>(dmap + static_cast<int64_t>(tex[k]) * C + c0, nc, sum);
      }
    }
  }
}

// a launch of `kernel` on `s` as a programmatic dependent of the work before
// it (see follow())
template <typename... Params, typename... Args>
cudaError_t launch_after(void (*kernel)(Params...), int blocks, cudaStream_t s,
                         Args... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

int grid_for(int64_t threads, int per_block) {
  return static_cast<int>((threads + per_block - 1) / per_block);
}

// Where each part of the scratch buffer lies (bytes from its start). The
// wrapper mirrors this as onehot_dmap.scratch_bytes.
struct Layout {
  int64_t keys_a, vals_a, keys_b, vals_b;   // the sort's two (key, index) buffers
  int64_t first, end;                       // each cell's run
  int64_t zeroed, zeroed_bytes;             // the histograms and per-tile counts
  int64_t hist, counts;
  int64_t planes, pieces, bytes;            // corners 1-3 of whole runs; cut runs' pieces
  int total, cells, tiles, segments, passes, bits;
};

Layout layout_of(int64_t V, int64_t N, int64_t H, int64_t W, int64_t C) {
  Layout l;
  const int64_t total = V * N, cells = V * H * W;
  l.total = static_cast<int>(total);
  l.cells = static_cast<int>(cells);
  l.tiles = static_cast<int>((total + kTile - 1) / kTile);
  l.segments = static_cast<int>((total + kSegment - 1) / kSegment);
  int key_bits = 1;
  while ((int64_t{1} << key_bits) < cells) ++key_bits;
  l.passes = (key_bits + kRadixBits - 1) / kRadixBits;
  l.bits = (key_bits + l.passes - 1) / l.passes;
  int64_t at = 0;
  l.keys_a = at, at += 4 * total;
  l.vals_a = at, at += 4 * total;
  l.keys_b = at, at += 4 * total;
  l.vals_b = at, at += 4 * total;
  l.first = at, at += 4 * cells;
  l.end = at, at += 4 * cells;
  l.zeroed = at;
  l.hist = at, at += 4 * kMaxPasses * kBins;
  l.counts = at, at += 4 * int64_t{l.passes} * kBins * l.tiles;
  l.zeroed_bytes = at - l.zeroed;
  at = (at + 15) / 16 * 16;
  l.planes = at, at += 4 * 3 * cells * C;
  l.pieces = at, at += 4 * (2 * int64_t{l.segments}) * 4 * C;
  l.bytes = at;
  return l;
}

template <typename T, typename G>
int launch(const float* xy, const G* g, float* dmap, char* scratch, int V, int N, int H,
           int W, int C, cudaStream_t s) {
  const Layout l = layout_of(V, N, H, W, C);
  const int total = l.total;
  auto ints = [&](int64_t at) { return reinterpret_cast<int*>(scratch + at); };
  if (total == 0)
    return static_cast<int>(cudaMemsetAsync(
        dmap, 0, static_cast<size_t>(l.cells) * C * sizeof(float), s));
  cudaError_t err =
      cudaMemsetAsync(scratch + l.zeroed, 0, static_cast<size_t>(l.zeroed_bytes), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int* counts = ints(l.counts);
  const int64_t table = int64_t{kBins} * l.tiles;
  keys_kernel<<<l.tiles, kThreads, 0, s>>>(xy, ints(l.keys_a), ints(l.hist), counts,
                                           ints(l.first), total, l.cells, N, H, W, l.passes,
                                           l.bits);
  const int* keys_in = ints(l.keys_a);
  const int* vals_in = nullptr;
  for (int pass = 0; pass < l.passes && err == cudaSuccess; ++pass) {
    int* keys_out = ints(pass % 2 ? l.keys_a : l.keys_b);
    int* vals_out = ints(pass % 2 ? l.vals_a : l.vals_b);
    err = launch_after(scan_kernel, 1 << l.bits, s, counts + pass * table,
                       ints(l.hist) + pass * kBins, l.tiles);
    if (err == cudaSuccess)
      err = launch_after(sort_pass_kernel, l.tiles, s, keys_in, vals_in, keys_out, vals_out,
                         counts + pass * table,
                         pass + 1 < l.passes ? counts + (pass + 1) * table : nullptr, l.tiles,
                         total, pass * l.bits, l.bits, (pass + 1) * l.bits);
    keys_in = keys_out;
    vals_in = vals_out;
  }
  const bool pair = C % 2 == 0 && reinterpret_cast<uintptr_t>(g) % (2 * sizeof(G)) == 0;
  float* planes = reinterpret_cast<float*>(scratch + l.planes);
  float* pieces = reinterpret_cast<float*>(scratch + l.pieces);
  const int64_t plane = static_cast<int64_t>(l.cells) * C;
  const int blocks = grid_for(int64_t{l.segments} * 32, kThreads);
  const int texel_blocks = grid_for(l.cells, kThreads);
  if (err == cudaSuccess)
    err = launch_after(pair ? accumulate_kernel<T, G, true> : accumulate_kernel<T, G, false>,
                       blocks, s, keys_in, vals_in, ints(l.first), ints(l.end), xy, g, dmap,
                       planes, pieces, plane, total, N, H, W, C);
  if (err == cudaSuccess)
    err = launch_after(pair ? pieces_kernel<true> : pieces_kernel<false>, blocks, s, keys_in,
                       ints(l.first), ints(l.end), dmap, planes, pieces, plane, total, W, C);
  if (err == cudaSuccess)
    err = launch_after(pair ? combine_kernel<true> : combine_kernel<false>, texel_blocks, s,
                       ints(l.first), dmap, planes, plane, l.cells, H, W, C);
  if (err != cudaSuccess) return static_cast<int>(err);
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

// Scratch bytes the kernel needs (layout_of; the wrapper mirrors this as
// onehot_dmap.scratch_bytes): the sort's keys and indices (16 bytes a
// point), each cell's run (8 bytes a texel), the zeroed histograms and
// per-tile digit counts, three corner planes of dmap's size and
// two pieces of (4, C) floats a segment.
extern "C" int64_t kpn_onehot_dmap_scratch_bytes(int V, int N, int H, int W, int C) {
  return layout_of(V, N, H, W, C).bytes;
}

// xy: (V, N, 2) f32 contiguous; g: (V, N, C) contiguous, f32 (g_dtype 0)
// or bf16 (1); dmap: (V, H, W, C) f32 contiguous, 16-byte aligned, written
// whole; scratch: at least kpn_onehot_dmap_scratch_bytes(V, N, H, W,
// C) bytes, 16-byte aligned. dtype 0 = f32 map, 1 = bf16 map (the rounding
// of the terms). V * N must be below 2^30 and V * H * W fit an int.
// Returns the first CUDA error of the memsets and launches (0 on
// success).
extern "C" int kpn_onehot_dmap(const float* xy, const void* g, float* dmap, void* scratch,
                               int64_t scratch_size, int V, int N, int H, int W, int C,
                               int dtype, int g_dtype, void* stream) {
  const int64_t total = static_cast<int64_t>(V) * N;
  const int64_t cells = static_cast<int64_t>(V) * H * W;
  if (V < 0 || N < 0 || H < 2 || W < 2 || C < 1 || total >= (int64_t{1} << 30) ||
      cells > INT32_MAX ||
      scratch_size < kpn_onehot_dmap_scratch_bytes(V, N, H, W, C) ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(dmap) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(xy) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* buf = static_cast<char*>(scratch);
  if (dtype == 0) return launch_map<float>(xy, g, g_dtype, dmap, buf, V, N, H, W, C, s);
  if (dtype == 1)
    return launch_map<__nv_bfloat16>(xy, g, g_dtype, dmap, buf, V, N, H, W, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
