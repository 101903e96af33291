// The tile machinery of the two plan-replay kernels (segsum_reuse.cu, K1, and
// lp_reuse.cu, K2); no other kernel includes it.
//
// Both replay a precomposed SpGEMM plan: for every product t,
//   out[seg_ids[t]] += float(A[a_slot[t]]) * float(B[b_slot[t]])
// with f32 products and f32 sums, into an f32 output of nnz_cap slots that
// arrives unwritten (torch.empty): every slot no live product reaches is
// written 0 here. A product whose segment lies outside [0, nnz_cap) (the
// plan's sentinel nnz_cap, or a negative id) is dropped. Slots are clamped
// into the value buffers, as the reference's gathers clamp.
//
// What the design relies on, as the reference kernels do: seg_ids are sorted
// (negative ids first, then live ids, then sentinels). Plans from spgemm also
// step by at most 1 between live ids; ids that skip are handled (the gaps are
// written 0) at the cost of one store per missing slot.
//
// A tile is a run of consecutive products, 256 threads a block, a fixed count
// a thread that each kernel sets (the template argument TileSize below is
// 256 x that count).
// Each thread loads its plan entries as 16-byte vectors where the array is
// aligned (tiles start where seg_ids is, so it always is in a whole tile;
// a_slot and b_slot are when their offset matches), element by element at a
// misaligned head, a ragged tail or a misaligned a_slot/b_slot; it issues
// every plan load, then every value gather, before it uses any of them. A
// tile whose first id is a sentinel holds only sentinels and stops there.
// A tile's live ids span [base, top]; each kernel writes that span once, in
// slot order (coalesced), the gaps inside it as 0, when the span fits its
// staging (segment sums in shared memory, K1; the table, K2): always for
// spgemm's plans. A wider span (ids that skip far) is written a segment at
// a time, its gaps zeroed apart.
//
// The write-out: each segment is stored once by the tile that holds its
// first product; a tile whose first segment began in an earlier tile writes
// its partial sum of it to carries[tile] instead, and zeroes the gap between
// the product before it and its first live id. Then replay_ends, a second
// small kernel on the same stream, adds the carries into their segments
// (stream order puts every store first) and zeroes [0, first live id) and
// (last live id, nnz_cap), whose bounds one block of the main kernel finds by
// a 128-ary search of seg_ids. No slot is written twice except by a carry.
// A segment over more than two tiles has a carry in each tile after its
// first, in consecutive tiles: the thread of the first of them sums the run
// in tile order and adds it once, so every sum comes in a fixed order and a
// launch repeats itself bit for bit on any plan.
// (A fill of the output first with atomics at tile edges, a single pass with
// decoupled look-back, and a persistent grid were measured slower or level:
// PERF.md.)
//
// The batched launch replays one plan over a stack of value rows at once:
// grid (tiles, batch), row b reading a + b * a_row_bytes and b + b *
// b_row_bytes (a row stride of 0 shares that operand across rows) and writing
// out[b] of a (batch, nnz_cap) output, with its own carries. The bounds
// depend on seg_ids alone: block (0, 0) finds them once for every row. Each
// row runs the single launch's tile code on its own TileArgs, so its adds
// come in the same order as a single launch on that row's values; each row
// reads the plan again. The single launch keeps its own kernels and
// arguments, untouched by the batched ones.
#pragma once

#include <climits>
#include <cstdint>

#include "replay_common.cuh"

namespace replay {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Bytes of workspace a launch over fm products in tiles of TileSize needs: the
// two bounds (8 bytes), then a carry of 8 bytes a tile, for each of batch rows.
// Tiles are shifted by seg_ids' misalignment, so one more.
template <int TileSize>
constexpr int64_t workspace_bytes(int64_t fm, int64_t batch = 1) {
  return 8 + 8 * (fm / TileSize + 2) * batch;
}

constexpr int kMaxBatch = 65535;  // rows of a batched launch: gridDim.y

struct TileArgs {
  const int32_t* a_slot;
  const int32_t* b_slot;
  const int32_t* seg_ids;
  const void* a;
  int64_t na;
  const void* b;
  int64_t nb;
  float* out;
  int64_t fm;
  int nnz_cap;
  int off;          // seg_ids' misalignment in elements: tile i starts at i*TileSize - off
  int64_t n_tiles;
  int* bounds;      // [first live id, last live id + 1], written by the search
  int2* carries;    // (segment or -1, f32 bits) a tile
  cudaStream_t stream;
};

// A batched launch: row 0's arguments, with a, b, out and carries at row 0,
// and the rows' strides.
struct BatchArgs {
  TileArgs r;
  int64_t a_row_bytes;  // bytes between rows of a (0: one row shared by all)
  int64_t b_row_bytes;  // likewise b
  int batch;
};

// Segment ids canonical: -1 below 0, nnz_cap at or past it (both dropped).
__device__ __forceinline__ int canon(int s, int nnz_cap) {
  return s < 0 ? -1 : (s >= nnz_cap ? nnz_cap : s);
}
__device__ __forceinline__ bool live(int s, int nnz_cap) { return s >= 0 && s < nnz_cap; }

// x[j] = p[t + j] for j < Items: int4 loads where the whole run lies in
// [0, n) and p + t is 16-byte aligned, else one element at a time, with lo
// for t + j < 0 and hi for t + j >= n.
template <int Items>
__device__ __forceinline__ void load_ids(const int32_t* p, int64_t t, int64_t n, int lo,
                                         int hi, int (&x)[Items]) {
  static_assert(Items % 4 == 0, "a thread's plan entries are whole int4s");
  if (t >= 0 && t + Items <= n && (reinterpret_cast<uintptr_t>(p + t) & 15) == 0) {
    const int4* q = reinterpret_cast<const int4*>(p + t);
#pragma unroll
    for (int k = 0; k < Items / 4; ++k) {
      const int4 v = __ldg(q + k);
      x[4 * k] = v.x;
      x[4 * k + 1] = v.y;
      x[4 * k + 2] = v.z;
      x[4 * k + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < Items; ++j) {
      const int64_t u = t + j;
      x[j] = u < 0 ? lo : (u < n ? __ldg(p + u) : hi);
    }
  }
}

// A thread's Items products from t: canonical segments and f32 products (0
// for a dropped product, which reads no value). Every plan load is issued,
// then every gather.
template <typename TA, typename TB, int Items>
__device__ __forceinline__ void load_items(const TileArgs& r, int64_t t, int (&seg)[Items],
                                           float (&val)[Items]) {
  int ia[Items], ib[Items];
  load_ids(r.seg_ids, t, r.fm, -1, r.nnz_cap, seg);
  load_ids(r.a_slot, t, r.fm, 0, 0, ia);
  load_ids(r.b_slot, t, r.fm, 0, 0, ib);
  float x[Items], y[Items];
#pragma unroll
  for (int j = 0; j < Items; ++j) {
    seg[j] = canon(seg[j], r.nnz_cap);
    const bool on = live(seg[j], r.nnz_cap);
    x[j] = on ? load_val(static_cast<const TA*>(r.a), clamp_slot(ia[j], r.na)) : 0.f;
    y[j] = on ? load_val(static_cast<const TB*>(r.b), clamp_slot(ib[j], r.nb)) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < Items; ++j) val[j] = x[j] * y[j];
}

// One tile: its products [begin, end), and the canonical ids of the product
// before it (prev, -1 for none), its first and its last. cont_prev: its first
// segment began in an earlier tile.
struct Tile {
  int64_t index, t0, begin, end;
  int prev, first, last;
  bool cont_prev;
};

// Tile index of TileSize products; only its first id is read. A tile whose
// first id is the sentinel holds only sentinels: the caller calls no_carry
// and stops there.
template <int TileSize>
__device__ __forceinline__ Tile tile_at(const TileArgs& r, int64_t index) {
  Tile tl;
  tl.index = index;
  tl.t0 = index * TileSize - r.off;
  tl.begin = tl.t0 < 0 ? 0 : tl.t0;
  tl.end = tl.t0 + TileSize < r.fm ? tl.t0 + TileSize : r.fm;
  tl.first = canon(__ldg(r.seg_ids + tl.begin), r.nnz_cap);
  return tl;
}

// Marks a tile with no carry (every tile that does not set one).
__device__ __forceinline__ void no_carry(const TileArgs& r, const Tile& tl) {
  if (threadIdx.x == 0) r.carries[tl.index] = make_int2(-1, 0);
}

// The rest of the tile's scalars, once its first id shows it holds live or
// negative products; marks the tile with no carry where it begins a segment.
__device__ __forceinline__ void tile_edges(const TileArgs& r, Tile& tl) {
  tl.prev = tl.begin > 0 ? canon(__ldg(r.seg_ids + tl.begin - 1), r.nnz_cap) : -1;
  tl.last = canon(__ldg(r.seg_ids + tl.end - 1), r.nnz_cap);
  tl.cont_prev = live(tl.first, r.nnz_cap) && tl.first == tl.prev;
  if (!tl.cont_prev) no_carry(r, tl);
}

// Slots (p, s) of the output, which no product reaches (p and s live ids of
// consecutive products).
__device__ __forceinline__ void zero_gap(float* out, int p, int s) {
  for (int g = p + 1; g < s; ++g) out[g] = 0.f;
}

// The gap before a tile's first live id s, after the product before it (p).
__device__ __forceinline__ void zero_gap_before(const TileArgs& r, int p, int s) {
  if (live(p, r.nnz_cap)) zero_gap(r.out, p, s);
}

// The gaps among a thread's products (prev: the id of the product before
// them); a cold path, taken only by ids that skip.
template <int Items>
__device__ __forceinline__ void zero_gaps(const TileArgs& r, const int (&seg)[Items], int prev) {
  bool any = false;
#pragma unroll
  for (int j = 0; j < Items; ++j) {
    const int p = j == 0 ? prev : seg[j - 1];
    any |= seg[j] > p + 1 && live(seg[j], r.nnz_cap) && live(p, r.nnz_cap);
  }
  if (!any) return;
  for (int j = 0; j < Items; ++j) {
    const int p = j == 0 ? prev : seg[j - 1];
    if (live(seg[j], r.nnz_cap) && live(p, r.nnz_cap)) zero_gap(r.out, p, seg[j]);
  }
}

// The tile's sum v of live segment s over its own products: a store, or the
// tile's carry where s began in an earlier tile.
__device__ __forceinline__ void write_segment(const TileArgs& r, const Tile& tl, int s,
                                              float v) {
  if (s == tl.first && tl.cont_prev) {
    r.carries[tl.index] = make_int2(s, __float_as_int(v));
  } else {
    r.out[s] = v;
  }
}

// One block: bounds = [first live id, last live id + 1] ([nnz_cap, nnz_cap]
// when no product is live), by two 128-ary searches of the sorted seg_ids at
// once (threads 0-127 for the first id >= 0, 128-255 for the first id >=
// nnz_cap).
__device__ void find_bounds(const TileArgs& r) {
  __shared__ int64_t found[2];
  const int half = threadIdx.x >> 7, lane = threadIdx.x & 127;
  const int target = half ? r.nnz_cap : 0;
  int64_t lo = 0, hi = r.fm;  // the first index whose id >= target is in [lo, hi]
  for (;;) {
    const bool active = lo < hi;
    if (!__syncthreads_or(active)) break;
    const int64_t step = (hi - lo + 127) / 128;
    const int64_t q = lo + lane * step;
    const bool below = active && q < hi && __ldg(r.seg_ids + q) < target;
    const int c0 = __syncthreads_count(below && half == 0);
    const int c1 = __syncthreads_count(below && half == 1);
    if (active) {
      const int c = half ? c1 : c0;  // probes 0 .. c-1 lie below target
      const int64_t nlo = c > 0 ? lo + (c - 1) * step + 1 : lo;
      const int64_t qc = lo + c * step;
      hi = qc < hi ? qc : hi;
      lo = nlo;
    }
  }
  if (lane == 0) found[half] = lo;
  __syncthreads();
  if (threadIdx.x == 0) {
    const int64_t i0 = found[0], i1 = found[1];
    if (i0 >= i1) {
      r.bounds[0] = r.bounds[1] = r.nnz_cap;
    } else {
      r.bounds[0] = __ldg(r.seg_ids + i0);
      r.bounds[1] = __ldg(r.seg_ids + i1 - 1) + 1;
    }
  }
}

// Tile t's carry, where it heads a run of carries into one segment: the run
// summed in tile order, added once. Only the tile after a segment's first
// tile heads its run (that first tile stores the segment and carries another
// one, or none), so each slot takes one add, after every store.
__device__ __forceinline__ void add_carries(const int2* carries, int64_t n_tiles, int64_t t,
                                            float* out) {
  const int2 c = carries[t];
  if (c.x < 0 || (t > 0 && carries[t - 1].x == c.x)) return;
  float sum = __int_as_float(c.y);
  for (int64_t u = t + 1; u < n_tiles && carries[u].x == c.x; ++u) {
    sum += __int_as_float(carries[u].y);
  }
  out[c.x] += sum;
}

// After the main kernel: add the carries and zero the slots before the first
// live id and past the last.
__global__ void __launch_bounds__(kThreads) replay_ends(const TileArgs r) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int64_t t = i0; t < r.n_tiles; t += stride) add_carries(r.carries, r.n_tiles, t, r.out);
  const int head_end = r.bounds[0], tail_begin = r.bounds[1];
  for (int64_t s = i0; s < head_end; s += stride) r.out[s] = 0.f;
  for (int64_t s = tail_begin + i0; s < r.nnz_cap; s += stride) r.out[s] = 0.f;
}

// The main kernel's block: Body::tile(r, its tile), one tile a block; block
// 0 then also runs the search.
template <typename Body>
__device__ __forceinline__ void run_tile(const TileArgs& r) {
  Body::tile(r, blockIdx.x);
  if (blockIdx.x == 0) {
    __syncthreads();
    find_bounds(r);
  }
}

// Places tiles of TileSize products (shifted by seg_ids' misalignment) and
// the workspace's parts in r, for batch rows; false when work is too small.
template <int TileSize>
inline bool place_tiles(TileArgs& r, void* work, int64_t work_bytes, int64_t batch = 1) {
  r.off = static_cast<int>((reinterpret_cast<uintptr_t>(r.seg_ids) & 15) / 4);
  r.n_tiles = (r.fm + r.off + TileSize - 1) / TileSize;
  char* w = static_cast<char*>(work);
  r.bounds = reinterpret_cast<int*>(w);
  r.carries = reinterpret_cast<int2*>(w + 8);
  return work != nullptr && work_bytes >= 8 + 8 * r.n_tiles * batch;
}

// The launch: the main kernel (smem bytes of dynamic shared memory), one
// block a tile, then replay_ends. Errors reach cudaGetLastError().
template <typename Kernel>
void launch_tiles(Kernel kernel, size_t smem, const TileArgs& r) {
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  kernel<<<static_cast<unsigned>(r.n_tiles), kThreads, smem, r.stream>>>(r);
  replay_ends<<<4 * sm_count(), kThreads, 0, r.stream>>>(r);
}

// ---- the batched launch -------------------------------------------------

// Row blockIdx.y's arguments: its operands, output and carries.
__device__ __forceinline__ TileArgs row_args(const BatchArgs& p) {
  const int64_t b = blockIdx.y;
  TileArgs row = p.r;
  row.a = static_cast<const char*>(p.r.a) + b * p.a_row_bytes;
  row.b = static_cast<const char*>(p.r.b) + b * p.b_row_bytes;
  row.out = p.r.out + b * p.r.nnz_cap;
  row.carries = p.r.carries + b * p.r.n_tiles;
  return row;
}

// replay_ends for row blockIdx.y.
__global__ void __launch_bounds__(kThreads) replay_ends_batched(const BatchArgs p) {
  const TileArgs& r = p.r;
  const int64_t row = blockIdx.y;
  float* out = r.out + row * r.nnz_cap;
  const int2* carries = r.carries + row * r.n_tiles;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int64_t t = i0; t < r.n_tiles; t += stride) add_carries(carries, r.n_tiles, t, out);
  const int head_end = r.bounds[0], tail_begin = r.bounds[1];
  for (int64_t s = i0; s < head_end; s += stride) out[s] = 0.f;
  for (int64_t s = tail_begin + i0; s < r.nnz_cap; s += stride) out[s] = 0.f;
}

// The batched kernel's block: Body::tile on its tile of its row; block (0, 0)
// then also runs the search, whose bounds every row shares.
template <typename Body>
__device__ __forceinline__ void run_tile_batched(const BatchArgs& p) {
  Body::tile(row_args(p), blockIdx.x);
  if (blockIdx.x == 0 && blockIdx.y == 0) {
    __syncthreads();
    find_bounds(p.r);
  }
}

// The batched launch: a row of tile blocks per row of values, then
// replay_ends_batched. Errors reach cudaGetLastError().
template <typename Kernel>
void launch_tiles_batched(Kernel kernel, size_t smem, const BatchArgs& p) {
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const unsigned rows = static_cast<unsigned>(p.batch);
  const unsigned ends = (4 * sm_count() + rows - 1) / rows;
  kernel<<<dim3(static_cast<unsigned>(p.r.n_tiles), rows), kThreads, smem, p.r.stream>>>(p);
  replay_ends_batched<<<dim3(ends, rows), kThreads, 0, p.r.stream>>>(p);
}

// Bytes of a value of dtype code c (0 for an unknown code, which dispatch
// refuses).
inline int64_t value_bytes(int c) { return c == kF32 ? 4 : (c == kF16 || c == kBF16 ? 2 : 0); }

}  // namespace replay

// The C interface of each replay library, with the kernel's name as prefix
// (KERNEL and BATCHED: the launchers of the single and the batched kernel;
// TILE: the kernel's products a tile):
//   int <name>_launch(a_slot, b_slot, seg_ids, a, a_code, na, b, b_code, nb,
//                     out, fm, nnz_cap, work, work_bytes, stream)
//       -> a CUDA error code (0: launched; cudaErrorInvalidValue for nnz_cap
//          outside [0, INT_MAX] or too small a workspace); out needs no
//          zeroing, work holds at least <name>_workspace_bytes(fm) bytes
//   int <name>_launch_batched(a_slot, b_slot, seg_ids, a, a_code, na,
//                             a_stride, b, b_code, nb, b_stride, out, fm,
//                             nnz_cap, batch, work, work_bytes, stream)
//       -> the same, over batch rows (1 to 65,535, else
//          cudaErrorInvalidValue): row i of a starts a_stride values after
//          row i - 1 (0: one row shared by all), likewise b; out is
//          (batch, nnz_cap) f32, work holds at least
//          <name>_workspace_bytes_batched(fm, batch) bytes
//   int64_t <name>_workspace_bytes(int64_t fm)
//   int64_t <name>_workspace_bytes_batched(int64_t fm, int64_t batch)
//   int64_t <name>_tile_products()
//   const char* <name>_error_string(int code)
#define REPLAY_C_API(NAME, KERNEL, BATCHED, TILE)                                      \
  extern "C" int NAME##_launch(const int32_t* a_slot, const int32_t* b_slot,           \
                               const int32_t* seg_ids, const void* a, int a_code,      \
                               int64_t na, const void* b, int b_code, int64_t nb,      \
                               float* out, int64_t fm, int64_t nnz_cap, void* work,    \
                               int64_t work_bytes, void* stream) {                     \
    if (nnz_cap < 0 || nnz_cap > INT_MAX) {                                            \
      return static_cast<int>(cudaErrorInvalidValue);                                  \
    }                                                                                  \
    replay::TileArgs r{};                                                              \
    r.a_slot = a_slot;                                                                 \
    r.b_slot = b_slot;                                                                 \
    r.seg_ids = seg_ids;                                                               \
    r.a = a;                                                                           \
    r.na = na;                                                                         \
    r.b = b;                                                                           \
    r.nb = nb;                                                                         \
    r.out = out;                                                                       \
    r.fm = fm;                                                                         \
    r.nnz_cap = static_cast<int>(nnz_cap);                                             \
    r.stream = static_cast<cudaStream_t>(stream);                                      \
    if (!replay::place_tiles<TILE>(r, work, work_bytes)) {                             \
      return static_cast<int>(cudaErrorInvalidValue);                                  \
    }                                                                                  \
    return replay::dispatch<KERNEL>(a_code, b_code, r);                                \
  }                                                                                    \
  extern "C" int NAME##_launch_batched(                                                 \
      const int32_t* a_slot, const int32_t* b_slot, const int32_t* seg_ids,            \
      const void* a, int a_code, int64_t na, int64_t a_stride, const void* b,          \
      int b_code, int64_t nb, int64_t b_stride, float* out, int64_t fm,                \
      int64_t nnz_cap, int64_t batch, void* work, int64_t work_bytes, void* stream) {  \
    if (nnz_cap < 0 || nnz_cap > INT_MAX || batch < 1 || batch > replay::kMaxBatch) {  \
      return static_cast<int>(cudaErrorInvalidValue);                                  \
    }                                                                                  \
    replay::BatchArgs p{};                                                             \
    p.r.a_slot = a_slot;                                                               \
    p.r.b_slot = b_slot;                                                               \
    p.r.seg_ids = seg_ids;                                                             \
    p.r.a = a;                                                                         \
    p.r.na = na;                                                                       \
    p.r.b = b;                                                                         \
    p.r.nb = nb;                                                                       \
    p.r.out = out;                                                                     \
    p.r.fm = fm;                                                                       \
    p.r.nnz_cap = static_cast<int>(nnz_cap);                                           \
    p.r.stream = static_cast<cudaStream_t>(stream);                                    \
    p.a_row_bytes = a_stride * replay::value_bytes(a_code);                            \
    p.b_row_bytes = b_stride * replay::value_bytes(b_code);                            \
    p.batch = static_cast<int>(batch);                                                 \
    if (!replay::place_tiles<TILE>(p.r, work, work_bytes, batch)) {                    \
      return static_cast<int>(cudaErrorInvalidValue);                                  \
    }                                                                                  \
    return replay::dispatch<BATCHED>(a_code, b_code, p);                               \
  }                                                                                    \
  extern "C" int64_t NAME##_workspace_bytes(int64_t fm) {                              \
    return replay::workspace_bytes<TILE>(fm);                                          \
  }                                                                                    \
  extern "C" int64_t NAME##_workspace_bytes_batched(int64_t fm, int64_t batch) {       \
    return replay::workspace_bytes<TILE>(fm, batch);                                   \
  }                                                                                    \
  extern "C" int64_t NAME##_tile_products() { return TILE; }                           \
  extern "C" const char* NAME##_error_string(int code) {                               \
    return cudaGetErrorString(static_cast<cudaError_t>(code));                         \
  }
