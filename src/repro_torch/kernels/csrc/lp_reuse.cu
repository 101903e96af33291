// lp_reuse: replay of a pinned SpGEMM plan through a linear-probing hash
// table, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/spgemm_lp.py (lp_reuse_arrays,
// body _reuse_kernel and _lp_probe). Same contract as segsum_reuse.cu:
//   out[seg_ids[t]] += float(A[a_slot[t]]) * float(B[b_slot[t]])
// into an f32 output of nnz_cap slots that it writes whole, ids outside
// [0, nnz_cap) dropped.
//
// What bounds it: bytes, as segsum_reuse (12 B of plan and two random value
// reads per product, 4 * nnz_cap bytes out), plus the table's shared-memory
// traffic, which stays on the SM.
//
// Design: the paper's LP accumulator (KKLP) on one tile of the product
// stream (the tile, its loads and the write-out: replay_tile.cuh). A block
// takes 256 x 4 consecutive products; shared memory holds a table of
// 2 x kTile slots (at most 50% full), 8 bytes a slot: int keys[] (-1 =
// empty) beside float vals[]; a tile whose ids are all live empties only
// the home slots of its key span, the only slots it probes. A product's key is its segment minus the
// tile's base, its smallest live id (seg_ids are sorted). A thread first
// sums its consecutive products of one key in registers, then inserts each
// sum: home slot key mod table, linear probe; a claim reads the slot and
// calls atomicCAS only on an empty one. A key that only this thread holds
// stores its sum; the thread's first and last keys, which a neighbour may
// hold too, add theirs with atomicAdd. Keys of a tile from spgemm's plans
// are consecutive, so home slots never collide there; ids that skip (the
// tests' synthetic plans) do probe. The flush walks the tile's key span and
// looks each key up (an absent key, a gap, reads 0), so its stores are
// coalesced and write every slot of the span once; a span wider than the
// table (ids that skip far) walks the occupied slots instead and zeroes the
// gaps apart. The shared adds come in no fixed order: results agree with
// the plain version to f32 rounding, not bit for bit.
#include <climits>

#include "replay_tile.cuh"

namespace {

using replay::kFull;
using replay::kThreads;
using replay::kWarps;

// four products a thread (tiles of 1,024, tables of 2,048 slots): measured
// faster than eight at both of the main path's shapes (PERF.md)
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr int kTable = 2 * kTile;  // table slots: occupancy <= 50%
constexpr size_t kSmem = 2 * sizeof(int) * kTable;
static_assert((kTable & (kTable - 1)) == 0, "the home slot is key & (kTable - 1)");

// Puts v under key: home slot key mod table, then a linear probe; a claim
// reads the slot and calls atomicCAS only on an empty one. A key only this
// thread inserts (exclusive) stores its sum; a key a neighbour may insert
// too adds it atomically.
__device__ __forceinline__ void insert(int* keys, float* vals, int key, float v,
                                       bool exclusive) {
  for (int p = key & (kTable - 1);; p = (p + 1) & (kTable - 1)) {
    int held = reinterpret_cast<volatile int*>(keys)[p];
    if (held == -1) {
      held = atomicCAS(keys + p, -1, key);
      if (held == -1) held = key;
    }
    if (held == key) {
      if (exclusive) {
        vals[p] = v;
      } else {
        atomicAdd(vals + p, v);
      }
      return;
    }
  }
}

// The sum under key, or 0 where the key is absent (the probe ends at an
// empty slot: the table is never full).
__device__ __forceinline__ float lookup(const int* keys, const float* vals, int key) {
  for (int p = key & (kTable - 1);; p = (p + 1) & (kTable - 1)) {
    const int held = keys[p];
    if (held == key) return vals[p];
    if (held == -1) return 0.f;
  }
}

template <typename TA, typename TB>
struct LpTile {
  static __device__ __forceinline__ void tile(const replay::TileArgs& r, int64_t index) {
    extern __shared__ int4 smem[];
    int* keys = reinterpret_cast<int*>(smem);
    float* vals = reinterpret_cast<float*>(keys + kTable);
    __shared__ int w_first[kWarps], w_last[kWarps], w_lo[kWarps], w_hi[kWarps];
    replay::Tile tl = replay::tile_at<kTile>(r, index);
    if (tl.first == r.nnz_cap) {  // sentinels only
      replay::no_carry(r, tl);
      return;
    }
    replay::tile_edges(r, tl);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    // a tile whose ids are all live and span fewer than kTable keys probes
    // only the home slots of that span: empty those, else the whole table
    const bool dense = replay::live(tl.first, r.nnz_cap) && replay::live(tl.last, r.nnz_cap) &&
                       tl.last - tl.first < kTable;
    const int used = dense ? (tl.last - tl.first) / 4 + 1 : kTable / 4;
    for (int q = tid; q < used; q += kThreads) {
      smem[q] = make_int4(-1, -1, -1, -1);
      smem[kTable / 4 + q] = make_int4(0, 0, 0, 0);
    }
    int seg[kItems];
    float val[kItems];
    replay::load_items<TA, TB>(r, tl.t0 + static_cast<int64_t>(tid) * kItems, seg, val);
    const int f = seg[0], l = seg[kItems - 1];
    int lo = INT_MAX, hi = -1;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (replay::live(seg[j], r.nnz_cap)) {
        lo = min(lo, seg[j]);
        hi = max(hi, seg[j]);
      }
    }
    lo = __reduce_min_sync(kFull, lo);
    hi = __reduce_max_sync(kFull, hi);
    int prev_l = __shfl_up_sync(kFull, l, 1);
    int next_f = __shfl_down_sync(kFull, f, 1);
    if (lane == 31) w_last[warp] = l;
    if (lane == 0) {
      w_first[warp] = f;
      w_lo[warp] = lo;
      w_hi[warp] = hi;
    }
    __syncthreads();  // the table is empty, w_* written
    if (lane == 0) prev_l = warp > 0 ? w_last[warp - 1] : tl.prev;
    if (lane == 31) next_f = warp + 1 < kWarps ? w_first[warp + 1] : r.nnz_cap;
    // the tile's live ids span [base, top]: a key is id - base
    int base = INT_MAX, top = -1;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      base = min(base, w_lo[v]);
      top = max(top, w_hi[v]);
    }
    // the thread's first and last keys may also be a neighbour's in the tile
    const bool shares_first = tid > 0 && prev_l == f;
    const bool shares_last = tid < kThreads - 1 && next_f == l;

    // one insert per run of equal keys among the thread's products
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int s = seg[j];
      acc += val[j];
      if (j == kItems - 1 || seg[j + 1] != s) {
        if (replay::live(s, r.nnz_cap)) {
          const bool shared = (s == f && shares_first) || (j == kItems - 1 && shares_last);
          insert(keys, vals, s - base, acc, !shared);
        }
        acc = 0.f;
      }
    }
    __syncthreads();  // the table is whole

    if (top < base || top - base < kTable) {  // the flush walks the key span
      if (tid == 0 && top >= base) replay::zero_gap_before(r, tl.prev, base);
      for (int key = tid; key <= top - base; key += kThreads) {
        replay::write_segment(r, tl, base + key, lookup(keys, vals, key));
      }
    } else {  // ids that skip far: walk the occupied slots, zero the gaps apart
      replay::zero_gaps(r, seg, prev_l);
      for (int q = tid; q < kTable; q += kThreads) {
        const int key = keys[q];
        if (key >= 0) replay::write_segment(r, tl, base + key, vals[q]);
      }
    }
  }
};

template <typename TA, typename TB>
__global__ void __launch_bounds__(kThreads) lp_reuse_kernel(const replay::TileArgs r) {
  replay::run_tile<LpTile<TA, TB>>(r);
}

template <typename TA, typename TB>
struct LpReuse {
  static void launch(const replay::TileArgs& r) {
    replay::launch_tiles(lp_reuse_kernel<TA, TB>, kSmem, r);
  }
};

// a stack of value rows over one plan: grid (tiles, rows)
template <typename TA, typename TB>
__global__ void __launch_bounds__(kThreads)
    lp_reuse_batched_kernel(const replay::BatchArgs p) {
  replay::run_tile_batched<LpTile<TA, TB>>(p);
}

template <typename TA, typename TB>
struct LpReuseBatched {
  static void launch(const replay::BatchArgs& p) {
    replay::launch_tiles_batched(lp_reuse_batched_kernel<TA, TB>, kSmem, p);
  }
};

}  // namespace

REPLAY_C_API(lp_reuse, LpReuse, LpReuseBatched, kTile)
