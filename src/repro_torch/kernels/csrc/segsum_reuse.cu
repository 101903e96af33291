// segsum_reuse: replay of a pinned SpGEMM plan on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/segsum_reuse.py
// (segsum_reuse_arrays, body _kernel and _gather_row). It computes
//   out[seg_ids[t]] += float(A[a_slot[t]]) * float(B[b_slot[t]])
// over the plan's products, which come sorted by segment, into an f32 output
// of nnz_cap slots that it writes whole (slots no product reaches get 0); ids
// outside [0, nnz_cap), the sentinel nnz_cap among them, are dropped.
//
// What bounds it: bytes. Each product reads 12 B of plan and two values at
// random slots; the output is 4 * nnz_cap bytes. There are 2 flops per
// product, far below the card's f32 rate.
//
// Design (the tile, its loads and the write-out: replay_tile.cuh): a block
// takes a tile of 256 x kItems consecutive products, a thread kItems of
// them, loaded as int4 vectors. A thread sums its products by segment in
// registers; a segmented scan of the threads' last-segment sums (keyed by
// that segment: __shfl_up_sync across the warp, then the warps' totals
// through shared memory) gives each thread the sum of its first segment over
// the threads before it in the tile. The thread that holds the last product
// of a segment in the tile then has the tile's whole sum of it and puts it
// in shared memory at segment - base; after a barrier the block writes the
// tile's span of segments once, in slot order (coalesced: per-thread stores
// straight to the output were the largest cost at RMAT-16 A*A), each a
// store, or a carry for the one segment begun in an earlier tile. No
// atomic touches the output; replay_ends adds the carries in tile order, so
// a launch repeats itself bit for bit. The sums are taken in another order
// than the plain version's, so results agree with it to f32 rounding, not
// bit for bit.
#include <climits>

#include "replay_tile.cuh"

namespace {

using replay::kFull;
using replay::kThreads;

constexpr int kItems = 8;  // consecutive products a thread
constexpr int kTile = kThreads * kItems;

template <typename TA, typename TB>
struct SegsumTile {
  static __device__ __forceinline__ void tile(const replay::TileArgs& r, int64_t index) {
    using replay::kWarps;
    __shared__ float4 s_out4[kTile / 4];  // the tile's sums, by segment - base
    __shared__ int w_first[kWarps], w_last[kWarps], w_lo[kWarps], w_hi[kWarps];
    __shared__ float w_sum[kWarps];
    __shared__ bool w_reach[kWarps];
    float* s_out = reinterpret_cast<float*>(s_out4);
    replay::Tile tl = replay::tile_at<kTile>(r, index);
    if (tl.first == r.nnz_cap) {  // sentinels only
      replay::no_carry(r, tl);
      return;
    }
    replay::tile_edges(r, tl);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
    for (int k = 0; k < kItems / 4; ++k) s_out4[tid * (kItems / 4) + k] = make_float4(0, 0, 0, 0);
    int seg[kItems];
    float val[kItems];
    replay::load_items<TA, TB>(r, tl.t0 + static_cast<int64_t>(tid) * kItems, seg, val);

    // the thread's first and last segment, its sum of the last, the span of
    // its live ids
    const int f = seg[0], l = seg[kItems - 1];
    float tail = 0.f;
    int lo = INT_MAX, hi = -1;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      tail += seg[j] == l ? val[j] : 0.f;
      if (replay::live(seg[j], r.nnz_cap)) {
        lo = min(lo, seg[j]);
        hi = max(hi, seg[j]);
      }
    }

    // inclusive scan of the tails within the warp, keyed by l: a run of
    // lanes with one l begins at `start`
    const int l_up = __shfl_up_sync(kFull, l, 1);
    const unsigned heads = __ballot_sync(kFull, lane == 0 || l_up != l);
    const int start = 31 - __clz(heads & (kFull >> (31 - lane)));
    float inc = tail;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float up = __shfl_up_sync(kFull, inc, d);
      if (lane - d >= start) inc += up;
    }
    lo = __reduce_min_sync(kFull, lo);
    hi = __reduce_max_sync(kFull, hi);
    if (lane == 31) {
      w_last[warp] = l;
      w_sum[warp] = inc;
      w_reach[warp] = start == 0;
    }
    if (lane == 0) {
      w_first[warp] = f;
      w_lo[warp] = lo;
      w_hi[warp] = hi;
    }
    __syncthreads();

    // the tile's sum of segment w_last[warp - 1] up to the end of that warp
    float w_carry = 0.f;
    for (int v = warp - 1; v >= 0 && w_last[v] == w_last[warp - 1]; --v) {
      w_carry += w_sum[v];
      if (!w_reach[v]) break;
    }
    if (start == 0 && warp > 0 && l == w_last[warp - 1]) inc += w_carry;
    // the thread before: its last segment and the tile's sum of it so far
    int prev_l = l_up;
    float prev_inc = __shfl_up_sync(kFull, inc, 1);
    if (lane == 0) {
      prev_l = warp > 0 ? w_last[warp - 1] : tl.prev;
      prev_inc = w_carry;
    }
    // the thread after: its first segment (the tile's last thread ends its runs)
    int next_f = __shfl_down_sync(kFull, f, 1);
    if (lane == 31 && warp + 1 < kWarps) next_f = w_first[warp + 1];
    const bool tile_end = tid == kThreads - 1;
    // the tile's live ids span [base, top]; staged in shared memory when the
    // span fits (always for spgemm's plans, whose ids step by at most 1)
    int base = INT_MAX, top = -1;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      base = min(base, w_lo[v]);
      top = max(top, w_hi[v]);
    }
    const bool staged = top < base || top - base < kTile;

    // the tile's sum of each segment, at the thread that holds its last
    // product in the tile
    auto each_segment = [&](auto&& emit) {
      float acc = prev_l == f ? prev_inc : 0.f;
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int s = seg[j];
        acc += val[j];
        const bool ends = j == kItems - 1 ? (tile_end || next_f != s) : seg[j + 1] != s;
        if (ends) {
          if (replay::live(s, r.nnz_cap)) emit(s, acc);
          acc = 0.f;
        }
      }
    };
    if (staged) each_segment([&](int s, float v) { s_out[s - base] = v; });
    __syncthreads();
    if (staged) {  // coalesced, the gaps inside the span included
      if (tid == 0 && top >= base) replay::zero_gap_before(r, tl.prev, base);
      for (int o = tid; o <= top - base; o += kThreads) {
        replay::write_segment(r, tl, base + o, s_out[o]);
      }
    } else {
      replay::zero_gaps(r, seg, prev_l);
      each_segment([&](int s, float v) { replay::write_segment(r, tl, s, v); });
    }
  }
};

template <typename TA, typename TB>
__global__ void __launch_bounds__(kThreads) segsum_reuse_kernel(const replay::TileArgs r) {
  replay::run_tile<SegsumTile<TA, TB>>(r);
}

template <typename TA, typename TB>
struct SegsumReuse {
  static void launch(const replay::TileArgs& r) {
    replay::launch_tiles(segsum_reuse_kernel<TA, TB>, 0, r);
  }
};

// a stack of value rows over one plan: grid (tiles, rows)
template <typename TA, typename TB>
__global__ void __launch_bounds__(kThreads)
    segsum_reuse_batched_kernel(const replay::BatchArgs p) {
  replay::run_tile_batched<SegsumTile<TA, TB>>(p);
}

template <typename TA, typename TB>
struct SegsumReuseBatched {
  static void launch(const replay::BatchArgs& p) {
    replay::launch_tiles_batched(segsum_reuse_batched_kernel<TA, TB>, 0, p);
  }
};

}  // namespace

REPLAY_C_API(segsum_reuse, SegsumReuse, SegsumReuseBatched, kTile)
