// lp_reuse: replay of a pinned SpGEMM plan through a linear-probing hash
// table, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/spgemm_lp.py (lp_reuse_arrays,
// body _reuse_kernel and _lp_probe). Same contract as segsum_reuse.cu:
//   out[seg_ids[t]] += float(A[a_slot[t]]) * float(B[b_slot[t]])
// into a zeroed f32 output of nnz_cap slots, the sentinel nnz_cap dropped.
//
// What bounds it: bytes, as segsum_reuse (12 B of plan and two random value
// reads per product, 4 * nnz_cap bytes out), plus the table's shared-memory
// traffic, which stays on the SM.
//
// Design: the paper's LP accumulator (KKLP) on one tile of the product
// stream. One block of 128 threads takes 128 products; shared memory holds
// int ids[256] (-1 = empty) and float vals[256]. A product's key is its
// segment minus the tile's base, the smallest live segment of the tile (its
// first live product's, since seg_ids are sorted); the hash is key & 255 and
// the probe is linear: atomicCAS(&ids[p], -1, key) until the slot holds the
// key, then atomicAdd(&vals[p], product). 128 products give at most 128
// keys, so the table is at most half full and every probe ends. After
// __syncthreads() each occupied slot does one atomicAdd into out[base + id].
//
// Because sorted segment ids step by at most 1, a tile's keys span fewer
// than 128 values: the hash is the identity and never collides (as in the
// TPU kernel). This replay measures the table's overhead, not its
// collisions; the probe loop stays because the numeric LP kernel reuses it.
// The atomics add in no fixed order: results agree with the plain version
// to f32 rounding, not bit for bit.
#include <climits>

#include "replay_common.cuh"

namespace {

constexpr int kTile = 128;   // products per block (the reference's LP_TILE)
constexpr int kTable = 256;  // table slots: 2x the tile, occupancy <= 50%

template <typename TA, typename TB>
__global__ void __launch_bounds__(kTile)
    lp_reuse_kernel(const replay::ReplayArgs r) {
  __shared__ int ids[kTable];
  __shared__ float vals[kTable];
  __shared__ int base;
  const int tid = threadIdx.x;
  for (int s = tid; s < kTable; s += kTile) {
    ids[s] = -1;
    vals[s] = 0.f;
  }
  if (tid == 0) base = INT_MAX;
  __syncthreads();

  const int64_t t = static_cast<int64_t>(blockIdx.x) * kTile + tid;
  int seg;
  const float v = replay::load_product<TA, TB>(r, t, &seg);
  if (seg >= 0) atomicMin(&base, seg);
  __syncthreads();

  if (seg >= 0) {
    const int key = seg - base;
    int p = key & (kTable - 1);
    while (true) {
      const int held = atomicCAS(&ids[p], -1, key);
      if (held == -1 || held == key) {
        atomicAdd(&vals[p], v);
        break;
      }
      p = (p + 1) & (kTable - 1);
    }
  }
  __syncthreads();

  for (int s = tid; s < kTable; s += kTile) {
    const int id = ids[s];
    if (id >= 0) atomicAdd(r.out + static_cast<int64_t>(base) + id, vals[s]);
  }
}

template <typename TA, typename TB>
struct LpReuse {
  static void launch(const replay::ReplayArgs& r) {
    const int64_t blocks = (r.fm + kTile - 1) / kTile;
    lp_reuse_kernel<TA, TB>
        <<<static_cast<unsigned>(blocks), kTile, 0, r.stream>>>(r);
  }
};

}  // namespace

REPLAY_C_API(lp_reuse, LpReuse)
