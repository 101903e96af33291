// segsum_reuse: replay of a pinned SpGEMM plan on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/segsum_reuse.py
// (segsum_reuse_arrays, body _kernel and _gather_row). It computes
//   out[seg_ids[t]] += float(A[a_slot[t]]) * float(B[b_slot[t]])
// over the plan's products, which come sorted by segment, into a zeroed f32
// output of nnz_cap slots; the sentinel segment nnz_cap is dropped.
//
// What bounds it: bytes. Each product reads 12 B of plan (three int32s,
// coalesced) and two values at random slots; the output is 4 * nnz_cap bytes.
// There are 2 flops per product, far below the card's f32 rate.
//
// Design: one thread per product, 256 per block. The gathers are real loads
// through the read-only cache (__ldg), where the TPU kernel multiplied by
// one-hot matrices. Each warp reduces its 32 products with a segmented
// inclusive scan (__shfl_up_sync; a run is a stretch of lanes with the same
// segment, found with one __ballot_sync), and the last lane of each run does
// one atomicAdd into the output. So a warp issues one atomic per segment it
// touches, not one per product, and a segment that spans many warps or
// blocks is summed by their atomics. Blocks need no order, so the TPU's
// sequential read-modify-write window, its 128-lane alignment and its padded
// output are gone. The atomics add in no fixed order: results agree with the
// plain version to f32 rounding, not bit for bit.
#include "replay_common.cuh"

namespace {

constexpr int kBlock = 256;
constexpr unsigned kFull = 0xffffffffu;

template <typename TA, typename TB>
__global__ void __launch_bounds__(kBlock)
    segsum_reuse_kernel(const replay::ReplayArgs r) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  const int lane = threadIdx.x & 31;
  int seg;
  float v = replay::load_product<TA, TB>(r, t, &seg);

  // run heads: a lane starts a run when its segment differs from the lane
  // before it; start = this lane's run head
  const int prev = __shfl_up_sync(kFull, seg, 1);
  const unsigned heads = __ballot_sync(kFull, lane == 0 || prev != seg);
  const int start = 31 - __clz(heads & (kFull >> (31 - lane)));
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float up = __shfl_up_sync(kFull, v, d);
    if (lane - d >= start) v += up;
  }
  const bool run_end = lane == 31 || ((heads >> (lane + 1)) & 1u);
  if (run_end && seg >= 0) atomicAdd(r.out + seg, v);
}

template <typename TA, typename TB>
struct SegsumReuse {
  static void launch(const replay::ReplayArgs& r) {
    const int64_t blocks = (r.fm + kBlock - 1) / kBlock;
    segsum_reuse_kernel<TA, TB>
        <<<static_cast<unsigned>(blocks), kBlock, 0, r.stream>>>(r);
  }
};

}  // namespace

REPLAY_C_API(segsum_reuse, SegsumReuse)
