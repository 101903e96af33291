// bsr_spgemm: the block-sparse (BSR) numeric phase of SpGEMM on Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/bsr_spgemm.py
// (bsr_spgemm_numeric, body _kernel). For every block s of C, with the plan
// of plan_bsr_numeric:
//   C[s] = sum over t < contrib_n[s] of float(A[contrib_a[s, t]]) @
//          float(B[contrib_b[s, t]])
// with f32 products and f32 sums, written in A's dtype. A padded slot
// (t >= contrib_n[s]) is skipped, never read, so a NaN in the block it points
// at cannot leak. Counts clamp into [0, t_max] and block ids into the block
// arrays, as the reference's gathers clamp.
//
// What bounds it: bytes. Each contribution reads one A and one B block
// (2 * bs^2 values, mostly from L2: a block of A or B serves several C
// blocks), each C block is written once; there are 2 * bs^3 flops per
// contribution, 16 flops per byte of f32 C at bs = 8.
//
// Design: the TPU kernel walks a (C block, contribution) grid in order and
// carries the sum in a VMEM tile. Here one warp owns one C block, so the sum
// lives in the warp's registers (bs^2 / 32 values a lane) and needs no
// atomics and no order between blocks; a block of 8 warps takes 8 C blocks.
// The loop over contributions takes the place of the sequential grid axis.
// Per contribution the warp copies the two blocks into its own shared-memory
// tiles with coalesced loads (the next pair is loaded into registers while
// the current one is multiplied), then each lane forms its outputs' dot
// products of length bs. Only __syncwarp is needed.
#include "replay_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

struct BsrArgs {
  const void* a;  // (nnzb_a, bs, bs)
  int64_t nnzb_a;
  const void* b;  // (nnzb_b, bs, bs)
  int64_t nnzb_b;
  const int32_t* contrib_a;  // (nnzb_c, t_max)
  const int32_t* contrib_b;  // (nnzb_c, t_max)
  const int32_t* contrib_n;  // (nnzb_c,)
  int64_t nnzb_c;
  int64_t t_max;
  void* out;  // (nnzb_c, bs, bs) in A's dtype
  int bs;
  cudaStream_t stream;
};

template <int BS, typename TA, typename TB>
__global__ void __launch_bounds__(kThreads) bsr_spgemm_kernel(const BsrArgs r) {
  constexpr int kElems = BS * BS;
  constexpr int kPerLane = kElems / 32;
  __shared__ float sa[kWarps][kElems];
  __shared__ float sb[kWarps][kElems];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (s >= r.nnzb_c) return;  // the whole warp; no block-wide barrier follows

  const TA* a = static_cast<const TA*>(r.a);
  const TB* b = static_cast<const TB*>(r.b);
  const int32_t* ca = r.contrib_a + s * r.t_max;
  const int32_t* cb = r.contrib_b + s * r.t_max;
  int64_t n = __ldg(r.contrib_n + s);
  n = n < 0 ? 0 : (n > r.t_max ? r.t_max : n);

  float acc[kPerLane];
  float ra[kPerLane], rb[kPerLane];
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) acc[q] = 0.f;
  if (n > 0) {
    const int64_t ea = replay::clamp_slot(__ldg(ca), r.nnzb_a) * kElems;
    const int64_t eb = replay::clamp_slot(__ldg(cb), r.nnzb_b) * kElems;
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      ra[q] = replay::load_val(a, ea + lane + 32 * q);
      rb[q] = replay::load_val(b, eb + lane + 32 * q);
    }
  }
  float* ta = sa[warp];
  float* tb = sb[warp];
  for (int64_t t = 0; t < n; ++t) {
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      ta[lane + 32 * q] = ra[q];
      tb[lane + 32 * q] = rb[q];
    }
    __syncwarp();
    if (t + 1 < n) {  // the next pair, in flight while this one is multiplied
      const int64_t ea = replay::clamp_slot(__ldg(ca + t + 1), r.nnzb_a) * kElems;
      const int64_t eb = replay::clamp_slot(__ldg(cb + t + 1), r.nnzb_b) * kElems;
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) {
        ra[q] = replay::load_val(a, ea + lane + 32 * q);
        rb[q] = replay::load_val(b, eb + lane + 32 * q);
      }
    }
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      const int e = lane + 32 * q;
      const int row = e / BS;
      const int col = e % BS;
      float dot = 0.f;
#pragma unroll
      for (int kk = 0; kk < BS; ++kk) dot = fmaf(ta[row * BS + kk], tb[kk * BS + col], dot);
      acc[q] += dot;
    }
    __syncwarp();  // the tiles are rewritten next
  }
  TA* out = static_cast<TA*>(r.out) + s * kElems;
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) replay::store_val(out, lane + 32 * q, acc[q]);
}

template <typename TA, typename TB>
struct BsrSpgemm {
  static void launch(const BsrArgs& r) {
    const unsigned grid = static_cast<unsigned>((r.nnzb_c + kWarps - 1) / kWarps);
    if (r.bs == 8) {
      bsr_spgemm_kernel<8, TA, TB><<<grid, kThreads, 0, r.stream>>>(r);
    } else {
      bsr_spgemm_kernel<16, TA, TB><<<grid, kThreads, 0, r.stream>>>(r);
    }
  }
};

}  // namespace

// int bsr_spgemm_launch(a, a_code, nnzb_a, b, b_code, nnzb_b, contrib_a,
//                       contrib_b, contrib_n, nnzb_c, t_max, out, bs, stream)
//   -> cudaGetLastError(); cudaErrorInvalidValue for a block size other than
//   8 or 16 or an unknown dtype code.
extern "C" int bsr_spgemm_launch(const void* a, int a_code, int64_t nnzb_a,
                                 const void* b, int b_code, int64_t nnzb_b,
                                 const int32_t* contrib_a, const int32_t* contrib_b,
                                 const int32_t* contrib_n, int64_t nnzb_c,
                                 int64_t t_max, void* out, int bs, void* stream) {
  if (bs != 8 && bs != 16) return static_cast<int>(cudaErrorInvalidValue);
  if (nnzb_c == 0) return static_cast<int>(cudaGetLastError());
  const BsrArgs r{a,      nnzb_a, b,   nnzb_b, contrib_a, contrib_b, contrib_n,
                  nnzb_c, t_max,  out, bs,     static_cast<cudaStream_t>(stream)};
  return replay::dispatch<BsrSpgemm>(a_code, b_code, r);
}

extern "C" const char* bsr_spgemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
