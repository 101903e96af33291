// spgemm_symbolic: the symbolic phase over B's bitmask rows, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/spgemm_symbolic.py
// (spgemm_symbolic, body _kernel). For every row i of C = A*B:
//   out[i] = popcount( OR over r < a_nnz[i] of bm[a_idx[i, r], :] )
// where bm is B's structure as an (n, k32) array of 32-bit words (column c is
// bit c & 31 of word c >> 5). A's padded slots (r >= a_nnz[i]) are masked;
// a live A column id is clamped into [0, n), as the reference's gather clamps.
//
// What bounds it: bytes. Each live A entry reads one k32-word bitmask row
// (k32 * 4 bytes); the roofline counts B's bitmask once (n * k32 * 4 bytes),
// but a row of B that many A rows select is read once per selecting entry,
// from L2 where it stays there. The OR and popcount are a few integer
// operations per word.
//
// Design: one block of 128 threads per C row. The block walks the k32 words
// in chunks of 512 (4 words per thread, kept in registers); for each chunk
// it loops over the row's live A entries and ORs the selected bitmask rows
// (neighbouring threads read neighbouring words: one coalesced 2 KiB read per
// A entry and chunk), then adds __popc of its words. A warp shuffle and one
// shared-memory pass sum the counts. The TPU kernel's k32 % 128 lane
// alignment is gone: the chunk loop masks the ragged end.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWords = 4;  // words per thread per chunk
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
    spgemm_symbolic_kernel(const int32_t* __restrict__ a_idx, int64_t r_a,
                           const int32_t* __restrict__ a_nnz,
                           const uint32_t* __restrict__ bm, int64_t n,
                           int64_t k32, int32_t* __restrict__ out) {
  const int64_t i = blockIdx.x;
  const int tid = threadIdx.x;
  int64_t live = __ldg(a_nnz + i);
  live = live < 0 ? 0 : (live > r_a ? r_a : live);
  const int32_t* row = a_idx + i * r_a;

  int count = 0;
  for (int64_t w0 = 0; w0 < k32; w0 += kThreads * kWords) {
    uint32_t acc[kWords] = {0u, 0u, 0u, 0u};
    for (int64_t r = 0; r < live; ++r) {
      int64_t j = __ldg(row + r);
      j = j < 0 ? 0 : (j >= n ? n - 1 : j);
      const uint32_t* brow = bm + j * k32;
#pragma unroll
      for (int q = 0; q < kWords; ++q) {
        const int64_t w = w0 + q * kThreads + tid;
        if (w < k32) acc[q] |= __ldg(brow + w);
      }
    }
#pragma unroll
    for (int q = 0; q < kWords; ++q) count += __popc(acc[q]);
  }

  __shared__ int warp_sums[kThreads / 32];
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) count += __shfl_down_sync(kFull, count, d);
  if ((tid & 31) == 0) warp_sums[tid >> 5] = count;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
    out[i] = total;
  }
}

}  // namespace

// int spgemm_symbolic_launch(a_idx, r_a, a_nnz, bm, n, k32, out, m, stream)
//   -> cudaGetLastError()
extern "C" int spgemm_symbolic_launch(const int32_t* a_idx, int64_t r_a,
                                      const int32_t* a_nnz, const void* bm,
                                      int64_t n, int64_t k32, int32_t* out,
                                      int64_t m, void* stream) {
  if (m > 0) {
    spgemm_symbolic_kernel<<<static_cast<unsigned>(m), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        a_idx, r_a, a_nnz, static_cast<const uint32_t*>(bm), n, k32, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spgemm_symbolic_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
