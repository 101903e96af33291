// Shared pieces of the two ELL numeric kernels (spgemm_numeric.cu, K4, and
// spgemm_lp.cu, K3); the shared-memory size, the SM count and the team
// helpers also serve spgemm_symbolic.cu (K5).
//
// Both compute, for each row i of C = A*B, the values at C's symbolic
// structure c_idx[i, :c_nnz[i]] from A's and B's ELL arrays:
//   C[i, c] = sum over r < a_nnz[i], t < nb(j) with b_idx[j, t] == c of
//             float(a_val[i, r]) * float(b_val[j, t]),   j = a_idx[i, r]
// with f32 products and f32 sums, written into an (m, r_c) output (K3: f32;
// K4: A's dtype, rounded once) whose slots past c_nnz[i] hold 0. nb(j) is
// b_nnz[j] where the caller
// passes it (K3 always; K4 optionally, since B's padded slots carry 0 by its
// contract) and r_b otherwise. Counts clamp into [0, width]; a live A column
// id clamps into [0, n), as the reference's gathers clamp.
#pragma once

#include <cstdint>

#include "replay_common.cuh"

namespace ell {

constexpr int kSmemBytes = 232448;  // a block's shared memory on the H100

using replay::sm_count;  // it sizes the persistent grids

struct EllArgs {
  const int32_t* a_idx;  // (m, r_a)
  const void* a_val;     // (m, r_a)
  const int32_t* a_nnz;  // (m,)
  int64_t r_a;
  const int32_t* b_idx;  // (n, r_b)
  const void* b_val;     // (n, r_b)
  const int32_t* b_nnz;  // (n,) or nullptr
  int64_t n;
  int64_t r_b;
  const int32_t* c_idx;  // (m, r_c)
  const int32_t* c_nnz;  // (m,)
  int64_t r_c;
  void* out;             // (m, r_c): f32 (K3) or A's dtype (K4)
  int64_t m;
  int64_t k;
  // K4: its int32 scratch (class counts, row windows, class row lists: see
  // spgemm_numeric.cu) and the device-memory accumulators of its wide class
  // (acc_floats f32; nullptr when k fits shared memory)
  int32_t* scratch;
  float* acc;
  int64_t acc_floats;
  // K3: L1 size (0 = per row); the non-empty rows sorted by size class
  // (device) and the rows of each class (a host array, read by the
  // launcher); the device-memory tables of the widest rows and the scan of
  // their slot allotments that places them; the count that sizes each
  // listed row's tables (nullptr: its c_nnz); where a row loses a product
  // (a full table), its id goes to lost_rows[atomicAdd(lost_count, 1)]
  // (lost_count nullptr: the kernel cannot lose one)
  int l1_size;
  const int64_t* rows;
  const int64_t* class_rows;
  const int64_t* g_off;
  int32_t* g_tab;
  const int64_t* size_counts;
  int32_t* lost_count;
  int64_t* lost_rows;
  cudaStream_t stream;
};

__device__ __forceinline__ int64_t clamp_count(int64_t x, int64_t width) {
  return x < 0 ? 0 : (x > width ? width : x);
}

__device__ __forceinline__ int64_t clamp_row(int64_t j, int64_t n) {
  return j < 0 ? 0 : (j >= n ? n - 1 : j);
}

// Live width of B's row j.
__device__ __forceinline__ int64_t b_width(const EllArgs& e, int64_t j) {
  return e.b_nnz ? clamp_count(__ldg(e.b_nnz + j), e.r_b) : e.r_b;
}

// The A entry r of row i (B row, A value, live B width), zeros past live_a.
template <typename TA>
__device__ __forceinline__ void load_entry(const EllArgs& e, const TA* a_val,
                                           int64_t i, int64_t r, int64_t live_a,
                                           int& j, float& av, long long& nb) {
  j = 0;
  av = 0.f;
  nb = 0;
  if (r < live_a) {
    const int64_t slot = i * e.r_a + r;
    j = static_cast<int>(clamp_row(__ldg(e.a_idx + slot), e.n));
    av = replay::load_val(a_val, slot);
    nb = b_width(e, j);
  }
}

// The lanes of a team of `team` threads (a power of two) that holds this
// thread: a team of at most 32 shares a warp, a larger one is the block.
__device__ __forceinline__ unsigned team_mask(int team) {
  return team >= 32 ? 0xffffffffu
                    : ((1u << team) - 1) << ((threadIdx.x & 31) & ~(team - 1));
}

__device__ __forceinline__ void team_sync(int team, unsigned tmask) {
  if (team > 32) __syncthreads(); else __syncwarp(tmask);
}

// Inclusive scan of x over a team: shuffles within a warp for a team of at
// most 32 lanes, and warp totals in shared memory for a block-wide team.
__device__ __forceinline__ long long team_scan(long long x, int lane, int team,
                                               unsigned tmask, long long* warp_sums) {
  if (team <= 32) {
    for (int d = 1; d < team; d <<= 1) {
      const long long y = __shfl_up_sync(tmask, x, d, team);
      if (lane >= d) x += y;
    }
    return x;
  }
  const int wl = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, x, d);
    if (wl >= d) x += y;
  }
  if (wl == 31) warp_sums[w] = x;
  __syncthreads();
  if (w == 0) {
    long long s = wl < (team >> 5) ? warp_sums[wl] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, s, d);
      if (wl >= d) s += y;
    }
    warp_sums[wl] = s;
  }
  __syncthreads();
  return w > 0 ? x + warp_sums[w - 1] : x;
}

// The index of the staged entry that holds flat item p, given the entries'
// inclusive item scan `off` (n_e entries); `lo` is where to start, since a
// lane's p only grows.
__device__ __forceinline__ int find_entry(const int64_t* off, int n_e, int64_t p, int lo) {
  int hi = n_e - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (off[mid] > p) hi = mid; else lo = mid + 1;
  }
  return lo;
}

}  // namespace ell

// The C interface of an ELL numeric library, with the kernel's name as
// prefix. K<TA, TB>::launch(const ell::EllArgs&) runs the kernel.
//   int <name>_launch(a_idx, a_val, a_code, a_nnz, r_a, b_idx, b_val, b_code,
//                     b_nnz, n, r_b, c_idx, c_nnz, r_c, out, m, k, scratch,
//                     acc, acc_floats, l1_size, rows, class_rows, g_off, g_tab,
//                     size_counts, lost_count, lost_rows, stream)
//     -> cudaGetLastError()
//   const char* <name>_error_string(int code)
#define ELL_C_API(NAME, KERNEL)                                               \
  extern "C" int NAME##_launch(                                               \
      const int32_t* a_idx, const void* a_val, int a_code,                    \
      const int32_t* a_nnz, int64_t r_a, const int32_t* b_idx,                \
      const void* b_val, int b_code, const int32_t* b_nnz, int64_t n,         \
      int64_t r_b, const int32_t* c_idx, const int32_t* c_nnz, int64_t r_c,   \
      void* out, int64_t m, int64_t k, int32_t* scratch, float* acc,          \
      int64_t acc_floats, int l1_size, const int64_t* rows,                   \
      const int64_t* class_rows, const int64_t* g_off, int32_t* g_tab,        \
      const int64_t* size_counts, int32_t* lost_count, int64_t* lost_rows,    \
      void* stream) {                                                         \
    const ell::EllArgs e{a_idx, a_val, a_nnz,   r_a,   b_idx, b_val,          \
                         b_nnz, n,     r_b,     c_idx, c_nnz, r_c,            \
                         out,   m,     k,       scratch, acc, acc_floats,     \
                         l1_size, rows,  class_rows, g_off, g_tab,            \
                         size_counts, lost_count, lost_rows,                  \
                         static_cast<cudaStream_t>(stream)};                  \
    return replay::dispatch<KERNEL>(a_code, b_code, e);                       \
  }                                                                           \
  extern "C" const char* NAME##_error_string(int code) {                      \
    return cudaGetErrorString(static_cast<cudaError_t>(code));                \
  }
