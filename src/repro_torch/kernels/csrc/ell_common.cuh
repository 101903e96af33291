// Shared pieces of the two ELL numeric kernels (spgemm_numeric.cu, K4, and
// spgemm_lp.cu, K3).
//
// Both compute, for each row i of C = A*B, the values at C's symbolic
// structure c_idx[i, :c_nnz[i]] from A's and B's ELL arrays:
//   C[i, c] = sum over r < a_nnz[i], t < nb(j) with b_idx[j, t] == c of
//             float(a_val[i, r]) * float(b_val[j, t]),   j = a_idx[i, r]
// with f32 products and f32 sums, written as f32 into an (m, r_c) output
// whose slots past c_nnz[i] hold 0. nb(j) is b_nnz[j] where the caller
// passes it (K3 always; K4 optionally, since B's padded slots carry 0 by its
// contract) and r_b otherwise. Counts clamp into [0, width]; a live A column
// id clamps into [0, n), as the reference's gathers clamp.
#pragma once

#include <cstdint>

#include "replay_common.cuh"

namespace ell {

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
  float* out;            // (m, r_c)
  int64_t m;
  int64_t k;
  // K4: f32 columns of the dense accumulator per pass
  int tile;
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

// Zero the output slots of row i past its live width cn.
__device__ __forceinline__ void zero_tail(const EllArgs& e, int64_t i,
                                          int64_t cn) {
  float* orow = e.out + i * e.r_c;
  for (int64_t s = cn + threadIdx.x; s < e.r_c; s += blockDim.x) orow[s] = 0.f;
}

}  // namespace ell

// The C interface of an ELL numeric library, with the kernel's name as
// prefix. K<TA, TB>::launch(const ell::EllArgs&) runs the kernel.
//   int <name>_launch(a_idx, a_val, a_code, a_nnz, r_a, b_idx, b_val, b_code,
//                     b_nnz, n, r_b, c_idx, c_nnz, r_c, out, m, k, tile,
//                     l1_size, rows, class_rows, g_off, g_tab, size_counts,
//                     lost_count, lost_rows, stream) -> cudaGetLastError()
//   const char* <name>_error_string(int code)
#define ELL_C_API(NAME, KERNEL)                                               \
  extern "C" int NAME##_launch(                                               \
      const int32_t* a_idx, const void* a_val, int a_code,                    \
      const int32_t* a_nnz, int64_t r_a, const int32_t* b_idx,                \
      const void* b_val, int b_code, const int32_t* b_nnz, int64_t n,         \
      int64_t r_b, const int32_t* c_idx, const int32_t* c_nnz, int64_t r_c,   \
      float* out, int64_t m, int64_t k, int tile, int l1_size,                \
      const int64_t* rows, const int64_t* class_rows, const int64_t* g_off,   \
      int32_t* g_tab, const int64_t* size_counts, int32_t* lost_count,        \
      int64_t* lost_rows, void* stream) {                                     \
    const ell::EllArgs e{a_idx, a_val, a_nnz, r_a, b_idx, b_val, b_nnz, n,    \
                         r_b,   c_idx, c_nnz, r_c, out,   m,     k,     tile, \
                         l1_size, rows,  class_rows, g_off, g_tab,            \
                         size_counts, lost_count, lost_rows,                  \
                         static_cast<cudaStream_t>(stream)};                  \
    return replay::dispatch<KERNEL>(a_code, b_code, e);                       \
  }                                                                           \
  extern "C" const char* NAME##_error_string(int code) {                      \
    return cudaGetErrorString(static_cast<cudaError_t>(code));                \
  }
