// Shared pieces of the two plan-replay kernels (segsum_reuse.cu, lp_reuse.cu);
// the value loads and stores and the dtype dispatch also serve the ELL
// kernels (spgemm_numeric.cu, spgemm_lp.cu) and bsr_spgemm.cu,
// grouped_matmul.cu and flash_attention.cu.
//
// Both replay a precomposed SpGEMM plan: for every product t,
//   C[seg_ids[t]] += A[a_slot[t]] * B[b_slot[t]]
// with f32 products and f32 accumulation. A product whose segment lies
// outside [0, nnz_cap) (the plan's padding sentinel nnz_cap) is dropped.
// Slots are clamped into the value buffers, as the reference's gathers clamp.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace replay {

// Value dtype codes, shared with the Python wrappers (kernels/segsum_reuse.py).
enum DtypeCode : int { kF32 = 0, kF16 = 1, kBF16 = 2 };

struct ReplayArgs {
  const int32_t* a_slot;
  const int32_t* b_slot;
  const int32_t* seg_ids;
  const void* a;
  int64_t na;
  const void* b;
  int64_t nb;
  float* out;
  int64_t fm;
  int64_t nnz_cap;
  cudaStream_t stream;
};

__device__ __forceinline__ float load_val(const float* p, int64_t i) {
  return __ldg(p + i);
}
__device__ __forceinline__ float load_val(const __half* p, int64_t i) {
  return __half2float(
      __ushort_as_half(__ldg(reinterpret_cast<const unsigned short*>(p) + i)));
}
__device__ __forceinline__ float load_val(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short*>(p) + i)));
}

// f32 v stored as *p's type (round to nearest even).
__device__ __forceinline__ void store_val(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_val(__half* p, int64_t i, float v) {
  p[i] = __float2half_rn(v);
}
__device__ __forceinline__ void store_val(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ int64_t clamp_slot(int64_t s, int64_t n) {
  return s < 0 ? 0 : (s >= n ? n - 1 : s);
}

// Product t of the plan. Sets *seg to its segment, or to -1 when the product
// is dropped (t >= fm or a sentinel segment); a dropped product is worth 0 and
// reads no value.
template <typename TA, typename TB>
__device__ __forceinline__ float load_product(const ReplayArgs& r, int64_t t,
                                              int* seg) {
  *seg = -1;
  if (t >= r.fm) return 0.f;
  const int s = __ldg(r.seg_ids + t);
  if (s < 0 || s >= r.nnz_cap) return 0.f;
  *seg = s;
  const int64_t ia = clamp_slot(__ldg(r.a_slot + t), r.na);
  const int64_t ib = clamp_slot(__ldg(r.b_slot + t), r.nb);
  return load_val(static_cast<const TA*>(r.a), ia) *
         load_val(static_cast<const TB*>(r.b), ib);
}

// Runs K<TA, TB>::launch(r) for the (a_code, b_code) pair and returns
// cudaGetLastError(), or cudaErrorInvalidValue for an unknown code. Args is
// the kernel's argument struct (ReplayArgs here; the ELL kernels have their
// own).
template <template <typename, typename> class K, typename TA, typename Args>
bool dispatch_b(int b_code, const Args& r) {
  switch (b_code) {
    case kF32: K<TA, float>::launch(r); return true;
    case kF16: K<TA, __half>::launch(r); return true;
    case kBF16: K<TA, __nv_bfloat16>::launch(r); return true;
  }
  return false;
}

template <template <typename, typename> class K, typename Args>
int dispatch(int a_code, int b_code, const Args& r) {
  bool ok = false;
  switch (a_code) {
    case kF32: ok = dispatch_b<K, float>(b_code, r); break;
    case kF16: ok = dispatch_b<K, __half>(b_code, r); break;
    case kBF16: ok = dispatch_b<K, __nv_bfloat16>(b_code, r); break;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace replay

// The C interface of each library, with the kernel's name as prefix:
//   int <name>_launch(a_slot, b_slot, seg_ids, a, a_code, na, b, b_code, nb,
//                     out, fm, nnz_cap, stream)   -> cudaGetLastError()
//   const char* <name>_error_string(int code)
#define REPLAY_C_API(NAME, KERNEL)                                           \
  extern "C" int NAME##_launch(const int32_t* a_slot, const int32_t* b_slot, \
                               const int32_t* seg_ids, const void* a,        \
                               int a_code, int64_t na, const void* b,        \
                               int b_code, int64_t nb, float* out,           \
                               int64_t fm, int64_t nnz_cap, void* stream) {  \
    const replay::ReplayArgs r{a_slot, b_slot, seg_ids, a,  na, b,           \
                               nb,     out,    fm,      nnz_cap,             \
                               static_cast<cudaStream_t>(stream)};           \
    return replay::dispatch<KERNEL>(a_code, b_code, r);                      \
  }                                                                          \
  extern "C" const char* NAME##_error_string(int code) {                     \
    return cudaGetErrorString(static_cast<cudaError_t>(code));               \
  }
