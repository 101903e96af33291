// Shared pieces of the CUDA kernels: the value loads and stores, the slot
// clamp, the SM count and the dtype dispatch. They serve the two plan-replay
// kernels (segsum_reuse.cu, lp_reuse.cu, whose tile machinery is
// replay_tile.cuh), the ELL kernels (spgemm_numeric.cu, spgemm_lp.cu,
// spgemm_symbolic.cu), bsr_spgemm.cu, grouped_matmul.cu and
// flash_attention.cu.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace replay {

// Value dtype codes, shared with the Python wrappers (kernels/segsum_reuse.py).
enum DtypeCode : int { kF32 = 0, kF16 = 1, kBF16 = 2 };

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

// The SMs of the current device (read once per library: it sizes grids).
static inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

__device__ __forceinline__ int64_t clamp_slot(int64_t s, int64_t n) {
  return s < 0 ? 0 : (s >= n ? n - 1 : s);
}

// Runs K<TA, TB>::launch(r) for the (a_code, b_code) pair and returns
// cudaGetLastError(), or cudaErrorInvalidValue for an unknown code. Args is
// the kernel's argument struct.
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
