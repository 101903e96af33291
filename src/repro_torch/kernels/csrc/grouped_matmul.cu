// grouped_matmul: the expert-grouped matmul (the MoE numeric phase) on Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/grouped_matmul.py
// (grouped_matmul, body _kernel). Tokens arrive sorted by expert and padded
// so that no block of kTM = 128 rows spans two experts:
//   y[t, :] = float(x[t, :]) @ float(w[block_expert[t / 128]])
// with f32 products and f32 sums, written in x's dtype. An expert id clamps
// into [0, E).
//
// What bounds it: operations. 2 * T * d * f flops against T * d + E * d * f
// + T * f values moved: at the MoE widths (d 2,048, f 768) each weight tile
// serves 128 tokens, so the flops dominate by far.
//
// Design: the TPU kernel's (token block, f tile, d tile) grid with a VMEM
// accumulator becomes one thread block per (token block, 128-column f tile)
// whose loop over d takes the place of the sequential d axis. The block's
// expert is read once from block_expert and selects the weight tile (the
// TPU's scalar-prefetched index_map). Each step stages a 128 x 16 slice of x
// (transposed) and a 16 x 128 slice of w in shared memory as f32, with
// 16-byte global loads; 256 threads each keep an 8 x 8 f32 tile of y in
// registers (rows ty*4 + i and 64 + ty*4 + i, columns tx*4 + j and
// 64 + tx*4 + j, so the shared-memory reads are conflict-free float4s) and
// add 64 FMAs per pair of fragments. No tensor cores: a simple kernel that is
// right first; mma/wgmma is later work.
#include "replay_common.cuh"

namespace {

constexpr int kTM = 128;  // token rows per block (the reference's TM)
constexpr int kTN = 128;  // f columns per block
constexpr int kTK = 16;   // d per step
constexpr int kThreads = 256;
constexpr int kPad = 4;   // keeps float4 rows aligned

struct GroupedArgs {
  const void* x;  // (t, d)
  const void* w;  // (e, d, f)
  const int32_t* block_expert;  // (t / 128,)
  void* out;  // (t, f) in x's dtype
  int64_t t, d, f, e;
  cudaStream_t stream;
};

// Eight consecutive values at p (16-byte aligned for 16-bit types, 32-byte
// for f32) as f32.
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ float to_float(unsigned short h, const __half*) {
  return __half2float(__ushort_as_half(h));
}
__device__ __forceinline__ float to_float(unsigned short h, const __nv_bfloat16*) {
  return __bfloat162float(__ushort_as_bfloat16(h));
}
template <typename T16>
__device__ __forceinline__ void load8(const T16* p, float* v) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned short* h = reinterpret_cast<const unsigned short*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = to_float(h[i], p);
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads) grouped_matmul_kernel(const GroupedArgs r) {
  __shared__ __align__(16) float xs[kTK][kTM + kPad];  // x slice, transposed
  __shared__ __align__(16) float ws[kTK][kTN + kPad];
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int64_t tb = blockIdx.y;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kTN;
  int64_t e = __ldg(r.block_expert + tb);
  e = e < 0 ? 0 : (e >= r.e ? r.e - 1 : e);
  const TX* x = static_cast<const TX*>(r.x) + tb * kTM * r.d;
  const TW* w = static_cast<const TW*>(r.w) + e * r.d * r.f + n0;

  // staging: x rows tid / 2, d offsets (tid % 2) * 8; w rows tid / 16,
  // columns (tid % 16) * 8
  const int xr = tid / 2, xc = (tid % 2) * 8;
  const int wr = tid / 16, wc = (tid % 16) * 8;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float xv[8], wv[8];
  load8(x + xr * r.d + xc, xv);
  load8(w + static_cast<int64_t>(wr) * r.f + wc, wv);
  for (int64_t k0 = 0; k0 < r.d; k0 += kTK) {
#pragma unroll
    for (int i = 0; i < 8; ++i) xs[xc + i][xr] = xv[i];
    *reinterpret_cast<float4*>(&ws[wr][wc]) = make_float4(wv[0], wv[1], wv[2], wv[3]);
    *reinterpret_cast<float4*>(&ws[wr][wc + 4]) = make_float4(wv[4], wv[5], wv[6], wv[7]);
    __syncthreads();
    if (k0 + kTK < r.d) {  // the next slices, in flight during the FMAs
      load8(x + xr * r.d + k0 + kTK + xc, xv);
      load8(w + (k0 + kTK + wr) * r.f + wc, wv);
    }
#pragma unroll
    for (int kk = 0; kk < kTK; ++kk) {
      float a[8], b[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&xs[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&ws[kk][64 + tx * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // the slices are rewritten next
  }
  TX* out = static_cast<TX*>(r.out) + tb * kTM * r.f + n0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t row = (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4;
      replay::store_val(out, row * r.f + col, acc[i][j]);
    }
  }
}

template <typename TX, typename TW>
struct GroupedMatmul {
  static void launch(const GroupedArgs& r) {
    const dim3 grid(static_cast<unsigned>(r.f / kTN), static_cast<unsigned>(r.t / kTM));
    grouped_matmul_kernel<TX, TW><<<grid, kThreads, 0, r.stream>>>(r);
  }
};

}  // namespace

// int grouped_matmul_launch(x, x_code, w, w_code, block_expert, out, t, d, f,
//                           e, stream) -> cudaGetLastError();
//   cudaErrorInvalidValue unless t % 128 == 0, d % 16 == 0, f % 128 == 0 and
//   e >= 1, or for an unknown dtype code.
extern "C" int grouped_matmul_launch(const void* x, int x_code, const void* w,
                                     int w_code, const int32_t* block_expert,
                                     void* out, int64_t t, int64_t d, int64_t f,
                                     int64_t e, void* stream) {
  if (t % kTM || d % kTK || f % kTN || e < 1 || d < kTK)
    return static_cast<int>(cudaErrorInvalidValue);
  if (t == 0 || f == 0) return static_cast<int>(cudaGetLastError());
  const GroupedArgs r{x, w, block_expert, out, t, d, f, e,
                      static_cast<cudaStream_t>(stream)};
  return replay::dispatch<GroupedMatmul>(x_code, w_code, r);
}

extern "C" const char* grouped_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
