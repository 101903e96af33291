// spgemm_numeric: the KKDENSE numeric phase over ELL operands, on Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/spgemm_numeric.py
// (spgemm_numeric, body _kernel). Contract in ell_common.cuh: for row i, a
// dense f32 accumulator over C's columns takes every product of the row, and
// C's values are read from it at c_idx[i, :c_nnz[i]] (a column id clamps into
// [0, k), as the reference's gather does); a product whose B column lies
// outside [0, k) is dropped.
//
// What bounds it: bytes. Each live A entry and each visited B slot is read
// (4 + 2..4 bytes each), C's structure once, C's values written once; there
// are 2 flops per product. The (m, r_c) output is written whole, zeros past
// c_nnz included.
//
// Design: one block of 256 threads per C row, the dense row in shared memory.
// A row of k f32 does not fit one block's shared memory at k = 65,536
// (256 KiB > 227 KiB), so the block first finds the window [lo, hi] of the
// row's C columns (block min/max) and walks it in passes of `tile` columns
// (the wrapper's K4_MAX_TILE, 16,384 f32 = 64 KiB, or k if smaller). Each
// pass zeroes only its part of the window (the paper's KKDENSE resets only
// what it touches; the TPU kernel zeroed the whole row), streams the row's products -- warp w takes A entries w, w+8,
// ..., its lanes stride over the B row -- and adds each product that falls in
// the pass with a shared-memory atomicAdd, then reads C's values that fall in
// it. A row whose columns are close together (the multigrid product) needs
// one narrow pass. The one-hot MXU scatter and gather of the TPU kernel are
// real indexed adds and loads here. The shared-memory atomics add in no fixed
// order: results agree with the plain version to f32 rounding.
#include <climits>

#include "ell_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename TA, typename TB>
__global__ void __launch_bounds__(kThreads)
    spgemm_numeric_kernel(const ell::EllArgs e) {
  extern __shared__ float acc[];
  __shared__ int win_lo, win_hi;
  const int64_t i = blockIdx.x;
  const int tid = threadIdx.x;
  const int64_t cn = ell::clamp_count(__ldg(e.c_nnz + i), e.r_c);
  ell::zero_tail(e, i, cn);
  if (cn == 0) return;  // the same for the whole block

  const int32_t* crow = e.c_idx + i * e.r_c;
  float* orow = e.out + i * e.r_c;
  if (tid == 0) {
    win_lo = INT_MAX;
    win_hi = -1;
  }
  __syncthreads();
  int lo = INT_MAX, hi = -1;
  for (int64_t s = tid; s < cn; s += kThreads) {
    const int c = static_cast<int>(ell::clamp_row(__ldg(crow + s), e.k));
    lo = min(lo, c);
    hi = max(hi, c);
  }
  atomicMin(&win_lo, lo);
  atomicMax(&win_hi, hi);
  __syncthreads();
  lo = win_lo;
  hi = win_hi;

  const int64_t live_a = ell::clamp_count(__ldg(e.a_nnz + i), e.r_a);
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const TA* a_val = static_cast<const TA*>(e.a_val);
  const TB* b_val = static_cast<const TB*>(e.b_val);
  for (int64_t base = lo; base <= hi; base += e.tile) {
    const int64_t width = hi - base + 1 < e.tile ? hi - base + 1 : e.tile;
    for (int64_t s = tid; s < width; s += kThreads) acc[s] = 0.f;
    __syncthreads();
    for (int64_t r = warp; r < live_a; r += kWarps) {
      const int64_t slot = i * e.r_a + r;
      const int64_t j = ell::clamp_row(__ldg(e.a_idx + slot), e.n);
      const float av = replay::load_val(a_val, slot);
      const int64_t nb = ell::b_width(e, j);
      for (int64_t t = lane; t < nb; t += 32) {
        const int64_t off = static_cast<int64_t>(__ldg(e.b_idx + j * e.r_b + t)) - base;
        if (off >= 0 && off < width)
          atomicAdd(&acc[off], av * replay::load_val(b_val, j * e.r_b + t));
      }
    }
    __syncthreads();
    for (int64_t s = tid; s < cn; s += kThreads) {
      const int64_t off = ell::clamp_row(__ldg(crow + s), e.k) - base;
      if (off >= 0 && off < width) orow[s] = acc[off];
    }
    __syncthreads();  // the next pass zeroes acc
  }
}

template <typename TA, typename TB>
struct SpgemmNumeric {
  static void launch(const ell::EllArgs& e) {
    if (e.m == 0) return;
    const int bytes = e.tile * static_cast<int>(sizeof(float));
    cudaFuncSetAttribute(spgemm_numeric_kernel<TA, TB>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    spgemm_numeric_kernel<TA, TB>
        <<<static_cast<unsigned>(e.m), kThreads, bytes, e.stream>>>(e);
  }
};

}  // namespace

ELL_C_API(spgemm_numeric, SpgemmNumeric)
