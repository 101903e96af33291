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
// What bounds it: at the MoE widths (d 2,048, f 768, 128 experts, 317 token
// blocks) in bf16 the bytes, just: 2 * T * d * f flops (127.6 GFLOP, 0.129 ms
// at 989 TFLOP/s) against T * d + E * d * f + T * f values (631 MB, 0.188 ms
// at 3.35 TB/s). In f32 the operations: three TF32 products (below) of 127.6
// GFLOP each at 495 TFLOP/s, 0.773 ms, against 1.262 GB (0.377 ms). Each
// weight tile serves the 128 tokens of a block, and the token blocks of one
// expert are adjacent, so they meet it in L2.
//
// Two variants, chosen by the dtype pair in variant_of, the one rule that the
// launcher, grouped_matmul_variant and grouped_matmul_products read; a failed
// launch is an error, never a fallback:
//
// "wgmma" -- x and w both bf16 or both f16. A product of two such values is
// exact in f32, so tensor cores with f32 accumulators keep the contract. One
// block per (token block, 128-column tile of f), the f tiles fastest, so the
// blocks that share an x tile run side by side; two blocks an SM (96
// registers a thread), so one block's epilogue overlaps the other's main
// loop. (256-column tiles, one block an SM, read x from L2 half as often but
// measured no faster at the qwen3-moe projections: PERF.md.) A producer warp
// keeps a ring of kWgStages stages in flight with TMA: each stage a 128 x 64
// slice of x (a 2-D map over (T, d)) and a 64 x 128 slice of w (a 3-D map
// over (E, d, f) whose expert coordinate is the block's clamped expert),
// 128-byte swizzled in 64-column panels, counted on the stage's "full"
// mbarrier. Two consumer warpgroups of 64 rows each issue four
// wgmma.m64n128k16 a stage with f32 accumulators: A (x) from shared memory
// K-major, B (w) from shared memory MN-major (the transpose-B flag; the
// descriptor of K8's V operand: 64-column panels 64 rows * 128 bytes apart,
// 8-row groups 1,024 bytes apart). A warpgroup keeps one stage's wgmmas in
// flight: it waits for the previous stage's, and each of its warps then
// releases that stage on its "empty" mbarrier, which the producer waits for
// before it refills the stage. The epilogue rounds to x's dtype in registers,
// gathers 8 consecutive columns into each lane of a quad with three
// shuffles, and writes 16-byte stores.
//
// "tf32" -- every other pair (f32 x f32, f32 with bf16 or f16 in either
// order, bf16 x f16 in either order) on tensor cores in split TF32. TF32
// keeps 11 significant bits, a relative error of about 5e-4 where the f32
// contract asks for about 1e-6, so each f32 operand v is split into
// big = cvt.rna.tf32(v) and small = cvt.rna.tf32(v - big) (tf32_split.cuh,
// shared with K8's "tf32" variant), and
//   y = xs * wb + xb * ws + xb * wb
// in f32, the small terms first (CUTLASS's 3xTF32; xs * ws is dropped,
// about 2^-22 of |x * w| a term). A bf16 or f16 value is exact in TF32 and
// has no small part, so a pair takes 3 products (f32 x f32), 2 (f32 with a
// 16-bit type) or 1 (bf16 x f16). The tensor cores' own adds truncate: summed
// over all of d in one accumulator they moved y by a relative 1.4e-5 (K7_FRO
// is 5e-6), so each stage's products go to a fresh accumulator, added to y
// in f32 after the stage. wgmma's TF32 form takes both operands K-major,
// and w is MN-major (f contiguous): so A (x) comes from registers, split
// there, and each stage of w is rewritten once in shared memory, in the pass
// that splits it, as K-major panels (big, and small for f32 w) with the
// 128-byte swizzle. One block of two warpgroups per (token block, 128-column
// f tile), one block an SM: a ring of kSwStages raw slices of 32 values of d
// (x's 128 rows, w's 32 rows of 128) filled by 16-byte cp.async two stages
// ahead; per stage each warpgroup loads and splits its A fragments, issues
// 12, 8 or 4 wgmma.m64n128k8 on the stage's panels, and rewrites the next
// stage's w into the other pair of panels while they run. Within a stage
// the panel's d order is permuted (k_of) so that a lane's x values of the
// whole stage are 8 consecutive ones.
//
// "mma" -- the same split on mma.sync.m16n8k8, fragments gathered from
// shared memory in any layout and split in registers (8 warps of 64 x 32,
// two blocks an SM), built only with -DGROUPED_MATMUL_FORCE_VARIANT=2, for
// scripts/k7_variants.py to time beside the wgmma design.
//
// "fma" -- the first f32 FMA kernel (f32 tiles in shared memory, an 8 x 8
// register tile a thread), built only with -DGROUPED_MATMUL_FORCE_VARIANT=1,
// which then runs every pair on it. scripts/k7_variants.py compiles such
// libraries from copies of this file to time the earlier designs against
// the port's. The port never builds them.
#include <climits>
#include <cstring>
#include <cuda.h>
#include <type_traits>

#include "replay_common.cuh"
#include "tf32_split.cuh"

namespace {

constexpr int kTM = 128;  // token rows per block (the reference's TM)

struct GroupedArgs {
  const void* x;  // (t, d)
  const void* w;  // (e, d, f)
  const int32_t* block_expert;  // (t / 128,)
  void* out;  // (t, f) in x's dtype
  int64_t t, d, f, e;
  cudaStream_t stream;
};

__device__ __forceinline__ int64_t block_expert_of(const GroupedArgs& r, int64_t tb) {
  const int64_t e = __ldg(r.block_expert + tb);
  return e < 0 ? 0 : (e >= r.e ? r.e - 1 : e);
}

// ---------------------------------------------------------------------------
// "fma": f32 FMAs over shared-memory tiles (only in a forced build)
// ---------------------------------------------------------------------------

#if defined(GROUPED_MATMUL_FORCE_VARIANT) && GROUPED_MATMUL_FORCE_VARIANT == 1
constexpr int kTN = 128;  // f columns per block
constexpr int kTK = 16;   // d per step
constexpr int kThreads = 256;
constexpr int kPad = 4;   // keeps float4 rows aligned

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
  const int64_t e = block_expert_of(r, tb);
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
int launch_fma(const GroupedArgs& r) {
  if (r.d % kTK) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(r.f / kTN), static_cast<unsigned>(r.t / kTM));
  grouped_matmul_kernel<TX, TW><<<grid, kThreads, 0, r.stream>>>(r);
  return static_cast<int>(cudaGetLastError());
}
#endif  // GROUPED_MATMUL_FORCE_VARIANT == 1

// ---------------------------------------------------------------------------
// "wgmma": bf16 x bf16 and f16 x f16 on tensor cores, TMA-fed stages
// ---------------------------------------------------------------------------

constexpr int kWgN = 128;      // f columns per block: two 64-column panels
constexpr int kWgK = 64;       // d per stage: one 128-byte swizzle row of 16-bit values
constexpr int kWgStages = 3;   // the ring; two blocks an SM share its shared memory
constexpr int kWgMinBlocks = 2;
constexpr int kConsumerWarps = 8;  // two warpgroups of 64 token rows
constexpr int kWgThreads = (kConsumerWarps + 1) * 32;  // and the producer warp
constexpr int kXBytes = kTM * kWgK * 2;   // 128 rows x 128 bytes
constexpr int kWBytes = kWgK * kWgN * 2;  // kWgN / 64 panels of kWgK rows x 128 bytes
constexpr int kStageBytes = kXBytes + kWBytes;
constexpr int kWgSmem = 1024 + kWgStages * kStageBytes + 2 * 8 * kWgStages;
static_assert(kWgMinBlocks * (kWgSmem + 1024) <= 233472, "two blocks do not fit an SM");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}
__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// Waits for the phase of parity `parity` to complete; a phase that never
// completes (a lost copy) traps after 10 s instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > 10000000000ull) __trap();
}

// One TMA box into shared memory, counted on bar's transaction bytes.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 (B128).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins registers that an in-flight wgmma writes: the compiler may neither
// move their uses across this point nor reuse them before it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

#define K7_WGMMA_M64N128K16(TY)                                                                  \
  asm volatile(                                                                                  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                               \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "                               \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "   \
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "    \
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "     \
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"     \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),               \
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),            \
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),            \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),            \
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),            \
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),            \
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),            \
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),            \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),            \
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                                                    \
      : "l"(da), "l"(db), "r"(scale_d))

// D (64 x 128, f32) (+)= A (64 x 16) * B (16 x 128): A K-major, B MN-major
// (transpose-B), both in shared memory with the 128-byte swizzle; scale_d = 0
// overwrites D.
template <typename T>
__device__ __forceinline__ void wgmma_tn(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    K7_WGMMA_M64N128K16("bf16");
  } else {
    K7_WGMMA_M64N128K16("f16");
  }
}
#undef K7_WGMMA_M64N128K16

// (lo, hi) rounded to T and packed, lo in the low half (the lower column).
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  uint32_t out;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    memcpy(&out, &v, 4);
  } else {
    const __half2 v = __floats2half2_rn(lo, hi);
    memcpy(&out, &v, 4);
  }
  return out;
}

__device__ __forceinline__ uint32_t pick4(const uint32_t (&v)[4], int i) {
  return i == 0 ? v[0] : (i == 1 ? v[1] : (i == 2 ? v[2] : v[3]));
}

template <typename T>
__global__ void __launch_bounds__(kWgThreads, kWgMinBlocks)
    grouped_matmul_wg(const __grid_constant__ GroupedArgs r,
                      const __grid_constant__ CUtensorMap x_map,
                      const __grid_constant__ CUtensorMap w_map) {
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle repeats every 8 rows
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kWgStages * kStageBytes);
  uint64_t* empty = full + kWgStages;
  const int warp = static_cast<int>(threadIdx.x) / 32;
  const int lane = static_cast<int>(threadIdx.x) % 32;
  const int tb = static_cast<int>(blockIdx.y);
  const int n0 = static_cast<int>(blockIdx.x) * kWgN;
  const int nk = static_cast<int>(r.d / kWgK);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // the producer: one lane issues every copy
    if (lane == 0) {
      const int e = static_cast<int>(block_expert_of(r, tb));
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kWgStages;
        if (kt >= kWgStages) mbar_wait(empty + s, static_cast<uint32_t>((kt / kWgStages - 1) & 1));
        unsigned char* xs = ring + s * kStageBytes;
        mbar_expect_tx(full + s, kStageBytes);
        tma_load_2d(xs, &x_map, kt * kWgK, tb * kTM, full + s);
#pragma unroll
        for (int p = 0; p < kWgN / 64; ++p)
          tma_load_3d(xs + kXBytes + p * kWgK * 128, &w_map, n0 + p * 64, kt * kWgK, e, full + s);
      }
    }
    return;
  }

  // a consumer warpgroup: token rows wg * 64 .. wg * 64 + 63 of the block
  const int wg = __shfl_sync(0xffffffffu, warp / 4, 0);
  float acc[kWgN / 2];
#pragma unroll
  for (int i = 0; i < kWgN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kWgStages;
    mbar_wait(full + s, static_cast<uint32_t>((kt / kWgStages) & 1));
    const uint32_t xa = smem_u32(ring + s * kStageBytes) + wg * 64 * 128;
    const uint32_t wa = smem_u32(ring + s * kStageBytes + kXBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgK / 16; ++kk)  // 16 values of d: 32 bytes of x's rows, 16 rows of w
      wgmma_tn<T>(acc, gmma_desc(xa + kk * 32, 16, 1024),
                  gmma_desc(wa + kk * 16 * 128, kWgK * 128, 1024), 1);
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's wgmmas are done: release it
    fence_regs(acc);
    if (kt > 0 && lane == 0) mbar_arrive(empty + (kt - 1) % kWgStages);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // acc[4j + 2h + c]: row lane / 4 + 8h of this warp's 16, column 8j + 2 (lane % 4) + c.
  // Per row half h and group of four column octets j = 4g + i, lane q of a quad
  // holds pair q of octets 4g .. 4g + 3 and takes, by three xor shuffles,
  // all four pairs of octet 4g + q: one 16-byte store.
  const int q = lane % 4;
  const int64_t row0 = static_cast<int64_t>(tb) * kTM + wg * 64 + (warp % 4) * 16 + lane / 4;
  T* out = static_cast<T*>(r.out);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int g = 0; g < kWgN / 32; ++g) {
      uint32_t v[4], o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[i] = pack2<T>(acc[4 * (4 * g + i) + 2 * h], acc[4 * (4 * g + i) + 2 * h + 1]);
        o[i] = v[i];
      }
#pragma unroll
      for (int x = 1; x < 4; ++x) {
        const uint32_t got = __shfl_xor_sync(0xffffffffu, pick4(v, q ^ x), x);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (i == (q ^ x)) o[i] = got;
      }
      *reinterpret_cast<uint4*>(out + (row0 + 8 * h) * r.f + n0 + 8 * (4 * g + q)) =
          make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// Split TF32, and "mma": the split on mma.sync.m16n8k8 (only in a forced build)
// ---------------------------------------------------------------------------

constexpr int kTfN = 128;       // f columns per block
constexpr int kTfK = 32;        // d per stage
constexpr int kTfStages = 3;
constexpr int kTfThreads = 256;  // 8 warps: 2 along the rows x 4 along f, 64 x 32 each
constexpr int kTfMinBlocks = 2;

// One stage of the ring: x's kTM rows of kTfK values, then w's kTfK rows of
// kTfN values, each row padded by 16 bytes (x) or 8 values (w), so that the
// fragment loads of a warp (8 rows x 4 values of x, 4 rows x 8 values of w)
// fall in 32 banks.
template <typename TX, typename TW>
struct TfStage {
  static constexpr int kXPitch = kTfK + 16 / static_cast<int>(sizeof(TX));
  static constexpr int kWPitch = kTfN + 8;
  static constexpr int kXBytes = kTM * kXPitch * static_cast<int>(sizeof(TX));
  static constexpr int kBytes = kXBytes + kTfK * kWPitch * static_cast<int>(sizeof(TW));
  static constexpr int kSmem = kTfStages * kBytes;
  static_assert(kXBytes % 16 == 0 && kBytes % 16 == 0, "16-byte cp.async targets");
  static_assert(kTfMinBlocks * (kSmem + 1024) <= 233472, "two blocks do not fit an SM");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float as_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

using tf32::split_tf32;  // tf32_split.cuh

// D (16 x 8, f32) += A (16 x 8, row) * B (8 x 8, col), TF32 operands.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// D = A * B (no addend).
__device__ __forceinline__ void mma_tf32_first(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

__device__ __forceinline__ void store2(float* p, float lo, float hi) {
  *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
}
template <typename T>
__device__ __forceinline__ void store2(T* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = pack2<T>(lo, hi);
}

// Stage kt's slices of x and w into ring slot kt % kTfStages: 16-byte
// cp.asyncs, a few a thread.
template <typename TX, typename TW>
__device__ __forceinline__ void tf_load(unsigned char* ring, const TX* x, const TW* w, int64_t d,
                                        int64_t f, int kt, int tid) {
  using S = TfStage<TX, TW>;
  unsigned char* stage = ring + (kt % kTfStages) * S::kBytes;
  TX* xs = reinterpret_cast<TX*>(stage);
  TW* ws = reinterpret_cast<TW*>(stage + S::kXBytes);
  const int64_t k0 = static_cast<int64_t>(kt) * kTfK;
  constexpr int kXv = 16 / static_cast<int>(sizeof(TX));  // values a copy
  constexpr int kXc = kTfK / kXv;                         // copies a row
  constexpr int kWv = 16 / static_cast<int>(sizeof(TW));
  constexpr int kWc = kTfN / kWv;
  static_assert((kTM * kXc) % kTfThreads == 0 && (kTfK * kWc) % kTfThreads == 0,
                "every thread issues the same copies");
#pragma unroll
  for (int i = 0; i < kTM * kXc / kTfThreads; ++i) {
    const int c = tid + i * kTfThreads;
    const int row = c / kXc, col = (c % kXc) * kXv;
    cp_async16(xs + row * S::kXPitch + col, x + row * d + k0 + col);
  }
#pragma unroll
  for (int i = 0; i < kTfK * kWc / kTfThreads; ++i) {
    const int c = tid + i * kTfThreads;
    const int row = c / kWc, col = (c % kWc) * kWv;
    cp_async16(ws + row * S::kWPitch + col, w + (k0 + row) * f + col);
  }
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(kTfThreads, kTfMinBlocks)
    grouped_matmul_mma(const GroupedArgs r) {
  using S = TfStage<TX, TW>;
  constexpr bool kSplitX = std::is_same<TX, float>::value;
  constexpr bool kSplitW = std::is_same<TW, float>::value;
  extern __shared__ __align__(16) unsigned char tf_ring[];
  const int tid = static_cast<int>(threadIdx.x);
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;  // the fragments' group and thread in group
  const int wm = warp / 4, wn = warp % 4;  // rows wm * 64 .., columns wn * 32 ..
  const int64_t tb = blockIdx.y;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kTfN;
  const int64_t e = block_expert_of(r, tb);
  const TX* x = static_cast<const TX*>(r.x) + tb * kTM * r.d;
  const TW* w = static_cast<const TW*>(r.w) + e * r.d * r.f + n0;
  const int nk = static_cast<int>(r.d / kTfK);

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

#pragma unroll
  for (int s = 0; s < kTfStages - 1; ++s) {
    if (s < nk) tf_load(tf_ring, x, w, r.d, r.f, s, tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kTfStages - 2>();  // stage kt has landed (this thread's copies)
    __syncthreads();  // ... everyone's; and stage kt - 1 is no longer read
    if (kt + kTfStages - 1 < nk) tf_load(tf_ring, x, w, r.d, r.f, kt + kTfStages - 1, tid);
    cp_async_commit();
    const unsigned char* stage = tf_ring + (kt % kTfStages) * S::kBytes;
    // A fragment i: row g + 8 (i & 1), column q + 4 (i >> 1); B fragment h:
    // row q + 4 h, column g
    const TX* xs = reinterpret_cast<const TX*>(stage) + (wm * 64 + g) * S::kXPitch + q;
    const TW* ws = reinterpret_cast<const TW*>(stage + S::kXBytes) + q * S::kWPitch + wn * 32 + g;
#pragma unroll
    for (int kk = 0; kk < kTfK; kk += 8) {
      uint32_t wb[4][2], wsm[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          split_tf32<kSplitW>(as_f32(ws[(kk + 4 * h) * S::kWPitch + nt * 8]), wb[nt][h],
                              wsm[nt][h]);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t xb[4], xsm[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split_tf32<kSplitX>(
              as_f32(xs[(mt * 16 + 8 * (i & 1)) * S::kXPitch + kk + 4 * (i >> 1)]), xb[i],
              xsm[i]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {  // the small terms first
          if constexpr (kSplitX) {
            // an f32 output: the step's products summed in a fresh tile, then
            // added in f32 (the tensor cores' own adds truncate; summed over
            // all of d they moved a relative 1.4e-5 of y where K7_FRO is 5e-6)
            float part[4];
            mma_tf32_first(part, xsm, wb[nt]);
            if constexpr (kSplitW) mma_tf32(part, xb, wsm[nt]);
            mma_tf32(part, xb, wb[nt]);
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[mt][nt][c] += part[c];
          } else {
            if constexpr (kSplitW) mma_tf32(acc[mt][nt], xb, wsm[nt]);
            mma_tf32(acc[mt][nt], xb, wb[nt]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // acc[mt][nt][2 h + c]: row wm * 64 + 16 mt + g + 8 h, column wn * 32 + 8 nt + 2 q + c
  TX* out = static_cast<TX*>(r.out) + tb * kTM * r.f + n0;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t row = wm * 64 + mt * 16 + g + 8 * h;
        store2(out + row * r.f + wn * 32 + nt * 8 + 2 * q, acc[mt][nt][2 * h],
               acc[mt][nt][2 * h + 1]);
      }
}

template <typename TX, typename TW>
int launch_mma(const GroupedArgs& r) {
  if (r.d % kTfK || r.f % kTfN) return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(r.x) | reinterpret_cast<uintptr_t>(r.w) |
       reinterpret_cast<uintptr_t>(r.out)) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  constexpr int smem = TfStage<TX, TW>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(grouped_matmul_mma<TX, TW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(r.f / kTfN), static_cast<unsigned>(r.t / kTM));
  grouped_matmul_mma<TX, TW><<<grid, kTfThreads, smem, r.stream>>>(r);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// "tf32": split TF32 on wgmma, A (x) from registers, B (w) rewritten K-major
// ---------------------------------------------------------------------------

constexpr int kSwThreads = 256;  // two warpgroups of 64 token rows
constexpr int kSwStages = 3;     // the ring of raw x and w slices (cp.async)
constexpr int kPanelBytes = kTfN * 128;  // 128 rows of f, 32 TF32 values of d each

// Position P (0..31) of a K-major panel row holds d offset k_of(P) of the
// stage: wgmma step s = P / 8 reads positions 8 s .. 8 s + 7, and the A
// fragment of lane q takes positions 8 s + q and 8 s + q + 4, so lane q
// needs d offsets 8 q + 2 s and 8 q + 2 s + 1: its x values of all four
// steps are 8 consecutive ones, two float4 loads (one for 16-bit x).
__host__ __device__ constexpr int k_of(int p) {
  return 8 * ((p % 8) % 4) + 2 * (p / 8) + (p % 8) / 4;
}

// One stage of the raw ring: x's kTM rows of kTfK values (f32 rows padded
// to 36 values so that a quarter-warp's 16-byte loads hit 32 banks), then
// w's kTfK rows of kTfN values, both as they lie in memory; then the two
// panel buffers, each a big and (for f32 w) a small panel.
template <typename TX, typename TW>
struct SwSmem {
  static constexpr bool kSmallW = std::is_same<TW, float>::value;
  static constexpr int kXPitch = std::is_same<TX, float>::value ? kTfK + 4 : kTfK;
  static constexpr int kXBytes = kTM * kXPitch * static_cast<int>(sizeof(TX));
  static constexpr int kStageBytes = kXBytes + kTfK * kTfN * static_cast<int>(sizeof(TW));
  static constexpr int kPanelsBytes = (kSmallW ? 2 : 1) * kPanelBytes;  // one buffer
  static constexpr int kSmem = 1024 + 2 * kPanelsBytes + kSwStages * kStageBytes;
  static_assert(kStageBytes % 16 == 0 && kXBytes % 16 == 0, "16-byte cp.async targets");
  static_assert(kSmem <= 232448, "the block does not fit an SM");
};

#define K7_WGMMA_TF32_M64N128K8                                                                  \
  asm volatile(                                                                                  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                               \
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "                                    \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "   \
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "    \
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "     \
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, "   \
      "1, 1;\n}\n"                                                                               \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),               \
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),            \
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),            \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),            \
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),            \
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),            \
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),            \
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),            \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),            \
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                                                    \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

// D (64 x 128, f32) (+)= A (64 x 8, TF32, registers: the m16n8k8 fragment of
// each warp's 16 rows) * B (8 x 128, TF32, shared memory K-major with the
// 128-byte swizzle); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                           int scale_d) {
  K7_WGMMA_TF32_M64N128K8;
}
#undef K7_WGMMA_TF32_M64N128K8

// 16 bytes at p as 4 f32 (8 16-bit values: the first or second 4).
__device__ __forceinline__ void lds4(const float* p, float (&v)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
}

// Lane q's 8 x values of one row for the stage (d offsets 8 q .. 8 q + 7), as f32.
__device__ __forceinline__ void x_row8(const float* row, int q, float (&v)[8]) {
  float lo[4], hi[4];
  lds4(row + 8 * q, lo);
  lds4(row + 8 * q + 4, hi);
#pragma unroll
  for (int i = 0; i < 4; ++i) { v[i] = lo[i]; v[4 + i] = hi[i]; }
}
template <typename T16>
__device__ __forceinline__ void x_row8(const T16* row, int q, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(row + 8 * q);
  const T16* h = reinterpret_cast<const T16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = as_f32(h[i]);
}

// Rewrite the raw w slice of a stage (kTfK rows of kTfN values, f
// contiguous) as K-major panels: row n of f holds w[k_of(P)][n] at position
// P, TF32 big parts in `big`, small parts in `small` (f32 w only), 16-byte
// chunk c of row n at chunk c ^ (n % 8) (the 128-byte swizzle). Thread tid
// takes row n = tid % 128 and chunks 4 (tid / 128) .. + 3.
template <typename TW>
__device__ __forceinline__ void rewrite_w(const TW* raw, unsigned char* big, unsigned char* small,
                                          int tid) {
  constexpr bool kSplit = std::is_same<TW, float>::value;
  const int n = tid % kTfN;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = 4 * (tid / kTfN) + i;
    uint32_t b[4], sm[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      split_tf32<kSplit>(as_f32(raw[k_of(4 * c + j) * kTfN + n]), b[j], sm[j]);
    const int off = n * 128 + ((c ^ (n % 8)) * 16);
    *reinterpret_cast<uint4*>(big + off) = make_uint4(b[0], b[1], b[2], b[3]);
    if constexpr (kSplit) *reinterpret_cast<uint4*>(small + off) = make_uint4(sm[0], sm[1], sm[2], sm[3]);
  }
}

// Stage kt's raw x and w slices into ring slot kt % kSwStages: 16-byte
// cp.asyncs, the same number for every thread.
template <typename TX, typename TW>
__device__ __forceinline__ void sw_load(unsigned char* ring, const TX* x, const TW* w, int64_t d,
                                        int64_t f, int kt, int tid) {
  using S = SwSmem<TX, TW>;
  unsigned char* stage = ring + (kt % kSwStages) * S::kStageBytes;
  TX* xs = reinterpret_cast<TX*>(stage);
  TW* ws = reinterpret_cast<TW*>(stage + S::kXBytes);
  const int64_t k0 = static_cast<int64_t>(kt) * kTfK;
  constexpr int kXv = 16 / static_cast<int>(sizeof(TX));
  constexpr int kXc = kTfK / kXv;
  constexpr int kWv = 16 / static_cast<int>(sizeof(TW));
  constexpr int kWc = kTfN / kWv;
  static_assert((kTM * kXc) % kSwThreads == 0 && (kTfK * kWc) % kSwThreads == 0,
                "every thread issues the same copies");
#pragma unroll
  for (int i = 0; i < kTM * kXc / kSwThreads; ++i) {
    const int c = tid + i * kSwThreads;
    const int row = c / kXc, col = (c % kXc) * kXv;
    cp_async16(xs + row * S::kXPitch + col, x + row * d + k0 + col);
  }
#pragma unroll
  for (int i = 0; i < kTfK * kWc / kSwThreads; ++i) {
    const int c = tid + i * kSwThreads;
    const int row = c / kWc, col = (c % kWc) * kWv;
    cp_async16(ws + row * kTfN + col, w + (k0 + row) * f + col);
  }
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(kSwThreads, 1) grouped_matmul_tf32(const GroupedArgs r) {
  using S = SwSmem<TX, TW>;
  constexpr bool kSplitX = std::is_same<TX, float>::value;
  constexpr bool kSplitW = S::kSmallW;
  extern __shared__ unsigned char sw_raw[];
  // 1024-byte alignment: the 128-byte swizzle repeats every 8 rows
  unsigned char* panels = sw_raw + ((1024 - (smem_u32(sw_raw) & 1023)) & 1023);
  unsigned char* ring = panels + 2 * S::kPanelsBytes;
  const int tid = static_cast<int>(threadIdx.x);
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int wg = warp / 4;  // the warpgroup: token rows wg * 64 ..
  const int64_t tb = blockIdx.y;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kTfN;
  const int64_t e = block_expert_of(r, tb);
  const TX* x = static_cast<const TX*>(r.x) + tb * kTM * r.d;
  const TW* w = static_cast<const TW*>(r.w) + e * r.d * r.f + n0;
  const int nk = static_cast<int>(r.d / kTfK);
  // this lane's two x rows: g and g + 8 of its warp's 16
  const int xrow = wg * 64 + (warp % 4) * 16 + g;

  auto raw_x = [&](int kt) {
    return reinterpret_cast<const TX*>(ring + (kt % kSwStages) * S::kStageBytes);
  };
  auto raw_w = [&](int kt) {
    return reinterpret_cast<const TW*>(ring + (kt % kSwStages) * S::kStageBytes + S::kXBytes);
  };
  auto big_panel = [&](int kt) { return panels + (kt % 2) * S::kPanelsBytes; };

  sw_load(ring, x, w, r.d, r.f, 0, tid);
  cp_async_commit();
  if (nk > 1) sw_load(ring, x, w, r.d, r.f, 1, tid);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  rewrite_w(raw_w(0), big_panel(0), big_panel(0) + kPanelBytes, tid);
  fence_async_smem();
  __syncthreads();

  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    // A fragments of the four steps: a0 (g, 8 s + q), a1 (g + 8, 8 s + q),
    // a2 (g, 8 s + q + 4), a3 (g + 8, 8 s + q + 4) in panel positions
    float v0[8], v1[8];
    x_row8(raw_x(kt) + xrow * S::kXPitch, q, v0);
    x_row8(raw_x(kt) + (xrow + 8) * S::kXPitch, q, v1);
    uint32_t xb[4][4], xs[4][4];
#pragma unroll
    for (int st = 0; st < 4; ++st) {
      split_tf32<kSplitX>(v0[2 * st], xb[st][0], xs[st][0]);
      split_tf32<kSplitX>(v1[2 * st], xb[st][1], xs[st][1]);
      split_tf32<kSplitX>(v0[2 * st + 1], xb[st][2], xs[st][2]);
      split_tf32<kSplitX>(v1[2 * st + 1], xb[st][3], xs[st][3]);
    }
    const uint32_t pb = smem_u32(big_panel(kt));
    wgmma_fence();
#pragma unroll
    for (int st = 0; st < 4; ++st) {  // the small terms first; 8 d offsets, 32 bytes, a step
      const uint64_t db = gmma_desc(pb + st * 32, 16, 1024);
      if constexpr (kSplitX) wgmma_tf32(part, xs[st], db, st > 0);
      if constexpr (kSplitW)
        wgmma_tf32(part, xb[st], gmma_desc(pb + kPanelBytes + st * 32, 16, 1024),
                   kSplitX || st > 0);
      wgmma_tf32(part, xb[st], db, kSplitX || kSplitW || st > 0);
    }
    wgmma_commit();
    if (kt + 2 < nk) sw_load(ring, x, w, r.d, r.f, kt + 2, tid);  // into the slot of kt - 1
    cp_async_commit();
    if (kt + 1 < nk) {  // the next panels, while this stage's wgmmas run
      cp_async_wait<1>();
      __syncthreads();
      rewrite_w(raw_w(kt + 1), big_panel(kt + 1), big_panel(kt + 1) + kPanelBytes, tid);
      fence_async_smem();
    }
    wgmma_wait<0>();
    fence_regs(part);
    // the stage's products summed in `part`, then added in f32 (the tensor
    // cores' own adds truncate: over all of d they moved y by a relative
    // 1.4e-5 in one accumulator, where K7_FRO is 5e-6)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
    __syncthreads();  // the next panels are whole; this stage's slot and panels are free
  }
  cp_async_wait<0>();

  // acc[4j + 2h + c]: row xrow + 8h, column 8j + 2q + c
  TX* out = static_cast<TX*>(r.out) + tb * kTM * r.f + n0;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < kTfN / 8; ++j)
      store2(out + static_cast<int64_t>(xrow + 8 * h) * r.f + 8 * j + 2 * q, acc[4 * j + 2 * h],
             acc[4 * j + 2 * h + 1]);
}

template <typename TX, typename TW>
int launch_tf32(const GroupedArgs& r) {
  if (r.d % kTfK || r.f % kTfN || r.d > INT_MAX || r.f > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(r.x) | reinterpret_cast<uintptr_t>(r.w) |
       reinterpret_cast<uintptr_t>(r.out)) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  constexpr int smem = SwSmem<TX, TW>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(grouped_matmul_tf32<TX, TW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(r.f / kTfN), static_cast<unsigned>(r.t / kTM));
  grouped_matmul_tf32<TX, TW><<<grid, kSwThreads, smem, r.stream>>>(r);
  return static_cast<int>(cudaGetLastError());
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (CUDA's tensor-map encoder), through the runtime
// (no -lcuda).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    return cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
                       cudaSuccess &&
                   found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A tensor of 16-bit values as a TMA map of `rank` dimensions (innermost
// first, the innermost contiguous), boxes of 64 values (128 bytes, swizzled)
// x rows (x 1).
bool make_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type, int rank,
              const cuuint64_t* dims, cuuint32_t rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t strides[2] = {dims[0] * 2, dims[0] * dims[1] * 2};
  const cuuint32_t box[3] = {64, rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, type, rank, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
int launch_wg(const GroupedArgs& r) {
  if (r.d % kWgK || r.f % kWgN || r.d > INT_MAX || r.f > INT_MAX || r.t > INT_MAX ||
      r.e > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(r.x) | reinterpret_cast<uintptr_t>(r.w) |
       reinterpret_cast<uintptr_t>(r.out)) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const CUtensorMapDataType type = std::is_same<T, __nv_bfloat16>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  const cuuint64_t x_dims[2] = {static_cast<cuuint64_t>(r.d), static_cast<cuuint64_t>(r.t)};
  const cuuint64_t w_dims[3] = {static_cast<cuuint64_t>(r.f), static_cast<cuuint64_t>(r.d),
                                static_cast<cuuint64_t>(r.e)};
  CUtensorMap x_map, w_map;
  if (!make_map(&x_map, r.x, type, 2, x_dims, kTM) ||
      !make_map(&w_map, r.w, type, 3, w_dims, kWgK))
    return static_cast<int>(cudaErrorNotSupported);
  cudaError_t err = cudaFuncSetAttribute(grouped_matmul_wg<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(r.f / kWgN), static_cast<unsigned>(r.t / kTM));
  grouped_matmul_wg<T><<<grid, kWgThreads, kWgSmem, r.stream>>>(r, x_map, w_map);
  return static_cast<int>(cudaGetLastError());
}

enum class Variant { kNone, kFma, kWgmma, kTf32, kMma };

template <typename T>
constexpr int code_of() {
  return std::is_same<T, float>::value ? replay::kF32
                                       : (std::is_same<T, __half>::value ? replay::kF16
                                                                        : replay::kBF16);
}

// The variant for (x's dtype code, w's), the one rule: both bf16 or both f16
// -> wgmma; every other pair of known codes -> tf32. Builds for
// scripts/k7_variants.py, which compiles copies of this file to time the
// designs against each other (the port never builds or loads them):
// -DGROUPED_MATMUL_FORCE_VARIANT=1 runs every pair on fma,
// -DGROUPED_MATMUL_FORCE_VARIANT=2 runs the tf32 pairs on mma.
constexpr Variant variant_of(int x_code, int w_code) {
  const auto known = [](int c) {
    return c == replay::kF32 || c == replay::kF16 || c == replay::kBF16;
  };
  if (!known(x_code) || !known(w_code)) return Variant::kNone;
#if defined(GROUPED_MATMUL_FORCE_VARIANT) && GROUPED_MATMUL_FORCE_VARIANT == 1
  return Variant::kFma;
#else
  if (x_code == w_code && x_code != replay::kF32) return Variant::kWgmma;
#if defined(GROUPED_MATMUL_FORCE_VARIANT) && GROUPED_MATMUL_FORCE_VARIANT == 2
  return Variant::kMma;
#else
  return Variant::kTf32;
#endif
#endif
}

// Tensor-core products a block of the pair's variant issues for each product
// of the contract: 1 on wgmma, 1 + one for each f32 operand on tf32 and mma
// (its small part), 0 on fma and for what the launcher refuses.
constexpr int products_of(int x_code, int w_code) {
  switch (variant_of(x_code, w_code)) {
    case Variant::kWgmma: return 1;
    case Variant::kTf32:
    case Variant::kMma: return 1 + (x_code == replay::kF32) + (w_code == replay::kF32);
    default: return 0;
  }
}

template <typename TX, typename TW>
int launch_pair(const GroupedArgs& r) {
#if defined(GROUPED_MATMUL_FORCE_VARIANT) && GROUPED_MATMUL_FORCE_VARIANT == 1
  return launch_fma<TX, TW>(r);
#else
  constexpr Variant v = variant_of(code_of<TX>(), code_of<TW>());
  if constexpr (v == Variant::kWgmma) {
    return launch_wg<TX>(r);
  } else if constexpr (v == Variant::kMma) {
    return launch_mma<TX, TW>(r);
  } else {
    return launch_tf32<TX, TW>(r);
  }
#endif
}

template <typename TX>
int launch_x(const GroupedArgs& r, int w_code) {
  switch (w_code) {
    case replay::kF32: return launch_pair<TX, float>(r);
    case replay::kF16: return launch_pair<TX, __half>(r);
    case replay::kBF16: return launch_pair<TX, __nv_bfloat16>(r);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// int grouped_matmul_launch(x, x_code, w, w_code, block_expert, out, t, d, f,
//                           e, stream) -> cudaGetLastError();
//   cudaErrorInvalidValue unless t % 128 == 0, f % 128 == 0, e >= 1, d % 32
//   == 0 (d % 64 == 0 on the wgmma variant) and t / 128 <= 65,535, or for an
//   unknown dtype code; cudaErrorMisalignedAddress for an operand that is not
//   16-byte aligned.
extern "C" int grouped_matmul_launch(const void* x, int x_code, const void* w,
                                     int w_code, const int32_t* block_expert,
                                     void* out, int64_t t, int64_t d, int64_t f,
                                     int64_t e, void* stream) {
  if (t % kTM || f % 128 || e < 1 || d < kTfK || t / kTM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (t == 0 || f == 0) return static_cast<int>(cudaGetLastError());
  const GroupedArgs r{x, w, block_expert, out, t, d, f, e,
                      static_cast<cudaStream_t>(stream)};
  switch (x_code) {
    case replay::kF32: return launch_x<float>(r, w_code);
    case replay::kF16: return launch_x<__half>(r, w_code);
    case replay::kBF16: return launch_x<__nv_bfloat16>(r, w_code);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The variant that grouped_matmul_launch runs for (x's dtype code, w's):
// "wgmma", "tf32", "mma" or "fma" (forced builds), or "none" for what it
// refuses (variant_of).
extern "C" const char* grouped_matmul_variant(int x_code, int w_code) {
  switch (variant_of(x_code, w_code)) {
    case Variant::kFma: return "fma";
    case Variant::kWgmma: return "wgmma";
    case Variant::kTf32: return "tf32";
    case Variant::kMma: return "mma";
    case Variant::kNone: break;
  }
  return "none";
}

// The tensor-core products that variant takes for the pair (products_of).
extern "C" int grouped_matmul_products(int x_code, int w_code) {
  return products_of(x_code, w_code);
}

extern "C" const char* grouped_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
