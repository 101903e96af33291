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
// blocks) the bytes, just: 2 * T * d * f flops (127.6 GFLOP, 0.129 ms at
// 989 TFLOP/s in bf16) against T * d + E * d * f + T * f values (631 MB,
// 0.188 ms at 3.35 TB/s). Each weight tile serves the 128 tokens of a block,
// and the token blocks of one expert are adjacent, so they meet it in L2.
//
// Two variants, chosen by the dtype pair in variant_of, the one rule that the
// launcher and grouped_matmul_variant read; a failed launch is an error, never
// a fallback:
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
// "fma" -- every other pair (f32, mixed types). One thread block per (token
// block, 128-column f tile) whose loop over d takes the place of the TPU's
// sequential d axis. Each step stages a 128 x 16 slice of x (transposed) and
// a 16 x 128 slice of w in shared memory as f32, with 16-byte global loads;
// 256 threads each keep an 8 x 8 f32 tile of y in registers (rows ty*4 + i
// and 64 + ty*4 + i, columns tx*4 + j and 64 + tx*4 + j, so the shared-memory
// reads are conflict-free float4s) and add 64 FMAs per pair of fragments.
// f32 operands would be rounded by TF32 tensor cores; a bf16 x f16 pair is
// exact in TF32, a later step.
#include <climits>
#include <cstring>
#include <cuda.h>
#include <type_traits>

#include "replay_common.cuh"

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
// "fma": f32 FMAs over shared-memory tiles
// ---------------------------------------------------------------------------

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

enum class Variant { kNone, kFma, kWgmma };

// The variant for (x's dtype code, w's), the one rule: both bf16 or both f16
// -> wgmma; every other pair of known codes -> fma. A build with
// -DGROUPED_MATMUL_FORCE_VARIANT=1 runs bf16 and f16 on fma instead:
// scripts/k7_variants.py compiles such a library under another name to time
// the variants against each other; the port never builds or loads it.
constexpr Variant variant_of(int x_code, int w_code) {
  const auto known = [](int c) {
    return c == replay::kF32 || c == replay::kF16 || c == replay::kBF16;
  };
  if (!known(x_code) || !known(w_code)) return Variant::kNone;
  if (x_code != w_code || x_code == replay::kF32) return Variant::kFma;
#if defined(GROUPED_MATMUL_FORCE_VARIANT) && GROUPED_MATMUL_FORCE_VARIANT == 1
  return Variant::kFma;
#else
  return Variant::kWgmma;
#endif
}

template <typename TX, int kX>
int launch_x(const GroupedArgs& r, int w_code) {
  switch (w_code) {
    case replay::kF32: return launch_fma<TX, float>(r);
    case replay::kF16:
      if constexpr (variant_of(kX, replay::kF16) == Variant::kWgmma) return launch_wg<__half>(r);
      else return launch_fma<TX, __half>(r);
    case replay::kBF16:
      if constexpr (variant_of(kX, replay::kBF16) == Variant::kWgmma)
        return launch_wg<__nv_bfloat16>(r);
      else return launch_fma<TX, __nv_bfloat16>(r);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// int grouped_matmul_launch(x, x_code, w, w_code, block_expert, out, t, d, f,
//                           e, stream) -> cudaGetLastError();
//   cudaErrorInvalidValue unless t % 128 == 0, f % 128 == 0, e >= 1, d % 16
//   == 0 (d % 64 == 0 on the wgmma variant) and t / 128 <= 65,535, or for an
//   unknown dtype code; cudaErrorMisalignedAddress for a wgmma operand that is
//   not 16-byte aligned.
extern "C" int grouped_matmul_launch(const void* x, int x_code, const void* w,
                                     int w_code, const int32_t* block_expert,
                                     void* out, int64_t t, int64_t d, int64_t f,
                                     int64_t e, void* stream) {
  if (t % kTM || f % kTN || e < 1 || d < kTK || t / kTM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (t == 0 || f == 0) return static_cast<int>(cudaGetLastError());
  const GroupedArgs r{x, w, block_expert, out, t, d, f, e,
                      static_cast<cudaStream_t>(stream)};
  switch (x_code) {
    case replay::kF32: return launch_x<float, replay::kF32>(r, w_code);
    case replay::kF16: return launch_x<__half, replay::kF16>(r, w_code);
    case replay::kBF16: return launch_x<__nv_bfloat16, replay::kBF16>(r, w_code);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The variant that grouped_matmul_launch runs for (x's dtype code, w's):
// "wgmma", "fma", or "none" for what it refuses (variant_of).
extern "C" const char* grouped_matmul_variant(int x_code, int w_code) {
  switch (variant_of(x_code, w_code)) {
    case Variant::kFma: return "fma";
    case Variant::kWgmma: return "wgmma";
    case Variant::kNone: break;
  }
  return "none";
}

extern "C" const char* grouped_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
