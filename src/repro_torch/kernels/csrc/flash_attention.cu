// flash_attention: blocked online-softmax attention with GQA, sliding window
// and logit softcap, on Hopper (sm_90a). An FA2/FA3-style forward.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention, body _kernel). For query head h (KV head h / group) and
// query row i:
//   s_ij = (q_i . k_j) * scale, scale = 1 / sqrt(D);
//   s_ij = tanh(s_ij / softcap) * softcap            (where softcap is set);
//   s_ij = -1e30 where (causal and i < j) or (window and i - j >= window);
//   out_i = softmax_j(s_ij) @ V                      (in q's dtype)
// with f32 scores, f32 statistics and f32 sums. The masked score is the
// finite -1e30 of both reference implementations, and the running max starts
// at -1e30 too: a KV tile that is fully masked before a row's first live key
// adds p = 1 terms that the next live tile wipes (alpha = exp(-1e30 - m) =
// 0), and a row with no live key at all ends as the mean of V, as in the
// reference. -INFINITY would give exp(-inf + inf) = NaN there. Keys past the
// end of the sequence (a ragged last tile) get -INFINITY and weigh exactly 0.
// The causal mask is top-left aligned (query i, key j, no offset when
// Tq != Tk). A KV tile is skipped only where no row concerned can see it and
// every such row has a live key somewhere, so the wipe stays exact and a row
// without live keys still sees every tile.
//
// What bounds it: operations, 4 * D flops per live (query, key) pair of each
// head against (Hq * Tq + 2 * Hkv * Tk) * D values read once and Hq * Tq * D
// written; in bf16/f16 at 989 TFLOP/s of tensor cores, in f32 three TF32
// products of that work at 495 TFLOP/s ("tf32", below; f32 FMAs at 67 TFLOP/s
// on "fma").
//
// Four variants, chosen by (dtype, D) in variant_of, the one rule that the
// launcher and flash_attention_variant read; a failed launch is an error,
// never a fallback:
//
// "wgmma" -- bf16 and f16 at D = 64, 128, 256. One block of two warpgroups per
// (128-row query tile, query head), each warpgroup 64 rows. Blocks run
// head-fastest with the query tiles in reverse, so the causal tiles with the
// most keys start first and the heads of one KV group run side by side (their
// K/V tiles are shared in L2). TMA copies Q once and K and V in 64-key stages
// (two of each) into shared memory, 128-byte swizzled in 64-column panels,
// each stage counted on an mbarrier; the last of the eight warps to release a
// stage refills it (a shared-memory counter), so no warp is a producer and
// the block's 256 threads keep a 255-register budget (a producer warpgroup
// made ptxas budget 168 registers a thread, setmaxnreg notwithstanding, and
// spill). Per stage a warpgroup starts O += P_{i-1} V_{i-1} (A = P from
// registers, V read MN-major) and then S_i = Q K_i^T (Q and K from shared
// memory), f32 accumulators, and runs the softmax of S_i in registers when
// both are done: started the other way round, the register-A wgmma makes ptxas
// serialise every wgmma of the kernel (note C7513). At D <= 128 two blocks
// share an SM (128 registers a thread; ptxas notes C7512 at D = 128 but it is
// the faster choice), so one block's softmax runs beside the other's wgmmas.
// 197,688 bytes of shared memory at D = 256 (cudaFuncSetAttribute).
//
// "mma" -- bf16 and f16 at D = 16, 32 (wgmma needs 64-column panels).
// mma.sync.m16n8k16 with f32 accumulators; one block of 8 warps per (128-row
// query tile, head), 16 query rows a warp, Q fragments in registers
// (ldmatrix once), K/V tiles of 64 keys double-buffered with 16-byte
// cp.async while the previous tile computes (one barrier a tile), rows padded
// by 16 bytes so that an ldmatrix's eight rows fall in distinct banks; a warp
// skips the MMAs of a tile none of its rows can see.
//
// Both tensor-core variants keep S, the softmax and O in registers: scale,
// softcap and masks on the scores, the row max over the four lanes of a row
// (shuffles), p = 2^(s - m) and alpha in the log2 domain (log2(e) folded
// into the scale; on tiles every row sees whole, with no softcap, into one
// FMA). P is rounded to the input dtype in registers and fed straight back
// as the A operand of O += P V; the reference keeps P in f32. That rounding
// (8 bits of mantissa in bf16, 11 in f16) is the one departure from the
// reference's f32 arithmetic that shows: the softcap's tanh comes from
// ex2.approx and rcp.approx (cap_tanh), about 1e-7 from tanhf in absolute
// terms. The row sums stay f32 and unrounded. chip_smoke.py holds every
// output to the reference tests' tolerance (5e-2, rtol and atol) and to a
// relative Frobenius error of 1e-2 in bf16 and 2e-3 in f16, with q and k
// scaled by 8 in some cases so that the softcap's tanh saturates.
//
// "tf32" -- f32 at D = 64, 128, 256, on tensor cores in split TF32
// (tf32_split.cuh): each f32 operand v is big = tf32(v) plus small =
// tf32(v - big), and a product is three TF32 products, small terms first,
// as * bb + ab * bs + ab * bb, for S = Q K^T and for P V alike; the scores,
// the softmax and O stay f32. wgmma's TF32 form takes both operands K-major:
// K is (for S), V is not. So a pre-pass kernel (split_kv_tf32, in the same
// launch) splits K and V once a call into device scratch: K's big and small
// parts as K lies, V^T's transposed, with each 8-key group of a row in
// kv_perm order so that the S accumulator's registers are P's A fragment as
// they stand. The attention kernel then copies each key stage's panels with
// TMA (128-byte swizzle) into single K and V^T buffers in shared memory, a
// stage ahead on mbarriers: K for stage i + 1 once every S of stage i is
// done, V^T for i + 1 once every P V of i is. (Splitting each stage in every
// block instead, from global loads or a cp.async staging area, was slower at
// every D: every 64 or 128 query rows re-split the same K and V; PERF.md.) The
// tensor cores' own adds truncate, so no accumulator sums for long: S is
// summed a 32-column panel of D at a time into a fresh accumulator (12
// products) and the parts added in f32, and each key stage's P V goes to a
// fresh accumulator folded as O = alpha O + P V in f32 (one accumulator
// across the stages moved K7's f32 outputs by 1.4e-5, PR 29). Q sits in
// shared memory as f32, laid out so that a lane's A-fragment values of a
// panel are 8 consecutive floats, and is split into registers panel by panel
// each stage (A from registers). Two warpgroups a block, one block an SM.
// D = 64 and 128 ("rows"): each warpgroup takes 64 query rows of a 128-row
// tile and all of D; 64 keys a stage. D = 256 ("pair"): O alone takes 128
// registers a thread for 64 rows and all of D, so both warpgroups take the
// same 64 rows, each half of D for S (the partial scores added through
// shared memory, so that both hold the same scores and run the same
// softmax) and half of O's columns; 32 keys a stage, 222,224 bytes of shared
// memory. The softcap is cap_tanh (below), as in bf16/f16. No instantiation
// spills (chip_smoke.py phase 1 fails if one does).
//
// "fma" -- f32 at D = 16 and 32 (PR 13's design, and every dtype at every
// D in a build with -DFLASH_ATTENTION_FORCE_VARIANT=1): f32 FMAs, no tensor
// cores. One block of 256 threads per (64-row query tile, head); the Q, K, V
// and score tiles sit in shared memory as f32, rows padded by one word (210
// KiB at D = 256); per KV tile S = Q K^T (4 x 4 scores a thread), scale,
// softcap and mask, four threads per row for the row max and sum, O = alpha O
// + P V with f32 FMAs (4 rows x D / 16 columns a thread in registers).
#include <climits>
#include <cmath>
#include <cstring>
#include <cuda.h>
#include <type_traits>

#include "replay_common.cuh"
#include "tf32_split.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: f32 FMAs over shared-memory tiles
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr float kMasked = -1e30f;

struct AttnArgs {
  const void* q;  // (hq, tq, d)
  const void* k;  // (hkv, tk, d)
  const void* v;  // (hkv, tk, d)
  void* out;      // (hq, tq, d)
  int64_t hq, hkv, tq, tk;
  float scale;
  int causal;
  int has_window;
  int64_t window;
  float softcap;  // 0: none
  cudaStream_t stream;
};

template <int D>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(float)) *
         ((kBQ + 2 * kBK) * (D + 1) + kBQ * (kBK + 1) + 3 * kBQ);
}

// Live keys of query row i: [lo_i, hi_i] (empty when lo_i > hi_i).
__device__ __forceinline__ int64_t live_lo(const AttnArgs& r, int64_t i) {
  if (!r.has_window) return 0;
  const int64_t lo = i - r.window + 1;
  return lo < 0 ? 0 : lo;
}
__device__ __forceinline__ int64_t live_hi(const AttnArgs& r, int64_t i) {
  return r.causal && i < r.tk - 1 ? i : r.tk - 1;
}

// Copies rows [row0, row0 + rows) of a (n, D) matrix into a (rows, D + 1)
// f32 tile; rows past n are 0.
template <int D, typename T>
__device__ __forceinline__ void load_tile(const T* src, int64_t row0, int64_t n,
                                          int rows, float* dst) {
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int rr = idx / D;
    const int c = idx % D;
    dst[rr * (D + 1) + c] =
        row0 + rr < n ? replay::load_val(src, (row0 + rr) * D + c) : 0.f;
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(const AttnArgs r) {
  constexpr int LD = D + 1;
  constexpr int SLD = kBK + 1;
  constexpr int kCols = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBQ * LD;
  float* vs = ks + kBK * LD;
  float* ss = vs + kBK * LD;
  float* m_s = ss + kBQ * SLD;
  float* l_s = m_s + kBQ;
  float* a_s = l_s + kBQ;

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int64_t h = blockIdx.y;
  const int64_t hk = h / (r.hq / r.hkv);
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kBQ;
  const T* q = static_cast<const T*>(r.q) + h * r.tq * D;
  const T* k = static_cast<const T*>(r.k) + hk * r.tk * D;
  const T* v = static_cast<const T*>(r.v) + hk * r.tk * D;

  load_tile<D>(q, q0, r.tq, kBQ, qs);
  if (tid < kBQ) {
    m_s[tid] = kMasked;
    l_s[tid] = 0.f;
  }
  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  // the KV tiles to visit: all of them, or only those that some row can see
  // when every row of this query tile has a live key (the emptiest rows are
  // the first and the last: lo - hi is non-increasing, then increasing)
  const int64_t n_tiles = (r.tk + kBK - 1) / kBK;
  const int64_t q_last = (q0 + kBQ < r.tq ? q0 + kBQ : r.tq) - 1;
  int64_t t_lo = 0, t_hi = n_tiles;
  if (live_lo(r, q0) <= live_hi(r, q0) && live_lo(r, q_last) <= live_hi(r, q_last)) {
    t_lo = live_lo(r, q0) / kBK;
    t_hi = live_hi(r, q_last) / kBK + 1;
  }

  for (int64_t kt = t_lo; kt < t_hi; ++kt) {
    const int64_t k0 = kt * kBK;
    load_tile<D>(k, k0, r.tk, kBK, ks);
    load_tile<D>(v, k0, r.tk, kBK, vs);
    __syncthreads();
    // S = Q K^T: rows ty + 16 i, columns tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * LD + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ks[(tx + 16 * j) * LD + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t qi = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t kj = k0 + tx + 16 * j;
        float x = s[i][j] * r.scale;
        if (r.softcap != 0.f) x = tanhf(x / r.softcap) * r.softcap;
        if (kj >= r.tk) {
          x = -INFINITY;
        } else if ((r.causal && qi < kj) || (r.has_window && qi - kj >= r.window)) {
          x = kMasked;
        }
        ss[(ty + 16 * i) * SLD + tx + 16 * j] = x;
      }
    }
    __syncthreads();
    // online softmax: four neighbouring lanes per row, 16 scores each
    {
      const int row = tid / 4;
      const int part = tid % 4;
      float* srow = ss + row * SLD + part * 16;
      const float m_prev = m_s[row];
      float mx = kMasked;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, srow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = __expf(srow[c] - m_new);
        srow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = __expf(m_prev - m_new);
        a_s[row] = alpha;
        l_s[row] = l_s[row] * alpha + sum;
        m_s[row] = m_new;
      }
    }
    __syncthreads();
    // O = alpha O + P V: rows ty + 16 i, columns tx + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ss[(ty + 16 * i) * SLD + kk];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float vv = vs[kk * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
    __syncthreads();  // the K, V and score tiles are rewritten next
  }

  T* out = static_cast<T*>(r.out) + h * r.tq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t qi = q0 + ty + 16 * i;
    if (qi >= r.tq) continue;
    float l = l_s[ty + 16 * i];
    l = l == 0.f ? 1.f : l;
#pragma unroll
    for (int j = 0; j < kCols; ++j) replay::store_val(out, qi * D + tx + 16 * j, acc[i][j] / l);
  }
}

// ---------------------------------------------------------------------------
// bf16 / f16: tensor cores (mma.sync.m16n8k16, f32 accumulators)
// ---------------------------------------------------------------------------

constexpr int kMmaBQ = 128;  // query rows a block
constexpr int kMmaBK = 64;   // keys a tile

constexpr int kMmaThreads = 256;  // 8 warps of 16 query rows

template <int D>
struct MmaTile {
  static constexpr int kLd = D + 8;  // row pitch in elements: 16 bytes of padding
  // two blocks an SM up to D = 64 (128 registers a thread); above, one
  static constexpr int kMinBlocks = D <= 64 ? 2 : 1;
  static constexpr int kSmem = (kMmaBQ + 4 * kMmaBK) * kLd * 2;  // Q, 2 x K, 2 x V
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !full.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8 x 8 b16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&x)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&x)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
               : "r"(smem_u32(p)));
}

// d += a (16 x 16, row) * b (16 x 8, col), f32 accumulators.
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

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

// Rows [row0, row0 + ROWS) of a (n, D) matrix into a (ROWS, kLd) tile with
// 16-byte cp.async copies; rows past n are zero-filled.
template <int D, int ROWS, typename T>
__device__ __forceinline__ void load_rows_async(T* dst, const T* src, int64_t row0, int64_t n) {
  constexpr int kChunks = D / 8;
  constexpr int kTotal = ROWS * kChunks;
  constexpr int kLd = MmaTile<D>::kLd;
#pragma unroll
  for (int it = 0; it < (kTotal + kMmaThreads - 1) / kMmaThreads; ++it) {
    const int idx = it * kMmaThreads + static_cast<int>(threadIdx.x);
    if (kTotal % kMmaThreads == 0 || idx < kTotal) {
      const int rr = idx / kChunks;
      const int c = idx % kChunks;
      const bool ok = row0 + rr < n;
      cp_async16(dst + rr * kLd + c * 8, ok ? src + (row0 + rr) * D + c * 8 : src, ok);
    }
  }
}

__device__ __forceinline__ bool has_live(const AttnArgs& r, int64_t i) {
  return live_lo(r, i) <= live_hi(r, i);
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x in one MUFU op (ex2.approx: 2^-22 relative error; -inf -> 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 1 / x in one MUFU op (rcp.approx: about 2^-23 relative error; inf -> 0).
__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// c * tanh(x) for y = 2 x log2(e): c (1 - 2 / (2^y + 1)), two MUFU ops and an
// FMA. Its absolute error is about 1e-7 over the whole range (2^y overflows
// to inf for large x, giving c; underflows to 0 for very negative x, giving
// -c), so at softcap 50 a logit moves by about 1e-5. tanh.approx.f32 (one
// MUFU op, relative error up to 2^-11) would move saturated logits by up to
// 0.024 and the outputs by about 1% where the softcap decides them.
__device__ __forceinline__ float cap_tanh(float y, float c) {
  return fmaf(-2.f * c, rcp(ex2(y) + 1.f), c);
}

// The scores of one 16-row MMA tile (an m16n8 accumulator per 8 keys: this
// lane holds rows row (e < 2) and row + 8 (e >= 2), keys key + 8 j + e % 2)
// become logits in the log2 domain, s * log2(e): scale, softcap, then the
// masks (-1e30 masked, -inf past Tk). exp2 of a log2-domain difference is
// exp of the natural one, and a masked logit stays -1e30 in either domain,
// so the wipe of masked tiles and the mean of V for rows with no live key
// are unchanged. Tiles that every row sees whole (`whole`) skip the masks.
template <int kNt>
__device__ __forceinline__ void to_logits(float (&s)[kNt][4], const AttnArgs& r, bool whole,
                                          int64_t row, int64_t key) {
  const bool cap = r.softcap != 0.f;
  const float pre = cap ? r.scale * (2.f * kLog2e) / r.softcap : r.scale * kLog2e;
  const float post = r.softcap * kLog2e;
#pragma unroll
  for (int j = 0; j < kNt; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e] * pre;
      if (cap) x = cap_tanh(x, post);
      if (!whole) {
        const int64_t qi = row + (e / 2) * 8;
        const int64_t kj = key + j * 8 + (e % 2);
        if (kj >= r.tk) {
          x = -INFINITY;
        } else if ((r.causal && qi < kj) || (r.has_window && qi - kj >= r.window)) {
          x = kMasked;
        }
      }
      s[j][e] = x;
    }
}

// One step of the online softmax for a 16-row tile of log2-domain logits
// pre * s (pre = 1: s are logits already): the row max over this lane's keys
// (a tree) and the four lanes of the row (shuffles), alpha = 2^(m_old - m)
// (by which O must be scaled), p = 2^(pre * s - m) in one FMA, left in s,
// and this lane's part of the row sum.
template <int kNt>
__device__ __forceinline__ void softmax_rows(float (&s)[kNt][4], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float pre = 1.f) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float t[kNt];
#pragma unroll
    for (int j = 0; j < kNt; ++j) t[j] = fmaxf(s[j][2 * hf], s[j][2 * hf + 1]);
#pragma unroll
    for (int w = kNt / 2; w >= 1; w /= 2)
#pragma unroll
      for (int j = 0; j < w; ++j) t[j] = fmaxf(t[j], t[j + w]);
    float mx = fmaxf(m[hf], t[0] * pre);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    alpha[hf] = ex2(m[hf] - mx);
    m[hf] = mx;
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
      s[j][2 * hf] = ex2(fmaf(s[j][2 * hf], pre, -mx));
      s[j][2 * hf + 1] = ex2(fmaf(s[j][2 * hf + 1], pre, -mx));
      t[j] = s[j][2 * hf] + s[j][2 * hf + 1];
    }
#pragma unroll
    for (int w = kNt / 2; w >= 1; w /= 2)
#pragma unroll
      for (int j = 0; j < w; ++j) t[j] += t[j + w];
    l[hf] = l[hf] * alpha[hf] + t[0];
  }
}

// softmax_rows, then P rounded to T and packed as m16n8k16 A fragments
// (score tiles 2 kk and 2 kk + 1 form fragment kk; the same layout serves
// wgmma's register A).
template <typename T, int kNt>
__device__ __forceinline__ void online_softmax(float (&s)[kNt][4], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], uint32_t (&pf)[kNt / 2][4],
                                               float pre = 1.f) {
  softmax_rows(s, m, l, alpha, pre);
#pragma unroll
  for (int kk = 0; kk < kNt / 2; ++kk) {
    pf[kk][0] = pack2<T>(s[2 * kk][0], s[2 * kk][1]);
    pf[kk][1] = pack2<T>(s[2 * kk][2], s[2 * kk][3]);
    pf[kk][2] = pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    pf[kk][3] = pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// O *= alpha, row by row (rows lane / 4 and lane / 4 + 8 of the tile).
template <int kDt>
__device__ __forceinline__ void rescale(float (&o)[kDt][4], const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < kDt; ++j) {
    o[j][0] *= alpha[0];
    o[j][1] *= alpha[0];
    o[j][2] *= alpha[1];
    o[j][3] *= alpha[1];
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kMmaThreads, MmaTile<D>::kMinBlocks)
    flash_attention_mma(const AttnArgs r) {
  constexpr int kLd = MmaTile<D>::kLd;
  constexpr int kNt = kMmaBK / 8;  // score column tiles (8 keys)
  constexpr int kDt = D / 8;       // output column tiles
  constexpr int kKs = D / 16;      // k steps of S = Q K^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + kMmaBQ * kLd;      // two K tiles
  T* vs = ks + 2 * kMmaBK * kLd;  // two V tiles

  const int warp = static_cast<int>(threadIdx.x) / 32;
  const int lane = static_cast<int>(threadIdx.x) % 32;
  const int64_t h = blockIdx.x;
  const int64_t hk = h / (r.hq / r.hkv);
  // query tiles in reverse: under a causal mask the last tiles see the most keys
  const int64_t q0 = static_cast<int64_t>(gridDim.y - 1 - blockIdx.y) * kMmaBQ;
  const T* q = static_cast<const T*>(r.q) + h * r.tq * D;
  const T* k = static_cast<const T*>(r.k) + hk * r.tk * D;
  const T* v = static_cast<const T*>(r.v) + hk * r.tk * D;

  // the block's KV tiles: all, or only those that some row can see when
  // every row of the query tile has a live key (the emptiest rows are the
  // first and the last: lo - hi is non-increasing, then increasing)
  const int64_t n_tiles = (r.tk + kMmaBK - 1) / kMmaBK;
  const int64_t q_last = (q0 + kMmaBQ < r.tq ? q0 + kMmaBQ : r.tq) - 1;
  int64_t t_lo = 0, t_hi = n_tiles;
  if (has_live(r, q0) && has_live(r, q_last)) {
    t_lo = live_lo(r, q0) / kMmaBK;
    t_hi = live_hi(r, q_last) / kMmaBK + 1;
  }
  // this warp's rows [w0, w1]; lo and hi are non-decreasing in the row, so
  // [lo(w0), hi(w1)] holds every key some row sees and [lo(w1), hi(w0)] the
  // keys that every row sees
  const int64_t w0 = q0 + warp * 16;
  const int64_t w1 = (w0 + 15 < r.tq ? w0 + 15 : r.tq - 1);
  const bool active = w0 < r.tq;
  const bool all_live = active && has_live(r, w0) && has_live(r, w1);
  const int64_t seen_lo = live_lo(r, w0), seen_hi = live_hi(r, w1);
  const int64_t whole_lo = live_lo(r, w1), whole_hi = live_hi(r, w0);

  load_rows_async<D, kMmaBQ>(qs, q, q0, r.tq);
  load_rows_async<D, kMmaBK>(ks, k, t_lo * kMmaBK, r.tk);
  load_rows_async<D, kMmaBK>(vs, v, t_lo * kMmaBK, r.tk);
  cp_async_commit();

  uint32_t qf[kKs][4];  // this warp's Q fragments, loaded once
  float o[kDt][4];
#pragma unroll
  for (int j = 0; j < kDt; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {kMasked, kMasked};
  float l[2] = {0.f, 0.f};  // this lane's part of the row sums
  // ldmatrix row addresses of this lane (see the m16n8k16 fragment layouts)
  const T* q_lane = qs + (warp * 16 + lane % 16) * kLd + (lane / 16) * 8;
  const int k_lane = ((lane % 8) + (lane / 16) * 8) * kLd + ((lane / 8) % 2) * 8;
  const int v_lane = (lane % 16) * kLd + (lane / 16) * 8;

  for (int64_t kt = t_lo; kt < t_hi; ++kt) {
    cp_async_wait_all();
    __syncthreads();  // tile kt has landed, and every warp is done with tile kt - 1
    const int buf = static_cast<int>((kt - t_lo) & 1);
    if (kt + 1 < t_hi) {
      load_rows_async<D, kMmaBK>(ks + (buf ^ 1) * kMmaBK * kLd, k, (kt + 1) * kMmaBK, r.tk);
      load_rows_async<D, kMmaBK>(vs + (buf ^ 1) * kMmaBK * kLd, v, (kt + 1) * kMmaBK, r.tk);
    }
    cp_async_commit();
    if (kt == t_lo) {
#pragma unroll
      for (int kk = 0; kk < kKs; ++kk) ldsm_x4(qf[kk], q_lane + kk * 16);
    }
    const int64_t k0 = kt * kMmaBK;
    if (!active || (all_live && (k0 > seen_hi || k0 + kMmaBK - 1 < seen_lo))) continue;
    const T* kb = ks + buf * kMmaBK * kLd;
    const T* vb = vs + buf * kMmaBK * kLd;

    // S = Q K^T: rows lane / 4 (+ 8), keys 8 j + 2 (lane % 4) (+ 1)
    float s[kNt][4];
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKs; ++kk) {
#pragma unroll
      for (int jn = 0; jn < kNt / 2; ++jn) {
        uint32_t b[4];
        ldsm_x4(b, kb + jn * 16 * kLd + k_lane + kk * 16);
        mma16816<T>(s[2 * jn], qf[kk], b[0], b[1]);
        mma16816<T>(s[2 * jn + 1], qf[kk], b[2], b[3]);
      }
    }

    // scale, softcap and mask in registers, then the online softmax; P comes
    // out rounded to T as the A operand of O += P V
    const bool whole = k0 + kMmaBK <= r.tk && whole_lo <= k0 && whole_hi >= k0 + kMmaBK - 1;
    uint32_t pf[kNt / 2][4];
    float alpha[2];
    to_logits(s, r, whole, w0 + lane / 4, k0 + (lane % 4) * 2);
    online_softmax<T>(s, m, l, alpha, pf);
    rescale(o, alpha);

    // O += P V (V through ldmatrix.trans)
#pragma unroll
    for (int kk = 0; kk < kNt / 2; ++kk) {
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t b[4];
        ldsm_x4_trans(b, vb + kk * 16 * kLd + v_lane + dn * 16);
        mma16816<T>(o[2 * dn], pf[kk], b[0], b[1]);
        mma16816<T>(o[2 * dn + 1], pf[kk], b[2], b[3]);
      }
    }
  }

  if (!active) return;
  T* out = static_cast<T*>(r.out) + h * r.tq * D;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float lt = l[hf];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float inv = 1.f / (lt == 0.f ? 1.f : lt);
    const int64_t qi = w0 + lane / 4 + hf * 8;
    if (qi < r.tq) {
#pragma unroll
      for (int j = 0; j < kDt; ++j)
        *reinterpret_cast<uint32_t*>(out + qi * D + j * 8 + (lane % 4) * 2) =
            pack2<T>(o[j][2 * hf] * inv, o[j][2 * hf + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 / f16 at D = 64, 128, 256: wgmma with TMA-fed K/V stages
// ---------------------------------------------------------------------------

template <int D>
struct WgTile {
  static constexpr int kBQ = 128;  // query rows: two warpgroups of 64
  static constexpr int kBK = 64;   // keys a stage
  static constexpr int kStages = 2;
  static constexpr int kThreads = 2 * 128;
  // two blocks an SM at D <= 128 (128 registers a thread): while one runs its
  // softmax, the other's wgmmas keep the tensor cores busy
  static constexpr int kMinBlocks = D <= 128 ? 2 : 1;
  static constexpr int kQBytes = kBQ * D * 2;     // D / 64 panels of kBQ rows x 128 bytes
  static constexpr int kTileBytes = kBK * D * 2;  // one K or V stage, in panels too
  static constexpr int kSmem = 1024 + kQBytes + 2 * kStages * kTileBytes + 8 * (1 + 3 * kStages);
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
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

// One box of the 3-D map (64 columns x rows x 1 head) at (c0, c1, c2) into
// shared memory, counted on bar's transaction bytes.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                         uint64_t* bar) {
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
// Pins registers that an in-flight wgmma reads or writes: the compiler may
// neither move their uses across this point nor reuse them before it.
template <int N, int M>
__device__ __forceinline__ void fence_regs(float (&x)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+f"(x[i][j])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}
template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&x)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(x[i][j])::"memory");
}

// D (64 x N, f32) (+)= A (64 x 16) * B (16 x N): A and B K-major in shared memory
// (128-byte swizzle); scale_d = 0 overwrites D.
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
}

// D (64 x N, f32) += A (64 x 16, this warp's m16n8k16 A fragment) * B (16 x N),
// B MN-major in shared memory (128-byte swizzle, read transposed).
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
}

template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
}

template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
}


// S = Q K^T for the 64 rows of a warpgroup and the kBK keys of a stage: D /
// 16 k steps of 16 columns, 32 bytes into a 128-byte row, panel by panel.
template <int D, int kBK, int kBQ, typename T>
__device__ __forceinline__ void gemm_qk(float (&s)[kBK / 8][4], uint64_t q_desc, uint64_t k_desc) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<T>(reinterpret_cast<float(&)[kBK / 2]>(s),
                q_desc + (((kk / 4) * kBQ * 128 + (kk % 4) * 32) >> 4),
                k_desc + (((kk / 4) * kBK * 128 + (kk % 4) * 32) >> 4), kk > 0);
  wgmma_commit();
}

// O += P V: 16 keys a step (16 V rows of 128 bytes), the D columns across
// panels kBK * 128 bytes apart (V read MN-major).
template <int D, int kBK, typename T>
__device__ __forceinline__ void gemm_pv(float (&o)[D / 8][4], const uint32_t (&pf)[kBK / 16][4],
                                         uint64_t v_desc) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    wgmma_rs<T>(reinterpret_cast<float(&)[D / 2]>(o), pf[kk], v_desc + ((kk * 16 * 128) >> 4), 1);
  wgmma_commit();
}

// A ring of K or V stages: the TMA map, the stage buffers, their "full"
// barriers (the copy has landed) and release counters.
struct Ring {
  const CUtensorMap* map;
  unsigned char* buf;
  uint64_t* full;
  uint32_t* released;
};

// Copies tile `i` of the block (key rows (t_lo + i) * kBK on) into stage
// i % kStages, panel by panel, counted on the stage's full barrier.
template <int D>
__device__ __forceinline__ void load_stage(const Ring& ring, int64_t i, int64_t t_lo, int64_t hk) {
  using Tile = WgTile<D>;
  const int st = static_cast<int>(i % Tile::kStages);
  const int k0 = static_cast<int>((t_lo + i) * Tile::kBK);
  mbar_expect_tx(ring.full + st, Tile::kTileBytes);
  for (int p = 0; p < D / 64; ++p)
    tma_load(ring.buf + st * Tile::kTileBytes + p * Tile::kBK * 128, ring.map, p * 64, k0,
             static_cast<int>(hk), ring.full + st);
}

// One warpgroup's 64 query rows [g0, g1] of flash_attention_wg; this warp's
// 16 start at w0. Step i starts O += P_{i-1} V_{i-1}, then S_i = Q K_i^T,
// waits for both, and runs the softmax of S_i. P V goes first: started after
// S, the register-A wgmma makes ptxas serialise every wgmma of the kernel
// (its C7513 note).
template <int D, typename T>
__device__ __forceinline__ void consume(const AttnArgs& r, uint32_t q_addr, uint64_t* q_full,
                                        const Ring& kr, const Ring& vr, int64_t q0, int64_t t_lo,
                                        int64_t n, int wg, int warp, int lane, int64_t h,
                                        int64_t hk) {
  using Tile = WgTile<D>;
  constexpr int kBK = Tile::kBK;
  constexpr int kS = Tile::kStages;
  constexpr int kNt = kBK / 8;  // score column tiles (8 keys)
  constexpr int kDt = D / 8;    // output column tiles
  const int64_t g0 = q0 + wg * 64;
  const int64_t g1 = (g0 + 63 < r.tq ? g0 + 63 : r.tq - 1);
  const int64_t w0 = g0 + (warp % 4) * 16;
  const bool active = g0 < r.tq;
  const int64_t whole_lo = live_lo(r, g1), whole_hi = live_hi(r, g0);
  // the stages this warpgroup computes, [c_lo, c_hi): those some row sees,
  // or all when a row has no live key; it only releases the others
  int64_t c_lo = 0, c_hi = active ? n : 0;
  if (active && has_live(r, g0) && has_live(r, g1)) {
    const int64_t lo = live_lo(r, g0) / kBK - t_lo, hi = live_hi(r, g1) / kBK - t_lo + 1;
    c_lo = lo > 0 ? lo : 0;
    c_hi = hi < n ? hi : n;
    if (c_lo > c_hi) c_lo = c_hi;
  }
  // descriptors of Q (this warpgroup's rows) and of the K and V stages of tile i
  const uint64_t q_desc = gmma_desc(q_addr, 16, 1024);
  auto k_desc = [&](int64_t i) {
    return gmma_desc(smem_u32(kr.buf) + static_cast<int>(i % kS) * Tile::kTileBytes, 16, 1024);
  };
  auto v_desc = [&](int64_t i) {
    return gmma_desc(smem_u32(vr.buf) + static_cast<int>(i % kS) * Tile::kTileBytes, kBK * 128,
                     1024);
  };
  auto wait = [](const Ring& ring, int64_t i) {
    mbar_wait(ring.full + i % kS, static_cast<uint32_t>((i / kS) & 1));
  };
  // this warp is done with stage i; the last of the 8 warps to say so refills
  // it with tile i + kS
  auto release = [&](const Ring& ring, int64_t i) {
    __syncwarp();
    if (lane == 0 && atomicAdd(ring.released + i % kS, 1u) % 8 == 7 && i + kS < n)
      load_stage<D>(ring, i + kS, t_lo, hk);
  };

  float o[kDt][4];
#pragma unroll
  for (int j = 0; j < kDt; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {kMasked, kMasked};
  float l[2] = {0.f, 0.f};  // this lane's part of the row sums
  float alpha[2];
  float s[kNt][4];
  uint32_t pf[kNt / 2][4];
  // the softmax of tile i into pf; a tile that every row sees whole, with no
  // softcap, takes the scale inside the exponent: the max over raw scores
  // (the scale is positive), p = 2^(s * scale * log2(e) - m) in one FMA
  auto softmax = [&](int64_t i) {
    const int64_t k0 = (t_lo + i) * kBK;
    const bool whole = k0 + kBK <= r.tk && whole_lo <= k0 && whole_hi >= k0 + kBK - 1;
    if (whole && r.softcap == 0.f) {
      online_softmax<T>(s, m, l, alpha, pf, r.scale * kLog2e);
    } else {
      to_logits(s, r, whole, w0 + lane / 4, k0 + (lane % 4) * 2);
      online_softmax<T>(s, m, l, alpha, pf);
    }
  };
  auto skip = [&](int64_t i) {  // a stage this warpgroup does not compute
    wait(kr, i);
    release(kr, i);
    wait(vr, i);
    release(vr, i);
  };

  mbar_wait(q_full, 0);
  for (int64_t i = 0; i < c_lo; ++i) skip(i);
  if (c_lo < c_hi) {
    wait(kr, c_lo);
    gemm_qk<D, kBK, Tile::kBQ, T>(s, q_desc, k_desc(c_lo));
    wgmma_wait<0>();
    fence_regs(s);
    release(kr, c_lo);
    softmax(c_lo);  // O is 0: no rescale
    for (int64_t i = c_lo + 1; i < c_hi; ++i) {
      wait(kr, i);
      wait(vr, i - 1);
      fence_regs(s);
      fence_regs(o);
      fence_regs(pf);
      // both stage descriptors set before the first wgmma.fence (llama3.2-1b
      // widths run about 5% faster than with them built between the wgmmas)
      uint64_t dk = k_desc(i), dv = v_desc(i - 1);
      asm volatile("" : "+l"(dk), "+l"(dv));
      gemm_pv<D, kBK, T>(o, pf, dv);
      gemm_qk<D, kBK, Tile::kBQ, T>(s, q_desc, dk);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(o);
      fence_regs(pf);
      release(vr, i - 1);
      release(kr, i);
      softmax(i);
      rescale(o, alpha);
    }
    wait(vr, c_hi - 1);
    fence_regs(o);
    fence_regs(pf);
    gemm_pv<D, kBK, T>(o, pf, v_desc(c_hi - 1));
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pf);
    release(vr, c_hi - 1);
  }
  for (int64_t i = c_hi; i < n; ++i) skip(i);

  if (!active) return;
  T* out = static_cast<T*>(r.out) + h * r.tq * D;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float lt = l[hf];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float inv = 1.f / (lt == 0.f ? 1.f : lt);
    const int64_t qi = w0 + lane / 4 + hf * 8;
    if (qi < r.tq) {
#pragma unroll
      for (int j = 0; j < kDt; ++j)
        *reinterpret_cast<uint32_t*>(out + qi * D + j * 8 + (lane % 4) * 2) =
            pack2<T>(o[j][2 * hf] * inv, o[j][2 * hf + 1] * inv);
    }
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(WgTile<D>::kThreads, WgTile<D>::kMinBlocks)
    flash_attention_wg(const __grid_constant__ AttnArgs r, const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map) {
  using Tile = WgTile<D>;
  constexpr int kBQ = Tile::kBQ;
  constexpr int kBK = Tile::kBK;
  constexpr int kS = Tile::kStages;
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle repeats every 8 rows
  unsigned char* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ks = qs + Tile::kQBytes;          // [stage][panel][kBK rows][128 bytes]
  unsigned char* vs = ks + kS * Tile::kTileBytes;  // the same
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + kS * Tile::kTileBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kS;
  uint32_t* released = reinterpret_cast<uint32_t*>(v_full + kS);  // K's kS, then V's kS
  const Ring kr{&k_map, ks, k_full, released};
  const Ring vr{&v_map, vs, v_full, released + kS};

  const int warp = static_cast<int>(threadIdx.x) / 32;
  const int lane = static_cast<int>(threadIdx.x) % 32;
  const int64_t h = blockIdx.x;
  const int64_t hk = h / (r.hq / r.hkv);
  // query tiles in reverse: under a causal mask the last tiles see the most keys
  const int64_t q0 = static_cast<int64_t>(gridDim.y - 1 - blockIdx.y) * kBQ;
  // the block's KV tiles (the rule of the other variants)
  const int64_t n_tiles = (r.tk + kBK - 1) / kBK;
  const int64_t q_last = (q0 + kBQ < r.tq ? q0 + kBQ : r.tq) - 1;
  int64_t t_lo = 0, t_hi = n_tiles;
  if (has_live(r, q0) && has_live(r, q_last)) {
    t_lo = live_lo(r, q0) / kBK;
    t_hi = live_hi(r, q_last) / kBK + 1;
  }
  const int64_t n = t_hi - t_lo;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kS; ++st) {
      mbar_init(k_full + st, 1);
      mbar_init(v_full + st, 1);
      released[st] = released[kS + st] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // Q, and the first stages of K and V; later stages are refilled by the
    // warp that releases a stage last
    mbar_expect_tx(q_full, Tile::kQBytes);
    for (int p = 0; p < D / 64; ++p)
      tma_load(qs + p * kBQ * 128, &q_map, p * 64, static_cast<int>(q0), static_cast<int>(h),
               q_full);
    for (int64_t i = 0; i < kS && i < n; ++i) {
      load_stage<D>(kr, i, t_lo, hk);
      load_stage<D>(vr, i, t_lo, hk);
    }
  }
  __syncthreads();
  // the warpgroup, warp-uniform as far as the compiler can tell: the
  // descriptors built from it stay in uniform registers
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  consume<D, T>(r, smem_u32(qs) + wg * 64 * 128, q_full, kr, vr, q0, t_lo, n, wg, warp, lane, h,
                hk);
}

// ---------------------------------------------------------------------------
// f32 at D = 64, 128, 256: split TF32 on wgmma
// ---------------------------------------------------------------------------

// D (64 x N, f32) (+)= A (64 x 8, TF32, registers: the m16n8k8 A fragment of
// each warp's 16 rows) * B (8 x N, TF32, shared memory K-major with the
// 128-byte swizzle); scale_d = 0 overwrites D. N = 32, 64, 128.
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int D>
struct TfTile {
  // "pair" (D = 256): both warpgroups take the same 64 query rows, each half
  // of D for S (the partial scores exchanged through shared memory) and half
  // of O's columns, so that O takes 64 registers a thread; "rows" (D <= 128):
  // each warpgroup takes 64 rows of its own and all of D
  static constexpr bool kPair = D == 256;
  static constexpr int kBQ = kPair ? 64 : 128;     // query rows a block
  static constexpr int kBK = D == 256 ? 32 : 64;  // keys a stage
  static constexpr int kThreads = 256;
  static constexpr int kPanels = D / 32;            // 32-column panels of Q and K
  static constexpr int kOCols = kPair ? D / 2 : D;  // a warpgroup's columns of O
  static constexpr int kQPitch = 36;  // floats a row of a Q panel: 32 + 4 of padding
  static constexpr int kKBytes = kBK * D * 4;  // one set (big or small) of a stage's K panels
  static constexpr int kVBytes = kBK * D * 4;  // the same of V^T
  static constexpr int kXBytes = kPair ? 2 * kBQ * kBK * 4 : 0;  // both warpgroups' partial scores
  static constexpr int kQBytes = kPanels * kBQ * kQPitch * 4;
  static constexpr int kSmem = 1024 + 2 * kKBytes + 2 * kVBytes + kXBytes + kQBytes + 16;
  static_assert(kSmem <= 232448, "the block does not fit an SM");
};

// Position p (0..7) of each 8-key group of a V^T row holds key kv_perm(p) of
// the group: lane q's P values of keys 2q and 2q + 1, where the S
// accumulator leaves them, are then the A fragment's positions q and q + 4.
__host__ __device__ constexpr int kv_perm(int p) { return p < 4 ? 2 * p : 2 * (p - 4) + 1; }

// The pre-pass of "tf32": K and V of every KV head split once a call into
// the arrays that the attention kernel's TMA loads copy into its panels as
// they stand. kb and ks (hkv, tk, D): K's big and small parts; vtb and vts
// (hkv, D, tkp): V^T's, each 8-key group of a row in kv_perm order, keys
// past tk 0 (tkp: tk rounded up to 32). One block per (32 keys, KV head);
// V's 32 rows pass through shared memory to be written transposed.
template <int D>
__global__ void __launch_bounds__(256) split_kv_tf32(const float* k, const float* v, int64_t tk,
                                                     int64_t tkp, uint32_t* kb, uint32_t* ks,
                                                     uint32_t* vtb, uint32_t* vts) {
  __shared__ float tile[32][D + 1];  // padded: a column read hits 32 banks
  const int64_t h = blockIdx.y;
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * 32;
  const int tid = static_cast<int>(threadIdx.x);
  for (int idx = tid; idx < 32 * D / 4; idx += 256) {
    const int n = idx / (D / 4), c = idx % (D / 4);
    const int64_t key = k0 + n;
    float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
    if (key < tk) {
      const int64_t at = (h * tk + key) * D;
      const float4 x = __ldg(reinterpret_cast<const float4*>(k + at) + c);
      const float kx[4] = {x.x, x.y, x.z, x.w};
      uint32_t b[4], sm[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) tf32::split_tf32<true>(kx[j], b[j], sm[j]);
      reinterpret_cast<uint4*>(kb + at)[c] = make_uint4(b[0], b[1], b[2], b[3]);
      reinterpret_cast<uint4*>(ks + at)[c] = make_uint4(sm[0], sm[1], sm[2], sm[3]);
      y = __ldg(reinterpret_cast<const float4*>(v + at) + c);
    }
    tile[n][4 * c] = y.x;
    tile[n][4 * c + 1] = y.y;
    tile[n][4 * c + 2] = y.z;
    tile[n][4 * c + 3] = y.w;
  }
  __syncthreads();
  for (int idx = tid; idx < D * 32; idx += 256) {
    const int d = idx / 32, p = idx % 32;
    uint32_t b, sm;
    tf32::split_tf32<true>(tile[8 * (p / 8) + kv_perm(p % 8)][d], b, sm);
    const int64_t at = (h * D + d) * tkp + k0 + p;
    vtb[at] = b;
    vts[at] = sm;
  }
}

// The scores of a warp's 16 rows (the m16n8 tile layout of to_logits) become
// log2-domain logits: s * scale, the softcap c tanh(x / c) (cap_tanh), then
// the masks (-1e30 masked, -inf past Tk).
template <int kNt>
__device__ __forceinline__ void to_logits_f32(float (&s)[kNt][4], const AttnArgs& r, bool whole,
                                              int64_t row, int64_t key) {
#pragma unroll
  for (int j = 0; j < kNt; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e] * r.scale;
      if (r.softcap != 0.f) x = cap_tanh(x * (2.f * kLog2e / r.softcap), r.softcap);
      x *= kLog2e;
      if (!whole) {
        const int64_t qi = row + (e / 2) * 8;
        const int64_t kj = key + j * 8 + (e % 2);
        if (kj >= r.tk) {
          x = -INFINITY;
        } else if ((r.causal && qi < kj) || (r.has_window && qi - kj >= r.window)) {
          x = kMasked;
        }
      }
      s[j][e] = x;
    }
}

template <int D>
__global__ void __launch_bounds__(TfTile<D>::kThreads, 1)
    flash_attention_tf32(const __grid_constant__ AttnArgs r,
                         const __grid_constant__ CUtensorMap kb_map,
                         const __grid_constant__ CUtensorMap ks_map,
                         const __grid_constant__ CUtensorMap vb_map,
                         const __grid_constant__ CUtensorMap vs_map) {
  using Tile = TfTile<D>;
  constexpr int kBQ = Tile::kBQ;
  constexpr int kBK = Tile::kBK;
  constexpr int kNt = kBK / 8;                // 8-key steps of a stage
  constexpr bool kPair = Tile::kPair;
  constexpr int kOCols = Tile::kOCols;  // a warpgroup's columns of O
  constexpr int kChunks = kPair ? Tile::kPanels / 2 : Tile::kPanels;  // its Q/K panels
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle repeats every 8 rows
  unsigned char* kb = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ks = kb + Tile::kKBytes;
  unsigned char* vb = ks + Tile::kKBytes;
  unsigned char* vsm = vb + Tile::kVBytes;
  float4* xch = reinterpret_cast<float4*>(vsm + Tile::kVBytes);
  float* qs = reinterpret_cast<float*>(vsm + Tile::kVBytes + Tile::kXBytes);
  uint64_t* k_full = reinterpret_cast<uint64_t*>(vsm + Tile::kVBytes + Tile::kXBytes + Tile::kQBytes);
  uint64_t* v_full = k_full + 1;

  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid % 32, g = lane / 4, q = lane % 4;
  // the warpgroup, warp-uniform as far as the compiler can tell
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int t = tid % 128;  // thread of the warpgroup
  // this lane's rows of the block, r0 and r0 + 8
  const int r0 = (kPair ? 0 : wg * 64) + (t / 32) * 16 + g;
  const int64_t h = blockIdx.x;
  const int64_t hk = h / (r.hq / r.hkv);
  // query tiles in reverse: under a causal mask the last tiles see the most keys
  const int64_t q0 = static_cast<int64_t>(gridDim.y - 1 - blockIdx.y) * kBQ;
  const float* qh = static_cast<const float*>(r.q) + h * r.tq * D;

  // the block's KV stages (the rule of the other variants)
  const int64_t n_tiles = (r.tk + kBK - 1) / kBK;
  const int64_t q_last = (q0 + kBQ < r.tq ? q0 + kBQ : r.tq) - 1;
  int64_t t_lo = 0, t_hi = n_tiles;
  if (has_live(r, q0) && has_live(r, q_last)) {
    t_lo = live_lo(r, q0) / kBK;
    t_hi = live_hi(r, q_last) / kBK + 1;
  }
  // the keys that every row of this warpgroup sees
  const int64_t g0 = q0 + (kPair ? 0 : wg * 64);
  const int64_t g1 = g0 + 63 < r.tq ? g0 + 63 : (g0 < r.tq ? r.tq - 1 : g0);
  const int64_t whole_lo = live_lo(r, g1), whole_hi = live_hi(r, g0);

  // one thread copies a stage's K panels (K's 32-column slices) and V^T
  // panels (32-key slices of V^T's rows), big and small, from the pre-pass's
  // arrays with TMA, each set counted on its "full" mbarrier; keys past tk
  // read as 0
  auto load_k = [&](int64_t i) {
    mbar_expect_tx(k_full, 2 * Tile::kKBytes);
    for (int p = 0; p < Tile::kPanels; ++p) {
      tma_load(kb + p * kBK * 128, &kb_map, 32 * p, static_cast<int>(i * kBK), static_cast<int>(hk),
               k_full);
      tma_load(ks + p * kBK * 128, &ks_map, 32 * p, static_cast<int>(i * kBK), static_cast<int>(hk),
               k_full);
    }
  };
  auto load_v = [&](int64_t i) {
    mbar_expect_tx(v_full, 2 * Tile::kVBytes);
    for (int kp = 0; kp < kBK / 32; ++kp) {
      tma_load(vb + kp * D * 128, &vb_map, static_cast<int>(i * kBK) + 32 * kp, 0,
               static_cast<int>(hk), v_full);
      tma_load(vsm + kp * D * 128, &vs_map, static_cast<int>(i * kBK) + 32 * kp, 0,
               static_cast<int>(hk), v_full);
    }
  };
  if (tid == 0) {
    mbar_init(k_full, 1);
    mbar_init(v_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    load_k(t_lo);
    load_v(t_lo);
  }
  // Q into shared memory once, f32, so that lane q's A-fragment values of
  // one panel's four k steps are 8 consecutive floats of each of its rows:
  // Q[row][32 p + 8 st + q + 4 hh] at (p * kBQ + row) * kQPitch + 8 q + 2 st + hh
  for (int idx = tid; idx < kBQ * D / 4; idx += Tile::kThreads) {
    const int row = idx / (D / 4), d0 = 4 * (idx % (D / 4));
    const float4 x = q0 + row < r.tq
                         ? __ldg(reinterpret_cast<const float4*>(qh + (q0 + row) * D) + d0 / 4)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    const float val[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = d0 + e, col = d % 32;
      qs[((d / 32) * kBQ + row) * Tile::kQPitch + 8 * (col % 4) + 2 * (col / 8) + (col % 8) / 4] =
          val[e];
    }
  }
  __syncthreads();

  float o[kOCols / 2];  // this warpgroup's columns of O (o_col on) at its rows
#pragma unroll
  for (int j = 0; j < kOCols / 2; ++j) o[j] = 0.f;
  float m[2] = {kMasked, kMasked};
  float l[2] = {0.f, 0.f};  // this lane's part of the row sums
  const int o_col = kPair ? wg * kOCols : 0;  // this warpgroup's first column of O
  // descriptors of the panels' starts; an operand's is its panel's plus its
  // offset in 16-byte units (the address field does not carry over)
  uint64_t dkb = gmma_desc(smem_u32(kb), 16, 1024), dks = gmma_desc(smem_u32(ks), 16, 1024);
  uint64_t dvb = gmma_desc(smem_u32(vb) + o_col * 128, 16, 1024);
  uint64_t dvs = gmma_desc(smem_u32(vsm) + o_col * 128, 16, 1024);

  for (int64_t i = t_lo; i < t_hi; ++i) {
    const int64_t k0 = i * kBK;
    const uint32_t parity = static_cast<uint32_t>((i - t_lo) & 1);
    // pair: opaque to the compiler, else it computes every wgmma's descriptor
    // once, outside the loop, and holds them all in registers (they spilled;
    // at D <= 128 that is the faster choice)
    if constexpr (kPair) asm volatile("" : "+l"(dkb), "+l"(dks), "+l"(dvb), "+l"(dvs));
    // S = Q K^T over this warpgroup's panels of D, a 32-column panel (four k
    // steps of 8, three TF32 products each, the small terms first) at a time
    // into a fresh part, each part added to s in f32. (part and pv are not
    // initialised: each chain of wgmmas starts with scale_d = 0, and values
    // carried across stages would hold registers.)
    float s[kNt][4];
    float part[2][kBK / 2];
    mbar_wait(k_full, parity);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int p = (kPair ? wg * kChunks : 0) + c;
      const float4* qrow =
          reinterpret_cast<const float4*>(qs + (p * kBQ + r0) * Tile::kQPitch + 8 * q);
      const float4 y0 = qrow[0], y1 = qrow[1];                                      // row r0
      const float4 y2 = qrow[2 * Tile::kQPitch], y3 = qrow[2 * Tile::kQPitch + 1];  // row r0 + 8
      const float x0[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
      const float x1[8] = {y2.x, y2.y, y2.z, y2.w, y3.x, y3.y, y3.z, y3.w};
      // A fragments of step st: (r0, q), (r0 + 8, q), (r0, q + 4), (r0 + 8, q + 4)
      uint32_t ab[4][4], as[4][4];
#pragma unroll
      for (int st = 0; st < 4; ++st) {
        tf32::split_tf32<true>(x0[2 * st], ab[st][0], as[st][0]);
        tf32::split_tf32<true>(x1[2 * st], ab[st][1], as[st][1]);
        tf32::split_tf32<true>(x0[2 * st + 1], ab[st][2], as[st][2]);
        tf32::split_tf32<true>(x1[2 * st + 1], ab[st][3], as[st][3]);
      }
      float(&acc)[kBK / 2] = part[c % 2];
      wgmma_fence();
#pragma unroll
      for (int st = 0; st < 4; ++st) {
        const uint32_t off = (p * kBK * 128 + st * 32) >> 4;
        wgmma_tf32(acc, as[st], dkb + off, st > 0);
        wgmma_tf32(acc, ab[st], dks + off, 1);
        wgmma_tf32(acc, ab[st], dkb + off, 1);
      }
      wgmma_commit();
      if (c > 0) {  // fold the previous part while this one runs
        wgmma_wait<1>();
        fence_regs(part[(c - 1) % 2]);
        float* sf = reinterpret_cast<float*>(s);
#pragma unroll
        for (int j = 0; j < kBK / 2; ++j)
          sf[j] = c == 1 ? part[0][j] : sf[j] + part[(c - 1) % 2][j];
      }
    }
    wgmma_wait<0>();
    fence_regs(part[(kChunks - 1) % 2]);
    {
      float* sf = reinterpret_cast<float*>(s);
#pragma unroll
      for (int j = 0; j < kBK / 2; ++j)
        sf[j] = kChunks == 1 ? part[0][j] : sf[j] + part[(kChunks - 1) % 2][j];
      // pair: the other warpgroup's half of D; both warpgroups then hold the
      // same scores (f32 addition commutes) and run the same softmax
      if constexpr (kPair) {
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j)
          xch[(wg * (kBK / 8) + j) * 128 + t] =
              make_float4(sf[4 * j], sf[4 * j + 1], sf[4 * j + 2], sf[4 * j + 3]);
      }
      __syncthreads();  // the partial scores written; every wgmma on K's panels done
      if (tid == 0 && i + 1 < t_hi) load_k(i + 1);
      if constexpr (kPair) {
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
          const float4 y = xch[((1 - wg) * (kBK / 8) + j) * 128 + t];
          sf[4 * j] += y.x;
          sf[4 * j + 1] += y.y;
          sf[4 * j + 2] += y.z;
          sf[4 * j + 3] += y.w;
        }
      }
    }
    // the softmax; a stage that every row sees whole, with no softcap,
    // takes the scale inside the exponent
    float alpha[2];
    const bool whole = k0 + kBK <= r.tk && whole_lo <= k0 && whole_hi >= k0 + kBK - 1;
    if (whole && r.softcap == 0.f) {
      softmax_rows(s, m, l, alpha, r.scale * kLog2e);
    } else {
      to_logits_f32(s, r, whole, q0 + r0, k0 + 2 * q);
      softmax_rows(s, m, l, alpha);
    }
    // P V over this warpgroup's columns of O, in a fresh accumulator: P's A
    // fragment of step st is (r0, key 8 st + 2 q),
    // (r0 + 8, 8 st + 2 q), (r0, 8 st + 2 q + 1), (r0 + 8, 8 st + 2 q + 1),
    // positions q and q + 4 of the V^T panels' permuted key order
    uint32_t pb[kNt][4], ps[kNt][4];
#pragma unroll
    for (int st = 0; st < kNt; ++st) {
      tf32::split_tf32<true>(s[st][0], pb[st][0], ps[st][0]);
      tf32::split_tf32<true>(s[st][2], pb[st][1], ps[st][1]);
      tf32::split_tf32<true>(s[st][1], pb[st][2], ps[st][2]);
      tf32::split_tf32<true>(s[st][3], pb[st][3], ps[st][3]);
    }
    mbar_wait(v_full, parity);
    float pv[kOCols / 2];
    wgmma_fence();
#pragma unroll
    for (int st = 0; st < kNt; ++st) {
      const uint32_t off = ((st / 4) * D * 128 + (st % 4) * 32) >> 4;
      wgmma_tf32(pv, ps[st], dvb + off, st > 0);
      wgmma_tf32(pv, pb[st], dvs + off, 1);
      wgmma_tf32(pv, pb[st], dvb + off, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(pv);
    // O = alpha O + P V in f32: pv[4 j + 2 hh + c] is row r0 + 8 hh
#pragma unroll
    for (int j = 0; j < kOCols / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * j + e] = fmaf(o[4 * j + e], alpha[e / 2], pv[4 * j + e]);
    __syncthreads();  // every wgmma on V^T's panels done; the partial scores read
    if (tid == 0 && i + 1 < t_hi) load_v(i + 1);
  }

  float* out = static_cast<float*>(r.out) + h * r.tq * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lt = l[hh];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float inv = 1.f / (lt == 0.f ? 1.f : lt);
    const int64_t qi = q0 + r0 + 8 * hh;
    if (qi < r.tq) {
#pragma unroll
      for (int j = 0; j < kOCols / 8; ++j)
        *reinterpret_cast<float2*>(out + qi * D + o_col + 8 * j + 2 * q) =
            make_float2(o[4 * j + 2 * hh] * inv, o[4 * j + 2 * hh + 1] * inv);
    }
  }
}

template <int D, typename T>
int launch_fma(const AttnArgs& r) {
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<D, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((r.tq + kBQ - 1) / kBQ), static_cast<unsigned>(r.hq));
  flash_attention_kernel<D, T><<<grid, kThreads, bytes, r.stream>>>(r);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename T>
int launch_mma(const AttnArgs& r) {
  constexpr int bytes = MmaTile<D>::kSmem;
  const int64_t n_qt = (r.tq + kMmaBQ - 1) / kMmaBQ;
  if (n_qt > 65535 || r.hq > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(r.q) | reinterpret_cast<uintptr_t>(r.k) |
       reinterpret_cast<uintptr_t>(r.v) | reinterpret_cast<uintptr_t>(r.out)) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_mma<D, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(r.hq), static_cast<unsigned>(n_qt));
  flash_attention_mma<D, T><<<grid, kMmaThreads, bytes, r.stream>>>(r);
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

// A (heads, t, D) tensor of 16-bit values as a 3-D TMA map whose boxes are
// 64 columns (128 bytes, swizzled) x rows x 1 head; rows past t read as 0.
bool make_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type, int64_t heads,
              int64_t t, int d, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(t) * d * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, type, 3, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, typename T>
int launch_wg(const AttnArgs& r) {
  using Tile = WgTile<D>;
  constexpr int bytes = Tile::kSmem;
  const int64_t n_qt = (r.tq + Tile::kBQ - 1) / Tile::kBQ;
  if (n_qt > 65535 || r.hq > INT_MAX || r.tq > INT_MAX || r.tk > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(r.q) | reinterpret_cast<uintptr_t>(r.k) |
       reinterpret_cast<uintptr_t>(r.v) | reinterpret_cast<uintptr_t>(r.out)) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const CUtensorMapDataType type = std::is_same<T, __nv_bfloat16>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  CUtensorMap q_map, k_map, v_map;
  if (!make_map(&q_map, r.q, type, r.hq, r.tq, D, Tile::kBQ) ||
      !make_map(&k_map, r.k, type, r.hkv, r.tk, D, Tile::kBK) ||
      !make_map(&v_map, r.v, type, r.hkv, r.tk, D, Tile::kBK))
    return static_cast<int>(cudaErrorNotSupported);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_wg<D, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(r.hq), static_cast<unsigned>(n_qt));
  flash_attention_wg<D, T><<<grid, Tile::kThreads, bytes, r.stream>>>(r, q_map, k_map, v_map);
  return static_cast<int>(cudaGetLastError());
}

// An f32 (heads, rows, cols) array as a 3-D TMA map whose boxes are 32
// columns (128 bytes, swizzled) x box_rows rows x 1 head; rows past `rows`
// read as 0.
bool make_map_f32(CUtensorMap* map, const void* ptr, int64_t heads, int64_t rows, int64_t cols,
                  int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 4,
                                 static_cast<cuuint64_t>(rows) * cols * 4};
  const cuuint32_t box[3] = {32, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The pre-pass's arrays, in 4-byte words: K's big and small parts (hkv * tk *
// d each), then V^T's (hkv * d * tkp each).
int64_t tf32_scratch_words(int64_t hkv, int64_t tk, int d) {
  const int64_t tkp = (tk + 31) / 32 * 32;
  return 2 * hkv * tk * d + 2 * hkv * d * tkp;
}

template <int D>
int launch_tf32(const AttnArgs& r, void* scratch) {
  using Tile = TfTile<D>;
  const int64_t n_qt = (r.tq + Tile::kBQ - 1) / Tile::kBQ;
  const int64_t tkp = (r.tk + 31) / 32 * 32;
  if (n_qt > 65535 || r.hq > INT_MAX || r.hkv > 65535 || tkp > INT_MAX || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(r.q) | reinterpret_cast<uintptr_t>(r.k) |
       reinterpret_cast<uintptr_t>(r.v) | reinterpret_cast<uintptr_t>(r.out) |
       reinterpret_cast<uintptr_t>(scratch)) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  uint32_t* kbg = static_cast<uint32_t*>(scratch);
  uint32_t* ksg = kbg + r.hkv * r.tk * D;
  uint32_t* vtb = ksg + r.hkv * r.tk * D;
  uint32_t* vts = vtb + r.hkv * D * tkp;
  split_kv_tf32<D><<<dim3(static_cast<unsigned>(tkp / 32), static_cast<unsigned>(r.hkv)), 256, 0,
                     r.stream>>>(static_cast<const float*>(r.k), static_cast<const float*>(r.v),
                                 r.tk, tkp, kbg, ksg, vtb, vts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap kb_map, ks_map, vb_map, vs_map;
  if (!make_map_f32(&kb_map, kbg, r.hkv, r.tk, D, Tile::kBK) ||
      !make_map_f32(&ks_map, ksg, r.hkv, r.tk, D, Tile::kBK) ||
      !make_map_f32(&vb_map, vtb, r.hkv, D, tkp, D) ||
      !make_map_f32(&vs_map, vts, r.hkv, D, tkp, D))
    return static_cast<int>(cudaErrorNotSupported);
  err = cudaFuncSetAttribute(flash_attention_tf32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Tile::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(r.hq), static_cast<unsigned>(n_qt));
  flash_attention_tf32<D><<<grid, Tile::kThreads, Tile::kSmem, r.stream>>>(r, kb_map, ks_map,
                                                                          vb_map, vs_map);
  return static_cast<int>(cudaGetLastError());
}

enum class Variant { kNone, kFma, kMma, kWgmma, kTf32 };

// The variant for (dtype code, D), the one rule: f32 -> tf32 at D >= 64 (its
// 32-column panels split between two warpgroups), fma at D 16 and 32; bf16
// and f16 -> wgmma at D >= 64 (its 64-column panels), mma at D 16 and 32. A
// build with -DFLASH_ATTENTION_FORCE_VARIANT=1 runs every dtype on fma at
// every D (PR 13's design), one with =2 runs bf16 and f16 on mma at every D:
// scripts/k8_variants.py compiles such libraries under other names to time
// the variants against each other; the port never builds or loads them.
constexpr Variant variant_of(int code, int d) {
  if (d != 16 && d != 32 && d != 64 && d != 128 && d != 256) return Variant::kNone;
  if (code != replay::kF32 && code != replay::kF16 && code != replay::kBF16) return Variant::kNone;
#if defined(FLASH_ATTENTION_FORCE_VARIANT) && FLASH_ATTENTION_FORCE_VARIANT == 1
  return Variant::kFma;
#else
  if (code == replay::kF32) return d >= 64 ? Variant::kTf32 : Variant::kFma;
#ifdef FLASH_ATTENTION_FORCE_VARIANT
  return Variant::kMma;
#else
  return d >= 64 ? Variant::kWgmma : Variant::kMma;
#endif
#endif
}

template <int D, typename T, int kCode>
int launch_t(const AttnArgs& r, void* scratch) {
  constexpr Variant v = variant_of(kCode, D);
  if constexpr (v == Variant::kFma) return launch_fma<D, T>(r);
  else if constexpr (v == Variant::kMma) return launch_mma<D, T>(r);
  else if constexpr (v == Variant::kWgmma) return launch_wg<D, T>(r);
  else if constexpr (v == Variant::kTf32) return launch_tf32<D>(r, scratch);
  else return static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int launch_d(const AttnArgs& r, int code, void* scratch) {
  switch (code) {
    case replay::kF32: return launch_t<D, float, replay::kF32>(r, scratch);
    case replay::kF16: return launch_t<D, __half, replay::kF16>(r, scratch);
    case replay::kBF16: return launch_t<D, __nv_bfloat16, replay::kBF16>(r, scratch);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// int flash_attention_launch(q, k, v, out, scratch, code, hq, hkv, tq, tk, d,
//                            scale, causal, has_window, window, softcap, stream)
//   -> cudaGetLastError(); cudaErrorInvalidValue for a head_dim other than
//   16, 32, 64, 128 or 256, an unknown dtype code, hq % hkv != 0, or no
//   scratch where the variant needs it; cudaErrorMisalignedAddress for a
//   pointer that is not 16-byte aligned on the tf32, wgmma and mma variants
//   (the wrapper realigns). scratch: flash_attention_scratch_bytes(code, hkv,
//   tk, d) bytes of device memory (none: a null pointer), overwritten.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, void* scratch, int code, int64_t hq, int64_t hkv,
                                      int64_t tq, int64_t tk, int d, float scale,
                                      int causal, int has_window, int64_t window,
                                      float softcap, void* stream) {
  if (hkv < 1 || hq % hkv || tk < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (hq == 0 || tq == 0) return static_cast<int>(cudaGetLastError());
  const AttnArgs r{q,     k,      v,          out,    hq,      hkv,
                   tq,    tk,     scale,      causal, has_window, window,
                   softcap, static_cast<cudaStream_t>(stream)};
  switch (d) {
    case 16: return launch_d<16>(r, code, scratch);
    case 32: return launch_d<32>(r, code, scratch);
    case 64: return launch_d<64>(r, code, scratch);
    case 128: return launch_d<128>(r, code, scratch);
    case 256: return launch_d<256>(r, code, scratch);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The scratch bytes that flash_attention_launch needs for (dtype code, hkv,
// tk, d): the "tf32" pre-pass's arrays, 0 for the other variants.
extern "C" int64_t flash_attention_scratch_bytes(int code, int64_t hkv, int64_t tk, int d) {
  return variant_of(code, d) == Variant::kTf32 ? 4 * tf32_scratch_words(hkv, tk, d) : 0;
}

// The variant that flash_attention_launch runs for (dtype code, d): "tf32",
// "wgmma", "mma", "fma", or "none" for what it refuses (variant_of).
extern "C" const char* flash_attention_variant(int code, int d) {
  switch (variant_of(code, d)) {
    case Variant::kFma: return "fma";
    case Variant::kMma: return "mma";
    case Variant::kWgmma: return "wgmma";
    case Variant::kTf32: return "tf32";
    case Variant::kNone: break;
  }
  return "none";
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
