// bsr_spgemm: the block-sparse (BSR) numeric phase of SpGEMM on Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/bsr_spgemm.py
// (bsr_spgemm_numeric, body _kernel). For every block s of C, with the plan
// of plan_bsr_numeric:
//   C[s] = sum over t < contrib_n[s] of float(A[contrib_a[s, t]]) @
//          float(B[contrib_b[s, t]])
// with f32 products and f32 sums (FMAs, no TF32: it would round the
// operands), written in A's dtype. A padded slot (t >= contrib_n[s]) is never
// read, so a NaN in the block it points at cannot leak. Counts clamp into
// [0, t_max] and block ids into the block arrays, as the reference's gathers
// clamp. A C block with no live slot is written as zeros.
//
// What bounds it: bytes. The least traffic is A's blocks, the plan and C,
// each moved once (B's blocks are A's in A*A, else read once more); at the
// block multigrid 512^2, bs 8, f32 that is 335 + 149 + 870 MB, 0.404 ms at
// 3.35 TB/s. The 2 * bs^3 flops of a product take a quarter of that time at
// bs 8 and half at bs 16 (67 TFLOP/s in f32). A kernel that fetches both
// blocks of every product from L2, with more shared-memory instructions than
// FMAs and few bytes in flight, stays far from it.
//
// Design: a CTA of 256 threads takes a tile of kTile consecutive C blocks;
// a C block belongs to a group of bs threads (four groups a warp at bs 8,
// two at bs 16), and a group owns every kGroups-th C block of the tile.
//  1. Plan. The tile's rows of contrib_n, and of contrib_a / contrib_b when
//     t_max <= kPlanT, are contiguous: one pass of 16-byte loads puts them
//     in shared memory (a larger t_max reads them from device memory).
//     Each thread then lists its C block's live products, clamped, into its
//     group's product list: (A slot, B slot, a flag on the block's last).
//     A group lists kCap products at a time; a plan of t_max <= kPlanT
//     needs one round.
//  2. A, staged once. In a plan of plan_bsr_numeric the C blocks of a tile
//     come from a few consecutive block rows, so the live A slots of the
//     tile lie in a short span (on the 5-point block operator at most 62
//     blocks for 128 C blocks, each used ~4.7 times). A block reduction
//     finds the span; when it fits kASpan blocks, cp.async copies it into
//     shared memory once (over the raw plan, read by then) and every A read
//     of the tile is served there. When it does not (random plans), each A
//     fragment is read from device memory (through L1/L2) where it is used:
//     a second path inside the kernel.
//  3. B, streamed. While a group multiplies product i, the B block of
//     product i + 1 is in flight into the group's two-stage ring by
//     cp.async; only __syncwarp orders the ring. A deeper ring costs
//     occupancy, which bought more here (five CTAs an SM at bs 8). A
//     group's ring is padded by one B row so that the groups of a warp read
//     different banks.
//  4. FMAs in registers. A thread owns rows rg, rg + 4, ... (bs / 4 of them)
//     x 4 columns of its C block. Per 4 of k it loads its A values as one
//     16-byte (8-byte in 16-bit types) load a row and B's 4 rows as one load
//     each, so each shared load feeds bs / 4 x 4 FMAs. Staged A blocks sit 16
//     bytes apart in their pitch so neighbouring blocks start 4 banks apart.
//  5. A C block is written once, when its last product is done, with
//     streaming 16-byte stores (8-byte in 16-bit types) in A's dtype: C is
//     never read again, so it does not displace B's live window in L2. A
//     block with no live slot is written as zeros first.
// Blocks stay in their own dtype in shared memory and become f32 where they
// are loaded into registers.
#include <climits>

#include "replay_common.cuh"

namespace {

constexpr int kThreads = 256;

// kTile, kASpan: mirrored by TILE_BLOCKS and A_SPAN_BLOCKS in
// kernels/bsr_spgemm.py (tests/test_torch_kernels.py holds them equal).
template <int BS>
struct Tile {
  static constexpr int kTile = BS == 8 ? 128 : 64;  // C blocks a CTA
  static constexpr int kASpan = BS == 8 ? 64 : 36;  // A blocks the CTA can stage
  static constexpr int kPlanT = BS == 8 ? 8 : 6;    // t_max up to which the plan is staged
  static constexpr int kStages = 2;                 // depth of a group's B ring
  static constexpr int kMinBlocks = BS == 8 ? 5 : 3;  // CTAs an SM (48 / 80 registers)
  static constexpr int kGroups = kThreads / BS;     // a group of BS threads per C block
  static constexpr int kOwned = kTile / kGroups;    // C blocks a group owns
  static constexpr int kCap = kOwned * kPlanT;      // products a group lists at a time
  static_assert(kTile % kGroups == 0 && kTile <= kThreads, "tile");
};

// Shared-memory layout in bytes: the A span and the largest product count,
// contrib_n, the groups' product lists, the staged A span (first the raw
// plan), the groups' B rings.
template <int BS, typename TA, typename TB>
struct Layout {
  using T = Tile<BS>;
  static constexpr int kBlkA = BS * BS * static_cast<int>(sizeof(TA));
  static constexpr int kBlkB = BS * BS * static_cast<int>(sizeof(TB));
  static constexpr int kPitchA = kBlkA + 16;
  static constexpr int kRing = T::kStages * kBlkB + BS * static_cast<int>(sizeof(TB));
  static constexpr int kOffN = 16;
  static constexpr int kOffList = kOffN + T::kTile * 4;
  static constexpr int kOffA = kOffList + T::kGroups * T::kCap * 8;  // first the raw plan
  static constexpr int kOffB = kOffA + T::kASpan * kPitchA;
  static constexpr int kBytes = kOffB + T::kGroups * kRing;
  static_assert(kOffA % 16 == 0 && kOffB % 16 == 0 && kRing % 16 == 0, "alignment");
  static_assert(2 * T::kTile * T::kPlanT * 4 <= T::kASpan * kPitchA, "the raw plan fits the A area");
  static_assert(kBlkB / 16 % BS == 0, "a group copies a B block in whole 16-byte pieces");
};

struct BsrArgs {
  const void* a;  // (nnzb_a, bs, bs)
  int64_t nnzb_a;
  const void* b;  // (nnzb_b, bs, bs)
  int64_t nnzb_b;
  const int32_t* contrib_a;  // (nnzb_c, t_max)
  const int32_t* contrib_b;  // (nnzb_c, t_max)
  const int32_t* contrib_n;  // (nnzb_c,)
  int64_t nnzb_c;
  int64_t t_max;
  void* out;  // (nnzb_c, bs, bs) in A's dtype
  int bs;
  cudaStream_t stream;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; .cg keeps them out of L1 (A, read once),
// .ca lets a B block that several C blocks of the tile use hit in L1.
__device__ __forceinline__ void cp_async16_cg(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16_ca(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four consecutive values as f32: from shared memory (kShared) or through
// the read-only path.
template <bool kShared>
__device__ __forceinline__ void load4(float (&v)[4], const float* p) {
  const float4 x = kShared ? *reinterpret_cast<const float4*>(p)
                           : __ldg(reinterpret_cast<const float4*>(p));
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
}
template <bool kShared>
__device__ __forceinline__ uint2 load8(const void* p) {
  return kShared ? *reinterpret_cast<const uint2*>(p) : __ldg(reinterpret_cast<const uint2*>(p));
}
template <bool kShared>
__device__ __forceinline__ void load4(float (&v)[4], const __half* p) {
  const uint2 x = load8<kShared>(p);
  const float2 lo = __half22float2(*reinterpret_cast<const __half2*>(&x.x));
  const float2 hi = __half22float2(*reinterpret_cast<const __half2*>(&x.y));
  v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
}
template <bool kShared>
__device__ __forceinline__ void load4(float (&v)[4], const __nv_bfloat16* p) {
  const uint2 x = load8<kShared>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
  v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
}

// Four consecutive f32 values stored in *p's type, streaming (C is written
// once and never read by the kernel).
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store4(__half* p, const float (&v)[4]) {
  const __half2 lo = __floats2half2_rn(v[0], v[1]);
  const __half2 hi = __floats2half2_rn(v[2], v[3]);
  __stcs(reinterpret_cast<uint2*>(p), make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                                                 *reinterpret_cast<const unsigned*>(&hi)));
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  __stcs(reinterpret_cast<uint2*>(p), make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                                                 *reinterpret_cast<const unsigned*>(&hi)));
}

// acc += A_block[rows rg + 4i] @ B_block[:, 4cg .. 4cg + 3], A from shared
// memory (kSharedA) or device memory, B from the group's ring.
template <int BS, bool kSharedA, typename TA, typename TB>
__device__ __forceinline__ void multiply(float (&acc)[BS / 4][4], const TA* a, const TB* b,
                                         int rg, int cg) {
#pragma unroll
  for (int k0 = 0; k0 < BS; k0 += 4) {
    float av[BS / 4][4];
#pragma unroll
    for (int i = 0; i < BS / 4; ++i) load4<kSharedA>(av[i], a + (rg + 4 * i) * BS + k0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float bv[4];
      load4<true>(bv, b + (k0 + kk) * BS + 4 * cg);
#pragma unroll
      for (int i = 0; i < BS / 4; ++i) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(av[i][kk], bv[c], acc[i][c]);
      }
    }
  }
}

template <int BS, typename TA>
__device__ __forceinline__ void store_block(TA* blk, const float (&acc)[BS / 4][4], int rg,
                                            int cg) {
#pragma unroll
  for (int i = 0; i < BS / 4; ++i) store4(blk + (rg + 4 * i) * BS + 4 * cg, acc[i]);
}

__device__ __forceinline__ int clamp32(int v, int n) { return v < 0 ? 0 : (v >= n ? n - 1 : v); }

// n ints global -> shared, 16 bytes a load: the launcher checks that the
// plan starts on 16 bytes, and a tile's rows start at a multiple of 4 ints.
__device__ __forceinline__ void stage_ints(int32_t* dst, const int32_t* src, int n) {
  const int head = n & ~3;
  for (int i = 4 * static_cast<int>(threadIdx.x); i < head; i += 4 * kThreads)
    *reinterpret_cast<int4*>(dst + i) = __ldg(reinterpret_cast<const int4*>(src + i));
  for (int i = head + static_cast<int>(threadIdx.x); i < n; i += kThreads) dst[i] = __ldg(src + i);
}

template <int BS, typename TA, typename TB>
__global__ void __launch_bounds__(kThreads, Tile<BS>::kMinBlocks)
    bsr_spgemm_kernel(const BsrArgs r) {
  using T = Tile<BS>;
  using L = Layout<BS, TA, TB>;
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_span = reinterpret_cast<int*>(smem);  // lo, hi, the largest product count
  int32_t* s_n = reinterpret_cast<int32_t*>(smem + L::kOffN);
  int2* s_list = reinterpret_cast<int2*>(smem + L::kOffList);
  unsigned char* s_a = smem + L::kOffA;
  unsigned char* s_b = smem + L::kOffB;
  // the raw plan, while the A span is not staged yet
  int32_t* s_ca = reinterpret_cast<int32_t*>(s_a);
  int32_t* s_cb = s_ca + T::kTile * T::kPlanT;

  const int tid = threadIdx.x;
  const int tm = static_cast<int>(r.t_max);
  const int na = static_cast<int>(r.nnzb_a);
  const int nb = static_cast<int>(r.nnzb_b);
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * T::kTile;
  const int nblk = static_cast<int>(r.nnzb_c - s0 < T::kTile ? r.nnzb_c - s0 : T::kTile);
  const bool plan_staged = tm <= T::kPlanT;

  // 1. the tile's plan
  if (tid == 0) s_span[0] = INT_MAX, s_span[1] = -1, s_span[2] = 0;
  for (int i = tid; i < nblk; i += kThreads) {
    const int32_t n = __ldg(r.contrib_n + s0 + i);
    s_n[i] = n < 0 ? 0 : (n > tm ? tm : n);
  }
  if (plan_staged) {
    stage_ints(s_ca, r.contrib_a + s0 * tm, nblk * tm);
    stage_ints(s_cb, r.contrib_b + s0 * tm, nblk * tm);
  }
  __syncthreads();
  const int32_t* pa = plan_staged ? s_ca : r.contrib_a + s0 * tm;
  const int32_t* pb = plan_staged ? s_cb : r.contrib_b + s0 * tm;

  // 2. each group's product count; block j's products are its group's
  // products off .. off + n - 1
  const int group = tid / BS;
  const int gt = tid % BS;
  auto n_of = [&](int k) {
    const int j = group + T::kGroups * k;
    return k < T::kOwned && j < nblk ? s_n[j] : 0;
  };
  int count = 0;
#pragma unroll
  for (int k = 0; k < T::kOwned; ++k) count += n_of(k);
  int off = 0;
  if (tid < nblk) {
    for (int j = tid % T::kGroups; j < tid; j += T::kGroups) off += s_n[j];
  }
  // the products off - round * kCap .. of block tid, listed as (A slot, B
  // slot | INT_MIN on the block's last product)
  auto list_round = [&](int round) {
    if (tid >= nblk) return;
    const int n = s_n[tid];
    const int first = round * T::kCap - off;
    int2* dst = s_list + (tid % T::kGroups) * T::kCap - first;
    const int32_t* ra = pa + static_cast<int64_t>(tid) * tm;
    const int32_t* rb = pb + static_cast<int64_t>(tid) * tm;
    for (int t = max(first, 0); t < min(n, first + T::kCap); ++t)
      dst[t] = make_int2(clamp32(ra[t], na), clamp32(rb[t], nb) | (t == n - 1 ? INT_MIN : 0));
  };
  list_round(0);
  // 3. the live span of A slots (all rounds)
  int lo = INT_MAX, hi = -1;
  if (tid < nblk) {
    const int n = s_n[tid];
    const int32_t* ra = pa + static_cast<int64_t>(tid) * tm;
    for (int t = 0; t < n; ++t) {
      const int e = clamp32(ra[t], na);
      lo = min(lo, e);
      hi = max(hi, e);
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  const int most = __reduce_max_sync(0xffffffffu, count);
  if ((tid & 31) == 0) {
    if (hi >= 0) {
      atomicMin(s_span, lo);
      atomicMax(s_span + 1, hi);
    }
    atomicMax(s_span + 2, most);
  }
  __syncthreads();  // the lists of round 0 are written, the raw plan is read
  lo = s_span[0];
  hi = s_span[1];
  const int rounds = (s_span[2] + T::kCap - 1) / T::kCap;
  const bool staged = hi >= lo && hi - lo < T::kASpan;
  const TA* a = static_cast<const TA*>(r.a);
  const TB* b = static_cast<const TB*>(r.b);
  if (staged) {
    constexpr int kChunks = L::kBlkA / 16;
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(a + static_cast<int64_t>(lo) * BS * BS);
    for (int c = tid; c < (hi - lo + 1) * kChunks; c += kThreads)
      cp_async16_cg(s_a + (c / kChunks) * L::kPitchA + (c % kChunks) * 16,
                    src + static_cast<int64_t>(c) * 16);
  }
  cp_async_commit();

  // 4. the group's C blocks with no live slot are zeros
  const int cg = gt % (BS / 4);
  const int rg = gt / (BS / 4);
  TA* out = static_cast<TA*>(r.out) + s0 * BS * BS;
  float acc[BS / 4][4];
#pragma unroll
  for (int i = 0; i < BS / 4; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < T::kOwned; ++k) {
    const int j = group + T::kGroups * k;
    if (j < nblk && s_n[j] == 0) store_block<BS>(out + j * BS * BS, acc, rg, cg);
  }
  int ck = 0;  // the owned block being summed
  while (ck < T::kOwned && n_of(ck) == 0) ++ck;
  const int2* list = s_list + group * T::kCap;
  unsigned char* ring = s_b + group * L::kRing;

  for (int round = 0; round < rounds; ++round) {
    if (round) {  // rounds past the first: t_max > kPlanT, the plan from device memory
      __syncthreads();  // the previous round's lists are consumed
      list_round(round);
      __syncthreads();
    }
    int cnt = count - round * T::kCap;
    cnt = cnt < 0 ? 0 : (cnt > T::kCap ? T::kCap : cnt);
    auto fetch_b = [&](int stage, int p) {  // the group's B block of product p
      const unsigned char* src = reinterpret_cast<const unsigned char*>(
          b + static_cast<int64_t>(list[p].y & INT_MAX) * BS * BS) + gt * 16;
      unsigned char* dst = ring + stage * L::kBlkB + gt * 16;
#pragma unroll
      for (int q = 0; q < L::kBlkB / 16 / BS; ++q)
        cp_async16_ca(dst + q * BS * 16, src + q * BS * 16);
    };
    // 5. the B ring, kStages - 1 products ahead, then the products
#pragma unroll
    for (int d = 0; d < T::kStages - 1; ++d) {
      if (d < cnt) fetch_b(d, d);
      cp_async_commit();
    }
    cp_async_wait<T::kStages - 1>();  // the A span (the oldest group) has landed
    __syncthreads();
    const int trip = __reduce_max_sync(0xffffffffu, cnt);
    int sc = 0, sp = T::kStages - 1;  // ring stages of the product summed and fetched
    for (int i = 0; i < trip; ++i) {
      cp_async_wait<T::kStages - 2>();  // product i's B block has landed
      __syncwarp();  // ... for the whole group, which is done with product i - 1
      if (i + T::kStages - 1 < cnt) fetch_b(sp, i + T::kStages - 1);
      cp_async_commit();
      if (i < cnt) {
        const int2 p = list[i];
        const TB* b_blk = reinterpret_cast<const TB*>(ring + sc * L::kBlkB);
        if (staged)
          multiply<BS, true>(acc, reinterpret_cast<const TA*>(s_a + (p.x - lo) * L::kPitchA),
                             b_blk, rg, cg);
        else
          multiply<BS, false>(acc, a + static_cast<int64_t>(p.x) * BS * BS, b_blk, rg, cg);
        if (p.y < 0) {  // the block's last product: write it once
          store_block<BS>(out + (group + T::kGroups * ck) * BS * BS, acc, rg, cg);
#pragma unroll
          for (int q = 0; q < BS / 4; ++q) {
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[q][c] = 0.f;
          }
          do ++ck;
          while (ck < T::kOwned && n_of(ck) == 0);
        }
      }
      sc = sc + 1 == T::kStages ? 0 : sc + 1;
      sp = sp + 1 == T::kStages ? 0 : sp + 1;
    }
  }
}

template <int BS, typename TA, typename TB>
void launch_bs(const BsrArgs& r) {
  constexpr int bytes = Layout<BS, TA, TB>::kBytes;
  cudaFuncSetAttribute(bsr_spgemm_kernel<BS, TA, TB>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  const int64_t tiles = (r.nnzb_c + Tile<BS>::kTile - 1) / Tile<BS>::kTile;
  bsr_spgemm_kernel<BS, TA, TB>
      <<<static_cast<unsigned>(tiles), kThreads, bytes, r.stream>>>(r);
}

template <typename TA, typename TB>
struct BsrSpgemm {
  static void launch(const BsrArgs& r) {
    if (r.bs == 8) {
      launch_bs<8, TA, TB>(r);
    } else {
      launch_bs<16, TA, TB>(r);
    }
  }
};

}  // namespace

// int bsr_spgemm_launch(a, a_code, nnzb_a, b, b_code, nnzb_b, contrib_a,
//                       contrib_b, contrib_n, nnzb_c, t_max, out, bs, stream)
//   -> cudaGetLastError(); cudaErrorInvalidValue for a block size other than
//   8 or 16, an unknown dtype code or more tiles than a grid holds;
//   cudaErrorMisalignedAddress unless every array starts on 16 bytes.
extern "C" int bsr_spgemm_launch(const void* a, int a_code, int64_t nnzb_a,
                                 const void* b, int b_code, int64_t nnzb_b,
                                 const int32_t* contrib_a, const int32_t* contrib_b,
                                 const int32_t* contrib_n, int64_t nnzb_c,
                                 int64_t t_max, void* out, int bs, void* stream) {
  if (bs != 8 && bs != 16) return static_cast<int>(cudaErrorInvalidValue);
  if (nnzb_c == 0) return static_cast<int>(cudaGetLastError());
  if (nnzb_c / 64 >= INT_MAX || nnzb_a > INT_MAX || nnzb_b > INT_MAX || t_max < 1 ||
      t_max > INT_MAX / 64)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
       reinterpret_cast<uintptr_t>(contrib_a) | reinterpret_cast<uintptr_t>(contrib_b) |
       reinterpret_cast<uintptr_t>(contrib_n) | reinterpret_cast<uintptr_t>(out)) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const BsrArgs r{a,      nnzb_a, b,   nnzb_b, contrib_a, contrib_b, contrib_n,
                  nnzb_c, t_max,  out, bs,     static_cast<cudaStream_t>(stream)};
  return replay::dispatch<BsrSpgemm>(a_code, b_code, r);
}

extern "C" const char* bsr_spgemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
