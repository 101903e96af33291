// spgemm_symbolic: the symbolic phase over B's bitmask rows, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/spgemm_symbolic.py
// (spgemm_symbolic, body _kernel). For every row i of C = A*B:
//   out[i] = popcount( OR over r < a_nnz[i] of bm[a_idx[i, r], :] )
// where bm is B's structure as an (n, k32) array of 32-bit words (column c is
// bit c & 31 of word c >> 5). A's padded slots (r >= a_nnz[i]) are masked;
// a live A column id is clamped into [0, n), as the reference's gather clamps.
//
// What bounds it: bytes, B's bitmask read once (n * k32 * 4 bytes), A's live
// column ids and the row sizes; a few integer operations per word.
//
// Design: read the bitmask once, then only its nonzero words.
//  1. index_rows (a warp per B row) sweeps the bitmask once and writes its
//     nonzero-word index: per row j, one summary bit per word (word w of the
//     row is nonzero: bit w & 31 of summary word w >> 5; g = ceil(k32 / 32)
//     summary words a row) and meta[j] = (first nonzero word, last nonzero
//     word, nonzero words) -- the paper's compressed bitmask kept at a fixed
//     place, so no scan and no host wait is needed. (An RMAT B row of ~7.5
//     columns has ~7.5 nonzero words among k32 = 2,048.)
//  2. warp_rows: a warp per C row of at most 32 live A entries whose selected
//     B rows hold at most kWarpWork nonzero words in all; it ORs only those
//     words into a dense accumulator of k32 words in shared memory (the
//     paper's dense accumulator applied to the symbolic phase), then counts
//     the bits of the words between the first and the last it touched and
//     zeroes them again, so the accumulator is zero between rows. Lanes walk
//     the row's (A entry, summary word) pairs flat, each pair's set bits in
//     batches of four loads. A wider row goes to a device list of hub rows.
//  3. hub_rows: a block per hub row on a persistent grid, the same walk over
//     the row's A entries in chunks of the block, reading the list's count
//     from device memory.
// The rows of one B row's index have distinct word indices, so a lane's
// shared atomicOr only collides with another entry's. Where k32 exceeds
// kWarpWords (too few warps' accumulators fit a block) every row is a hub
// row; where it exceeds kSharedWords the hub blocks' accumulators are
// device-memory slices (zeroed by the launcher, atomics in L2). Integer ORs: bitwise equal to the plain version.
#include <climits>

#include "ell_common.cuh"

namespace {

constexpr int kIndexThreads = 256;
constexpr int kIndexUnroll = 8;      // words in flight per lane
constexpr int kWarpThreads = 256;    // warp_rows: 8 warps a block at most
constexpr int kHubThreads = 512;     // hub_rows: a block per row
constexpr int kWarpEntries = 32;     // live A entries of a warp row, at most
constexpr int kWarpWords = 8192;     // k32 up to which warps take rows (32 KiB)
constexpr int kWarpWork = 1024;      // nonzero words a warp row ORs, at most
constexpr int kStageBytes = 16;      // per thread: scanned pairs, B row, first summary word
// the hub blocks' shared accumulator, at most (words)
constexpr int kSharedWords = (ell::kSmemBytes - kHubThreads * kStageBytes - 1024) / 4 / 1024 * 1024;
constexpr unsigned kFull = 0xffffffffu;

// A warp's dynamic shared memory in warp_rows: its staging, then k32 words,
// rounded up to 16 bytes so that the next warp's staging stays aligned.
__host__ __device__ __forceinline__ int64_t warp_stride(int64_t k32) {
  return 32 * kStageBytes + ((k32 * 4 + 15) & ~int64_t(15));
}

struct SymArgs {
  const int32_t* a_idx;
  int64_t r_a;
  const int32_t* a_nnz;
  const uint32_t* bm;
  int64_t n;
  int64_t k32;
  int32_t* out;
  int64_t m;
  int64_t g;                // summary words a B row
  const uint32_t* summary;  // (n, g)
  const int4* meta;         // (n,): first, last nonzero word (INT_MAX, -1 if none), count
  int* hub_count;
  int* hub_list;            // (m,)
  uint32_t* dev_acc;        // hub blocks' device slices (k32 words each) or nullptr
};

__global__ void __launch_bounds__(kIndexThreads)
    index_rows(const uint32_t* __restrict__ bm, int64_t n, int64_t k32, int64_t g,
               uint32_t* __restrict__ summary, int4* __restrict__ meta) {
  const int lane = threadIdx.x & 31;
  const int64_t j = static_cast<int64_t>(blockIdx.x) * (kIndexThreads / 32) + (threadIdx.x >> 5);
  if (j >= n) return;  // the same for the whole warp
  const uint32_t* row = bm + j * k32;
  uint32_t* srow = summary + j * g;
  int lo = INT_MAX, hi = -1, cnt = 0;
  uint32_t mine = 0;  // summary word (group & ~31) + lane, stored every 32 groups
  for (int64_t g0 = 0; g0 < g; g0 += kIndexUnroll) {
    uint32_t w[kIndexUnroll];
#pragma unroll
    for (int u = 0; u < kIndexUnroll; ++u) {
      const int64_t idx = (g0 + u) * 32 + lane;
      w[u] = g0 + u < g && idx < k32 ? __ldg(row + idx) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kIndexUnroll; ++u) {
      const int64_t grp = g0 + u;
      if (grp >= g) break;  // the same for the whole warp
      const uint32_t bits = __ballot_sync(kFull, w[u] != 0u);
      if (bits) {
        cnt += __popc(bits);
        lo = min(lo, static_cast<int>(grp * 32) + __ffs(bits) - 1);
        hi = max(hi, static_cast<int>(grp * 32) + 31 - __clz(bits));
      }
      if (lane == (grp & 31)) mine = bits;
      if ((grp & 31) == 31 || grp == g - 1) {
        const int64_t s = (grp & ~int64_t(31)) + lane;
        if (s < g) srow[s] = mine;
      }
    }
  }
  if (lane == 0) meta[j] = make_int4(lo, hi, cnt, 0);
}

// A team's walk over its staged chunk of n_e A entries: flat over the
// (entry, summary word) pairs whose inclusive scan is st_off; each pair's
// nonzero words are ORed into acc (k32 words), four loads at a time. lo and
// hi track the words this lane touched.
__device__ __forceinline__ void or_chunk(const SymArgs& s, const int64_t* st_off,
                                         const int* st_j, const int* st_s, int n_e,
                                         int lane, int team, uint32_t* acc, int& lo, int& hi) {
  const int64_t total = st_off[n_e - 1];
  int q = 0;
  for (int64_t p = lane; p < total; p += team) {
    q = ell::find_entry(st_off, n_e, p, q);
    const int64_t j = st_j[q];
    const int64_t grp = st_s[q] + p - (q > 0 ? st_off[q - 1] : 0);
    uint32_t bits = __ldg(s.summary + j * s.g + grp);
    const uint32_t* words = s.bm + j * s.k32 + grp * 32;
    while (bits) {
      uint32_t v[4];
      int b[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        b[u] = -1;
        if (bits) {
          b[u] = __ffs(bits) - 1;
          bits &= bits - 1;
          v[u] = __ldg(words + b[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (b[u] < 0) break;
        const int w = static_cast<int>(grp * 32) + b[u];
        atomicOr(acc + w, v[u]);
        lo = min(lo, w);
        hi = max(hi, w);
      }
    }
  }
}

// Live A entry r of row i: its B row, first summary word, summary words
// (0 for an empty B row) and nonzero words; zeros past live_a.
__device__ __forceinline__ void load_entry(const SymArgs& s, int64_t i, int64_t r,
                                           int64_t live_a, int& j, int& s0,
                                           long long& pairs, int& words) {
  j = 0;
  s0 = 0;
  pairs = 0;
  words = 0;
  if (r < live_a) {
    j = static_cast<int>(ell::clamp_row(__ldg(s.a_idx + i * s.r_a + r), s.n));
    const int4 mt = __ldg(s.meta + j);
    if (mt.y >= 0) {
      s0 = mt.x >> 5;
      pairs = (mt.y >> 5) - s0 + 1;
      words = mt.z;
    }
  }
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(kFull, x, d);
  return x;
}

// Rows of at most kWarpEntries entries and kWarpWork nonzero words, a warp
// each (dynamic shared memory: per warp its staging, then k32 words); the
// others are appended to the hub list (all of them when hub_only).
__global__ void __launch_bounds__(kWarpThreads)
    warp_rows(const SymArgs s, bool hub_only) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int wpb = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* mine = smem + warp * warp_stride(s.k32);
  int64_t* st_off = reinterpret_cast<int64_t*>(mine);
  int* st_j = reinterpret_cast<int*>(mine + 32 * 8);
  int* st_s = reinterpret_cast<int*>(mine + 32 * 12);
  uint32_t* acc = reinterpret_cast<uint32_t*>(mine + 32 * kStageBytes);
  if (!hub_only)
    for (int64_t w = lane; w < s.k32; w += 32) acc[w] = 0u;
  __syncwarp();
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * wpb + warp; i < s.m;
       i += static_cast<int64_t>(gridDim.x) * wpb) {
    const int64_t live_a = ell::clamp_count(__ldg(s.a_nnz + i), s.r_a);
    if (live_a == 0) {
      if (lane == 0) s.out[i] = 0;
      continue;
    }
    int j, s0, words;
    long long pairs;
    load_entry(s, i, lane, live_a, j, s0, pairs, words);
    if (hub_only || live_a > kWarpEntries || warp_sum(words) > kWarpWork) {
      if (lane == 0) s.hub_list[atomicAdd(s.hub_count, 1)] = static_cast<int>(i);
      continue;
    }
    st_off[lane] = ell::team_scan(pairs, lane, 32, kFull, nullptr);
    st_j[lane] = j;
    st_s[lane] = s0;
    __syncwarp();
    int lo = INT_MAX, hi = -1;
    or_chunk(s, st_off, st_j, st_s, static_cast<int>(live_a), lane, 32, acc, lo, hi);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      lo = min(lo, __shfl_xor_sync(kFull, lo, d));
      hi = max(hi, __shfl_xor_sync(kFull, hi, d));
    }
    __syncwarp();  // every OR is in
    int count = 0;
    if (hi >= 0) {
      for (int w = lo + lane; w <= hi; w += 32) {
        count += __popc(acc[w]);
        acc[w] = 0u;
      }
    }
    count = warp_sum(count);
    if (lane == 0) s.out[i] = count;
    __syncwarp();  // the next row restages
  }
}

// Hub rows, a block each on a persistent grid: staging in dynamic shared
// memory, then the accumulator (k32 words, zeroed here) unless kDev, where it
// is the block's device slice (zeroed by the launcher).
template <bool kDev>
__global__ void __launch_bounds__(kHubThreads) hub_rows(const SymArgs s) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long warp_sums[32];
  __shared__ int s_lo, s_hi, s_count;
  const int tid = threadIdx.x, team = blockDim.x;
  int64_t* st_off = reinterpret_cast<int64_t*>(smem);
  int* st_j = reinterpret_cast<int*>(smem + team * 8);
  int* st_s = reinterpret_cast<int*>(smem + team * 12);
  uint32_t* acc = kDev ? s.dev_acc + blockIdx.x * s.k32
                       : reinterpret_cast<uint32_t*>(smem + team * kStageBytes);
  if (!kDev)
    for (int64_t w = tid; w < s.k32; w += team) acc[w] = 0u;
  const int64_t n_rows = *s.hub_count;
  for (int64_t pos = blockIdx.x; pos < n_rows; pos += gridDim.x) {
    const int64_t i = __ldg(s.hub_list + pos);
    const int64_t live_a = ell::clamp_count(__ldg(s.a_nnz + i), s.r_a);
    if (tid == 0) {
      s_lo = INT_MAX;
      s_hi = -1;
      s_count = 0;
    }
    int lo = INT_MAX, hi = -1;
    for (int64_t r0 = 0; r0 < live_a; r0 += team) {
      int j, s0, words;
      long long pairs;
      load_entry(s, i, r0 + tid, live_a, j, s0, pairs, words);
      st_off[tid] = ell::team_scan(pairs, tid, team, kFull, warp_sums);
      st_j[tid] = j;
      st_s[tid] = s0;
      __syncthreads();  // staged (and, first, the accumulator zeroed)
      const int n_e = live_a - r0 < team ? static_cast<int>(live_a - r0) : team;
      or_chunk(s, st_off, st_j, st_s, n_e, tid, team, acc, lo, hi);
      __syncthreads();  // the next chunk restages
    }
    atomicMin(&s_lo, lo);
    atomicMax(&s_hi, hi);
    __syncthreads();
    int count = 0;
    const int w_hi = s_hi;
    for (int w = w_hi < 0 ? 0 : s_lo + tid; w <= w_hi; w += team) {
      if (kDev) {
        count += __popc(__ldcg(acc + w));
        __stcg(acc + w, 0u);
      } else {
        count += __popc(acc[w]);
        acc[w] = 0u;
      }
    }
    count = warp_sum(count);
    if ((tid & 31) == 0) atomicAdd(&s_count, count);
    __syncthreads();
    if (tid == 0) s.out[i] = s_count;
    __syncthreads();  // the next row resets s_lo, s_hi, s_count
  }
}

template <typename Kernel>
int64_t persistent_blocks(Kernel kernel, int threads, int smem) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  return static_cast<int64_t>(ell::sm_count()) * (per_sm > 0 ? per_sm : 1);
}

}  // namespace

// int spgemm_symbolic_launch(a_idx, r_a, a_nnz, bm, n, k32, out, m, index,
//                            dev_acc, dev_words, stream) -> cudaGetLastError()
// index: int32 scratch of the wrapper's index_ints(n, k32, m): meta (4 n) |
// hub count (4) | hub list (m) | summary (n * ceil(k32 / 32)). dev_acc:
// dev_words int32 of device slices (k32 words per hub block), nullptr when
// k32 <= kSharedWords.
extern "C" int spgemm_symbolic_launch(const int32_t* a_idx, int64_t r_a,
                                      const int32_t* a_nnz, const void* bm,
                                      int64_t n, int64_t k32, int32_t* out,
                                      int64_t m, int32_t* index, int32_t* dev_acc,
                                      int64_t dev_words, void* stream) {
  if (m == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t g = (k32 + 31) / 32;
  SymArgs s{a_idx, r_a, a_nnz, static_cast<const uint32_t*>(bm), n, k32, out, m, g,
            reinterpret_cast<const uint32_t*>(index + 4 * n + 4 + m),
            reinterpret_cast<const int4*>(index), index + 4 * n, index + 4 * n + 4,
            reinterpret_cast<uint32_t*>(dev_acc)};
  cudaMemsetAsync(s.hub_count, 0, sizeof(int), st);
  const unsigned index_blocks =
      static_cast<unsigned>((n + kIndexThreads / 32 - 1) / (kIndexThreads / 32));
  index_rows<<<index_blocks, kIndexThreads, 0, st>>>(
      s.bm, n, k32, g, const_cast<uint32_t*>(s.summary), const_cast<int4*>(s.meta));

  // warps take the small rows where k32 words fit beside seven others
  const bool hub_only = k32 > kWarpWords;
  const int64_t fit = (ell::kSmemBytes - 1024) / warp_stride(k32);
  const int wpb = hub_only ? 1 : static_cast<int>(fit < 8 ? fit : 8);
  const int warp_smem = hub_only ? 0 : wpb * static_cast<int>(warp_stride(k32));
  int64_t blocks = persistent_blocks(warp_rows, wpb * 32, warp_smem);
  if (blocks > (m + wpb - 1) / wpb) blocks = (m + wpb - 1) / wpb;
  warp_rows<<<static_cast<unsigned>(blocks), wpb * 32, warp_smem, st>>>(s, hub_only);

  if (k32 <= kSharedWords) {
    const int smem = kHubThreads * kStageBytes + static_cast<int>(k32) * 4;
    int64_t hubs = persistent_blocks(hub_rows<false>, kHubThreads, smem);
    if (hubs > m) hubs = m;
    hub_rows<false><<<static_cast<unsigned>(hubs), kHubThreads, smem, st>>>(s);
  } else {
    // as many device slices as the wrapper gave (none: a launch of 0 blocks fails)
    int64_t hubs = persistent_blocks(hub_rows<true>, kHubThreads, kHubThreads * kStageBytes);
    if (hubs > m) hubs = m;
    if (hubs > dev_words / k32) hubs = dev_words / k32;
    if (hubs > 0) cudaMemsetAsync(dev_acc, 0, hubs * k32 * sizeof(int32_t), st);
    hub_rows<true><<<static_cast<unsigned>(hubs), kHubThreads, kHubThreads * kStageBytes,
                     st>>>(s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spgemm_symbolic_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
