// spgemm_numeric: the KKDENSE numeric phase over ELL operands, on Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/spgemm_numeric.py
// (spgemm_numeric, body _kernel). Contract in ell_common.cuh: for row i, a
// dense f32 accumulator over C's columns takes every product of the row, and
// C's values are read from it at c_idx[i, :c_nnz[i]] (a column id clamps into
// [0, k), as the reference's gather does); a product whose B column lies
// outside [0, k) is dropped. The output is written in A's dtype (one rounding
// of the f32 sum, as the plain version's cast).
//
// What bounds it: bytes. Each live A entry and each visited B slot is read
// (4 + 2..4 bytes each), C's structure once, C's values written once; there
// are 2 flops per product. The (m, r_c) output is written whole, zeros past
// c_nnz included: at RMAT-16 A*A those zeros (8.6 GB) are nearly all of the
// bound, and the launcher writes them first with one fill at the card's
// memory rate (cudaMemsetAsync; 2.6 ms there on an NVIDIA H100 80GB HBM3 at
// 700 W); the kernels then write each row's c_nnz values.
//
// Design. A row's products can only matter inside its window [lo, hi], the
// span of its clamped C columns; a product outside it is dropped unread. The
// accumulator is dense over the window, and, as the paper's KKDENSE resets
// only what it touches, only the row's C columns are zeroed before its
// products and read after them: the work is O(products + c_nnz), whatever
// the window. A slot no C column names may collect products; it is never
// read. The window only sizes the accumulator, so rows are binned by it:
//  1. bin_rows (a warp per row) finds each row's window and appends the row
//     to its class's list (block-aggregated atomics on device counters);
//  2. one kernel per class (kClasses) walks its list on a persistent grid,
//     reading the count from device memory: the host never waits. A class
//     gives each row a team of lanes and its own shared-memory slice of the
//     class's window: 4 or 16 lanes of a warp for windows of at most 64 or
//     512 columns (many rows a block, no block-wide barrier), a block for
//     wider ones. The wide class holds the first kWideCols columns of the
//     window in shared memory and the rest in a device-memory slice of its
//     persistent block (L2-resident), so a row of any window is walked in one
//     pass: no product is read twice. (At RMAT-16 A*A, 33,033 of the 33,355
//     non-empty rows are wide and hold all but 701 of the 122.8M products;
//     RMAT columns crowd the low ids, so 29% of the products fall past the
//     26,624 shared columns, 3% past 53,248.)
// A team walks its row's products flat, one product per lane (K3's walk:
// stage `team` A entries, scan their B widths, binary-search a product's
// entry), four products a step so that their loads are in flight together,
// and adds each with a shared-memory (or, past kWideCols, an L2) atomicAdd;
// the next row's id, window, widths and first A entries load meanwhile.
// The atomics add in no fixed order: results agree with the plain version to
// f32 rounding. The wide class is bound by latency, a row at a time per
// block: two 512-thread blocks an SM (two rows in flight, 26,624 shared
// columns each) measured faster on an H100 than one 1,024-thread block with
// twice the shared window, and four blocks slower; writing the zeros on a
// second stream beside the numeric kernels measured slower than one fill
// before them (PERF.md).
//
// Scratch (int32, ell::EllArgs::scratch, sized by the wrapper's
// scratch_ints): class counts (2 * kNumClasses ints, the second half
// padding) | windows (lo, hi) of the m rows | kNumClasses lists of m row ids.
// Device slices (ell::EllArgs::acc): (k - kWideCols) f32 per wide block, as
// many blocks as acc_floats holds, at most the grid.
#include <climits>
#include <type_traits>

#include "ell_common.cuh"

namespace {

struct WindowClass {
  int cols;     // the widest window of the class (its slice, f32); 0: wide
  int team;     // lanes per row: up to 32 share a warp; a larger team is the block
  int threads;  // per block
};

constexpr int kWideBlocks = 2;  // wide blocks an SM
constexpr int kWideThreads = 1024 / kWideBlocks;

// K4's window classes, in order (CLASS_COLS in kernels/spgemm_numeric.py
// mirrors the columns): a row goes to the first class whose columns hold its
// window, and past the last shared one to the wide class.
constexpr WindowClass kClasses[] = {
    {64, 4, 256}, {512, 16, 256}, {4096, 256, 256}, {16384, 512, 512},
    {0, kWideThreads, kWideThreads}};
constexpr int kNumClasses = sizeof(kClasses) / sizeof(kClasses[0]);
constexpr int kStageBytes = 16;  // per thread: scanned B width, B row, A value
// the wide class's shared columns: what a block's share of an SM leaves
// after staging and the static scan buffer (rounded down to 1,024 columns)
constexpr int kWideCols =
    ((ell::kSmemBytes / kWideBlocks - kWideThreads * kStageBytes - 1024) / 4) / 1024 * 1024;

// K4's pieces of a class's block: staged entries, then a slice per row.
constexpr int smem_bytes(const WindowClass& c, int slice) {
  return c.threads * kStageBytes + (c.threads / c.team) * slice * 4;
}
static_assert(smem_bytes(kClasses[kNumClasses - 1], kWideCols) + 1024 <=
                  ell::kSmemBytes / kWideBlocks,
              "the wide class exceeds its share of shared memory");

constexpr int kBinThreads = 256;
constexpr int kBinRowsPerWarp = 8;
constexpr int kBinRows = kBinThreads / 32 * kBinRowsPerWarp;  // rows per block
constexpr unsigned kFull = 0xffffffffu;

// The first class whose columns hold `window` (the limits are compile-time
// constants: kClasses itself lives on the host).
template <int c = 0>
__device__ __forceinline__ int class_of(int64_t window) {
  if constexpr (c == kNumClasses - 1) {
    return c;
  } else {
    constexpr int cols = kClasses[c].cols;
    return window <= cols ? c : class_of<c + 1>(window);
  }
}

// A warp per row: the window of its clamped C columns and, unless the row is
// empty, its place in its class's list.
__global__ void __launch_bounds__(kBinThreads)
    bin_rows(const ell::EllArgs e, int* counts, int2* windows, int* lists) {
  __shared__ int s_count[kNumClasses], s_base[kNumClasses];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x < kNumClasses) s_count[threadIdx.x] = 0;
  __syncthreads();
  const int64_t row0 = (static_cast<int64_t>(blockIdx.x) * (kBinThreads / 32) + warp) *
                       kBinRowsPerWarp;
  int cls[kBinRowsPerWarp], slot[kBinRowsPerWarp];
#pragma unroll
  for (int q = 0; q < kBinRowsPerWarp; ++q) {
    const int64_t i = row0 + q;
    cls[q] = -1;
    slot[q] = 0;
    if (i >= e.m) continue;  // the same for the whole warp
    const int64_t cn = ell::clamp_count(__ldg(e.c_nnz + i), e.r_c);
    if (cn == 0) continue;
    const int32_t* crow = e.c_idx + i * e.r_c;
    int lo = INT_MAX, hi = -1;
    for (int64_t s = lane; s < cn; s += 32) {
      const int c = static_cast<int>(ell::clamp_row(__ldg(crow + s), e.k));
      lo = min(lo, c);
      hi = max(hi, c);
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      lo = min(lo, __shfl_xor_sync(kFull, lo, d));
      hi = max(hi, __shfl_xor_sync(kFull, hi, d));
    }
    cls[q] = class_of(static_cast<int64_t>(hi) - lo + 1);
    if (lane == 0) {
      windows[i] = make_int2(lo, hi);
      slot[q] = atomicAdd(&s_count[cls[q]], 1);
    }
  }
  __syncthreads();
  if (threadIdx.x < kNumClasses)
    s_base[threadIdx.x] = s_count[threadIdx.x] ? atomicAdd(counts + threadIdx.x,
                                                           s_count[threadIdx.x]) : 0;
  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < kBinRowsPerWarp; ++q)
      if (cls[q] >= 0)
        lists[cls[q] * e.m + s_base[cls[q]] + slot[q]] = static_cast<int>(row0 + q);
  }
}

// A listed row: its id, window and live widths.
struct Row {
  int64_t i;
  int lo, hi;
  int64_t cn, live_a;
};

__device__ __forceinline__ Row load_row(const ell::EllArgs& e, const int2* windows, int64_t i) {
  const int2 w = __ldg(windows + i);
  return Row{i, w.x, w.y, ell::clamp_count(__ldg(e.c_nnz + i), e.r_c),
             ell::clamp_count(__ldg(e.a_nnz + i), e.r_a)};
}

// The accumulator slot of window offset `off`: shared memory below `slice`,
// else (kWide) the block's device slice.
template <bool kWide>
__device__ __forceinline__ float* slot_of(float* acc, float* dacc, int slice, int off) {
  return (!kWide || off < slice) ? acc + off : dacc + (off - slice);
}

// Reset what row r reads: the accumulator at its C columns.
template <bool kWide>
__device__ __forceinline__ void reset_columns(const ell::EllArgs& e, const Row& r, float* acc,
                                              float* dacc, int slice, int lane, int team) {
  const int32_t* crow = e.c_idx + r.i * e.r_c;
  for (int64_t s = lane; s < r.cn; s += team) {
    const int off = static_cast<int>(ell::clamp_row(__ldg(crow + s), e.k)) - r.lo;
    if (!kWide || off < slice) acc[off] = 0.f;
    else __stcg(dacc + (off - slice), 0.f);
  }
}

// The rows of class `cls` on a persistent grid; `slice` f32 columns of
// shared memory per row (the class's columns, or k if smaller). kWide: the
// window's columns past `slice` go to the block's `dev_cols` columns of
// e.acc, zeroed and read past L1 (the adds are L2 atomics). A team's rows
// are pipelined: the next row's id, window, widths and first A entries load
// while this row is walked, and its columns are zeroed right after this
// row's emit, so a row starts with its staging. Each lane walks four
// products a step, their loads in flight together.
template <int kThreads, bool kWide, typename TA, typename TB>
__global__ void __launch_bounds__(kThreads, kThreads >= 1024 ? 1 : 1024 / kThreads)
    numeric_rows(const ell::EllArgs e, const int* counts, const int2* windows,
                 const int* lists, int cls, int slice, int team, int64_t dev_cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long warp_sums[32];
  const int per_block = blockDim.x / team;
  const int t = threadIdx.x / team;
  const int lane = threadIdx.x & (team - 1);
  const unsigned tmask = ell::team_mask(team);
  int64_t* st_off = reinterpret_cast<int64_t*>(smem) + t * team;
  int* st_j = reinterpret_cast<int*>(smem + blockDim.x * 8) + t * team;
  float* st_av = reinterpret_cast<float*>(smem + blockDim.x * 12) + t * team;
  float* acc = reinterpret_cast<float*>(smem + blockDim.x * kStageBytes) +
               static_cast<int64_t>(t) * slice;
  float* dacc = kWide ? e.acc + blockIdx.x * dev_cols : nullptr;
  const TA* a_val = static_cast<const TA*>(e.a_val);
  const TB* b_val = static_cast<const TB*>(e.b_val);
  const int64_t count = counts[cls];
  const int* list = lists + cls * e.m;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * per_block;

  // a team's rows: the same for every lane of it (and, for a block-wide
  // team, for the block)
  int64_t pos = static_cast<int64_t>(blockIdx.x) * per_block + t;
  if (pos >= count) return;
  Row row = load_row(e, windows, __ldg(list + pos));
  int j;
  float av;
  long long nb;
  ell::load_entry(e, a_val, row.i, lane, row.live_a, j, av, nb);
  reset_columns<kWide>(e, row, acc, dacc, slice, lane, team);
  for (;;) {
    const bool more = pos + stride < count;
    const int64_t next_i = more ? __ldg(list + pos + stride) : 0;
    for (int64_t r0 = 0; r0 < row.live_a; r0 += team) {
      st_off[lane] = ell::team_scan(nb, lane, team, tmask, warp_sums);
      st_j[lane] = j;
      st_av[lane] = av;
      ell::team_sync(team, tmask);  // staged; and (first chunk) the columns zeroed
      // the next chunk's entry loads while this one's products are walked
      ell::load_entry(e, a_val, row.i, r0 + team + lane, row.live_a, j, av, nb);
      const int n_e = row.live_a - r0 < team ? static_cast<int>(row.live_a - r0) : team;
      const int64_t total = st_off[n_e - 1];
      int q = 0;
      for (int64_t p0 = lane; p0 < total; p0 += 4 * static_cast<int64_t>(team)) {
        int64_t bs[4];
        float a4[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int64_t p = p0 + u * static_cast<int64_t>(team);
          bs[u] = -1;
          if (p < total) {
            q = ell::find_entry(st_off, n_e, p, q);
            bs[u] = static_cast<int64_t>(st_j[q]) * e.r_b + p - (q > 0 ? st_off[q - 1] : 0);
            a4[u] = st_av[q];
          }
        }
        int col[4];
        float bv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (bs[u] >= 0) {
            col[u] = __ldg(e.b_idx + bs[u]);
            bv[u] = replay::load_val(b_val, bs[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          // a column outside the window (or outside [0, k)) is dropped
          if (bs[u] >= 0 && col[u] >= row.lo && col[u] <= row.hi)
            atomicAdd(slot_of<kWide>(acc, dacc, slice, col[u] - row.lo), a4[u] * bv[u]);
        }
      }
      ell::team_sync(team, tmask);  // the next chunk restages
    }
    Row next{};
    if (more) next = load_row(e, windows, next_i);
    const int32_t* crow = e.c_idx + row.i * e.r_c;
    TA* orow = static_cast<TA*>(e.out) + row.i * e.r_c;
    for (int64_t s = lane; s < row.cn; s += team) {
      const int off = static_cast<int>(ell::clamp_row(__ldg(crow + s), e.k)) - row.lo;
      const float v = (!kWide || off < slice) ? acc[off] : __ldcg(dacc + (off - slice));
      replay::store_val(orow, s, v);
    }
    if (!more) break;
    ell::load_entry(e, a_val, next.i, lane, next.live_a, j, av, nb);
    ell::team_sync(team, tmask);  // every lane has emitted before the slice is reset
    reset_columns<kWide>(e, next, acc, dacc, slice, lane, team);
    row = next;
    pos += stride;
  }
}

// Class c's blocks an SM at the shared memory last asked for, per launch
// site (dtype pair and class: the instantiations differ in registers). Plain
// globals of this file, not statics of a template: those would be one
// object across every library loaded with the same names.
int g_occupancy[3][3][kNumClasses];
int g_occupancy_smem[3][3][kNumClasses];

template <typename T> constexpr int type_index() {
  return sizeof(T) == 4 ? 0 : (std::is_same<T, __half>::value ? 1 : 2);
}

template <typename TA, typename TB>
struct SpgemmNumeric {

  template <int kThreads, bool kWide>
  static void launch_class(const ell::EllArgs& e, const int* counts, const int2* windows,
                           const int* lists, int c, int64_t dev_cols) {
    const WindowClass& wc = kClasses[c];
    const int cols = kWide ? kWideCols : wc.cols;
    const int slice = static_cast<int>(e.k < cols ? e.k : cols);
    const int smem = smem_bytes(wc, slice);
    auto kernel = numeric_rows<kThreads, kWide, TA, TB>;
    int& occupancy = g_occupancy[type_index<TA>()][type_index<TB>()][c];
    int& occupancy_smem = g_occupancy_smem[type_index<TA>()][type_index<TB>()][c];
    if (occupancy_smem != smem) {
      // classes share a kernel: its limit is always the block's most
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           ell::kSmemBytes - 1024);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occupancy, kernel, wc.threads, smem);
      occupancy_smem = smem;
    }
    const int per_block = wc.threads / wc.team;
    int64_t blocks = static_cast<int64_t>(ell::sm_count()) * (occupancy > 0 ? occupancy : 1);
    const int64_t needed = (e.m + per_block - 1) / per_block;
    if (blocks > needed) blocks = needed;
    // the device slices the wrapper allotted; none (0 blocks) fails the launch
    if (kWide && dev_cols > 0 && blocks > e.acc_floats / dev_cols)
      blocks = e.acc_floats / dev_cols;
    kernel<<<static_cast<unsigned>(blocks), wc.threads, smem, e.stream>>>(
        e, counts, windows, lists, c, slice, wc.team, dev_cols);
  }

  static void launch(const ell::EllArgs& e) {
    if (e.m == 0) return;
    // scratch: counts (2 * kNumClasses ints, so the windows are 8-byte
    // aligned), windows (2 * m), lists (kNumClasses * m)
    int* counts = e.scratch;
    int2* windows = reinterpret_cast<int2*>(e.scratch + 2 * kNumClasses);
    int* lists = e.scratch + 2 * kNumClasses + 2 * e.m;
    // the wide class's columns past kWideCols live in device slices
    const int64_t dev_cols = e.k > kWideCols ? e.k - kWideCols : 0;
    // C's zeros first, one fill at the card's memory rate; the kernels then
    // write each row's c_nnz values
    cudaMemsetAsync(e.out, 0, e.m * e.r_c * sizeof(TA), e.stream);
    cudaMemsetAsync(counts, 0, kNumClasses * sizeof(int), e.stream);
    const unsigned bin_blocks = static_cast<unsigned>((e.m + kBinRows - 1) / kBinRows);
    bin_rows<<<bin_blocks, kBinThreads, 0, e.stream>>>(e, counts, windows, lists);
    launch_class<256, false>(e, counts, windows, lists, 0, 0);
    launch_class<256, false>(e, counts, windows, lists, 1, 0);
    launch_class<256, false>(e, counts, windows, lists, 2, 0);
    launch_class<512, false>(e, counts, windows, lists, 3, 0);
    launch_class<kWideThreads, true>(e, counts, windows, lists, 4, dev_cols);
  }
};

}  // namespace

ELL_C_API(spgemm_numeric, SpgemmNumeric)
