// spgemm_lp: the KKLP numeric phase over ELL operands -- the paper's
// two-level linear-probing hash accumulator -- on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/spgemm_lp.py (spgemm_lp, body
// _kernel and _lp_probe). Contract in ell_common.cuh, with B's padded slots
// masked by b_nnz; a product whose B column lies outside [0, k) is dropped.
// Per row, products go into an L1 table with the paper's 50% rule (cutoff
// min(s1 / 2, s1 - 1) keys; past it a *new* key is rejected while keys
// already in L1 still accumulate) and rejected products into an L2 table that
// holds every spill. C's value at column c is L1[c] + L2[c]. The wrapper
// zeroes the (m, r_c) output; the kernel writes each row's c_nnz values.
//
// What bounds it: bytes, as spgemm_numeric.cu (live A entries, live B slots,
// C's structure, the (m, r_c) output written whole; 2 flops per product),
// plus the tables' traffic, which stays in shared memory for all but the
// widest rows. At RMAT-16 A*A the output's zeros past c_nnz are nearly all
// of the bytes: the wrapper writes them with one fill at the card's memory
// rate.
//
// Design. Each key's products are summed in one table unless a race puts
// the key in both (below), so a table needs no more room than the row's
// keys. With s2 = the next power of two >= 2 * c_nnz[i] (at least 8): a row
// whose c_nnz is above the cutoff of the caller's l1_size spills, with an L1
// of l1_size slots and an L2 of s2; every other row (and every row when
// l1_size is not forced) has one table of s2 slots, which its c_nnz keys
// cannot push past half full, so a forced l1_size never allots more than a
// spilling row needs. A slot is an int key (-1 = empty) beside its f32
// value, so a probe and its add touch one 32-byte sector of a table in
// device memory. The wrapper sorts the non-empty rows by size class (kClasses): a
// class's shared memory is its largest table, so a row shares its SM with as
// many others as their tables allow. A class gives each row a team of lanes:
// 4 to 32 lanes of a warp for tables of at most 512 slots (many rows a
// block, each with its own table slice), a whole block of 128 to 1,024
// threads above that, and 1,024 threads with the tables in device memory,
// allocated by the wrapper, for rows beyond 16,384 slots. (Cutting such a
// row into column windows, a block each with a shared table, every window
// rereading the row's products, measured slower at RMAT-16 A*A: PERF.md.)
//
// A team walks its row's products flat, one product per lane, so neither a
// short B row nor a short A row leaves lanes idle: it stages `team` A entries
// (B row, A value, B width), scans the widths, and lane l takes products
// l, l + team, ...; a binary search over the scanned widths finds a product's
// A entry, and consecutive lanes read consecutive slots of a B row.
//
// Insert: probe linearly from the key's multiplicative hash (lp_hash); a slot
// holding the key takes an atomicAdd; an empty slot is claimed with
// atomicCAS(-1 -> key). Only L1 of a row that can spill checks the cutoff (a
// shared counter of claimed slots); elsewhere no cutoff can be reached and
// the insert skips it. Probes stop after s slots, so a full table cannot hang
// the kernel. Concurrent inserts may push L1 a little past its cutoff (two
// threads pass the check and both claim), and a key that one thread spilled
// may enter L1 through another: the emit adds L1 and L2 for every key, so
// such a key is still summed once per product. The atomics add in no fixed
// order: results agree with the plain version to f32 rounding, not bit for
// bit.
//
// Lost products. The tables are sized from c_nnz, the caller's count of the
// row's distinct columns; a caller may pass a structure with fewer columns
// than the row's products reach (ops.numeric_values and spgemm_lp accept any
// structure), and the row's last table (L2, or its only table) then fills.
// An insert that finds no slot there marks the row: the team votes, skips
// the emit, and appends the row to lost_rows. The wrapper reads the count
// (one wait) and runs just those rows again with size_counts = their
// product counts, which bound their distinct keys, in tables in device
// memory that cannot fill; that pass writes their outputs.
#include "ell_common.cuh"

namespace {

struct SizeClass {
  int slots;    // the largest table (L1 + L2 slots) of the class; 0: device memory
  int team;     // lanes per row: 4 to 32 share a warp, more take a block
  int threads;  // per block
};

// K3's size classes, in the order the wrapper sorts rows (CLASS_SLOTS in
// kernels/spgemm_lp.py mirrors the slots): a row goes to the first class
// whose slots hold its tables, and past the last shared one to device memory.
constexpr SizeClass kClasses[] = {
    {16, 4, 256},     {32, 8, 256},     {64, 16, 256},    {128, 32, 256},
    {256, 32, 256},   {512, 32, 256},   {1024, 128, 128}, {2048, 256, 256},
    {4096, 256, 256}, {8192, 512, 512}, {16384, 1024, 1024}, {0, 1024, 1024}};
constexpr int kNumClasses = sizeof(kClasses) / sizeof(kClasses[0]);

// Dynamic shared memory of a block: per thread a staged A entry (scanned
// B width, B row, A value), per row its tables and its L1 claim counter.
constexpr int smem_bytes(const SizeClass& c) {
  return c.threads * 16 + (c.threads / c.team) * (4 + 8 * c.slots);
}

constexpr int max_smem_bytes() {
  int most = 0;
  for (const SizeClass& c : kClasses) most = smem_bytes(c) > most ? smem_bytes(c) : most;
  return most;
}
static_assert(max_smem_bytes() <= ell::kSmemBytes, "a class exceeds 227 KiB of shared memory");

// A key's home slot in a table of `size` (a power of two) slots: Knuth's
// multiplicative hash, the top log2(size) bits of key * 2654435761 (mod
// 2^32). RMAT column ids are not permuted and their low bits are mostly 0,
// so `key & (size - 1)` piles a row's keys onto a few home slots and linear
// probing turns the pile into long runs. SPGEMM_LP_IDENTITY_HASH builds that
// masked identity for scripts/k3_variants.py; the port never defines it.
__device__ __forceinline__ int64_t lp_hash(int key, int64_t size) {
#ifdef SPGEMM_LP_IDENTITY_HASH
  return key & (size - 1);
#else
  const int bits = 63 - __clzll(size);
  const uint32_t h = static_cast<uint32_t>(key) * 2654435761u;
  return bits == 0 ? 0 : static_cast<int64_t>(h >> (32 - bits));
#endif
}

__device__ __forceinline__ int64_t next_pow2(int64_t x) {
  int64_t p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Insert-or-accumulate (key, v) into the table; false when the key was
// rejected (kCutoff: `cutoff` keys claimed; or no slot within `size` probes).
// A table of `size` slots at `tab`: slot p's key at tab[2p], its value's
// bits at tab[2p + 1].
template <bool kCutoff>
__device__ __forceinline__ bool lp_insert(int* tab, int64_t size, int64_t cutoff,
                                          int* used, int key, float v) {
  const int64_t mask = size - 1;
  int64_t p = lp_hash(key, size);
  for (int64_t probe = 0; probe < size; ++probe) {
    int* slot = tab + 2 * p;
    const int held = *reinterpret_cast<volatile int*>(slot);
    if (held == key) {
      atomicAdd(reinterpret_cast<float*>(slot + 1), v);
      return true;
    }
    if (held == -1) {
      if (kCutoff && *reinterpret_cast<volatile int*>(used) >= cutoff) return false;
      const int prev = atomicCAS(slot, -1, key);
      if (prev == -1 || prev == key) {
        if (kCutoff && prev == -1) atomicAdd(used, 1);
        atomicAdd(reinterpret_cast<float*>(slot + 1), v);
        return true;
      }
    }
    p = (p + 1) & mask;
  }
  return false;
}

__device__ __forceinline__ float lp_lookup(const int* tab, int64_t size, int key) {
  const int64_t mask = size - 1;
  int64_t p = lp_hash(key, size);
  for (int64_t probe = 0; probe < size; ++probe) {
    const int held = tab[2 * p];
    if (held == key) return __int_as_float(tab[2 * p + 1]);
    if (held == -1) return 0.f;
    p = (p + 1) & mask;
  }
  return 0.f;
}

// One team's share of a staged chunk: products lane, lane + team, ... of the
// n_e A entries whose inclusive B-width scan is st_off. A product that no
// table takes sets `lost`.
template <bool kSpill, typename TB>
__device__ __forceinline__ void walk_products(
    const ell::EllArgs& e, const TB* b_val, const int64_t* st_off, const int* st_j,
    const float* st_av, int n_e, int lane, int team, int* tab, int64_t s1,
    int64_t s2, int64_t cutoff, int* used, bool& lost) {
  const int64_t total = st_off[n_e - 1];
  int lo = 0;
  for (int64_t p = lane; p < total; p += team) {
    lo = ell::find_entry(st_off, n_e, p, lo);
    const int64_t bs = static_cast<int64_t>(st_j[lo]) * e.r_b + p -
                       (lo > 0 ? st_off[lo - 1] : 0);
    const int key = __ldg(e.b_idx + bs);
    if (key < 0 || key >= e.k) continue;  // outside [0, k)
    const float v = st_av[lo] * replay::load_val(b_val, bs);
    if (!kSpill) {
      if (!lp_insert<false>(tab, s1, 0, nullptr, key, v)) lost = true;
    } else if (!lp_insert<true>(tab, s1, cutoff, used, key, v)) {
      if (!lp_insert<false>(tab + 2 * s1, s2, 0, nullptr, key, v)) lost = true;  // L2 follows L1
    }
  }
}

// Rows rows[0, n_rows) of one class; `cap` its tables' slots (0: device
// memory, at the offsets of lp_bins), `team` its lanes per row.
// kThreads bounds the block: 256 for the packed and small classes, whose
// registers then allow six blocks an SM (40 registers, a few spilled; 32
// spilled more and ran slower on rows of a few products), 1,024 for the
// others.
template <int kThreads, typename TA, typename TB>
__global__ void __launch_bounds__(kThreads, kThreads == 1024 ? 1 : 6)
    spgemm_lp_kernel(const ell::EllArgs e, const int64_t* rows, int64_t n_rows,
                     int cap, int team) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long warp_sums[32];
  const int per_block = blockDim.x / team;
  const int t = threadIdx.x / team;
  const int lane = threadIdx.x & (team - 1);
  const int64_t pos = static_cast<int64_t>(blockIdx.x) * per_block + t;
  // only teams of a packed block run out of rows: block-wide teams never do
  if (pos >= n_rows) return;
  const unsigned tmask = ell::team_mask(team);
  auto team_sync = [&]() { ell::team_sync(team, tmask); };
  int64_t* st_off = reinterpret_cast<int64_t*>(smem) + t * team;
  int* st_j = reinterpret_cast<int*>(smem + blockDim.x * 8) + t * team;
  float* st_av = reinterpret_cast<float*>(smem + blockDim.x * 12) + t * team;
  int* table = reinterpret_cast<int*>(smem + blockDim.x * 16) +
               static_cast<int64_t>(t) * 2 * cap;
  int* used = reinterpret_cast<int*>(smem + blockDim.x * 16) +
              static_cast<int64_t>(per_block) * 2 * cap + t;

  // Start the loads that need only the row before the tables are cleared:
  // its sizes, this lane's first A entry and its first C column.
  const int64_t i = __ldg(rows + pos);
  const int64_t cn = ell::clamp_count(__ldg(e.c_nnz + i), e.r_c);
  const int64_t live_a = ell::clamp_count(__ldg(e.a_nnz + i), e.r_a);
  const TA* a_val = static_cast<const TA*>(e.a_val);
  const TB* b_val = static_cast<const TB*>(e.b_val);
  const int32_t* crow = e.c_idx + i * e.r_c;
  const int first_key = lane < cn ? __ldg(crow + lane) : 0;
  int j;
  float av;
  long long nb;
  ell::load_entry(e, a_val, i, lane, live_a, j, av, nb);
  if (cn == 0) return;  // the same for the whole team; the wrapper bins none
  // table sizes: the same formula as the wrapper's lp_table_slots, from c_nnz
  // or, in the pass that redoes lost rows, from the row's product count
  const int64_t sz = e.size_counts ? e.size_counts[pos] : cn;
  const int64_t s2 = next_pow2(2 * sz > 8 ? 2 * sz : 8);
  const int64_t cutoff = e.l1_size / 2 < e.l1_size - 1 ? e.l1_size / 2 : e.l1_size - 1;
  const bool spill = e.l1_size > 0 && cutoff < sz;
  const int64_t s1 = spill ? e.l1_size : s2;
  const int64_t slots = s1 + (spill ? s2 : 0);
  int* tab;
  if (cap == 0) {
    // row pos's allotment: slots [g_off[pos], g_off[pos + 1]) (see lp_bins)
    const int64_t off = e.g_off[pos];
    if (slots > e.g_off[pos + 1] - off) __trap();  // short allotment
    tab = e.g_tab + 2 * off;
  } else {
    if (slots > cap) __trap();  // a row binned into too small a class
    tab = table;
  }
  for (int64_t s = lane; s < slots; s += team)
    reinterpret_cast<int2*>(tab)[s] = make_int2(-1, 0);  // key -1, value 0.f
  if (lane == 0) *used = 0;
  team_sync();

  bool lost = false;
  for (int64_t r0 = 0; r0 < live_a; r0 += team) {
    st_off[lane] = ell::team_scan(nb, lane, team, tmask, warp_sums);
    st_j[lane] = j;
    st_av[lane] = av;
    team_sync();
    // the next chunk's entry loads while this one's products are walked
    ell::load_entry(e, a_val, i, r0 + team + lane, live_a, j, av, nb);
    const int n_e = live_a - r0 < team ? static_cast<int>(live_a - r0) : team;
    if (spill)
      walk_products<true>(e, b_val, st_off, st_j, st_av, n_e, lane, team, tab, s1, s2,
                          cutoff, used, lost);
    else
      walk_products<false>(e, b_val, st_off, st_j, st_av, n_e, lane, team, tab, s1, s2,
                           cutoff, used, lost);
    team_sync();  // the next chunk restages
  }
  if (e.lost_count != nullptr &&
      (team > 32 ? __syncthreads_or(lost) : __any_sync(tmask, lost))) {
    if (lane == 0) e.lost_rows[atomicAdd(e.lost_count, 1)] = i;  // redone by the wrapper
    return;
  }

  float* orow = static_cast<float*>(e.out) + i * e.r_c;
  for (int64_t s = lane; s < cn; s += team) {
    const int key = s == lane ? first_key : __ldg(crow + s);
    float v = lp_lookup(tab, s1, key);
    if (spill) v += lp_lookup(tab + 2 * s1, s2, key);
    orow[s] = v;
  }
}

template <typename TA, typename TB>
struct SpgemmLp {
  static void launch(const ell::EllArgs& e) {
    cudaFuncSetAttribute(spgemm_lp_kernel<256, TA, TB>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem_bytes());
    cudaFuncSetAttribute(spgemm_lp_kernel<1024, TA, TB>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem_bytes());
    if (e.lost_count != nullptr) cudaMemsetAsync(e.lost_count, 0, sizeof(int32_t), e.stream);
    const int64_t* rows = e.rows;
    for (int c = 0; c < kNumClasses; ++c) {
      const int64_t n = e.class_rows[c];
      if (n == 0) continue;
      const SizeClass& sc = kClasses[c];
      const int per_block = sc.threads / sc.team;
      const unsigned blocks = static_cast<unsigned>((n + per_block - 1) / per_block);
      if (sc.threads <= 256) {
        spgemm_lp_kernel<256, TA, TB><<<blocks, sc.threads, smem_bytes(sc), e.stream>>>(
            e, rows, n, sc.slots, sc.team);
      } else {
        spgemm_lp_kernel<1024, TA, TB><<<blocks, sc.threads, smem_bytes(sc), e.stream>>>(
            e, rows, n, sc.slots, sc.team);
      }
      rows += n;
    }
  }
};

}  // namespace

ELL_C_API(spgemm_lp, SpgemmLp)
