// spgemm_lp: the KKLP numeric phase over ELL operands -- the paper's
// two-level linear-probing hash accumulator -- on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/spgemm_lp.py (spgemm_lp, body
// _kernel and _lp_probe). Contract in ell_common.cuh, with B's padded slots
// masked by b_nnz; a product whose B column lies outside [0, k) is dropped.
// Per row, products go into an L1 table with the paper's 50% rule (cutoff
// min(s1 / 2, s1 - 1) keys; past it a *new* key is rejected while keys
// already in L1 still accumulate) and rejected products into an L2 table that
// holds every spill. C's value at column c is L1[c] + L2[c].
//
// What bounds it: bytes, as spgemm_numeric.cu (live A entries, live B slots,
// C's structure, C's values; 2 flops per product), plus the tables' traffic,
// which stays in shared memory for all but the widest rows.
//
// Design: one block per C row, tables sized per row. Each key's products are
// summed in one table unless a race puts the key in both (below), so a table
// needs no more room than the row's keys: L1 holds s1 = the next power of two
// >= 2 * c_nnz[i] (at least 8) slots, or the caller's l1_size, and L2 exists,
// with s2 = the next power of two >= 2 * c_nnz[i] slots, only where L1's
// cutoff is below c_nnz[i], i.e. where a spill can happen. A table slot is an
// int key (-1 = empty) and an f32 value. The wrapper sorts the rows into
// three classes by table size: up to 2,048 slots (16 KiB of shared memory,
// 128 threads), up to 16,384 slots (128 KiB, 256 threads), and larger rows,
// whose tables live in device memory that the wrapper allocates (256
// threads). The kernel allocates nothing.
//
// Insert (every thread, products of one A entry per warp, lanes over the B
// row): probe linearly from key & (s - 1); a slot holding the key takes an
// atomicAdd; at an empty slot, a table under its cutoff claims it with
// atomicCAS(-1 -> key), a table at its cutoff rejects the key. Probes stop
// after s slots, so a full table cannot hang the kernel. Concurrent inserts
// may push L1 a little past its cutoff (two threads pass the check and both
// claim), and a key that one thread spilled may enter L1 through another:
// the emit adds L1 and L2 for every key, so such a key is still summed once
// per product. The atomics add in no fixed order: results agree with the
// plain version to f32 rounding, not bit for bit.
#include "ell_common.cuh"

namespace {

constexpr int kSmallSlots = 2048;   // class 0: 16 KiB of shared memory
constexpr int kMidSlots = 16384;    // class 1: 128 KiB of shared memory

__device__ __forceinline__ int64_t next_pow2(int64_t x) {
  int64_t p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Insert-or-accumulate (key, v) into the table; false when the key was
// rejected (cutoff reached, or no slot found within `size` probes).
// cutoff < 0: no cutoff (L2).
__device__ __forceinline__ bool lp_insert(int* ids, float* vals, int64_t size,
                                          int64_t cutoff, int* used, int key,
                                          float v) {
  const int64_t mask = size - 1;
  int64_t p = key & mask;
  for (int64_t probe = 0; probe < size; ++probe) {
    const int held = *reinterpret_cast<volatile int*>(ids + p);
    if (held == key) {
      atomicAdd(vals + p, v);
      return true;
    }
    if (held == -1) {
      if (cutoff >= 0 && *reinterpret_cast<volatile int*>(used) >= cutoff)
        return false;
      const int prev = atomicCAS(ids + p, -1, key);
      if (prev == -1 || prev == key) {
        if (prev == -1 && cutoff >= 0) atomicAdd(used, 1);
        atomicAdd(vals + p, v);
        return true;
      }
    }
    p = (p + 1) & mask;
  }
  return false;
}

__device__ __forceinline__ float lp_lookup(const int* ids, const float* vals,
                                           int64_t size, int key) {
  const int64_t mask = size - 1;
  int64_t p = key & mask;
  for (int64_t probe = 0; probe < size; ++probe) {
    const int held = ids[p];
    if (held == key) return vals[p];
    if (held == -1) return 0.f;
    p = (p + 1) & mask;
  }
  return 0.f;
}

template <typename TA, typename TB>
__global__ void __launch_bounds__(256)
    spgemm_lp_kernel(const ell::EllArgs e, int cls) {
  extern __shared__ int smem[];
  __shared__ int used1;
  const int64_t pos = blockIdx.x;
  const int64_t i = __ldg(e.rows[cls] + pos);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int64_t cn = ell::clamp_count(__ldg(e.c_nnz + i), e.r_c);
  ell::zero_tail(e, i, cn);
  if (cn == 0) return;  // the same for the whole block

  // table sizes: the same formula as the wrapper's lp_table_slots
  const int64_t s2 = next_pow2(2 * cn > 8 ? 2 * cn : 8);
  const int64_t s1 = e.l1_size > 0 ? e.l1_size : s2;
  const int64_t cutoff = s1 / 2 < s1 - 1 ? s1 / 2 : s1 - 1;
  const bool has_l2 = cutoff < cn;
  const int64_t slots = s1 + (has_l2 ? s2 : 0);
  int* ids;
  float* vals;
  if (cls == 2) {
    ids = e.g_ids + e.g_off[pos];
    vals = e.g_vals + e.g_off[pos];
  } else {
    if (slots > (cls == 0 ? kSmallSlots : kMidSlots)) __trap();  // class mismatch
    ids = smem;
    vals = reinterpret_cast<float*>(smem + slots);
  }
  for (int64_t s = tid; s < slots; s += nthreads) {
    ids[s] = -1;
    vals[s] = 0.f;
  }
  if (tid == 0) used1 = 0;
  __syncthreads();

  const int64_t live_a = ell::clamp_count(__ldg(e.a_nnz + i), e.r_a);
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nwarps = nthreads >> 5;
  const TA* a_val = static_cast<const TA*>(e.a_val);
  const TB* b_val = static_cast<const TB*>(e.b_val);
  for (int64_t r = warp; r < live_a; r += nwarps) {
    const int64_t slot = i * e.r_a + r;
    const int64_t j = ell::clamp_row(__ldg(e.a_idx + slot), e.n);
    const float av = replay::load_val(a_val, slot);
    const int64_t nb = ell::b_width(e, j);
    for (int64_t t = lane; t < nb; t += 32) {
      const int key = __ldg(e.b_idx + j * e.r_b + t);
      if (key < 0 || key >= e.k) continue;
      const float v = av * replay::load_val(b_val, j * e.r_b + t);
      if (!lp_insert(ids, vals, s1, cutoff, &used1, key, v) && has_l2)
        lp_insert(ids + s1, vals + s1, s2, -1, nullptr, key, v);
    }
  }
  __syncthreads();

  const int32_t* crow = e.c_idx + i * e.r_c;
  float* orow = e.out + i * e.r_c;
  for (int64_t s = tid; s < cn; s += nthreads) {
    const int key = __ldg(crow + s);
    float v = lp_lookup(ids, vals, s1, key);
    if (has_l2) v += lp_lookup(ids + s1, vals + s1, s2, key);
    orow[s] = v;
  }
}

template <typename TA, typename TB>
struct SpgemmLp {
  static void launch(const ell::EllArgs& e) {
    const int threads[3] = {128, 256, 256};
    const int bytes[3] = {kSmallSlots * 8, kMidSlots * 8, 0};
    cudaFuncSetAttribute(spgemm_lp_kernel<TA, TB>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes[1]);
    for (int cls = 0; cls < 3; ++cls) {
      if (e.n_rows[cls] == 0) continue;
      spgemm_lp_kernel<TA, TB>
          <<<static_cast<unsigned>(e.n_rows[cls]), threads[cls], bytes[cls],
             e.stream>>>(e, cls);
    }
  }
};

}  // namespace

ELL_C_API(spgemm_lp, SpgemmLp)
