// plan_columns: C's column indices of a fresh SpGEMM plan on Hopper (sm_90a).
//
// Replaces no TPU kernel. The reference writes these columns with an XLA
// scatter-max (repro/core/spgemm.py, plan_from_sorted); the port ran it as
// torch's scatter_reduce_(..., "amax"), which kernels/plan_columns.py keeps
// as the plain version. Over the products of a sorted expansion it computes
//   out[seg_ids[i]] = max(cols[i], 0)  for each i < fm with heads[i] set
// and seg_ids[i] in [0, nnz_cap), into an int32 output that the caller has
// zeroed. A (row, column) group has one head and the heads' seg_ids count
// up from 0, so each C entry is stored once, to its own address; products
// that are not heads, padding among them, store nothing. The max with 0 is
// the scatter-max's zeroed start: it gives the plain version's bits for any
// column.
//
// Why a kernel: the scatter sends every product to its group's slot, heads
// and non-heads alike, and every padding product to one slot, so its
// atomics serialise on a few addresses (97 ms on an H100 for a Graph500
// scale-15 A*A over 2^28 slots, whose bytes take under 1 ms). Here no two
// threads store to one address and nothing is atomic.
//
// What bounds it: bytes. A product costs its head flag (1 B); a group of
// four with a head in it costs its seg_ids and columns too (32 B); each C
// entry is one 4 B store. Padding sorts last and has no heads, so past the
// live products only the flags are read.
//
// Design: a thread takes 16 consecutive products, loads their flags as one
// 16 B vector and, for each group of four with a head, the group's seg_ids
// and columns as int4 vectors (through the read-only cache: a warp's four
// group loads cover the same lines). Arrays that do not start on 16 bytes,
// as a row of a stacked shard expansion may not, take a scalar build of the
// same kernel, as does the ragged end of any array.
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;  // consecutive products a thread
constexpr int64_t kTile = static_cast<int64_t>(kThreads) * kItems;

__device__ __forceinline__ void put(int32_t* __restrict__ out, int seg, int col, int nnz_cap) {
  if (seg >= 0 && seg < nnz_cap) out[seg] = col > 0 ? col : 0;
}

// one group of four products whose flags are the four bytes of `flags`
__device__ __forceinline__ void put_group(int32_t* __restrict__ out, uint32_t flags,
                                         const int4& seg, const int4& col, int nnz_cap) {
  if (flags & 0xffu) put(out, seg.x, col.x, nnz_cap);
  if (flags & 0xff00u) put(out, seg.y, col.y, nnz_cap);
  if (flags & 0xff0000u) put(out, seg.z, col.z, nnz_cap);
  if (flags & 0xff000000u) put(out, seg.w, col.w, nnz_cap);
}

template <bool kVector>
__global__ void __launch_bounds__(kThreads)
    plan_columns_kernel(const uint8_t* __restrict__ heads, const int32_t* __restrict__ seg_ids,
                        const int32_t* __restrict__ cols, int64_t fm,
                        int32_t* __restrict__ out, int nnz_cap) {
  const int64_t i0 = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kItems;
  if (i0 >= fm) return;
  if (kVector && i0 + kItems <= fm) {
    const uint4 h = __ldg(reinterpret_cast<const uint4*>(heads + i0));
    const uint32_t flags[4] = {h.x, h.y, h.z, h.w};
    const int4* seg4 = reinterpret_cast<const int4*>(seg_ids + i0);
    const int4* col4 = reinterpret_cast<const int4*>(cols + i0);
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q)
      if (flags[q]) put_group(out, flags[q], __ldg(seg4 + q), __ldg(col4 + q), nnz_cap);
    return;
  }
  const int64_t end = i0 + kItems < fm ? i0 + kItems : fm;
  for (int64_t i = i0; i < end; ++i)
    if (heads[i]) put(out, seg_ids[i], cols[i], nnz_cap);
}

}  // namespace

// Stores the columns of the heads among fm sorted products into out
// (nnz_cap int32 slots, zeroed by the caller) on `stream`; heads are bytes,
// 0 or not. -> cudaGetLastError(); cudaErrorInvalidValue for fm or nnz_cap
// outside [0, INT_MAX]. Nothing launches for fm or nnz_cap 0.
extern "C" int plan_columns_launch(const void* heads, const int32_t* seg_ids,
                                   const int32_t* cols, int64_t fm, int32_t* out,
                                   int64_t nnz_cap, void* stream) {
  if (fm < 0 || fm > INT_MAX || nnz_cap < 0 || nnz_cap > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (fm == 0 || nnz_cap == 0) return static_cast<int>(cudaGetLastError());
  const auto flags = static_cast<const uint8_t*>(heads);
  const unsigned blocks = static_cast<unsigned>((fm + kTile - 1) / kTile);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool aligned = ((reinterpret_cast<uintptr_t>(heads) | reinterpret_cast<uintptr_t>(seg_ids) |
                         reinterpret_cast<uintptr_t>(cols)) % 16) == 0;
  if (aligned)
    plan_columns_kernel<true><<<blocks, kThreads, 0, s>>>(flags, seg_ids, cols, fm, out,
                                                          static_cast<int>(nnz_cap));
  else
    plan_columns_kernel<false><<<blocks, kThreads, 0, s>>>(flags, seg_ids, cols, fm, out,
                                                           static_cast<int>(nnz_cap));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* plan_columns_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
