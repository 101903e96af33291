// flash_attention: blocked online-softmax attention with GQA, sliding window
// and logit softcap, on Hopper (sm_90a). An FA2-style forward.
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
//
// What bounds it: operations, 4 * D flops per live (query, key) pair of each
// head against (Hq * Tq + 2 * Hkv * Tk) * D values read once and Hq * Tq * D
// written.
//
// Design: one block of 256 threads per (query tile of kBQ = 64 rows, query
// head); the loop over KV tiles of kBK = 64 keys takes the place of the TPU's
// sequential kv grid axis, with the running (m, l) per row in shared memory
// and the output tile in registers (4 rows x D / 16 columns a thread). The Q
// tile, the K and V tiles and the score tile sit in shared memory as f32,
// rows padded by one word so that the strided reads are conflict-free: at
// D = 256 that is 210 KiB of dynamic shared memory, above the 48 KiB default
// (cudaFuncSetAttribute). Per KV tile: S = Q K^T (4 x 4 scores a thread),
// scale, softcap and mask; four threads per row take the row max and sum
// with shuffles and rescale (m, l); then O = alpha O + P V. A KV tile that
// no row of the query tile can see is skipped, but only when every row of
// the tile has a live key somewhere, so the wipe above is exact and a row
// without live keys still sees every tile. No tensor cores: f32 FMAs over
// shared-memory tiles, for every dtype.
#include <cmath>

#include "replay_common.cuh"

namespace {

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

template <int D, typename T>
int launch_d(const AttnArgs& r) {
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<D, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((r.tq + kBQ - 1) / kBQ), static_cast<unsigned>(r.hq));
  flash_attention_kernel<D, T><<<grid, kThreads, bytes, r.stream>>>(r);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_t(const AttnArgs& r, int d) {
  switch (d) {
    case 16: return launch_d<16, T>(r);
    case 32: return launch_d<32, T>(r);
    case 64: return launch_d<64, T>(r);
    case 128: return launch_d<128, T>(r);
    case 256: return launch_d<256, T>(r);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// int flash_attention_launch(q, k, v, out, code, hq, hkv, tq, tk, d, scale,
//                            causal, has_window, window, softcap, stream)
//   -> cudaGetLastError(); cudaErrorInvalidValue for a head_dim other than
//   16, 32, 64, 128 or 256, an unknown dtype code, or hq % hkv != 0.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, int code, int64_t hq, int64_t hkv,
                                      int64_t tq, int64_t tk, int d, float scale,
                                      int causal, int has_window, int64_t window,
                                      float softcap, void* stream) {
  if (hkv < 1 || hq % hkv || tk < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (hq == 0 || tq == 0) return static_cast<int>(cudaGetLastError());
  const AttnArgs r{q,     k,      v,          out,    hq,      hkv,
                   tq,    tk,     scale,      causal, has_window, window,
                   softcap, static_cast<cudaStream_t>(stream)};
  switch (code) {
    case replay::kF32: return launch_t<float>(r, d);
    case replay::kF16: return launch_t<__half>(r, d);
    case replay::kBF16: return launch_t<__nv_bfloat16>(r, d);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
