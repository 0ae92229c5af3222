// Hopper (sm_90a) kernel for one-token GQA decode over a paged KV cache.
//
// It replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py
// (paged_attention: _paged_kernel, _paged_kernel_quant, their shared
// _fold_page).  For every decode row b and kv head h, the G query heads of
// the group attend over the row's first lengths[b] logical positions, where
// logical position p lives in the shared pool at
//
//   (block_tables[b, p / page_size], p % page_size, h, :)
//
// and the result is
//
//   out[b, h, g] = sum_p softmax_p(q[b, h, g] . k_p * hd^-0.5) v_p      (f32)
//
// Pools are f32, bf16, f16, int8 or float8_e4m3fn.  With k_scale / v_scale
// (one f32 per pool token slot, (num_pages, page_size)), each token's row is
// dequantized as value * scale before QK and PV, as _paged_kernel_quant does.
// block_tables and lengths are read from device memory: the caller computes
// lengths = pos + 1 on the device and never waits on the host.
//
// Bound on an H100 SXM: bytes.  A row reads its live k and v rows once
// (2 * hd * itemsize per token and kv head, 4 KiB per token over qwen3's 8
// kv heads at bf16) and does 4 * G * hd flops per token and head: far
// below the ~295 flops per byte where bf16 tensor cores would bound it.
//
// Design (simple first; split-K over pages, wgmma and TMA are later work):
// one CTA per (kv head, row) holds all G query heads of the group.  The TPU
// grid visits all max_pages pages of the block table and masks the dead
// ones; here the CTA walks only the row's live tokens, kTile at a time, so
// a wide block table costs nothing.  Each step stages the tile's k and v
// rows in shared memory as f32 (dequantized): 16-byte loads where the rows
// allow them, kRound of k and of v in flight per thread before any is
// used, since one CTA per SM has little else to hide the memory latency
// with (the dot-product loops are unrolled for the same reason).  Then
// one thread per (g, t) takes a score (k rows padded by one
// float, so the lanes' rows fall in different banks), one warp per query
// head folds the tile into the running (m, l, acc) of an online softmax,
// exactly the update of _fold_page: m' = max(m, max s), p = exp(s - m'),
// l' = l e^(m-m') + sum p, acc' = acc e^(m-m') + p V.  The output is
// acc / max(l, 1e-30).  Any page_size; hd and G bounded only by shared
// memory (the wrapper checks).
//
// The entry points launch on the caller's stream, allocate nothing and
// return cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;            // tokens folded per step
constexpr int kRound = 8;            // k (and v) loads in flight per thread
constexpr float kNegInf = -1e30f;    // the reference's NEG_INF

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_f32<__half>(__half x) {
  return __half2float(x);
}
template <>
__device__ __forceinline__ float to_f32<int8_t>(int8_t x) {
  return static_cast<float>(x);
}
template <>
__device__ __forceinline__ float to_f32<__nv_fp8_e4m3>(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

// One load unit of a k or v row: 16 bytes (kN elements) when VEC, else one
// element.
template <typename T, bool VEC>
struct Unit {
  static constexpr int kN = VEC ? 16 / (int)sizeof(T) : 1;
  using Raw = typename std::conditional<VEC, uint4, T>::type;

  __device__ static __forceinline__ Raw load(const T* p) {
    if constexpr (VEC) {
      return __ldg(reinterpret_cast<const uint4*>(p));
    } else {
      return *p;
    }
  }

  // out[i] = f32(element i) * scale
  __device__ static __forceinline__ void store(const Raw& r, float scale,
                                               bool scaled, float* out) {
    const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const float x = to_f32(e[i]);
      out[i] = scaled ? x * scale : x;
    }
  }
};

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Dynamic shared memory in floats: q and acc (G*hd each), the k tile
// (kTile rows of hd + 1) and the v tile (kTile*hd), the scores (G*kTile),
// and m, l, corr (G each).  kernels/paged_attention.py::smem_bytes repeats
// this count.
__host__ __device__ inline int64_t smem_floats(int groups, int hd) {
  return 2LL * groups * hd + (int64_t)kTile * (hd + 1) +
         (int64_t)kTile * hd + (int64_t)groups * kTile + 3LL * groups;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const float* __restrict__ q,
                           const T* __restrict__ k_pool,
                           const T* __restrict__ v_pool,
                           const float* __restrict__ k_scale,
                           const float* __restrict__ v_scale,
                           const int* __restrict__ block_tables,
                           const int* __restrict__ lengths, int kv_heads,
                           int groups, int hd, int page_size, int max_pages,
                           float scale, float* __restrict__ out) {
  using U = Unit<T, VEC>;
  extern __shared__ float smem[];
  const int gh = groups * hd;
  const int ks_stride = hd + 1;
  float* q_s = smem;
  float* acc = q_s + gh;
  float* k_s = acc + gh;
  float* v_s = k_s + kTile * ks_stride;
  float* p_s = v_s + kTile * hd;
  float* m_s = p_s + groups * kTile;
  float* l_s = m_s + groups;
  float* c_s = l_s + groups;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const bool scaled = k_scale != nullptr;

  const float* qb = q + ((int64_t)b * kv_heads + h) * gh;
  for (int i = tid; i < gh; i += kThreads) {
    q_s[i] = qb[i];
    acc[i] = 0.f;
  }
  if (tid < groups) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  // positions >= lengths[b] are masked: walk the live ones only
  const int n = max(0, min(lengths[b], max_pages * page_size));
  const int* bt = block_tables + (int64_t)b * max_pages;
  const int64_t token_stride = (int64_t)kv_heads * hd;
  const int units_per_row = hd / U::kN;
  __syncthreads();

  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int nt = min(kTile, n - t0);
    // stage the tile: kRound loads of k and of v per thread in flight
    const int units = nt * units_per_row;
    for (int base = 0; base < units; base += kRound * kThreads) {
      typename U::Raw kr[kRound], vr[kRound];
      float ksc[kRound], vsc[kRound];
#pragma unroll
      for (int j = 0; j < kRound; ++j) {
        const int u = base + j * kThreads + tid;
        ksc[j] = vsc[j] = 1.f;
        if (u < units) {
          const int t = u / units_per_row;
          const int d = (u - t * units_per_row) * U::kN;
          const int pos = t0 + t;
          const int page_idx = pos / page_size;
          const int64_t slot = (int64_t)bt[page_idx] * page_size +
                               (pos - page_idx * page_size);
          const int64_t at = slot * token_stride + (int64_t)h * hd + d;
          kr[j] = U::load(k_pool + at);
          vr[j] = U::load(v_pool + at);
          if (scaled) {
            ksc[j] = k_scale[slot];
            vsc[j] = v_scale[slot];
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kRound; ++j) {
        const int u = base + j * kThreads + tid;
        if (u < units) {
          const int t = u / units_per_row;
          const int d = (u - t * units_per_row) * U::kN;
          U::store(kr[j], ksc[j], scaled, k_s + t * ks_stride + d);
          U::store(vr[j], vsc[j], scaled, v_s + t * hd + d);
        }
      }
    }
    __syncthreads();

    // scores: one thread per (g, t)
    for (int pair = tid; pair < groups * nt; pair += kThreads) {
      const int g = pair / nt;
      const int t = pair - g * nt;
      const float* qg = q_s + g * hd;
      const float* kt = k_s + t * ks_stride;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < hd; ++d) s += qg[d] * kt[d];
      p_s[g * kTile + t] = s * scale;
    }
    __syncthreads();

    // online-softmax statistics, one warp per query head
    for (int g = warp; g < groups; g += kWarps) {
      float* s = p_s + g * kTile;
      float mx = kNegInf;
      for (int t = lane; t < nt; t += 32) mx = fmaxf(mx, s[t]);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
      for (int t = lane; t < nt; t += 32) {
        const float p = expf(s[t] - m_new);
        s[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
        c_s[g] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p V; each thread owns its acc elements
    for (int i = tid; i < gh; i += kThreads) {
      const int g = i / hd;
      const int d = i - g * hd;
      const float* p = p_s + g * kTile;
      float pv = 0.f;
#pragma unroll 8
      for (int t = 0; t < nt; ++t) pv += p[t] * v_s[t * hd + d];
      acc[i] = acc[i] * c_s[g] + pv;
    }
    __syncthreads();
  }

  float* ob = out + ((int64_t)b * kv_heads + h) * gh;
  for (int i = tid; i < gh; i += kThreads)
    ob[i] = acc[i] / fmaxf(l_s[i / hd], 1e-30f);
}

template <typename T, bool VEC>
int launch_as(const float* q, const T* k_pool, const T* v_pool,
              const float* k_scale, const float* v_scale,
              const int* block_tables, const int* lengths, int batch,
              int kv_heads, int groups, int hd, int page_size, int max_pages,
              float scale, float* out, cudaStream_t stream) {
  const size_t smem = (size_t)smem_floats(groups, hd) * sizeof(float);
  // above 48 KB a block takes dynamic shared memory only once allowed;
  // the kernel's own limit is raised once to the largest size asked for
  static size_t allowed = 48 * 1024;
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  const dim3 grid(kv_heads, batch);
  paged_attention_kernel<T, VEC><<<grid, kThreads, smem, stream>>>(
      q, k_pool, v_pool, k_scale, v_scale, block_tables, lengths, kv_heads,
      groups, hd, page_size, max_pages, scale, out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const float* q, const void* k_pool, const void* v_pool,
           const float* k_scale, const float* v_scale,
           const int* block_tables, const int* lengths, int batch,
           int kv_heads, int groups, int hd, int page_size, int max_pages,
           float scale, int vec, float* out, cudaStream_t stream) {
  if (batch <= 0 || kv_heads <= 0 || groups <= 0 || hd <= 0 ||
      page_size <= 0 || max_pages <= 0 || batch > 65535 ||
      (k_scale == nullptr) != (v_scale == nullptr) ||
      (vec && (hd * (int)sizeof(T)) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  const T* k = static_cast<const T*>(k_pool);
  const T* v = static_cast<const T*>(v_pool);
  if (vec)
    return launch_as<T, true>(q, k, v, k_scale, v_scale, block_tables,
                              lengths, batch, kv_heads, groups, hd,
                              page_size, max_pages, scale, out, stream);
  return launch_as<T, false>(q, k, v, k_scale, v_scale, block_tables,
                             lengths, batch, kv_heads, groups, hd, page_size,
                             max_pages, scale, out, stream);
}

}  // namespace

extern "C" {

// q: (batch, kv_heads, groups, hd) f32; k_pool, v_pool: (num_pages,
// page_size, kv_heads, hd) in the entry point's dtype; k_scale, v_scale:
// (num_pages, page_size) f32 or both NULL; block_tables: (batch, max_pages)
// int32; lengths: (batch,) int32; scale: hd^-0.5 as f32; vec: 16-byte
// loads (hd * itemsize % 16 == 0 and both pools 16-byte aligned); out:
// (batch, kv_heads, groups, hd) f32.  All contiguous, on the device.
#define PAGED_ATTENTION_ENTRY(NAME, T)                                      \
  int NAME(const float* q, const void* k_pool, const void* v_pool,          \
           const float* k_scale, const float* v_scale,                      \
           const int* block_tables, const int* lengths, int batch,          \
           int kv_heads, int groups, int hd, int page_size, int max_pages,  \
           float scale, int vec, float* out, cudaStream_t stream) {         \
    return launch<T>(q, k_pool, v_pool, k_scale, v_scale, block_tables,     \
                     lengths, batch, kv_heads, groups, hd, page_size,       \
                     max_pages, scale, vec, out, stream);                   \
  }

PAGED_ATTENTION_ENTRY(paged_attention_f32, float)
PAGED_ATTENTION_ENTRY(paged_attention_bf16, __nv_bfloat16)
PAGED_ATTENTION_ENTRY(paged_attention_f16, __half)
PAGED_ATTENTION_ENTRY(paged_attention_i8, int8_t)
PAGED_ATTENTION_ENTRY(paged_attention_fp8, __nv_fp8_e4m3)

#undef PAGED_ATTENTION_ENTRY

}  // extern "C"
