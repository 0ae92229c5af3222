// Hopper (sm_90a) kernels for one-token GQA decode over a paged KV cache.
//
// They replace the Pallas TPU kernel src/repro/kernels/paged_attention.py
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
// (one f32 per pool token slot, (num_pages, page_size)), each token's k row
// is dequantized as value * scale before QK and its v row before PV, as
// _paged_kernel_quant does (here the scale multiplies the token's score and
// its softmax weight, which is the same product).  block_tables and lengths
// are read from device memory: the caller computes lengths = pos + 1 on the
// device and never waits on the host.
//
// Bound on an H100 SXM: bytes.  A row reads its live k and v rows once
// (2 * hd * itemsize per token and kv head, 4 KiB per token over qwen3's 8
// kv heads at bf16) and does 4 * G * hd flops per token and head: about 2
// flops per byte at bf16, far below the ~295 where bf16 tensor cores would
// bound it.  So the design is about memory-level parallelism, not wgmma: at
// G = 2 a 16-row MMA tile of queries would be 7/8 padding.
//
// Design: split-K over each row's live tokens (flash-decoding), two
// launches.
//
// Pass 1 (paged_partial_kernel), grid (kv_heads, batch, splits).  The
// split count is fixed per launch on the host from batch, kv_heads and the
// SM count only, never from the block table's width, so a 640-wide and a
// 37-wide table give the same ranges and bitwise the same output.  CTA s of
// row b takes the live tokens [s * per, min((s + 1) * per, n)), n =
// lengths[b] read on the device, per = ceil(n / splits) rounded up to the
// page size; a CTA whose range is empty writes the empty partial (m =
// -1e30, l = 0, acc = 0) and exits.  A live CTA walks its range kTile
// tokens at a time through a ring of kStages tiles in shared memory, filled
// by 16-byte cp.async.cg copies of the pool rows (gather-addressed 256-byte
// rows at qwen3's bf16 hd 128: TMA's tiled copies buy nothing for rows
// picked one by one through a block table), so the next tiles' loads are in
// flight while this one is scored.  Rows stay in the pool's own type in
// shared memory and are converted at use.  A few threads per (token, query
// head) take each score (strided over hd, a shuffle sum: the score of one
// token is no long serial chain); one warp per query head folds the
// tile into the running (m, l, acc) of an online softmax, the update of
// _fold_page: m' = max(m, max s), p = exp(s - m'), l' = l e^(m-m') + sum p,
// acc' = acc e^(m-m') + p V.  The CTA writes its (m, l) per query head and
// acc (G x hd f32) to the workspace (batch, kv_heads, splits, G[, hd]).
//
// Pass 2 (paged_merge_kernel), one CTA per (kv head, row), a warp's lanes
// over the splits for M and the weights:
//
//   M = max_s m_s,
//   out = sum_s e^(m_s - M) acc_s / max(sum_s e^(m_s - M) l_s, 1e-30)
//
// in a fixed order (acc over s in order, the weights' sum by a fixed
// shuffle tree), so the output is the same from run to run; the guard is
// the reference's final division.  Any page_size; hd and G bounded
// only by shared memory (the wrapper checks).
//
// The dot products are explicit fmaf (the library builds with -fmad=false
// for other kernels' bitwise pins; this one is held to 1e-6, not to the
// bit).  The entry points launch on the caller's stream, allocate nothing
// (the wrapper passes the workspace) and return cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;            // tokens per stage of the ring
constexpr int kStages = 2;           // tiles in flight
constexpr float kNegInf = -1e30f;    // the reference's NEG_INF
static_assert(kTile <= 32, "one lane per token of a tile");

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

constexpr int kPad = 16;             // bytes after each k row in a tile
constexpr int kQPad = 4;             // floats after each query head's row

// Bytes of one ring stage: the k tile (kTile rows of hd T, each followed by
// kPad bytes, so the rows of neighbouring tokens start in other banks), the
// v tile (kTile rows of hd T) and the per-token scales, rounded up to 16.
__host__ __device__ inline int64_t stage_bytes(int hd, int itemsize) {
  const int64_t b = (int64_t)kTile * (hd * itemsize + kPad) +
                    (int64_t)kTile * hd * itemsize + 2LL * kTile * 4;
  return (b + 15) / 16 * 16;
}

// Dynamic shared memory of pass 1: the ring, then in floats q (G rows of
// hd + kQPad), acc (G*hd), the weights p (G*kTile), and m, l, corr (G
// each).  kernels/paged_attention.py::smem_bytes repeats this count.
__host__ __device__ inline int64_t smem_bytes(int groups, int hd,
                                              int itemsize) {
  return kStages * stage_bytes(hd, itemsize) +
         4LL * ((int64_t)groups * (2 * hd + kQPad) +
                (int64_t)groups * kTile + 3LL * groups);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    paged_partial_kernel(const float* __restrict__ q,
                         const T* __restrict__ k_pool,
                         const T* __restrict__ v_pool,
                         const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale,
                         const int* __restrict__ block_tables,
                         const int* __restrict__ lengths, int kv_heads,
                         int groups, int hd, int page_size, int max_pages,
                         float scale, float* __restrict__ part_ml,
                         float* __restrict__ part_acc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t sb = stage_bytes(hd, (int)sizeof(T));
  const int gh = groups * hd;
  const int qs = hd + kQPad;                    // q_s row stride (floats)
  const int ks = hd + kPad / (int)sizeof(T);    // k tile row stride (T)
  float* q_s = reinterpret_cast<float*>(smem + kStages * sb);
  float* acc = q_s + groups * qs;
  float* p_s = acc + gh;
  float* m_s = p_s + groups * kTile;
  float* l_s = m_s + groups;
  float* c_s = l_s + groups;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int splits = gridDim.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const bool scaled = k_scale != nullptr;

  // this CTA's live tokens: [t_lo, t_hi), a whole number of tiles; tiles
  // are gathered token by token through the block table, so neither the
  // ranges nor the tiles depend on the page size, and neither do the bits
  // of the output
  const int n = max(0, min(lengths[b], max_pages * page_size));
  int per = (n + splits - 1) / splits;
  per = (per + kTile - 1) / kTile * kTile;
  const int t_lo = min(n, split * per);
  const int t_hi = min(n, t_lo + per);
  const int64_t part = ((int64_t)b * kv_heads + h) * splits + split;
  float* ml = part_ml + part * 2 * groups;        // m (G), then l (G)
  float* pa = part_acc + part * gh;
  if (t_lo >= t_hi) {
    for (int i = tid; i < gh; i += kThreads) pa[i] = 0.f;
    if (tid < groups) {
      ml[tid] = kNegInf;
      ml[groups + tid] = 0.f;
    }
    return;
  }

  const int* bt = block_tables + (int64_t)b * max_pages;
  const int64_t token_stride = (int64_t)kv_heads * hd;
  constexpr int kN = VEC ? 16 / (int)sizeof(T) : 1;   // elements per copy
  const int units_per_row = hd / kN;
  const int n_tiles = (t_hi - t_lo + kTile - 1) / kTile;

  // copy tile i of the range into stage i % kStages (cp.async where rows
  // take 16-byte copies, plain loads otherwise)
  auto issue = [&](int i) {
    unsigned char* st = smem + (i % kStages) * sb;
    T* k_t = reinterpret_cast<T*>(st);
    T* v_t = k_t + kTile * ks;
    float* sc = reinterpret_cast<float*>(v_t + kTile * hd);
    const int t0 = t_lo + i * kTile;
    const int nt = min(kTile, t_hi - t0);
    for (int u = tid; u < nt * units_per_row; u += kThreads) {
      const int t = u / units_per_row;
      const int d = (u - t * units_per_row) * kN;
      const int pos = t0 + t;
      const int page_idx = pos / page_size;
      const int64_t slot = (int64_t)__ldg(bt + page_idx) * page_size +
                           (pos - page_idx * page_size);
      const int64_t at = slot * token_stride + (int64_t)h * hd + d;
      if constexpr (VEC) {
        cp_async16(k_t + t * ks + d, k_pool + at);
        cp_async16(v_t + t * hd + d, v_pool + at);
      } else {
        k_t[t * ks + d] = k_pool[at];
        v_t[t * hd + d] = v_pool[at];
      }
      if (scaled && d == 0) {
        cp_async4(sc + t, k_scale + slot);
        cp_async4(sc + kTile + t, v_scale + slot);
      }
    }
  };

  // the first tiles' copies go out before q is read
#pragma unroll
  for (int i = 0; i < kStages; ++i) {
    if (i < n_tiles) issue(i);
    cp_async_commit();
  }
  const float* qb = q + ((int64_t)b * kv_heads + h) * gh;
  for (int i = tid; i < gh; i += kThreads) {
    q_s[(i / hd) * qs + i % hd] = qb[i];
    acc[i] = 0.f;
  }
  // the score phase: tpp threads (a power of two) per (token, query head)
  // pair, pairs token-major so a token's G heads read the same k row
  int tpp = 32;
  while (tpp > 1 && tpp * groups * kTile > kThreads) tpp >>= 1;
  const int sub = tid % tpp;            // this thread's share of hd
  if (tid < groups) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 1>();      // this thread's copies of tile i
    __syncthreads();                   // everyone's, and q_s / m_s / l_s
    const unsigned char* st = smem + (i % kStages) * sb;
    const T* k_t = reinterpret_cast<const T*>(st);
    const T* v_t = k_t + kTile * ks;
    const float* sc = reinterpret_cast<const float*>(v_t + kTile * hd);
    const int nt = min(kTile, t_hi - (t_lo + i * kTile));

    // scores: tpp threads per (t, g) over strided d, two partial sums each,
    // then a shuffle sum over the tpp lanes (every thread takes part in the
    // shuffles: the loop count is the same for all)
    for (int w0 = 0; w0 < groups * kTile; w0 += kThreads / tpp) {
      const int w = w0 + tid / tpp;
      const int t = w / groups;
      const int g = w - t * groups;
      float s0 = 0.f, s1 = 0.f;
      if (t < nt) {
        const T* kr = k_t + t * ks;
        const float* qg = q_s + g * qs;
        int d = sub;
        for (; d + tpp < hd; d += 2 * tpp) {
          s0 = fmaf(qg[d], to_f32(kr[d]), s0);
          s1 = fmaf(qg[d + tpp], to_f32(kr[d + tpp]), s1);
        }
        if (d < hd) s0 = fmaf(qg[d], to_f32(kr[d]), s0);
      }
      float s = s0 + s1;
      for (int o = tpp / 2; o > 0; o >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      if (t < nt && sub == 0)
        p_s[g * kTile + t] = s * (scaled ? sc[t] : 1.f) * scale;
    }
    __syncthreads();

    // online-softmax statistics, one warp per query head; p_s keeps the
    // weights p * v_scale that PV takes
    for (int g = warp; g < groups; g += kWarps) {
      float* s = p_s + g * kTile;
      const float x = lane < nt ? s[lane] : kNegInf;
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(x));
      const float p = lane < nt ? expf(x - m_new) : 0.f;
      if (lane < nt) s[lane] = scaled ? p * sc[kTile + lane] : p;
      const float sum = warp_sum(p);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
        c_s[g] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p V; each thread owns its acc elements
    for (int e = tid; e < gh; e += kThreads) {
      const int g = e / hd;
      const int d = e - g * hd;
      const float* p = p_s + g * kTile;
      float pv = 0.f;
#pragma unroll 4
      for (int t = 0; t < nt; ++t)
        pv = fmaf(p[t], to_f32(v_t[t * hd + d]), pv);
      acc[e] = acc[e] * c_s[g] + pv;
    }
    __syncthreads();                   // the stage is free again
    if (i + kStages < n_tiles) issue(i + kStages);
    cp_async_commit();
  }

  for (int e = tid; e < gh; e += kThreads) pa[e] = acc[e];
  if (tid < groups) {
    ml[tid] = m_s[tid];
    ml[groups + tid] = l_s[tid];
  }
}

// Dynamic shared memory: the weights e^(m_s - M) (splits x G), then the
// sums L (G).
__global__ void __launch_bounds__(kThreads)
    paged_merge_kernel(const float* __restrict__ part_ml,
                       const float* __restrict__ part_acc, int kv_heads,
                       int groups, int hd, int splits,
                       float* __restrict__ out) {
  extern __shared__ float wsm[];
  float* w_s = wsm;
  float* L_s = wsm + splits * groups;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int gh = groups * hd;
  const int64_t row = (int64_t)b * kv_heads + h;
  const float* ml = part_ml + row * splits * 2 * groups;
  const float* pa = part_acc + row * splits * gh;
  // one warp per query head: lanes over the splits
  for (int g = threadIdx.x / 32; g < groups; g += kWarps) {
    float M = kNegInf;
    for (int s = lane; s < splits; s += 32)
      M = fmaxf(M, ml[s * 2 * groups + g]);
    M = warp_max(M);
    float L = 0.f;
    for (int s = lane; s < splits; s += 32) {
      const float w = expf(ml[s * 2 * groups + g] - M);
      w_s[s * groups + g] = w;
      L += w * ml[s * 2 * groups + groups + g];
    }
    L = warp_sum(L);
    if (lane == 0) L_s[g] = L;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < gh; e += kThreads) {
    const int g = e / hd;
    float A = 0.f;
#pragma unroll 16
    for (int s = 0; s < splits; ++s)
      A = fmaf(w_s[s * groups + g], pa[(int64_t)s * gh + e], A);
    out[row * gh + e] = A / fmaxf(L_s[g], 1e-30f);
  }
}

template <typename T, bool VEC>
int launch_as(const float* q, const T* k_pool, const T* v_pool,
              const float* k_scale, const float* v_scale,
              const int* block_tables, const int* lengths, int batch,
              int kv_heads, int groups, int hd, int page_size, int max_pages,
              float scale, int splits, float* work, float* out,
              cudaStream_t stream) {
  const size_t smem = (size_t)smem_bytes(groups, hd, (int)sizeof(T));
  // above 48 KB a block takes dynamic shared memory only once allowed;
  // the attribute is the current device's: each device's limit is raised
  // to the largest size asked for there
  constexpr int kMaxDevices = 64;
  static size_t allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (smem > 48 * 1024 && (dev >= kMaxDevices || smem > allowed[dev])) {
    e = cudaFuncSetAttribute(paged_partial_kernel<T, VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < kMaxDevices) allowed[dev] = smem;
  }
  float* part_ml = work;
  float* part_acc = work + (int64_t)batch * kv_heads * splits * 2 * groups;
  const dim3 grid(kv_heads, batch, splits);
  paged_partial_kernel<T, VEC><<<grid, kThreads, smem, stream>>>(
      q, k_pool, v_pool, k_scale, v_scale, block_tables, lengths, kv_heads,
      groups, hd, page_size, max_pages, scale, part_ml, part_acc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t wsmem = (size_t)(splits + 1) * groups * sizeof(float);
  paged_merge_kernel<<<dim3(kv_heads, batch), kThreads, wsmem, stream>>>(
      part_ml, part_acc, kv_heads, groups, hd, splits, out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const float* q, const void* k_pool, const void* v_pool,
           const float* k_scale, const float* v_scale,
           const int* block_tables, const int* lengths, int batch,
           int kv_heads, int groups, int hd, int page_size, int max_pages,
           float scale, int vec, int splits, float* work, float* out,
           cudaStream_t stream) {
  if (batch <= 0 || kv_heads <= 0 || groups <= 0 || hd <= 0 ||
      page_size <= 0 || max_pages <= 0 || batch > 65535 || splits <= 0 ||
      splits > 65535 || (k_scale == nullptr) != (v_scale == nullptr) ||
      (vec && (hd * (int)sizeof(T)) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  const T* k = static_cast<const T*>(k_pool);
  const T* v = static_cast<const T*>(v_pool);
  if (vec)
    return launch_as<T, true>(q, k, v, k_scale, v_scale, block_tables,
                              lengths, batch, kv_heads, groups, hd,
                              page_size, max_pages, scale, splits, work, out,
                              stream);
  return launch_as<T, false>(q, k, v, k_scale, v_scale, block_tables,
                             lengths, batch, kv_heads, groups, hd, page_size,
                             max_pages, scale, splits, work, out, stream);
}

}  // namespace

extern "C" {

// q: (batch, kv_heads, groups, hd) f32; k_pool, v_pool: (num_pages,
// page_size, kv_heads, hd) in the entry point's dtype; k_scale, v_scale:
// (num_pages, page_size) f32 or both NULL; block_tables: (batch, max_pages)
// int32; lengths: (batch,) int32; scale: hd^-0.5 as f32; vec: 16-byte
// copies (hd * itemsize % 16 == 0 and both pools 16-byte aligned); splits:
// CTAs per (kv head, row); work: batch * kv_heads * splits * groups *
// (hd + 2) f32; out: (batch, kv_heads, groups, hd) f32.  All contiguous, on
// the device.
#define PAGED_ATTENTION_ENTRY(NAME, T)                                      \
  int NAME(const float* q, const void* k_pool, const void* v_pool,          \
           const float* k_scale, const float* v_scale,                      \
           const int* block_tables, const int* lengths, int batch,          \
           int kv_heads, int groups, int hd, int page_size, int max_pages,  \
           float scale, int vec, int splits, float* work, float* out,       \
           cudaStream_t stream) {                                           \
    return launch<T>(q, k_pool, v_pool, k_scale, v_scale, block_tables,     \
                     lengths, batch, kv_heads, groups, hd, page_size,       \
                     max_pages, scale, vec, splits, work, out, stream);     \
  }

PAGED_ATTENTION_ENTRY(paged_attention_f32, float)
PAGED_ATTENTION_ENTRY(paged_attention_bf16, __nv_bfloat16)
PAGED_ATTENTION_ENTRY(paged_attention_f16, __half)
PAGED_ATTENTION_ENTRY(paged_attention_i8, int8_t)
PAGED_ATTENTION_ENTRY(paged_attention_fp8, __nv_fp8_e4m3)

#undef PAGED_ATTENTION_ENTRY

}  // extern "C"
