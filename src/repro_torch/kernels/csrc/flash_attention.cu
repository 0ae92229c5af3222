// Hopper (sm_90a) kernel for forward GQA attention over a whole sequence:
// causal and/or sliding-window, Sq != Sk allowed, any lengths.
//
// It replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention: _flash_kernel).  For batch row b, query head
// h = kv * groups + g and query position i,
//
//   s_ij  = (q[b, i, kv, g] . k[b, j, kv]) * hd^-0.5                     (f32)
//   masked to -1e30 where j >= Sk, causal and j > i, or window > 0 and
//   i - j >= window (positions absolute from 0 on both sides)
//   out[b, i, kv, g] = sum_j p_ij v[b, j, kv] / max(sum_j p_ij, 1e-30)
//
// with the online softmax of _flash_kernel: over key tiles, m' = max(m,
// max s), p = exp(s - m'), l' = l e^(m-m') + sum p, acc' = acc e^(m-m') +
// round(p) V, where round(p) is p in v's dtype (bf16 inputs round it, f32
// inputs do not).  Inputs are f32 or bf16; the output is in q's dtype.
//
// Bound on an H100 SXM: operations.  A causal prefill of S tokens does
// about 2 S^2 hd flops per query head against 4 S hd bytes per head moved
// (f32): at S = 512, hd = 128 that is 1.08 GFLOP over 16 heads, 16 us at
// the f32 CUDA-core peak of 67 TFLOP/s, against 3.8 us for the 12.6 MB of
// q, k, v and o.  Tensor cores would lift the ceiling, but f32 operands
// take them only as TF32, which the port's f32 products do not use.
//
// Design (simple first; wgmma, TMA and a pipelined K/V ring are later
// work): one CTA of 128 threads per (q tile of 32 rows, query head, batch
// row), so nothing carries between CTAs, where the TPU grid walks the key
// tiles of one (b, head, q tile) in order on one core.  The CTA loads its
// q tile once, then for each 64-key tile stages k and v in shared memory
// as f32 (rows padded to 4 more floats, so the lanes' 16-byte reads fall
// in different banks) and keeps the scores in registers: thread (ty, tx)
// owns rows 2ty, 2ty+1 and key columns tx + 8j, and the row max and sum
// are shuffle reductions over the 8 lanes of a row.  Probabilities go
// through shared memory to the PV product, where the same thread owns
// output columns 4tx + 32jj of its two rows.  GQA maps query head h to kv
// head h / groups.  Key tiles that are wholly masked for every row of the
// CTA (past the causal diagonal, before the window) are skipped: a row's
// masked entries contribute exp(-1e30 - m) = 0 once it has seen a live
// key, and before that its corr = exp(-1e30 - m) = 0 erases them, so the
// result is the reference's.  Query tiles run heaviest first.  Products
// are explicit fmaf: the library builds with -fmad=false for the bitwise
// kernels, which would otherwise split every product into two roundings.
//
// The entry points launch on the caller's stream, allocate nothing and
// return cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 32;              // query rows per CTA
constexpr int kBK = 64;              // keys per tile
constexpr int kCols = kBK / 8;       // score columns per thread
constexpr int kPS = kBK + 4;         // probability row stride (floats)
constexpr float kNegInf = -1e30f;    // the reference's NEG_INF

// four consecutive elements as f32 (16-byte loads for f32, 8 for bf16)
template <typename T>
__device__ __forceinline__ float4 load4(const T* p);
template <>
__device__ __forceinline__ float4 load4<float>(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
template <>
__device__ __forceinline__ float4 load4<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi),
                     __high2float(hi));
}

template <typename T>
__device__ __forceinline__ void store4(T* p, float4 x);
template <>
__device__ __forceinline__ void store4<float>(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float4 x) {
  uint2 raw;
  *reinterpret_cast<__nv_bfloat162*>(&raw.x) = __floats2bfloat162_rn(x.x, x.y);
  *reinterpret_cast<__nv_bfloat162*>(&raw.y) = __floats2bfloat162_rn(x.z, x.w);
  *reinterpret_cast<uint2*>(p) = raw;
}

// p as the PV product sees it: rounded to v's dtype
template <typename T>
__device__ __forceinline__ float round_to(float p) {
  if constexpr (std::is_same<T, float>::value) {
    return p;
  } else {
    return __bfloat162float(__float2bfloat16_rn(p));
  }
}

// Dynamic shared memory in floats: the q tile, the k tile (rows of hd + 4)
// and the v tile (rows of hd), and the probabilities (rows of kPS); at
// hd = 256, the largest instantiation, 174,080 bytes.
__host__ __device__ constexpr int smem_floats(int hd) {
  return kBQ * (hd + 4) + kBK * (hd + 4) + kBK * hd + kBQ * kPS;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int sq, int sk, int kv_heads, int groups,
                           int causal, int window, float scale) {
  constexpr int QS = HD + 4;
  constexpr int KS = HD + 4;
  constexpr int kUnits = HD / 4;              // 4-element units per row
  constexpr int kAcc = HD / 32;               // float4 columns per thread
  constexpr int kTileUnits = kBK * kUnits;    // units of one k (or v) tile
  constexpr int kRound = HD / 8 < 8 ? HD / 8 : 8;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + kBQ * QS;
  float* v_s = k_s + kBK * KS;
  float* p_s = v_s + kBK * HD;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int heads = kv_heads * groups;
  const int kvh = h / groups;
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 3;
  const int tx = tid & 7;
  const int r0 = 2 * ty;

  // the q tile; rows past sq are zeros and never written out
  for (int u = tid; u < kBQ * kUnits; u += kThreads) {
    const int r = u / kUnits;
    const int d = (u - r * kUnits) * 4;
    const int qpos = q0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (qpos < sq)
      x = load4(q + (((int64_t)b * sq + qpos) * heads + h) * HD + d);
    *reinterpret_cast<float4*>(q_s + r * QS + d) = x;
  }

  // the key range any row of this tile can see
  const int q_last = min(q0 + kBQ, sq) - 1;
  const int k_end = causal ? min(sk, q_last + 1) : sk;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float4 acc[2][kAcc];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < kAcc; ++jj)
      acc[i][jj] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int64_t kv_row = (int64_t)kv_heads * HD;
  const T* kb = k + (int64_t)b * sk * kv_row + (int64_t)kvh * HD;
  const T* vb = v + (int64_t)b * sk * kv_row + (int64_t)kvh * HD;

  for (int k0 = (k_begin / kBK) * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's k, v and p are consumed
    // stage k and v: kRound loads of each per thread in flight
    for (int base = 0; base < kTileUnits; base += kRound * kThreads) {
      float4 kr[kRound], vr[kRound];
#pragma unroll
      for (int j = 0; j < kRound; ++j) {
        const int u = base + j * kThreads + tid;
        const int r = u / kUnits;
        const int d = (u - r * kUnits) * 4;
        kr[j] = vr[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k0 + r < sk) {
          kr[j] = load4(kb + (int64_t)(k0 + r) * kv_row + d);
          vr[j] = load4(vb + (int64_t)(k0 + r) * kv_row + d);
        }
      }
#pragma unroll
      for (int j = 0; j < kRound; ++j) {
        const int u = base + j * kThreads + tid;
        const int r = u / kUnits;
        const int d = (u - r * kUnits) * 4;
        *reinterpret_cast<float4*>(k_s + r * KS + d) = kr[j];
        *reinterpret_cast<float4*>(v_s + r * HD + d) = vr[j];
      }
    }
    __syncthreads();

    // scores of rows r0, r0 + 1 against keys tx + 8j
    float s[2][kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[0][j] = s[1][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 qa = *reinterpret_cast<const float4*>(q_s + r0 * QS + d);
      const float4 qb =
          *reinterpret_cast<const float4*>(q_s + (r0 + 1) * QS + d);
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float4 kk =
            *reinterpret_cast<const float4*>(k_s + (tx + 8 * j) * KS + d);
        s[0][j] = fmaf(qa.x, kk.x, s[0][j]);
        s[0][j] = fmaf(qa.y, kk.y, s[0][j]);
        s[0][j] = fmaf(qa.z, kk.z, s[0][j]);
        s[0][j] = fmaf(qa.w, kk.w, s[0][j]);
        s[1][j] = fmaf(qb.x, kk.x, s[1][j]);
        s[1][j] = fmaf(qb.y, kk.y, s[1][j]);
        s[1][j] = fmaf(qb.z, kk.z, s[1][j]);
        s[1][j] = fmaf(qb.w, kk.w, s[1][j]);
      }
    }

    // online softmax over the tile, one row pair per thread
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qpos = q0 + r0 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx + 8 * j;
        const bool live = kpos < sk && (!causal || kpos <= qpos) &&
                          (window <= 0 || qpos - kpos < window);
        s[i][j] = live ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        p_s[(r0 + i) * kPS + tx + 8 * j] = round_to<T>(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < kAcc; ++jj) {
        acc[i][jj].x *= corr;
        acc[i][jj].y *= corr;
        acc[i][jj].z *= corr;
        acc[i][jj].w *= corr;
      }
    }
    __syncthreads();

    // acc += p V over the tile's keys
#pragma unroll 4
    for (int t = 0; t < kBK; ++t) {
      const float pa = p_s[r0 * kPS + t];
      const float pb = p_s[(r0 + 1) * kPS + t];
#pragma unroll
      for (int jj = 0; jj < kAcc; ++jj) {
        const float4 vv =
            *reinterpret_cast<const float4*>(v_s + t * HD + 4 * tx + 32 * jj);
        acc[0][jj].x = fmaf(pa, vv.x, acc[0][jj].x);
        acc[0][jj].y = fmaf(pa, vv.y, acc[0][jj].y);
        acc[0][jj].z = fmaf(pa, vv.z, acc[0][jj].z);
        acc[0][jj].w = fmaf(pa, vv.w, acc[0][jj].w);
        acc[1][jj].x = fmaf(pb, vv.x, acc[1][jj].x);
        acc[1][jj].y = fmaf(pb, vv.y, acc[1][jj].y);
        acc[1][jj].z = fmaf(pb, vv.z, acc[1][jj].z);
        acc[1][jj].w = fmaf(pb, vv.w, acc[1][jj].w);
      }
    }
  }

  // finalize: acc / max(l, 1e-30) in q's dtype
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = q0 + r0 + i;
    if (qpos >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + (((int64_t)b * sq + qpos) * heads + h) * HD;
#pragma unroll
    for (int jj = 0; jj < kAcc; ++jj) {
      const float4 a = acc[i][jj];
      store4(o + 4 * tx + 32 * jj,
             make_float4(a.x / denom, a.y / denom, a.z / denom, a.w / denom));
    }
  }
}

template <typename T, int HD>
int launch_hd(const T* q, const T* k, const T* v, T* out, int batch, int sq,
              int sk, int kv_heads, int groups, int causal, int window,
              float scale, cudaStream_t stream) {
  constexpr size_t smem = (size_t)smem_floats(HD) * sizeof(float);
  // above 48 KB a block takes dynamic shared memory only once allowed
  static bool allowed = false;
  if (smem > 48 * 1024 && !allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed = true;
  }
  const dim3 grid((sq + kBQ - 1) / kBQ, kv_heads * groups, batch);
  flash_attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, sq, sk, kv_heads, groups, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int sq, int sk, int kv_heads, int groups, int hd, int causal,
           int window, float scale, cudaStream_t stream) {
  if (batch <= 0 || sq <= 0 || sk <= 0 || kv_heads <= 0 || groups <= 0 ||
      batch > 65535 || (int64_t)kv_heads * groups > 65535)
    return (int)cudaErrorInvalidValue;
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(out);
  switch (hd) {
    case 32:
      return launch_hd<T, 32>(qq, kk, vv, oo, batch, sq, sk, kv_heads,
                              groups, causal, window, scale, stream);
    case 64:
      return launch_hd<T, 64>(qq, kk, vv, oo, batch, sq, sk, kv_heads,
                              groups, causal, window, scale, stream);
    case 128:
      return launch_hd<T, 128>(qq, kk, vv, oo, batch, sq, sk, kv_heads,
                               groups, causal, window, scale, stream);
    case 256:
      return launch_hd<T, 256>(qq, kk, vv, oo, batch, sq, sk, kv_heads,
                               groups, causal, window, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q: (batch, sq, kv_heads, groups, hd); k, v: (batch, sk, kv_heads, hd);
// out: like q.  All in the entry point's dtype, contiguous, 16-byte
// aligned, on the device.  hd is 32, 64, 128 or 256; causal is 0 or 1;
// window <= 0 means no window; scale is hd^-0.5 as f32.
int flash_attention_f32(const void* q, const void* k, const void* v,
                        void* out, int batch, int sq, int sk, int kv_heads,
                        int groups, int hd, int causal, int window,
                        float scale, cudaStream_t stream) {
  return launch<float>(q, k, v, out, batch, sq, sk, kv_heads, groups, hd,
                       causal, window, scale, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* out, int batch, int sq, int sk, int kv_heads,
                         int groups, int hd, int causal, int window,
                         float scale, cudaStream_t stream) {
  return launch<__nv_bfloat16>(q, k, v, out, batch, sq, sk, kv_heads, groups,
                               hd, causal, window, scale, stream);
}

}  // extern "C"
