// Hopper (sm_90a) kernels for the DC-S3GD update tail.
//
// They replace the two Pallas TPU kernels of src/repro/kernels/dc_update.py:
//
//   dc_norms         <- dc_norms / _dc_norms_kernel   (Eq. 17's two sums)
//   dc_fused_update  <- dc_fused_update / _dc_update_kernel (Eq. 10+11+12)
//
// Both are bound by device memory, not arithmetic: a few flops per 4-byte
// element.  On an H100 SXM (3.35 TB/s) the lower bounds are
//   dc_norms:        8 B/element read (g, D)
//   dc_fused_update: 28 B/element with f32 w (read g, D, m, w; write w', m',
//                    Δw), 24 B/element with bf16 w.
// So the design is one streaming pass: grid-stride loops with 16-byte loads
// and stores, neighbouring threads on neighbouring addresses, enough blocks
// in flight to cover latency, nothing kept between passes.
//
// The TPU norm kernel carries its sum in a (1,1) block across a sequential
// grid.  Blocks here run in parallel and in no order, so the norms are a
// two-pass reduction: pass 1 writes one (Σg², Σc²) pair per block, pass 2
// sums the pairs of each worker row in a fixed order.  No float atomics:
// the grid and each thread's element order are functions of n only (groups
// of four when n % 4 == 0), and every reduction tree is fixed, so the sums
// are identical from run to run.  The operands' alignment picks only how a
// group of four is loaded (one 16-byte load or four 4-byte ones), never
// the order it is summed in, so a misaligned view sums to the same bits.
//
// Built with -fmad=false: each element is computed with the same roundings
// as the plain PyTorch version (repro_torch/kernels/dc_update.py), so the
// fused update is bitwise that version; fusing multiply-adds would buy
// nothing in a byte-bound kernel.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Fixed-order sum of (a, b) over the block; the result is valid in thread 0.
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[kWarps];
  __shared__ float sb[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < kWarps ? sa[lane] : 0.f;
    b = lane < kWarps ? sb[lane] : 0.f;
    a = warp_sum(a);
    b = warp_sum(b);
  }
}

__device__ __forceinline__ void norm_acc(float g, float d, float& sg,
                                         float& sc) {
  const float gg = g * g;
  const float c = gg * d;
  sg += gg;
  sc += c * c;
}

// Four consecutive floats from p: one 16-byte load when p is 16-byte
// aligned, else four 4-byte loads; the same values either way.
__device__ __forceinline__ float4 load4_any(const float* p, int aligned) {
  if (aligned) return __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

// Pass 1: grid (blocks, rows); block x of row w strides over that row.
// vec (n % 4 == 0): thread i sums groups of four; aligned: 16-byte loads.
__global__ void __launch_bounds__(kThreads)
    norms_partial(const float* __restrict__ g, const float* __restrict__ d,
                  int64_t n, int vec, int aligned,
                  float* __restrict__ partials) {
  const int64_t row = blockIdx.y;
  const float* gw = g + row * n;
  const float* dw = d + row * n;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t start = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  float sg = 0.f, sc = 0.f;
  if (vec) {
    for (int64_t i = start; i < n / 4; i += stride) {
      const float4 a = load4_any(gw + 4 * i, aligned);
      const float4 b = load4_any(dw + 4 * i, aligned);
      norm_acc(a.x, b.x, sg, sc);
      norm_acc(a.y, b.y, sg, sc);
      norm_acc(a.z, b.z, sg, sc);
      norm_acc(a.w, b.w, sg, sc);
    }
  } else {
    for (int64_t i = start; i < n; i += stride) norm_acc(gw[i], dw[i], sg, sc);
  }
  block_sum2(sg, sc);
  if (threadIdx.x == 0) {
    float* p = partials + 2 * (row * gridDim.x + blockIdx.x);
    p[0] = sg;
    p[1] = sc;
  }
}

// Pass 2: one block per row sums that row's block pairs in a fixed order.
__global__ void __launch_bounds__(kThreads)
    norms_final(const float* __restrict__ partials, int nblocks,
                float* __restrict__ out) {
  const int64_t row = blockIdx.x;
  const float* p = partials + 2 * row * nblocks;
  float sg = 0.f, sc = 0.f;
  for (int i = threadIdx.x; i < nblocks; i += kThreads) {
    sg += p[2 * i];
    sc += p[2 * i + 1];
  }
  block_sum2(sg, sc);
  if (threadIdx.x == 0) {
    out[2 * row] = sg;
    out[2 * row + 1] = sc;
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned int*>(&lo);
  u.y = *reinterpret_cast<const unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

struct Scalars {
  float lam, mu, eta, wd;
};

// Eq. 10 + decoupled weight decay + momentum (Eq. 11) + Eq. 12, one element.
__device__ __forceinline__ void update1(float g, float d, float m, float w,
                                        const Scalars& s, float& w_new,
                                        float& m_new, float& delta) {
  float gt = g + s.lam * (g * g * d);
  gt = gt + s.wd * w;
  m_new = s.mu * m + gt;
  delta = -s.eta * m_new;
  w_new = w + d + delta;
}

template <typename WT>
__global__ void __launch_bounds__(kThreads)
    fused_update(const float* __restrict__ g, const float* __restrict__ d,
                 const float* __restrict__ m, const WT* __restrict__ w,
                 const float* __restrict__ lam, float mu, float eta, float wd,
                 int64_t n, int vec, WT* __restrict__ w_out,
                 float* __restrict__ m_out, float* __restrict__ delta_out) {
  const int64_t row = blockIdx.y;
  const int64_t base = row * n;
  const Scalars s{lam[row], mu, eta, wd};
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t start = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (vec) {
    for (int64_t i = start; i < n / 4; i += stride) {
      const int64_t e = base + 4 * i;
      const float4 G = load4(g + e), D = load4(d + e), M = load4(m + e);
      const float4 Wv = load4(w + e);
      float4 Wn, Mn, Dl;
      update1(G.x, D.x, M.x, Wv.x, s, Wn.x, Mn.x, Dl.x);
      update1(G.y, D.y, M.y, Wv.y, s, Wn.y, Mn.y, Dl.y);
      update1(G.z, D.z, M.z, Wv.z, s, Wn.z, Mn.z, Dl.z);
      update1(G.w, D.w, M.w, Wv.w, s, Wn.w, Mn.w, Dl.w);
      store4(w_out + e, Wn);
      store4(m_out + e, Mn);
      store4(delta_out + e, Dl);
    }
  } else {
    for (int64_t i = start; i < n; i += stride) {
      const int64_t e = base + i;
      float wn, mn, dl;
      update1(g[e], d[e], m[e], to_f32(w[e]), s, wn, mn, dl);
      from_f32(wn, w_out + e);
      m_out[e] = mn;
      delta_out[e] = dl;
    }
  }
}

template <typename WT>
int launch_update(const float* g, const float* d, const float* m, const WT* w,
                  const float* lam, float mu, float eta, float wd, int64_t rows,
                  int64_t n, int vec, int nblocks, WT* w_out, float* m_out,
                  float* delta_out, cudaStream_t stream) {
  const dim3 grid(nblocks, (unsigned)rows);
  fused_update<WT><<<grid, kThreads, 0, stream>>>(
      g, d, m, w, lam, mu, eta, wd, n, vec, w_out, m_out, delta_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// g, d: (rows, n) f32 contiguous; vec: n % 4 == 0; aligned: vec and g, d
// 16-byte aligned; partials: (rows, nblocks, 2) f32 scratch;
// out: (rows, 2) f32 = [Σ g², Σ (g²·D)²] per row.
int dc_norms_f32(const float* g, const float* d, int64_t rows, int64_t n,
                 int vec, int aligned, int nblocks, float* partials,
                 float* out, cudaStream_t stream) {
  norms_partial<<<dim3(nblocks, (unsigned)rows), kThreads, 0, stream>>>(
      g, d, n, vec, aligned, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  norms_final<<<(unsigned)rows, kThreads, 0, stream>>>(partials, nblocks, out);
  return (int)cudaGetLastError();
}

// g, d, m: (rows, n) f32; w, w_out: (rows, n) f32 or bf16; lam: (rows,) f32
// on the device; m_out, delta_out: (rows, n) f32.
int dc_fused_update_f32w(const float* g, const float* d, const float* m,
                         const float* w, const float* lam, float mu, float eta,
                         float wd, int64_t rows, int64_t n, int vec,
                         int nblocks, float* w_out, float* m_out,
                         float* delta_out, cudaStream_t stream) {
  return launch_update<float>(g, d, m, w, lam, mu, eta, wd, rows, n, vec,
                              nblocks, w_out, m_out, delta_out, stream);
}

int dc_fused_update_bf16w(const float* g, const float* d, const float* m,
                          const void* w, const float* lam, float mu, float eta,
                          float wd, int64_t rows, int64_t n, int vec,
                          int nblocks, void* w_out, float* m_out,
                          float* delta_out, cudaStream_t stream) {
  return launch_update<__nv_bfloat16>(
      g, d, m, static_cast<const __nv_bfloat16*>(w), lam, mu, eta, wd, rows,
      n, vec, nblocks, static_cast<__nv_bfloat16*>(w_out), m_out, delta_out,
      stream);
}

}  // extern "C"
