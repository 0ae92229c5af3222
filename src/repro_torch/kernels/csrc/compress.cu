// Hopper (sm_90a) kernel for the error-feedback compression body.
//
// It replaces the Pallas TPU kernel src/repro/kernels/compress.py
// (select_ef_mean / _select_ef_kernel).  One launch per bucket covers all W
// workers: for every column j of the (W, n) accumulated payload a,
//
//   keep_w = |a_w| >= t_w            (union: OR of the masks over W)
//   c_w    = keep_w ? a_w : 0         cast to the wire dtype and back
//   mean   = (c_0 + c_1 + ... + c_{W-1}) * (1/W), rounded to the wire dtype
//   res_w  = a_w - c_w
//
// and writes mean (1, n) f32 and res (W, n) f32.  The thresholds t (W,) f32
// come from device memory, so the caller never reads them on the host.
//
// Bound on an H100 SXM (3.35 TB/s): bytes.  Per column it reads 4W bytes
// and writes 4 + 4W, a compare, a select and W adds: 20 B per column at
// W = 2.  So the design is one streaming pass: a grid-stride loop over
// groups of four columns, 16-byte loads and stores where n % 4 == 0 and
// the rows are 16-byte aligned (else 4-byte ones; the result is the same
// bits either way), neighbouring threads on neighbouring columns, every
// worker row of a column handled by the same thread so the mean needs no
// communication.  With union, a thread reads its W values twice (mask,
// then select); the second read hits L1/L2.
//
// The sum runs in worker order starting from c_0 (not from 0, which would
// turn a -0 into +0) and is multiplied by the f32 reciprocal of W that the
// caller passes: the plain PyTorch version on the card divides by W through
// that same reciprocal, and for W a power of two it is the division.
// Built with -fmad=false, like dc_update.cu, so no multiply-add is fused
// and each element gets the plain version's roundings: bitwise equal.
//
// The entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

enum Wire { kF32 = 0, kBF16 = 1, kF16 = 2 };

// Round an f32 to the wire dtype and back (round to nearest even).
template <int WIRE>
__device__ __forceinline__ float wire_cast(float x) {
  if (WIRE == kBF16) return __bfloat162float(__float2bfloat16_rn(x));
  if (WIRE == kF16) return __half2float(__float2half_rn(x));
  return x;
}

__device__ __forceinline__ float4 load4(const float* p, int vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

__device__ __forceinline__ void store4(float* p, float4 v, int vec) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = v;
  } else {
    p[0] = v.x;
    p[1] = v.y;
    p[2] = v.z;
    p[3] = v.w;
  }
}

// One column: c from a, the threshold test and the union mask.
__device__ __forceinline__ float select1(float a, float t, int union_,
                                         bool any) {
  const bool keep = union_ ? any : (fabsf(a) >= t);
  return keep ? a : 0.f;
}

template <int WIRE>
__device__ __forceinline__ void column(const float* __restrict__ a,
                                       const float* __restrict__ thresh,
                                       int64_t rows, int64_t n, int64_t j,
                                       int union_, float inv_w,
                                       float* __restrict__ mean,
                                       float* __restrict__ res) {
  bool any = false;
  if (union_) {
    for (int64_t w = 0; w < rows; ++w)
      any = any || (fabsf(__ldg(a + w * n + j)) >= __ldg(thresh + w));
  }
  float acc = 0.f;
  for (int64_t w = 0; w < rows; ++w) {
    const float x = __ldg(a + w * n + j);
    const float c = select1(x, __ldg(thresh + w), union_, any);
    res[w * n + j] = x - c;
    const float cw = wire_cast<WIRE>(c);
    acc = (w == 0) ? cw : acc + cw;
  }
  mean[j] = wire_cast<WIRE>(acc * inv_w);
}

// Groups of four columns (n % 4 == 0); vec: 16-byte accesses.
template <int WIRE>
__device__ __forceinline__ void column4(const float* __restrict__ a,
                                        const float* __restrict__ thresh,
                                        int64_t rows, int64_t n, int64_t j,
                                        int union_, int vec, float inv_w,
                                        float* __restrict__ mean,
                                        float* __restrict__ res) {
  bool ax = false, ay = false, az = false, aw = false;
  if (union_) {
    for (int64_t w = 0; w < rows; ++w) {
      const float4 x = load4(a + w * n + j, vec);
      const float t = __ldg(thresh + w);
      ax = ax || (fabsf(x.x) >= t);
      ay = ay || (fabsf(x.y) >= t);
      az = az || (fabsf(x.z) >= t);
      aw = aw || (fabsf(x.w) >= t);
    }
  }
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int64_t w = 0; w < rows; ++w) {
    const float4 x = load4(a + w * n + j, vec);
    const float t = __ldg(thresh + w);
    const float4 c = make_float4(select1(x.x, t, union_, ax),
                                 select1(x.y, t, union_, ay),
                                 select1(x.z, t, union_, az),
                                 select1(x.w, t, union_, aw));
    store4(res + w * n + j,
           make_float4(x.x - c.x, x.y - c.y, x.z - c.z, x.w - c.w), vec);
    const float4 cw = make_float4(wire_cast<WIRE>(c.x), wire_cast<WIRE>(c.y),
                                  wire_cast<WIRE>(c.z), wire_cast<WIRE>(c.w));
    if (w == 0) {
      acc = cw;
    } else {
      acc.x = acc.x + cw.x;
      acc.y = acc.y + cw.y;
      acc.z = acc.z + cw.z;
      acc.w = acc.w + cw.w;
    }
  }
  store4(mean + j,
         make_float4(wire_cast<WIRE>(acc.x * inv_w),
                     wire_cast<WIRE>(acc.y * inv_w),
                     wire_cast<WIRE>(acc.z * inv_w),
                     wire_cast<WIRE>(acc.w * inv_w)),
         vec);
}

// grid.x blocks stride over the columns (in groups of four when
// n % 4 == 0); every worker row of a column is handled by one thread.
template <int WIRE>
__global__ void __launch_bounds__(kThreads)
    select_ef_mean(const float* __restrict__ a,
                   const float* __restrict__ thresh, int64_t rows, int64_t n,
                   int union_, float inv_w, int groups4, int vec,
                   float* __restrict__ mean, float* __restrict__ res) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t start = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (groups4) {
    for (int64_t i = start; i < n / 4; i += stride)
      column4<WIRE>(a, thresh, rows, n, 4 * i, union_, vec, inv_w, mean,
                    res);
  } else {
    for (int64_t j = start; j < n; j += stride)
      column<WIRE>(a, thresh, rows, n, j, union_, inv_w, mean, res);
  }
}

template <int WIRE>
void launch(const float* a, const float* thresh, int64_t rows, int64_t n,
            int union_, float inv_w, int vec, int nblocks, float* mean,
            float* res, cudaStream_t stream) {
  select_ef_mean<WIRE><<<nblocks, kThreads, 0, stream>>>(
      a, thresh, rows, n, union_, inv_w, (int)(n % 4 == 0), vec, mean, res);
}

}  // namespace

extern "C" {

// a: (rows, n) f32 contiguous; thresh: (rows,) f32 on the device;
// wire: 0 f32, 1 bf16, 2 f16; union_: OR the masks over the rows;
// inv_w: the f32 reciprocal of rows; vec: n % 4 == 0 and a, mean, res
// 16-byte aligned; mean: (n,) f32; res: (rows, n) f32.
int select_ef_mean_f32(const float* a, const float* thresh, int64_t rows,
                       int64_t n, int wire, int union_, float inv_w, int vec,
                       int nblocks, float* mean, float* res,
                       cudaStream_t stream) {
  switch (wire) {
    case kF32:
      launch<kF32>(a, thresh, rows, n, union_, inv_w, vec, nblocks, mean, res,
                   stream);
      break;
    case kBF16:
      launch<kBF16>(a, thresh, rows, n, union_, inv_w, vec, nblocks, mean,
                    res, stream);
      break;
    case kF16:
      launch<kF16>(a, thresh, rows, n, union_, inv_w, vec, nblocks, mean, res,
                   stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
