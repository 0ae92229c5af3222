// Hopper (sm_90a) kernels for the Mamba-1 selective scan.
//
// They replace the Pallas TPU kernel src/repro/kernels/ssm_scan.py
// (ssm_scan: _ssm_kernel).  For batch row b, channel e and state n,
//
//   h_t[e, n] = exp(dt_t[e] A[e, n]) h_{t-1}[e, n] + dtx_t[e] b_t[n]
//   y_t[e]    = sum_n h_t[e, n] c_t[n]
//
// with A = -exp(a_log) and h_0 = 0; it writes y (B, S, E) and the state
// after the last step, h_last (B, E, N), both f32.  Any S and E: the TPU
// kernel needs the caller to pad S with identity steps and E to its block.
//
// Bound on an H100 SXM: bytes.  The scan reads dt and dtx (4 B each per
// (t, e)) and writes y, so at B = 1, S = 512, E = 8192, N = 16 it moves
// 51.4 MB, 15.4 us at 3.35 TB/s; its 67 M exp and ~6 flops per (t, e, n)
// are 7 us at the f32 peak.  Nothing in it is a matrix product, so the
// tensor cores do not apply.  But each (b, e, n) is a chain of S dependent
// steps, and at B = 1 there are only 131,072 chains: run whole, their
// latency, not the bytes, sets the time.
//
// Design: a chunked scan with a carry pass, the associative form of the
// reference's models/ssm.py::_ssm_scan_chunked, (a1, b1) o (a2, b2) =
// (a1 a2, a2 b1 + b2).  S is cut into C chunks of L steps (the last one
// ragged; L is chosen on the host from the shapes so that the grid fills
// the SMs).  Both passes run the grid (ceil(E / channels per CTA), B,
// chunks); a thread owns 4 states of one channel (N / 4 lanes per channel),
// loads dt and dtx once for its 4 states and reduces y over its N / 4 lanes
// with shuffles (8 states a thread, with fewer threads, measured slower).
//
//   pass 1 (chunks 0 .. C-2): scan the chunk from h = 0 and write its end
//           state h_c and decay product P_c = prod_t exp(dt_t A), formed
//           step by step as the chain forms h, to the workspace (B, C-1,
//           E, N) x 2.  Chunk 0 starts from the true state h_0 = 0, so it
//           writes its y here and needs no P;
//   pass 2 (chunks 1 .. C-1): fold the carry of the chunks before this one,
//           H = h_0, then H = P_c' H + h_c' for 0 < c' < c in order, then
//           scan the chunk from H, writing y; the last chunk writes h_last.
//
// So every step but those of chunk 0 and chunk C-1 is taken twice.
//
// Per CTA, the chunk's b_t and c_t rows are staged in shared memory by
// 16-byte cp.async copies, kBlk steps at a time, double-buffered, where
// every thread would otherwise load the same rows itself; the dt and dtx
// loads of kSteps steps are issued before any of them is used, through
// pointers stepped by E (a 64-bit index product per load would cost more
// instructions than the step itself).
//
// Numerics.  With one chunk (S <= L) pass 2 alone runs the sequential
// chain with the accurate expf (not __expf) and, under -fmad=false, each
// product rounded on its own, as the plain version's separate tensor ops
// round it: h matches it to the bit where expf agrees.  Past one chunk the
// carry rounds apart from the chain anyway, and the step is the SFU's ex2
// of dt A log2(e) with fused multiply-adds (relative error ~1e-7 |dt A| per
// factor, max |dy|, |dh_last| a few 1e-6 at the prefill's shapes, within
// the reference's 1e-4): expf is eight instructions to ex2's two, and most
// steps are taken twice.
//
// The entry point launches on the caller's stream, allocates nothing (the
// wrapper passes the workspace) and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;      // states per thread (one float4)
constexpr int kSteps = 8;    // time steps whose dt/dtx loads fly together
constexpr int kBlk = 32;     // time steps of b and c staged per round

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Dynamic shared memory: two buffers of kBlk rows of b and of c, N floats
// each.
template <int N>
constexpr int smem_bytes() {
  return 2 * 2 * kBlk * N * 4;
}

// One step's decay factor exp(dt A).  EXACT: the accurate expf of the
// product, as the plain version rounds it.  Otherwise the SFU's ex2 of dt
// times A log2(e) (relative error ~1e-7 |dt A|): two instructions for
// expf's eight.
template <bool EXACT>
__device__ __forceinline__ float decay(float dt, float a, float a2) {
  if constexpr (EXACT) {
    return expf(dt * a);
  } else {
    float r;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(dt * a2));
    return r;
  }
}

// x * y + z: rounded once (fmaf) unless EXACT, where the plain version's
// separate product and sum are kept.
template <bool EXACT>
__device__ __forceinline__ float mul_add(float x, float y, float z) {
  if constexpr (EXACT) {
    return x * y + z;     // -fmad=false: two roundings
  } else {
    return fmaf(x, y, z);
  }
}

// The kPer (4) consecutive floats at p (16-byte aligned), in and out.
__device__ __forceinline__ void load_row(const float* p, float (&v)[kPer]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

__device__ __forceinline__ void store_row(float* p, const float (&v)[kPer]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Scan steps [t_lo, t_hi) of batch row bi from the state h.  Y: write y_t
// (the b and c rows staged); else multiply the decay factors into P (b
// alone staged).  b_s / c_s: two buffers of kBlk rows of N floats each.
template <int N, bool Y, bool EXACT>
__device__ __forceinline__ void scan_chunk(
    float (&h)[kPer], float (&P)[kPer], const float (&A)[kPer],
    const float (&A2)[kPer], const float* __restrict__ dt,
    const float* __restrict__ dtx, const float* __restrict__ b,
    const float* __restrict__ c, float* __restrict__ y, float* b_s,
    float* c_s, int64_t row, int channels, int e, int lane, bool live,
    int t_lo, int t_hi) {
  constexpr int LANES = N / kPer;
  constexpr int kRow = kBlk * N;
  const int n_rounds = (t_hi - t_lo + kBlk - 1) / kBlk;

  // stage the b (and c) rows of round r into buffer r & 1
  auto issue = [&](int r) {
    const int t0 = t_lo + r * kBlk;
    const int units = min(kBlk, t_hi - t0) * (N / 4);
    const int64_t at = (row + t0) * N;
    for (int u = threadIdx.x; u < units; u += kThreads) {
      cp_async16(b_s + (r & 1) * kRow + u * 4, b + at + u * 4);
      if constexpr (Y)
        cp_async16(c_s + (r & 1) * kRow + u * 4, c + at + u * 4);
    }
  };

  // one step: fold (dt, dtx, b_t) into h; y_t out or the decay product on.
  // bq / cq point at the step's staged b and c rows.
  const bool writer = live && lane == 0;
  const int64_t cs = channels;
  auto step = [&](float dtv, float dxv, const float* bq, const float* cq,
                  float* yq) {
    float bb[kPer];
    load_row(bq + lane * kPer, bb);
    float dA[kPer];
#pragma unroll
    for (int n = 0; n < kPer; ++n) {
      dA[n] = decay<EXACT>(dtv, A[n], A2[n]);
      h[n] = mul_add<EXACT>(dA[n], h[n], dxv * bb[n]);
    }
    if constexpr (Y) {
      float cc[kPer];
      load_row(cq + lane * kPer, cc);
      float part = h[0] * cc[0];
#pragma unroll
      for (int n = 1; n < kPer; ++n) part = mul_add<EXACT>(h[n], cc[n], part);
#pragma unroll
      for (int o = LANES / 2; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if (writer) *yq = part;
    } else {
#pragma unroll
      for (int n = 0; n < kPer; ++n) P[n] = P[n] * dA[n];
    }
  };

  if (n_rounds > 0) issue(0);
  cp_async_commit();
  for (int r = 0; r < n_rounds; ++r) {
    if (r + 1 < n_rounds) {
      issue(r + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* bq = b_s + (r & 1) * kRow;
    const float* cq = c_s + (r & 1) * kRow;
    const int r0 = t_lo + r * kBlk;
    const int nr = min(kBlk, t_hi - r0);
    const int64_t at0 = (row + r0) * cs + e;
    const float* dt_p = dt + at0;
    const float* dx_p = dtx + at0;
    float* y_p = Y ? y + at0 : nullptr;
    int j = 0;
    // whole groups of kSteps: their dt/dtx loads first, no predicates
    for (; j + kSteps <= nr; j += kSteps) {
      float dtv[kSteps], dxv[kSteps];
#pragma unroll
      for (int i = 0; i < kSteps; ++i) {
        dtv[i] = __ldg(dt_p);
        dxv[i] = __ldg(dx_p);
        dt_p += cs;
        dx_p += cs;
      }
#pragma unroll
      for (int i = 0; i < kSteps; ++i) {
        step(dtv[i], dxv[i], bq, cq, y_p);
        bq += N;
        cq += N;
        if constexpr (Y) y_p += cs;
      }
    }
    for (; j < nr; ++j) {
      step(__ldg(dt_p), __ldg(dx_p), bq, cq, y_p);
      dt_p += cs;
      dx_p += cs;
      bq += N;
      cq += N;
      if constexpr (Y) y_p += cs;
    }
    __syncthreads();       // buffer r & 1 is free for round r + 2
  }
}

// FINAL false, pass 1: chunk blockIdx.z of 0 .. C-2 from h = 0, writing h_c
// and (c > 0) P_c to the workspace; chunk 0 starts from the true state, so
// it also writes its y, and pass 2 skips it.  FINAL true, pass 2: chunk
// blockIdx.z + 1 of 1 .. C-1 (chunk 0 where C = 1) from its carry, writing
// y, and h_last from the last chunk.  EXACT (C = 1 only): the sequential
// chain rounded as the plain version rounds it.
template <int N, bool FINAL, bool EXACT>
__global__ void __launch_bounds__(kThreads)
    ssm_chunk_kernel(const float* __restrict__ a_log,
                     const float* __restrict__ dt,
                     const float* __restrict__ dtx,
                     const float* __restrict__ b,
                     const float* __restrict__ c, float* __restrict__ y,
                     float* __restrict__ h_last, float* __restrict__ work_h,
                     float* __restrict__ work_p, int seq, int channels,
                     int chunk, int chunks) {
  constexpr int LANES = N / kPer;
  constexpr int kChannels = kThreads / LANES;   // channels per CTA
  extern __shared__ __align__(16) float smem[];
  float* b_s = smem;                            // [2][kBlk][N]
  float* c_s = smem + 2 * kBlk * N;             // [2][kBlk][N]

  const int lane = threadIdx.x % LANES;
  const int e_raw = blockIdx.x * kChannels + threadIdx.x / LANES;
  // threads past the last channel compute a copy of it (every lane takes
  // part in the shuffles and the copies) and write nothing
  const bool live = e_raw < channels;
  const int e = live ? e_raw : channels - 1;
  const int bi = blockIdx.y;
  const int ci = FINAL && chunks > 1 ? blockIdx.z + 1 : blockIdx.z;
  const int64_t row = (int64_t)bi * seq;
  const int t_lo = ci * chunk;
  const int t_hi = min(seq, t_lo + chunk);
  const int64_t at = (int64_t)e * N + lane * kPer;   // this thread's states

  float A[kPer], A2[kPer], h[kPer], P[kPer];
  load_row(a_log + at, A);
  constexpr float kLog2e = 1.4426950408889634f;
#pragma unroll
  for (int n = 0; n < kPer; ++n) {
    A[n] = -expf(A[n]);
    A2[n] = A[n] * kLog2e;
    h[n] = 0.f;
    P[n] = 1.f;
  }
  const int64_t wstride = (int64_t)channels * N;   // one chunk's states
  const int64_t w0 = (int64_t)bi * (chunks - 1) * wstride + at;
  if (FINAL && ci > 0) {
    // the carry into this chunk: H = h_0, then H = P_c' H + h_c' for
    // 0 < c' < ci in order
    load_row(work_h + w0, h);
#pragma unroll 4
    for (int cp = 1; cp < ci; ++cp) {
      float hp[kPer], pp[kPer];
      load_row(work_h + w0 + cp * wstride, hp);
      load_row(work_p + w0 + cp * wstride, pp);
#pragma unroll
      for (int n = 0; n < kPer; ++n) h[n] = fmaf(pp[n], h[n], hp[n]);
    }
  }

  if (FINAL || ci == 0)
    scan_chunk<N, true, EXACT>(h, P, A, A2, dt, dtx, b, c, y, b_s, c_s,
                                    row, channels, e, lane, live, t_lo,
                                    t_hi);
  else
    scan_chunk<N, false, EXACT>(h, P, A, A2, dt, dtx, b, c, y, b_s,
                                     c_s, row, channels, e, lane, live, t_lo,
                                     t_hi);

  if (!live) return;
  if (FINAL) {
    if (ci == chunks - 1)
      store_row(h_last + (int64_t)bi * wstride + at, h);
  } else {
    store_row(work_h + w0 + ci * wstride, h);
    if (ci > 0) store_row(work_p + w0 + ci * wstride, P);
  }
}

template <int N, bool FINAL, bool EXACT>
int launch_pass(const float* a_log, const float* dt, const float* dtx,
                const float* b, const float* c, float* y, float* h_last,
                float* work_h, float* work_p, int batch, int seq,
                int channels, int chunk, int chunks, int grid_z,
                cudaStream_t stream) {
  constexpr int kChannels = kThreads / (N / kPer);
  constexpr int smem = smem_bytes<N>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssm_chunk_kernel<N, FINAL, EXACT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((channels + kChannels - 1) / kChannels, batch, grid_z);
  ssm_chunk_kernel<N, FINAL, EXACT><<<grid, kThreads, smem, stream>>>(
      a_log, dt, dtx, b, c, y, h_last, work_h, work_p, seq, channels, chunk,
      chunks);
  return (int)cudaGetLastError();
}

template <int N>
int launch(const float* a_log, const float* dt, const float* dtx,
           const float* b, const float* c, float* y, float* h_last,
           float* work, int batch, int seq, int channels, int chunk,
           cudaStream_t stream) {
  const int chunks = seq > 0 ? (seq + chunk - 1) / chunk : 1;
  if (chunks > 65535 || (chunks > 1 && work == nullptr))
    return (int)cudaErrorInvalidValue;
  if (chunks == 1)
    return launch_pass<N, true, true>(a_log, dt, dtx, b, c, y, h_last,
                                           nullptr, nullptr, batch, seq,
                                           channels, chunk, 1, 1, stream);
  float* work_h = work;
  float* work_p = work + (int64_t)batch * (chunks - 1) * channels * N;
  const int err = launch_pass<N, false, false>(
      a_log, dt, dtx, b, c, y, h_last, work_h, work_p, batch, seq, channels,
      chunk, chunks, chunks - 1, stream);
  if (err != 0) return err;
  return launch_pass<N, true, false>(a_log, dt, dtx, b, c, y, h_last,
                                          work_h, work_p, batch, seq,
                                          channels, chunk, chunks,
                                          chunks - 1, stream);
}

}  // namespace

extern "C" {

// a_log: (channels, state); dt, dtx: (batch, seq, channels); b, c: (batch,
// seq, state); y: (batch, seq, channels); h_last: (batch, channels,
// state); chunk: steps per chunk (>= 1); work: 2 * batch * (chunks - 1) *
// channels * state f32 (NULL when one chunk holds seq).  All f32,
// contiguous, 16-byte aligned, on the device; state is 4, 8, 16, 32, 64 or
// 128.
int ssm_scan_f32(const float* a_log, const float* dt, const float* dtx,
                 const float* b, const float* c, float* y, float* h_last,
                 float* work, int batch, int seq, int channels, int state,
                 int chunk, cudaStream_t stream) {
  if (batch <= 0 || batch > 65535 || seq < 0 || channels <= 0 || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  switch (state) {
#define SSM_CASE(NN)                                                        \
  case NN:                                                                  \
    return launch<NN>(a_log, dt, dtx, b, c, y, h_last, work, batch, seq,    \
                      channels, chunk, stream);
    SSM_CASE(4)
    SSM_CASE(8)
    SSM_CASE(16)
    SSM_CASE(32)
    SSM_CASE(64)
    SSM_CASE(128)
#undef SSM_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
