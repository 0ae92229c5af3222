// Hopper (sm_90a) kernel for the Mamba-1 selective scan.
//
// It replaces the Pallas TPU kernel src/repro/kernels/ssm_scan.py
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
// are 7 us at the f32 peak.  But each (b, e, n) is a chain of S dependent
// steps, and at B = 1 there are only 131,072 of them: the chains' latency,
// not the bytes, is what the time will show.
//
// Design (simple first; splitting S into chunks with a carry pass is
// later work): parallel over (b, e, n) and sequential over t inside the
// thread, nothing carried between CTAs, where the TPU grid walks S blocks
// in order with the state in VMEM.  A thread owns 4 states of one channel
// (N / 4 lanes per channel), so it loads dt and dtx once for 4 states and
// reduces y over N / 4 lanes with shuffles.  The loads of 8 steps are
// issued before any of them is used, since at one CTA per SM there are few
// warps to hide the memory latency with.  exp is the accurate expf (not
// __expf), and with -fmad=false each product is rounded on its own, as
// the plain version's separate tensor ops round it: h matches it to the
// bit where expf agrees, and y differs only in the order of the n sum.
//
// The entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;      // states per thread
constexpr int kSteps = 8;    // time steps whose loads are in flight together

template <int LANES>         // threads per channel: N / kPer
__global__ void __launch_bounds__(kThreads)
    ssm_scan_kernel(const float* __restrict__ a_log,
                    const float* __restrict__ dt,
                    const float* __restrict__ dtx,
                    const float* __restrict__ b,
                    const float* __restrict__ c, float* __restrict__ y,
                    float* __restrict__ h_last, int seq, int channels) {
  constexpr int N = LANES * kPer;
  constexpr int kChannels = kThreads / LANES;   // channels per CTA
  const int lane = threadIdx.x % LANES;
  const int e_raw = blockIdx.x * kChannels + threadIdx.x / LANES;
  // threads past the last channel compute a copy of it (every lane takes
  // part in the shuffles) and write nothing
  const bool live = e_raw < channels;
  const int e = live ? e_raw : channels - 1;
  const int64_t row = (int64_t)blockIdx.y * seq;

  const float4 al =
      __ldg(reinterpret_cast<const float4*>(a_log + (int64_t)e * N) + lane);
  const float A[kPer] = {-expf(al.x), -expf(al.y), -expf(al.z), -expf(al.w)};
  float h[kPer] = {0.f, 0.f, 0.f, 0.f};

  for (int t0 = 0; t0 < seq; t0 += kSteps) {
    const int nt = min(kSteps, seq - t0);
    float dtv[kSteps], dxv[kSteps];
    float4 bv[kSteps], cv[kSteps];
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      if (j < nt) {
        const int64_t t = row + t0 + j;
        dtv[j] = __ldg(dt + t * channels + e);
        dxv[j] = __ldg(dtx + t * channels + e);
        bv[j] = __ldg(reinterpret_cast<const float4*>(b + t * N) + lane);
        cv[j] = __ldg(reinterpret_cast<const float4*>(c + t * N) + lane);
      }
    }
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      if (j < nt) {
        const float bb[kPer] = {bv[j].x, bv[j].y, bv[j].z, bv[j].w};
        const float cc[kPer] = {cv[j].x, cv[j].y, cv[j].z, cv[j].w};
        float part = 0.f;
#pragma unroll
        for (int n = 0; n < kPer; ++n) {
          const float dA = expf(dtv[j] * A[n]);
          h[n] = dA * h[n] + dxv[j] * bb[n];
          part += h[n] * cc[n];
        }
#pragma unroll
        for (int o = LANES / 2; o > 0; o >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        if (live && lane == 0) y[(row + t0 + j) * channels + e] = part;
      }
    }
  }
  if (live)
    reinterpret_cast<float4*>(h_last + ((int64_t)blockIdx.y * channels + e) *
                                           N)[lane] =
        make_float4(h[0], h[1], h[2], h[3]);
}

template <int LANES>
int launch(const float* a_log, const float* dt, const float* dtx,
           const float* b, const float* c, float* y, float* h_last, int batch,
           int seq, int channels, cudaStream_t stream) {
  constexpr int kChannels = kThreads / LANES;
  const dim3 grid((channels + kChannels - 1) / kChannels, batch);
  ssm_scan_kernel<LANES><<<grid, kThreads, 0, stream>>>(
      a_log, dt, dtx, b, c, y, h_last, seq, channels);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// a_log: (channels, state); dt, dtx: (batch, seq, channels); b, c: (batch,
// seq, state); y: (batch, seq, channels); h_last: (batch, channels,
// state).  All f32, contiguous, 16-byte aligned, on the device; state is
// 4, 8, 16, 32, 64 or 128.
int ssm_scan_f32(const float* a_log, const float* dt, const float* dtx,
                 const float* b, const float* c, float* y, float* h_last,
                 int batch, int seq, int channels, int state,
                 cudaStream_t stream) {
  if (batch <= 0 || batch > 65535 || seq < 0 || channels <= 0)
    return (int)cudaErrorInvalidValue;
  switch (state) {
    case 4:
      return launch<1>(a_log, dt, dtx, b, c, y, h_last, batch, seq, channels,
                       stream);
    case 8:
      return launch<2>(a_log, dt, dtx, b, c, y, h_last, batch, seq, channels,
                       stream);
    case 16:
      return launch<4>(a_log, dt, dtx, b, c, y, h_last, batch, seq, channels,
                       stream);
    case 32:
      return launch<8>(a_log, dt, dtx, b, c, y, h_last, batch, seq, channels,
                       stream);
    case 64:
      return launch<16>(a_log, dt, dtx, b, c, y, h_last, batch, seq,
                        channels, stream);
    case 128:
      return launch<32>(a_log, dt, dtx, b, c, y, h_last, batch, seq,
                        channels, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
