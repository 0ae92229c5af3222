// Hopper (sm_90a) kernel for forward GQA attention over a whole sequence:
// causal and/or sliding-window, Sq != Sk allowed, any lengths, queries
// at an offset (a chunk of a longer prompt).
//
// It replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention: _flash_kernel).  For batch row b, query head
// h = kv * groups + g and query position i,
//
//   s_ij  = (q[b, i, kv, g] . k[b, j, kv]) * hd^-0.5                     (f32)
//   masked to -1e30 where j >= Sk, causal and j > q_start + i, or
//   window > 0 and q_start + i - j >= window (key j at absolute position
//   j, query row i at q_start + i; q_start = 0 is the Pallas kernel's
//   whole-sequence case, q_start > 0 a chunk of a prompt resumed over the
//   keys already in its cache)
//   out[b, i, kv, g] = sum_j p_ij v[b, j, kv] / max(sum_j p_ij, 1e-30)
//
// with the online softmax of _flash_kernel: over key tiles, m' = max(m,
// max s), p = exp(s - m'), l' = l e^(m-m') + sum p, acc' = acc e^(m-m') +
// round(p) V, where round(p) is p in v's dtype (bf16 inputs round it, f32
// inputs do not).  Inputs are f32 or bf16; the output is in q's dtype.
//
// Bound on an H100 SXM: operations.  A causal prefill of S tokens does
// 4 hd flops per live (query, key) pair; at the qwen3-0.6b prefill (8 kv
// heads, G 2, hd 128, S = 512) 1.08 GFLOP against 12.6 MB of f32 q, k, v
// and o (3.8 us at 3.35 TB/s).  Both products run on the tensor cores:
// bf16 at 989 TFLOP/s (1.1 us, so the bytes bound the bf16 body), and f32
// as 3xTF32 (three TF32 products per f32 one, 495 / 3 = 165 TFLOP/s:
// 6.5 us) where the CUDA cores' f32 would take 16 us.
//
// Design.
//
// * Tensor cores through mma.sync (m16n8k16 bf16 -> f32 for bf16 inputs,
//   m16n8k8 tf32 -> f32 for f32 inputs), both products.  Each warp owns
//   16 rows of the CTA's 64 and every key column of its scores, so the row
//   max and sum are shuffles within a quad and P never leaves registers:
//   the S accumulator of two 8-key column tiles is the A operand of the PV
//   product over those 16 keys (bf16), and for tf32 the PV product's key
//   order is permuted (logical k = t <-> key 2t, k = t + 4 <-> key 2t + 1)
//   so that the accumulator (g, 2t), (g, 2t + 1) is again the A operand as
//   it stands, V's fragment read in the same order.  QK^T takes the same
//   permutation over hd, so its fragments are 8-byte shared-memory reads.
// * f32 as 3xTF32: x = hi + lo, hi = x rounded to TF32 (cvt.rna's result,
//   in two integer instructions), lo = x - hi (exact; the tensor core reads
//   its top 19 bits); a.b ~ lo_a.hi_b + hi_a.lo_b + hi_a.hi_b into one f32
//   accumulator, smallest first, lo.lo dropped: ~2^-21 relative, inside
//   the reference's 2e-5 where one TF32 product is ~1e-3 off.  The split is
//   made as each fragment is read from shared memory (q's once per key
//   tile, k's and v's once per warp), which keeps the tiles in f32.
// * GQA rows packed: the G query heads of one kv head fill the 64 rows
//   together (row R = position * G + head), so each K/V tile is staged
//   once per kv head and tile of 64 / G positions.  The masks follow each
//   row's position R / G.  G > 64 spreads one position over CTAs.
// * Two or three warpgroups per CTA split the key tiles of its 64 rows
//   (tiles 0, W, 2W, ... for warpgroup 0 of W, 1, W + 1, ... for the
//   next, by absolute tile index, key tiles aligned to key 0), each
//   walking them through its own ring of two cp.async stages
//   (the copy of its next tile runs under the current tile's products; a
//   named barrier per warpgroup), and warpgroups 1.. hand their (m, l,
//   acc) to warpgroup 0 at the end, which merges them in a fixed order.
//   So each SM scheduler holds two or three warps, and the causal row
//   tiles that see the most keys take a half or a third as long.  Three
//   where 384 threads' registers (168 each) and three rings fit: bf16 at
//   hd <= 128.  Tiles stay in the input dtype, rows padded so the fragment
//   reads are conflict-free (f32 q and k rows by 8 floats for the 8-byte
//   reads, v rows by 4 for the 4-byte column reads; bf16 rows by 8 for
//   ldmatrix).
// * Key tiles of 64, smaller where two stages per warpgroup would not fit
//   (f32: 32 at hd 128, 16 at hd 256; bf16: 32 at hd 256).  Tiles that are
//   wholly masked for every row of the CTA (past the causal diagonal,
//   before the window) are skipped, and only tiles that cut the mask test
//   it: a row's masked entries contribute exp2(-1e30 - m) = 0 once it has
//   seen a live key, and before that its corr = exp2(-1e30 - m) = 0 erases
//   them, so the result is the reference's.  Query tiles run heaviest
//   first.  The sums run in a fixed order: the output is bitwise equal
//   from run to run.
// * A row's output does not depend on which rows share its CTA or where
//   its chunk starts (q_start): its live key tiles are the same absolute
//   tiles on the same warpgroups in the same order, a wholly masked tile
//   after a live one is an exact no-op (corr = exp2(0) = 1, p = 0), and a
//   warpgroup that saw no live key of the row is erased at the merge
//   (weight exp2(-1e30 - m) = 0; warpgroup 0 always holds key 0, live for
//   every causal row).  So a prefix-cache hit's chunks give bitwise the
//   cold chunks' rows.
// * The library builds with -fmad=false (for the bitwise kernels), which
//   leaves mma alone; the softmax takes scores to the log2 domain with one
//   product and ex2.approx, as the online softmax allows.
//
// Shared memory per instantiation (q tile + 2 stages of k and v per
// warpgroup):
//   f32 (2 warpgroups):  hd 32: 88,064 B; hd 64: 161,792 B; hd 80:
//         198,656 B; hd 128 (keys 32): 172,032 B; hd 256 (keys 16):
//         201,728 B
//   bf16 (3 warpgroups): hd 32: 66,560 B; hd 64: 119,808 B; hd 80:
//         146,432 B; hd 128: 226,304 B; hd 256 (keys 32, 2 warpgroups):
//         168,960 B
//
// The entry points launch on the caller's stream and current device,
// allocate nothing and return cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWGThreads = 128;      // one warpgroup
constexpr int kBM = 64;              // packed query rows per CTA
constexpr float kNegInf = -1e30f;    // the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxDevices = 64;      // devices whose smem limit is tracked

// warpgroups splitting a CTA's key tiles: three where their registers
// (at most 168 each at 384 threads) and rings fit, else two
template <typename T, int HD>
constexpr int warpgroups() {
  return std::is_same<T, float>::value || HD == 256 ? 2 : 3;
}

// keys per tile: two stages per warpgroup must fit beside the q tile
template <typename T, int HD>
constexpr int key_tile() {
  if (std::is_same<T, float>::value) return HD <= 80 ? 64 : HD == 128 ? 32 : 16;
  return HD <= 128 ? 64 : 32;
}

template <typename T, int HD>
struct Tile {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kWG = warpgroups<T, HD>();
  static constexpr int kThreads = kWG * kWGThreads;
  static constexpr int BN = key_tile<T, HD>();
  static constexpr int QS = HD + 8;                  // row strides
  static constexpr int KS = HD + 8;
  static constexpr int VS = kF32 ? HD + 4 : HD + 8;
  static constexpr int kStage = BN * KS + BN * VS;   // elements
  static constexpr int kBytes =
      (kBM * QS + kWG * 2 * kStage) * (int)sizeof(T);
  static constexpr int kChunk = 16 / (int)sizeof(T);  // elements per 16 B
  static constexpr int kRowChunks = HD / kChunk;
  // the hand-over of (m, l, o) between warpgroups reuses the ring
  static constexpr int kHand = (HD / 2 + 4) * kWGThreads;   // floats
  static_assert((kWG - 1) * kHand * 4 <= kWG * 2 * kStage * (int)sizeof(T),
                "the ring holds the hand-over");
  static_assert(kBytes <= 232448, "227 KB of shared memory per block");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, zero-filled where !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo: hi is x rounded to TF32, to nearest with ties away from
// zero (cvt.rna.tf32.f32's result for finite x, in two integer
// instructions); lo = x - hi is exact in f32, and the tensor core reads
// its top 19 bits
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// a barrier over one warpgroup's 128 threads (barrier 0 is the CTA's)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kWGThreads)
               : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a.b as 3xTF32, smallest products first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float b0,
                                           float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// S (16 x BN per warp) += Q K^T over hd.  s[j] is the 8-key column tile j:
// s[j][0..1] row g, keys 8j + 2t, +1; s[j][2..3] row g + 8.
template <typename T, int HD>
__device__ __forceinline__ void scores(float (&s)[Tile<T, HD>::BN / 8][4],
                                       const T* q_s, const T* k_s, int warp,
                                       int lane) {
  using L = Tile<T, HD>;
  constexpr int NT = L::BN / 8;
  const int g = lane >> 2, t = lane & 3;
  if constexpr (L::kF32) {
    // logical k = t <-> d 2t, k = t + 4 <-> d 2t + 1 (both operands)
    const float* qa = q_s + (warp * 16 + g) * L::QS + 2 * t;
    const float* kb = k_s + g * L::KS + 2 * t;
#pragma unroll 2
    for (int d = 0; d < HD; d += 8) {
      const float2 q0 = *reinterpret_cast<const float2*>(qa + d);
      const float2 q1 = *reinterpret_cast<const float2*>(qa + 8 * L::QS + d);
      uint32_t ah[4], al[4];
      split(q0.x, ah[0], al[0]);
      split(q1.x, ah[1], al[1]);
      split(q0.y, ah[2], al[2]);
      split(q1.y, ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 kk =
            *reinterpret_cast<const float2*>(kb + 8 * j * L::KS + d);
        mma_3xtf32(s[j], ah, al, kk.x, kk.y);
      }
    }
  } else {
    const int mi = lane >> 3, r8 = lane & 7;
    // ldmatrix row addresses: A (rows 0-7 | 8-15) x (d 0-7 | 8-15);
    // B pairs of 8-key tiles x (d 0-7 | 8-15)
    const T* qa = q_s + (warp * 16 + (mi & 1) * 8 + r8) * L::QS + (mi >> 1) * 8;
    const T* kb = k_s + ((mi >> 1) * 8 + r8) * L::KS + (mi & 1) * 8;
#pragma unroll 2
    for (int d = 0; d < HD; d += 16) {
      uint32_t a[4];
      ldsm_x4(a, qa + d);
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj) {
        uint32_t b[4];
        ldsm_x4(b, kb + 16 * jj * L::KS + d);
        mma_bf16(s[2 * jj], a, b[0], b[1]);
        mma_bf16(s[2 * jj + 1], a, b[2], b[3]);
      }
    }
  }
}

// O (16 x HD per warp) += P V over the tile's keys, P from registers.
template <typename T, int HD>
__device__ __forceinline__ void accumulate(
    float (&o)[HD / 8][4], const float (&p)[Tile<T, HD>::BN / 8][4],
    const T* v_s, int lane) {
  using L = Tile<T, HD>;
  constexpr int NT = L::BN / 8;
  const int g = lane >> 2, t = lane & 3;
  if constexpr (L::kF32) {
    // k-step j over keys 8j..8j+7: logical k = t <-> key 2t, t + 4 <-> 2t + 1
    const float* vb = v_s + 2 * t * L::VS + g;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t ah[4], al[4];
      split(p[j][0], ah[0], al[0]);
      split(p[j][2], ah[1], al[1]);
      split(p[j][1], ah[2], al[2]);
      split(p[j][3], ah[3], al[3]);
      const float* v0 = vb + 8 * j * L::VS;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        mma_3xtf32(o[n], ah, al, v0[8 * n], v0[L::VS + 8 * n]);
    }
  } else {
    const int mi = lane >> 3, r8 = lane & 7;
    // ldmatrix.trans row addresses: (keys 0-7 | 8-15) x (d 0-7 | 8-15)
    const T* vb = v_s + ((mi & 1) * 8 + r8) * L::VS + (mi >> 1) * 8;
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
      a[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
      a[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
      a[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
      for (int nn = 0; nn < HD / 16; ++nn) {
        uint32_t b[4];
        ldsm_x4_t(b, vb + 16 * kk * L::VS + 16 * nn);
        mma_bf16(o[2 * nn], a, b[0], b[1]);
        mma_bf16(o[2 * nn + 1], a, b[2], b[3]);
      }
    }
  }
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

template <typename T, int HD>
__global__ void __launch_bounds__(Tile<T, HD>::kThreads, 1)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int sq, int sk, int kv_heads, int groups,
                           int row_tiles, int causal, int window,
                           int q_start, float scale) {
  using L = Tile<T, HD>;
  constexpr int BN = L::BN;
  constexpr int NT = BN / 8;
  constexpr int kWG = L::kWG;
  constexpr int kThreads = L::kThreads;
  extern __shared__ float4 smem4[];
  T* q_s = reinterpret_cast<T*>(smem4);
  T* ring = q_s + kBM * L::QS;

  // heaviest row tiles first; then kv head, then batch row
  const int heads_b = (int)(gridDim.x / row_tiles);   // kv_heads * batch
  const int tile = row_tiles - 1 - (int)(blockIdx.x / heads_b);
  const int hb = (int)(blockIdx.x % heads_b);
  const int kvh = hb % kv_heads;
  const int b = hb / kv_heads;
  const int rows = sq * groups;
  const int m0 = tile * kBM;
  const int tid = threadIdx.x;
  const int wg = tid / kWGThreads;         // this thread's warpgroup
  const int wt = tid % kWGThreads;         // and its index there
  const int warp = wt >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  const int64_t kv_row = (int64_t)kv_heads * HD;
  const T* kb = k + (int64_t)b * sk * kv_row + (int64_t)kvh * HD;
  const T* vb = v + (int64_t)b * sk * kv_row + (int64_t)kvh * HD;
  // row R of the tile is query head kvh * groups + R % groups at position
  // R / groups: q + ((b sq + pos) kv_heads + kvh) groups hd + (R % G) hd
  const int64_t q_pos_stride = (int64_t)kv_heads * groups * HD;
  const int64_t q_base = ((int64_t)b * sq * kv_heads + kvh) * groups * HD;

  // the key range any row of this tile can see (absolute positions: row
  // R sits at q_start + R / groups); warpgroup w takes the key tiles of
  // absolute index w mod kWG in it
  const int p_first = q_start + m0 / groups;
  const int p_last = q_start + (min(m0 + kBM, rows) - 1) / groups;
  const int k_end = causal ? min(sk, p_last + 1) : sk;
  const int k_begin = window > 0 ? max(0, p_first - window + 1) : 0;
  const int k_first = ((k_begin / BN) / kWG * kWG + wg) * BN;
  T* my_ring = ring + wg * 2 * L::kStage;   // this warpgroup's two stages

  auto stage_kv = [&](int k0, int st) {
    T* ks = my_ring + st * L::kStage;
    T* vs = ks + BN * L::KS;
    for (int c = wt; c < BN * L::kRowChunks; c += kWGThreads) {
      const int r = c / L::kRowChunks;
      const int e = (c - r * L::kRowChunks) * L::kChunk;
      const bool valid = k0 + r < sk;
      const int64_t off = valid ? (int64_t)(k0 + r) * kv_row + e : 0;
      cp_async16(ks + r * L::KS + e, kb + off, valid);
      cp_async16(vs + r * L::VS + e, vb + off, valid);
    }
  };

  // the q tile (rows past sq * groups are zeros, never written out), one
  // group; then each warpgroup's first k/v tile
  for (int c = tid; c < kBM * L::kRowChunks; c += kThreads) {
    const int r = c / L::kRowChunks;
    const int e = (c - r * L::kRowChunks) * L::kChunk;
    const int R = m0 + r;
    const bool valid = R < rows;
    const int64_t off =
        valid ? q_base + (int64_t)(R / groups) * q_pos_stride +
                    (int64_t)(R % groups) * HD + e
              : 0;
    cp_async16(q_s + r * L::QS + e, q + off, valid);
  }
  cp_async_commit();
  if (k_first < k_end) stage_kv(k_first, 0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();   // q landed for every warp

  // this thread's rows g and g + 8 of its warp's 16, and their positions
  int pos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    pos[i] = q_start + (m0 + warp * 16 + g + 8 * i) / groups;

  const float sl = scale * kLog2e;   // scores in the log2 domain
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};           // this thread's columns' share
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  int st = 0;
  for (int k0 = k_first; k0 < k_end; k0 += kWG * BN, st ^= 1) {
    if (k0 + kWG * BN < k_end) stage_kv(k0 + kWG * BN, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();   // this tile landed; the next in flight
    wg_sync(wg);
    const T* ks = my_ring + st * L::kStage;
    const T* vs = ks + BN * L::KS;

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    scores<T, HD>(s, q_s, ks, warp, lane);

    // does the mask cut this tile for any row of the CTA?
    const bool cut = k0 + BN > sk || (causal && k0 + BN - 1 > p_first) ||
                     (window > 0 && p_last - k0 >= window);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[j][2 * i + e] * sl;
          if (cut) {
            const int kpos = k0 + 8 * j + 2 * t + e;
            const bool live = kpos < sk && (!causal || kpos <= pos[i]) &&
                              (window <= 0 || pos[i] - kpos < window);
            x = live ? x : kNegInf;
          }
          s[j][2 * i + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      const float corr = ex2(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = ex2(s[j][2 * i + e] - m_new);
          sum += p;
          s[j][2 * i + e] = p;
        }
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        o[n][2 * i] *= corr;
        o[n][2 * i + 1] *= corr;
      }
    }
    accumulate<T, HD>(o, s, vs, lane);
    wg_sync(wg);   // this stage is read before it is staged again
  }
  cp_async_wait<0>();

  if constexpr (kWG > 1) {
    // warpgroups 1.. hand (m, l, o) to warpgroup 0 through the free ring,
    // thread for thread (their fragments cover the same rows and
    // columns); warpgroup 0 merges them in order: m = max, each side
    // scaled by exp2(its m - m), a side that saw no live key (m = -1e30)
    // by 0
    __syncthreads();   // every ring consumed
    if (wg > 0) {
      float* hand = reinterpret_cast<float*>(ring) + (wg - 1) * L::kHand;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          hand[(n * 4 + c) * kWGThreads + wt] = o[n][c];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        hand[(HD / 2 + i) * kWGThreads + wt] = m[i];
        hand[(HD / 2 + 2 + i) * kWGThreads + wt] = l[i];
      }
    }
    __syncthreads();
    if (wg > 0) return;
    for (int w = 1; w < kWG; ++w) {
      const float* h = reinterpret_cast<const float*>(ring) +
                       (w - 1) * L::kHand;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m1 = h[(HD / 2 + i) * kWGThreads + wt];
        const float l1 = h[(HD / 2 + 2 + i) * kWGThreads + wt];
        const float mm = fmaxf(m[i], m1);
        const float c0 = ex2(m[i] - mm);
        const float c1 = ex2(m1 - mm);
        m[i] = mm;
        l[i] = l[i] * c0 + l1 * c1;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            o[n][2 * i + e] = o[n][2 * i + e] * c0 +
                              h[(n * 4 + 2 * i + e) * kWGThreads + wt] * c1;
      }
    }
  }

  // finalize: acc / max(l, 1e-30) in q's dtype
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const float denom = fmaxf(li, 1e-30f);
    const int R = m0 + warp * 16 + g + 8 * i;
    if (R >= rows) continue;
    T* orow = out + q_base + (int64_t)(R / groups) * q_pos_stride +
              (int64_t)(R % groups) * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      store2(orow + 8 * n, o[n][2 * i] / denom, o[n][2 * i + 1] / denom);
  }
}

template <typename T, int HD>
int launch_hd(const T* q, const T* k, const T* v, T* out, int batch, int sq,
              int sk, int kv_heads, int groups, int causal, int window,
              int q_start, float scale, cudaStream_t stream) {
  constexpr int smem = Tile<T, HD>::kBytes;
  // above 48 KB a block takes dynamic shared memory only once allowed;
  // the attribute is the current device's: raised once on each
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (smem > 48 * 1024 && (dev >= kMaxDevices || !raised[dev])) {
    e = cudaFuncSetAttribute(flash_attention_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < kMaxDevices) raised[dev] = true;
  }
  const int64_t row_tiles = ((int64_t)sq * groups + kBM - 1) / kBM;
  const int64_t ctas = row_tiles * kv_heads * batch;
  if ((int64_t)sq * groups > 0x7fffffff - kBM || ctas > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  flash_attention_kernel<T, HD>
      <<<(unsigned)ctas, Tile<T, HD>::kThreads, smem, stream>>>(
      q, k, v, out, sq, sk, kv_heads, groups, (int)row_tiles, causal, window,
      q_start, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int sq, int sk, int kv_heads, int groups, int hd, int causal,
           int window, int q_start, float scale, cudaStream_t stream) {
  if (batch <= 0 || sq <= 0 || sk <= 0 || kv_heads <= 0 || groups <= 0 ||
      q_start < 0 || (int64_t)q_start + sq > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(out);
  switch (hd) {
    case 32:
      return launch_hd<T, 32>(qq, kk, vv, oo, batch, sq, sk, kv_heads,
                              groups, causal, window, q_start, scale,
                              stream);
    case 64:
      return launch_hd<T, 64>(qq, kk, vv, oo, batch, sq, sk, kv_heads,
                              groups, causal, window, q_start, scale,
                              stream);
    case 80:
      return launch_hd<T, 80>(qq, kk, vv, oo, batch, sq, sk, kv_heads,
                              groups, causal, window, q_start, scale,
                              stream);
    case 128:
      return launch_hd<T, 128>(qq, kk, vv, oo, batch, sq, sk, kv_heads,
                               groups, causal, window, q_start, scale,
                               stream);
    case 256:
      return launch_hd<T, 256>(qq, kk, vv, oo, batch, sq, sk, kv_heads,
                               groups, causal, window, q_start, scale,
                               stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q: (batch, sq, kv_heads, groups, hd); k, v: (batch, sk, kv_heads, hd);
// out: like q.  All in the entry point's dtype, contiguous, 16-byte
// aligned, on the current device.  hd is 32, 64, 80, 128 or 256; causal
// is 0 or 1; window <= 0 means no window; q_start >= 0 is query row 0's
// absolute position; scale is hd^-0.5 as f32.
int flash_attention_f32(const void* q, const void* k, const void* v,
                        void* out, int batch, int sq, int sk, int kv_heads,
                        int groups, int hd, int causal, int window,
                        int q_start, float scale, cudaStream_t stream) {
  return launch<float>(q, k, v, out, batch, sq, sk, kv_heads, groups, hd,
                       causal, window, q_start, scale, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* out, int batch, int sq, int sk, int kv_heads,
                         int groups, int hd, int causal, int window,
                         int q_start, float scale, cudaStream_t stream) {
  return launch<__nv_bfloat16>(q, k, v, out, batch, sq, sk, kv_heads, groups,
                               hd, causal, window, q_start, scale, stream);
}

}  // extern "C"
