// Causal (or full) flash attention forward for Hopper (sm_90a) in float32:
// B7, `flash_attention`, for float32 inputs (bfloat16 inputs go to the
// wgmma kernel of flash_fwd_sm90.cu).
//
// Replaces the TPU kernel `flash_attention_kernel` (`_flash_kernel`) in
// src/repro/kernels/flash_attention/kernel.py:281.  Inputs in the models'
// layout, contiguous: q (B, Sq, H, dh), k and v (B, Sk, KV, dh), float32;
// query head h reads KV head h / (H / KV), the order of the reference's
// `jnp.repeat` and `_group_heads`, with no copy.  Output o (B, Sq, H, dh):
//
//   s_ij = (q_i . k_j) * dh^-0.5 on keys j < Sk, and j <= i when causal
//          (top-left aligned when Sq != Sk, as in the reference);
//   o_i  = sum_j exp(s_ij - m_i) v_j / max(l_i, 1e-30),
//          l_i = sum_j exp(s_ij - m_i),
//
// an online softmax over key tiles, in float32.  Masked scores are -1e30,
// as in the reference.
//
// What bounds it: the tensor cores' rate for float32 products.  At the LM
// prefill's shape (zamba2-7b, B = 2, S = 4096, 32 heads of 112, causal)
// one call does 240 GFLOP over the causal pairs and moves 0.47 GB (0.14 ms
// of bytes).  On the CUDA cores that is 3.59 ms at 67 TFLOP/s.  Here both
// products run on the tensor cores as 3xTF32 (what SDPA's float32
// kernel does), which keeps float32 accuracy: each operand x is split into
// a TF32 part hi(x) (x cut to 10 mantissa bits) and the rest
// lo(x) = x - hi(x), and a . b is accumulated in float32 as
// lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b), dropping only lo(a) lo(b) and
// the bits of lo past TF32's (about 2^-20 of the product).  Three TF32
// products: at 495 TFLOP/s the bound is 3 x 240 GFLOP = 1.45 ms.  The LM's
// float32 logits parity rests on this; a single TF32 product (10 bits)
// would not hold it.  What limits it now is issue slots as much as the
// tensor cores: each mma.sync needs its operands split (two instructions
// an element) and loaded from shared memory.  Design, after
// FlashAttention-2:
//
//  * one block per (b, h, tile of query rows), the heaviest causal tiles
//    (the last query rows) launched first; each warp owns 16 query rows;
//    8 warps and 64-key tiles for dh <= 128, 4 warps and 32-key tiles
//    above (shared memory);
//  * products on mma.sync m16n8k8 (TF32 in, float32 accumulators).  The
//    block's Q tile stays in shared memory for the whole key loop, and a
//    warp reads its fragments per k-step (kept in registers, they took
//    all 255 registers and spilled at dh 112 and 128, and ran slower); S =
//    Q K^T stays in registers, and so does P, which is the A operand of
//    O += P V: the accumulator holds keys (2t, 2t + 1) of each 8-key group
//    where the A operand wants (t, t + 4), so the keys of each group are
//    taken in the order 0, 2, 4, 6, 1, 3, 5, 7 for P and V alike (the sum
//    over keys does not depend on it), and P needs no shuffle.  The head
//    dimension of Q K^T is permuted the same way, so a lane's K fragment
//    is two adjacent floats, one 8-byte shared load;
//  * K and V tiles stream through a two-stage cp.async ring (16-byte
//    copies, zero past Sk): the next tile loads while this one is used.
//    Rows are padded so that every fragment load is free of bank
//    conflicts: Q and K by 8 floats (8-byte loads of rows g at dims 2t), V
//    by 4 (4-byte loads of keys 2t at dims g: TF32 has no ldmatrix.trans);
//  * the online softmax (m, l, alpha) runs per row in float32 registers,
//    in the exp2 domain (scores scaled by dh^-0.5 log2 e), the row's max
//    over the 4 lanes that hold it by shuffles;
//  * in causal mode the block's key loop stops at the tile holding its
//    last diagonal key, and a warp skips the products of a tile whose keys
//    all lie past its 16 rows; scores past Sk or the diagonal are -1e30;
//  * 1 / max(l, 1e-30) in the epilogue; rows past Sq are not written.
//
// Plain C interface for ctypes; the wrapper (kernel.py) picks the key tile
// (kernel.flash_plan), allocates the output and raises on a non-zero
// return.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
struct Geom {
  static_assert(DH % 16 == 0, "dh must be a multiple of 16");
  static constexpr bool kWide = DH > 128;
  static constexpr int kWarps = kWide ? 4 : 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBQ = 16 * kWarps;       // query rows per block
  static constexpr int kBK = kWide ? 32 : 64;   // keys per tile
  static constexpr int kKP = DH + 8;            // Q and K row pitch
  static constexpr int kVP = DH + 4;            // V row pitch
  static constexpr int kStage = kBK * (kKP + kVP);        // floats
  static constexpr int kSmem = 4 * (2 * kStage + kBQ * kKP);  // bytes
  static constexpr int kNT = kBK / 8;   // n-tiles of S = k-steps of P V
  static constexpr int kDT = DH / 8;    // k-steps of Q K^T = n-tiles of O
};

// x = hi + lo: hi is x cut to TF32 (10 mantissa bits, the low 13 bits
// zero); lo = x - hi is exact in float32 and goes to the tensor core as it
// is, which reads its top 19 bits (the low 13 are ignored).  Cutting hi,
// not rounding it, saves an instruction an element, for about a fifth
// more error, still some thirty times inside the 2e-4 tolerance.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const uint32_t h = __float_as_uint(x) & 0xffffe000u;
  hi = h;
  lo = __float_as_uint(x - __uint_as_float(h));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b in 3xTF32, the small products first; a given as its two
// parts, b as the two floats of the lane's fragment.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           float b0, float b1) {
  uint32_t h0, l0, h1, l1;
  split(b0, h0, l0);
  split(b1, h1, l1);
  mma_tf32(d, a_lo, h0, h1);
  mma_tf32(d, a_hi, l0, l1);
  mma_tf32(d, a_hi, h0, h1);
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool live) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(live ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [r0, r0 + rows) of a (.., ld) operand, DH floats each, into shared
// rows of `pitch` floats; rows at or past r_end are zero.
template <int DH, int kThreads>
__device__ __forceinline__ void stage_rows(float* dst, int pitch,
                                           const float* __restrict__ src,
                                           int64_t ld, int r0, int rows,
                                           int r_end, int tid) {
  constexpr int kChunks = DH / 4;               // 16-byte chunks a row
  for (int e = tid; e < rows * kChunks; e += kThreads) {
    const int r = e / kChunks, c = (e % kChunks) * 4;
    const bool live = r0 + r < r_end;
    cp_async16(dst + r * pitch + c,
               live ? src + (r0 + r) * ld + c : src, live);
  }
}

template <int DH>
__global__ void __launch_bounds__(Geom<DH>::kThreads, 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int sq,
                 int sk, int heads, int kv_heads, int causal, float scale) {
  using G = Geom<DH>;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem + 2 * G::kStage;             // [kBQ][kKP]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;        // mma groupID, thread in group
  const int qtile = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int q_start = qtile * G::kBQ;
  const int row0 = q_start + 16 * warp;          // the warp's first row
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int kvh = h / (heads / kv_heads);
  const int64_t q_row = static_cast<int64_t>(heads) * DH;     // q, o
  const int64_t k_row = static_cast<int64_t>(kv_heads) * DH;  // k, v
  const float* qb = q + static_cast<int64_t>(b) * sq * q_row + h * DH;
  const float* kb = k + static_cast<int64_t>(b) * sk * k_row + kvh * DH;
  const float* vb = v + static_cast<int64_t>(b) * sk * k_row + kvh * DH;

  // Keys this tile of queries can see: all of them, or up to its last row.
  const int k_end = causal ? min(sk, q_start + G::kBQ) : sk;
  const int n_tiles = (k_end + G::kBK - 1) / G::kBK;

  auto stage_kv = [&](int tile) {
    float* ks = smem + (tile & 1) * G::kStage;
    float* vs = ks + G::kBK * G::kKP;
    const int k0 = tile * G::kBK;
    stage_rows<DH, G::kThreads>(ks, G::kKP, kb, k_row, k0, G::kBK, sk, tid);
    stage_rows<DH, G::kThreads>(vs, G::kVP, vb, k_row, k0, G::kBK, sk, tid);
  };
  stage_rows<DH, G::kThreads>(qs, G::kKP, qb, q_row, q_start, G::kBQ, sq,
                              tid);
  stage_kv(0);
  cp_async_commit();
  // The warp's Q rows g and g + 8 at dims 8d + 2t, 8d + 2t + 1 (lane (g,
  // t)): k-step d's A fragment, (a0, a1, a2, a3) = (Q[g][2t], Q[g + 8][2t],
  // Q[g][2t + 1], Q[g + 8][2t + 1]).
  const float* q0 = qs + (16 * warp + g) * G::kKP + 2 * t;

  const float sl = scale * kLog2e;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[G::kDT][4];
#pragma unroll
  for (int n = 0; n < G::kDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_all();
    __syncthreads();        // tile `it` is in; tile it - 1's stage is free
    if (it + 1 < n_tiles) stage_kv(it + 1);
    cp_async_commit();

    const int k0 = it * G::kBK;
    if (causal && k0 > row0 + 15) continue;    // all past the warp's rows
    const float* ks = smem + (it & 1) * G::kStage;
    const float* vs = ks + G::kBK * G::kKP;

    // S = Q K^T over the tile's keys: n-tile j holds keys 8j + g.
    float s[G::kNT][4];
#pragma unroll
    for (int j = 0; j < G::kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int d = 0; d < G::kDT; ++d) {
      uint32_t a_hi[4], a_lo[4];
      const float2 r0 = *reinterpret_cast<const float2*>(q0 + 8 * d);
      const float2 r1 =
          *reinterpret_cast<const float2*>(q0 + 8 * G::kKP + 8 * d);
      split(r0.x, a_hi[0], a_lo[0]);
      split(r1.x, a_hi[1], a_lo[1]);
      split(r0.y, a_hi[2], a_lo[2]);
      split(r1.y, a_hi[3], a_lo[3]);
#pragma unroll
      for (int j = 0; j < G::kNT; ++j) {
        const float2 kv = *reinterpret_cast<const float2*>(
            ks + (8 * j + g) * G::kKP + 8 * d + 2 * t);
        mma_3xtf32(s[j], a_hi, a_lo, kv.x, kv.y);
      }
    }

    // Online softmax; lane (g, t) holds rows g and g + 8, keys 8j + 2t and
    // 8j + 2t + 1 of each n-tile j.
    const bool edge = k0 + G::kBK > sk || (causal && k0 + G::kBK - 1 > row0);
    float mt[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < G::kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * sl;
        if (edge) {
          const int kj = k0 + 8 * j + 2 * t + (e & 1);
          const int qi = row0 + g + 8 * (e >> 1);
          if (kj >= sk || (causal && kj > qi)) x = kNegInf;
        }
        s[j][e] = x;
        mt[e >> 1] = fmaxf(mt[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float m_new = fmaxf(m[r], mt[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < G::kDT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
#pragma unroll
    for (int j = 0; j < G::kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m[e >> 1]);
        l[e >> 1] += p;
        s[j][e] = p;
      }

    // O += P V: k-step j is n-tile j of S.  Its A operand takes keys in the
    // order 0, 2, .., 6, 1, 3, .., 7: (a0, a1, a2, a3) = P rows (g, g + 8)
    // at keys 2t, then at 2t + 1 -- the accumulator's (s0, s2, s1, s3) --
    // and V's fragment rows t and t + 4 are keys 2t and 2t + 1.
#pragma unroll
    for (int j = 0; j < G::kNT; ++j) {
      uint32_t p_hi[4], p_lo[4];
      split(s[j][0], p_hi[0], p_lo[0]);
      split(s[j][2], p_hi[1], p_lo[1]);
      split(s[j][1], p_hi[2], p_lo[2]);
      split(s[j][3], p_hi[3], p_lo[3]);
      const float* v0 = vs + (8 * j + 2 * t) * G::kVP + g;
#pragma unroll
      for (int n = 0; n < G::kDT; ++n)
        mma_3xtf32(acc[n], p_hi, p_lo, v0[8 * n], v0[G::kVP + 8 * n]);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float li = l[r];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int qi = row0 + g + 8 * r;
    if (qi < sq) {
      const float inv = 1.f / fmaxf(li, 1e-30f);
      float* orow = o + static_cast<int64_t>(b) * sq * q_row + qi * q_row +
                    h * DH + 2 * t;
#pragma unroll
      for (int n = 0; n < G::kDT; ++n)
        *reinterpret_cast<float2*>(orow + 8 * n) =
            make_float2(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    }
  }
}

template <int DH>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   int b, int sq, int sk, int heads, int kv_heads,
                   int causal, float scale, cudaStream_t stream) {
  using G = Geom<DH>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        G::kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((sq + G::kBQ - 1) / G::kBQ, b * heads);
  flash_fwd_kernel<DH><<<grid, G::kThreads, G::kSmem, stream>>>(
      q, k, v, o, sq, sk, heads, kv_heads, causal, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// float32 q, k, v, o, 16-byte aligned; key_tile as kernel.flash_plan
// chooses it.  `scale` is dh^-0.5 as the wrapper rounds it to float32.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a (dh, key_tile) without an instantiation.
int mrsch_flash_fwd(const void* q, const void* k, const void* v, void* o,
                    int b, int sq, int sk, int heads, int kv_heads, int dh,
                    int key_tile, int causal, float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto qf = static_cast<const float*>(q);
  auto kf = static_cast<const float*>(k);
  auto vf = static_cast<const float*>(v);
  auto of = static_cast<float*>(o);
#define MRSCH_FLASH_CASE(DH)                                                \
  if (dh == DH && key_tile == Geom<DH>::kBK)                                \
    return static_cast<int>(launch<DH>(qf, kf, vf, of, b, sq, sk, heads,    \
                                       kv_heads, causal, scale, s));
  MRSCH_FLASH_CASE(16)
  MRSCH_FLASH_CASE(32)
  MRSCH_FLASH_CASE(64)
  MRSCH_FLASH_CASE(112)
  MRSCH_FLASH_CASE(128)
  MRSCH_FLASH_CASE(192)
  MRSCH_FLASH_CASE(256)
#undef MRSCH_FLASH_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* mrsch_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
