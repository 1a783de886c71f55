// Mamba2 chunked SSD (state-space duality) for Hopper (sm_90a): B8, `ssd`.
//
// Replaces the TPU kernel `ssd_kernel` (`_ssd_kernel`) in
// src/repro/kernels/ssd/kernel.py:62.  Per (batch, head), chunk by chunk,
// with the (N, P) float32 state h carried across chunks:
//
//   y_i  = sum_{j <= i} (C_i . B_j) exp(l_i - l_j) dt_j x_j     (intra)
//        + exp(l_i) (C_i . h)                                    (inter)
//   h   <- exp(l_last) h + sum_j (B_j exp(l_last - l_j) dt_j)^T x_j
//
// where i, j run over one chunk and l is the within-chunk cumulative sum of
// dA = dt * A (the wrapper computes it).  Inputs in the models' layout:
// x (B, S, H, P), B and C (B, S, G, N) with head h reading group
// h / (H / G) (no per-head copy), each with its own batch and token
// strides and unit head and feature strides, so the model's slices of its
// fused projection go in as they are; dt and l (B, Sp, H) float32, padded by
// the wrapper to Sp, a multiple of the chunk.  Tokens at or past S read as
// zero x, B and C (the reference pads them with zeros, which adds nothing
// to the rows before them) and are not written.  x, B and C are float32 or
// bfloat16; y (B, S, H, P) is float32 or x's dtype.
//
// What bounds it: at zamba2-7b's prefill (B = 2, S = 4096, 112 heads of
// P = 64, N = 64, chunk 256) a call does ~45 GFLOP over 0.35 GB: 0.108 ms
// of bytes, 0.67 ms of float32 FMA.  The TPU kernel walks the chunks of a
// (batch, head) in order on one core with the state in VMEM; one block per
// (batch, head) here filled 224 blocks on 132 SMs and ran on the CUDA
// cores.  Instead, the work is the decomposition of the JAX package's
// `_ssd_chunked` (src/repro/models/mamba2.py:57), in three launches that
// are parallel over chunks:
//
//  1. ssd_chunk_state_kernel, one block per (chunk, batch-head): the
//     chunk's local state S_c = (B exp(l_last - l) dt)^T x (N x P, float32)
//     into a workspace (B, H, n_chunks, N, P) that the wrapper allocates;
//  2. ssd_state_pass_kernel, per (batch-head, slice of the state): walks
//     the chunks in order, h_0 = 0, h_c = exp(l_last_{c-1}) h_{c-1} +
//     S_{c-1}, and writes the state entering each chunk in place (bound by
//     the workspace's bytes);
//  3. ssd_chunk_scan_kernel, one block per (chunk, batch-head, tile of 128
//     query rows), the heaviest tiles first: y = the masked, decayed
//     C B^T times dt and x over the key tiles at or below the diagonal,
//     plus exp(l) C h_c.
//
// Every product runs on the tensor cores (mma.sync), 4 warps a block (8 in
// the scan):
//  * bfloat16 in: m16n8k16; x, B and C are exact, and each float32 operand
//    (the scaled B of pass 1, the state h, the decayed scores W) goes in as
//    three bfloat16 parts (about 24 mantissa bits), three products a tile;
//  * float32 in: 3xTF32 on m16n8k8 (lo.hi + hi.lo + hi.hi, hi cut to TF32,
//    as flash_fwd.cu), which keeps float32 accuracy.
// exp(l_i - l_j) is a masked difference computed per element in registers
// (never exp(l_i) exp(-l_j), which overflows: l falls far below 0 over a
// chunk).  The scores stay in registers and are pass 3's A operand: in
// bfloat16 the m16n8 accumulator of two key tiles is the m16n8k16 A
// fragment; in float32 the keys of each group of 8 are taken in the order
// 0, 2, 4, 6, 1, 3, 5, 7 for W and x alike (flash_fwd.cu's permutation).
// Tiles of B, C and x stream into shared memory by cp.async (16-byte
// copies where the strides allow, else element by element), two stages.
// The layouts are fixed at P = 64 and N = 64 or 128 (smaller P and N are
// zero-padded in shared memory).
//
// Plain C interface for ctypes; the wrapper (kernel.py) allocates the
// workspace and the output, launches the three passes in order on one
// stream and raises on a non-zero return.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;      // 4 warps
constexpr int kT = 64;             // tokens of a query or key tile
constexpr int kP = 64;             // the head dim the layouts hold
constexpr int kMaxN = 128;         // largest state width
constexpr int kMaxChunk = 1024;    // longest chunk
constexpr float kLog2e = 1.4426950408889634f;
// bfloat16 parts each float32 operand of a bfloat16 product is cut into
// (the scaled B of the chunk states, the state h of the inter term, and the
// decayed scores W of the intra term).  Three (about 24 mantissa bits): with
// two, y with float32 out came within 8.2e-5 of the plain version's on
// zamba2-7b's operands, against a limit of 1e-4, nearly all of it from W;
// with three, 3.8e-6, for 0.07 ms more a call (NVIDIA H100 80GB HBM3).
constexpr int kParts = 3;

struct Layout {                    // element strides of one operand
  int64_t batch, token;
};

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__host__ __device__ __forceinline__ int round_tile(int n) {
  return (n + kT - 1) / kT * kT;
}

// ------------------------------------------------------------- primitives
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// x = hi + lo, hi rounded to the nearest TF32 (not cut, as flash_fwd.cu
// does: lo is then at most half as large, and of either sign, so what the
// products drop, lo.lo and lo's bits past the top 19 the tensor core reads,
// is smaller and does not lean one way over a contraction); lo = x - hi is
// exact in float32.  Adding half a TF32 step to the bits before cutting
// rounds the magnitude, ties away from zero, as cvt.rna.tf32.f32 does, in
// two integer operations (cvt.rna itself ran the float32 passes slower).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  const uint32_t h = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  hi = h;
  lo = __float_as_uint(x - __uint_as_float(h));
}

// Two values (low half first) as K bfloat16 pairs, the largest first: part k
// is what the parts before it leave, rounded (K = 2: hi + lo, about 16
// mantissa bits; K = 3: about 24).
template <int K>
__device__ __forceinline__ void split_parts(float v0, float v1,
                                            uint32_t (&part)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
    part[k] = *reinterpret_cast<const uint32_t*>(&h);
    v0 -= __low2float(h);
    v1 -= __high2float(h);
  }
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b in 3xTF32, a given as its two parts, b as two floats.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           float b0, float b1) {
  uint32_t h0, l0, h1, l1;
  split_tf32(b0, h0, l0);
  split_tf32(b1, h1, l1);
  mma_tf32(d, a_lo, h0, h1);
  mma_tf32(d, a_hi, l0, l1);
  mma_tf32(d, a_hi, h0, h1);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* smem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* smem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

// Rows [0, R) of a tile of F features into shared rows of kPitch, by kThr
// threads: row r < rows reads src + r * token, features < nfeat; the rest
// is zero.  vec: 16-byte cp.async copies (src, its strides and nfeat
// aligned to them, so a copy lies wholly inside or outside the row); else
// element by element.
template <typename T, int R, int F, int kPitch, int kThr>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src,
                                           int64_t token, int rows,
                                           int nfeat, bool vec, int tid) {
  if (vec) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(T));
    constexpr int kRow = F / kPer;                    // copies a row
    for (int q = tid; q < R * kRow; q += kThr) {
      const int r = q / kRow, c = (q % kRow) * kPer;
      const bool live = r < rows && c < nfeat;
      cp_async16(dst + r * kPitch + c, live ? src + r * token + c : src,
                 live ? 16 : 0);
    }
    return;
  }
  for (int e = tid; e < R * F; e += kThr) {
    const int r = e / F, c = e % F;
    dst[r * kPitch + c] = r < rows && c < nfeat ? src[r * token + c]
                                                : from_f<T>(0.f);
  }
}

// ------------------------------------------------ pass 1: chunk states
// grid = (n_chunks, B * H).  The block's 4 warps form a 2 x 2 grid over the
// (kN x P) state, warp w owning rows (w / 2) * kN / 2 .. of N and columns
// (w % 2) * 32 .. of P.  The contraction runs over the chunk's tokens in
// tiles of 64: B and x land raw by cp.async, then B's rows are scaled by
// exp(l_last - l_j) dt_j in shared memory (bfloat16: into hi and lo
// arrays) before the products.
template <typename T, int kN>
struct StateGeom {
  static constexpr bool kF32 = std::is_same_v<T, float>;
  // float32 fragment reads (row t, column g) fall in distinct banks with a
  // pitch of 8 mod 32 words; bfloat16 rows of 144 or 272 bytes put the 8
  // rows of an ldmatrix in distinct 16-byte bank groups.
  static constexpr int kBP = kN + 8;
  static constexpr int kXP = kP + 8;
  static constexpr int kBBytes = kT * kBP * static_cast<int>(sizeof(T));
  static constexpr int kStage = kBBytes + kT * kXP * static_cast<int>(sizeof(T));
  static constexpr int kHiLo = kF32 ? 0 : kParts * kT * kBP * 2;
  static constexpr int kMI = kN / 32;           // 16-row tiles a warp
  static int bytes(int chunk) {
    return 2 * kStage + kHiLo + 4 * round_tile(chunk);
  }
};

template <typename T, int kN>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_state_kernel(const T* __restrict__ x,
                           const float* __restrict__ dt,
                           const float* __restrict__ lcum,
                           const T* __restrict__ bm,
                           float* __restrict__ states, int seq, int seq_pad,
                           int heads, int groups, int n, int p, int chunk,
                           Layout xl, Layout bl, int vec) {
  using G = StateGeom<T, kN>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* scale = reinterpret_cast<float*>(smem + 2 * G::kStage + G::kHiLo);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;      // mma groupID, thread in group
  const int lr = lane & 7, lm = lane >> 3;      // ldmatrix row, matrix
  const int c = blockIdx.x, bh = blockIdx.y, n_chunks = gridDim.x;
  const int b = bh / heads, h = bh % heads, g = h / (heads / groups);
  const int c_start = c * chunk;
  const int valid = min(chunk, seq - c_start);
  const T* xb = x + b * xl.batch + c_start * xl.token + static_cast<int64_t>(h) * p;
  const T* bb = bm + b * bl.batch + c_start * bl.token + static_cast<int64_t>(g) * n;
  const int64_t at = (static_cast<int64_t>(b) * seq_pad + c_start) * heads + h;
  const float l_last = lcum[at + static_cast<int64_t>(chunk - 1) * heads];
  const int n_kt = (valid + kT - 1) / kT;
  for (int j = tid; j < n_kt * kT; j += kThreads)
    scale[j] = j < valid ? expf(l_last - lcum[at + j * heads]) *
                               dt[at + j * heads]
                         : 0.f;

  auto stage = [&](int kt) {
    unsigned char* st = smem + (kt & 1) * G::kStage;
    const int rows = min(kT, valid - kt * kT);
    stage_rows<T, kT, kN, G::kBP, kThreads>(reinterpret_cast<T*>(st),
                                            bb + kt * kT * bl.token, bl.token,
                                            rows, n, vec, tid);
    stage_rows<T, kT, kP, G::kXP, kThreads>(
        reinterpret_cast<T*>(st + G::kBBytes), xb + kt * kT * xl.token,
        xl.token, rows, p, vec, tid);
    cp_async_commit();
  };

  const int wn0 = (warp >> 1) * (kN / 2), wp0 = (warp & 1) * 32;
  float acc[G::kMI][4][4];
#pragma unroll
  for (int i = 0; i < G::kMI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  stage(0);
  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) {
      stage(kt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                     // tile kt (and scale) in place
    unsigned char* st = smem + (kt & 1) * G::kStage;
    T* bs = reinterpret_cast<T*>(st);
    const T* xs = reinterpret_cast<const T*>(st + G::kBBytes);
    const float* sc = scale + kt * kT;
    if constexpr (G::kF32) {
      for (int e = tid; e < kT * kN; e += kThreads) {
        const int r = e / kN, f = e % kN;
        bs[r * G::kBP + f] *= sc[r];
      }
    } else {
      __nv_bfloat16* parts =
          reinterpret_cast<__nv_bfloat16*>(smem + 2 * G::kStage);
      for (int e = tid; e < kT * kN / 2; e += kThreads) {
        const int r = e / (kN / 2), f = (e % (kN / 2)) * 2;
        const int o = r * G::kBP + f;
        const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(bs + o);
        uint32_t part[kParts];
        split_parts(__low2float(v) * sc[r], __high2float(v) * sc[r], part);
#pragma unroll
        for (int k = 0; k < kParts; ++k)
          *reinterpret_cast<uint32_t*>(parts + k * kT * G::kBP + o) = part[k];
      }
    }
    __syncthreads();                     // the scaled B is in place
    if constexpr (G::kF32) {
#pragma unroll
      for (int ks = 0; ks < kT; ks += 8) {
        // A = B~^T (rows n, contraction j), staged [j][n]: a0..a3 = (n g,
        // j t), (n g + 8, j t), (n g, j t + 4), (n g + 8, j t + 4).
        uint32_t ah[G::kMI][4], al[G::kMI][4];
#pragma unroll
        for (int i = 0; i < G::kMI; ++i) {
          const float* a = bs + (ks + tq) * G::kBP + wn0 + 16 * i + gq;
          split_tf32(a[0], ah[i][0], al[i][0]);
          split_tf32(a[8], ah[i][1], al[i][1]);
          split_tf32(a[4 * G::kBP], ah[i][2], al[i][2]);
          split_tf32(a[4 * G::kBP + 8], ah[i][3], al[i][3]);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          // b0, b1 = x[j t][p g], x[j t + 4][p g].
          const float* q = xs + (ks + tq) * G::kXP + wp0 + 8 * jj + gq;
#pragma unroll
          for (int i = 0; i < G::kMI; ++i)
            mma_3xtf32(acc[i][jj], ah[i], al[i], q[0], q[4 * G::kXP]);
        }
      }
    } else {
      const __nv_bfloat16* parts =
          reinterpret_cast<const __nv_bfloat16*>(smem + 2 * G::kStage);
#pragma unroll
      for (int ks = 0; ks < kT; ks += 16) {
        // A from [j][n] by ldmatrix.trans: matrices (n 0-7, j 0-7), (n 8-15,
        // j 0-7), (n 0-7, j 8-15), (n 8-15, j 8-15); one set per part.
        uint32_t a[G::kMI][kParts][4];
#pragma unroll
        for (int i = 0; i < G::kMI; ++i) {
          const int off = (ks + lr + (lm >> 1) * 8) * G::kBP + wn0 + 16 * i +
                          (lm & 1) * 8;
#pragma unroll
          for (int k = 0; k < kParts; ++k)
            ldsm_x4_trans(a[i][k], parts + k * kT * G::kBP + off);
        }
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          // B = x (contraction j, columns p), staged [j][p]: matrices (p
          // tile 2jp, j 0-7), (2jp, j 8-15), (2jp + 1, j 0-7), (2jp + 1,
          // j 8-15).
          uint32_t bq[4];
          ldsm_x4_trans(bq, xs + (ks + lr + (lm & 1) * 8) * G::kXP + wp0 +
                                16 * jp + (lm >> 1) * 8);
#pragma unroll
          for (int i = 0; i < G::kMI; ++i)
#pragma unroll
            for (int k = kParts - 1; k >= 0; --k) {   // the smallest first
              mma_bf16(acc[i][2 * jp], a[i][k], bq[0], bq[1]);
              mma_bf16(acc[i][2 * jp + 1], a[i][k], bq[2], bq[3]);
            }
        }
      }
    }
    __syncthreads();                     // tile kt is read
  }

  float* out = states + (static_cast<int64_t>(bh) * n_chunks + c) * n * p;
#pragma unroll
  for (int i = 0; i < G::kMI; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = wn0 + 16 * i + gq + 8 * hh;
      if (row >= n) continue;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = wp0 + 8 * jj + 2 * tq;
        if (col < p)
          *reinterpret_cast<float2*>(out + row * p + col) =
              make_float2(acc[i][jj][2 * hh], acc[i][jj][2 * hh + 1]);
      }
    }
}

// ------------------------------------------------ pass 2: the state pass
// grid = (ceil(N P / 4 / 128), B * H).  Thread e owns 4 consecutive floats
// of the (N, P) state of one (batch, head) and walks the chunks in order,
// replacing each chunk's local state S_c by the state entering it; the
// loads of 16 chunks are issued before the first of them is used.
__global__ void __launch_bounds__(kThreads)
    ssd_state_pass_kernel(float* __restrict__ states,
                          const float* __restrict__ lcum, int n_chunks,
                          int seq_pad, int heads, int quads, int chunk) {
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= quads) return;
  float4* s = reinterpret_cast<float4*>(states) +
              static_cast<int64_t>(bh) * n_chunks * quads + e;
  const float* lb = lcum + static_cast<int64_t>(b) * seq_pad * heads + h;
  float4 hv = make_float4(0.f, 0.f, 0.f, 0.f);
  constexpr int kAhead = 16;
  for (int c0 = 0; c0 < n_chunks; c0 += kAhead) {
    float4 v[kAhead];
    float a[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int c = c0 + u;
      if (c < n_chunks) {
        v[u] = s[static_cast<int64_t>(c) * quads];
        a[u] = expf(lb[(static_cast<int64_t>(c) * chunk + chunk - 1) * heads]);
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int c = c0 + u;
      if (c >= n_chunks) break;
      s[static_cast<int64_t>(c) * quads] = hv;
      hv.x = fmaf(a[u], hv.x, v[u].x);
      hv.y = fmaf(a[u], hv.y, v[u].y);
      hv.z = fmaf(a[u], hv.z, v[u].z);
      hv.w = fmaf(a[u], hv.w, v[u].w);
    }
  }
}

// ------------------------------------------------- pass 3: the chunk scan
// grid = (n_chunks, B * H, ceil(chunk / 128)), the heaviest query tiles
// (the last of a chunk) first; 8 warps a block, warp w owning query rows
// 16 w .. 16 w + 15 of the tile's 128.  C's tile and the state entering the
// chunk are staged first, and the inter term C h starts y, scaled by
// exp(l_i); then the key tiles of 64 at or below the diagonal stream
// through a two-stage ring whose second stage takes h's place, and for
// each one the warp computes its 16 x 64 scores C B^T in registers, masks
// and decays them there, and adds W x.  A warp skips the key groups that
// lie wholly past its rows.
constexpr int kQ = 128;                // query rows of a scan block
constexpr int kScanThreads = 256;      // 8 warps

template <typename T, int kN>
struct ScanGeom {
  static constexpr bool kF32 = std::is_same_v<T, float>;
  static constexpr int kE = static_cast<int>(sizeof(T));
  // float32: C and B rows read (row g, column t): pitch 4 mod 32 words; x
  // read at keys 2t, 2t + 1 and column g: 4 mod 32 too; h read (row t,
  // column g): 8 mod 32.  bfloat16: rows of 16 mod 128 bytes (ldmatrix).
  static constexpr int kCP = kF32 ? kN + 4 : kN + 8;   // C and B rows
  static constexpr int kXP = kF32 ? kP + 4 : kP + 8;   // x rows
  static constexpr int kHP = kP + 8;                   // h rows
  static constexpr int kCBytes = kQ * kCP * kE;
  static constexpr int kHBytes = kF32 ? kN * kHP * 4 : kParts * kN * kHP * 2;
  static constexpr int kBBytes = kT * kCP * kE;
  static constexpr int kStage = kBBytes + kT * kXP * kE;
  // The ring's second stage, which holds h until the key loop starts.
  static constexpr int kSlot1 = kStage > kHBytes ? kStage : kHBytes;
  static int bytes(int chunk) {
    return kCBytes + kStage + kSlot1 + 8 * ((chunk + kQ - 1) / kQ * kQ);
  }
};

template <typename O>
__device__ __forceinline__ void store_pair(O* out, float v0, float v1) {
  if constexpr (std::is_same_v<O, float>)
    *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
  else
    *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(v0, v1);
}

template <typename T, typename O, int kN>
__global__ void __launch_bounds__(kScanThreads, kN <= 64 ? 2 : 1)
    ssd_chunk_scan_kernel(const T* __restrict__ x,
                          const float* __restrict__ dt,
                          const float* __restrict__ lcum,
                          const T* __restrict__ bm, const T* __restrict__ cm,
                          const float* __restrict__ states,
                          O* __restrict__ y, int seq, int seq_pad, int heads,
                          int groups, int n, int p, int chunk, Layout xl,
                          Layout bl, Layout cl, int vec) {
  using G = ScanGeom<T, kN>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* cs = reinterpret_cast<T*>(smem);
  unsigned char* ring = smem + G::kCBytes;
  unsigned char* hsm = ring + G::kStage;           // the ring's stage 1
  float* ls = reinterpret_cast<float*>(hsm + G::kSlot1);
  float* dts = ls + (chunk + kQ - 1) / kQ * kQ;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int lr = lane & 7, lm = lane >> 3;
  const int c = blockIdx.x, bh = blockIdx.y, n_chunks = gridDim.x;
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int q0 = qt * kQ;
  const int c_start = c * chunk;
  const int valid = min(chunk, seq - c_start);
  if (q0 >= valid) return;                         // block-uniform
  const int key_end = min(q0 + kQ, valid);         // keys the tile sees
  const int b = bh / heads, h = bh % heads, g = h / (heads / groups);
  const T* xb = x + b * xl.batch + c_start * xl.token + static_cast<int64_t>(h) * p;
  const T* bb = bm + b * bl.batch + c_start * bl.token + static_cast<int64_t>(g) * n;
  const T* cb = cm + b * cl.batch + c_start * cl.token + static_cast<int64_t>(g) * n;
  const int64_t at = (static_cast<int64_t>(b) * seq_pad + c_start) * heads + h;
  const float* hg = states + (static_cast<int64_t>(bh) * n_chunks + c) * n * p;
  const int n_kt = (key_end + kT - 1) / kT;

  auto stage = [&](int kt) {
    unsigned char* st = ring + (kt & 1) * G::kStage;
    const int rows = min(kT, key_end - kt * kT);
    stage_rows<T, kT, kN, G::kCP, kScanThreads>(
        reinterpret_cast<T*>(st), bb + kt * kT * bl.token, bl.token, rows, n,
        vec, tid);
    stage_rows<T, kT, kP, G::kXP, kScanThreads>(
        reinterpret_cast<T*>(st + G::kBBytes), xb + kt * kT * xl.token,
        xl.token, rows, p, vec, tid);
    cp_async_commit();
  };

  stage_rows<T, kQ, kN, G::kCP, kScanThreads>(cs, cb + q0 * cl.token,
                                              cl.token, key_end - q0, n, vec,
                                              tid);
  stage(0);                              // one group: C and key tile 0
  // l and dt of the tile's rows and keys; past the chunk's (or sequence's)
  // end, l repeats its last value and dt is zero, so every decay of a key
  // at or before a row, valid or not, is exp of a difference <= 0.
  for (int j = tid; j < q0 + kQ; j += kScanThreads) {
    ls[j] = lcum[at + min(j, key_end - 1) * heads];
    dts[j] = j < key_end ? dt[at + j * heads] : 0.f;
  }
  // The state entering the chunk, rows past N and columns past P zero.
  for (int e = tid; e < kN * kP / 4; e += kScanThreads) {
    const int r = e / (kP / 4), col = (e % (kP / 4)) * 4;
    const float4 v = r < n && col < p
                         ? *reinterpret_cast<const float4*>(hg + r * p + col)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (G::kF32) {
      *reinterpret_cast<float4*>(reinterpret_cast<float*>(hsm) + r * G::kHP +
                                 col) = v;
    } else {
      __nv_bfloat16* parts = reinterpret_cast<__nv_bfloat16*>(hsm);
      uint32_t p01[kParts], p23[kParts];
      split_parts(v.x, v.y, p01);
      split_parts(v.z, v.w, p23);
#pragma unroll
      for (int k = 0; k < kParts; ++k)
        *reinterpret_cast<uint2*>(parts + (k * kN + r) * G::kHP + col) =
            make_uint2(p01[k], p23[k]);
    }
  }

  const int row0 = 16 * warp;                      // the warp's rows in C
  const int i0 = q0 + row0 + gq, i1 = i0 + 8;      // chunk positions
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  cp_async_wait<0>();
  __syncthreads();                       // C, key tile 0, h and l in place
  const float li0 = ls[i0], li1 = ls[i1];
  // Inter term: y = exp(l_i) (C_i . h).
  if constexpr (G::kF32) {
    const float* hf = reinterpret_cast<const float*>(hsm);
#pragma unroll
    for (int ks = 0; ks < kN; ks += 8) {
      uint32_t ah[4], al[4];
      const float* a = cs + (row0 + gq) * G::kCP + ks + tq;
      split_tf32(a[0], ah[0], al[0]);
      split_tf32(a[8 * G::kCP], ah[1], al[1]);
      split_tf32(a[4], ah[2], al[2]);
      split_tf32(a[8 * G::kCP + 4], ah[3], al[3]);
#pragma unroll
      for (int jp = 0; jp < 8; ++jp) {
        const float* q = hf + (ks + tq) * G::kHP + 8 * jp + gq;
        mma_3xtf32(acc[jp], ah, al, q[0], q[4 * G::kHP]);
      }
    }
  } else {
    const __nv_bfloat16* parts = reinterpret_cast<const __nv_bfloat16*>(hsm);
#pragma unroll
    for (int ks = 0; ks < kN; ks += 16) {
      uint32_t a[4];
      ldsm_x4(a, cs + (row0 + lr + (lm & 1) * 8) * G::kCP + ks +
                     (lm >> 1) * 8);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        const int off =
            (ks + lr + (lm & 1) * 8) * G::kHP + 16 * jp + (lm >> 1) * 8;
#pragma unroll
        for (int k = kParts - 1; k >= 0; --k) {       // the smallest first
          uint32_t bq[4];
          ldsm_x4_trans(bq, parts + k * kN * G::kHP + off);
          mma_bf16(acc[2 * jp], a, bq[0], bq[1]);
          mma_bf16(acc[2 * jp + 1], a, bq[2], bq[3]);
        }
      }
    }
  }
  {
    const float e0 = i0 < key_end ? expf(li0) : 0.f;
    const float e1 = i1 < key_end ? expf(li1) : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[j][0] *= e0, acc[j][1] *= e0;
      acc[j][2] *= e1, acc[j][3] *= e1;
    }
  }
  __syncthreads();                       // h is read: stage 1 takes its place

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) {
      stage(kt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                     // tile kt in place
    const unsigned char* st = ring + (kt & 1) * G::kStage;
    const T* bs = reinterpret_cast<const T*>(st);
    const T* xs = reinterpret_cast<const T*>(st + G::kBBytes);

    // Intra term over this key tile.  kmax: the last key of the tile that
    // a row of this warp sees (below 0: the warp's rows all precede it, and
    // it skips every key group).
    const int k0 = kt * kT;
    const int kmax = q0 + row0 + 15 - k0;
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    if constexpr (G::kF32) {
#pragma unroll
      for (int ks = 0; ks < kN; ks += 8) {
        uint32_t ah[4], al[4];
        const float* a = cs + (row0 + gq) * G::kCP + ks + tq;
        split_tf32(a[0], ah[0], al[0]);
        split_tf32(a[8 * G::kCP], ah[1], al[1]);
        split_tf32(a[4], ah[2], al[2]);
        split_tf32(a[8 * G::kCP + 4], ah[3], al[3]);
#pragma unroll
        for (int jn = 0; jn < 8; ++jn) {
          if (8 * jn > kmax) continue;
          // b0, b1 = B[key g][n t], B[key g][n t + 4].
          const float* q = bs + (8 * jn + gq) * G::kCP + ks + tq;
          mma_3xtf32(sc[jn], ah, al, q[0], q[4]);
        }
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < kN; ks += 16) {
        uint32_t a[4];
        ldsm_x4(a, cs + (row0 + lr + (lm & 1) * 8) * G::kCP + ks +
                       (lm >> 1) * 8);
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          if (16 * jp > kmax) continue;
          // B = B-matrix rows (keys), contraction n: matrices (keys 16jp
          // .., n 0-7), (16jp .., n 8-15), (16jp + 8 .., n 0-7), (16jp + 8
          // .., n 8-15).
          uint32_t bq[4];
          ldsm_x4(bq, bs + (16 * jp + lr + (lm >> 1) * 8) * G::kCP + ks +
                          (lm & 1) * 8);
          mma_bf16(sc[2 * jp], a, bq[0], bq[1]);
          mma_bf16(sc[2 * jp + 1], a, bq[2], bq[3]);
        }
      }
    }
    // Decay, exp(l_i - l_j) dt_j per element (exp2 of the difference
    // times log2 e), and on a tile that reaches past the warp's first row
    // the mask key j <= row i.  A lane's keys are 2t, 2t + 1 of each group
    // of 8: one 8-byte load of l and of dt a group.  Rows past the chunk's
    // end are never stored.
    const bool diag = k0 + kT - 1 > q0 + row0;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      if (8 * jn > kmax) continue;
      const int j = k0 + 8 * jn + 2 * tq;
      const float2 lj = *reinterpret_cast<const float2*>(ls + j);
      const float2 dj = *reinterpret_cast<const float2*>(dts + j);
      float w[4] = {sc[jn][0] * exp2f((li0 - lj.x) * kLog2e) * dj.x,
                    sc[jn][1] * exp2f((li0 - lj.y) * kLog2e) * dj.y,
                    sc[jn][2] * exp2f((li1 - lj.x) * kLog2e) * dj.x,
                    sc[jn][3] * exp2f((li1 - lj.y) * kLog2e) * dj.y};
      if (diag) {
        w[0] = j <= i0 ? w[0] : 0.f;
        w[1] = j + 1 <= i0 ? w[1] : 0.f;
        w[2] = j <= i1 ? w[2] : 0.f;
        w[3] = j + 1 <= i1 ? w[3] : 0.f;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[jn][e] = w[e];
    }
    if constexpr (G::kF32) {
      // A = W with the keys of group kk in the order 2t, 2t + 1: a0..a3 =
      // (row g, key 2t), (g + 8, 2t), (g, 2t + 1), (g + 8, 2t + 1).
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if (8 * kk > kmax) continue;
        uint32_t ah[4], al[4];
        split_tf32(sc[kk][0], ah[0], al[0]);
        split_tf32(sc[kk][2], ah[1], al[1]);
        split_tf32(sc[kk][1], ah[2], al[2]);
        split_tf32(sc[kk][3], ah[3], al[3]);
#pragma unroll
        for (int jp = 0; jp < 8; ++jp) {
          const T* q = xs + (8 * kk + 2 * tq) * G::kXP + 8 * jp + gq;
          mma_3xtf32(acc[jp], ah, al, q[0], q[G::kXP]);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (16 * kk > kmax) continue;
        // A = W of keys 16kk .. 16kk + 15, from the accumulators of key
        // groups 2kk and 2kk + 1, in kParts parts.
        uint32_t a[kParts][4];
        {
          uint32_t pw[4][kParts];
          split_parts(sc[2 * kk][0], sc[2 * kk][1], pw[0]);
          split_parts(sc[2 * kk][2], sc[2 * kk][3], pw[1]);
          split_parts(sc[2 * kk + 1][0], sc[2 * kk + 1][1], pw[2]);
          split_parts(sc[2 * kk + 1][2], sc[2 * kk + 1][3], pw[3]);
#pragma unroll
          for (int k = 0; k < kParts; ++k)
#pragma unroll
            for (int e = 0; e < 4; ++e) a[k][e] = pw[e][k];
        }
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          uint32_t bq[4];
          ldsm_x4_trans(bq, xs + (16 * kk + lr + (lm & 1) * 8) * G::kXP +
                                16 * jp + (lm >> 1) * 8);
#pragma unroll
          for (int k = kParts - 1; k >= 0; --k) {     // the smallest first
            mma_bf16(acc[2 * jp], a[k], bq[0], bq[1]);
            mma_bf16(acc[2 * jp + 1], a[k], bq[2], bq[3]);
          }
        }
      }
    }
    __syncthreads();                     // tile kt is read
  }

  const int64_t y_row = static_cast<int64_t>(heads) * p;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = hh == 0 ? i0 : i1;
    if (i >= key_end) continue;
    O* yr = y + (static_cast<int64_t>(b) * seq + c_start + i) * y_row +
            static_cast<int64_t>(h) * p;
#pragma unroll
    for (int jp = 0; jp < 8; ++jp) {
      const int col = 8 * jp + 2 * tq;
      if (col < p)
        store_pair(yr + col, acc[jp][2 * hh], acc[jp][2 * hh + 1]);
    }
  }
}

// ----------------------------------------------------------------- launch
struct Shape {
  int batch, seq, seq_pad, heads, groups, n, p, chunk;
  int n_chunks() const { return seq_pad / chunk; }
};

// The dynamic shared-memory ceiling is raised once per instantiation, to
// what the longest chunk takes; each launch asks for what its chunk needs.
template <typename K>
cudaError_t raise_smem(K kernel, int bytes, bool& configured) {
  if (configured) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) configured = true;
  return err;
}

template <typename T, int kN>
cudaError_t launch_state(const void* x, const void* dt, const void* l,
                         const void* bm, float* states, const Shape& s,
                         Layout xl, Layout bl, int vec, cudaStream_t stream) {
  using G = StateGeom<T, kN>;
  static bool configured = false;
  const cudaError_t err = raise_smem(ssd_chunk_state_kernel<T, kN>,
                                     G::bytes(kMaxChunk), configured);
  if (err != cudaSuccess) return err;
  const dim3 grid(s.n_chunks(), s.batch * s.heads);
  ssd_chunk_state_kernel<T, kN><<<grid, kThreads, G::bytes(s.chunk), stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(l), static_cast<const T*>(bm), states, s.seq,
      s.seq_pad, s.heads, s.groups, s.n, s.p, s.chunk, xl, bl, vec);
  return cudaGetLastError();
}

template <typename T, typename O, int kN>
cudaError_t launch_scan(const void* x, const void* dt, const void* l,
                        const void* bm, const void* cm, const float* states,
                        void* y, const Shape& s, Layout xl, Layout bl,
                        Layout cl, int vec, cudaStream_t stream) {
  using G = ScanGeom<T, kN>;
  static bool configured = false;
  const cudaError_t err = raise_smem(ssd_chunk_scan_kernel<T, O, kN>,
                                     G::bytes(kMaxChunk), configured);
  if (err != cudaSuccess) return err;
  const dim3 grid(s.n_chunks(), s.batch * s.heads, (s.chunk + kQ - 1) / kQ);
  ssd_chunk_scan_kernel<T, O, kN><<<grid, kScanThreads, G::bytes(s.chunk),
                                    stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(l), static_cast<const T*>(bm),
      static_cast<const T*>(cm), states, static_cast<O*>(y), s.seq,
      s.seq_pad, s.heads, s.groups, s.n, s.p, s.chunk, xl, bl, cl, vec);
  return cudaGetLastError();
}

bool shape_ok(const Shape& s) {
  return s.n >= 1 && s.n <= kMaxN && s.p >= 2 && s.p <= kP && s.p % 4 == 0 &&
         s.chunk >= 1 && s.chunk <= kMaxChunk && s.groups >= 1 &&
         s.heads % s.groups == 0 && s.seq >= 1 && s.seq_pad % s.chunk == 0 &&
         s.seq <= s.seq_pad;
}

}  // namespace

extern "C" {

// in_dtype, out_dtype: 0 float32, 1 bfloat16 (x, B and C; y), out float32
// or in_dtype.  Strides are in elements.  vec: x, B and C, their batch and
// token strides and the rows of N and P elements are 16-byte aligned.
// states: the float32 workspace (batch, heads, seq_pad / chunk, n, p).
// Each returns cudaGetLastError() after its launch (0 on success), or
// cudaErrorInvalidValue for a shape or dtype without an instantiation.
int mrsch_ssd_chunk_state(const void* x, const void* dt, const void* l,
                          const void* bm, void* states, int batch, int seq,
                          int seq_pad, int heads, int groups, int n, int p,
                          int chunk, long long x_batch, long long x_token,
                          long long b_batch, long long b_token, int in_dtype,
                          int vec, void* stream) {
  const Shape s{batch, seq, seq_pad, heads, groups, n, p, chunk};
  if (!shape_ok(s)) return static_cast<int>(cudaErrorInvalidValue);
  const Layout xl{x_batch, x_token}, bl{b_batch, b_token};
  auto st = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(states);
  const bool wide = n > 64;
  if (in_dtype == 0)
    return static_cast<int>(
        wide ? launch_state<float, 128>(x, dt, l, bm, ws, s, xl, bl, vec, st)
             : launch_state<float, 64>(x, dt, l, bm, ws, s, xl, bl, vec, st));
  if (in_dtype == 1)
    return static_cast<int>(
        wide ? launch_state<__nv_bfloat16, 128>(x, dt, l, bm, ws, s, xl, bl,
                                                vec, st)
             : launch_state<__nv_bfloat16, 64>(x, dt, l, bm, ws, s, xl, bl,
                                               vec, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

int mrsch_ssd_state_pass(void* states, const void* l, int batch, int seq_pad,
                         int heads, int n, int p, int chunk, void* stream) {
  if (n < 1 || p < 1 || (n * p) % 4 != 0 || chunk < 1 || seq_pad % chunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const int quads = n * p / 4;
  const dim3 grid((quads + kThreads - 1) / kThreads, batch * heads);
  ssd_state_pass_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(states), static_cast<const float*>(l),
      seq_pad / chunk, seq_pad, heads, quads, chunk);
  return static_cast<int>(cudaGetLastError());
}

int mrsch_ssd_chunk_scan(const void* x, const void* dt, const void* l,
                         const void* bm, const void* cm, const void* states,
                         void* y, int batch, int seq, int seq_pad, int heads,
                         int groups, int n, int p, int chunk,
                         long long x_batch, long long x_token,
                         long long b_batch, long long b_token,
                         long long c_batch, long long c_token, int in_dtype,
                         int out_dtype, int vec, void* stream) {
  const Shape s{batch, seq, seq_pad, heads, groups, n, p, chunk};
  if (!shape_ok(s)) return static_cast<int>(cudaErrorInvalidValue);
  const Layout xl{x_batch, x_token}, bl{b_batch, b_token},
      cl{c_batch, c_token};
  auto st = static_cast<cudaStream_t>(stream);
  const float* ws = static_cast<const float*>(states);
  const bool wide = n > 64;
  cudaError_t err = cudaErrorInvalidValue;
  if (in_dtype == 0 && out_dtype == 0)
    err = wide ? launch_scan<float, float, 128>(x, dt, l, bm, cm, ws, y, s,
                                                xl, bl, cl, vec, st)
               : launch_scan<float, float, 64>(x, dt, l, bm, cm, ws, y, s,
                                               xl, bl, cl, vec, st);
  else if (in_dtype == 1 && out_dtype == 1)
    err = wide ? launch_scan<__nv_bfloat16, __nv_bfloat16, 128>(
                     x, dt, l, bm, cm, ws, y, s, xl, bl, cl, vec, st)
               : launch_scan<__nv_bfloat16, __nv_bfloat16, 64>(
                     x, dt, l, bm, cm, ws, y, s, xl, bl, cl, vec, st);
  else if (in_dtype == 1 && out_dtype == 0)
    err = wide ? launch_scan<__nv_bfloat16, float, 128>(
                     x, dt, l, bm, cm, ws, y, s, xl, bl, cl, vec, st)
               : launch_scan<__nv_bfloat16, float, 64>(
                     x, dt, l, bm, cm, ws, y, s, xl, bl, cl, vec, st);
  return static_cast<int>(err);
}

const char* mrsch_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
