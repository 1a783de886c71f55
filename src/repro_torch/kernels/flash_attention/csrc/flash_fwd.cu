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
// an online softmax over tiles of 64 keys, all in float32.  Masked scores
// are -1e30, as in the reference.
//
// What bounds it: the FMA rate.  At the LM prefill's shapes (zamba2-7b,
// B = 2, S = 4096, 32 heads of 112) one causal call does about 2 x 2 x
// 64 x 4096^2 / 2 x 112 = 240 GFLOP and moves 0.47 GB: 3.6 ms at 67
// TFLOP/s float32 against 0.14 ms of bytes.  The TPU design (128 x 128 MXU
// tiles, padded sequences, m / l / acc carried in VMEM across a sequential
// key grid) does not carry over.  It runs on the CUDA cores, so float32
// inputs keep full float32 products (no TF32: the LM's float32 parity
// rests on them):
//
//  * one block of 256 threads per (b, h, tile of 64 query rows); the
//    heaviest causal tiles (the last query rows) are launched first;
//  * the block keeps its q tile in shared memory, transposed, and walks
//    the key tiles; in causal mode it stops at the tile holding the
//    diagonal (the tiles past it would add exactly 0); the ragged edges
//    (Sq, Sk not multiples of 64) are masked in place, with no padding;
//  * each thread owns a 4 x 4 block of the 64 x 64 score tile and the same
//    4 rows of the output, dh / 16 columns each; a row's max is reduced
//    over the 16 lanes that share it with shuffles, its sum l at the end;
//  * shared memory: q and k transposed (dh x 68 floats each), v (64 x dh)
//    and p (64 x 68): 222 KB at dh = 256, 107 KB at dh = 112.
//
// Plain C interface for ctypes; the wrapper (kernel.py) allocates the
// output and raises on a non-zero return.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 64;            // keys per tile
constexpr int kPad = 4;            // row padding of the transposed tiles
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

template <int DH>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(float)) *
         (DH * (kBQ + kPad) + DH * (kBK + kPad) + kBK * DH +
          kBQ * (kBK + kPad));
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int sq,
                 int sk, int heads, int kv_heads, int causal, float scale) {
  static_assert(DH % 16 == 0, "dh must be a multiple of 16");
  constexpr int kCols = DH / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* qt = smem;                              // [DH][kBQ + kPad]
  float* kt = qt + DH * (kBQ + kPad);            // [DH][kBK + kPad]
  float* vs = kt + DH * (kBK + kPad);            // [kBK][DH]
  float* ps = vs + kBK * DH;                     // [kBQ][kBK + kPad]

  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  const int r0 = tr * 4, c0 = tc * 4;
  const int n_qt = gridDim.x;
  const int qtile = n_qt - 1 - blockIdx.x;       // heaviest tiles first
  const int q_start = qtile * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int kvh = h / (heads / kv_heads);
  const int64_t q_row = static_cast<int64_t>(heads) * DH;     // q, o
  const int64_t k_row = static_cast<int64_t>(kv_heads) * DH;  // k, v
  const float* qb = q + static_cast<int64_t>(b) * sq * q_row + h * DH;
  const float* kb = k + static_cast<int64_t>(b) * sk * k_row + kvh * DH;
  const float* vb = v + static_cast<int64_t>(b) * sk * k_row + kvh * DH;

  for (int e = tid; e < kBQ * DH; e += kThreads) {
    const int r = e / DH, d = e % DH;
    const int qi = q_start + r;
    qt[d * (kBQ + kPad) + r] = qi < sq ? qb[qi * q_row + d] : 0.f;
  }

  // Keys this tile of queries can see: all of them, or up to its last row.
  const int k_end = causal ? min(sk, q_start + kBQ) : sk;
  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();                 // the previous tile is read by all
    for (int e = tid; e < kBK * DH; e += kThreads) {
      const int c = e / DH, d = e % DH;
      const int kj = k0 + c;
      const bool in = kj < sk;
      kt[d * (kBK + kPad) + c] = in ? kb[kj * k_row + d] : 0.f;
      vs[c * DH + d] = in ? vb[kj * k_row + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float4 qa =
          *reinterpret_cast<const float4*>(qt + d * (kBQ + kPad) + r0);
      const float4 ka =
          *reinterpret_cast<const float4*>(kt + d * (kBK + kPad) + c0);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
    const bool edge = k0 + kBK > sk || (causal && k0 + kBK - 1 > q_start);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] *= scale;
        if (edge) {
          const int kj = k0 + c0 + j, qi = q_start + r0 + i;
          if (kj >= sk || (causal && qi < kj)) s[i][j] = kNegInf;
        }
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
      float pr[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pr[j] = expf(s[i][j] - m_new);
        l[i] += pr[j];
      }
      *reinterpret_cast<float4*>(ps + (r0 + i) * (kBK + kPad) + c0) =
          make_float4(pr[0], pr[1], pr[2], pr[3]);
    }
    __syncthreads();

    // acc += p . v over the keys of this tile that any row can see.
    const int kn = min(kBK, k_end - k0);
    for (int c = 0; c < kn; c += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(ps + (r0 + i) * (kBK + kPad)
                                                 + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vr = vs + (c + cc) * DH + tc;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const float vv = vr[16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = cc == 0 ? pa[i].x : cc == 1 ? pa[i].y
                          : cc == 2 ? pa[i].z : pa[i].w;
            acc[i][j] = fmaf(p, vv, acc[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      li += __shfl_xor_sync(0xffffffffu, li, off);
    const int qi = q_start + r0 + i;
    if (qi < sq) {
      const float inv = 1.f / fmaxf(li, 1e-30f);
      float* orow = o + static_cast<int64_t>(b) * sq * q_row + qi * q_row +
                h * DH + tc;
#pragma unroll
      for (int j = 0; j < kCols; ++j) orow[16 * j] = acc[i][j] * inv;
    }
  }
}

template <int DH>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   int b, int sq, int sk, int heads, int kv_heads,
                   int causal, float scale, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<DH>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((sq + kBQ - 1) / kBQ, b * heads);
  flash_fwd_kernel<DH><<<grid, kThreads, bytes, stream>>>(
      q, k, v, o, sq, sk, heads, kv_heads, causal, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// float32 q, k, v, o.  `scale` is dh^-0.5 as the wrapper rounds it to
// float32.  Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a head dim without an instantiation.
int mrsch_flash_fwd(const void* q, const void* k, const void* v, void* o,
                    int b, int sq, int sk, int heads, int kv_heads, int dh,
                    int causal, float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto qf = static_cast<const float*>(q);
  auto kf = static_cast<const float*>(k);
  auto vf = static_cast<const float*>(v);
  auto of = static_cast<float*>(o);
#define MRSCH_FLASH_CASE(DH)                                                \
  if (dh == DH)                                                             \
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
