// Masked non-causal attention forward for Hopper (sm_90a): B5, `mha_fwd`.
//
// Replaces the TPU kernel `mha_fwd_kernel` (`_mha_fwd_kernel`) in
// src/repro/kernels/flash_attention/kernel.py:125.  Inputs q (BH, Sq, dh),
// k and v (BH, Sk, dh) and lengths (BH,), float32, contiguous and 16-byte
// aligned.  Keys at positions >= the row's length are masked (the position
// compared in float32, as the reference compares it); queries are not.
// Outputs o (BH, Sq, dh) and lse (BH, Sq):
//
//   o   = sum_j p_j v_j / max(l, 1e-30),   p_j = exp(s_j - m) on valid keys,
//   lse = m + log(max(l, 1e-30)),          s_j = (q . k_j) * dh^-0.5,
//
// with m the row's largest score and l = sum_j p_j.  A batch-head with no
// valid key writes o = 0 and lse = -1e30 (finite), which the backward
// kernels rely on.
//
// What bounds it.  On the device engine's and the trainer's main path
// (BH = 4 heads x 64 rows = 256, S = 1 + Q = 129, dh = 16, lengths 1 + the
// queue length, about 36 of 129 keys on average) one call moves q, o and
// lse (4.4 MB) and the kept keys and values: 1.6 us of bytes at 3.35 TB/s,
// and less of arithmetic.  Neither bounds it in practice.  A block does
// little work, so it waits on device-memory round trips (the length, then
// the keys), and at 256 blocks on how many warps an SM holds at once and
// the instructions each issues per 16 keys (about 4 us of a call over its
// length-1 time, at lengths up to 72).  The design:
//
//  * one block per (batch-head, tile of query rows), each warp owning 16
//    rows; kernel.mha_plan holds all rows of a batch-head in one block up
//    to 144 (the main path's 129 rows are 9 warps), and splits them over
//    more blocks only where the batch-heads alone would leave most SMs
//    idle (the service's BH = 4: three blocks of 3 warps).  Two blocks of
//    9 warps share an SM (at most 96 registers a thread, kMinBlocks);
//  * the length and the warp's q rows are read first (16 bytes a lane, one
//    round trip for both); then the block stages the batch-head's kept keys
//    and values, ceil(length) rows of each (contiguous in device memory),
//    with cp.async 16-byte copies issued all at once, zero-filled to the
//    16-key chunk; where they exceed the plan's stage (long Sk) the stages
//    form a two-stage ring, the next tile loading while this one is used;
//  * once staged, k and v are split into their TF32 parts in place (a hi
//    and a lo plane), once per block rather than in every warp's products;
//  * both products on the tensor cores in 3xTF32 (mma.sync m16n8k8; each
//    float32 operand as hi + lo, three TF32 products summed in float32),
//    which holds float32 accuracy: S = q k^T over 16-key chunks (two 8-key
//    groups) and P stay in registers in the FlashAttention-2 layout, with
//    an online softmax in the exp2 domain whose row maxima meet by quad
//    shuffles; only the last chunk is masked; P V goes to a fresh
//    accumulator per chunk, added in float32 (mha_common.cuh);
//  * o is written 16 bytes a lane (lane pairs swap halves by a shuffle),
//    lse once per row.  Any Sq and Sk, ragged, with no padding.
//
// Plain C interface for ctypes; the wrapper (kernel.py) takes the plan
// from kernel.mha_plan, allocates the outputs and raises on a non-zero
// return.

#include "mha_common.cuh"

namespace {

using namespace mha;

// One 16-key chunk (two 8-key groups: more would take registers that two
// blocks of the main path need to share an SM) from key c0 of the staged
// tile: scores on the tensor cores, the online softmax update, then P V.
// `left` counts the tile's keys from c0 that are below the length; with
// kMask the chunk's keys past it (zero-filled rows) are masked.
template <int DH, bool kMask>
__device__ __forceinline__ void fwd_chunk(const RowsA<DH>& qa, const float* ks,
                                          int k_lo, const float* vs, int v_lo,
                                          int c0, int left, float sl, int g,
                                          int t, float (&m)[2], float (&l)[2],
                                          float (&acc)[Geom<DH>::kDT][4]) {
  constexpr int G = 2;
  using Gm = Geom<DH>;
  float s[G][4];
#pragma unroll
  for (int j = 0; j < G; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    mma_over_dh<DH>(s[j], qa, ks + (c0 + 8 * j + g) * Gm::kPR + Gm::kVec * t,
                    k_lo);
  }
  // Scores to the exp2 domain (keys past the length to -1e30), the row
  // maxima over the quad.
  float mt[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < G; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e] * sl;
      if (kMask && 8 * j + 2 * t + (e & 1) >= left) x = kNegInf;
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
  // P V into a fresh accumulator, then acc = acc alpha + P V.
  float pv[Gm::kDT][4];
#pragma unroll
  for (int n = 0; n < Gm::kDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
#pragma unroll
  for (int j = 0; j < G; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(s[j][e] - m[e >> 1]);
      l[e >> 1] += p;
      s[j][e] = p;
    }
    mma_over_rows<DH>(pv, s[j], vs + (c0 + 8 * j + 2 * t) * Gm::kPC + g,
                      v_lo);
  }
#pragma unroll
  for (int n = 0; n < Gm::kDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[n][e] = fmaf(acc[n][e], alpha[e >> 1], pv[n][e]);
}

template <int DH>
__global__ void __launch_bounds__(Geom<DH>::kThreads, Geom<DH>::kMinBlocks)
mha_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v,
               const float* __restrict__ lengths, float* __restrict__ o,
               float* __restrict__ lse, int sq, int sk, int rows,
               int key_tile, float scale) {
  using G = Geom<DH>;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t bh = blockIdx.x;
  const int q0 = blockIdx.y * rows;
  // The length, then the lane's two q rows: one round trip for both.
  const float len = lengths[bh];
  const int ra = q0 + 16 * warp + g, rb = ra + 8;
  RowsA<DH> qa;
  qa.load(q + (bh * sq + ra) * DH + G::kVec * t, ra < sq,
          q + (bh * sq + rb) * DH + G::kVec * t, rb < sq);
  const int nk = valid_keys(len, sk);
  const float* kb = k + bh * sk * DH;
  const float* vb = v + bh * sk * DH;
  float* ob = o + bh * sq * DH;
  float* lseb = lse + bh * sq;

  if (nk == 0) {            // uniform per block: o = 0, lse = -1e30
    const int q1 = min(sq, q0 + rows);
    zero_rows<DH>(ob, q0, q1, tid, nthreads);
    for (int r = q0 + tid; r < q1; r += nthreads)
      lseb[r] = kNegInf + logf(1e-30f);
    return;
  }

  // A stage: k's hi and lo planes (pitch kPR), then v's (pitch kPC).
  const int k_lo = key_tile * G::kPR, v_lo = key_tile * G::kPC;
  const int stage_floats = 2 * (k_lo + v_lo);
  const int n_tiles = (nk + key_tile - 1) / key_tile;
  auto tile_keys = [&](int it) { return min(key_tile, nk - it * key_tile); };
  auto stage_kv = [&](int it) {
    float* ks = smem + (it & 1) * stage_floats;
    const int k0 = it * key_tile, n = tile_keys(it);
    const int n16 = (n + 15) & ~15;
    stage_rows<DH>(ks, G::kPR, kb + k0 * DH, n16, n, tid, nthreads);
    stage_rows<DH>(ks + 2 * k_lo, G::kPC, vb + k0 * DH, n16, n, tid,
                   nthreads);
  };
  stage_kv(0);
  cp_async_commit();

  const float sl = scale * kLog2e;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[G::kDT][4];
#pragma unroll
  for (int n = 0; n < G::kDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    float* ks = smem + (it & 1) * stage_floats;
    float* vs = ks + 2 * k_lo;
    const int n = tile_keys(it);
    const int n16 = (n + 15) & ~15;
    cp_async_wait_all();
    __syncthreads();        // tile `it` is in; tile it - 1's stage is free
    split_rows<DH>(ks, G::kPR, k_lo, n16, tid, nthreads);
    split_rows<DH>(vs, G::kPC, v_lo, n16, tid, nthreads);
    __syncthreads();
    if (it + 1 < n_tiles) stage_kv(it + 1);
    cp_async_commit();

    // 16-key chunks; only the last is masked, and at most 15 keys past the
    // length are computed.
    int c0 = 0;
    for (; n - c0 >= 16; c0 += 16)
      fwd_chunk<DH, false>(qa, ks, k_lo, vs, v_lo, c0, n - c0, sl, g, t, m, l,
                           acc);
    if (c0 < n)
      fwd_chunk<DH, true>(qa, ks, k_lo, vs, v_lo, c0, n - c0, sl, g, t, m, l,
                          acc);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
    inv[r] = 1.f / l[r];
  }
  store_row<DH>(acc, 0, inv[0], ob + static_cast<int64_t>(ra) * DH, ra < sq,
                t);
  store_row<DH>(acc, 1, inv[1], ob + static_cast<int64_t>(rb) * DH, rb < sq,
                t);
  if (t == 0) {
    if (ra < sq) lseb[ra] = m[0] * kLn2 + logf(l[0]);
    if (rb < sq) lseb[rb] = m[1] * kLn2 + logf(l[1]);
  }
}

template <int DH>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* lengths, float* o, float* lse, int bh,
                   int sq, int sk, int rows, int tiles, int key_tile,
                   int smem, float scale, cudaStream_t stream) {
  static int allowed = 48 * 1024;
  const cudaError_t err = allow_smem(mha_fwd_kernel<DH>, smem, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, tiles);
  mha_fwd_kernel<DH><<<grid, 2 * rows, smem, stream>>>(
      q, k, v, lengths, o, lse, sq, sk, rows, key_tile, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The plan (rows a block, tiles a batch-head, keys a stage, shared bytes)
// is kernel.mha_plan's; `scale` is dh^-0.5 as the wrapper rounds it to
// float32.  Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a head dim without an instantiation or a plan
// this kernel cannot run.
int mrsch_mha_fwd(const void* q, const void* k, const void* v,
                  const void* lengths, void* o, void* lse, int bh, int sq,
                  int sk, int dh, int rows, int tiles, int key_tile,
                  int smem, float scale, void* stream) {
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* lf = static_cast<const float*>(lengths);
  auto* of = static_cast<float*>(o);
  auto* lsef = static_cast<float*>(lse);
  auto s = static_cast<cudaStream_t>(stream);
#define MRSCH_MHA_CASE(DH)                                                  \
  if (dh == DH) {                                                           \
    if (!mha::plan_fits<DH>(rows, key_tile))                                \
      return static_cast<int>(cudaErrorInvalidValue);                       \
    return static_cast<int>(launch<DH>(qf, kf, vf, lf, of, lsef, bh, sq,    \
                                       sk, rows, tiles, key_tile, smem,     \
                                       scale, s));                          \
  }
  MRSCH_MHA_CASE(8)
  MRSCH_MHA_CASE(16)
  MRSCH_MHA_CASE(32)
  MRSCH_MHA_CASE(64)
#undef MRSCH_MHA_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* mrsch_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
