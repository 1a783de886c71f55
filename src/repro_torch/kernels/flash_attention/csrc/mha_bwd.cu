// Masked non-causal attention backward for Hopper (sm_90a): B6,
// `mha_bwd_dq` and `mha_bwd_dkv`.
//
// Replaces the TPU kernels of `mha_bwd_kernels` (`_mha_bwd_dq_kernel` and
// `_mha_bwd_dkv_kernel`) in src/repro/kernels/flash_attention/kernel.py:216.
// Inputs q and do (BH, Sq, dh), k and v (BH, Sk, dh), lse and delta
// (BH, Sq) and lengths (BH,), float32 and contiguous, the four (.., dh)
// operands 16-byte aligned; lse comes from the forward (mha.cu) and delta
// = rowsum(do * o) from the wrapper.  Both kernels recompute the
// probabilities flash-style on the valid keys (position < length,
// compared in float32), never storing them:
//
//   p = exp(q . k * scale - lse),   ds = p * (do . v - delta) * scale,
//   dq = sum_keys ds k,   dk = sum_queries ds q,   dv = sum_queries p do.
//
// Masked keys contribute nothing and get dk = dv = 0; a batch-head with no
// valid key gets dq = 0, all exactly, with no exp(+1e30) ever computed.
//
// What bounds them.  On the trainer's main path (BH = 256, S = 129, dh =
// 16, about 36 kept keys a row) each call moves 2.1 MB per (BH, S, dh)
// operand: dq reads q, do, lse, delta and the kept k, v and writes dq;
// dkv reads the same and writes dk, dv; about 2 us of bytes.  As in the
// forward, what a call waits on is the round trips of a block and, at
// 256 blocks, the warps an SM holds and what each issues.  The design,
// the forward's (mha.cu, mha_common.cuh):
//
//  * dq: one block per (batch-head, tile of query rows), the forward's
//    plan (kernel.mha_plan); a warp owns 16 query rows and holds q and do
//    as A fragments (16-byte reads), lse and delta per row.  The kept k
//    and v rows are staged once with cp.async (a two-stage ring for long
//    Sk), zero-filled to the 16-key chunk, and split into TF32 planes once
//    per block.  Per 8-key group (one at a time: fewer registers, two
//    blocks an SM, measured faster than two), S = q k^T and dP = do v^T on
//    mma.sync in 3xTF32, p = exp2(S scale log2 e - lse log2 e) and dS =
//    p (dP - delta) scale in registers, and dQ += dS k on mma.sync, dS (an
//    accumulator) serving as the A operand as it is;
//  * dkv: one block per (batch-head, tile of key rows), up to 144 keys.
//    The warps that own kept keys, ceil(kept / 16) of them, share the
//    block's warps out among themselves: each takes every s-th 16-query
//    block of all Sq rows, s = warps / ceil(kept / 16), and split 0 adds
//    the others' partial dK and dV in split order through shared memory.
//    Key rows past the length are zeroed with 16-byte stores, and no
//    arithmetic touches them.  The block stages its kept k and v rows and
//    q, do, lse and delta of all Sq rows once (a ring for long Sq),
//    zero-filled past Sq, so padded query rows add nothing (their do and
//    q are 0), and splits k, v, q and do into TF32 planes.  A warp reads
//    its k and v fragments from shared memory at each use (held in
//    registers they keep the second block off the SM); per 8-query group
//    it recomputes S^T = k q^T and dP^T = v do^T, p and dS in registers,
//    and adds dV += P^T do and dK += dS^T q on mma.sync in 3xTF32;
//  * no atomics: each output row is summed in a fixed order (one warp, or
//    the splits in order), so the results repeat bit for bit.  Any Sq and
//    Sk, ragged.
//
// Plain C interface for ctypes; the wrapper (kernel.py) takes each plan
// from kernel.mha_plan, allocates the outputs and raises on a non-zero
// return.

#include "mha_common.cuh"

namespace {

using namespace mha;

// 8-row groups a warp takes at once, dq's over keys and dkv's over
// queries: the faster of one and two on the card at the main path's shape.
constexpr int kDqGroups = 1;
constexpr int kDkvGroups = 2;

// G 8-key groups from key j0 of the staged tile: S = q k^T and dP = do
// v^T, p and dS in registers, then dQ += dS k.  `left` counts the tile's
// keys from j0 below the length; with kMask the chunk's keys past it
// (zero-filled rows) get p = 0.
template <int DH, int G, bool kMask>
__device__ __forceinline__ void dq_chunk(const RowsA<DH>& qa,
                                         const RowsA<DH>& da, const float* ks,
                                         int k_lo, const float* vs, int v_lo,
                                         int j0, int left, float sl,
                                         float scale, const float (&lse2)[2],
                                         const float (&dlt)[2], int g, int t,
                                         float (&acc)[Geom<DH>::kDT][4]) {
  using Gm = Geom<DH>;
  float s[G][4], dp[G][4];
#pragma unroll
  for (int j = 0; j < G; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_over_dh<DH>(s[j], qa, ks + (j0 + 8 * j + g) * Gm::kPC + Gm::kVec * t,
                    k_lo);
    mma_over_dh<DH>(dp[j], da, vs + (j0 + 8 * j + g) * Gm::kPR + Gm::kVec * t,
                    v_lo);
  }
#pragma unroll
  for (int j = 0; j < G; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float p = exp2f(fmaf(s[j][e], sl, -lse2[r]));
      if (kMask && 8 * j + 2 * t + (e & 1) >= left) p = 0.f;
      s[j][e] = p * (dp[j][e] - dlt[r]) * scale;
    }
#pragma unroll
  for (int j = 0; j < G; ++j)
    add_over_rows<DH>(acc, s[j], ks + (j0 + 8 * j + 2 * t) * Gm::kPC + g,
                      k_lo);
}

// G 8-query groups from query i0 of the staged tile, for the warp's key
// rows: S^T = k q^T and dP^T = v do^T, p and dS in registers (zero for key
// rows past the length: live0, live1), then dV += P^T do and dK += dS^T q.
// Staged query rows past Sq are zero, with lse = delta = 0: their p is 1
// and their do, q and dS are 0, so they add nothing.
template <int DH, int G>
__device__ __forceinline__ void dkv_groups(const PlanesA<DH>& kr,
                                          const PlanesA<DH>& vr,
                                          const float* qs,
                                          const float* ds, int lo_off,
                                          const float* ls, const float* dls,
                                          int i0, bool live0, bool live1,
                                          float sl, float scale, int g, int t,
                                          float (&dka)[Geom<DH>::kDT][4],
                                          float (&dva)[Geom<DH>::kDT][4]) {
  using Gm = Geom<DH>;
  float s[G][4], dp[G][4];
#pragma unroll
  for (int j = 0; j < G; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_over_dh<DH>(s[j], kr, qs + (i0 + 8 * j + g) * Gm::kPC + Gm::kVec * t,
                    lo_off);
    mma_over_dh<DH>(dp[j], vr, ds + (i0 + 8 * j + g) * Gm::kPC + Gm::kVec * t,
                    lo_off);
  }
#pragma unroll
  for (int j = 0; j < G; ++j) {
    // Columns: queries i0 + 8j + 2t and + 1.
    const float2 lq = *reinterpret_cast<const float2*>(ls + i0 + 8 * j + 2 * t);
    const float2 dq =
        *reinterpret_cast<const float2*>(dls + i0 + 8 * j + 2 * t);
    const float lc[2] = {lq.x * kLog2e, lq.y * kLog2e};
    const float dc[2] = {dq.x, dq.y};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool live = (e >> 1) ? live1 : live0;
      const float p = live ? exp2f(fmaf(s[j][e], sl, -lc[e & 1])) : 0.f;
      s[j][e] = p;
      dp[j][e] = p * (dp[j][e] - dc[e & 1]) * scale;
    }
  }
  // One group's dV, then its dK, each through a fresh accumulator: at dh
  // 64 the two sums' registers and theirs would not fit together.
#pragma unroll
  for (int j = 0; j < G; ++j) {
    add_over_rows<DH>(dva, s[j], ds + (i0 + 8 * j + 2 * t) * Gm::kPC + g,
                      lo_off);
    add_over_rows<DH>(dka, dp[j], qs + (i0 + 8 * j + 2 * t) * Gm::kPC + g,
                      lo_off);
  }
}

template <int DH>
__global__ void __launch_bounds__(Geom<DH>::kThreads, Geom<DH>::kMinBlocks)
mha_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  const float* __restrict__ lengths, float* __restrict__ dq,
                  int sq, int sk, int rows, int key_tile, float scale) {
  using G = Geom<DH>;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t bh = blockIdx.x;
  const int q0 = blockIdx.y * rows;
  // The length, then the lane's q and do rows: one round trip for all.
  const float len = lengths[bh];
  const int ra = q0 + 16 * warp + g, rb = ra + 8;
  const bool la = ra < sq, lb = rb < sq;
  const int64_t oa = (bh * sq + ra) * DH + G::kVec * t;
  const int64_t ob = (bh * sq + rb) * DH + G::kVec * t;
  RowsA<DH> qa, da;
  qa.load(q + oa, la, q + ob, lb);
  da.load(dout + oa, la, dout + ob, lb);
  const int nk = valid_keys(len, sk);
  const float* kb = k + bh * sk * DH;
  const float* vb = v + bh * sk * DH;
  float* dqb = dq + bh * sq * DH;

  if (nk == 0) {            // uniform per block
    zero_rows<DH>(dqb, q0, min(sq, q0 + rows), tid, nthreads);
    return;
  }

  // A stage: k's hi and lo planes (pitch kPC: k is read both as rows, in
  // S = q k^T, and as columns, in dq += ds k), then v's (pitch kPR).
  const int k_lo = key_tile * G::kPC, v_lo = key_tile * G::kPR;
  const int stage_floats = 2 * (k_lo + v_lo);
  const int n_tiles = (nk + key_tile - 1) / key_tile;
  auto tile_keys = [&](int it) { return min(key_tile, nk - it * key_tile); };
  auto stage_kv = [&](int it) {
    float* ks = smem + (it & 1) * stage_floats;
    const int k0 = it * key_tile, n = tile_keys(it);
    const int n16 = (n + 15) & ~15;
    stage_rows<DH>(ks, G::kPC, kb + k0 * DH, n16, n, tid, nthreads);
    stage_rows<DH>(ks + 2 * k_lo, G::kPR, vb + k0 * DH, n16, n, tid,
                   nthreads);
  };
  stage_kv(0);
  cp_async_commit();

  // Rows past Sq: q = do = 0 and lse = delta = 0, so p = 1 and ds = 0.
  const float lse2[2] = {la ? lse[bh * sq + ra] * kLog2e : 0.f,
                         lb ? lse[bh * sq + rb] * kLog2e : 0.f};
  const float dlt[2] = {la ? delta[bh * sq + ra] : 0.f,
                        lb ? delta[bh * sq + rb] : 0.f};
  const float sl = scale * kLog2e;

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
    split_rows<DH>(ks, G::kPC, k_lo, n16, tid, nthreads);
    split_rows<DH>(vs, G::kPR, v_lo, n16, tid, nthreads);
    __syncthreads();
    if (it + 1 < n_tiles) stage_kv(it + 1);
    cp_async_commit();

    // Chunks of kDqGroups 8-key groups; only the last is masked.
    int j0 = 0;
    for (; n - j0 >= 8 * kDqGroups; j0 += 8 * kDqGroups)
      dq_chunk<DH, kDqGroups, false>(qa, da, ks, k_lo, vs, v_lo, j0, n - j0,
                                     sl, scale, lse2, dlt, g, t, acc);
    if (j0 < n)
      dq_chunk<DH, kDqGroups, true>(qa, da, ks, k_lo, vs, v_lo, j0, n - j0,
                                    sl, scale, lse2, dlt, g, t, acc);
  }
  store_row<DH>(acc, 0, 1.f, dqb + static_cast<int64_t>(ra) * DH, la, t);
  store_row<DH>(acc, 1, 1.f, dqb + static_cast<int64_t>(rb) * DH, lb, t);
}

__device__ __forceinline__ void bar_sync(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(nthreads) : "memory");
}

template <int DH>
__global__ void __launch_bounds__(Geom<DH>::kThreads, Geom<DH>::kMinBlocks)
mha_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   const float* __restrict__ lengths,
                   float* __restrict__ dk, float* __restrict__ dv, int sq,
                   int sk, int rows, int query_tile, float scale) {
  using G = Geom<DH>;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t bh = blockIdx.x;
  const int k0 = blockIdx.y * rows;
  const int k1 = min(sk, k0 + rows);
  const int nk = valid_keys(lengths[bh], sk);
  const int kept = max(0, min(nk, k1) - k0);   // the block's kept key rows
  float* dkb = dk + bh * sk * DH;
  float* dvb = dv + bh * sk * DH;

  // Key rows past the length: dk = dv = 0, by every thread of the block.
  zero_rows<DH>(dkb, k0 + kept, k1, tid, blockDim.x);
  zero_rows<DH>(dvb, k0 + kept, k1, tid, blockDim.x);
  // Warps that own kept keys (16 rows each), and as many splits of the
  // query rows among the block's warps as they leave room for: warp w
  // takes key rows w % working and the 16-query blocks b with b % splits
  // = w / working.  The rest stop here, uniformly per warp.
  const int working = (kept + 15) / 16;
  if (working == 0) return;
  const int splits = (blockDim.x >> 5) / working;
  const int active = working * splits;
  if (warp >= active) return;
  const int nthreads = 32 * active;
  const int kw = warp % working, part = warp / working;

  // Shared memory: the block's kept k rows, hi and lo planes, then v's
  // (pitch kPR; read as A fragments at each use); then the stages: q's hi
  // and lo planes, then do's (pitch kPC: both are read as rows and as
  // columns), then lse and delta, one float a query.
  const int kept16 = 16 * working;
  const int kv_lo = rows * G::kPR;
  float* kvs = smem;
  float* stages = smem + 4 * kv_lo;
  const int lo_off = query_tile * G::kPC;
  const int stage_floats = 4 * lo_off + 2 * query_tile;
  const int n_tiles = (sq + query_tile - 1) / query_tile;
  const float* qb = q + bh * sq * DH;
  const float* db = dout + bh * sq * DH;
  auto tile_rows = [&](int it) {
    return min(query_tile, sq - it * query_tile);
  };
  stage_rows<DH>(kvs, G::kPR, k + (bh * sk + k0) * DH, kept16, kept, tid,
                 nthreads);
  stage_rows<DH>(kvs + 2 * kv_lo, G::kPR, v + (bh * sk + k0) * DH, kept16,
                 kept, tid, nthreads);
  auto stage_q = [&](int it) {
    float* qs = stages + (it & 1) * stage_floats;
    float* ls = qs + 4 * lo_off;
    const int i0 = it * query_tile, n = tile_rows(it);
    const int n16 = (n + 15) & ~15;
    stage_rows<DH>(qs, G::kPC, qb + i0 * DH, n16, n, tid, nthreads);
    stage_rows<DH>(qs + 2 * lo_off, G::kPC, db + i0 * DH, n16, n, tid,
                   nthreads);
    for (int r = tid; r < n16; r += nthreads) {
      const bool ok = r < n;
      const int64_t at = bh * sq + i0 + (ok ? r : 0);
      cp_async4(ls + r, lse + at, ok);
      cp_async4(ls + query_tile + r, delta + at, ok);
    }
  };
  stage_q(0);
  cp_async_commit();

  const int ka = k0 + 16 * kw + g, kb2 = ka + 8;
  const int kend = k0 + kept;
  const bool la = ka < kend, lb = kb2 < kend;
  const uint32_t kra = static_cast<uint32_t>(__cvta_generic_to_shared(
      kvs + (16 * kw + g) * G::kPR + G::kVec * t));
  const PlanesA<DH> kr{kra, 4 * kv_lo};
  const PlanesA<DH> vr{kra + 8 * kv_lo, 4 * kv_lo};
  const float sl = scale * kLog2e;

  float dka[G::kDT][4], dva[G::kDT][4];
#pragma unroll
  for (int n = 0; n < G::kDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    float* qs = stages + (it & 1) * stage_floats;
    float* ds = qs + 2 * lo_off;
    const float* ls = qs + 4 * lo_off;
    const int n16 = (tile_rows(it) + 15) & ~15;
    cp_async_wait_all();
    bar_sync(1, nthreads);  // tile `it` is in; tile it - 1's stage is free
    if (it == 0) {
      split_rows<DH>(kvs, G::kPR, kv_lo, kept16, tid, nthreads);
      split_rows<DH>(kvs + 2 * kv_lo, G::kPR, kv_lo, kept16, tid, nthreads);
    }
    split_rows<DH>(qs, G::kPC, lo_off, n16, tid, nthreads);
    split_rows<DH>(ds, G::kPC, lo_off, n16, tid, nthreads);
    bar_sync(1, nthreads);
    if (it + 1 < n_tiles) stage_q(it + 1);
    cp_async_commit();

    for (int b = part; 16 * b < n16; b += splits)
#pragma unroll
      for (int i0 = 16 * b; i0 < 16 * b + 16; i0 += 8 * kDkvGroups)
        dkv_groups<DH, kDkvGroups>(kr, vr, qs, ds, lo_off, ls,
                                   ls + query_tile, i0, la, lb, sl, scale, g,
                                   t, dka, dva);
  }

  // The splits' partial sums, added by split 0 in split order (the same
  // order every call) through shared memory, which the stages no longer
  // need: warp w's are at red[(w * 8 kDT + e) * 32 + lane].
  if (splits > 1) {
    constexpr int kR = 8 * G::kDT;
    bar_sync(1, nthreads);   // every warp is done with the stages
    float* red = smem;
    if (part > 0) {
#pragma unroll
      for (int n = 0; n < G::kDT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          red[(warp * kR + 4 * n + e) * 32 + lane] = dka[n][e];
          red[(warp * kR + 4 * (G::kDT + n) + e) * 32 + lane] = dva[n][e];
        }
    }
    bar_sync(1, nthreads);
    if (part > 0) return;
    for (int p = 1; p < splits; ++p) {
      const int w = kw + p * working;
#pragma unroll
      for (int n = 0; n < G::kDT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dka[n][e] += red[(w * kR + 4 * n + e) * 32 + lane];
          dva[n][e] += red[(w * kR + 4 * (G::kDT + n) + e) * 32 + lane];
        }
    }
  }
  store_row<DH>(dka, 0, 1.f, dkb + static_cast<int64_t>(ka) * DH, la, t);
  store_row<DH>(dka, 1, 1.f, dkb + static_cast<int64_t>(kb2) * DH, lb, t);
  store_row<DH>(dva, 0, 1.f, dvb + static_cast<int64_t>(ka) * DH, la, t);
  store_row<DH>(dva, 1, 1.f, dvb + static_cast<int64_t>(kb2) * DH, lb, t);
}

struct Args {
  const float *q, *k, *v, *dout, *lse, *delta, *lengths;
  int bh, sq, sk, rows, tiles, stream_tile, smem;
  float scale;
  cudaStream_t stream;
};

template <int DH>
cudaError_t launch_dq(const Args& a, float* dq) {
  if (!plan_fits<DH>(a.rows, a.stream_tile)) return cudaErrorInvalidValue;
  static int allowed = 48 * 1024;
  const cudaError_t err =
      allow_smem(mha_bwd_dq_kernel<DH>, a.smem, allowed);
  if (err != cudaSuccess) return err;
  mha_bwd_dq_kernel<DH><<<dim3(a.bh, a.tiles), 2 * a.rows, a.smem,
                          a.stream>>>(a.q, a.k, a.v, a.dout, a.lse, a.delta,
                                      a.lengths, dq, a.sq, a.sk, a.rows,
                                      a.stream_tile, a.scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dkv(const Args& a, float* dk, float* dv) {
  if (!plan_fits<DH>(a.rows, a.stream_tile)) return cudaErrorInvalidValue;
  static int allowed = 48 * 1024;
  const cudaError_t err =
      allow_smem(mha_bwd_dkv_kernel<DH>, a.smem, allowed);
  if (err != cudaSuccess) return err;
  mha_bwd_dkv_kernel<DH><<<dim3(a.bh, a.tiles), 2 * a.rows, a.smem,
                           a.stream>>>(a.q, a.k, a.v, a.dout, a.lse,
                                       a.delta, a.lengths, dk, dv, a.sq,
                                       a.sk, a.rows, a.stream_tile, a.scale);
  return cudaGetLastError();
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const void* lengths,
               int bh, int sq, int sk, int rows, int tiles, int stream_tile,
               int smem, float scale, void* stream) {
  return Args{static_cast<const float*>(q), static_cast<const float*>(k),
              static_cast<const float*>(v), static_cast<const float*>(dout),
              static_cast<const float*>(lse),
              static_cast<const float*>(delta),
              static_cast<const float*>(lengths), bh, sq, sk, rows, tiles,
              stream_tile, smem, scale, static_cast<cudaStream_t>(stream)};
}

}  // namespace

extern "C" {

// Each plan (rows a block, tiles a batch-head, rows a stage, shared bytes)
// is kernel.mha_plan's: dq's over query rows with key stages, dkv's over
// key rows with query stages.  `scale` is dh^-0.5 as the wrapper rounds it
// to float32.  Each returns cudaGetLastError() after its launch (0 on
// success), or cudaErrorInvalidValue for a head dim without an
// instantiation or a plan its kernel cannot run.
int mrsch_mha_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     const void* lengths, void* dq, int bh, int sq, int sk,
                     int dh, int rows, int tiles, int key_tile, int smem,
                     float scale, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, lengths, bh, sq, sk,
                           rows, tiles, key_tile, smem, scale, stream);
  auto* out = static_cast<float*>(dq);
  switch (dh) {
    case 8: return launch_dq<8>(a, out);
    case 16: return launch_dq<16>(a, out);
    case 32: return launch_dq<32>(a, out);
    case 64: return launch_dq<64>(a, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int mrsch_mha_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      const void* lengths, void* dk, void* dv, int bh,
                      int sq, int sk, int dh, int rows, int tiles,
                      int query_tile, int smem, float scale, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, lengths, bh, sq, sk,
                           rows, tiles, query_tile, smem, scale, stream);
  auto* dkf = static_cast<float*>(dk);
  auto* dvf = static_cast<float*>(dv);
  switch (dh) {
    case 8: return launch_dkv<8>(a, dkf, dvf);
    case 16: return launch_dkv<16>(a, dkf, dvf);
    case 32: return launch_dkv<32>(a, dkf, dvf);
    case 64: return launch_dkv<64>(a, dkf, dvf);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* mrsch_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
