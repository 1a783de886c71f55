// Fused dense layer backward for Hopper (sm_90a): the two gradient kernels
// of y = act(x @ W + b).
//
//   dgrad:  dx (M, K) = (g * act'(y)) (M, N) @ W^T        W is (K, N)
//   wgrad:  dW (K, N) = x^T (K, M) @ (g * act'(y)) (M, N),
//           and the bias gradient db (N,) = sum_m (g * act'(y))[m, :]
//
// Replace the TPU kernels `fused_mlp_dgrad_layer` (`_fused_mlp_dgrad_kernel`)
// and `fused_mlp_wgrad_layer` (`_fused_mlp_wgrad_kernel`) in
// src/repro/kernels/fused_mlp/kernel.py.  float32 or bfloat16 in and out,
// float32 accumulation, act in {leaky_relu, relu, tanh, linear}.  act' is
// recovered from the saved output y and applied while the operand is staged
// in shared memory, so the (M, N) product g * act'(y) is never written to
// device memory (the property the TPU kernels were built for; the JAX
// package leaves db to XLA, here it folds into the wgrad, whose blocks of
// the first K tile already hold the scaled g).  Nothing is padded: ragged
// M, K and N edges are masked in the kernels.
//
// What bounds them:
//
//  * wgrad, in DFP training (M = 64 rows per minibatch), is bound on the
//    widest layer by operations in float32 and by its writes in bfloat16:
//    2MKN FLOP against a contraction only M long, with a large output
//    (45.6 M elements, 182.6 MB float32, for the 11410 x 4000 layer: 87 us
//    of float32 FMA at 67 TFLOP/s, 54.5 us of writes at 3.35 TB/s).  Its
//    other layers, and the attention encoder's
//    (K, N <= 128 and M up to 64 x 129 = 8,256: the whole layer one or two
//    tiles, so one block would walk every row of M), are bound by latency.
//    Design: the tile is chosen per layer (128, 64 or 32 square) so that
//    the blocks spread over the SMs; M, the contraction, is split across
//    blocks (grid.z) when the tiles alone cannot fill the card, never into
//    slices shorter than 64 rows, and the splits' float32 partial sums of
//    dW and db are added in a fixed order by a second small kernel, so the
//    results repeat bit for bit.  Each block stages x, g and y in shared
//    memory and multiplies: float32 on the CUDA cores, bfloat16 on the
//    tensor cores (below).
//  * dgrad is bound by operations at M = 64 (about 7.6 us of float32 FMA
//    for the 4000 x 1000 layer) and by bytes or latency at small M and on
//    the attention encoder's layers (M = 8,256, K, N <= 128).  Each
//    dx[:, k] contracts along the contiguous row k of W, the transpose of
//    the forward's access, which is the K-major operand mma.sync takes.
//    Design: the products run on the tensor cores (bfloat16 with s = g *
//    act'(y) as hi + lo; float32 in 3xTF32); the tile (rows of M by
//    columns of K) is chosen per layer so that the blocks spread over the
//    SMs, and N is split across up to 8 blocks where the tiles alone
//    cannot fill the card (K = 4000 gives 125 32-wide tiles for 132 SMs).
//    The splits of a tile form a thread-block cluster and add their
//    float32 partial sums in split order through distributed shared
//    memory, in the same launch, so results do not depend on scheduling.
//
// Plain C interface for ctypes; the wrapper (kernel.py) picks the tiles
// and splits, allocates dx, dW, db and the wgrad's partial buffers, and
// raises on a non-zero return.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;

enum Activation { kLeakyRelu = 0, kRelu = 1, kTanh = 2, kLinear = 3 };
enum DType { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// d act / d pre-activation from the output y (slope > 0): 1 at y = 0 for
// leaky_relu, 0 for relu, as the JAX package's `_activation_grad`.
__device__ __forceinline__ float activation_grad(float y, int act,
                                                 float slope) {
  switch (act) {
    case kLeakyRelu:
      return y >= 0.f ? 1.f : slope;
    case kRelu:
      return y > 0.f ? 1.f : 0.f;
    case kTanh:
      return 1.f - y * y;
    default:
      return 1.f;
  }
}

// Four consecutive outputs [c, c + 4) of one row.  kVec: the row length is a
// multiple of 4, so the four are one aligned store and all or none lie
// inside it (the caller skips c >= n).
template <typename T, bool kVec>
struct Store4;

template <>
struct Store4<float, true> {
  __device__ __forceinline__ static void run(float* __restrict__ out,
                                             long long off, int, int,
                                             const float (&v)[4]) {
    *reinterpret_cast<float4*>(out + off) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Store4<__nv_bfloat16, true> {
  __device__ __forceinline__ static void run(__nv_bfloat16* __restrict__ out,
                                             long long off, int, int,
                                             const float (&v)[4]) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 q;
    q.x = *reinterpret_cast<const uint32_t*>(&lo);
    q.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(out + off) = q;
  }
};

template <typename T>
struct Store4<T, false> {
  __device__ __forceinline__ static void run(T* __restrict__ out,
                                             long long off, int c, int n,
                                             const float (&v)[4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c + j < n) out[off + j] = from_f32<T>(v[j]);
  }
};

// ------------------------------------------------------------------ wgrad
// grid = (ceil(N / T), ceil(K / T), splits) for a square tile T of 128, 64
// or 32 (kernel.py's wgrad_tile: the largest of which the layer has a wave
// of tiles; else 64 where M is split, 32 where it is not).  Block (nt, kt,
// s) owns the T x T tile (k0, n0) of dW over the rows [s * chunk, min(M,
// (s + 1) * chunk)) of M; 256 threads.
//
// Each 32-row step of M goes through a two-stage ring in shared memory: x,
// g and y land there by cp.async (the widest chunk of 16, 8 or 4 bytes the
// rows are aligned to; zero past M, K or N) while the step before is
// multiplied; a linear layer (act' = 1) does not load y.  The blocks of
// the first K tile also sum s = g * act'(y) over M for db, in a fixed
// order.  The product of a step:
//  * float32, on the CUDA cores: a pass replaces the staged g by s, then
//    thread (tx, ty) = (tid % 16, tid / 16) accumulates a (T / 16) x (T /
//    16) micro-tile of dW in float32 FMAs, reading x and s along M in
//    vectors (rows ty * T / 16.., columns tx * T / 16..); at T = 128 the
//    same 8 x 8 micro-tile is computed by wgrad_fma128_kernel below, which
//    stages through registers.  3xTF32 on mma.sync, tried first, was slower
//    at every shape (mma.sync runs TF32 at a fraction of wgmma's rate, and
//    the three products triple it) and, its accumulation truncating, missed
//    the 1e-4 tolerance over long M;
//  * bfloat16, on the tensor cores (mma.sync m16n8k16): the 8 warps form a
//    2 x 4 grid, warp w owning a (T / 2) x (T / 4) sub-tile of 16 x 8
//    tiles, and skip the tiles that lie wholly past K or N.  act' is
//    applied as the fragments of g are read (ldmatrix.trans: the
//    contraction M is the outer dimension of both staged operands), s
//    split into bfloat16 s_hi + s_lo, so it keeps about 16 mantissa bits;
//    x is exact, and each tile adds x s_lo + x s_hi.
// With one split the block writes its dW tile (and db) in the output dtype;
// with more it writes float32 partial sums, which wgrad_sum_kernel adds in
// a fixed order, so the results repeat bit for bit.
constexpr int kWgStepM = 32;             // rows of M a ring stage holds
constexpr int kWgStages = 2;

template <int kTile>
struct WgGeom {
  static constexpr int kPitch = kTile + 8;               // spreads the banks
  static constexpr int kArray = kWgStepM * kPitch;       // one staged array
  static constexpr int kSmem(int elem) { return kWgStages * 3 * kArray * elem; }
  // float32: a (kPer x kPer) micro-tile per thread, in kGroups vectors of kV
  // whose starts are kSpan apart.
  static constexpr int kPer = kTile / 16;
  static constexpr int kV = kPer < 4 ? kPer : 4;
  static constexpr int kGroups = kPer / kV;
  static constexpr int kSpan = kTile / kGroups;
  static constexpr int kPassRows = kThreads / kTile;     // rows a pass sweep
  // bfloat16: the 2 x 4 warp grid's sub-tiles of 16 x 8 tensor-core tiles.
  static constexpr int kWarpK = kTile / 2;
  static constexpr int kWarpN = kTile / 4;
  static constexpr int kI = kWarpK / 16;
  static constexpr int kJ = kWarpN / 8;
  static_assert(kWarpK % 16 == 0 && kWarpN % 8 == 0, "tile");
};

// cp.async of kBytes (4, 8 or 16); src_bytes = 0 fills the chunk with zeros.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(gmem), "n"(kBytes), "r"(src_bytes)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Two values (low half first) as hi + lo, both bfloat16 pairs.
__device__ __forceinline__ void split_bf16x2(float v0, float v1, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(
      v0 - __low2float(h), v1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2],
                                              const void* smem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(s)
      : "memory");
}

// Stage rows [row0, row0 + 32) of a (rows, ld) operand's columns [c0, c0 +
// kTile), zero past m_end or ld, in chunks of `bytes` (16, 8 or 4: ld and
// the operand are aligned to it, so a chunk lies wholly inside or outside
// the row) by cp.async; bytes = 0 stages element by element.
template <typename T, int kTile>
__device__ __forceinline__ void wgrad_stage(T* dst, const T* __restrict__ src,
                                            int ld, int c0, int row0,
                                            int m_end, int bytes, int tid) {
  constexpr int kP = WgGeom<kTile>::kPitch;
  if (bytes == 0) {
    const T zero = from_f32<T>(0.f);
    for (int e = tid; e < kWgStepM * kTile; e += kThreads) {
      const int r = e / kTile, c = e % kTile;
      const int m = row0 + r;
      dst[r * kP + c] = m < m_end && c0 + c < ld
                            ? src[static_cast<long long>(m) * ld + c0 + c]
                            : zero;
    }
    return;
  }
  const int per = bytes / static_cast<int>(sizeof(T));  // elements a chunk
  const int shift = __ffs(kTile / per) - 1;              // log2 chunks a row
  for (int q = tid; q < (kWgStepM << shift); q += kThreads) {
    const int r = q >> shift, c = (q & ((1 << shift) - 1)) * per;
    const int m = row0 + r;
    const bool live = m < m_end && c0 + c < ld;
    const T* from = live ? src + static_cast<long long>(m) * ld + c0 + c : src;
    const int n = live ? bytes : 0;
    T* to = dst + r * kP + c;
    if (bytes == 16)
      cp_async<16>(to, from, n);
    else if (bytes == 8)
      cp_async<8>(to, from, n);
    else
      cp_async<4>(to, from, n);
  }
}

// kV consecutive float32 values from shared memory (kV = 2 or 4, aligned).
template <int kV>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (kV == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x, v[1] = q.y;
  }
}

// kV consecutive outputs (c .. c + kV) of one row; `vec`: the row length is
// a multiple of kV, so all lie inside it and form one aligned store.
template <int kV, typename T>
__device__ __forceinline__ void store_vec(T* out, long long off, int c, int n,
                                          const float* v, bool vec) {
  if constexpr (kV == 4) {
    if (vec) {
      Store4<T, true>::run(out, off, c, n,
                           *reinterpret_cast<const float(*)[4]>(v));
      return;
    }
  } else if constexpr (std::is_same_v<T, float>) {
    if (vec) {
      *reinterpret_cast<float2*>(out + off) = make_float2(v[0], v[1]);
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < kV; ++j)
    if (c + j < n) out[off + j] = from_f32<T>(v[j]);
}

// float32: the staged steps on the CUDA cores.
template <int kTile>
__global__ void __launch_bounds__(kThreads, 2)
    wgrad_fma_kernel(const float* __restrict__ x, const float* __restrict__ g,
                     const float* __restrict__ y, float* __restrict__ dw,
                     float* __restrict__ db, float* __restrict__ partial,
                     float* __restrict__ db_partial, int M, int K, int N,
                     int chunk, int x_bytes, int gy_bytes, int act,
                     float slope) {
  using G = WgGeom<kTile>;
  extern __shared__ __align__(16) unsigned char wg_smem[];
  __shared__ float db_rows[G::kPassRows][kTile];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * kTile;
  const int k0 = blockIdx.y * kTile;
  const int split = blockIdx.z;
  const int m_begin = split * chunk;
  const int m_end = min(M, m_begin + chunk);
  const int steps = (m_end - m_begin + kWgStepM - 1) / kWgStepM;
  const bool use_y = act != kLinear;     // linear: act' = 1 whatever y is
  float* const ring = reinterpret_cast<float*>(wg_smem);

  auto stage = [&](int s, int step) {
    float* xs = ring + (s * 3) * G::kArray;
    const int row0 = m_begin + step * kWgStepM;
    wgrad_stage<float, kTile>(xs, x, K, k0, row0, m_end, x_bytes, tid);
    wgrad_stage<float, kTile>(xs + G::kArray, g, N, n0, row0, m_end,
                              gy_bytes, tid);
    if (use_y)
      wgrad_stage<float, kTile>(xs + 2 * G::kArray, y, N, n0, row0, m_end,
                                gy_bytes, tid);
    cp_async_commit();
  };

  float acc[G::kPer][G::kPer];
#pragma unroll
  for (int i = 0; i < G::kPer; ++i)
#pragma unroll
    for (int j = 0; j < G::kPer; ++j) acc[i][j] = 0.f;
  float db_acc = 0.f;
  // The pass's map: column tid % kTile of rows tid / kTile + kPassRows r.
  const int pc = tid % kTile, pr = tid / kTile;

  stage(0, 0);
  if (steps > 1)
    stage(1, 1);
  else
    cp_async_commit();                   // keeps one group per step
  for (int step = 0; step < steps; ++step) {
    const float* const xs = ring + ((step & 1) * 3) * G::kArray;
    float* const ss = ring + ((step & 1) * 3 + 1) * G::kArray;   // g, then s
    const float* const ys = ss + G::kArray;
    cp_async_wait_prior();               // this step's group has landed
    __syncthreads();
#pragma unroll
    for (int r = pr; r < kWgStepM; r += G::kPassRows) {
      const int o = r * G::kPitch + pc;
      float s = ss[o];
      if (use_y) {
        s *= activation_grad(ys[o], act, slope);
        ss[o] = s;
      }
      db_acc += s;
    }
    __syncthreads();
#pragma unroll 4
    for (int m = 0; m < kWgStepM; ++m) {
      float a[G::kPer], b[G::kPer];
#pragma unroll
      for (int q = 0; q < G::kGroups; ++q) {
        load_vec<G::kV>(xs + m * G::kPitch + q * G::kSpan + ty * G::kV,
                        a + q * G::kV);
        load_vec<G::kV>(ss + m * G::kPitch + q * G::kSpan + tx * G::kV,
                        b + q * G::kV);
      }
#pragma unroll
      for (int i = 0; i < G::kPer; ++i)
#pragma unroll
        for (int j = 0; j < G::kPer; ++j)
          acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();                     // the stage is free again
    if (step + 2 < steps)
      stage(step & 1, step + 2);
    else
      cp_async_commit();
  }

  const bool fused = partial == nullptr;
  const bool vec = N % G::kV == 0;
#pragma unroll
  for (int i = 0; i < G::kPer; ++i) {
    const int k = k0 + (i / G::kV) * G::kSpan + ty * G::kV + i % G::kV;
    if (k >= K) continue;
#pragma unroll
    for (int q = 0; q < G::kGroups; ++q) {
      const int c = n0 + q * G::kSpan + tx * G::kV;
      if (c >= N) continue;
      if (fused)
        store_vec<G::kV>(dw, static_cast<long long>(k) * N + c, c, N,
                         acc[i] + q * G::kV, vec);
      else
        store_vec<G::kV>(partial,
                         (static_cast<long long>(split) * K + k) * N + c, c,
                         N, acc[i] + q * G::kV, vec);
    }
  }
  if (blockIdx.y == 0) {                 // block-uniform
    db_rows[pr][pc] = db_acc;
    __syncthreads();
    if (tid < kTile && n0 + tid < N) {
      float total = 0.f;
#pragma unroll
      for (int r = 0; r < G::kPassRows; ++r) total += db_rows[r][tid];
      if (fused) {
        if (db != nullptr) db[n0 + tid] = total;
      } else if (db_partial != nullptr) {
        db_partial[static_cast<long long>(split) * N + n0 + tid] = total;
      }
    }
  }
}

// bfloat16: a staged step's product into the warp's tensor-core tiles.
// live_i, live_j: the warp's tiles along K and N that reach inside the
// layer; with_db: this warp sums s for db (its rows start the K tile 0).
template <int kTile>
__device__ __forceinline__ void wgrad_mma_step(
    float (&acc)[WgGeom<kTile>::kI][WgGeom<kTile>::kJ][4],
    float (&db)[WgGeom<kTile>::kJ], const __nv_bfloat16* xs,
    const __nv_bfloat16* gs, const __nv_bfloat16* ys, int wk0, int wn0,
    int live_i, int live_j, bool with_db, bool use_y, int act, float slope,
    int lane) {
  using G = WgGeom<kTile>;
  constexpr int kP = G::kPitch;
  // ldmatrix: lane l gives the address of row (l & 7) of matrix l >> 3.
  const int mat = lane >> 3, row = lane & 7;
#pragma unroll
  for (int ks = 0; ks < kWgStepM; ks += 16) {
    uint32_t bh[G::kJ][2], bl[G::kJ][2];
#pragma unroll
    for (int jp = 0; jp < (G::kJ + 1) / 2; ++jp) {
      // Matrices: (n-tile 2jp: rows ks.., ks + 8..), (2jp + 1: the same);
      // a warp one tile wide reads the first two only.
      constexpr int kE = G::kJ == 1 ? 2 : 4;
      const int off =
          (ks + (mat & 1) * 8 + row) * kP + wn0 + 16 * jp + (mat >> 1) * 8;
      uint32_t gr[4], yr[4];
      if constexpr (kE == 2) {
        ldsm_x2_trans(reinterpret_cast<uint32_t(&)[2]>(gr), gs + off);
        if (use_y)
          ldsm_x2_trans(reinterpret_cast<uint32_t(&)[2]>(yr), ys + off);
      } else {
        ldsm_x4_trans(gr, gs + off);
        if (use_y) ldsm_x4_trans(yr, ys + off);
      }
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const __nv_bfloat162 g2 =
            *reinterpret_cast<const __nv_bfloat162*>(&gr[e]);
        float s0 = __low2float(g2), s1 = __high2float(g2);
        if (use_y) {
          const __nv_bfloat162 y2 =
              *reinterpret_cast<const __nv_bfloat162*>(&yr[e]);
          s0 *= activation_grad(__low2float(y2), act, slope);
          s1 *= activation_grad(__high2float(y2), act, slope);
        }
        const int j = 2 * jp + (e >> 1);
        if (with_db) db[j] += s0 + s1;
        split_bf16x2(s0, s1, bh[j][e & 1], bl[j][e & 1]);
      }
    }
#pragma unroll
    for (int i = 0; i < G::kI; ++i) {
      if (i >= live_i) break;
      // a0..a3: (k 0-7, m 0-7), (k 8-15, m 0-7), (k 0-7, m 8-15), (k 8-15,
      // m 8-15) of the tile, x staged (m, k).
      const int off =
          (ks + (mat >> 1) * 8 + row) * kP + wk0 + 16 * i + (mat & 1) * 8;
      uint32_t a[4];
      ldsm_x4_trans(a, xs + off);
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int j = 0; j < G::kJ; ++j) {
          if (j >= live_j) break;
          mma_bf16(acc[i][j], a, p == 0 ? bl[j] : bh[j]);
        }
    }
  }
}

// Two neighbouring outputs (c, c + 1) of one row; `even`: the row length
// is even, so both lie inside it and form one aligned store (else `second`
// says whether c + 1 does).
template <typename T>
__device__ __forceinline__ void store2(T* out, long long off, float v0,
                                       float v1, bool even, bool second) {
  if constexpr (std::is_same_v<T, float>) {
    if (even) {
      *reinterpret_cast<float2*>(out + off) = make_float2(v0, v1);
      return;
    }
  } else {
    if (even) {
      *reinterpret_cast<__nv_bfloat162*>(out + off) =
          __floats2bfloat162_rn(v0, v1);
      return;
    }
  }
  out[off] = from_f32<T>(v0);
  if (second) out[off + 1] = from_f32<T>(v1);
}

template <int kTile>
__global__ void __launch_bounds__(kThreads, 2)
    wgrad_mma_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ g,
                     const __nv_bfloat16* __restrict__ y,
                     __nv_bfloat16* __restrict__ dw,
                     __nv_bfloat16* __restrict__ db,
                     float* __restrict__ partial,
                     float* __restrict__ db_partial, int M, int K, int N,
                     int chunk, int x_bytes, int gy_bytes, int act,
                     float slope) {
  using T = __nv_bfloat16;
  using G = WgGeom<kTile>;
  extern __shared__ __align__(16) unsigned char wg_smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * kTile;
  const int k0 = blockIdx.y * kTile;
  const int split = blockIdx.z;
  const int m_begin = split * chunk;
  const int m_end = min(M, m_begin + chunk);
  const int steps = (m_end - m_begin + kWgStepM - 1) / kWgStepM;
  const int wk0 = (warp >> 2) * G::kWarpK;
  const int wn0 = (warp & 3) * G::kWarpN;
  // The warp's tiles that reach inside K and N (warp-uniform).
  const int live_i = min(G::kI, max(0, (K - k0 - wk0 + 15) / 16));
  const int live_j = min(G::kJ, max(0, (N - n0 - wn0 + 7) / 8));
  const bool live = live_i > 0 && live_j > 0;
  // db: the warps of the tile's first K rows, in the first K tile.
  const bool with_db = blockIdx.y == 0 && wk0 == 0 && live_j > 0;
  const bool use_y = act != kLinear;     // linear: act' = 1 whatever y is
  T* const ring = reinterpret_cast<T*>(wg_smem);

  auto stage = [&](int s, int step) {
    T* xs = ring + (s * 3) * G::kArray;
    const int row0 = m_begin + step * kWgStepM;
    wgrad_stage<T, kTile>(xs, x, K, k0, row0, m_end, x_bytes, tid);
    wgrad_stage<T, kTile>(xs + G::kArray, g, N, n0, row0, m_end, gy_bytes,
                          tid);
    if (use_y)
      wgrad_stage<T, kTile>(xs + 2 * G::kArray, y, N, n0, row0, m_end,
                            gy_bytes, tid);
    cp_async_commit();
  };

  float acc[G::kI][G::kJ][4];
#pragma unroll
  for (int i = 0; i < G::kI; ++i)
#pragma unroll
    for (int j = 0; j < G::kJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  float db_acc[G::kJ];
#pragma unroll
  for (int j = 0; j < G::kJ; ++j) db_acc[j] = 0.f;

  stage(0, 0);
  if (steps > 1)
    stage(1, 1);
  else
    cp_async_commit();                   // keeps one group per step
  for (int step = 0; step < steps; ++step) {
    const T* const xs = ring + ((step & 1) * 3) * G::kArray;
    cp_async_wait_prior();               // this step's group has landed
    __syncthreads();
    if (live)
      wgrad_mma_step<kTile>(acc, db_acc, xs, xs + G::kArray,
                            xs + 2 * G::kArray, wk0, wn0, live_i, live_j,
                            with_db, use_y, act, slope, lane);
    __syncthreads();                     // the stage is free again
    if (step + 2 < steps)
      stage(step & 1, step + 2);
    else
      cp_async_commit();
  }

  const bool fused = partial == nullptr;
  if (live) {
    const bool even = (N & 1) == 0;
#pragma unroll
    for (int i = 0; i < G::kI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = k0 + wk0 + 16 * i + (lane >> 2) + 8 * h;
        if (k >= K) continue;
#pragma unroll
        for (int j = 0; j < G::kJ; ++j) {
          const int n = n0 + wn0 + 8 * j + 2 * (lane & 3);
          if (n >= N) continue;
          const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
          if (fused)
            store2(dw, static_cast<long long>(k) * N + n, v0, v1, even,
                   n + 1 < N);
          else
            store2(partial, (static_cast<long long>(split) * K + k) * N + n,
                   v0, v1, even, n + 1 < N);
        }
      }
  }
  if (with_db) {
    // Each column's sum lies over the 4 lanes that share it (the pairs of
    // rows of the fragments): a fixed shuffle tree.
#pragma unroll
    for (int j = 0; j < G::kJ; ++j) {
      float t = db_acc[j];
      t += __shfl_xor_sync(0xffffffffu, t, 1);
      t += __shfl_xor_sync(0xffffffffu, t, 2);
      const int n = n0 + wn0 + 8 * j + (lane >> 2);
      if ((lane & 3) == 0 && n < N) {
        if (fused) {
          if (db != nullptr) db[n] = from_f32<T>(t);
        } else if (db_partial != nullptr) {
          db_partial[static_cast<long long>(split) * N + n] = t;
        }
      }
    }
  }
}

constexpr int kFmaTile = 128;   // rows of K and columns of N a block
constexpr int kFmaStepM = 16;   // rows of M staged a step

// float32 at the 128 tile (the DFP's 11410 x 4000 and 4000 x 1000 at M =
// 64, whose tiles fill the card; never split): the 16-row steps are loaded
// into registers while the step before is computed, g * act'(y) formed
// there, and staged in shared memory.  On these layers it is faster than
// wgrad_fma_kernel<128>, the cp.async ring above at the same 8 x 8
// micro-tile (PERF.md section 6 has both times).
// grid = (ceil(N / 128), ceil(K / 128)); block = 256 threads.  Thread
// (tx, ty) = (tid % 16, tid / 16) owns rows {ty*4 .. +3, 64 + ty*4 .. +3}
// and columns {tx*4 .. +3, 64 + tx*4 .. +3} of the block's dW tile.  The
// blocks of the first K tile (blockIdx.y == 0) also sum the staged, scaled
// g over M into db, in a fixed order.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    wgrad_fma128_kernel(const float* __restrict__ x,
                     const float* __restrict__ g,
                     const float* __restrict__ y, float* __restrict__ dw,
                     float* __restrict__ db, int M, int K, int N, int act,
                     float slope) {
  using T = float;
  constexpr int kPer = kFmaStepM * kFmaTile / kThreads;  // 8 per thread
  __shared__ __align__(16) float xs[kFmaStepM][kFmaTile];
  __shared__ __align__(16) float gs[kFmaStepM][kFmaTile];

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int n0 = blockIdx.x * kFmaTile;
  const int k0 = blockIdx.y * kFmaTile;
  // Staging map: element r of this thread is row 2r + sr, column sc of the
  // stage; a warp reads 32 consecutive columns of one row.
  const int sc = tid & (kFmaTile - 1);
  const int sr = tid / kFmaTile;
  const bool k_live = k0 + sc < K;
  const bool n_live = n0 + sc < N;

  // The next stage's operands, loaded into registers while the current
  // stage is computed, so the loads' latency is not exposed stage by stage.
  float xr[kPer], gr[kPer], yr[kPer];
  auto load = [&](int m0) {
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int m = m0 + 2 * r + sr;
      const bool m_live = m < M;
      xr[r] = (m_live && k_live)
                  ? to_f32(x[static_cast<long long>(m) * K + k0 + sc])
                  : 0.f;
      const long long o = static_cast<long long>(m) * N + n0 + sc;
      gr[r] = (m_live && n_live) ? to_f32(g[o]) : 0.f;
      yr[r] = (m_live && n_live) ? to_f32(y[o]) : 0.f;
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const bool with_db = db != nullptr && blockIdx.y == 0 && tid < kFmaTile;
  float db_acc = 0.f;

  load(0);
  for (int m0 = 0; m0 < M; m0 += kFmaStepM) {
    // Rows past M and columns past K or N stage as zero.
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      xs[2 * r + sr][sc] = xr[r];
      gs[2 * r + sr][sc] = gr[r] * activation_grad(yr[r], act, slope);
    }
    __syncthreads();
    if (m0 + kFmaStepM < M) load(m0 + kFmaStepM);
    if (with_db) {
#pragma unroll
      for (int m = 0; m < kFmaStepM; ++m) db_acc += gs[m][tid];
    }
#pragma unroll
    for (int m = 0; m < kFmaStepM; ++m) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[m][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&xs[m][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&gs[m][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&gs[m][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (with_db && n0 + tid < N) db[n0 + tid] = from_f32<T>(db_acc);

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = k0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (k >= K) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = n0 + h * 64 + tx * 4;
      if (c < N) {
        const float v[4] = {acc[i][h * 4], acc[i][h * 4 + 1],
                            acc[i][h * 4 + 2], acc[i][h * 4 + 3]};
        Store4<T, kVec>::run(dw, static_cast<long long>(k) * N + c, c, N, v);
      }
    }
  }
}

// dW and db from the splits' float32 partial sums: element i < K N of dW,
// then the N of db.  A block takes 32 consecutive outputs; each of its 8
// warps sums one contiguous eighth of the splits, in order, and the eight
// sums are added in order: a fixed order, whatever the scheduling.
constexpr int kSumCols = 32;
constexpr int kSumGroups = kThreads / kSumCols;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    wgrad_sum_kernel(const float* __restrict__ partial,
                     const float* __restrict__ db_partial, T* __restrict__ dw,
                     T* __restrict__ db, long long kn, int N, int splits) {
  __shared__ float sums[kSumGroups][kSumCols];
  const int lane = threadIdx.x % kSumCols, grp = threadIdx.x / kSumCols;
  const long long i = static_cast<long long>(blockIdx.x) * kSumCols + lane;
  const int per = (splits + kSumGroups - 1) / kSumGroups;
  const int q0 = grp * per, q1 = min(splits, q0 + per);
  float s = 0.f;
  if (i < kn) {
#pragma unroll 4
    for (int q = q0; q < q1; ++q) s += partial[q * kn + i];
  } else if (i < kn + N) {
    for (int q = q0; q < q1; ++q)
      s += db_partial[static_cast<long long>(q) * N + (i - kn)];
  }
  sums[grp][lane] = s;
  __syncthreads();
  if (grp != 0) return;
  float t = 0.f;
#pragma unroll
  for (int q = 0; q < kSumGroups; ++q) t += sums[q][lane];
  if (i < kn)
    dw[i] = from_f32<T>(t);
  else if (i < kn + N && db != nullptr)
    db[i - kn] = from_f32<T>(t);
}

// ------------------------------------------------------------------ dgrad
// grid = (splits, ceil(K / BK), ceil(M / BM)) for a tile of BM rows of M by
// BK columns of K (kernel.py's dgrad_plan: 64 x 128, 64 x 64 or 32 x 32);
// 8 warps at 64 rows, else 4.  Split s covers columns [s *
// chunk, min(N, (s + 1) * chunk)) of g and W; with more than one split, the
// splits of one output tile are one thread-block cluster (blockIdx.x is
// the rank).
//
// Each 32-column step of N goes through a three-stage cp.async ring in
// shared memory: g, y (not for a linear layer: act' = 1) and W's rows land
// there raw, zero past M, K or the split's end, two steps ahead of their
// use (16-byte copies where N's rows allow, else element by element).  When
// a step has landed, the block forms s = g * act'(y) once per staged
// element and leaves it in place, split: g's rows become s_hi and y's s_lo
// (one more barrier; formed as the fragments were read, each element was
// converted by every warp that reads it, and the warps, one or two a
// scheduler, waited on that chain).  Both operands are contiguous along N,
// the contraction, which is what mma.sync's row.col layout wants, so
// nothing is transposed:
//  * bfloat16: s as bfloat16 s_hi + s_lo (about 16 mantissa bits), W as it
//    is (exact), both by ldmatrix; each m16n8k16 tile adds s_lo W + s_hi W;
//  * float32: s as TF32 hi + lo, W cut into hi + lo as it is read; each
//    m16n8k8 tile adds lo.hi + hi.lo + hi.hi (3xTF32, the products of
//    flash_fwd.cu), dropping only lo.lo.
// The warps form a 2 x 4, 4 x 2 or 2 x 2 grid over the tile, each owning a
// sub-tile of 16 x 8 tensor-core tiles.  With one split the block writes
// its dx tile.  With more, each block leaves its float32 partial tile in
// its own shared memory (where the ring was); after cluster.sync() block r
// adds, through distributed shared memory, the partials of ranks 0, 1, ..
// in that order for the r-th slice of the tile and stores it: one launch,
// no partial sums in device memory, and the same bits every call.
constexpr int kDgStepN = 32;             // columns of N a ring stage holds
constexpr int kDgStages = 3;
constexpr int kDgMaxCluster = 8;         // the portable cluster size

template <int BM, int BK>
struct DgGeom {
  // Warps: 2 x 4 at 64 x 128, 4 x 2 at 64 x 64, 2 x 2 at 32 x 32.
  static constexpr int kWarpsM = BM == 64 && BK == 64 ? 4 : 2;
  static constexpr int kWarpsK = BK == 128 ? 4 : 2;
  static constexpr int kThreads = 32 * kWarpsM * kWarpsK;
  static constexpr int kWM = BM / kWarpsM;               // warp sub-tile
  static constexpr int kWK = BK / kWarpsK;
  static constexpr int kMI = kWM / 16;
  static constexpr int kNJ = kWK / 8;
  static_assert(kWM % 16 == 0 && kWK % 16 == 0, "warp sub-tile");
  // Row pitches: float32 rows of 32 + 4 (the 3xTF32 fragment reads, row g
  // column t, fall in 32 distinct banks); bfloat16 rows of 32 + 8 (80
  // bytes: the 8 rows of an ldmatrix fall in distinct 16-byte bank groups).
  static constexpr int kPitchF = kDgStepN + 4;
  static constexpr int kPitchH = kDgStepN + 8;
  static constexpr int kStageF = (2 * BM + BK) * kPitchF * 4;   // bytes
  static constexpr int kStageH = (2 * BM + BK) * kPitchH * 2;
  static constexpr int kPartPitch = BK + 4;
  static constexpr int kPart = BM * kPartPitch * 4;
  // The ring, then (with splits) the partial tile in its place.
  static constexpr int kBytesF =
      kDgStages * kStageF > kPart ? kDgStages * kStageF : kPart;
  static constexpr int kBytesH =
      kDgStages * kStageH > kPart ? kDgStages * kStageH : kPart;
};

// x = hi + lo: hi is x cut to TF32 (the low 13 bits zero); lo = x - hi is
// exact in float32 and goes to the tensor core as it is (it reads the top
// 19 bits), as in flash_fwd.cu.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* smem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

// Rows [row0, row0 + R) by columns [n0, n0 + 32) of a row-major (.., N)
// operand into shared rows of kPitch, zero at rows >= row_end or columns
// >= n_end.  vec: 16-byte cp.async copies (the operand and its rows are
// aligned to them, and n_end, a multiple of 32 or N, cuts no copy); else
// element by element.
template <typename T, int R, int kPitch, int kThr>
__device__ __forceinline__ void dgrad_stage(T* dst, const T* __restrict__ src,
                                            int N, int row0, int row_end,
                                            int n0, int n_end, bool vec,
                                            int tid) {
  if (vec) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(T));
    constexpr int kRow = kDgStepN / kPer;                 // copies a row
    for (int q = tid; q < R * kRow; q += kThr) {
      const int r = q / kRow, c = (q % kRow) * kPer;
      const bool live = row0 + r < row_end && n0 + c < n_end;
      cp_async<16>(dst + r * kPitch + c,
                   live ? src + static_cast<long long>(row0 + r) * N + n0 + c
                        : src,
                   live ? 16 : 0);
    }
    return;
  }
  for (int e = tid; e < R * kDgStepN; e += kThr) {
    const int r = e / kDgStepN, c = e % kDgStepN;
    dst[r * kPitch + c] =
        row0 + r < row_end && n0 + c < n_end
            ? src[static_cast<long long>(row0 + r) * N + n0 + c]
            : from_f32<T>(0.f);
  }
}

template <typename T, int BM, int BK, bool kSplit>
__global__ void __launch_bounds__(DgGeom<BM, BK>::kThreads)
    dgrad_kernel(const T* __restrict__ g, const T* __restrict__ y,
                 const T* __restrict__ w, T* __restrict__ dx, int M, int K,
                 int N, int chunk, int vec, int act, float slope) {
  using G = DgGeom<BM, BK>;
  constexpr bool kF32 = std::is_same_v<T, float>;
  constexpr int kPitch = kF32 ? G::kPitchF : G::kPitchH;
  constexpr int kStage = kF32 ? G::kStageF : G::kStageH;
  extern __shared__ __align__(16) unsigned char dg_smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int m0 = blockIdx.z * BM;
  const int n_begin = split * chunk;
  const int n_end = min(N, n_begin + chunk);
  const int steps = (n_end - n_begin + kDgStepN - 1) / kDgStepN;
  const int wm0 = (warp / G::kWarpsK) * G::kWM;
  const int wk0 = (warp % G::kWarpsK) * G::kWK;
  const bool use_y = act != kLinear;     // linear: act' = 1 whatever y is
  const int gq = lane >> 2, tq = lane & 3;      // mma groupID, thread in group
  const int lr = lane & 7, lm = lane >> 3;      // ldmatrix row, matrix

  auto stage = [&](int slot, int step) {
    T* gs = reinterpret_cast<T*>(dg_smem + slot * kStage);
    T* ys = gs + BM * kPitch;
    T* ws = ys + BM * kPitch;
    const int nb = n_begin + step * kDgStepN;
    dgrad_stage<T, BM, kPitch, G::kThreads>(gs, g, N, m0, M, nb, n_end, vec,
                                            tid);
    if (use_y)
      dgrad_stage<T, BM, kPitch, G::kThreads>(ys, y, N, m0, M, nb, n_end,
                                              vec, tid);
    dgrad_stage<T, BK, kPitch, G::kThreads>(ws, w, N, k0, K, nb, n_end, vec,
                                            tid);
  };

  float acc[G::kMI][G::kNJ][4];
#pragma unroll
  for (int i = 0; i < G::kMI; ++i)
#pragma unroll
    for (int j = 0; j < G::kNJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kDgStages - 1; ++s) {
    if (s < steps) stage(s, s);
    cp_async_commit();                   // one group per step, empty or not
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait_prior();               // this step's group has landed
    __syncthreads();                     // ... for every thread
    T* const sh = reinterpret_cast<T*>(dg_smem + (step % kDgStages) * kStage);
    T* const sl = sh + BM * kPitch;
    const T* const ws = sl + BM * kPitch;
    // s = g * act'(y), once per staged element, in place: g's rows become
    // s_hi and y's rows s_lo (TF32 parts as float32 bits, or bfloat16).
    if constexpr (kF32) {
      for (int e = tid; e < BM * kDgStepN; e += G::kThreads) {
        const int o = (e / kDgStepN) * kPitch + e % kDgStepN;
        float v = sh[o];
        if (use_y) v *= activation_grad(sl[o], act, slope);
        uint32_t hi, lo;
        split_tf32(v, hi, lo);
        sh[o] = __uint_as_float(hi);
        sl[o] = __uint_as_float(lo);
      }
    } else {
      constexpr int kPairs = kDgStepN / 2;
      for (int e = tid; e < BM * kPairs; e += G::kThreads) {
        const int o = (e / kPairs) * kPitch + (e % kPairs) * 2;
        const __nv_bfloat162 g2 = *reinterpret_cast<const __nv_bfloat162*>(sh + o);
        float s0 = __low2float(g2), s1 = __high2float(g2);
        if (use_y) {
          const __nv_bfloat162 y2 =
              *reinterpret_cast<const __nv_bfloat162*>(sl + o);
          s0 *= activation_grad(__low2float(y2), act, slope);
          s1 *= activation_grad(__high2float(y2), act, slope);
        }
        uint32_t hi, lo;
        split_bf16x2(s0, s1, hi, lo);
        *reinterpret_cast<uint32_t*>(sh + o) = hi;
        *reinterpret_cast<uint32_t*>(sl + o) = lo;
      }
    }
    __syncthreads();                     // s is in place; the slot refilled
    if (step + kDgStages - 1 < steps)    // below was read a step ago
      stage((step + kDgStages - 1) % kDgStages, step + kDgStages - 1);
    cp_async_commit();
    if constexpr (kF32) {
#pragma unroll
      for (int ks = 0; ks < kDgStepN; ks += 8) {
        uint32_t ah[G::kMI][4], al[G::kMI][4];
#pragma unroll
        for (int i = 0; i < G::kMI; ++i) {
          // a0..a3: (row g, col t), (g + 8, t), (g, t + 4), (g + 8, t + 4).
          const int o = (wm0 + 16 * i + gq) * kPitch + ks + tq;
          const int at[4] = {o, o + 8 * kPitch, o + 4, o + 8 * kPitch + 4};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ah[i][e] = __float_as_uint(sh[at[e]]);
            al[i][e] = __float_as_uint(sl[at[e]]);
          }
        }
#pragma unroll
        for (int j = 0; j < G::kNJ; ++j) {
          // b0, b1: (k t, n g), (k t + 4, n g); W's row is n.
          const float* q = ws + (wk0 + 8 * j + gq) * kPitch + ks + tq;
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(q[0], bh0, bl0);
          split_tf32(q[4], bh1, bl1);
#pragma unroll
          for (int i = 0; i < G::kMI; ++i) {
            mma_tf32(acc[i][j], al[i], bh0, bh1);
            mma_tf32(acc[i][j], ah[i], bl0, bl1);
            mma_tf32(acc[i][j], ah[i], bh0, bh1);
          }
        }
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < kDgStepN; ks += 16) {
        // A matrices: (rows 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15), (8-15,
        // 8-15); lane l addresses row l & 7 of matrix l >> 3.
        uint32_t ah[G::kMI][4], al[G::kMI][4];
#pragma unroll
        for (int i = 0; i < G::kMI; ++i) {
          const int off = (wm0 + 16 * i + lr + (lm & 1) * 8) * kPitch + ks +
                          (lm >> 1) * 8;
          ldsm_x4(ah[i], sh + off);
          ldsm_x4(al[i], sl + off);
        }
#pragma unroll
        for (int jp = 0; jp < G::kNJ / 2; ++jp) {
          // B matrices: (n-tile 2jp, k 0-7), (2jp, k 8-15), (2jp + 1, k
          // 0-7), (2jp + 1, k 8-15).
          const int off = (wk0 + 16 * jp + lr + (lm >> 1) * 8) * kPitch + ks +
                          (lm & 1) * 8;
          uint32_t b[4];
          ldsm_x4(b, ws + off);
          const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
#pragma unroll
          for (int i = 0; i < G::kMI; ++i) {
            mma_bf16(acc[i][2 * jp], al[i], b0);
            mma_bf16(acc[i][2 * jp], ah[i], b0);
            mma_bf16(acc[i][2 * jp + 1], al[i], b1);
            mma_bf16(acc[i][2 * jp + 1], ah[i], b1);
          }
        }
      }
    }
  }

  if constexpr (!kSplit) {
    const bool even = (K & 1) == 0;
#pragma unroll
    for (int i = 0; i < G::kMI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm0 + 16 * i + gq + 8 * h;
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < G::kNJ; ++j) {
          const int k = k0 + wk0 + 8 * j + 2 * tq;
          if (k >= K) continue;
          store2(dx, static_cast<long long>(m) * K + k, acc[i][j][2 * h],
                 acc[i][j][2 * h + 1], even, k + 1 < K);
        }
      }
  } else {
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    float* part = reinterpret_cast<float*>(dg_smem);
    cp_async_wait_all();                 // only empty groups are left
    __syncthreads();                     // the ring is read
#pragma unroll
    for (int i = 0; i < G::kMI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < G::kNJ; ++j)
          *reinterpret_cast<float2*>(
              part + (wm0 + 16 * i + gq + 8 * h) * G::kPartPitch + wk0 +
              8 * j + 2 * tq) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
    cluster.sync();                      // every partial tile is written
    const int rank = static_cast<int>(cluster.block_rank());
    const int ranks = static_cast<int>(cluster.num_blocks());
    constexpr int kQuads = BK / 4;
    constexpr int kAll = BM * kQuads;
    const int q_end = (rank + 1) * kAll / ranks;
    const bool vec4 = (K & 3) == 0;
    for (int q = rank * kAll / ranks + tid; q < q_end; q += G::kThreads) {
      const int row = q / kQuads, c = (q % kQuads) * 4;
      const int m = m0 + row, k = k0 + c;
      float t[4] = {0.f, 0.f, 0.f, 0.f};
      for (int s = 0; s < ranks; ++s) {    // in split order
        const float4 v = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(part, s) + row * G::kPartPitch + c);
        t[0] += v.x, t[1] += v.y, t[2] += v.z, t[3] += v.w;
      }
      if (m >= M || k >= K) continue;
      const long long off = static_cast<long long>(m) * K + k;
      if (vec4)
        Store4<T, true>::run(dx, off, k, K, t);
      else
        Store4<T, false>::run(dx, off, k, K, t);
    }
    cluster.sync();                      // no block leaves while read
  }
}

template <typename T, int BM, int BK>
cudaError_t launch_dgrad_tile(const void* g, const void* y, const void* w,
                              void* dx, int M, int K, int N, int splits,
                              int chunk, int vec, int act, float slope,
                              cudaStream_t stream) {
  using G = DgGeom<BM, BK>;
  constexpr int bytes = std::is_same_v<T, float> ? G::kBytesF : G::kBytesH;
  const auto kernel = splits == 1 ? dgrad_kernel<T, BM, BK, false>
                                  : dgrad_kernel<T, BM, BK, true>;
  static bool configured = false;        // once per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        dgrad_kernel<T, BM, BK, false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(dgrad_kernel<T, BM, BK, true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  if (splits > kDgMaxCluster) return cudaErrorInvalidValue;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(splits, (K + BK - 1) / BK, (M + BM - 1) / BM);
  config.blockDim = dim3(G::kThreads);
  config.dynamicSmemBytes = bytes;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;     // the splits of a tile: one cluster
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = splits > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&config, kernel, static_cast<const T*>(g),
                            static_cast<const T*>(y), static_cast<const T*>(w),
                            static_cast<T*>(dx), M, K, N, chunk, vec, act,
                            slope);
}

template <typename T>
cudaError_t launch_dgrad(const void* g, const void* y, const void* w,
                         void* dx, int M, int K, int N, int tile_m,
                         int tile_k, int splits, int chunk, int vec, int act,
                         float slope, cudaStream_t stream) {
  if (tile_m == 64 && tile_k == 128)
    return launch_dgrad_tile<T, 64, 128>(g, y, w, dx, M, K, N, splits, chunk,
                                         vec, act, slope, stream);
  if (tile_m == 64 && tile_k == 64)
    return launch_dgrad_tile<T, 64, 64>(g, y, w, dx, M, K, N, splits, chunk,
                                        vec, act, slope, stream);
  if (tile_m == 32 && tile_k == 32)
    return launch_dgrad_tile<T, 32, 32>(g, y, w, dx, M, K, N, splits, chunk,
                                        vec, act, slope, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
struct WgradKernel;
template <>
struct WgradKernel<float> {
  template <int kTile>
  static constexpr auto get() { return wgrad_fma_kernel<kTile>; }
};
template <>
struct WgradKernel<__nv_bfloat16> {
  template <int kTile>
  static constexpr auto get() { return wgrad_mma_kernel<kTile>; }
};

template <typename T, int kTile>
cudaError_t launch_wgrad_tile(const void* x, const void* g, const void* y,
                              void* dw, void* db, float* partial,
                              float* db_partial, int M, int K, int N,
                              int splits, int chunk, int x_bytes, int gy_bytes,
                              int act, float slope, cudaStream_t stream) {
  constexpr auto kernel = WgradKernel<T>::template get<kTile>();
  constexpr int bytes = WgGeom<kTile>::kSmem(static_cast<int>(sizeof(T)));
  static bool configured = false;        // once per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((N + kTile - 1) / kTile, (K + kTile - 1) / kTile, splits);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const T*>(y), static_cast<T*>(dw), static_cast<T*>(db),
      splits > 1 ? partial : nullptr, db_partial, M, K, N, chunk, x_bytes,
      gy_bytes, act, slope);
  if (splits == 1) return cudaSuccess;
  const long long kn = static_cast<long long>(K) * N;
  const unsigned blocks =
      static_cast<unsigned>((kn + N + kSumCols - 1) / kSumCols);
  wgrad_sum_kernel<T><<<blocks, kThreads, 0, stream>>>(
      partial, db_partial, static_cast<T*>(dw), static_cast<T*>(db), kn, N,
      splits);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_wgrad(const void* x, const void* g, const void* y,
                         void* dw, void* db, float* partial,
                         float* db_partial, int M, int K, int N, int tile,
                         int splits, int chunk, int x_bytes, int gy_bytes,
                         int act, float slope, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, float>) {
    if (tile == 128) {                   // never split (kernel.py's plan)
      if (splits != 1) return cudaErrorInvalidValue;
      const dim3 grid((N + kFmaTile - 1) / kFmaTile,
                      (K + kFmaTile - 1) / kFmaTile);
      auto kernel = N % 4 == 0 ? wgrad_fma128_kernel<true>
                               : wgrad_fma128_kernel<false>;
      kernel<<<grid, kThreads, 0, stream>>>(
          static_cast<const float*>(x), static_cast<const float*>(g),
          static_cast<const float*>(y), static_cast<float*>(dw),
          static_cast<float*>(db), M, K, N, act, slope);
      return cudaSuccess;
    }
  } else {
    if (tile == 128)
      return launch_wgrad_tile<T, 128>(x, g, y, dw, db, partial, db_partial,
                                       M, K, N, splits, chunk, x_bytes,
                                       gy_bytes, act, slope, stream);
  }
  if (tile == 64)
    return launch_wgrad_tile<T, 64>(x, g, y, dw, db, partial, db_partial, M,
                                    K, N, splits, chunk, x_bytes, gy_bytes,
                                    act, slope, stream);
  if (tile == 32)
    return launch_wgrad_tile<T, 32>(x, g, y, dw, db, partial, db_partial, M,
                                    K, N, splits, chunk, x_bytes, gy_bytes,
                                    act, slope, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after its launches (0 on success).
// tile_m x tile_k: one of the dgrad tiles; splits <= 8 (one cluster a
// tile); vec: g, y, W and their rows of N are 16-byte aligned.
int mrsch_fused_mlp_dgrad(const void* g, const void* y, const void* w,
                          void* dx, int M, int K, int N, int tile_m,
                          int tile_k, int splits, int chunk, int vec, int act,
                          float slope, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kFloat32)
    err = launch_dgrad<float>(g, y, w, dx, M, K, N, tile_m, tile_k, splits,
                              chunk, vec, act, slope, s);
  else if (dtype == kBFloat16)
    err = launch_dgrad<__nv_bfloat16>(g, y, w, dx, M, K, N, tile_m, tile_k,
                                      splits, chunk, vec, act, slope, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// db may be null: then only dW is written.  partial (splits, K, N) and
// db_partial (splits, N), float32, are used only when splits > 1.  tile:
// 128, 64 or 32.  x_bytes and gy_bytes: the cp.async chunk (16, 8 or 4) the
// rows of x and of g and y are aligned to, or 0 to stage them element by
// element.
int mrsch_fused_mlp_wgrad(const void* x, const void* g, const void* y,
                          void* dw, void* db, void* partial, void* db_partial,
                          int M, int K, int N, int tile, int splits,
                          int chunk, int x_bytes, int gy_bytes, int act,
                          float slope, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  float* dp = static_cast<float*>(db_partial);
  cudaError_t err;
  if (dtype == kFloat32)
    err = launch_wgrad<float>(x, g, y, dw, db, p, dp, M, K, N, tile, splits,
                              chunk, x_bytes, gy_bytes, act, slope, s);
  else if (dtype == kBFloat16)
    err = launch_wgrad<__nv_bfloat16>(x, g, y, dw, db, p, dp, M, K, N, tile,
                                      splits, chunk, x_bytes, gy_bytes, act,
                                      slope, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* mrsch_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
