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
// M, K and N edges are masked in the kernels.  Both kernels stage their
// operands in shared memory one step at a time and load the next step's
// operands into registers while the current step is computed, so a step's
// global loads are all in flight together and their latency overlaps the
// arithmetic.
//
// What bounds them, in DFP training (M = 64 rows per minibatch):
//
//  * wgrad is bound by operations: 2MKN FLOP against a contraction only M
//    long, with a large output (45.6 M elements, 182.6 MB float32, for the
//    11410 x 4000 layer: 87 us of float32 FMA at 67 TFLOP/s, 54 us of
//    writes).  Design: a register-tiled product.  Each block owns a 128 x
//    128 tile of dW; x[:, k-tile] and the act'-scaled g[:, n-tile] are staged
//    in shared memory 16 rows of M at a time; each thread accumulates an
//    8 x 8 micro-tile in registers (four 16-byte shared loads feed 64 FMAs)
//    and writes its part of dW exactly once, four columns per store; db is
//    summed over M in a fixed order by the blocks of the first K tile.
//  * dgrad is bound by operations at M = 64 (about 7.6 us for the 4000 x
//    1000 layer) and by W's bytes at small M.  Each dx[:, k] contracts along
//    the contiguous row k of W, the transpose of the forward's access.
//    Design: each block owns 64 rows of M by 64 columns of K and reads its
//    64 rows of W once (per 64 rows of M), whole 32-byte sectors of 4 rows
//    per warp load, transposing them into shared memory; the scaled g is staged
//    in N-chunks of 32 (the whole (64, 4000) scaled g, 1 MB, does not fit).
//    Each thread accumulates a 4 x 4 micro-tile.  When the K tiles alone
//    cannot fill the card (K = 4000 gives 63 tiles for 132 SMs), N is split
//    across blocks (grid.y); the float32 partial sums are added in split
//    order by a second small kernel, so results do not depend on scheduling.
//
// Plain C interface for ctypes; the wrapper (kernel.py) picks the split,
// allocates dx, dW, db and the partial buffer, and raises on a non-zero
// return.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// wgrad geometry: 16 x 16 threads, 8 x 8 outputs each.
constexpr int kWgTileK = 128;
constexpr int kWgTileN = 128;
constexpr int kWgStepM = 16;

// dgrad geometry: 16 x 16 threads, 4 x 4 outputs each.
constexpr int kDgTileM = 64;
constexpr int kDgTileK = 64;
constexpr int kDgStepN = 32;
constexpr int kDgPad = 4;  // keeps rows 16-byte aligned, spreads the banks

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
// grid = (ceil(N / 128), ceil(K / 128)); block = 256 threads.  Thread
// (tx, ty) = (tid % 16, tid / 16) owns rows {ty*4 .. +3, 64 + ty*4 .. +3}
// and columns {tx*4 .. +3, 64 + tx*4 .. +3} of the block's dW tile.  The
// blocks of the first K tile (blockIdx.y == 0) also sum the staged, scaled
// g over M into db, in a fixed order.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    wgrad_kernel(const T* __restrict__ x, const T* __restrict__ g,
                 const T* __restrict__ y, T* __restrict__ dw,
                 T* __restrict__ db, int M, int K, int N, int act,
                 float slope) {
  constexpr int kPer = kWgStepM * kWgTileK / kThreads;  // 8 per thread
  static_assert(kWgTileK == kWgTileN, "one staging map for x and g");
  __shared__ __align__(16) float xs[kWgStepM][kWgTileK];
  __shared__ __align__(16) float gs[kWgStepM][kWgTileN];

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int n0 = blockIdx.x * kWgTileN;
  const int k0 = blockIdx.y * kWgTileK;
  // Staging map: element r of this thread is row 2r + sr, column sc of the
  // stage; a warp reads 32 consecutive columns of one row.
  const int sc = tid & (kWgTileK - 1);
  const int sr = tid / kWgTileK;
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
  const bool with_db = db != nullptr && blockIdx.y == 0 && tid < kWgTileN;
  float db_acc = 0.f;

  load(0);
  for (int m0 = 0; m0 < M; m0 += kWgStepM) {
    // Rows past M and columns past K or N stage as zero.
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      xs[2 * r + sr][sc] = xr[r];
      gs[2 * r + sr][sc] = gr[r] * activation_grad(yr[r], act, slope);
    }
    __syncthreads();
    if (m0 + kWgStepM < M) load(m0 + kWgStepM);
    if (with_db) {
#pragma unroll
      for (int m = 0; m < kWgStepM; ++m) db_acc += gs[m][tid];
    }
#pragma unroll
    for (int m = 0; m < kWgStepM; ++m) {
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

// ------------------------------------------------------------------ dgrad
// grid = (ceil(K / 64), splits, ceil(M / 64)); block = 256 threads.  Split s
// covers columns [s * chunk, min(N, (s + 1) * chunk)) of g and W.  Thread
// (tk, tm) = (tid % 16, tid / 16) owns rows m0 + tm*4 .. +3 and columns
// k0 + tk*4 .. +3 of the block's dx tile.
template <typename T, bool kVec, bool kFused>
__global__ void __launch_bounds__(kThreads)
    dgrad_kernel(const T* __restrict__ g, const T* __restrict__ y,
                 const T* __restrict__ w, T* __restrict__ dx,
                 float* __restrict__ partial, int M, int K, int N, int chunk,
                 int act, float slope) {
  constexpr int kPer = kDgTileM * kDgStepN / kThreads;  // 8 per thread
  static_assert(kDgTileM == kDgTileK, "one staging map for g and W");
  __shared__ __align__(16) float gs[kDgStepN][kDgTileM + kDgPad];
  __shared__ __align__(16) float ws[kDgStepN][kDgTileK + kDgPad];

  const int tid = threadIdx.x;
  const int tk = tid & 15;
  const int tm = tid >> 4;
  const int k0 = blockIdx.x * kDgTileK;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * kDgTileM;
  const int n_begin = split * chunk;
  const int n_end = min(N, n_begin + chunk);
  // Staging map of a 64-row by 32-column tile (rows of g or of W, columns
  // of N): element r of this thread is row (tid / 8) + 32 (r / 4), column
  // (tid % 8) + 8 (r % 4).  A warp reads 8 consecutive columns (one 32-byte
  // sector) of each of 4 rows, and writes the transposed tile to shared
  // memory without bank conflicts.
  const int srow = tid >> 3;
  const int scol = tid & 7;

  float gr[kPer], yr[kPer], wr[kPer];
  auto load = [&](int nb) {
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int row = srow + 32 * (r >> 2);
      const int n = nb + scol + 8 * (r & 3);
      const bool n_live = n < n_end;
      const long long o = static_cast<long long>(m0 + row) * N + n;
      const bool g_live = n_live && m0 + row < M;
      gr[r] = g_live ? to_f32(g[o]) : 0.f;
      yr[r] = g_live ? to_f32(y[o]) : 0.f;
      wr[r] = (n_live && k0 + row < K)
                  ? to_f32(w[static_cast<long long>(k0 + row) * N + n])
                  : 0.f;
    }
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  load(n_begin);
  for (int nb = n_begin; nb < n_end; nb += kDgStepN) {
    // Stage (g * act'(y))[m0 : m0 + 64, nb : nb + 32) and W[k0 : k0 + 64,
    // nb : nb + 32), both transposed so the inner loop reads them along M
    // and K; entries past M, K or the split's end stage as zero.
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int row = srow + 32 * (r >> 2);
      const int col = scol + 8 * (r & 3);
      gs[col][row] = gr[r] * activation_grad(yr[r], act, slope);
      ws[col][row] = wr[r];
    }
    __syncthreads();
    if (nb + kDgStepN < n_end) load(nb + kDgStepN);
#pragma unroll
    for (int nn = 0; nn < kDgStepN; ++nn) {
      const float4 a = *reinterpret_cast<const float4*>(&gs[nn][tm * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[nn][tk * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const int c = k0 + tk * 4;
  if (c >= K) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + tm * 4 + i;
    if (m >= M) break;
    if (kFused) {
      Store4<T, kVec>::run(dx, static_cast<long long>(m) * K + c, c, K,
                           acc[i]);
    } else {
      Store4<float, kVec>::run(
          partial, (static_cast<long long>(split) * M + m) * K + c, c, K,
          acc[i]);
    }
  }
}

// dx[i] = sum_s partial[s][i], summed in split order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    splitk_sum_kernel(const float* __restrict__ partial, T* __restrict__ dx,
                      long long total, int splits) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int q = 0; q < splits; ++q) s += partial[q * total + i];
  dx[i] = from_f32<T>(s);
}

template <typename T, bool kVec>
void launch_dgrad_main(const T* g, const T* y, const T* w, T* dx,
                       float* partial, int M, int K, int N, int splits,
                       int chunk, int act, float slope, cudaStream_t stream) {
  const dim3 grid((K + kDgTileK - 1) / kDgTileK, splits,
                  (M + kDgTileM - 1) / kDgTileM);
  if (splits == 1)
    dgrad_kernel<T, kVec, true><<<grid, kThreads, 0, stream>>>(
        g, y, w, dx, partial, M, K, N, chunk, act, slope);
  else
    dgrad_kernel<T, kVec, false><<<grid, kThreads, 0, stream>>>(
        g, y, w, dx, partial, M, K, N, chunk, act, slope);
}

template <typename T>
void launch_dgrad(const void* g, const void* y, const void* w, void* dx,
                  float* partial, int M, int K, int N, int splits, int chunk,
                  int vec, int act, float slope, cudaStream_t stream) {
  const T* gt = static_cast<const T*>(g);
  const T* yt = static_cast<const T*>(y);
  const T* wt = static_cast<const T*>(w);
  T* dxt = static_cast<T*>(dx);
  if (vec)
    launch_dgrad_main<T, true>(gt, yt, wt, dxt, partial, M, K, N, splits,
                               chunk, act, slope, stream);
  else
    launch_dgrad_main<T, false>(gt, yt, wt, dxt, partial, M, K, N, splits,
                                chunk, act, slope, stream);
  if (splits > 1) {
    const long long total = static_cast<long long>(M) * K;
    const unsigned blocks =
        static_cast<unsigned>((total + kThreads - 1) / kThreads);
    splitk_sum_kernel<T><<<blocks, kThreads, 0, stream>>>(partial, dxt,
                                                          total, splits);
  }
}

template <typename T>
void launch_wgrad(const void* x, const void* g, const void* y, void* dw,
                  void* db, int M, int K, int N, int vec, int act,
                  float slope, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  const T* yt = static_cast<const T*>(y);
  T* dwt = static_cast<T*>(dw);
  T* dbt = static_cast<T*>(db);
  const dim3 grid((N + kWgTileN - 1) / kWgTileN, (K + kWgTileK - 1) / kWgTileK);
  if (vec)
    wgrad_kernel<T, true><<<grid, kThreads, 0, stream>>>(xt, gt, yt, dwt, dbt,
                                                         M, K, N, act, slope);
  else
    wgrad_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        xt, gt, yt, dwt, dbt, M, K, N, act, slope);
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after its launches (0 on success).
int mrsch_fused_mlp_dgrad(const void* g, const void* y, const void* w,
                          void* dx, void* partial, int M, int K, int N,
                          int splits, int chunk, int vec, int act, float slope,
                          int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  if (dtype == kFloat32)
    launch_dgrad<float>(g, y, w, dx, p, M, K, N, splits, chunk, vec, act,
                        slope, s);
  else if (dtype == kBFloat16)
    launch_dgrad<__nv_bfloat16>(g, y, w, dx, p, M, K, N, splits, chunk, vec,
                                act, slope, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// db may be null: then only dW is written.
int mrsch_fused_mlp_wgrad(const void* x, const void* g, const void* y,
                          void* dw, void* db, int M, int K, int N, int vec,
                          int act, float slope, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    launch_wgrad<float>(x, g, y, dw, db, M, K, N, vec, act, slope, s);
  else if (dtype == kBFloat16)
    launch_wgrad<__nv_bfloat16>(x, g, y, dw, db, M, K, N, vec, act, slope,
                                s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

const char* mrsch_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
