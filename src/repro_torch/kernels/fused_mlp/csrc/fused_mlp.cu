// Fused dense layer forward for Hopper (sm_90a):  y = act(x @ W + b).
//
// Replaces the TPU kernel `fused_mlp_layer` (`_fused_mlp_kernel`) in
// src/repro/kernels/fused_mlp/kernel.py.  Shapes: x (M, K), W (K, N) with N
// contiguous (the JAX package's (in, out) layout), b (N,), y (M, N); float32
// or bfloat16 in and out, float32 accumulation, bias + activation in the
// epilogue.
//
// What bounds it: the bytes of W.  The DFP network that serves decisions
// runs it at skinny M (1..16, the padded service batch) with K up to 11410
// and N up to 4000, so every forward streams W once: 182.6 MB for the first
// state layer alone, against about 1.5 GFLOP at M = 16, far below the card's
// ridge point.  The TPU design (128x256x512 MXU tiles, W padded to block
// multiples on every call) does not carry over; this one:
//
//  * reads W exactly once per M tile, never padded: each lane loads four
//    consecutive columns of a row (one 16-byte load for float32), so a warp
//    reads 512 contiguous bytes of a row; ragged N and M edges are masked in
//    the kernel;
//  * keeps all M rows of the output tile in registers (MT x 4 per lane), so
//    one W load feeds MT * 4 FMAs;
//  * stages x in shared memory as float32, 256 rows of K at a time; the
//    eight warps of a block share one column tile and take 4 consecutive K
//    rows each per step, so x comes out of shared memory as float4
//    broadcasts and each lane keeps four W loads in flight;
//  * splits K across blocks (grid.y) when the column tiles alone cannot fill
//    the card (N = 4000 gives 32 tiles of 128 columns for 132 SMs); the
//    float32 partial sums (splits x M x N, a few MB that stay in L2) are
//    added in a fixed order by a second small kernel that applies bias and
//    activation, so results do not depend on scheduling.  With one split the
//    epilogue runs in the main kernel.
//  * M above 16 runs as several M tiles (grid.z), each re-reading W: correct,
//    not fast.
//
// Plain C interface for ctypes; the wrapper (kernel.py) picks the split,
// allocates y and the partial buffer, and raises on a non-zero return.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kColsPerLane = 4;
constexpr int kTileN = 32 * kColsPerLane;  // 128 columns per block
constexpr int kTileK = 256;                // rows of x staged per step
constexpr int kRowsPerWarpStep = 4;        // consecutive K rows per warp step
constexpr int kStepK = kWarps * kRowsPerWarpStep;  // 32 rows per block step
constexpr int kMaxTileM = 16;

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

__device__ __forceinline__ float activate(float y, int act, float slope) {
  switch (act) {
    case kLeakyRelu:
      return y >= 0.f ? y : slope * y;
    case kRelu:
      return fmaxf(y, 0.f);
    case kTanh:
      return tanhf(y);
    default:
      return y;
  }
}

// Four consecutive columns [c, c + 4) of one row of W, as float32.
// kVec: N % 4 == 0 and W 16-byte aligned, so the four are one aligned load
// and either all or none lie inside N (the caller skips c >= N).
template <typename T, bool kVec>
struct LoadW4;

template <>
struct LoadW4<float, true> {
  __device__ __forceinline__ static void run(const float* __restrict__ w,
                                             long long off, int, int,
                                             float (&v)[4]) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(w + off));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
};

template <>
struct LoadW4<__nv_bfloat16, true> {
  __device__ __forceinline__ static void run(
      const __nv_bfloat16* __restrict__ w, long long off, int, int,
      float (&v)[4]) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(w + off));
    const float2 lo =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 hi =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
    v[0] = lo.x;
    v[1] = lo.y;
    v[2] = hi.x;
    v[3] = hi.y;
  }
};

template <typename T>
struct LoadW4<T, false> {
  __device__ __forceinline__ static void run(const T* __restrict__ w,
                                             long long off, int c, int n,
                                             float (&v)[4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = (c + j < n) ? to_f32(w[off + j]) : 0.f;
  }
};

// grid = (ceil(N / 128), splits, ceil(M / MT)); block = 256 threads.
// Split s covers K rows [s * chunk, min(K, (s + 1) * chunk)).
template <typename T, int MT, bool kVec, bool kFused>
__global__ void __launch_bounds__(kThreads)
    fused_mlp_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                         const T* __restrict__ b, T* __restrict__ y,
                         float* __restrict__ partial, int M, int K, int N,
                         int chunk, int act, float slope) {
  __shared__ __align__(16) float xs[MT][kTileK];
  __shared__ __align__(16) float red[kWarps][kTileN];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * kTileN + lane * kColsPerLane;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  const int k_begin = split * chunk;
  const int k_end = min(K, k_begin + chunk);
  const bool col_live = c < N;

  float acc[MT][kColsPerLane];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) acc[m][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kTileK) {
    const int kt = min(kTileK, k_end - k0);
    // Stage x[m0 : m0 + MT, k0 : k0 + kt) as float32; rows past M and
    // columns past kt read as zero.
    for (int i = threadIdx.x; i < MT * kTileK; i += kThreads) {
      const int m = i / kTileK;
      const int kk = i - m * kTileK;
      float v = 0.f;
      if (m0 + m < M && kk < kt)
        v = to_f32(x[static_cast<long long>(m0 + m) * K + k0 + kk]);
      xs[m][kk] = v;
    }
    __syncthreads();

    if (col_live) {
      int kb = 0;
      for (; kb + kStepK <= kt; kb += kStepK) {
        const int kr = kb + warp * kRowsPerWarpStep;
        float wv[kRowsPerWarpStep][kColsPerLane];
#pragma unroll
        for (int u = 0; u < kRowsPerWarpStep; ++u)
          LoadW4<T, kVec>::run(
              w, static_cast<long long>(k0 + kr + u) * N + c, c, N, wv[u]);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float4 xv = *reinterpret_cast<const float4*>(&xs[m][kr]);
          const float xr[kRowsPerWarpStep] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int u = 0; u < kRowsPerWarpStep; ++u)
#pragma unroll
            for (int j = 0; j < kColsPerLane; ++j)
              acc[m][j] = fmaf(xr[u], wv[u][j], acc[m][j]);
        }
      }
      // Tail of the staged rows: one row per warp at a time.
      for (int kk = kb + warp; kk < kt; kk += kWarps) {
        float wv[kColsPerLane];
        LoadW4<T, kVec>::run(w, static_cast<long long>(k0 + kk) * N + c, c,
                             N, wv);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float xv = xs[m][kk];
#pragma unroll
          for (int j = 0; j < kColsPerLane; ++j)
            acc[m][j] = fmaf(xv, wv[j], acc[m][j]);
        }
      }
    }
    __syncthreads();
  }

  // Add the eight warps' sums of each output row in a fixed order.
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    *reinterpret_cast<float4*>(&red[warp][lane * kColsPerLane]) =
        make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    __syncthreads();
    if (threadIdx.x < kTileN) {
      const int col = blockIdx.x * kTileN + threadIdx.x;
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < kWarps; ++q) s += red[q][threadIdx.x];
      if (col < N && m0 + m < M) {
        if (kFused) {
          y[static_cast<long long>(m0 + m) * N + col] =
              from_f32<T>(activate(s + to_f32(b[col]), act, slope));
        } else {
          partial[(static_cast<long long>(split) * M + m0 + m) * N + col] = s;
        }
      }
    }
    __syncthreads();
  }
}

// y[i] = act(sum_s partial[s][i] + b[i % N]), summed in split order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    splitk_epilogue_kernel(const float* __restrict__ partial,
                           const T* __restrict__ b, T* __restrict__ y, int M,
                           int N, int splits, int act, float slope) {
  const long long total = static_cast<long long>(M) * N;
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int q = 0; q < splits; ++q) s += partial[q * total + i];
  y[i] = from_f32<T>(activate(s + to_f32(b[i % N]), act, slope));
}

template <typename T, int MT, bool kVec>
void launch_main(const T* x, const T* w, const T* b, T* y, float* partial,
                 int M, int K, int N, int splits, int chunk, int act,
                 float slope, cudaStream_t stream) {
  const dim3 grid((N + kTileN - 1) / kTileN, splits, (M + MT - 1) / MT);
  if (splits == 1) {
    fused_mlp_fwd_kernel<T, MT, kVec, true><<<grid, kThreads, 0, stream>>>(
        x, w, b, y, partial, M, K, N, chunk, act, slope);
  } else {
    fused_mlp_fwd_kernel<T, MT, kVec, false><<<grid, kThreads, 0, stream>>>(
        x, w, b, y, partial, M, K, N, chunk, act, slope);
  }
}

template <typename T, bool kVec>
void launch_tile_m(const T* x, const T* w, const T* b, T* y, float* partial,
                   int M, int K, int N, int splits, int chunk, int act,
                   float slope, cudaStream_t stream) {
  // The smallest power-of-two M tile that holds M, at most 16.
  if (M <= 1)
    launch_main<T, 1, kVec>(x, w, b, y, partial, M, K, N, splits, chunk, act,
                            slope, stream);
  else if (M <= 2)
    launch_main<T, 2, kVec>(x, w, b, y, partial, M, K, N, splits, chunk, act,
                            slope, stream);
  else if (M <= 4)
    launch_main<T, 4, kVec>(x, w, b, y, partial, M, K, N, splits, chunk, act,
                            slope, stream);
  else if (M <= 8)
    launch_main<T, 8, kVec>(x, w, b, y, partial, M, K, N, splits, chunk, act,
                            slope, stream);
  else
    launch_main<T, kMaxTileM, kVec>(x, w, b, y, partial, M, K, N, splits,
                                    chunk, act, slope, stream);
}

template <typename T>
void launch(const void* x, const void* w, const void* b, void* y,
            float* partial, int M, int K, int N, int splits, int chunk,
            int vec, int act, float slope, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* bt = static_cast<const T*>(b);
  T* yt = static_cast<T*>(y);
  if (vec)
    launch_tile_m<T, true>(xt, wt, bt, yt, partial, M, K, N, splits, chunk,
                           act, slope, stream);
  else
    launch_tile_m<T, false>(xt, wt, bt, yt, partial, M, K, N, splits, chunk,
                            act, slope, stream);
  if (splits > 1) {
    const long long total = static_cast<long long>(M) * N;
    const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) /
                                                  kThreads);
    splitk_epilogue_kernel<T><<<blocks, kThreads, 0, stream>>>(
        partial, bt, yt, M, N, splits, act, slope);
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launches (0 on success).
int mrsch_fused_mlp_forward(const void* x, const void* w, const void* b,
                            void* y, void* partial, int M, int K, int N,
                            int splits, int chunk, int vec, int act,
                            float slope, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  if (dtype == kFloat32)
    launch<float>(x, w, b, y, p, M, K, N, splits, chunk, vec, act, slope, s);
  else if (dtype == kBFloat16)
    launch<__nv_bfloat16>(x, w, b, y, p, M, K, N, splits, chunk, vec, act,
                          slope, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

const char* mrsch_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
