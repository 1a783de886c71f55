// Fused dense layer forward for Hopper (sm_90a):  y = act(x @ W + b).
//
// Replaces the TPU kernel `fused_mlp_layer` (`_fused_mlp_kernel`) in
// src/repro/kernels/fused_mlp/kernel.py.  Shapes: x (M, K), W (K, N) with N
// contiguous (the JAX package's (in, out) layout), b (N,), y (M, N); float32
// or bfloat16 in and out, float32 accumulation on the CUDA cores, bias +
// activation in the epilogue.  The TPU design (128x256x512 MXU tiles, W
// padded to block multiples on every call) does not carry over.  Two
// kernels, chosen by M (kernel.forward_plan):
//
// fused_mlp_fwd_kernel, M <= 16 (the decision service's padded batches).
// What bounds it: the bytes of W.  The DFP network runs it with K up to
// 11410 and N up to 4000, so every forward streams W once: 182.6 MB for
// the first state layer alone, against about 1.5 GFLOP at M = 16, far
// below the card's ridge point.  So it:
//  * reads W exactly once, never padded: each lane loads four consecutive
//    columns of a row (one 16-byte load for float32), so a warp reads 512
//    contiguous bytes of a row; ragged N and M edges are masked in the
//    kernel;
//  * keeps all M rows of the output tile in registers (MT x 4 per lane), so
//    one W load feeds MT * 4 FMAs;
//  * stages x in shared memory as float32, 256 rows of K at a time; the
//    eight warps of a block share one column tile and take 4 consecutive K
//    rows each per step, so x comes out of shared memory as float4
//    broadcasts and each lane keeps four W loads in flight.
//
// fused_mlp_fwd_m64_kernel, M > 16 (the device engine's and training's
// M = 64, the attention encoder's M up to 8,256).  What bounds it: the
// float32 FMA rate.  At M = 64 the 11410 x 4000 layer does 5.8 GFLOP on
// 182.6 MB of W: 87 us at 67 TFLOP/s against 55 us of bytes.  The M <= 16
// kernel would run four 16-row tiles there, each streaming W again (730
// MB).  This one:
//  * gives a block 64 rows of x and 128 columns of W, so W is read once for
//    up to 64 rows; 256 threads, thread (warp w, lane) holding rows
//    8w..8w+7 and columns 4 lane..4 lane+3 (an 8 x 4 micro-tile): per 4
//    rows of K, eight float4 broadcasts of x and four float4 loads of W
//    from shared memory feed 128 FMAs;
//  * streams x and W through a three-stage cp.async ring of 32 rows of K
//    (the widest 16, 8 or 4-byte copy the rows are aligned to; bfloat16
//    staged as it is and widened as it leaves shared memory); a stage
//    holds only the rows of K the layer has, rounded up to 4 (zero past
//    K), so K = 4 stages 4 rows, not 32 or 256; rows past M and columns
//    past N are zero.
//
// Both kernels split K across blocks (grid.y) when the column tiles and M
// tiles alone cannot fill the card (N = 4000 gives 32 tiles of 128 columns
// for 132 SMs): the M > 16 kernel into as many ranges as one wave of two
// blocks per SM holds (8 for that layer: 256 blocks), since a partial
// second wave costs a whole block's time.  The float32 partial sums
// (splits x M x N, a few MB that stay in L2) are added in a fixed order by
// a second small kernel that applies bias and activation, so results do
// not depend on scheduling.  With one split the epilogue runs in the main
// kernel.
//
// Plain C interface for ctypes; the wrapper (kernel.py) picks the kernel,
// the split and the copy widths, allocates y and the partial buffer, and
// raises on a non-zero return.

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

// ------------------------------------------------------------- M > 16
constexpr int kTileM64 = 64;   // rows of x per block
constexpr int kRingK = 32;     // rows of K a ring stage holds
constexpr int kRingStages = 3;

constexpr int kStageElems = kTileM64 * kRingK + kRingK * kTileN;  // x, W

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
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Rows [r0, r0 + rows) by columns [c0, c0 + kCols) of a (.., ld) operand
// into shared rows of kCols elements, zero where the row is at or past
// r_end or the column at or past c_end, in chunks of `bytes` (16, 8 or 4:
// ld, c0 and c_end are multiples of the chunk, so a chunk lies wholly
// inside or outside); bytes = 0 stages element by element.
template <typename T, int kCols>
__device__ __forceinline__ void stage_box(T* dst, const T* __restrict__ src,
                                          long long ld, int r0, int rows,
                                          int r_end, int c0, int c_end,
                                          int bytes, int tid) {
  if (bytes == 0) {
    for (int e = tid; e < rows * kCols; e += kThreads) {
      const int r = e / kCols, c = e % kCols;
      const bool live = r0 + r < r_end && c0 + c < c_end;
      dst[r * kCols + c] = live ? src[(r0 + r) * ld + c0 + c]
                                : from_f32<T>(0.f);
    }
    return;
  }
  const int per = bytes / static_cast<int>(sizeof(T));  // elements a chunk
  const int shift = __ffs(kCols / per) - 1;              // log2 chunks a row
  for (int e = tid; e < (rows << shift); e += kThreads) {
    const int r = e >> shift, c = (e & ((1 << shift) - 1)) * per;
    const bool live = r0 + r < r_end && c0 + c < c_end;
    const T* from = live ? src + (r0 + r) * ld + c0 + c : src;
    T* to = dst + r * kCols + c;
    const int n = live ? bytes : 0;
    if (bytes == 16)
      cp_async<16>(to, from, n);
    else if (bytes == 8)
      cp_async<8>(to, from, n);
    else
      cp_async<4>(to, from, n);
  }
}

// Four consecutive elements of shared memory as float32.
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 lds4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// acc += x[rows][kk, kk + 4) W[kk, kk + 4)[cols]: eight float4 broadcasts
// of x (the warp's rows) and four float4 loads of W feed 128 FMAs.
template <typename T>
__device__ __forceinline__ void m64_k4(float (&acc)[8][4], const T* xs,
                                       const T* ws, int kk, int warp,
                                       int lane) {
  float4 xv[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) xv[i] = lds4(xs + (8 * warp + i) * kRingK + kk);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float4 wv = lds4(ws + (kk + u) * kTileN + 4 * lane);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float xr = u == 0 ? xv[i].x : u == 1 ? xv[i].y
                     : u == 2 ? xv[i].z : xv[i].w;
      acc[i][0] = fmaf(xr, wv.x, acc[i][0]);
      acc[i][1] = fmaf(xr, wv.y, acc[i][1]);
      acc[i][2] = fmaf(xr, wv.z, acc[i][2]);
      acc[i][3] = fmaf(xr, wv.w, acc[i][3]);
    }
  }
}

// grid = (ceil(N / 128), splits, ceil(M / 64)); block = 256 threads.
// Split s covers K rows [s * chunk, min(K, (s + 1) * chunk)); chunk is a
// multiple of kRingK.
template <typename T, bool kFused>
__global__ void __launch_bounds__(kThreads, 2)
    fused_mlp_fwd_m64_kernel(const T* __restrict__ x, const T* __restrict__ w,
                             const T* __restrict__ b, T* __restrict__ y,
                             float* __restrict__ partial, int M, int K, int N,
                             int chunk, int x_bytes, int w_bytes, int vec,
                             int act, float slope) {
  extern __shared__ __align__(16) unsigned char m64_smem[];
  T* ring = reinterpret_cast<T*>(m64_smem);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * kTileN;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * kTileM64;
  const int k_begin = split * chunk;
  const int k_end = min(K, k_begin + chunk);
  const int steps = (k_end - k_begin + kRingK - 1) / kRingK;

  auto stage = [&](int step) {
    T* xs = ring + (step % kRingStages) * kStageElems;
    T* ws = xs + kTileM64 * kRingK;
    const int k0 = k_begin + step * kRingK;
    const int kt = (min(kRingK, k_end - k0) + 3) & ~3;
    stage_box<T, kRingK>(xs, x, K, m0, kTileM64, M, k0, k_end, x_bytes,
                         tid);
    stage_box<T, kTileN>(ws, w, N, k0, kt, k_end, n0, N, w_bytes, tid);
  };

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kRingStages - 1; ++s) {
    if (s < steps) stage(s);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kRingStages - 2>();
    __syncthreads();   // this step's stage is in; the last step's is free
    if (step + kRingStages - 1 < steps) stage(step + kRingStages - 1);
    cp_async_commit();
    const T* xs = ring + (step % kRingStages) * kStageElems;
    const T* ws = xs + kTileM64 * kRingK;
    const int k0 = k_begin + step * kRingK;
    const int kt = (min(kRingK, k_end - k0) + 3) & ~3;
    if (kt == kRingK) {
#pragma unroll
      for (int kk = 0; kk < kRingK; kk += 4)
        m64_k4<T>(acc, xs, ws, kk, warp, lane);
    } else {
#pragma unroll 1
      for (int kk = 0; kk < kt; kk += 4)
        m64_k4<T>(acc, xs, ws, kk, warp, lane);
    }
  }

  const int c = n0 + 4 * lane;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + 8 * warp + i;
    if (m >= M) break;
    if (kFused) {
      T* out = y + static_cast<long long>(m) * N;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < N)
          out[c + j] = from_f32<T>(activate(acc[i][j] + to_f32(b[c + j]), act,
                                            slope));
    } else {
      float* out = partial + (static_cast<long long>(split) * M + m) * N;
      if (vec && c < N) {
        *reinterpret_cast<float4*>(out + c) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < N) out[c + j] = acc[i][j];
      }
    }
  }
}

template <typename T>
cudaError_t launch_m64(const T* x, const T* w, const T* b, T* y,
                       float* partial, int M, int K, int N, int splits,
                       int chunk, int x_bytes, int w_bytes, int vec, int act,
                       float slope, cudaStream_t stream) {
  constexpr int bytes =
      kRingStages * kStageElems * static_cast<int>(sizeof(T));
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_mlp_fwd_m64_kernel<T, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fused_mlp_fwd_m64_kernel<T, false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((N + kTileN - 1) / kTileN, splits,
                  (M + kTileM64 - 1) / kTileM64);
  if (splits == 1)
    fused_mlp_fwd_m64_kernel<T, true><<<grid, kThreads, bytes, stream>>>(
        x, w, b, y, partial, M, K, N, chunk, x_bytes, w_bytes, vec, act,
        slope);
  else
    fused_mlp_fwd_m64_kernel<T, false><<<grid, kThreads, bytes, stream>>>(
        x, w, b, y, partial, M, K, N, chunk, x_bytes, w_bytes, vec, act,
        slope);
  return cudaSuccess;
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
cudaError_t launch(const void* x, const void* w, const void* b, void* y,
                   float* partial, int M, int K, int N, int splits, int chunk,
                   int m64, int x_bytes, int w_bytes, int vec, int act,
                   float slope, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* bt = static_cast<const T*>(b);
  T* yt = static_cast<T*>(y);
  if (m64) {
    const cudaError_t err =
        launch_m64<T>(xt, wt, bt, yt, partial, M, K, N, splits, chunk,
                      x_bytes, w_bytes, vec, act, slope, stream);
    if (err != cudaSuccess) return err;
  } else if (vec) {
    launch_tile_m<T, true>(xt, wt, bt, yt, partial, M, K, N, splits, chunk,
                           act, slope, stream);
  } else {
    launch_tile_m<T, false>(xt, wt, bt, yt, partial, M, K, N, splits, chunk,
                            act, slope, stream);
  }
  if (splits > 1) {
    const long long total = static_cast<long long>(M) * N;
    const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) /
                                                  kThreads);
    splitk_epilogue_kernel<T><<<blocks, kThreads, 0, stream>>>(
        partial, bt, yt, M, N, splits, act, slope);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// m64 = 0 runs the M <= 16 kernel (fused_mlp_fwd_kernel), m64 = 1 the M > 16
// one (fused_mlp_fwd_m64_kernel), which stages x and W by cp.async in chunks
// of x_bytes and w_bytes (16, 8, 4, or 0: element by element).  Returns
// cudaGetLastError() after the launches (0 on success).
int mrsch_fused_mlp_forward(const void* x, const void* w, const void* b,
                            void* y, void* partial, int M, int K, int N,
                            int splits, int chunk, int m64, int x_bytes,
                            int w_bytes, int vec, int act, float slope,
                            int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  cudaError_t err;
  if (dtype == kFloat32)
    err = launch<float>(x, w, b, y, p, M, K, N, splits, chunk, m64, x_bytes,
                        w_bytes, vec, act, slope, s);
  else if (dtype == kBFloat16)
    err = launch<__nv_bfloat16>(x, w, b, y, p, M, K, N, splits, chunk, m64,
                                x_bytes, w_bytes, vec, act, slope, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* mrsch_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
