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
// bfloat16 (widened on load); all arithmetic is float32; y (B, S, H, P) is
// float32 or x's dtype.
//
// What bounds it: the FMA rate, and the parallelism of one block per
// (batch, head).  At zamba2-7b's prefill (B = 2, S = 4096, 112 heads of
// P = 64, N = 64, chunk 256) a call does ~50 GFLOP (the causal half of
// the 256 x 256 intra-chunk products) over 0.3 GB: ~0.75 ms at 67 TFLOP/s
// float32.  The TPU body holds the chunk's (256, 256) float32 score block
// at once (256 KB), more than the 227 KB a block may have here, so this
// version walks the chunk in 64 x 64 tiles, as flash attention walks keys:
//
//  * one block of 256 threads per (batch, head); the chunks run in order,
//    and h stays in shared memory (16 KB at N = 64, 32 KB at N = 128);
//  * for each tile of 64 query rows: C's tile (transposed) is loaded once,
//    the inter term C h is summed, then for each key tile at or below the
//    diagonal, B's tile (transposed) and x's tile are loaded, the 64 x 64
//    scores C B^T are masked (j <= i) and decayed in registers, staged in
//    shared memory, and multiplied into x;
//  * then the state update walks the chunk's key tiles once more, with B
//    scaled by exp(l_last - l_j) dt_j on load;
//  * each thread owns a 4 x 4 block of a score tile and 4 rows x P / 16
//    columns of y; rows N / 16 x P / 16 of h.
//
// Plain C interface for ctypes; the wrapper (kernel.py) allocates the
// output and raises on a non-zero return.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;             // rows of a query or key tile
constexpr int kPad = 4;            // row padding of the transposed tiles
constexpr int kThreads = 256;
constexpr int kMaxN = 128;         // largest state width
constexpr int kMaxNI = kMaxN / 16; // state rows per thread, at most
constexpr int kMaxChunk = 1024;    // longest chunk

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16(x);
}

struct Layout {                    // element strides of one operand
  int64_t batch, token;
};

int smem_bytes(int n, int p, int chunk) {
  return static_cast<int>(sizeof(float)) *
         (n * p + 2 * n * (kT + kPad) + kT * p + kT * (kT + kPad) +
          2 * chunk);
}

template <int P, typename T, typename O>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ lcum, const T* __restrict__ bm,
           const T* __restrict__ cm, O* __restrict__ y, int seq,
           int seq_pad, int heads, int groups, int n, int chunk, Layout xl,
           Layout bl, Layout cl) {
  static_assert(P % 16 == 0 && P <= 64, "P must be 16, 32, 48 or 64");
  constexpr int kCols = P / 16;
  extern __shared__ float smem[];
  float* hs = smem;                        // [n][P] state
  float* ct = hs + n * P;                  // [n][kT + kPad] C tile, transposed
  float* bt = ct + n * (kT + kPad);        // [n][kT + kPad] B tile, transposed
  float* xs = bt + n * (kT + kPad);        // [kT][P]
  float* ws = xs + kT * P;                 // [kT][kT + kPad] decayed scores
  float* ls = ws + kT * (kT + kPad);       // [chunk] l of the chunk
  float* dts = ls + chunk;                 // [chunk] dt of the chunk

  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  const int r0 = tr * 4, c0 = tc * 4;
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int g = h / (heads / groups);
  const T* xb = x + b * xl.batch + static_cast<int64_t>(h) * P;
  const T* bb = bm + b * bl.batch + static_cast<int64_t>(g) * n;
  const T* cb = cm + b * cl.batch + static_cast<int64_t>(g) * n;
  const int64_t y_row = static_cast<int64_t>(heads) * P;
  O* yb = y + static_cast<int64_t>(b) * seq * y_row + h * P;
  const float* dtb = dt + static_cast<int64_t>(b) * seq_pad * heads + h;
  const float* lb = lcum + static_cast<int64_t>(b) * seq_pad * heads + h;

  for (int e = tid; e < n * P; e += kThreads) hs[e] = 0.f;

  // Loads a (kT x n) tile of B or C, rows [t0, t0 + kT) of the chunk at
  // token c_start, transposed; rows past the chunk or the sequence are 0.
  // With `state_scale`, row j is scaled by exp(l_last - l_j) dt_j.
  auto load_t = [&](float* dst, const T* src, const Layout& lay, int c_start,
                    int t0, bool state_scale, float l_last) {
    for (int e = tid; e < kT * n; e += kThreads) {
      const int r = e / n, f = e % n;
      const int j = t0 + r, tok = c_start + j;
      float val = 0.f;
      if (j < chunk && tok < seq) {
        val = to_f(src[tok * lay.token + f]);
        if (state_scale) val = val * expf(l_last - ls[j]) * dts[j];
      }
      dst[f * (kT + kPad) + r] = val;
    }
  };
  auto load_x = [&](int c_start, int t0) {
    for (int e = tid; e < kT * P; e += kThreads) {
      const int r = e / P, f = e % P;
      const int j = t0 + r, tok = c_start + j;
      xs[r * P + f] =
          (j < chunk && tok < seq) ? to_f(xb[tok * xl.token + f]) : 0.f;
    }
  };

  const int n_tiles = (chunk + kT - 1) / kT;
  for (int c_start = 0; c_start < seq; c_start += chunk) {
    __syncthreads();               // the previous chunk's state is written
    for (int j = tid; j < chunk; j += kThreads) {
      const int64_t at = static_cast<int64_t>(c_start + j) * heads;
      ls[j] = lb[at];
      dts[j] = dtb[at];
    }
    __syncthreads();
    const float l_last = ls[chunk - 1];

    for (int qt = 0; qt < n_tiles; ++qt) {
      const int q0 = qt * kT;
      __syncthreads();             // ct of the previous tile is read
      load_t(ct, cb, cl, c_start, q0, false, 0.f);
      __syncthreads();

      // Inter-chunk term from the carried state: C_i . h.
      float inter[4][kCols], acc[4][kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < kCols; ++jj) inter[i][jj] = acc[i][jj] = 0.f;
      for (int f = 0; f < n; ++f) {
        const float4 ca =
            *reinterpret_cast<const float4*>(ct + f * (kT + kPad) + r0);
        const float cv[4] = {ca.x, ca.y, ca.z, ca.w};
#pragma unroll
        for (int jj = 0; jj < kCols; ++jj) {
          const float hv = hs[f * P + tc + 16 * jj];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            inter[i][jj] = fmaf(cv[i], hv, inter[i][jj]);
        }
      }

      // Intra-chunk term over the key tiles at or below the diagonal.
      for (int kt = 0; kt <= qt; ++kt) {
        const int k0 = kt * kT;
        __syncthreads();           // bt, xs and ws of the last tile are read
        load_t(bt, bb, bl, c_start, k0, false, 0.f);
        load_x(c_start, k0);
        __syncthreads();
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
        for (int f = 0; f < n; ++f) {
          const float4 ca =
              *reinterpret_cast<const float4*>(ct + f * (kT + kPad) + r0);
          const float4 ba =
              *reinterpret_cast<const float4*>(bt + f * (kT + kPad) + c0);
          const float cv[4] = {ca.x, ca.y, ca.z, ca.w};
          const float bv[4] = {ba.x, ba.y, ba.z, ba.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              s[i][jj] = fmaf(cv[i], bv[jj], s[i][jj]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = q0 + r0 + i;
          float w[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int kj = k0 + c0 + jj;
            w[jj] = (qi >= kj && qi < chunk)
                        ? s[i][jj] * expf(ls[qi] - ls[kj]) * dts[kj]
                        : 0.f;
          }
          *reinterpret_cast<float4*>(ws + (r0 + i) * (kT + kPad) + c0) =
              make_float4(w[0], w[1], w[2], w[3]);
        }
        __syncthreads();
        const int kn = min(kT, chunk - k0);
        for (int c = 0; c < kn; c += 4) {
          float4 wa[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            wa[i] = *reinterpret_cast<const float4*>(
                ws + (r0 + i) * (kT + kPad) + c);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            if (c + cc >= kn) break;
            const float* xr = xs + (c + cc) * P + tc;
#pragma unroll
            for (int jj = 0; jj < kCols; ++jj) {
              const float xv = xr[16 * jj];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const float wv = cc == 0 ? wa[i].x : cc == 1 ? wa[i].y
                               : cc == 2 ? wa[i].z : wa[i].w;
                acc[i][jj] = fmaf(wv, xv, acc[i][jj]);
              }
            }
          }
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = q0 + r0 + i, tok = c_start + qi;
        if (qi < chunk && tok < seq) {
          const float el = expf(ls[qi]);
          O* yr = yb + tok * y_row + tc;
#pragma unroll
          for (int jj = 0; jj < kCols; ++jj)
            from_f(acc[i][jj] + el * inter[i][jj], yr + 16 * jj);
        }
      }
    }

    // State update: h <- exp(l_last) h + (B exp(l_last - l) dt)^T x.
    float hn[kMaxNI][kCols];
    const float decay = expf(l_last);
#pragma unroll
    for (int i = 0; i < kMaxNI; ++i) {
      const int f = tr + 16 * i;
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj)
        hn[i][jj] = f < n ? decay * hs[f * P + tc + 16 * jj] : 0.f;
    }
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int k0 = kt * kT;
      __syncthreads();             // bt and xs of the last tile are read
      load_t(bt, bb, bl, c_start, k0, true, l_last);
      load_x(c_start, k0);
      __syncthreads();
      const int kn = min(kT, chunk - k0);
      for (int c = 0; c < kn; ++c) {
        float xv[kCols];
#pragma unroll
        for (int jj = 0; jj < kCols; ++jj) xv[jj] = xs[c * P + tc + 16 * jj];
#pragma unroll
        for (int i = 0; i < kMaxNI; ++i) {
          const int f = tr + 16 * i;
          if (f < n) {
            const float bv = bt[f * (kT + kPad) + c];
#pragma unroll
            for (int jj = 0; jj < kCols; ++jj)
              hn[i][jj] = fmaf(bv, xv[jj], hn[i][jj]);
          }
        }
      }
    }
    __syncthreads();               // every thread has read the old state
#pragma unroll
    for (int i = 0; i < kMaxNI; ++i) {
      const int f = tr + 16 * i;
      if (f < n) {
#pragma unroll
        for (int jj = 0; jj < kCols; ++jj) hs[f * P + tc + 16 * jj] = hn[i][jj];
      }
    }
  }
}

template <int P, typename T, typename O>
cudaError_t launch(const void* x, const void* dt, const void* l,
                   const void* bm, const void* cm, void* y, int batch,
                   int seq, int seq_pad, int heads, int groups, int n,
                   int chunk, Layout xl, Layout bl, Layout cl,
                   cudaStream_t stream) {
  // The shared-memory ceiling is raised once, to what the widest state
  // and the longest chunk take; each launch asks for what its shape needs.
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel<P, T, O>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes(kMaxN, P, kMaxChunk));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int bytes = smem_bytes(n, P, chunk);
  ssd_kernel<P, T, O><<<batch * heads, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(l), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<O*>(y), seq, seq_pad, heads,
      groups, n, chunk, xl, bl, cl);
  return cudaGetLastError();
}

template <typename T, typename O>
cudaError_t dispatch(int p, const void* x, const void* dt, const void* l,
                     const void* bm, const void* cm, void* y, int batch,
                     int seq, int seq_pad, int heads, int groups, int n,
                     int chunk, Layout xl, Layout bl, Layout cl,
                     cudaStream_t s) {
  switch (p) {
    case 16: return launch<16, T, O>(x, dt, l, bm, cm, y, batch, seq,
                                     seq_pad, heads, groups, n, chunk, xl,
                                     bl, cl, s);
    case 32: return launch<32, T, O>(x, dt, l, bm, cm, y, batch, seq,
                                     seq_pad, heads, groups, n, chunk, xl,
                                     bl, cl, s);
    case 64: return launch<64, T, O>(x, dt, l, bm, cm, y, batch, seq,
                                     seq_pad, heads, groups, n, chunk, xl,
                                     bl, cl, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// in_dtype: 0 float32, 1 bfloat16 (x, B and C); out_dtype: 0 float32,
// 1 bfloat16, which must be float32 or in_dtype.  Strides are in elements.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a shape or dtype without an instantiation.
int mrsch_ssd_fwd(const void* x, const void* dt, const void* l,
                  const void* bm, const void* cm, void* y, int batch,
                  int seq, int seq_pad, int heads, int groups, int n, int p,
                  int chunk, long long x_batch, long long x_token,
                  long long b_batch, long long b_token, long long c_batch,
                  long long c_token, int in_dtype, int out_dtype,
                  void* stream) {
  if (n < 1 || n > kMaxN || chunk < 1 || chunk > kMaxChunk || groups < 1 ||
      heads % groups != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout xl{x_batch, x_token}, bl{b_batch, b_token},
      cl{c_batch, c_token};
  auto s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0)
    return dispatch<float, float>(p, x, dt, l, bm, cm, y, batch, seq,
                                  seq_pad, heads, groups, n, chunk, xl, bl,
                                  cl, s);
  if (in_dtype == 1 && out_dtype == 1)
    return dispatch<__nv_bfloat16, __nv_bfloat16>(
        p, x, dt, l, bm, cm, y, batch, seq, seq_pad, heads, groups, n, chunk,
        xl, bl, cl, s);
  if (in_dtype == 1 && out_dtype == 0)
    return dispatch<__nv_bfloat16, float>(p, x, dt, l, bm, cm, y, batch,
                                          seq, seq_pad, heads, groups, n,
                                          chunk, xl, bl, cl, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* mrsch_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
