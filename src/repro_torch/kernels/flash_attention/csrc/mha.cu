// Masked non-causal attention forward for Hopper (sm_90a): B5, `mha_fwd`.
//
// Replaces the TPU kernel `mha_fwd_kernel` (`_mha_fwd_kernel`) in
// src/repro/kernels/flash_attention/kernel.py:125.  Inputs q (BH, Sq, dh),
// k and v (BH, Sk, dh) and lengths (BH,), float32 and contiguous.  Keys at
// positions >= the row's length are masked (the position compared in
// float32, as the reference compares it); queries are not.  Outputs
// o (BH, Sq, dh) and lse (BH, Sq):
//
//   o   = sum_j p_j v_j / max(l, 1e-30),   p_j = exp(s_j - m) on valid keys,
//   lse = m + log(max(l, 1e-30)),          s_j = (q . k_j) * dh^-0.5,
//
// with m the running maximum and l = sum_j p_j.  A row with no valid key
// keeps m = -1e30 and l = 0: it writes o = 0 and a finite lse (-1e30),
// which the backward kernels rely on.
//
// What bounds it: launch latency and, within a launch, the FMA rate.  On
// the device engine's and the trainer's main path (BH = 4 heads x 64 rows
// = 256, S = 1 + Q = 129, dh = 16) one call reads q, k and v (6.3 MB) and
// writes o and lse (2.2 MB), 2.5 us at 3.35 TB/s; with every key valid it
// does 2 x 129 x 129 x 16 FMAs per bh, 0.27 GFLOP, 4 us at 67 TFLOP/s
// float32.  The TPU design (128 x 128 MXU tiles, sequences padded to block
// multiples, m / l / acc carried in VMEM scratch across a sequential key
// grid) does not carry over; this one is a plain CUDA-core online softmax:
//
//  * one block per (bh, tile of 64 query rows), one thread per query row,
//    with its q row, m, l and acc[dh] in registers (dh is a template
//    parameter: 8, 16, 32 or 64);
//  * the block stages the keys and values of its bh in shared memory, 64
//    rows at a time, with flat coalesced loads; every thread then reads
//    the same key row (a broadcast, no bank conflict);
//  * every row of a block shares one length, so the key loop stops at
//    ceil(length) without divergence: the keys it skips are exactly the
//    masked ones, which would add p = 0 and leave m unchanged.  On the
//    queue traffic this skips most of the 129-token buffer;
//  * the accumulator is rescaled only when a score raises the running
//    maximum.  Any Sq and Sk, ragged, with no padding.
//
// Plain C interface for ctypes; the wrapper (kernel.py) allocates the
// outputs and raises on a non-zero return.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;          // query rows per block, one per thread
constexpr float kNegInf = -1e30f;

// Keys whose float32 position is below `len`: ceil(len), within [0, sk].
__device__ __forceinline__ int valid_keys(float len, int sk) {
  if (!(len > 0.f)) return 0;      // also a NaN length
  return static_cast<int>(ceilf(fminf(len, static_cast<float>(sk))));
}

template <int DH>
__global__ void __launch_bounds__(kRows)
mha_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v,
               const float* __restrict__ lengths, float* __restrict__ o,
               float* __restrict__ lse, int sq, int sk, float scale) {
  __shared__ float ks[kRows * DH];
  __shared__ float vs[kRows * DH];

  const int64_t bh = blockIdx.x;
  const int row = blockIdx.y * kRows + threadIdx.x;
  const bool active = row < sq;
  const int nk = valid_keys(lengths[bh], sk);
  const float* kb = k + bh * sk * DH;
  const float* vb = v + bh * sk * DH;
  const int64_t qrow = (bh * sq + row) * DH;

  float qr[DH], acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qr[d] = active ? q[qrow + d] : 0.f;
    acc[d] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  for (int t0 = 0; t0 < nk; t0 += kRows) {
    const int n = min(kRows, nk - t0);
    __syncthreads();                 // the previous tile is read by all
    for (int e = threadIdx.x; e < n * DH; e += kRows) {
      ks[e] = kb[static_cast<int64_t>(t0) * DH + e];
      vs[e] = vb[static_cast<int64_t>(t0) * DH + e];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float* kr = ks + j * DH;
      const float* vr = vs + j * DH;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) s = fmaf(qr[d], kr[d], s);
      s *= scale;
      if (s > m) {                   // a new maximum: rescale what is summed
        const float alpha = expf(m - s);
        l *= alpha;
#pragma unroll
        for (int d = 0; d < DH; ++d) acc[d] *= alpha;
        m = s;
      }
      const float p = expf(s - m);
      l += p;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = fmaf(p, vr[d], acc[d]);
    }
  }

  if (active) {
    const float lc = fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < DH; ++d) o[qrow + d] = acc[d] / lc;
    lse[bh * sq + row] = m + logf(lc);
  }
}

template <int DH>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* lengths, float* o, float* lse, int bh,
                   int sq, int sk, float scale, cudaStream_t stream) {
  const dim3 grid(bh, (sq + kRows - 1) / kRows);
  mha_fwd_kernel<DH><<<grid, kRows, 0, stream>>>(q, k, v, lengths, o, lse,
                                                  sq, sk, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// `scale` is dh^-0.5 as the wrapper rounds it to float32.  Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a head dim without an instantiation.
int mrsch_mha_fwd(const void* q, const void* k, const void* v,
                  const void* lengths, void* o, void* lse, int bh, int sq,
                  int sk, int dh, float scale, void* stream) {
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* lf = static_cast<const float*>(lengths);
  auto* of = static_cast<float*>(o);
  auto* lsef = static_cast<float*>(lse);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 8:
      return launch<8>(qf, kf, vf, lf, of, lsef, bh, sq, sk, scale, s);
    case 16:
      return launch<16>(qf, kf, vf, lf, of, lsef, bh, sq, sk, scale, s);
    case 32:
      return launch<32>(qf, kf, vf, lf, of, lsef, bh, sq, sk, scale, s);
    case 64:
      return launch<64>(qf, kf, vf, lf, of, lsef, bh, sq, sk, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* mrsch_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
