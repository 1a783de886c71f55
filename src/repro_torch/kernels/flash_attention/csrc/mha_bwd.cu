// Masked non-causal attention backward for Hopper (sm_90a): B6,
// `mha_bwd_dq` and `mha_bwd_dkv`.
//
// Replaces the TPU kernels of `mha_bwd_kernels` (`_mha_bwd_dq_kernel` and
// `_mha_bwd_dkv_kernel`) in src/repro/kernels/flash_attention/kernel.py:216.
// Inputs q and do (BH, Sq, dh), k and v (BH, Sk, dh), lse and delta
// (BH, Sq) and lengths (BH,), float32 and contiguous; lse comes from the
// forward (mha.cu) and delta = rowsum(do * o) from the wrapper.  Both
// kernels recompute the probabilities flash-style on the valid keys
// (position < length, compared in float32), never storing them:
//
//   p = exp(q . k * scale - lse),   ds = p * (do . v - delta) * scale,
//   dq = sum_keys ds k,   dk = sum_queries ds q,   dv = sum_queries p do.
//
// Masked keys contribute nothing and get dk = dv = 0; a row with no valid
// key gets dq = 0, all exactly, with no exp(+1e30) ever computed.
//
// What bounds them: as for the forward, launch latency and then the FMA
// rate.  On the trainer's main path (BH = 256, S = 129, dh = 16) they read
// 2.1 MB per (BH, S, dh) operand and do 4 x 129 x 129 x 16 FMAs per bh
// over the valid keys (dq: two dots and an axpy per key; dkv: two dots and
// two axpys per query), ~0.5 GFLOP with every key valid.  The TPU kernels
// tile by 128 x 128 blocks of padded sequences and carry accumulators in
// scratch over a sequential grid; here:
//
//  * dq: one block per (bh, tile of 64 query rows), one thread per query
//    row holding q, do, lse, delta and the dq accumulator in registers;
//    the block stages k and v in shared memory 64 keys at a time and stops
//    at ceil(length) keys, as the forward does;
//  * dkv: one block per (bh, tile of 64 key rows), one thread per key row
//    holding k, v and the dk, dv accumulators in registers.  A tile wholly
//    past the length writes zeros and stops; in the others, key rows past
//    the length write zeros, and the valid ones loop over every query row,
//    staged in shared memory in chunks of 64 (q, do, lse, delta);
//  * no atomics: each output row is summed by one thread in a fixed order,
//    so the results are deterministic.  Any Sq and Sk, ragged.
//
// At dh = 64 the dkv kernel's four register rows exceed the register file
// a thread may hold; ptxas spills (its -v report is in the build log).
// The main path runs dh = 16.
//
// Plain C interface for ctypes; the wrapper (kernel.py) allocates the
// outputs and raises on a non-zero return.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;          // rows per block, one per thread

// Keys whose float32 position is below `len`: ceil(len), within [0, sk].
__device__ __forceinline__ int valid_keys(float len, int sk) {
  if (!(len > 0.f)) return 0;      // also a NaN length
  return static_cast<int>(ceilf(fminf(len, static_cast<float>(sk))));
}

template <int DH>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < DH; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

template <int DH>
__global__ void __launch_bounds__(kRows)
mha_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  const float* __restrict__ lengths, float* __restrict__ dq,
                  int sq, int sk, float scale) {
  __shared__ float ks[kRows * DH];
  __shared__ float vs[kRows * DH];

  const int64_t bh = blockIdx.x;
  const int row = blockIdx.y * kRows + threadIdx.x;
  const bool active = row < sq;
  const int nk = valid_keys(lengths[bh], sk);
  const float* kb = k + bh * sk * DH;
  const float* vb = v + bh * sk * DH;
  const int64_t qrow = (bh * sq + row) * DH;

  float qr[DH], dor[DH], acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qr[d] = active ? q[qrow + d] : 0.f;
    dor[d] = active ? dout[qrow + d] : 0.f;
    acc[d] = 0.f;
  }
  const float lse_r = active ? lse[bh * sq + row] : 0.f;
  const float delta_r = active ? delta[bh * sq + row] : 0.f;

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
      const float p = expf(dot<DH>(qr, kr) * scale - lse_r);
      const float ds = p * (dot<DH>(dor, vs + j * DH) - delta_r) * scale;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = fmaf(ds, kr[d], acc[d]);
    }
  }
  if (active) {
#pragma unroll
    for (int d = 0; d < DH; ++d) dq[qrow + d] = acc[d];
  }
}

template <int DH>
__global__ void __launch_bounds__(kRows)
mha_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   const float* __restrict__ lengths,
                   float* __restrict__ dk, float* __restrict__ dv, int sq,
                   int sk, float scale) {
  __shared__ float qs[kRows * DH];
  __shared__ float dos[kRows * DH];
  __shared__ float lses[kRows];
  __shared__ float deltas[kRows];

  const int64_t bh = blockIdx.x;
  const int key = blockIdx.y * kRows + threadIdx.x;
  const bool in_range = key < sk;
  const int nk = valid_keys(lengths[bh], sk);
  const int64_t krow = (bh * sk + key) * DH;

  if (static_cast<int>(blockIdx.y) * kRows >= nk) {   // uniform per block
    if (in_range) {
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        dk[krow + d] = 0.f;
        dv[krow + d] = 0.f;
      }
    }
    return;
  }

  const bool valid = key < nk;
  float kr[DH], vr[DH], dk_acc[DH], dv_acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    kr[d] = valid ? k[krow + d] : 0.f;
    vr[d] = valid ? v[krow + d] : 0.f;
    dk_acc[d] = 0.f;
    dv_acc[d] = 0.f;
  }
  const float* qb = q + bh * sq * DH;
  const float* db = dout + bh * sq * DH;

  for (int t0 = 0; t0 < sq; t0 += kRows) {
    const int n = min(kRows, sq - t0);
    __syncthreads();                 // the previous chunk is read by all
    for (int e = threadIdx.x; e < n * DH; e += kRows) {
      qs[e] = qb[static_cast<int64_t>(t0) * DH + e];
      dos[e] = db[static_cast<int64_t>(t0) * DH + e];
    }
    if (threadIdx.x < n) {
      lses[threadIdx.x] = lse[bh * sq + t0 + threadIdx.x];
      deltas[threadIdx.x] = delta[bh * sq + t0 + threadIdx.x];
    }
    __syncthreads();
    if (valid) {
      for (int i = 0; i < n; ++i) {
        const float* qi = qs + i * DH;
        const float* doi = dos + i * DH;
        const float p = expf(dot<DH>(qi, kr) * scale - lses[i]);
        const float ds = p * (dot<DH>(doi, vr) - deltas[i]) * scale;
#pragma unroll
        for (int d = 0; d < DH; ++d) {
          dv_acc[d] = fmaf(p, doi[d], dv_acc[d]);
          dk_acc[d] = fmaf(ds, qi[d], dk_acc[d]);
        }
      }
    }
  }
  if (in_range) {
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      dk[krow + d] = dk_acc[d];      // zero for a key past the length
      dv[krow + d] = dv_acc[d];
    }
  }
}

struct Args {
  const float *q, *k, *v, *dout, *lse, *delta, *lengths;
  int bh, sq, sk;
  float scale;
  cudaStream_t stream;
};

template <int DH>
cudaError_t launch_dq(const Args& a, float* dq) {
  const dim3 grid(a.bh, (a.sq + kRows - 1) / kRows);
  mha_bwd_dq_kernel<DH><<<grid, kRows, 0, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.lengths, dq, a.sq, a.sk,
      a.scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dkv(const Args& a, float* dk, float* dv) {
  const dim3 grid(a.bh, (a.sk + kRows - 1) / kRows);
  mha_bwd_dkv_kernel<DH><<<grid, kRows, 0, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.lengths, dk, dv, a.sq, a.sk,
      a.scale);
  return cudaGetLastError();
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const void* lengths,
               int bh, int sq, int sk, float scale, void* stream) {
  return Args{static_cast<const float*>(q), static_cast<const float*>(k),
              static_cast<const float*>(v), static_cast<const float*>(dout),
              static_cast<const float*>(lse),
              static_cast<const float*>(delta),
              static_cast<const float*>(lengths), bh, sq, sk, scale,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

extern "C" {

// `scale` is dh^-0.5 as the wrapper rounds it to float32.  Each returns
// cudaGetLastError() after its launch (0 on success), or
// cudaErrorInvalidValue for a head dim without an instantiation.
int mrsch_mha_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     const void* lengths, void* dq, int bh, int sq, int sk,
                     int dh, float scale, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, lengths, bh, sq, sk,
                           scale, stream);
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
                      int sq, int sk, int dh, float scale, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, lengths, bh, sq, sk,
                           scale, stream);
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
