// Window pack for Hopper (sm_90a): the first W waiting jobs of every
// environment, densely packed.
//
// Replaces the TPU kernel `window_pack_kernel` (`_window_pack_kernel`) in
// src/repro/kernels/window_pack/kernel.py:37.  Inputs: waiting (N, J)
// float32 0/1 and feats (N, J, F) float32.  Slot w of environment n holds
// the (w+1)-th waiting job in ascending index order: its feature row in
// win_feats (N, W, F), its index in win_idx (N, W) int32 and 1 in
// win_valid (N, W) (one byte: the wrapper hands PyTorch a bool tensor).
// Slots past the number of waiting jobs hold zero features, index 0 and
// valid 0.  The result is a gather, so it is bit-identical to the plain
// version's one-hot product.
//
// What bounds it: launch latency.  On the device rollout's main path
// (N = 64, J ~ 330, F = 4, W = 10) it reads about 85 KB of `waiting` and
// 10 KB of selected feature rows, and writes 13 KB: ~0.03 us at 3.35 TB/s,
// against a launch floor of a few us.  The TPU design (a (W, J) one-hot
// times (J, F) matmul on the MXU, every array padded to 128 lanes) does
// not carry over; this one is a scan plus a gather:
//
//  * one block per environment, threads striding the J axis 256 at a time;
//  * a block-wide prefix count of `waiting > 0.5`: `__ballot_sync` and
//    `__popc` inside each warp, then one warp scans the warps' totals;
//  * a waiting job whose rank r is below W writes its index to win_idx[r];
//    the block stops scanning as soon as W jobs are found;
//  * then the block copies the selected rows of `feats` (and only those)
//    and zero-fills the rest.  Any J, F and W, ragged, with no padding.
//
// Plain C interface for ctypes; the wrapper (kernel.py) allocates the
// outputs and raises on a non-zero return.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
window_pack_kernel(const float* __restrict__ waiting,
                   const float* __restrict__ feats, float* __restrict__ wf,
                   int32_t* __restrict__ wi, uint8_t* __restrict__ wv, int J,
                   int F, int W) {
  __shared__ int warp_count[kWarps];
  __shared__ int found;                  // waiting jobs seen so far

  const int64_t n = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* wait_row = waiting + n * J;
  int32_t* idx = wi + n * W;

  if (tid == 0) found = 0;
  __syncthreads();

  for (int base = 0; base < J; base += kThreads) {
    const int j = base + tid;
    const bool is_wait = j < J && wait_row[j] > 0.5f;
    const unsigned ballot = __ballot_sync(0xffffffffu, is_wait);
    const int before_in_warp = __popc(ballot & ((1u << lane) - 1u));
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    if (warp == 0) {                     // inclusive scan of the warp counts
      int v = lane < kWarps ? warp_count[lane] : 0;
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += t;
      }
      if (lane < kWarps) warp_count[lane] = v;
    }
    __syncthreads();
    const int rank = found + (warp == 0 ? 0 : warp_count[warp - 1]) +
                     before_in_warp;
    if (is_wait && rank < W) idx[rank] = j;
    __syncthreads();                     // every thread has read `found`
    if (tid == 0) found += warp_count[kWarps - 1];
    __syncthreads();
    if (found >= W) break;               // uniform: all threads read one value
  }

  // The indices written above are visible block-wide after the barrier.
  const int count = found < W ? found : W;
  for (int w = tid; w < W; w += kThreads) {
    if (w >= count) idx[w] = 0;
    wv[n * W + w] = w < count ? 1 : 0;
  }
  const int64_t total = static_cast<int64_t>(W) * F;
  float* out = wf + n * total;
  const float* feat_env = feats + n * static_cast<int64_t>(J) * F;
  for (int64_t e = tid; e < total; e += kThreads) {
    const int w = static_cast<int>(e / F);
    const int f = static_cast<int>(e - static_cast<int64_t>(w) * F);
    out[e] = w < count ? feat_env[static_cast<int64_t>(idx[w]) * F + f] : 0.f;
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success).
int mrsch_window_pack(const void* waiting, const void* feats, void* win_feats,
                      void* win_idx, void* win_valid, int N, int J, int F,
                      int W, void* stream) {
  window_pack_kernel<<<N, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(waiting), static_cast<const float*>(feats),
      static_cast<float*>(win_feats), static_cast<int32_t*>(win_idx),
      static_cast<uint8_t*>(win_valid), J, F, W);
  return static_cast<int>(cudaGetLastError());
}

const char* mrsch_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
