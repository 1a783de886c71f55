// Window pack and the device round's front for Hopper (sm_90a).
//
// Replaces the TPU kernel `window_pack_kernel` (`_window_pack_kernel`) in
// src/repro/kernels/window_pack/kernel.py:37, and on the card also the ops
// that XLA fuses around it inside the reference's jitted round
// (src/repro/sim/device.py:587-610).  Two entry points over one block-wide
// scan of the job axis (`scan_waiting`):
//
// * `window_pack_kernel`: the JAX `ops.pack_window`.  Inputs waiting (N, J)
//   float32 0/1 and feats (N, J, F) float32; slot w of environment n holds
//   the (w+1)-th waiting job in ascending index order: its feature row in
//   win_feats (N, W, F), its index in win_idx (N, W) int32 and 1 in
//   win_valid (N, W) (one byte: the wrapper hands PyTorch a bool tensor).
//   Slots past the number of waiting jobs hold zero features, index 0 and
//   valid 0.  It stops scanning once W jobs are found.
//
// * `decision_rows_kernel`: the whole front of a deciding round in one
//   launch, the counterpart of `ref.py::pack_decision_rows_reference`.  It
//   reads the round's state once (the ready times, the started, finished
//   and failed flags, the estimated ends, every unit's release time and,
//   with drains, its owner) and writes the queued mask, its count, the
//   free-unit counts per resource, the packed K slots (indices, validity)
//   and the decision row: "mask" the window's validity; "mlp" [W tokens |
//   per resource avail, ttf over the encoding's section | meas | goal |
//   valid(W)]; "attention" [Q tokens | qlen | per resource free fraction,
//   mean ttf | meas | goal | valid(W)].
//
// What bounds it: launch latency.  At the device rollout's shapes (N = 64,
// J ~ 358-445, U = 5685 units, rows of 11,430 floats) a block reads ~35 KB
// and writes ~47 KB: ~5 MB in all, ~1.5 us at 3.35 TB/s, against a launch
// and event floor of ~5 us.  What it saves is the ~45 (MLP) to ~73
// (attention) small launches that the same work takes as PyTorch ops.
// Design:
//
//  * one block per environment, 512 threads; nothing is shared between
//    blocks, so no second pass or atomics in device memory;
//  * what a block waits on is memory latency, so loads are issued early
//    and together: the unit axis is read in passes of 12 units a thread
//    (Theta's 5,685 units in one pass), and the first pass is issued
//    before the job axis is scanned; a job's loads are unconditional;
//  * the job axis in chunks of 512: the queued predicate from the four
//    flag rows and `now`, the 0/1 mask written, a block-wide prefix count
//    (`__ballot_sync` and `__popc` inside each warp, one warp scanning
//    the warps' totals) giving each waiting job its rank; ranks below K
//    write their index; the goal's job sums (walltime of the waiting,
//    clamped remainder of the running, times each demand) ride along;
//  * on the unit axis, free, phantom and busy counts and the TTF sums per
//    resource (a thread's running sums move to the next resource where
//    its units cross a segment), and the MLP's avail and ttf written
//    straight into the row at their offsets (cut at the section size,
//    zero-padded past the capacity);
//  * then only the selected feature rows are gathered into the tokens,
//    and one thread per resource writes meas, goal and the context.
//
// Rounding: every value but two equals the PyTorch ops' result bit for
// bit.  Each operation the ops round separately is one intrinsic here
// (`__fsub_rn`, `__fmul_rn`, `__fdiv_rn`: no FMA contraction), and a
// division by a Python number is a multiplication by its float reciprocal
// (`inv_ts`, `inv_cap`), as aten's CUDA division by a CPU scalar does.
// The goal (a sum over the job axis, a batched product there) and the
// attention context's mean TTF (a sum over units) are sums in another
// order: deterministic (a fixed tree), within float rounding of the ops.
//
// Plain C interface for ctypes; the wrapper (kernel.py) allocates the
// outputs and raises on a non-zero return.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kMaxR = 8;               // resources (the wrapper checks)

// The front's shapes and constants, passed by value (built once per
// rollout by kernel.py; the layout must match its ctypes Structure).  At
// namespace scope: the exported entry point's signature names it.
struct RowParams {
  int N, J, R, U, W, K, mode, has_drains, row_dim;
  int unit_off;   // mlp: first unit section; attention: the qlen column
  int meas_off, goal_off, valid_off;
  int phantom_owner;    // ref.PHANTOM_OWNER: a drained unit's owner
  float inv_ts;         // 1 / time_scale, rounded to float
  float goal_default;   // float(1.0 / R): the goal when no work is known
  float ttf_horizon;    // ref.TTF_HORIZON, rounded to float
  int seg_off[kMaxR], seg_cap[kMaxR];   // the unit axis, per resource
  int enc_cap[kMaxR], enc_off[kMaxR];   // mlp sections: size, row offset
  float inv_cap[kMaxR]; // 1 / max(cap, 1), rounded to float
};

namespace {

constexpr int kPackThreads = 256;      // window_pack_kernel
constexpr int kRowThreads = 512;       // decision_rows_kernel
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kUnitRegs = 12;          // unit loads in flight per thread
enum Mode { kMask = 0, kMlp = 1, kAttention = 2 };

// Block-wide ordered scan of the job axis.  Every thread calls it with the
// same arguments.  For each j < J, in chunks of kThreads: `is_wait(j)`
// decides whether job j waits and `visit(j, waits)` sees it; the waiting
// job of rank r < K writes j to idx[r].  With kStopEarly the scan ends
// after the chunk in which K waiting jobs were reached.  Returns the
// number of waiting jobs counted (all of them unless stopped early).  The
// idx writes are visible block-wide on return.
template <int kThreads, bool kStopEarly, class IsWait, class Visit>
__device__ int scan_waiting(int J, int K, int32_t* __restrict__ idx,
                            IsWait is_wait, Visit visit) {
  constexpr int kWarps = kThreads / 32;
  static_assert(kWarps <= 32, "one warp scans the warp counts");
  __shared__ int warp_count[kWarps];
  __shared__ int found;                  // waiting jobs seen so far

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) found = 0;
  __syncthreads();

  for (int base = 0; base < J; base += kThreads) {
    const int j = base + tid;
    const bool waits = j < J && is_wait(j);
    if (j < J) visit(j, waits);
    const unsigned ballot = __ballot_sync(0xffffffffu, waits);
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
    if (waits && rank < K) idx[rank] = j;
    __syncthreads();                     // every thread has read `found`
    if (tid == 0) found += warp_count[kWarps - 1];
    __syncthreads();
    if (kStopEarly && found >= K) break; // uniform: all threads read one value
  }
  return found;
}

__global__ void __launch_bounds__(kPackThreads)
window_pack_kernel(const float* __restrict__ waiting,
                   const float* __restrict__ feats, float* __restrict__ wf,
                   int32_t* __restrict__ wi, uint8_t* __restrict__ wv, int J,
                   int F, int W) {
  const int64_t n = blockIdx.x;
  const int tid = threadIdx.x;
  const float* wait_row = waiting + n * J;
  int32_t* idx = wi + n * W;

  const int found = scan_waiting<kPackThreads, true>(
      J, W, idx, [&](int j) { return wait_row[j] > 0.5f; },
      [](int, bool) {});

  const int count = found < W ? found : W;
  for (int w = tid; w < W; w += kPackThreads) {
    if (w >= count) idx[w] = 0;
    wv[n * W + w] = w < count ? 1 : 0;
  }
  const int64_t total = static_cast<int64_t>(W) * F;
  float* out = wf + n * total;
  const float* feat_env = feats + n * static_cast<int64_t>(J) * F;
  for (int64_t e = tid; e < total; e += kPackThreads) {
    const int w = static_cast<int>(e / F);
    const int f = static_cast<int>(e - static_cast<int64_t>(w) * F);
    out[e] = w < count ? feat_env[static_cast<int64_t>(idx[w]) * F + f] : 0.f;
  }
}

// Sum of one float over the block in a fixed order (each warp by
// shuffles, then the warps in order); the result in every thread.
__device__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < kRowWarps; ++w) s += scratch[w];
  __syncthreads();                       // scratch is reused
  return s;
}

__device__ int block_count(int v, int* scratch) {
  v = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
  for (int w = 0; w < kRowWarps; ++w) s += scratch[w];
  __syncthreads();
  return s;
}

__device__ __forceinline__ float clamp_ttf(float rel, float now,
                                           float horizon) {
  return fminf(fmaxf(__fsub_rn(rel, now), 0.f), horizon);
}

// One pass over the unit axis: unit u = base + i * kRowThreads + tid of
// this environment in slot i (release 0 and owner 0 past the axis).
__device__ __forceinline__ void load_units(const RowParams& p,
                                           const float* __restrict__ rel_env,
                                           const int32_t* __restrict__ own_env,
                                           int base, float* rel, int* own) {
#pragma unroll
  for (int i = 0; i < kUnitRegs; ++i) {
    const int u = base + i * kRowThreads + threadIdx.x;
    rel[i] = u < p.U ? rel_env[u] : 0.f;
    own[i] = (p.has_drains && u < p.U) ? own_env[u] : 0;
  }
}

// Adds a thread's running sums of resource r into its per-resource ones
// (registers: the index is resolved by unrolling).
__device__ __forceinline__ void flush_units(int r, int& c_free, int& c_phantom,
                                            int& c_busy, float& t_sum,
                                            int* free_r, int* phantom_r,
                                            int* busy_r, float* ttf_r) {
#pragma unroll
  for (int q = 0; q < kMaxR; ++q)
    if (q == r) {
      free_r[q] += c_free;
      phantom_r[q] += c_phantom;
      busy_r[q] += c_busy;
      ttf_r[q] += t_sum;
    }
  c_free = c_phantom = c_busy = 0;
  t_sum = 0.f;
}

__global__ void __launch_bounds__(kRowThreads)
decision_rows_kernel(const RowParams p, const float* __restrict__ ready,
                     const float* __restrict__ now_env,
                     const uint8_t* __restrict__ started,
                     const uint8_t* __restrict__ finished,
                     const uint8_t* __restrict__ failed,
                     const float* __restrict__ release,
                     const float* __restrict__ est_end,
                     const int32_t* __restrict__ owner,
                     const float* __restrict__ feats,
                     const float* __restrict__ walltime,
                     const float* __restrict__ demands,
                     const float* __restrict__ caps_f,
                     float* __restrict__ waiting,
                     float* __restrict__ n_waiting,
                     float* __restrict__ free_out,
                     int32_t* __restrict__ idx_out,
                     uint8_t* __restrict__ valid_out,
                     float* __restrict__ obs_out) {
  __shared__ float f_scratch[kRowWarps];
  __shared__ int i_scratch[kRowWarps];
  __shared__ float s_acc[kMaxR];         // goal: sum over jobs of tw * demand
  __shared__ int s_free[kMaxR], s_phantom[kMaxR], s_busy[kMaxR];
  __shared__ float s_ttf[kMaxR];

  const int64_t n = blockIdx.x;
  const int tid = threadIdx.x;
  const int R = p.R, K = p.K, W = p.W, F = R + 2;
  const bool rows = p.mode != kMask;
  const int64_t jrow = n * p.J;
  const float* rel_env = release + n * p.U;
  const int32_t* own_env = owner + n * p.U;   // read only with drains
  float* obs = obs_out + n * p.row_dim;
  int32_t* idx = idx_out + n * K;

  // The unit axis's first pass is in flight while the job axis is read.
  float rel[kUnitRegs];
  int own[kUnitRegs];
  load_units(p, rel_env, own_env, 0, rel, own);
  const float now = now_env[n];

  // ---- job axis: queued mask, ranks, the goal's job sums.  Every load of
  // a job is issued unconditionally, so a job costs one memory latency.
  float acc[kMaxR];
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) acc[r] = 0.f;
  const int n_wait = scan_waiting<kRowThreads, false>(
      p.J, K, idx,
      [&](int j) {
        const bool eligible = ready[jrow + j] <= now;
        const bool live = started[jrow + j] | finished[jrow + j] |
                          failed[jrow + j];
        return eligible & !live;
      },
      [&](int j, bool waits) {
        waiting[jrow + j] = waits ? 1.f : 0.f;
        if (!rows) return;
        // walltime * waiting + clamp_min(est_end - now, 0) * running
        const float wall = walltime[jrow + j];
        const float rem = fmaxf(__fsub_rn(est_end[jrow + j], now), 0.f);
        const float* d = demands + (jrow + j) * R;
        float dj[kMaxR];
#pragma unroll
        for (int r = 0; r < kMaxR; ++r) dj[r] = r < R ? d[r] : 0.f;
        const bool running = started[jrow + j] && !finished[jrow + j];
        const float tw = __fadd_rn(waits ? wall : 0.f, running ? rem : 0.f);
#pragma unroll
        for (int r = 0; r < kMaxR; ++r) acc[r] += tw * dj[r];
      });
  if (rows) {
#pragma unroll
    for (int r = 0; r < kMaxR; ++r)
      if (r < R) {
        const float s = block_sum(acc[r], f_scratch);
        if (tid == 0) s_acc[r] = s;
      }
  }

  // ---- unit axis, kUnitRegs units a thread a pass (one pass up to
  // 6,144 units): free, phantom and busy counts and TTF sums per resource;
  // the MLP row's avail and ttf written at their offsets.
  int free_r[kMaxR], phantom_r[kMaxR], busy_r[kMaxR];
  float ttf_r[kMaxR];
#pragma unroll
  for (int q = 0; q < kMaxR; ++q) {
    free_r[q] = phantom_r[q] = busy_r[q] = 0;
    ttf_r[q] = 0.f;
  }
  int r = 0;                             // resource of the thread's unit
  int c_free = 0, c_phantom = 0, c_busy = 0;
  float t_sum = 0.f;
  for (int base = 0;;) {
#pragma unroll
    for (int i = 0; i < kUnitRegs; ++i) {
      const int u = base + i * kRowThreads + tid;
      if (u >= p.U) break;
      while (r + 1 < R && u >= p.seg_off[r + 1]) {
        flush_units(r, c_free, c_phantom, c_busy, t_sum, free_r, phantom_r,
                    busy_r, ttf_r);
        ++r;
      }
      const bool busy = rel[i] > 0.f;
      c_free += rel[i] == 0.f;
      c_phantom += own[i] == p.phantom_owner;
      c_busy += busy;
      const float ttf = busy ? clamp_ttf(rel[i], now, p.ttf_horizon) : 0.f;
      t_sum += ttf;
      const int l = u - p.seg_off[r];
      if (p.mode == kMlp && l < p.enc_cap[r]) {
        float* avail_row = obs + p.enc_off[r];
        avail_row[l] = busy ? 0.f : 1.f;
        avail_row[p.enc_cap[r] + l] = __fmul_rn(ttf, p.inv_ts);
      }
    }
    base += kUnitRegs * kRowThreads;
    if (base >= p.U) break;
    load_units(p, rel_env, own_env, base, rel, own);
  }
  flush_units(r, c_free, c_phantom, c_busy, t_sum, free_r, phantom_r,
              busy_r, ttf_r);
#pragma unroll
  for (int q = 0; q < kMaxR; ++q)
    if (q < R) {
      const int cap = p.seg_cap[q];
      if (p.mode == kMlp) {              // sections past the capacity: 0
        float* avail_row = obs + p.enc_off[q];
        for (int l = cap + tid; l < p.enc_cap[q]; l += kRowThreads)
          avail_row[l] = avail_row[p.enc_cap[q] + l] = 0.f;
      }
      const int cf = block_count(free_r[q], i_scratch);
      const int cp = p.has_drains ? block_count(phantom_r[q], i_scratch) : 0;
      int cb = 0;
      float ts = 0.f;
      if (p.mode == kAttention) {
        cb = block_count(busy_r[q], i_scratch);
        ts = block_sum(ttf_r[q], f_scratch);
      }
      if (tid == 0) {
        s_free[q] = cf;
        s_phantom[q] = cp;
        s_busy[q] = cb;
        s_ttf[q] = ts;
      }
    }

  // ---- slots: validity, indices past the count, the job tokens.
  const int count = n_wait < K ? n_wait : K;
  for (int w = tid; w < K; w += kRowThreads) {
    if (w >= count) idx[w] = 0;
    valid_out[n * K + w] = w < count ? 1 : 0;
  }
  for (int w = tid; w < W; w += kRowThreads)
    obs[p.valid_off + w] = w < count ? 1.f : 0.f;
  if (rows) {
    for (int e = tid; e < K * F; e += kRowThreads) {
      const int w = e / F, f = e - w * F;
      float v = 0.f;
      if (w < count) {
        const float* row = feats + (jrow + idx[w]) * F;
        // [fracs(R), walltime_norm] as stored; queued = (now - submit) / ts
        v = f < R + 1 ? row[f] : __fmul_rn(__fsub_rn(now, row[R + 1]),
                                           p.inv_ts);
      }
      obs[e] = v;
    }
  }
  __syncthreads();                       // s_* are written

  // ---- per resource: free, meas, goal, the attention context.
  if (tid == 0) n_waiting[n] = static_cast<float>(n_wait);
  if (tid < R) {
    const int q = tid;
    const float fr = static_cast<float>(s_free[q]);
    free_out[n * R + q] = fr;
    if (rows) {
      const float used = p.has_drains
          ? __fadd_rn(fr, static_cast<float>(s_phantom[q])) : fr;
      obs[p.meas_off + q] = __fsub_rn(1.f, __fdiv_rn(used, caps_f[q]));
      float total = 0.f;
      for (int t = 0; t < R; ++t)
        total = __fadd_rn(total, __fdiv_rn(s_acc[t], caps_f[t]));
      const float dt = __fdiv_rn(s_acc[q], caps_f[q]);
      obs[p.goal_off + q] = total > 0.f
          ? __fdiv_rn(dt, fmaxf(total, 1e-30f)) : p.goal_default;
    }
    if (p.mode == kAttention) {
      const float nb = static_cast<float>(s_busy[q]);
      obs[p.unit_off + 1 + 2 * q] = __fsub_rn(1.f, __fmul_rn(nb, p.inv_cap[q]));
      obs[p.unit_off + 2 + 2 * q] = nb > 0.f
          ? __fmul_rn(__fdiv_rn(s_ttf[q], fmaxf(nb, 1.f)), p.inv_ts) : 0.f;
    }
  }
  if (p.mode == kAttention && tid == 0)
    obs[p.unit_off] = fminf(static_cast<float>(n_wait),
                            static_cast<float>(K));
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success).
int mrsch_window_pack(const void* waiting, const void* feats, void* win_feats,
                      void* win_idx, void* win_valid, int N, int J, int F,
                      int W, void* stream) {
  window_pack_kernel<<<N, kPackThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(waiting), static_cast<const float*>(feats),
      static_cast<float*>(win_feats), static_cast<int32_t*>(win_idx),
      static_cast<uint8_t*>(win_valid), J, F, W);
  return static_cast<int>(cudaGetLastError());
}

// The front of a deciding round: 12 inputs (owner may be null without
// drains), 6 outputs, in the order of decision_rows_kernel's arguments.
int mrsch_decision_rows(const RowParams* params, const void* ready,
                        const void* now, const void* started,
                        const void* finished, const void* failed,
                        const void* release, const void* est_end,
                        const void* owner, const void* feats,
                        const void* walltime, const void* demands,
                        const void* caps_f, void* waiting, void* n_waiting,
                        void* free_out, void* idx, void* valid, void* obs,
                        void* stream) {
  if (params->R < 1 || params->R > kMaxR) return cudaErrorInvalidValue;
  decision_rows_kernel<<<params->N, kRowThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      *params, static_cast<const float*>(ready),
      static_cast<const float*>(now), static_cast<const uint8_t*>(started),
      static_cast<const uint8_t*>(finished),
      static_cast<const uint8_t*>(failed), static_cast<const float*>(release),
      static_cast<const float*>(est_end), static_cast<const int32_t*>(owner),
      static_cast<const float*>(feats), static_cast<const float*>(walltime),
      static_cast<const float*>(demands), static_cast<const float*>(caps_f),
      static_cast<float*>(waiting), static_cast<float*>(n_waiting),
      static_cast<float*>(free_out), static_cast<int32_t*>(idx),
      static_cast<uint8_t*>(valid), static_cast<float*>(obs));
  return static_cast<int>(cudaGetLastError());
}

const char* mrsch_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
