// Helpers shared by the masked attention kernels, B5 (mha.cu) and B6
// (mha_bwd.cu): block geometry and shared-memory pitches per head dim,
// cp.async staging with zero fill, the split of staged operands into TF32
// planes, 3xTF32 products on mma.sync m16n8k8, and the warp's 16-row
// fragments in the FlashAttention-2 layout.
//
// Fragments.  A warp owns 16 rows; lane (g, t) = (lane / 4, lane % 4)
// holds rows g and g + 8.  An accumulator of 16 rows x 8 columns holds
// columns 2t and 2t + 1 of both rows, as mma.sync writes it.  In a product
// over dh, the head dimension is taken in a permuted order (the sum does
// not depend on it) so that a lane reads its part of a row as one 16-byte
// vector: at dh >= 16 the lane's vector at dims 16c + 4t .. 16c + 4t + 3
// feeds k-steps 2c and 2c + 1, two dims each (k-index t and t + 4); at dh
// 8 one 8-byte vector at dims 2t, 2t + 1 feeds the single k-step.  In a
// product over keys (or queries), an accumulator is the A operand as it
// is: its columns 2t and 2t + 1 are taken as k-indices t and t + 4, so the
// B operand's rows 2t and 2t + 1 of the 8-row group go with them.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mha {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int DH>
struct Geom {
  static_assert(DH == 8 || DH == 16 || DH == 32 || DH == 64,
                "dh must be 8, 16, 32 or 64");
  // Most warps a block runs (16 rows each; kernel.mha_plan uses the same
  // numbers) and the blocks an SM must hold at once.  Registers bound both:
  // an SM's four schedulers hold 16,384 each, and a warp's registers sit
  // with one of them, so two blocks of 9 warps (the main path's 129 rows)
  // fit only at 96 registers a thread or fewer, which kMinBlocks = 2 makes
  // the compiler keep to.  At dh 32 and 64 the products' operands need
  // more, and fewer warps a block leave room for them.
  static constexpr int kWarps = DH <= 16 ? 9 : (DH == 32 ? 8 : 4);
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kMinBlocks = DH <= 16 ? 2 : 1;
  static constexpr int kDT = DH / 8;              // k-steps over dh
  static constexpr int kVec = DH >= 16 ? 4 : 2;   // floats of a lane's vector
  static constexpr int kVecs = DH / (4 * kVec);   // vectors a lane's row part
  // Pitches (floats) of staged rows.  kPR: rows read as B fragments over
  // dh (lane (g, t) reads its vector of row g), free of bank conflicts
  // when two rows' 16-byte reads (four at dh 8) share no bank.  kPC: rows
  // read as B fragments over rows (lane (g, t) reads column g of rows 2t
  // and 2t + 1), free of conflicts when 2 kPC = 8 (mod 32).  A row read
  // both ways takes kPC; its 16-byte reads then meet 2-way conflicts on a
  // quarter of the banks.
  static constexpr int kPR = DH == 8 ? 8 : (DH % 32 == 16 ? DH : DH + 16);
  static constexpr int kPC = DH + 4;
};

// Keys whose float32 position is below `len`: ceil(len), within [0, sk].
__device__ __forceinline__ int valid_keys(float len, int sk) {
  if (!(len > 0.f)) return 0;      // also a NaN length
  return static_cast<int>(ceilf(fminf(len, static_cast<float>(sk))));
}

// x = hi + lo: hi is x rounded to TF32 (10 mantissa bits, the low 13 bits
// zero; ties away from zero); lo = x - hi is exact in float32 and goes to
// the tensor core as it is, which reads its top 19 bits.  Rounding hi,
// not cutting it, halves lo and so the error: dk's sums hold about 5e-6 of
// the exact value at S = 600 rather than 3e-5, inside a 1e-4 limit that
// the float32 reference itself uses up to 3e-5 of.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const uint32_t h = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
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

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool live) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(live ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          bool live) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(live ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [0, n) of a contiguous (.., DH) block at `src` into shared rows of
// `pitch` floats, 16-byte copies spread over threads [tid, nthreads): row
// r is copied when r < live and zero-filled otherwise (shared memory may
// hold NaN, and 0 x NaN is NaN).
template <int DH>
__device__ __forceinline__ void stage_rows(float* dst, int pitch,
                                           const float* __restrict__ src,
                                           int n, int live, int tid,
                                           int nthreads) {
  constexpr int kChunks = DH / 4;
  for (int e = tid; e < n * kChunks; e += nthreads) {
    const int r = e / kChunks, c = (e % kChunks) * 4;
    const bool ok = r < live;
    cp_async16(dst + r * pitch + c, ok ? src + r * DH + c : src, ok);
  }
}

// Split rows [0, n) of a staged operand in place into its TF32 parts: the
// hi part stays where the float was, the lo part goes `lo_off` floats on
// (a second plane of the same pitch).  Done once per stage, so that no
// warp splits a shared operand again for each product.
template <int DH>
__device__ __forceinline__ void split_rows(float* x, int pitch, int lo_off,
                                           int n, int tid, int nthreads) {
  constexpr int kChunks = DH / 4;
  for (int e = tid; e < n * kChunks; e += nthreads) {
    float* p = x + (e / kChunks) * pitch + (e % kChunks) * 4;
    float4 v = *reinterpret_cast<float4*>(p);
    uint32_t h[4], l[4];
    split(v.x, h[0], l[0]);
    split(v.y, h[1], l[1]);
    split(v.z, h[2], l[2]);
    split(v.w, h[3], l[3]);
    *reinterpret_cast<float4*>(p) =
        make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                    __uint_as_float(h[2]), __uint_as_float(h[3]));
    *reinterpret_cast<float4*>(p + lo_off) =
        make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                    __uint_as_float(l[2]), __uint_as_float(l[3]));
  }
}

// The lane's part of one row (pointer already at the lane's first vector,
// row + kVec t): x[d] holds k-step d's two floats.  Zero when !live.
template <int DH>
__device__ __forceinline__ void load_row(const float* p, bool live,
                                         float (&x)[Geom<DH>::kDT][2]) {
  using G = Geom<DH>;
#pragma unroll
  for (int c = 0; c < G::kVecs; ++c) {
    if constexpr (G::kVec == 4) {
      const float4 r = live ? *reinterpret_cast<const float4*>(p + 16 * c)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      x[2 * c][0] = r.x;
      x[2 * c][1] = r.y;
      x[2 * c + 1][0] = r.z;
      x[2 * c + 1][1] = r.w;
    } else {
      const float2 r = live ? *reinterpret_cast<const float2*>(p + 8 * c)
                            : make_float2(0.f, 0.f);
      x[c][0] = r.x;
      x[c][1] = r.y;
    }
  }
}

// A fragments of the warp's 16 rows over dh, from rows g (x0) and g + 8
// (x1): k-step d is (x0[d][0], x1[d][0], x0[d][1], x1[d][1]).  Up to dh 32
// they are held split (hi, lo); at dh 64 as floats, split at each use: the
// two parts of dkv's k and v rows would take 128 registers a thread.
template <int DH>
struct RowsA {
  static constexpr int kDT = Geom<DH>::kDT;
  static constexpr bool kHeldSplit = DH <= 32;
  uint32_t a[kDT][4], b[kHeldSplit ? kDT : 1][4];

  __device__ __forceinline__ void load(const float* row0, bool live0,
                                       const float* row1, bool live1) {
    float x0[kDT][2], x1[kDT][2];
    load_row<DH>(row0, live0, x0);
    load_row<DH>(row1, live1, x1);
#pragma unroll
    for (int d = 0; d < kDT; ++d) {
      const float x[4] = {x0[d][0], x1[d][0], x0[d][1], x1[d][1]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (kHeldSplit)
          split(x[e], a[d][e], b[d][e]);
        else
          a[d][e] = __float_as_uint(x[e]);
      }
    }
  }

  // The parts of the k-steps of the lane's vector c (k-steps c kVec / 2
  // and on): hi[i], lo[i] for the i-th of them.
  __device__ __forceinline__ void chunk(int c,
                                        uint32_t (&hi)[Geom<DH>::kVec / 2][4],
                                        uint32_t (&lo)[Geom<DH>::kVec / 2][4])
      const {
#pragma unroll
    for (int i = 0; i < Geom<DH>::kVec / 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = c * (Geom<DH>::kVec / 2) + i;
        if constexpr (kHeldSplit) {
          hi[i][e] = a[d][e];
          lo[i][e] = b[d][e];
        } else {
          split(__uint_as_float(a[d][e]), hi[i][e], lo[i][e]);
        }
      }
  }
};

// The same fragments read from staged rows already split into planes (hi
// at row0 and row1, lo lo_off floats on) at each use, not held: dkv's k and
// v rows, which in registers would keep two blocks of 9 warps off an SM.
// The reads are volatile so that the compiler does not hoist them out of
// the loops into registers after all.
template <int DH>
struct PlanesA {
  uint32_t row0;   // shared address of row g's vector; row g + 8 follows
  int lo_bytes;    // from a hi plane to its lo plane

  __device__ __forceinline__ static void read(uint32_t a, float (&x)[4]) {
    if constexpr (Geom<DH>::kVec == 4) {
      asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                   : "=f"(x[0]), "=f"(x[1]), "=f"(x[2]), "=f"(x[3])
                   : "r"(a));
    } else {
      asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                   : "=f"(x[0]), "=f"(x[1])
                   : "r"(a));
    }
  }

  __device__ __forceinline__ void chunk(int c,
                                        uint32_t (&hi)[Geom<DH>::kVec / 2][4],
                                        uint32_t (&lo)[Geom<DH>::kVec / 2][4])
      const {
    const uint32_t r0 = row0 + 16 * Geom<DH>::kVec * c;
    const uint32_t r1 = r0 + 32 * Geom<DH>::kPR;   // 8 rows on
    float h0[4], h1[4], l0[4], l1[4];
    read(r0, h0);
    read(r1, h1);
    read(r0 + lo_bytes, l0);
    read(r1 + lo_bytes, l1);
#pragma unroll
    for (int i = 0; i < Geom<DH>::kVec / 2; ++i) {
      const float hv[4] = {h0[2 * i], h1[2 * i], h0[2 * i + 1], h1[2 * i + 1]};
      const float lv[4] = {l0[2 * i], l1[2 * i], l0[2 * i + 1], l1[2 * i + 1]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hi[i][e] = __float_as_uint(hv[e]);
        lo[i][e] = __float_as_uint(lv[e]);
      }
    }
  }
};

// The products below read a staged operand split into planes (hi at x,
// lo at x + lo_off; split_rows).  The tensor core rounds its sums toward
// zero, so a long chain of products into one accumulator drifts (by about
// 2e-4 over 600 rows of magnitude 25 in dk, measured): a sum over dh
// chains 3 dh / 8 products, at dh 64 with the large ones (hi hi) in an
// accumulator of their own, and a sum over rows goes to a fresh
// accumulator per chunk of 8 or 16 rows that the caller adds in float32.

// acc (16 x 8) += A . B^T over dh, A a RowsA or PlanesA, B the 8 staged
// rows whose row g starts at `b` (pitch kPR or kPC; `b` already at the
// lane's vector, + kVec t).
template <int DH, typename A>
__device__ __forceinline__ void mma_over_dh(float (&acc)[4], const A& a,
                                            const float* b, int lo_off) {
  using G = Geom<DH>;
  float xh[G::kDT][2], xl[G::kDT][2];
  load_row<DH>(b, true, xh);
  load_row<DH>(b + lo_off, true, xl);
  float big[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < G::kVecs; ++c) {
    uint32_t hi[G::kVec / 2][4], lo[G::kVec / 2][4];
    a.chunk(c, hi, lo);
#pragma unroll
    for (int i = 0; i < G::kVec / 2; ++i) {
      const int d = c * (G::kVec / 2) + i;
      const uint32_t h0 = __float_as_uint(xh[d][0]);
      const uint32_t h1 = __float_as_uint(xh[d][1]);
      mma_tf32(acc, lo[i], h0, h1);
      mma_tf32(acc, hi[i], __float_as_uint(xl[d][0]),
               __float_as_uint(xl[d][1]));
      if constexpr (DH == 64)
        mma_tf32(big, hi[i], h0, h1);
      else
        mma_tf32(acc, hi[i], h0, h1);
    }
  }
  if constexpr (DH == 64) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += big[e];
  }
}

// out (16 x dh, n-tile n = dims 8n .. 8n + 7) += P . X over 8 rows of a
// staged operand X (pitch kPC), P a warp accumulator (16 x 8); `x` is at
// X's row 2t of the 8-row group, column g.
template <int DH>
__device__ __forceinline__ void mma_over_rows(float (&out)[Geom<DH>::kDT][4],
                                              const float (&p)[4],
                                              const float* x, int lo_off) {
  uint32_t hi[4], lo[4];
  split(p[0], hi[0], lo[0]);
  split(p[2], hi[1], lo[1]);
  split(p[1], hi[2], lo[2]);
  split(p[3], hi[3], lo[3]);
  constexpr int kP = Geom<DH>::kPC;
#pragma unroll
  for (int n = 0; n < Geom<DH>::kDT; ++n) {
    const uint32_t h0 = __float_as_uint(x[8 * n]);
    const uint32_t h1 = __float_as_uint(x[kP + 8 * n]);
    mma_tf32(out[n], lo, h0, h1);
    mma_tf32(out[n], hi, __float_as_uint(x[lo_off + 8 * n]),
             __float_as_uint(x[lo_off + kP + 8 * n]));
    mma_tf32(out[n], hi, h0, h1);
  }
}

// out += P . X as mma_over_rows, through a fresh accumulator added in
// float32.
template <int DH>
__device__ __forceinline__ void add_over_rows(float (&out)[Geom<DH>::kDT][4],
                                              const float (&p)[4],
                                              const float* x, int lo_off) {
  float d[Geom<DH>::kDT][4];
#pragma unroll
  for (int n = 0; n < Geom<DH>::kDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[n][e] = 0.f;
  mma_over_rows<DH>(d, p, x, lo_off);
#pragma unroll
  for (int n = 0; n < Geom<DH>::kDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[n][e] += d[n][e];
}

// Store row g (r = 0) or g + 8 (r = 1) of the warp's 16 x dh accumulator
// (n-tile n holds dims 8n + 2t and 8n + 2t + 1), times `scale`, to `out`
// when `live`.  At dh >= 16 lanes t and t ^ 1 swap two floats of each
// pair of n-tiles, so that each stores 16 contiguous bytes: an even t dims
// 16c + 2t .. + 3, an odd t 16c + 6 + 2t .. + 3.  Every lane of the warp
// must call it.
template <int DH>
__device__ __forceinline__ void store_row(const float (&acc)[Geom<DH>::kDT][4],
                                          int r, float scale, float* out,
                                          bool live, int t) {
  if constexpr (DH == 8) {
    if (live)
      *reinterpret_cast<float2*>(out + 2 * t) =
          make_float2(acc[0][2 * r] * scale, acc[0][2 * r + 1] * scale);
  } else {
    const bool odd = t & 1;
#pragma unroll
    for (int c = 0; c < Geom<DH>::kDT / 2; ++c) {
      const float* lo = acc[2 * c];        // selects, not a runtime index
      const float* hi = acc[2 * c + 1];    // into registers
      const float y0 =
          __shfl_xor_sync(0xffffffffu, odd ? lo[2 * r] : hi[2 * r], 1);
      const float y1 = __shfl_xor_sync(
          0xffffffffu, odd ? lo[2 * r + 1] : hi[2 * r + 1], 1);
      const float m0 = odd ? hi[2 * r] : lo[2 * r];
      const float m1 = odd ? hi[2 * r + 1] : lo[2 * r + 1];
      const float4 v = odd ? make_float4(y0, y1, m0, m1)
                           : make_float4(m0, m1, y0, y1);
      if (live)
        *reinterpret_cast<float4*>(out + 16 * c + (odd ? 6 : 0) + 2 * t) =
            make_float4(v.x * scale, v.y * scale, v.z * scale, v.w * scale);
    }
  }
}

// Whether a plan (kernel.mha_plan's) fits the kernels at this dh: whole
// warps, no more than a block may run, stages of whole 16-row chunks.
template <int DH>
inline bool plan_fits(int rows, int stage) {
  return rows >= 16 && rows % 16 == 0 && rows <= 16 * Geom<DH>::kWarps &&
         stage >= 16 && stage % 16 == 0;
}

// Let `kernel` launch with `smem` bytes of dynamic shared memory (above
// 48 KB it must be allowed first); `allowed`, the kernel's own, only
// grows.  One device at a time, as the wrappers call it.
template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, int smem, int& allowed) {
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) allowed = smem;
  return err;
}

// Zero rows [r0, r1) of a (.., DH) output with 16-byte stores spread over
// threads [tid, nthreads).
template <int DH>
__device__ __forceinline__ void zero_rows(float* __restrict__ out, int r0,
                                          int r1, int tid, int nthreads) {
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  float4* o = reinterpret_cast<float4*>(out + static_cast<int64_t>(r0) * DH);
  for (int e = tid; e < (r1 - r0) * (DH / 4); e += nthreads) o[e] = z;
}

}  // namespace mha
