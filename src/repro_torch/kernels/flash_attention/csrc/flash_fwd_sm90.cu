// Causal (or full) flash attention forward for Hopper (sm_90a) in
// bfloat16: B7, `flash_attention`, on wgmma with TMA-fed K and V tiles.
//
// Replaces the TPU kernel `flash_attention_kernel` (`_flash_kernel`) in
// src/repro/kernels/flash_attention/kernel.py:281 for bfloat16 inputs
// (float32 inputs keep the CUDA-core kernel of flash_fwd.cu, whose float32
// products the LM's float32 parity relies on; TF32 would break it).
// Inputs in the models' layout, contiguous, read in place: q (B, Sq, H,
// dh), k and v (B, Sk, KV, dh); query head h reads KV head h / (H / KV).
// Output o (B, Sq, H, dh) in bfloat16:
//
//   s_ij = (q_i . k_j) * dh^-0.5 on keys j < Sk, and j <= i when causal
//          (top-left aligned when Sq != Sk, as in the reference);
//   o_i  = sum_j bf(exp(s_ij - m_i)) v_j / max(l_i, 1e-30),
//          l_i = sum_j exp(s_ij - m_i) (summed before the rounding bf()),
//
// an online softmax over key tiles in float32, where bf() rounds p to
// bfloat16 before p . v (the reference casts p the same way).  Masked
// scores are -1e30, as in the reference.
//
// What bounds it: the tensor cores.  At the LM prefill's shape (zamba2-7b,
// B = 2, S = 4096, 32 heads of 112, causal) one call does 240.6 GFLOP over
// the causal pairs and moves 0.12 GB: 0.243 ms at 989 TFLOP/s against 36 us
// of bytes.  The CUDA-core kernel it replaces reached 25 TFLOP/s.  Design,
// after FlashAttention-3:
//
//  * one block per (b, h, tile of 128 query rows), the (b, h) fastest, so
//    the heaviest causal tiles (the last query rows) of every head are
//    launched first; three warpgroups: two consumers of 64 query rows each,
//    and a producer whose one thread starts every TMA load;
//  * the producer loads the Q tile once and keeps the K and V tiles of the
//    key loop in flight through a two-stage ring on mbarriers (full: the
//    tile's bytes have landed; empty: both consumers are done with it); in
//    causal mode the loop ends at the tile holding the block's last
//    diagonal key;
//  * the tiles are TMA boxes of 64 head-dim columns (128 bytes, the 128-byte
//    swizzle) by 128 query rows or by the key tile; dh is padded to a
//    multiple of 64 (dh_pad) by TMA's zero fill past dh (zamba2-7b's 112:
//    columns 112-127 of the second box), and rows past Sq or Sk are zero;
//  * S = Q K^T: wgmma m64n{key tile}k16, Q and K both from swizzled shared
//    memory (K-major), over dh_pad / 16 steps; the scores of keys past Sk
//    or past the diagonal are set to -1e30 (a zero-filled key scores 0);
//  * the online softmax (m, l, alpha) stays in float32 registers, in the
//    exp2 domain (scores scaled by dh^-0.5 log2 e); p is rounded to
//    bfloat16 in registers and is the A operand of O += P V (wgmma
//    m64n{dh_pad}k16, V from shared memory, MN-major), as FlashAttention-3
//    reuses the S accumulator's layout;
//  * key tile 128 for dh_pad <= 128, 64 for 192 and 256 (shared memory:
//    Q + 2 stages of K and V, 80-193 KB; registers: the consumers raise
//    their limit to 232 with setmaxnreg, the producer drops to 40);
//  * 1 / max(l, 1e-30) in the epilogue; rows past Sq and columns past dh
//    are not written.
//
// The TMA descriptors are built on the host for every call with
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (the
// library links no libcuda), and passed as __grid_constant__ parameters.
//
// Plain C interface for ctypes; the wrapper (kernel.py) picks dh_pad and
// the key tile, allocates the output and raises on a non-zero return.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;              // query rows per block
constexpr int kConsumers = 2;         // warpgroups of 64 query rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kStages = 2;
constexpr int kBox = 64;              // head-dim columns per TMA box
constexpr int kRowBytes = kBox * 2;   // 128: one swizzled row of a box
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ----------------------------------------------------------- mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of a (dh, heads, seq, batch) tensor into shared memory.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int d, int h, int s,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(d),
      "r"(h), "r"(s), "r"(b)
      : "memory");
}

// ---------------------------------------------------------------- wgmma
// A shared-memory matrix descriptor of the 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (B128).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of wgmma's registers
// across the fence, commit and wait above.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// m64n64k16, both operands in shared memory (K-major), D (+)= A B.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// m64n64k16, A from registers, B in shared memory (MN-major), D += A B.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// m64n128k16, both operands in shared memory (K-major), D (+)= A B.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// m64n128k16, A from registers, B in shared memory (MN-major), D += A B.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// m64n192k16, A from registers, B in shared memory (MN-major), D += A B.
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, "
      "%79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "
      "%92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// m64n256k16, A from registers, B in shared memory (MN-major), D += A B.
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, "
      "%79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "
      "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, %112, %113, "
      "%114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int accumulate) {
  static_assert(N == 64 || N == 128, "key tile");
  if constexpr (N == 64)
    wgmma_ss_n64(d, a, b, accumulate);
  else
    wgmma_ss_n128(d, a, b, accumulate);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  static_assert(N == 64 || N == 128 || N == 192 || N == 256, "dh_pad");
  if constexpr (N == 64)
    wgmma_rs_n64(d, a, b);
  else if constexpr (N == 128)
    wgmma_rs_n128(d, a, b);
  else if constexpr (N == 192)
    wgmma_rs_n192(d, a, b);
  else
    wgmma_rs_n256(d, a, b);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int DHP, int BK>
struct Layout {
  static constexpr int kPanels = DHP / kBox;
  static constexpr int kQBytes = kPanels * kBQ * kRowBytes;
  static constexpr int kTileBytes = kPanels * BK * kRowBytes;  // K or V
  static constexpr int kSmem = kQBytes + 2 * kStages * kTileBytes + 1024;
};

// grid = (B * H, ceil(Sq / 128)); block = 384 threads.  Thread t of
// consumer warpgroup w holds query rows q0 + 64 w + 16 (t / 32) + (t % 32)
// / 4 and that + 8, as wgmma's accumulator lays them out.
template <int DHP, int BK>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          __nv_bfloat16* __restrict__ o, int sq, int sk,
                          int heads, int kv_heads, int dh, int causal,
                          float scale_log2) {
  using L = Layout<DHP, BK>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t q_full, full[kStages], empty[kStages];
  // The 128-byte swizzle repeats every 1024 bytes: tiles start on one.
  unsigned char* const base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* const qs = base;
  unsigned char* const ks = qs + L::kQBytes;             // [stage][panel]
  unsigned char* const vs = ks + kStages * L::kTileBytes;

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int kvh = h / (heads / kv_heads);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;     // heaviest first
  const int k_end = causal ? min(sk, q0 + kBQ) : sk;
  const int n_tiles = (k_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 128 * kConsumers) {
      mbar_expect_tx(&q_full, L::kQBytes);
#pragma unroll
      for (int p = 0; p < L::kPanels; ++p)
        tma_load(qs + p * kBQ * kRowBytes, &q_map, &q_full, p * kBox, h, q0,
                 b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(&empty[s], ((t / kStages) - 1) & 1);
        mbar_expect_tx(&full[s], 2 * L::kTileBytes);
        unsigned char* const kt = ks + s * L::kTileBytes;
        unsigned char* const vt = vs + s * L::kTileBytes;
#pragma unroll
        for (int p = 0; p < L::kPanels; ++p) {
          tma_load(kt + p * BK * kRowBytes, &k_map, &full[s], p * kBox, kvh,
                   t * BK, b);
          tma_load(vt + p * BK * kRowBytes, &v_map, &full[s], p * kBox, kvh,
                   t * BK, b);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int row = 16 * (tid / 32) + lane / 4;  // and row + 8
    const int qi0 = q0 + 64 * wg + row, qi1 = qi0 + 8;
    const int col = 2 * (lane % 4);              // and col + 1, of each 8
    const uint32_t q_addr = smem_u32(qs) + 64 * wg * kRowBytes;

    float acc[DHP / 2];
#pragma unroll
    for (int i = 0; i < DHP / 2; ++i) acc[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

    mbar_wait(&q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      mbar_wait(&full[s], (t / kStages) & 1);
      const uint32_t k_addr = smem_u32(ks + s * L::kTileBytes);
      const uint32_t v_addr = smem_u32(vs + s * L::kTileBytes);

      // S = Q K^T over dh_pad in steps of 16 (32 bytes of a swizzled row).
      float sc[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DHP / 16; ++kk) {
        const uint32_t panel = kk / 4, off = (kk % 4) * 32;
        wgmma_ss<BK>(sc,
                     smem_desc(q_addr + panel * kBQ * kRowBytes + off, 16,
                               1024),
                     smem_desc(k_addr + panel * BK * kRowBytes + off, 16,
                               1024),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // Mask, scale into the exp2 domain, and the tile's row maxima.
      const int k0 = t * BK;
      const bool edge =
          k0 + BK > sk || (causal && k0 + BK - 1 > q0 + 64 * wg);
      float mt0 = kNegInf, mt1 = kNegInf;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v0 = sc[4 * j + e] * scale_log2;
          float v1 = sc[4 * j + 2 + e] * scale_log2;
          if (edge) {
            const int kj = k0 + 8 * j + col + e;
            if (kj >= sk || (causal && kj > qi0)) v0 = kNegInf;
            if (kj >= sk || (causal && kj > qi1)) v1 = kNegInf;
          }
          sc[4 * j + e] = v0;
          sc[4 * j + 2 + e] = v1;
          mt0 = fmaxf(mt0, v0);
          mt1 = fmaxf(mt1, v1);
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, off));
        mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, off));
      }
      const float mn0 = fmaxf(m0, mt0), mn1 = fmaxf(m1, mt1);
      const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      l0 *= alpha0;
      l1 *= alpha1;

      // p = exp2(s - m): l sums it in float32, P V takes it in bfloat16.
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const float p0 = exp2f(sc[4 * j] - mn0);
        const float p1 = exp2f(sc[4 * j + 1] - mn0);
        const float p2 = exp2f(sc[4 * j + 2] - mn1);
        const float p3 = exp2f(sc[4 * j + 3] - mn1);
        l0 += p0 + p1;
        l1 += p2 + p3;
        // Keys 8j..8j+7 are half of the k16 step j / 2: a0/a1 for the
        // first half, a2/a3 for the second.
        pa[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
        pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
      }
#pragma unroll
      for (int j = 0; j < DHP / 8; ++j) {
        acc[4 * j] *= alpha0;
        acc[4 * j + 1] *= alpha0;
        acc[4 * j + 2] *= alpha1;
        acc[4 * j + 3] *= alpha1;
      }

      // O += P V: 16 keys a step; V's rows (keys) are the K dimension and
      // its 64-column boxes the N dimension (LBO: the box stride).
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<DHP>(acc, pa[kk],
                      smem_desc(v_addr + kk * 16 * kRowBytes,
                                BK * kRowBytes, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      mbar_arrive(&empty[s]);
    }

    // Epilogue: the row sums over the quad, then o = acc / max(l, 1e-30).
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-30f);
    const float inv1 = 1.f / fmaxf(l1, 1e-30f);
    const int64_t row_stride = static_cast<int64_t>(heads) * dh;
    __nv_bfloat16* const o0 =
        o + (static_cast<int64_t>(b) * sq + qi0) * row_stride + h * dh + col;
    __nv_bfloat16* const o1 = o0 + 8 * row_stride;
#pragma unroll
    for (int j = 0; j < DHP / 8; ++j) {
      if (8 * j >= dh) break;
      if (qi0 < sq)
        *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
      if (qi1 < sq)
        *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * j) = __floats2bfloat162_rn(
            acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
    }
  }
}

// ----------------------------------------------------------------- host
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

cudaError_t encode_fn(EncodeTiledFn* fn) {
  static EncodeTiledFn cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiledFn>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// A (dh, heads, seq, batch) bfloat16 tensor, boxes of 64 columns by `rows`
// rows of one head, 128-byte swizzle, zero past every edge.
cudaError_t make_map(EncodeTiledFn encode, CUtensorMap* map, const void* ptr,
                     int dh, int heads, int seq, int batch, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = static_cast<cuuint64_t>(dh) * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * seq};
  const cuuint32_t box[4] = {kBox, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int DHP, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int b, int sq, int sk, int heads, int kv_heads, int dh,
                   int causal, float scale, cudaStream_t stream) {
  constexpr int bytes = Layout<DHP, BK>::kSmem;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_sm90_kernel<DHP, BK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  EncodeTiledFn encode;
  cudaError_t err = encode_fn(&encode);
  if (err != cudaSuccess) return err;
  CUtensorMap qm, km, vm;
  if ((err = make_map(encode, &qm, q, dh, heads, sq, b, kBQ)) != cudaSuccess ||
      (err = make_map(encode, &km, k, dh, kv_heads, sk, b, BK)) !=
          cudaSuccess ||
      (err = make_map(encode, &vm, v, dh, kv_heads, sk, b, BK)) !=
          cudaSuccess)
    return err;
  const dim3 grid(b * heads, (sq + kBQ - 1) / kBQ);
  flash_fwd_sm90_kernel<DHP, BK><<<grid, kThreads, bytes, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), sq, sk, heads, kv_heads,
      dh, causal, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bfloat16 q, k, v, o; dh_pad and key_tile as kernel.flash_plan chooses
// them.  `scale` is dh^-0.5 as the wrapper rounds it to float32.  Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a (dh_pad, key_tile) without an instantiation
// or a tensor TMA cannot describe.
int mrsch_flash_fwd_sm90(const void* q, const void* k, const void* v,
                         void* o, int b, int sq, int sk, int heads,
                         int kv_heads, int dh, int dh_pad, int key_tile,
                         int causal, float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dh > dh_pad || dh % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
#define MRSCH_FLASH_CASE(DHP, BK)                                         \
  if (dh_pad == DHP && key_tile == BK)                                    \
    return static_cast<int>(launch<DHP, BK>(q, k, v, o, b, sq, sk, heads, \
                                            kv_heads, dh, causal, scale, s));
  MRSCH_FLASH_CASE(64, 128)
  MRSCH_FLASH_CASE(128, 128)
  MRSCH_FLASH_CASE(192, 64)
  MRSCH_FLASH_CASE(256, 64)
#undef MRSCH_FLASH_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* mrsch_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
