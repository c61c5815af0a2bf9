// The bf16 tensor-core core of the precision modes "high" and "default"
// (used by ffn.cu): Hopper's warpgroup products (wgmma) fed by the Tensor
// Memory Accelerator (TMA) through a ring of shared-memory stages, each
// completed on an mbarrier.
//
// Replaces the TPU arithmetic of keypoints_interpolation_transformer_tpu/
// ops/pallas/ffn.py under those modes: _split_hi_lo / _split_hi_lo_kernel
// (a float32 x becomes hi = bf16(x) and lo = bf16(x - hi), both rounded to
// nearest even: split2 in grad.cuh), _dot3 / _dot_parts (a product of
// split operands is A_hi B_hi + A_hi B_lo + A_lo B_hi, every term summed in
// float32: "high", XLA's bf16_3x on the TPU) and the single bf16 pass of
// _prep_act ("default", A_hi B_hi).  A product of two bf16 values is exact
// in float32, so only the rounding of the operands and the order of the
// float32 sums differ from the plain version (ops/kernels/precision.py).
//
// What bounds these products on an H100: the tensor cores, 989 TFLOP/s of
// bf16 (three passes for "high"), reached only through wgmma, and keeping
// them fed: a weight tile has to be in shared memory before the product that
// reads it, without a barrier of the whole block in the way.  So:
//   * each term is one wgmma.mma_async m64nNk16 (bf16 in, float32
//     accumulate) of a warpgroup (4 warps, 64 rows); "high" issues its three
//     terms into one accumulator at every 16-deep step, "default" one;
//   * operands in shared memory sit in the 128-byte swizzled layout that
//     both TMA and wgmma read: rows of 64 bf16 (128 bytes), 8-row atoms of
//     1 KB whose 16-byte chunks are permuted by the row (chunk ^ row % 8), so
//     neither the copy nor the product meets bank conflicts.  A K-major
//     operand (contraction axis contiguous: the forward's weights and rows)
//     advances 32 bytes a 16-deep step inside its atom; an MN-major one
//     (output axis contiguous: the weight-gradient products, which contract
//     over token rows, read dz, du, gelu(u) and x1 as they lie in memory)
//     advances 16 rows, 2 KB, with no transpose anywhere;
//   * a producer warpgroup keeps the ring of stages filled by TMA (one
//     thread issues whole tiles; out-of-bounds rows and columns arrive as
//     zeros, so ragged edges need no code; the group's registers go to the
//     consumers), and the two consumer warpgroups wait on each stage's
//     "full" mbarrier and release it on its "empty" one once the products
//     reading it are done (wgmma.wait_group 1 keeps the next stage's
//     products in flight meanwhile).
// The tensor maps are encoded on the host per call (cuTensorMapEncodeTiled,
// found through the runtime's driver entry point: nothing links libcuda).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace kit {

typedef __nv_bfloat16 bf16;

constexpr int TC_TILE = 64 * 128 * 2;    // bytes of one plane of a 128 x 64 (or 64 x 128) tile
constexpr int CONSUMER_WARPS = 8;      // two warpgroups
// and a producer warpgroup (one of its threads issues the copies), whose
// registers the consumers take (setmaxnreg): 384 threads start at 168
// registers each, the producer gives back all but 40 and each consumer
// thread takes 232.
constexpr int WG_THREADS = 32 * CONSUMER_WARPS + 128;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int MAX_STAGES = 6;
// the dynamic shared memory a tensor-core block may lay out: an H100
// block's 232,448 bytes less 1 KB for aligning the swizzled tiles and 1 KB
// for the barriers
constexpr int TC_SMEM = 232448 - 2048;

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory rounded up to the 1 KB the swizzle repeats on.
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// Byte offset of element (r, k) of a K-major tile of `rows` rows held as
// 64-wide k blocks (each rows x 128 bytes), in the 128-byte swizzle.
__device__ __forceinline__ uint32_t swizzled(int r, int k, int rows) {
  return (k >> 6) * rows * 128 + r * 128 + ((((k >> 3) & 7) ^ (r & 7)) << 4) + ((k & 7) << 1);
}

// ---- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Generic-proxy writes to shared memory made visible to wgmma and TMA.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
// (No timeout that traps: a trap is a divergent exit, and ptxas then
// serializes every wgmma of the kernel and ignores setmaxnreg.)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
}

// Consumer barrier of the two warpgroups (named barrier 1, 256 threads):
// the producer takes no part.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * CONSUMER_WARPS) : "memory");
}

// The warp's and the warpgroup's index, uniform as far as the compiler can
// see (a branch on them is then not divergent: wgmma in a path the compiler
// takes for divergent is serialized, and setmaxnreg is not honoured).
__device__ __forceinline__ int warp_index() { return __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0); }
__device__ __forceinline__ int warpgroup_index() {
  return __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
}

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// A ring position: stage and the parity of its current round.
struct RingPos {
  int stage = 0, phase = 0;
  template <int STAGES>
  __device__ __forceinline__ void advance() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// ---- TMA -----------------------------------------------------------------------

// Box (c0, c1) of the map (c0 the column, innermost) into shared memory,
// completing `bytes` on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// ---- wgmma -----------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses to an accumulator across an
// asynchronous product (the registers change under it until the wait).
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptors in the 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units).  K-major: 8-row atoms 1
// KB apart (the leading offset unused).  MN-major: 8-row (k) atoms 1 KB
// apart, 64-wide blocks of the output axis `lead` bytes apart.
__device__ __forceinline__ uint64_t desc_encode(uint32_t x) { return (uint64_t)((x & 0x3FFFF) >> 4); }
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return desc_encode(addr) | (desc_encode(16) << 16) | (desc_encode(1024) << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, uint32_t lead) {
  return desc_encode(addr) | (desc_encode(lead) << 16) | (desc_encode(1024) << 32) | (1ull << 62);
}

// d (m64n64, float32) += A B, both from shared memory (descriptors da, db);
// TA / TB: 0 K-major, 1 MN-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d (m64n128, float32) += A B, both from shared memory (descriptors da, db);
// TA / TB: 0 K-major, 1 MN-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d (m64n64, float32) += A B, A from registers (the m64k16 fragment, a[4])
// and B from shared memory (descriptor db, K-major).
__device__ __forceinline__ void wgmma_rs64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64n128, float32) += A B, A from registers (the m64k16 fragment, a[4])
// and B from shared memory (descriptor db; TB 0 K-major, 1 MN-major).
template <int TB = 0>
__device__ __forceinline__ void wgmma_rs128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}


// d (m64n96, float32) += A B, A from registers (the m64k16 fragment, a[4])
// and B from shared memory (descriptor db; TB 0 K-major, 1 MN-major).
template <int TB = 0>
__device__ __forceinline__ void wgmma_rs96(float (&d)[48], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, %54;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

// d (m64n32, float32) += A B, A from registers (the m64k16 fragment, a[4])
// and B from shared memory (descriptor db; TB 0 K-major, 1 MN-major).
template <int TB = 0>
__device__ __forceinline__ void wgmma_rs32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

// ---- host side ---------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a row-major bf16 matrix (rows x cols, row stride ld >= cols,
// a multiple of 8) read in boxes of 64 columns x box_rows rows, 128-byte
// swizzled, zero-filled out of bounds; a null base leaves the map zero (a
// plane the mode does not read).
inline int plane_map(CUtensorMap* m, const bf16* base, int rows, int cols, int box_rows,
                     int ld) {
  *m = CUtensorMap{};
  if (base == nullptr) return 0;
  EncodeTiled f = encode_tiled();
  if (f == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(bf16)};
  const cuuint32_t box[2] = {64u, (cuuint32_t)box_rows}, unit[2] = {1u, 1u};
  const CUresult r = f(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(base), dims,
                       strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                       CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                       CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// plane_map of a matrix whose row stride is its width.
inline int plane_map(CUtensorMap* m, const bf16* base, int rows, int cols, int box_rows) {
  return plane_map(m, base, rows, cols, box_rows, cols);
}

}  // namespace kit
