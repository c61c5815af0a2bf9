// One dense layer y = x W + b in the precision modes "high" (bf16x3) and
// "default" (one bf16 pass): the forward (kit_mode_linear, W's planes made
// once per weight version by kit_mode_linear_weight) and the backward
// (kit_mode_linear_bwd).
//
// No Pallas body stands behind it.  It replaces the products the JAX
// package leaves to XLA under those modes: its nn.Dense layers (the
// training route's pointwise chains, the per-op q / k / v and
// out-projections, the Embedding autoencoder, the serving chains where its
// pointwise kernels do not run), which run under the ambient
// jax.default_matmul_precision (train/loop.py, eval/serving.py) and which
// XLA on the TPU takes as bf16_3x ("high") or one bf16 pass ("default"),
// their transposed products in the backward at the same precision.  It
// exists so that those products round as the TPU rounds them.  The
// contract:
//   * forward: y = x_hi W_hi + x_hi W_lo + x_lo W_hi at "high", x_hi W_hi at
//     "default" (hi = bf16(v), lo = bf16(v - hi), both rounded to nearest
//     even), the float32 sum then + b;
//   * backward: dx = g W^T and dW = x^T g, each from the bf16 parts of its
//     two operands in the same mode; db = the column sums of g in float32.
//
// What bounds it on an H100: the bytes for the model's layers (x in, y out:
// a q / k / v projection of 8192 rows, 256 -> 768, moves 34 MB for 3.2
// GFLOP of bf16 products, three passes at "high", some 0.010 ms of memory
// against 0.003-0.010 of tensor cores); and, at these sizes, the host: a
// call's device time is some 0.02 ms, as long as a few launches' host work.
//
// Design of the forward (mode_linear_kernel): ONE launch a call.  The
// tensor-core ring of tc_gemm.cuh (128 x 128 output tiles, a producer
// warpgroup issuing TMA into an mbarrier ring, two consumer warpgroups of
// 64 rows on wgmma m64n128k16, two accumulators over even and odd stages)
// with x read in float32: each 64-deep stage holds x's 128 rows as two
// 32-float TMA boxes (128-byte swizzled; TMA zero-fills past K and M, so
// 108 columns need no padding pass) beside W's planes (MN-major 64 x 64
// boxes, as tc_gemm_kernel's TB 1 reads them).  The consumers split x in
// registers: a thread loads its m64k16 A fragment's float pairs from the
// swizzled box (two wavefronts a warp, the least for 256 bytes), rounds
// them to hi / lo and feeds them to wgmma as a register A (the RS form).
// Chosen over a bf16 stage in shared memory in wgmma's layout: no second
// copy of x through shared memory (16 KB a stage at "high"), no barrier
// of the warpgroup between the split and the product, and the fragment a
// thread splits is the one it multiplies.  Each parity of stages keeps its
// own fragment registers, so a stage's products are in flight while the
// next stage is split.  The three products of a 16-deep step at "high" go
// into one accumulator in tc_gemm_kernel's order (hi hi, hi lo, lo hi).
// When the caller asks for x's planes, as ModeLinearFunction does for its
// backward, the blocks write them too (rows padded to pad16(K) columns with
// TMA's zeros, the same bits split_rows_kernel writes), each 64-deep stage
// by one column of output tiles in turn, so no column carries all the
// writes; a serving call writes nothing but y.  W's planes and
// their tensor maps are made once per weight version
// (kit_mode_linear_weight; the wrapper keeps them): a call encodes one
// map (x's) and launches one kernel.
//
// Design of the backward: tc_gemm_kernel as in tc_gemm.cuh:
//   backward split g; dx = g W^T with W's planes read K-major (TB 0); dW =
//            x^T g with x's planes as an MN-major A (TA 1) over `splits`
//            row ranges, added in order (sum_split); db = the column sums
//            of g over `vsplits` row ranges (bias_sum_kernel: 16-byte loads,
//            8 warps a range), added in order (sum_parts).  No sum uses
//            atomics: a gradient has the same bits from run to run.
#include <string.h>

#include "common.cuh"
#include "grad.cuh"
#include "mma_bf16.cuh"
#include "sgemm_grad.cuh"
#include "tc_gemm.cuh"

using namespace kit;

// (A kernel in namespace kit: see attention_modes.cu.)
namespace kit {

// db's partial sums: part[z * N + c] = the sum of g's column c over the
// rows [z rows, (z + 1) rows), 4 columns a lane (16-byte loads), the 8
// warps of a block over the range's rows, then added in order of the
// warps; sum_parts adds the ranges in order.
__global__ void __launch_bounds__(NT) bias_sum_kernel(const float* __restrict__ g, int M, int N,
                                                      int rows, float* __restrict__ part) {
  __shared__ float4 red[NT / 32][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = 128 * blockIdx.x + 4 * lane, r1 = min(M, (int)(blockIdx.y + 1) * rows);
  const bool in = c < N;  // N is a multiple of 4
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r = blockIdx.y * rows + warp; r < r1 && in; r += NT / 32) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(g + (size_t)r * N + c));
    s = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp != 0 || !in) return;
  float4 t = red[0][lane];
  for (int w = 1; w < NT / 32; ++w) {
    const float4 v = red[w][lane];
    t = make_float4(t.x + v.x, t.y + v.y, t.z + v.z, t.w + v.w);
  }
  *reinterpret_cast<float4*>(part + (size_t)blockIdx.y * N + c) = t;
}

// ---- the forward ------------------------------------------------------------

struct LinMaps {
  CUtensorMap x;     // x (M, K) float32, 32 x 128 boxes, 128-byte swizzle
  CUtensorMap w[2];  // W's planes (K, pad16(N)), 64 x 64 boxes (the lo map zero at "default")
};

struct LinArgs {
  int M, N, K, KP;    // KP = pad16(K): the width of x's planes
  const float* bias;  // (N) or null
  float* y;           // (M, N)
  bf16 *xh, *xl;      // x's planes (M, KP) or null; xl null at "default"
};

template <int PASSES>
struct LinFwd {
  static constexpr int PLANES = PASSES == 3 ? 2 : 1;
  static constexpr int XBOX = 128 * 32 * 4;  // one 32-float box of x's 128 rows
  static constexpr int STAGE = 2 * XBOX + PLANES * TC_TILE;
  static constexpr int STAGES = cmin(MAX_STAGES, TC_SMEM / STAGE);
  static constexpr int SMEM = STAGES * STAGE + 1024;
  static constexpr int LDC = 128 + 8;  // the output tile's row stride in the ring, floats
  static_assert(STAGES >= 3, "a ring of at least three stages");
  static_assert(128 * LDC * 4 <= STAGES * STAGE, "the output tile fits the ring");
};

// The float pair (r, c), (r, c + 1) of a 128-byte swizzled box of 32-float
// rows (c even).
__device__ __forceinline__ float2 box_pair(const unsigned char* box, int r, int c) {
  return *reinterpret_cast<const float2*>(box + r * 128 + ((((c >> 2) ^ r) & 7) << 4) +
                                          ((c & 3) << 2));
}

// y (M, N) = x W + b over 128 x 128 tiles (see the note at the top).
template <int PASSES>
__global__ void __launch_bounds__(WG_THREADS, 1)
    mode_linear_kernel(const __grid_constant__ LinMaps mp, const LinArgs p) {
  using G = LinFwd<PASSES>;
  constexpr int STAGES = G::STAGES;
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  const int warp = warp_index(), lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * 128, n0 = blockIdx.x * 128;
  const int steps = (p.K + 63) / 64;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int role = warpgroup_index();
  if (role == 2) {  // the producer
    reg_dealloc<PRODUCER_REGS>();
    if (warp == CONSUMER_WARPS && lane == 0) {
      RingPos at;
      for (int kt = 0; kt < steps; ++kt) {
        const int k0 = 64 * kt;
        mbar_wait(&empty[at.stage], at.phase ^ 1);
        unsigned char* sb = ring + at.stage * G::STAGE;
        uint64_t* bar = &full[at.stage];
        mbar_expect_tx(bar, G::STAGE);
        tma_load(sb, &mp.x, k0, m0, bar);
        tma_load(sb + G::XBOX, &mp.x, k0 + 32, m0, bar);
        for (int pl = 0; pl < G::PLANES; ++pl) {
          unsigned char* sw = sb + 2 * G::XBOX + pl * TC_TILE;
          tma_load(sw, &mp.w[pl], n0, k0, bar);
          tma_load(sw + TC_TILE / 2, &mp.w[pl], n0 + 64, k0, bar);
        }
        at.advance<STAGES>();
      }
    }
    return;
  }

  reg_alloc<CONSUMER_REGS>();
  const int wg = role, wq = warp & 3, g = lane >> 2, t = lane & 3;
  const int r0 = 64 * wg + 16 * wq + g;  // the thread's rows of the tile: r0 and r0 + 8
  // x's planes, when asked, are written by the column of tiles kt % its
  // width of each 64-deep stage kt: the writes spread over the columns
  const bool planes = p.xh != nullptr;
  float acc[64], acc1[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = acc1[e] = 0.f;
  // each parity of stages splits into its own fragments: a stage's
  // products read them while the next stage is split
  uint32_t fh0[4][4], fl0[4][4], fh1[4][4], fl1[4][4];
  RingPos at;
  int prev = -1, kt = 0;
  auto stage = [&](float(&d)[64], uint32_t(&fh)[4][4], uint32_t(&fl)[4][4]) {
    mbar_wait(&full[at.stage], at.phase);
    const unsigned char* sb = ring + at.stage * G::STAGE;
    // the A fragment of 16-deep step s: (r0, c), (r0 + 8, c), (r0, c + 8),
    // (r0 + 8, c + 8), c = 16 s + 2 t, in box s / 2
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const unsigned char* box = sb + (s >> 1) * G::XBOX;
      const int c = 16 * (s & 1) + 2 * t;
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const float2 v = box_pair(box, r0 + 8 * (h & 1), c + 8 * (h >> 1));
        split2(v.x, v.y, fh[s][h], fl[s][h]);
      }
    }
    if (planes && kt % (int)gridDim.x == (int)blockIdx.x) {  // past K: TMA's zeros
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int col = 64 * kt + 16 * s + 2 * t;
        if (col >= p.KP) break;
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int m = m0 + r0 + 8 * (h & 1);
          if (m >= p.M) continue;
          const size_t o = (size_t)m * p.KP + col + 8 * (h >> 1);
          *reinterpret_cast<uint32_t*>(p.xh + o) = fh[s][h];
          if (PASSES == 3) *reinterpret_cast<uint32_t*>(p.xl + o) = fl[s][h];
        }
      }
    }
    const uint32_t b0 = smem_u32(sb + 2 * G::XBOX);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint32_t b = b0 + s * 2048;
      wgmma_rs128<1>(d, fh[s], desc_mn(b, TC_TILE / 2));
      if (PASSES == 3) {
        wgmma_rs128<1>(d, fh[s], desc_mn(b + TC_TILE, TC_TILE / 2));
        wgmma_rs128<1>(d, fl[s], desc_mn(b, TC_TILE / 2));
      }
    }
    wgmma_commit();
    if (prev >= 0) {
      wgmma_wait<1>();
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[prev]);
    }
    prev = at.stage;
    at.advance<STAGES>();
    ++kt;
  };
  while (kt < steps) {
    stage(acc, fh0, fl0);
    if (kt < steps) stage(acc1, fh1, fl1);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  fence_acc(acc1);
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] += acc1[e];
  if (prev >= 0) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[prev]);
  }
  // the tile through shared memory (the ring is free once both groups are
  // done), then whole rows of it: 4 columns a lane, 16-byte accesses
  consumers_sync();
  float* Cs = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int jj = 0; jj < 16; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(Cs + (64 * wg + 16 * wq + g + 8 * h) * G::LDC + 8 * jj + 2 * t) =
          make_float2(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]);
  consumers_sync();
  const int c = n0 + 4 * lane;
  if (c >= p.N) return;  // N is a multiple of 4: the lane's 4 columns are in or out
  const float4 bias = p.bias == nullptr ? make_float4(0.f, 0.f, 0.f, 0.f)
                                        : __ldg(reinterpret_cast<const float4*>(p.bias + c));
  for (int rr = warp; rr < 128; rr += CONSUMER_WARPS) {
    const int m = m0 + rr;
    if (m >= p.M) break;
    float4 v = *reinterpret_cast<const float4*>(Cs + rr * G::LDC + 4 * lane);
    if (p.bias != nullptr) v = make_float4(v.x + bias.x, v.y + bias.y, v.z + bias.z, v.w + bias.w);
    *reinterpret_cast<float4*>(p.y + (size_t)m * p.N + c) = v;
  }
}

}  // namespace kit

namespace {

#define KIT_CHECK(x) \
  if ((rc = (x)) != 0) return rc

// A width padded to the planes' row multiple: 16 bf16 (the product's k
// step, and 32 bytes).
constexpr int pad16(int n) { return (n + 15) / 16 * 16; }

// The map of x (M, K) float32 (row stride K, 16-byte multiple) read in
// boxes of 32 columns x 128 rows, 128-byte swizzled, zero-filled out of
// bounds.
int x_map(CUtensorMap* m, const float* x, int M, int K) {
  *m = CUtensorMap{};
  EncodeTiled f = encode_tiled();
  if (f == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)K * sizeof(float)};
  const cuuint32_t box[2] = {32u, 128u}, unit[2] = {1u, 1u};
  const CUresult r = f(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(x), dims, strides,
                       box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                       CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int PASSES>
int forward(const float* x, int M, int K, int N, const CUtensorMap* wmaps, const float* b,
            float* y, bf16* xh, bf16* xl, cudaStream_t st) {
  using G = LinFwd<PASSES>;
  static bool ready = false;
  cudaError_t e = allow_smem(mode_linear_kernel<PASSES>, G::SMEM, ready);
  if (e != cudaSuccess) return (int)e;
  LinMaps mp;
  int rc = x_map(&mp.x, x, M, K);
  if (rc) return rc;
  mp.w[0] = wmaps[0];
  mp.w[1] = wmaps[1];
  const LinArgs p{M, N, K, pad16(K), b, y, xh, PASSES == 3 ? xl : nullptr};
  const dim3 grid((N + 127) / 128, (M + 127) / 128);
  mode_linear_kernel<PASSES><<<grid, WG_THREADS, G::SMEM, st>>>(mp, p);
  return (int)cudaGetLastError();
}

template <int PASSES>
int backward(const float* g, int M, int K, int N, const bf16* xh, const bf16* xl, const bf16* wh,
             const bf16* wl, float* dx, float* dw, float* db, int splits, int vsplits, bf16* gh,
             bf16* gl, float* part, cudaStream_t st) {
  const int KP = pad16(K), NP = pad16(N);
  int rc;
  if (M <= 0) {
    if (dw != nullptr) KIT_CHECK((int)cudaMemsetAsync(dw, 0, (size_t)K * N * sizeof(float), st));
    if (db != nullptr) KIT_CHECK((int)cudaMemsetAsync(db, 0, (size_t)N * sizeof(float), st));
    return 0;
  }
  KIT_CHECK(split_rows(g, M, N, NP, gh, gl, st));
  if (dx != nullptr) {  // dx[m][k] = sum_c g[m][c] W[k][c]: W's planes K-major
    GemmArgs p{};
    p.M = M;
    p.N = K;
    p.K = NP;
    p.out = dx;
    p.ldo = K;
    KIT_CHECK((tc_gemm_ld<PASSES, 0, EPI_STORE, 0>(gh, gl, M, NP, NP, wh, wl, K, NP, NP, p, 1, st)));
  }
  if (dw != nullptr) {  // dW[k][c] = sum_m x[m][k] g[m][c], per row range of m
    GemmArgs p{};
    p.M = K;
    p.N = N;
    p.K = M;
    p.ldo = N;
    p.split = (size_t)K * N;
    p.out = splits > 1 ? part : dw;
    KIT_CHECK((tc_gemm_ld<PASSES, 1, EPI_STORE, 1>(xh, xl, M, KP, KP, gh, gl, M, NP, NP, p, splits,
                                                   st)));
    if (splits > 1) KIT_CHECK(sum_split(part, splits, p.split, K * N, dw, st));
  }
  if (db != nullptr) {
    float* vpart = part + (splits > 1 ? (size_t)splits * K * N : 0);
    bias_sum_kernel<<<dim3((N + 127) / 128, vsplits), NT, 0, st>>>(g, M, N,
                                                                  (M + vsplits - 1) / vsplits, vpart);
    KIT_CHECK((int)cudaGetLastError());
    KIT_CHECK(sum_parts(vpart, vsplits, N, db, st));
  }
  return 0;
}

#undef KIT_CHECK

bool planes_ok(int passes, const void* a, const void* b) {
  return passes == 1 || (passes == 3 && a != nullptr && b != nullptr);
}

}  // namespace

// W (K, N) float32 -> its planes wh / wl (K, pad16(N)) in mode passes (3
// "high", 1 "default"; wl null then), the columns past N zero, and their
// two tensor maps, encoded here once, into maps (host memory, two
// CUtensorMap; the second zero at "default"): what kit_mode_linear reads,
// kept by the caller while W is unchanged.  K and N multiples of 4.
extern "C" int kit_mode_linear_weight(int passes, const void* w, int K, int N, void* wh, void* wl,
                                      void* maps, void* stream) {
  if (!planes_ok(passes, wh, wl) || K <= 0 || N <= 0 || K % 4 || N % 4 || maps == nullptr)
    return (int)cudaErrorInvalidValue;
  const int NP = pad16(N);
  int rc = split_rows((const float*)w, K, N, NP, (bf16*)wh, passes == 3 ? (bf16*)wl : nullptr,
                      (cudaStream_t)stream);
  if (rc) return rc;
  CUtensorMap m[2];  // rows past K read as zeros
  if ((rc = plane_map(&m[0], (const bf16*)wh, K, NP, 64)) ||
      (rc = plane_map(&m[1], passes == 3 ? (const bf16*)wl : nullptr, K, NP, 64)))
    return rc;
  memcpy(maps, m, sizeof(m));
  return 0;
}

// x (M, K) -> y (M, N) = x W + b in mode passes (3 "high", 1 "default"):
// one launch.  wmaps: kit_mode_linear_weight's maps of W's planes (host
// memory); b (N) or null.  xh / xl (M, pad16(K)) receive x's planes, or
// are null (xl null at "default").  x and y 16-byte aligned; K and N
// multiples of 4.
extern "C" int kit_mode_linear(int passes, const void* x, int M, int K, int N, const void* wmaps,
                               const void* b, void* y, void* xh, void* xl, void* stream) {
  if (!(passes == 1 || passes == 3) || (passes == 3 && xh != nullptr && xl == nullptr) ||
      wmaps == nullptr || M < 0 || K <= 0 || N <= 0 || K % 4 || N % 4)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  CUtensorMap w[2];
  memcpy(w, wmaps, sizeof(w));
  auto f = passes == 3 ? forward<3> : forward<1>;
  return f((const float*)x, M, K, N, w, (const float*)b, (float*)y, (bf16*)xh, (bf16*)xl,
           (cudaStream_t)stream);
}

// The gradients of kit_mode_linear's y given g = dL/dy (M, N), from the
// forward's planes of x (xh / xl, (M, pad16(K))) and of W (wh / wl, (K,
// pad16(N))): dx (M, K), dW (K, N) and db (N), each null when not wanted.
// dW sums over `splits` row ranges, db over `vsplits`.  gh / gl: (M,
// pad16(N)) bf16 scratch; part: (splits > 1 ? splits K N : 0) + vsplits N
// floats.
extern "C" int kit_mode_linear_bwd(int passes, const void* g, int M, int K, int N, const void* xh,
                                   const void* xl, const void* wh, const void* wl, void* dx,
                                   void* dw, void* db, int splits, int vsplits, void* gh, void* gl,
                                   void* part, void* stream) {
  if (!planes_ok(passes, wl, xl) || !planes_ok(passes, gl, xh) || M < 0 || K <= 0 || N <= 0 ||
      K % 4 || N % 4 || splits < 1 || vsplits < 1)
    return (int)cudaErrorInvalidValue;
  auto f = passes == 3 ? backward<3> : backward<1>;
  return f((const float*)g, M, K, N, (const bf16*)xh, (const bf16*)xl, (const bf16*)wh,
           (const bf16*)wl, (float*)dx, (float*)dw, (float*)db, splits, vsplits, (bf16*)gh,
           (bf16*)gl, (float*)part, (cudaStream_t)stream);
}
