// The one-launch product of a float32 matrix and a weight's bf16 planes in
// the precision modes "high" (bf16x3) and "default" (one bf16 pass):
// mode_linear_kernel and its launch (linear_launch).  mode_linear.cu runs
// it for mode_linear's forward (y = x W + b, W's planes MN-major) and for
// its backward's dx = g W^T (W's planes K-major, g's planes and the column
// sums of g beside it); attn_sublayer_modes.cu for the training forward's k
// / v projection of a memory.  See mode_linear.cu's note for the design.
#pragma once

#include "common.cuh"
#include "grad.cuh"
#include "mma_bf16.cuh"

namespace kit {

struct LinMaps {
  CUtensorMap x;     // the float32 A (M, K), 32 x 128 boxes, 128-byte swizzle
  CUtensorMap w[2];  // W's planes: MN-major (K, pad16(N)) 64 x 64 boxes, 128-byte
                     // swizzle (TB 1), or K-major (N, pad16(K)) 32 x 128 boxes,
                     // 64-byte swizzle (TB 0); lo zero at "default"
};

struct LinArgs {
  int M, N, K, KP;    // y (M, N) = A (M, K) B; KP = pad16(K): the width of A's planes
  const float* bias;  // (N) or null
  float* y;           // (M, N), row stride ldy
  int ldy;
  bf16 *xh, *xl;      // A's planes (M, KP) or null; xl null at "default"
  float* colsum;      // null, or (ceil(M / 128) * 8, K): A's column sums per 16 rows (TB 0)
};

// The ring of mode_linear_kernel: 64-deep stages with W's planes MN-major
// (TB 1), 32-deep ones with them K-major (TB 0), as many as fit (up to 6):
// a K-major weight tile of 64 columns holds the stage no shorter than its
// MN-major one, so half the depth doubles the stages in flight.
template <int PASSES, int TB = 1>
struct LinFwd {
  static constexpr int PLANES = PASSES == 3 ? 2 : 1;
  static constexpr int KS = TB == 1 ? 64 : 32;       // the stage's depth
  static constexpr int XBOX = 128 * 32 * 4;           // one 32-float box of x's 128 rows
  static constexpr int WTILE = 128 * KS * 2;          // one plane of W's tile
  static constexpr int STAGE = KS / 32 * XBOX + PLANES * WTILE;
  static constexpr int STAGES = cmin(MAX_STAGES, TC_SMEM / STAGE);
  static constexpr int SMEM = STAGES * STAGE + 1024;
  static constexpr int LDC = 128 + 8;  // the output tile's row stride in the ring, floats
  static_assert(STAGES >= 3, "a ring of at least three stages");
  static_assert(128 * LDC * 4 <= STAGES * STAGE, "the output tile fits the ring");
};

// A K-major descriptor in the 64-byte swizzle (rows of 32 bf16; 8-row atoms
// 512 bytes apart), as a 32-column TMA box with CU_TENSOR_MAP_SWIZZLE_64B
// lays a tile out.
__device__ __forceinline__ uint64_t desc_k64(uint32_t addr) {
  return desc_encode(addr) | (desc_encode(16) << 16) | (desc_encode(512) << 32) | (2ull << 62);
}

// The float pair (r, c), (r, c + 1) of a 128-byte swizzled box of 32-float
// rows (c even).
__device__ __forceinline__ float2 box_pair(const unsigned char* box, int r, int c) {
  return *reinterpret_cast<const float2*>(box + r * 128 + ((((c >> 2) ^ r) & 7) << 4) +
                                          ((c & 3) << 2));
}

// y (M, N) = A W + b over 128 x 128 tiles (see mode_linear.cu's note); TB
// 1: W's planes MN-major (the forward), TB 0: K-major (the backward's dx =
// g W^T, and a projection by a weight in torch's layout).
template <int PASSES, int TB>
__global__ void __launch_bounds__(WG_THREADS, 1)
    mode_linear_kernel(const __grid_constant__ LinMaps mp, const LinArgs p) {
  using G = LinFwd<PASSES, TB>;
  constexpr int STAGES = G::STAGES, KS = G::KS, S16 = KS / 16;  // 16-deep steps a stage
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  const int warp = warp_index(), lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * 128, n0 = blockIdx.x * 128;
  const int steps = (p.K + KS - 1) / KS;
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
        const int k0 = KS * kt;
        mbar_wait(&empty[at.stage], at.phase ^ 1);
        unsigned char* sb = ring + at.stage * G::STAGE;
        uint64_t* bar = &full[at.stage];
        mbar_expect_tx(bar, G::STAGE);
        for (int xb = 0; xb < KS / 32; ++xb) tma_load(sb + xb * G::XBOX, &mp.x, k0 + 32 * xb, m0, bar);
        for (int pl = 0; pl < G::PLANES; ++pl) {
          unsigned char* sw = sb + KS / 32 * G::XBOX + pl * G::WTILE;
          if (TB == 1) {
            tma_load(sw, &mp.w[pl], n0, k0, bar);
            tma_load(sw + TC_TILE / 2, &mp.w[pl], n0 + 64, k0, bar);
          } else {
            tma_load(sw, &mp.w[pl], k0, n0, bar);
          }
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
  // width of each 64-deep stage kt: the writes spread over the columns;
  // that column also takes the stage's column sums (TB 0, colsum)
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
    const bool mine = kt % (int)gridDim.x == (int)blockIdx.x;
    // the stage's column sums of A (TB 0, colsum) over the warp's 16 rows:
    // rows r0 and r0 + 8 of the lane, then the eight lanes of a column (xor
    // 4, 8, 16) in a fixed tree; past M and K TMA's zeros add nothing
    const bool sums = TB == 0 && p.colsum != nullptr && mine;
    // the A fragment of 16-deep step s: (r0, c), (r0 + 8, c), (r0, c + 8),
    // (r0 + 8, c + 8), c = 16 s + 2 t, in box s / 2
#pragma unroll
    for (int s = 0; s < S16; ++s) {
      const unsigned char* box = sb + (s >> 1) * G::XBOX;
      const int c = 16 * (s & 1) + 2 * t;
      float2 v[4];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        v[h] = box_pair(box, r0 + 8 * (h & 1), c + 8 * (h >> 1));
        split2(v[h].x, v[h].y, fh[s][h], fl[s][h]);
      }
      if (sums) {
        float x[4] = {v[0].x + v[1].x, v[0].y + v[1].y, v[2].x + v[3].x, v[2].y + v[3].y};
#pragma unroll
        for (int o = 4; o < 32; o <<= 1)
#pragma unroll
          for (int i = 0; i < 4; ++i) x[i] += __shfl_xor_sync(0xffffffffu, x[i], o);
        float* part = p.colsum + (size_t)(blockIdx.y * CONSUMER_WARPS + warp) * p.K;
        const int col = KS * kt + 16 * s + 2 * t;
        if (g == 0 && col < p.K) *reinterpret_cast<float2*>(part + col) = make_float2(x[0], x[1]);
        if (g == 0 && col + 8 < p.K)
          *reinterpret_cast<float2*>(part + col + 8) = make_float2(x[2], x[3]);
      }
    }
    if (planes && mine) {  // past K: TMA's zeros
#pragma unroll
      for (int s = 0; s < S16; ++s) {
        const int col = KS * kt + 16 * s + 2 * t;
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
    const uint32_t b0 = smem_u32(sb + KS / 32 * G::XBOX);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < S16; ++s) {
      if (TB == 1) {
        const uint32_t b = b0 + s * 2048;
        wgmma_rs128<1>(d, fh[s], desc_mn(b, TC_TILE / 2));
        if (PASSES == 3) {
          wgmma_rs128<1>(d, fh[s], desc_mn(b + TC_TILE, TC_TILE / 2));
          wgmma_rs128<1>(d, fl[s], desc_mn(b, TC_TILE / 2));
        }
      } else {
        const uint32_t b = b0 + s * 32;
        wgmma_rs128<0>(d, fh[s], desc_k64(b));
        if (PASSES == 3) {
          wgmma_rs128<0>(d, fh[s], desc_k64(b + G::WTILE));
          wgmma_rs128<0>(d, fl[s], desc_k64(b));
        }
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
    *reinterpret_cast<float4*>(p.y + (size_t)m * p.ldy + c) = v;
  }
}

// A width padded to the planes' row multiple: 16 bf16 (the product's k
// step, and 32 bytes).
__host__ __device__ constexpr int pad16(int n) { return (n + 15) / 16 * 16; }

// The map of x (M, K) float32 (row stride ld floats, a 16-byte multiple)
// read in boxes of 32 columns x 128 rows, 128-byte swizzled, zero-filled
// out of bounds.
inline int x_map(CUtensorMap* m, const float* x, int M, int K, int ld) {
  *m = CUtensorMap{};
  EncodeTiled f = encode_tiled();
  if (f == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(float)};
  const cuuint32_t box[2] = {32u, 128u}, unit[2] = {1u, 1u};
  const CUresult r = f(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(x), dims, strides,
                       box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                       CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The map of a K-major bf16 plane (rows x cols, row stride cols) read in
// 32-column boxes of box_rows rows (128: TB 0's weight tiles), 64-byte
// swizzle (desc_k64), zero out of bounds; a null base leaves the map zero.
inline int kmajor_map(CUtensorMap* m, const bf16* base, int rows, int cols, int box_rows = 128) {
  *m = CUtensorMap{};
  if (base == nullptr) return 0;
  EncodeTiled f = encode_tiled();
  if (f == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {32u, (cuuint32_t)box_rows}, unit[2] = {1u, 1u};
  const CUresult r = f(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(base), dims,
                       strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                       CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                       CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// One launch of mode_linear_kernel: A (M, K) float32 of row stride lda,
// W's two maps as TB reads them, the output tiles over (M, N).
// Internal linkage: see sgemm_grad.cuh's host side.
template <int PASSES, int TB>
static int linear_launch(const float* a, int lda, const CUtensorMap* wmaps, const LinArgs& p,
                         cudaStream_t st) {
  using G = LinFwd<PASSES, TB>;
  static bool ready = false;
  cudaError_t e = allow_smem(mode_linear_kernel<PASSES, TB>, G::SMEM, ready);
  if (e != cudaSuccess) return (int)e;
  LinMaps mp;
  int rc = x_map(&mp.x, a, p.M, p.K, lda);
  if (rc) return rc;
  mp.w[0] = wmaps[0];
  mp.w[1] = wmaps[1];
  const dim3 grid((p.N + 127) / 128, (p.M + 127) / 128);
  mode_linear_kernel<PASSES, TB><<<grid, WG_THREADS, G::SMEM, st>>>(mp, p);
  return (int)cudaGetLastError();
}

}  // namespace kit
