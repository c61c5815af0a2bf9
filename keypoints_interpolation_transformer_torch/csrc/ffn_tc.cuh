// The forward of the FF sublayer in the precision modes "high" (bf16x3) and
// "default" (one bf16 pass) on the bf16 tensor cores: ffn_tc_kernel, its
// launch (launch_tc) and the FF split's second pass (ffn_finish_kernel),
// which the float32 forward shares.  ffn.cu's kit_ffn_tc launches it for
// the FF sublayer, layer_modes.cu for the FF tail of the merged layers in a
// mode; see the notes at the top of ffn.cu.
#pragma once

#include "common.cuh"
#include "grad.cuh"
#include "mma_bf16.cuh"

namespace kit {

// The tensor-core forward's FF chunk (the N of its u product).
constexpr int FC_TC = 64;

// The arguments of the float32 forward (kit_ffn): r (M, D) -> y (M, D);
// u (M, FF) and z (M, D) when not null; g1 null: no LN1; with parts > 1,
// partial holds parts x M x D floats.
struct FfArgs {
  const float* r;
  int M, n, FF, parts;
  const float *w1, *b1, *w2, *b2, *g1, *be1, *g2, *be2;
  float *y, *u, *z, *partial;
};

// The FF split's second pass, one warp a row: z = the parts' sums added
// in order, + x1 + b2, x1 = LN1(r) again by the same expression as the
// first pass; z written when asked, y = LN2(z).
template <int TN>
__global__ void __launch_bounds__(NT) ffn_finish_kernel(const FfArgs p) {
  constexpr int D = 32 * TN;
  const int row0 = blockIdx.x * (NT / 32), row = row0 + (threadIdx.x >> 5);
  if (row >= p.M) return;  // the whole warp
  auto load = [&](float (&v)[1][TN], const float* src) {
#pragma unroll
    for (int g = 0; g < TN / 4; ++g) {
      const float4 t = __ldcg(reinterpret_cast<const float4*>(src + col_of(4 * g)));
      v[0][4 * g] = t.x;
      v[0][4 * g + 1] = t.y;
      v[0][4 * g + 2] = t.z;
      v[0][4 * g + 3] = t.w;
    }
  };
  float x[1][TN], s[1][TN], t[1][TN];
  load(x, p.r + (size_t)row * D);
  if (p.g1 != nullptr) layer_norm<TN>(x, p.g1, p.be1, p.n);
  load(s, p.partial + (size_t)row * D);
  for (int q = 1; q < p.parts; ++q) {
    load(t, p.partial + ((size_t)q * p.M + row) * D);
#pragma unroll
    for (int j = 0; j < TN; ++j) s[0][j] += t[0][j];
  }
#pragma unroll
  for (int j = 0; j < TN; ++j) x[0][j] = x[0][j] + (s[0][j] + __ldg(p.b2 + col_of(j)));
  if (p.z != nullptr) store_rows<TN>(p.z, D, D, row0, p.M, x);
  layer_norm<TN>(x, p.g2, p.be2, p.n);
  store_rows<TN>(p.y, D, D, row0, p.M, x);
}

// ---- the precision modes "high" and "default" ------------------------------

// One token row of width D = 32 * TN as a warp holds it in the row phases
// of the tensor-core kernels: lane l has columns col_of(j), j < TN.
template <int TN>
__device__ __forceinline__ void load_row(float (&v)[TN], const float* __restrict__ src) {
#pragma unroll
  for (int q = 0; q < TN / 4; ++q) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(src + col_of(4 * q)));
    v[4 * q] = x.x;
    v[4 * q + 1] = x.y;
    v[4 * q + 2] = x.z;
    v[4 * q + 3] = x.w;
  }
}

template <int TN>
__device__ __forceinline__ void store_row(float* dst, const float (&v)[TN]) {
#pragma unroll
  for (int q = 0; q < TN / 4; ++q)
    *reinterpret_cast<float4*>(dst + col_of(4 * q)) =
        make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

// layer_norm (common.cuh) of one row held by the warp: statistics over the
// first n columns, 0 written beyond them (gamma and beta are zero there).
template <int TN>
__device__ __forceinline__ void row_layer_norm(float (&v)[TN], const float* __restrict__ gamma,
                                               const float* __restrict__ beta, int n) {
  const float inv_n = 1.f / n;
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < TN; ++j) s += col_of(j) < n ? v[j] : 0.f;
  const float mean = warp_sum(s) * inv_n;
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const float d = col_of(j) < n ? v[j] - mean : 0.f;
    ss += d * d;
  }
  const float inv = rsqrtf(warp_sum(ss) * inv_n + LN_EPS);
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int c = col_of(j);
    v[j] = (c < n ? (v[j] - mean) * inv : 0.f) * __ldg(gamma + c) + __ldg(beta + c);
  }
}

// The tiles of ffn_tc_kernel at D = 32 * TN in the mode's PASSES (see the
// note at the top).  Up to D = 256 the two consumer groups take 64 rows
// each (ROWS = 128) and hold z (64 x D) in registers; above, z would not
// fit, so both groups take the same 64 rows and split z's columns (group w
// the 64 columns 128 j + 64 w of each 128-wide tile j), each computing the
// chunk's u itself.  Shared memory: x1's planes (K-major,
// swizzled), then the ring of STAGES stages, each one 16 KB tile a plane:
// W1^T rows f0 .. f0 + 63 at 128 columns of D, or W2^T rows 128 j .. 128 j +
// 127 at the chunk's 64 columns of FF.  After the products z + b2 (ROWS x
// LDZ floats) reuses it all.
template <int TN, int PASSES>
struct TcFwd {
  static constexpr int D = 32 * TN;
  static constexpr bool SPLIT_D = D > 256;
  static constexpr int ROWS = SPLIT_D ? 64 : 128;
  static constexpr int PLANES = PASSES == 3 ? 2 : 1;
  static constexpr int KT = D / 128;         // stages of each product a chunk
  static constexpr int ZN = SPLIT_D ? 64 : 128;  // z's columns a group of each stage
  static constexpr int XP = ROWS * D * 2;      // bytes of one x1 plane
  static constexpr int STAGE = TC_TILE * PLANES;
  static constexpr int STAGES = cmin(MAX_STAGES, (TC_SMEM - XP * PLANES) / STAGE);
  static constexpr int LDZ = D + 8;
  static constexpr int SMEM = cmax(XP * PLANES + STAGES * STAGE, ROWS * LDZ * 4) + 1024;
  static_assert(STAGES >= 3, "a ring of at least three stages");
};

// The forward's weight planes as TMA reads them: W1^T (FF, D) in 64 x 64
// boxes, W2^T (D, FF) in 128-row x 64 boxes; [1] the lo planes.
struct FfTcMaps {
  CUtensorMap w1[2], w2[2];
};

// The forward in the mode's passes (see the note at the top) for row tile
// blockIdx.x and part blockIdx.y of p.parts (the part's share of the FF
// chunks: all of them when p.parts == 1, which also ends the tile; else the
// z sums go to the part's slice of p.partial and ffn_finish_kernel ends
// it).  p.w1 / p.w2 are unused: the weights come through the maps.
template <int TN, int PASSES>
__global__ void __launch_bounds__(WG_THREADS, 1)
    ffn_tc_kernel(const __grid_constant__ FfTcMaps mp, const FfArgs p) {
  using G = TcFwd<TN, PASSES>;
  constexpr int D = G::D, ROWS = G::ROWS, KT = G::KT, STAGES = G::STAGES;
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* ring = smem + G::XP * G::PLANES;
  const int warp = warp_index(), lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * ROWS, q = blockIdx.y;
  const int chunks = (p.FF + FC_TC - 1) / FC_TC;
  const int c_lo = q * chunks / p.parts, c_hi = (q + 1) * chunks / p.parts;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int role = warpgroup_index();
  if (role == 2) {  // the producer: per chunk W1's KT stages, then W2's
    reg_dealloc<PRODUCER_REGS>();
    if (warp == CONSUMER_WARPS && lane == 0) {
      RingPos at;
      for (int c = c_lo; c < c_hi; ++c) {
        const int f0 = c * FC_TC;
        for (int j = 0; j < 2 * KT; ++j) {
          mbar_wait(&empty[at.stage], at.phase ^ 1);
          unsigned char* sb = ring + at.stage * G::STAGE;
          mbar_expect_tx(&full[at.stage], G::STAGE);
          for (int pl = 0; pl < G::PLANES; ++pl) {
            if (j < KT) {
              tma_load(sb + pl * TC_TILE, &mp.w1[pl], 128 * j, f0, &full[at.stage]);
              tma_load(sb + pl * TC_TILE + TC_TILE / 2, &mp.w1[pl], 128 * j + 64, f0,
                       &full[at.stage]);
            } else {
              tma_load(sb + pl * TC_TILE, &mp.w2[pl], f0, 128 * (j - KT), &full[at.stage]);
            }
          }
          at.advance<STAGES>();
        }
      }
    }
    return;
  }

  reg_alloc<CONSUMER_REGS>();
  const int wg = role, wq = warp & 3, g = lane >> 2, t = lane & 3;
  const int grow = G::SPLIT_D ? 0 : 64 * wg;  // the group's first row in the tile
  // x1 = LN1(r) (or r), split into its planes; rows >= M are 0
  for (int rr = warp; rr < ROWS; rr += CONSUMER_WARPS) {
    const int row = row0 + rr;
    float v[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) v[j] = 0.f;
    if (row < p.M) {
      load_row<TN>(v, p.r + (size_t)row * D);
      if (p.g1 != nullptr) row_layer_norm<TN>(v, p.g1, p.be1, p.n);
    }
#pragma unroll
    for (int q4 = 0; q4 < TN / 4; ++q4) {
      uint32_t h0, l0, h1, l1;
      split2(v[4 * q4], v[4 * q4 + 1], h0, l0);
      split2(v[4 * q4 + 2], v[4 * q4 + 3], h1, l1);
      const uint32_t o = swizzled(rr, col_of(4 * q4), ROWS);
      *reinterpret_cast<uint2*>(smem + o) = make_uint2(h0, h1);
      if (PASSES == 3) *reinterpret_cast<uint2*>(smem + G::XP + o) = make_uint2(l0, l1);
    }
  }
  fence_proxy_async();
  consumers_sync();

  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  };
  const uint32_t xa = smem_u32(smem) + grow * 128;  // the group's rows of x1, k block 0
  constexpr int ZN = G::ZN;
  float z[KT][ZN / 2];  // z's columns 128 j + (64 wg with SPLIT_D) + ...
#pragma unroll
  for (int i = 0; i < KT; ++i)
#pragma unroll
    for (int e = 0; e < ZN / 2; ++e) z[i][e] = 0.f;
  RingPos at;
  for (int c = c_lo; c < c_hi; ++c) {
    const int f0 = c * FC_TC;
    // u = x1 W1[:, chunk]: 8 steps of 16 a stage
    float u[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) u[e] = 0.f;
    int prev = -1;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      mbar_wait(&full[at.stage], at.phase);
      const uint32_t sb = smem_u32(ring + at.stage * G::STAGE);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const uint32_t a = xa + (2 * j + (s >> 2)) * ROWS * 128 + (s & 3) * 32;
        const uint32_t b = sb + (s >> 2) * (TC_TILE / 2) + (s & 3) * 32;
        wgmma_ss64<0, 0>(u, desc_k(a), desc_k(b));
        if (PASSES == 3) {
          wgmma_ss64<0, 0>(u, desc_k(a), desc_k(b + TC_TILE));
          wgmma_ss64<0, 0>(u, desc_k(a + G::XP), desc_k(b));
        }
      }
      wgmma_commit();
      if (prev >= 0) {
        wgmma_wait<1>();
        release(prev);
      }
      prev = at.stage;
      at.advance<STAGES>();
    }
    wgmma_wait<0>();
    fence_acc(u);
    release(prev);
    // u += b1 (stored for training); h = gelu(u) split into the A fragments
    // of the z product: accumulator pair (g or g + 8, 16 s + 8 (h / 2) + 2 t)
    // is fragment register h of 16-deep step s (0 beyond FF)
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int i = 8 * s + 2 * h, rr = grow + 16 * wq + g + 8 * (h & 1);
        const int f = f0 + 16 * s + 8 * (h >> 1) + 2 * t;
        float h0 = 0.f, h1 = 0.f;
        if (f < p.FF) {  // FF is even: f + 1 < FF too
          const float u0 = u[i] + __ldg(p.b1 + f), u1 = u[i + 1] + __ldg(p.b1 + f + 1);
          if (p.u != nullptr && row0 + rr < p.M && (!G::SPLIT_D || wg == 0))
            *reinterpret_cast<float2*>(p.u + (size_t)(row0 + rr) * p.FF + f) =
                make_float2(u0, u1);
          h0 = gelu(u0);
          h1 = gelu(u1);
        }
        split2(h0, h1, ah[s][h], al[s][h]);
      }
    // z += h W2[chunk, :]: 4 steps of 16 a 128-column stage (the group's
    // 64 of them with SPLIT_D)
    const uint32_t zoff = G::SPLIT_D ? wg * 64 * 128 : 0;
    prev = -1;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      mbar_wait(&full[at.stage], at.phase);
      const uint32_t sb = smem_u32(ring + at.stage * G::STAGE) + zoff;
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if constexpr (G::SPLIT_D) {
          wgmma_rs64(z[j], ah[s], desc_k(sb + s * 32));
          if (PASSES == 3) {
            wgmma_rs64(z[j], ah[s], desc_k(sb + TC_TILE + s * 32));
            wgmma_rs64(z[j], al[s], desc_k(sb + s * 32));
          }
        } else {
          wgmma_rs128(z[j], ah[s], desc_k(sb + s * 32));
          if (PASSES == 3) {
            wgmma_rs128(z[j], ah[s], desc_k(sb + TC_TILE + s * 32));
            wgmma_rs128(z[j], al[s], desc_k(sb + s * 32));
          }
        }
      }
      wgmma_commit();
      if (prev >= 0) {
        wgmma_wait<1>();
        release(prev);
      }
      prev = at.stage;
      at.advance<STAGES>();
    }
    wgmma_wait<0>();
    release(prev);
#pragma unroll
    for (int i = 0; i < KT; ++i) fence_acc(z[i]);
  }

  // z (+ b2 when this block ends the tile) into shared memory: value e of
  // n8 block jj of tile i is row grow + 16 wq + g (+ 8), column 128 (tile) +
  // 8 jj + 2 t (+ 1)
  consumers_sync();  // every product is done: the x1 planes and the ring are free
  float* Zs = reinterpret_cast<float*>(smem);
  const bool ends = p.parts == 1;
#pragma unroll
  for (int i = 0; i < KT; ++i) {
    const int col0 = 128 * i + (G::SPLIT_D ? 64 * wg : 0);
#pragma unroll
    for (int jj = 0; jj < ZN / 8; ++jj) {
      const int cc = col0 + 8 * jj + 2 * t;
      const float b0 = ends ? __ldg(p.b2 + cc) : 0.f, b1 = ends ? __ldg(p.b2 + cc + 1) : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(Zs + (grow + 16 * wq + g + 8 * h) * G::LDZ + cc) =
            make_float2(z[i][4 * jj + 2 * h] + b0, z[i][4 * jj + 2 * h + 1] + b1);
    }
  }
  consumers_sync();
  for (int rr = warp; rr < ROWS; rr += CONSUMER_WARPS) {
    const int row = row0 + rr;
    if (row >= p.M) continue;  // the whole warp
    float v[TN];
    if (!ends) {  // the part's sums, to its slice of the scratch
#pragma unroll
      for (int j = 0; j < TN; ++j) v[j] = Zs[rr * G::LDZ + col_of(j)];
      store_row<TN>(p.partial + ((size_t)q * p.M + row) * D, v);
      continue;
    }
    // z = x1 + (h W2 + b2), x1 = LN1(r) again; y = LN2(z)
    load_row<TN>(v, p.r + (size_t)row * D);
    if (p.g1 != nullptr) row_layer_norm<TN>(v, p.g1, p.be1, p.n);
#pragma unroll
    for (int j = 0; j < TN; ++j) v[j] = v[j] + Zs[rr * G::LDZ + col_of(j)];
    if (p.z != nullptr) store_row<TN>(p.z + (size_t)row * D, v);
    row_layer_norm<TN>(v, p.g2, p.be2, p.n);
    store_row<TN>(p.y + (size_t)row * D, v);
  }
}

// The forward in the mode's passes, then, with the FF split, its second
// pass (ffn_finish_kernel, the float32 forward's).  w1h / w1l = W1^T (FF,
// D), w2h / w2l = W2^T (D, FF), the lo planes null with passes 1.
// Internal linkage: see sgemm_grad.cuh's host side (ffn.cu and
// layer_modes.cu each set their own kernels' shared-memory ceiling).
template <int TN, int PASSES>
static int launch_tc(const FfArgs& p, const bf16* w1h, const bf16* w1l, const bf16* w2h,
              const bf16* w2l, cudaStream_t st) {
  using G = TcFwd<TN, PASSES>;
  constexpr int D = G::D;
  static bool ready = false;
  cudaError_t e = allow_smem(ffn_tc_kernel<TN, PASSES>, G::SMEM, ready);
  if (e != cudaSuccess) return (int)e;
  if (p.M <= 0) return 0;
  FfTcMaps mp;
  int rc;
  if ((rc = plane_map(&mp.w1[0], w1h, p.FF, D, 64)) || (rc = plane_map(&mp.w1[1], w1l, p.FF, D, 64)) ||
      (rc = plane_map(&mp.w2[0], w2h, D, p.FF, 128)) || (rc = plane_map(&mp.w2[1], w2l, D, p.FF, 128)))
    return rc;
  ffn_tc_kernel<TN, PASSES>
      <<<dim3((p.M + G::ROWS - 1) / G::ROWS, p.parts), WG_THREADS, G::SMEM, st>>>(mp, p);
  rc = (int)cudaGetLastError();
  if (rc != 0 || p.parts == 1) return rc;
  ffn_finish_kernel<TN><<<(p.M + NT / 32 - 1) / (NT / 32), NT, 0, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace kit
