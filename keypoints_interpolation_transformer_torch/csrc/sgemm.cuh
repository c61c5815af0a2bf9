// The float32 block product of the whole-layer kernels (layer_fused.cu),
// the per-sublayer forwards (ffn.cu, attn_sublayer.cu) and the pointwise
// chains (pointwise.cu): a tile of BM token rows times an N-wide slice of
// a weight, on FFMA.  Its thread tile (Mma, mma_depth) also runs the
// training backwards' products (sgemm_grad.cuh).
//
// What bounds such a product on an H100, and what this core does about it:
//   * Shared-memory bandwidth.  An SM's shared memory delivers 32 floats a
//     cycle (one 128-byte wavefront; a float4 read costs a warp 4 of them
//     however many lanes share an address) and its FFMA pipes 128.  A
//     thread's RT x CT sums take RT + CT floats a step of depth 1 for
//     RT x CT FFMAs, so the two meet at 4 (RT + CT) = RT CT: at the 8 x 8
//     tile here (BM = 64, N = 256), against 2.67 times the FFMAs' reads in
//     a 4 x 8 tile (the first form of the pointwise chains).  No larger
//     tile fits the FF tail, which holds two such tiles, so the products
//     run at about 65 % of the FFMA peak on an H100.  Warps are 2 x 4
//     over the tile, lanes 4 x 8 over a warp's part; A and B are float4
//     reads, the operands of depth kk + 1 read while depth kk is
//     multiplied.
//   * Weight bytes from L2.  Each weight tile fetched serves BM rows: 64
//     where the budget allows (D <= 256), twice a 32-row block's, so a
//     whole layer's weights cross L2 once per 64 rows (about 1.9 TB/s of
//     L2 reads over the card at the FFMA peak, D = 256).
//   * Load latency.  The weight streams through a ring of STAGES tiles of
//     DEPTH x N floats in shared memory with cp.async 16-byte .cg copies
//     (L2 only): tile s + STAGES - 1 is in flight while tile s is
//     multiplied, one barrier per step, and the next product's first
//     tiles load during the last steps of the one before and its epilogue.
// The activation rows are k-major in shared memory (AT[k * LDA + r]),
// staged once per tile, as common.cuh keeps them.  Weights are (K, N)
// row-major, the Flax layout.
//
// The LayerNorm epilogues need a row in one warp (common.cuh's row layout,
// RM = BM / 8 rows a warp); the sums reach it through shared memory:
// g_put writes them k-major, get_rows reads them back.
#pragma once

#include "common.cuh"

namespace kit {

// Depth pairs of the product's inner loop unrolled into one loop body (a
// whole 16-deep step at 8 x 8 is some 1100 instructions); on an H100 the
// layer kernels ran no slower with 1 or 2 pairs a body than with more
// (PERF.md §6, PR 8).
constexpr int MMA_UNROLL = 2;

// The row tile of a width's build: 64 rows where two D x 68 k-major tiles,
// the weight ring and the FF tail's two 64-row accumulator tiles (128
// registers a thread) fit; 32 at D = 384 and 512.
__host__ __device__ constexpr int row_tile(int D) { return D <= 256 ? 64 : 32; }
// Weight tiles in the ring: 3, or 2 at D = 512 (shared memory).
__host__ __device__ constexpr int ring_stages(int D) { return D <= 384 ? 3 : 2; }

// An H100 SXM's SMs.  The per-sublayer forwards (ffn.cu, attn_sublayer.cu)
// pick their tiles by it, not by the card they run on, so the same inputs
// give the same bits on any card.
constexpr int SMS = 132;
// Whether M rows in row_tile(D) tiles, one block an SM each, fill half the
// card or more: the forwards then take those tiles, else narrower ones.
__host__ __device__ constexpr bool rows_fill(int M, int D) {
  return 2 * ((M + row_tile(D) - 1) / row_tile(D)) >= SMS;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool full) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// The thread layout of a BM x N product: the block row and column of sum
// (i, j) of this thread.
template <int BM, int N>
struct Mma {
  static constexpr int RT = BM / 8;   // rows a thread
  static constexpr int CT = N / 32;   // columns a thread
  static_assert(RT % 4 == 0 && CT % 4 == 0, "a thread's rows and columns are float4 groups");
  __device__ static __forceinline__ int row(int i) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    return (warp >> 2) * (BM / 2) + (i >> 2) * 16 + (lane >> 3) * 4 + (i & 3);
  }
  __device__ static __forceinline__ int col(int j) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    return (warp & 3) * (N / 4) + (j >> 2) * 32 + (lane & 7) * 4 + (j & 3);
  }
};

template <int R, int C>
__device__ __forceinline__ void zero(float (&v)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) v[i][j] = 0.f;
}

// AT[c * LDA + r] = src[(row0 + r) * lds + c] for r < BM, c < K, rows >=
// M as 0, read through L2 (ld.global.cg: src may have been written earlier
// in the launch).  K, lds multiples of 4, src 16-byte aligned.  A warp
// takes 16 rows x 2 float4 of each: whole 32-byte sectors, and transposed
// stores on 32 distinct banks (4 LDA = 16 mod 32).
template <int BM, int LDA>
__device__ __forceinline__ void stage_kmajor(float* AT, const float* src, int lds, int row0,
                                             int M, int K) {
  static_assert(BM % 16 == 0, "16 rows a warp");
  constexpr int U = 4;  // loads in flight a thread
  const int total = BM * (K / 4);
  for (int base = threadIdx.x; base < total; base += U * NT) {
    float4 v[U];
    int r[U], c[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = base + u * NT, grp = idx >> 5, lane = idx & 31;
      r[u] = (grp % (BM / 16)) * 16 + (lane >> 1);
      c[u] = 4 * ((grp / (BM / 16)) * 2 + (lane & 1));
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (idx < total && row0 + r[u] < M)
        v[u] = __ldcg(reinterpret_cast<const float4*>(src + (size_t)(row0 + r[u]) * lds + c[u]));
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (base + u * NT >= total) break;
      AT[c[u] * LDA + r[u]] = v[u].x;
      AT[(c[u] + 1) * LDA + r[u]] = v[u].y;
      AT[(c[u] + 2) * LDA + r[u]] = v[u].z;
      AT[(c[u] + 3) * LDA + r[u]] = v[u].w;
    }
  }
}

// One product's weight: rows k < K of W (row stride ldw, a multiple of 4,
// 16-byte aligned), columns < ncols (a multiple of 4) of the N the product
// reads; the rest read as 0.  W null: no product.
struct Wt {
  const float* W;
  int ldw, ncols, K;
};

// The weight ring: STAGES tiles of DEPTH x N floats in shared memory, fed
// by cp.async along a chain of products (one product's tiles, then the
// next one's), one commit group per tile position; pos is the chain
// position of the next tile to multiply.  A product may name the product
// that follows it, whose first STAGES - 1 tiles then load during its own
// last steps and the caller's epilogue between the two, if it has at
// least that many (chainable).
template <int N, int DEPTH, int STAGES>
struct Ring {
  static constexpr int TILE = DEPTH * N;
  float* buf;
  int pos;

  __device__ static bool chainable(const Wt& w) {
    return w.W != nullptr && w.K >= (STAGES - 1) * DEPTH;
  }

  __device__ static int steps(const Wt& w) { return (w.K + DEPTH - 1) / DEPTH; }

  // Tile q of the chain that starts at cur (then next), into the slot of
  // chain position pos + q; nothing past next.
  __device__ __forceinline__ void fetch(const Wt& cur, const Wt& next, int q) const {
    const int sc = steps(cur);
    const Wt& w = q < sc ? cur : next;
    const int t = q < sc ? q : q - sc;
    if (w.W == nullptr || t >= steps(w)) return;
    float* dst = buf + ((pos + q) % STAGES) * TILE;
    static_assert(TILE / 4 % NT == 0, "whole float4 copies a thread");
#pragma unroll
    for (int u = 0; u < TILE / 4 / NT; ++u) {
      const int idx = threadIdx.x + u * NT, kk = idx / (N / 4), c = 4 * (idx - kk * (N / 4));
      const int k = t * DEPTH + kk;
      const bool ok = k < w.K && c < w.ncols;
      cp_async16(dst + kk * N + c, ok ? w.W + (size_t)k * w.ldw + c : w.W, ok);
    }
  }

  // Start a chain at cur: its first STAGES - 1 tiles (and next's, where
  // cur has fewer) in flight.  The ring must be free.
  __device__ __forceinline__ void start(const Wt& cur, const Wt& next) {
#pragma unroll
    for (int q = 0; q < STAGES - 1; ++q) {
      fetch(cur, next, q);
      cp_async_commit();
    }
  }
};

// acc[i][j] += sum_{kk < DEPTH} A[kk * LDA + 16 (i / 4) + i % 4] *
// B[kk * N + 32 (j / 4) + j % 4]: one DEPTH-deep step of the thread's sums,
// with A and B the k-major operand tiles in shared memory at the thread's
// first row and column (Mma::row(0), Mma::col(0)).  The operands of depth
// kk + 1 are read while depth kk is multiplied.
template <int BM, int N, int LDA, int DEPTH>
__device__ __forceinline__ void mma_depth(float (&acc)[BM / 8][N / 32], const float* A,
                                          const float* B) {
  constexpr int RT = BM / 8, CT = N / 32;
  static_assert(DEPTH % 2 == 0, "depths in pairs");
  float a[2][RT], b[2][CT];
  auto read = [&](int kk, float(&ak)[RT], float(&bk)[CT]) {
#pragma unroll
    for (int g = 0; g < RT / 4; ++g) {
      const float4 a4 = *reinterpret_cast<const float4*>(A + kk * LDA + 16 * g);
      ak[4 * g] = a4.x;
      ak[4 * g + 1] = a4.y;
      ak[4 * g + 2] = a4.z;
      ak[4 * g + 3] = a4.w;
    }
#pragma unroll
    for (int h = 0; h < CT / 4; ++h) {
      const float4 b4 = *reinterpret_cast<const float4*>(B + kk * N + 32 * h);
      bk[4 * h] = b4.x;
      bk[4 * h + 1] = b4.y;
      bk[4 * h + 2] = b4.z;
      bk[4 * h + 3] = b4.w;
    }
  };
  auto fma_step = [&](const float(&ak)[RT], const float(&bk)[CT]) {
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) acc[i][j] = fmaf(ak[i], bk[j], acc[i][j]);
  };
  read(0, a[0], b[0]);
#pragma unroll(MMA_UNROLL)
  for (int kk = 0; kk < DEPTH; kk += 2) {
    read(kk + 1, a[1], b[1]);
    fma_step(a[0], b[0]);
    if (kk + 2 < DEPTH) read(kk + 2, a[0], b[0]);
    fma_step(a[1], b[1]);
  }
}

// acc[i][j] += sum_{k < cur.K} AT[k * LDA + row(i)] * cur.W[k * ldw +
// col(j)], with cur's first tiles in flight (ring.start, or the product
// before named cur as its next).  AT: the tile's rows k-major in shared
// memory, finite for k in [K, round_up(K, DEPTH)).  next: the product that
// follows, if chainable (else W null), its tiles loaded from the last
// steps on.  Ends with a barrier after the last step and no copy in
// flight but next's, so the caller may overwrite AT right after, and the
// ring too when next is null.
template <int BM, int N, int LDA, int DEPTH, int STAGES>
__device__ __forceinline__ void block_mma(float (&acc)[BM / 8][N / 32], const float* AT,
                                          const Wt& cur, const Wt& next,
                                          Ring<N, DEPTH, STAGES>& ring) {
  using L = Mma<BM, N>;
  static_assert(STAGES >= 2, "a tile in flight while one is multiplied");
  const int steps = ring.steps(cur);
  const int r0 = L::row(0), c0 = L::col(0);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 2>();  // tile s has landed (this thread's copies)
    __syncthreads();              // ... and every thread's; tile s - 1 is consumed
    ring.fetch(cur, next, s + STAGES - 1);
    cp_async_commit();
    mma_depth<BM, N, LDA, DEPTH>(acc, AT + s * DEPTH * LDA + r0,
                                 ring.buf + ((ring.pos + s) % STAGES) * ring.TILE + c0);
  }
  ring.pos += steps;
  __syncthreads();
}

// acc[i][j] += bias[col(j)]
template <int BM, int N>
__device__ __forceinline__ void g_bias(float (&acc)[BM / 8][N / 32],
                                       const float* __restrict__ bias) {
  using L = Mma<BM, N>;
#pragma unroll
  for (int j = 0; j < L::CT; ++j) {
    const float bj = __ldg(bias + L::col(j));
#pragma unroll
    for (int i = 0; i < L::RT; ++i) acc[i][j] += bj;
  }
}

// Store the sums of rows row0 + row(i) < M to out (row stride ldo, a
// multiple of 4): one 16-byte store per row and column group.
template <int BM, int N>
__device__ __forceinline__ void g_store(float* out, int ldo, int row0, int M,
                                        const float (&acc)[BM / 8][N / 32]) {
  using L = Mma<BM, N>;
#pragma unroll
  for (int i = 0; i < L::RT; ++i) {
    const int row = row0 + L::row(i);
    if (row >= M) continue;
#pragma unroll
    for (int h = 0; h < L::CT / 4; ++h)
      *reinterpret_cast<float4*>(out + (size_t)row * ldo + L::col(4 * h)) =
          make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
  }
}

// Write the sums k-major into shared memory: AT[col(j) * LDA + row(i)].
template <int BM, int N, int LDA>
__device__ __forceinline__ void g_put(float* AT, const float (&acc)[BM / 8][N / 32]) {
  using L = Mma<BM, N>;
#pragma unroll
  for (int j = 0; j < L::CT; ++j)
#pragma unroll
    for (int g = 0; g < L::RT / 4; ++g)
      *reinterpret_cast<float4*>(AT + L::col(j) * LDA + L::row(4 * g)) = make_float4(
          acc[4 * g][j], acc[4 * g + 1][j], acc[4 * g + 2][j], acc[4 * g + 3][j]);
}

// Read what g_put (or put_rows) left at this thread's positions.
template <int BM, int N, int LDA>
__device__ __forceinline__ void g_get(float (&acc)[BM / 8][N / 32], const float* AT) {
  using L = Mma<BM, N>;
#pragma unroll
  for (int j = 0; j < L::CT; ++j)
#pragma unroll
    for (int g = 0; g < L::RT / 4; ++g) {
      const float4 v = *reinterpret_cast<const float4*>(AT + L::col(j) * LDA + L::row(4 * g));
      acc[4 * g][j] = v.x;
      acc[4 * g + 1][j] = v.y;
      acc[4 * g + 2][j] = v.z;
      acc[4 * g + 3][j] = v.w;
    }
}

}  // namespace kit
