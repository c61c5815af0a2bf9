// One post-LN attention sublayer of the transformer, three launches.
//
// Replaces keypoints_interpolation_transformer_tpu/ops/pallas/
// attn_sublayer.py::_sublayer_kernel:
//     q = x Wq + bq;  k = m Wk + bk;  v = m Wv + bv        (m = x or memory)
//     a = softmax(q k^T / sqrt(dh) + bias) v                (per head)
//     r = x + a Wo + bo;  y = LN(r) if post_ln else r
// with the bias built in-kernel from the 1-D (B, T) frame and valid masks
// (ops/pallas/attention.py::_bias_terms):
//     NEG where kind is repeat-inc, key > query and mask[key] == 1;
//     + mask[key] when add_keypad;  + NEG where valid[key] == 0.
//
// What bounds it on an H100: at the flagship shape (B = 256, T = 128,
// D = 256, 8 heads of 32) the four projections are 0.52 MFLOP per token of
// float32 FFMA work and the attention core 0.13 MFLOP per token; the
// (B, H, T, T) scores would be 134 MB per sublayer if they were written.
// Design, and what passes through device memory between the launches:
//   1. qkv_proj: one product of the block's 32 rows against the packed
//      [Wq | Wk | Wv] (D, 3D) weight, one D-wide column block per grid.y;
//      writes qkv (B*T, 3D).
//   2. attn_core: one block per (query tile of 128, head, batch row), one
//      query per thread with q and the output in registers; keys and values
//      stream through shared memory in tiles of 64 with an online softmax,
//      so no (T, T) score tensor is ever written; writes a (B*T, D).
//   3. out_proj: a Wo + bo + x, then the optional LayerNorm over the full
//      D-wide row (one warp per row) in the same block; writes y.
// Not copied from the TPU kernel: the key-major transposed scores, the
// exp2 / log2(e) fold, and its T <= 512 cap (keys stream, so T is free).
#include "common.cuh"

using namespace kit;

namespace {

constexpr int QT = 128;  // queries per attention block, one per thread
constexpr int KT = 64;   // keys per shared tile
constexpr int KC = 16;   // keys per online-softmax chunk

template <int TN>
__global__ void __launch_bounds__(NT)
qkv_proj_kernel(const float* __restrict__ x, const float* __restrict__ mem, int M,
                const float* __restrict__ wqkv, const float* __restrict__ bqkv,
                float* __restrict__ qkv) {
  constexpr int D = 32 * TN;
  extern __shared__ __align__(16) float smem[];
  float* AT = smem;            // D x LDT, k-major rows
  float* Ws = smem + D * LDT;  // BK x D
  const int row0 = blockIdx.x * BM, part = blockIdx.y;  // 0: q, 1: k, 2: v
  stage_rows(AT, part == 0 ? x : mem, D, row0, M, D);
  __syncthreads();
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  mma_rows<TN>(acc, AT, D, wqkv + part * D, 3 * D, D, Ws);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] += __ldg(bqkv + part * D + col_of(j));
  store_rows<TN>(qkv + part * D, 3 * D, D, row0, M, acc);
}

template <int DH>
__global__ void __launch_bounds__(QT)
attn_core_kernel(const float* __restrict__ qkv, const float* __restrict__ mask,
                 const float* __restrict__ valid, float* __restrict__ out, int T, int H,
                 int repeat_inc, int add_keypad, float scale) {
  __shared__ float Ks[KT][DH];
  __shared__ float Vs[KT][DH];
  __shared__ float km[KT];  // mask[key]
  __shared__ float kv[KT];  // valid[key]
  const int D = H * DH, ld = 3 * D;
  const int b = blockIdx.z, h = blockIdx.y;
  const int qi = blockIdx.x * QT + threadIdx.x;
  const float* base = qkv + (size_t)b * T * ld;

  float q[DH], o[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    q[d] = qi < T ? base[(size_t)qi * ld + h * DH + d] : 0.f;
    o[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < T; k0 += KT) {
    for (int idx = threadIdx.x; idx < KT * DH; idx += QT) {
      int j = idx / DH, d = idx - j * DH;
      int key = k0 + j;
      bool in = key < T;
      Ks[j][d] = in ? base[(size_t)key * ld + D + h * DH + d] : 0.f;
      Vs[j][d] = in ? base[(size_t)key * ld + 2 * D + h * DH + d] : 0.f;
    }
    for (int j = threadIdx.x; j < KT; j += QT) {
      int key = k0 + j;
      km[j] = (key < T && mask != nullptr) ? mask[(size_t)b * T + key] : 0.f;
      kv[j] = (key < T && valid != nullptr) ? valid[(size_t)b * T + key] : 1.f;
    }
    __syncthreads();
    for (int c0 = 0; c0 < KT; c0 += KC) {
      float s[KC];
      float cmax = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < KC; ++jj) {
        const int j = c0 + jj, key = k0 + j;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < DH; ++d) dot = fmaf(q[d], Ks[j][d], dot);
        float bias = (repeat_inc && key > qi && km[j] > 0.f) ? NEG : 0.f;
        if (add_keypad) bias += km[j];
        bias += kv[j] > 0.f ? 0.f : NEG;
        s[jj] = key < T ? dot * scale + bias : -INFINITY;
        cmax = fmaxf(cmax, s[jj]);
      }
      // the chunk at c0 = 0 of the first tile always holds key 0, so m is
      // finite from then on and no -inf - -inf arises
      const float mnew = fmaxf(m, cmax);
      const float corr = expf(m - mnew);
      l *= corr;
#pragma unroll
      for (int d = 0; d < DH; ++d) o[d] *= corr;
#pragma unroll
      for (int jj = 0; jj < KC; ++jj) {
        const float p = expf(s[jj] - mnew);
        l += p;
#pragma unroll
        for (int d = 0; d < DH; ++d) o[d] = fmaf(p, Vs[c0 + jj][d], o[d]);
      }
      m = mnew;
    }
    __syncthreads();
  }
  if (qi < T) {
    const float inv = 1.f / l;
    float* dst = out + ((size_t)b * T + qi) * D + h * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) dst[d] = o[d] * inv;
  }
}

template <int TN>
__global__ void __launch_bounds__(NT)
out_proj_kernel(const float* __restrict__ a, const float* __restrict__ x, int M,
                const float* __restrict__ wo, const float* __restrict__ bo,
                const float* __restrict__ gamma, const float* __restrict__ beta,
                float* __restrict__ y) {
  constexpr int D = 32 * TN;
  extern __shared__ __align__(16) float smem[];
  float* AT = smem;            // D x LDT, k-major rows
  float* Ws = smem + D * LDT;  // BK x D
  const int row0 = blockIdx.x * BM;
  stage_rows(AT, a, D, row0, M, D);
  __syncthreads();
  float r[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) r[i][j] = 0.f;
  mma_rows<TN>(r, AT, D, wo, D, D, Ws);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    int row = row0 + row_of(i);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      int c = col_of(j);
      float xr = row < M ? __ldg(x + (size_t)row * D + c) : 0.f;
      r[i][j] = xr + (r[i][j] + __ldg(bo + c));
    }
  }
  if (gamma != nullptr) layer_norm<TN>(r, gamma, beta);
  store_rows<TN>(y, D, D, row0, M, r);
}

template <int DH>
int launch_core(const float* qkv, const float* mask, const float* valid, float* a, int B, int T,
                int H, int repeat_inc, int add_keypad, cudaStream_t st) {
  dim3 grid((T + QT - 1) / QT, H, B);
  attn_core_kernel<DH><<<grid, QT, 0, st>>>(qkv, mask, valid, a, T, H, repeat_inc, add_keypad,
                                            1.f / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

template <int TN>
int launch_rows(const float* x, const float* mem, int M, const float* wqkv, const float* bqkv,
                const float* wo, const float* bo, const float* gamma, const float* beta,
                float* qkv, float* a, float* y, int B, int T, int H, int repeat_inc,
                int add_keypad, const float* mask, const float* valid, cudaStream_t st) {
  constexpr int D = 32 * TN;
  const int smem = (D * LDT + BK * D) * sizeof(float);
  static bool ready_qkv = false, ready_out = false;
  cudaError_t e = allow_smem(qkv_proj_kernel<TN>, smem, ready_qkv);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(out_proj_kernel<TN>, smem, ready_out);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (M + BM - 1) / BM;

  qkv_proj_kernel<TN><<<dim3(blocks, 3), NT, smem, st>>>(x, mem, M, wqkv, bqkv, qkv);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;

  switch (D / H) {
    case 16: rc = launch_core<16>(qkv, mask, valid, a, B, T, H, repeat_inc, add_keypad, st); break;
    case 32: rc = launch_core<32>(qkv, mask, valid, a, B, T, H, repeat_inc, add_keypad, st); break;
    case 64: rc = launch_core<64>(qkv, mask, valid, a, B, T, H, repeat_inc, add_keypad, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;

  out_proj_kernel<TN><<<blocks, NT, smem, st>>>(a, x, M, wo, bo, gamma, beta, y);
  return (int)cudaGetLastError();
}

}  // namespace

// x, mem (B*T, D) -> y (B*T, D).  qkv (B*T, 3D) and a (B*T, D) are scratch
// the caller allocates.  mask, valid (B, T) may be null (no keypad / repeat-
// inc term, all keys valid); gamma, beta null means no LayerNorm.  D is 128
// or 256 and D / H is 16, 32 or 64.
extern "C" int kit_attn_sublayer(const void* x, const void* mem, int B, int T, int D, int H,
                                 const void* wqkv, const void* bqkv, const void* wo,
                                 const void* bo, const void* gamma, const void* beta,
                                 const void* mask, const void* valid, int repeat_inc,
                                 int add_keypad, void* qkv, void* a, void* y, void* stream) {
  auto st = (cudaStream_t)stream;
  auto p = [](const void* v) { return (const float*)v; };
  const int M = B * T;
  switch (D) {
    case 128:
      return launch_rows<4>(p(x), p(mem), M, p(wqkv), p(bqkv), p(wo), p(bo), p(gamma), p(beta),
                            (float*)qkv, (float*)a, (float*)y, B, T, H, repeat_inc, add_keypad,
                            p(mask), p(valid), st);
    case 256:
      return launch_rows<8>(p(x), p(mem), M, p(wqkv), p(bqkv), p(wo), p(bo), p(gamma), p(beta),
                            (float*)qkv, (float*)a, (float*)y, B, T, H, repeat_inc, add_keypad,
                            p(mask), p(valid), st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
