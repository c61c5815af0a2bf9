// One post-LN attention sublayer of the transformer: forward (three
// launches, with the training residuals when asked) and backward.
//
// Replaces keypoints_interpolation_transformer_tpu/ops/pallas/
// attn_sublayer.py::_sublayer_kernel and _sublayer_train_kernel:
//     q = x Wq + bq;  k = m Wk + bk;  v = m Wv + bv        (m = x or memory)
//     a = softmax(q k^T / sqrt(dh) + bias) v                (per head)
//     r = x + a Wo + bo;  y = LN(r) if post_ln else r
// and _sublayer_bwd_kernel (its gradients).  The bias is built in-kernel
// from the 1-D (B, T) frame and valid masks (ops/pallas/attention.py::
// _bias_terms), by the same expression in every kernel here, so the
// backward sees the forward's bias bit for bit:
//     NEG where kind is repeat-inc, key > query and mask[key] == 1;
//     + mask[key] when add_keypad;  + NEG where valid[key] == 0.
//
// What bounds it on an H100: at D = 256, 8 heads of 32 the four projections
// are 0.52 MFLOP per token of float32 FFMA work and the attention core
// 0.13 MFLOP per token at T = 128 (the backward about twice each); the
// (B, H, T, T) scores would be 34 MB per sublayer at B = 64, T = 128 if
// they were written.  Forward design, and what passes through device
// memory between the launches:
//   1. qkv_proj: one product of the block's 32 rows against the packed
//      [Wq | Wk | Wv] (D, 3D) weight, one D-wide column block per grid.y;
//      writes qkv (B*T, 3D).
//   2. attn_core: one block per (query tile of 128, head, batch row), one
//      query per thread with q and the output in registers; keys and values
//      stream through shared memory in tiles of 64 with an online softmax,
//      so no (T, T) score tensor is ever written; writes a (B*T, D) and, in
//      training, each (row, head)'s softmax max and sum (stats).
//   3. out_proj: a Wo + bo + x, then the optional LayerNorm over the full
//      D-wide row (one warp per row) in the same block; writes y and, in
//      training, the pre-LN r.
// The training forward keeps qkv, a, stats and r; its q is the unscaled
// projection.  The log-sum-exp is kept as its two parts: m + log(l) rounds
// away log(l) when m = NEG (a row whose keys are all blocked), and the
// backward would then rebuild probabilities of 1 instead of 1 / l.
//
// Backward design (the TPU kernel keeps a (T, H*T) probability residual
// when it fits VMEM and otherwise rebuilds it; here every probability is
// rebuilt from q, k, the bias and the stats, so no (T, T) tensor is stored
// at any T):
//   1. with post_ln, dr = LN'(dy) (ln_bwd, one warp per row), else dr = dy;
//   2. da = dr Wo^T (rows_matmul);
//   3. attn_bwd_dq: one query per thread, keys streamed: delta = da . a per
//      (row, head), p rebuilt, dp = da . v, ds = p (dp - delta), dq = scale
//      sum ds k; writes dq into dqkv (B*T, 3D) and delta;
//   4. attn_bwd_dkv: one key per thread, queries streamed: dv = sum p da,
//      dk = scale sum ds q; writes dk, dv into dqkv;
//   5. the weight gradients dWqkv^T = dqkv^T [x | m], dWo^T = dr^T a and the
//      bias gradients (column sums) by the shared products of grad.cuh,
//      per row range then summed in a fixed order (no atomics);
//   6. dx = dr + dqkv Wqkv^T (self), or dx = dr + dq Wq^T and dmem = [dk dv]
//      [Wk Wv]^T (cross), by rows_matmul.
// Not copied from the TPU kernel: the key-major transposed scores, the
// exp2 / log2(e) fold, and its T <= 512 cap (keys and queries stream, so T
// is free).
#include "attention.cuh"
#include "common.cuh"
#include "grad.cuh"

using namespace kit;

namespace {

constexpr int QT = 128;  // queries per attention block, one per thread
constexpr int KT = 64;   // keys per shared tile
constexpr int KC = 16;   // keys per online-softmax chunk
constexpr int QC = 64;   // queries per shared tile of the key-major backward

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
                 const float* __restrict__ valid, float* __restrict__ out,
                 float* __restrict__ stats, int T, int H, int repeat_inc, int add_keypad,
                 float scale) {
  __shared__ __align__(16) float Ks[KT][DH];
  __shared__ __align__(16) float Vs[KT][DH];
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
    // the chunk at c0 = 0 of the first tile always holds key 0, so m is
    // finite from then on
    for (int c0 = 0; c0 < KT; c0 += KC)
      softmax_chunk<DH, KC>(q, o, m, l, &Ks[c0][0], &Vs[c0][0], DH, km + c0, kv + c0, qi,
                            k0 + c0, T, repeat_inc, add_keypad, scale);
    __syncthreads();
  }
  if (qi < T) {
    const float inv = 1.f / l;
    float* dst = out + ((size_t)b * T + qi) * D + h * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) dst[d] = o[d] * inv;
    if (stats != nullptr) {
      float* st = stats + (((size_t)b * H + h) * T + qi) * 2;
      st[0] = m;
      st[1] = l;
    }
  }
}

template <int TN>
__global__ void __launch_bounds__(NT)
out_proj_kernel(const float* __restrict__ a, const float* __restrict__ x, int M,
                const float* __restrict__ wo, const float* __restrict__ bo,
                const float* __restrict__ gamma, const float* __restrict__ beta,
                float* __restrict__ y, float* __restrict__ r_out) {
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
  if (gamma != nullptr) {
    if (r_out != nullptr) store_rows<TN>(r_out, D, D, row0, M, r);
    layer_norm<TN>(r, gamma, beta);
  }
  store_rows<TN>(y, D, D, row0, M, r);
}

// Backward, query-major: one query per thread, keys streamed.  dq (scaled)
// into dqkv[:, h*DH ...] and delta = da . a per (row, head).
template <int DH>
__global__ void __launch_bounds__(QT)
attn_bwd_dq_kernel(const float* __restrict__ qkv, const float* __restrict__ da,
                   const float* __restrict__ a, const float* __restrict__ stats,
                   const float* __restrict__ mask, const float* __restrict__ valid, int T, int H,
                   int repeat_inc, int add_keypad, float scale, float* __restrict__ dqkv,
                   float* __restrict__ delta) {
  __shared__ float Ks[KT][DH];
  __shared__ float Vs[KT][DH];
  __shared__ float km[KT];
  __shared__ float kv[KT];
  const int D = H * DH, ld = 3 * D;
  const int b = blockIdx.z, h = blockIdx.y;
  const int qi = blockIdx.x * QT + threadIdx.x;
  const bool in_q = qi < T;
  const size_t row = (size_t)b * T + qi;
  const float* base = qkv + (size_t)b * T * ld;

  float q[DH], g[DH], dq[DH];
  float dl = 0.f;
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    q[d] = in_q ? base[(size_t)qi * ld + h * DH + d] : 0.f;
    g[d] = in_q ? da[row * D + h * DH + d] : 0.f;
    dl = fmaf(g[d], in_q ? a[row * D + h * DH + d] : 0.f, dl);
    dq[d] = 0.f;
  }
  float m = 0.f, inv_l = 0.f;
  if (in_q) {
    const float* st = stats + (((size_t)b * H + h) * T + qi) * 2;
    m = st[0];
    inv_l = 1.f / st[1];
  }

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
    const int nk = min(KT, T - k0);
    for (int j = 0; j < nk; ++j) {
      float dot = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        dot = fmaf(q[d], Ks[j][d], dot);
        dp = fmaf(g[d], Vs[j][d], dp);
      }
      const float s = fmaf(dot, scale, key_bias(repeat_inc, add_keypad, qi, k0 + j, km[j], kv[j]));
      const float p = expf(s - m) * inv_l;
      const float ds = p * (dp - dl);
#pragma unroll
      for (int d = 0; d < DH; ++d) dq[d] = fmaf(ds, Ks[j][d], dq[d]);
    }
    __syncthreads();
  }
  if (in_q) {
    float* dst = dqkv + row * ld + h * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) dst[d] = dq[d] * scale;
    delta[((size_t)b * H + h) * T + qi] = dl;
  }
}

// Backward, key-major: one key per thread, queries streamed.  dk (scaled)
// and dv into dqkv[:, D + h*DH ...] and dqkv[:, 2D + h*DH ...].
template <int DH>
__global__ void __launch_bounds__(QT)
attn_bwd_dkv_kernel(const float* __restrict__ qkv, const float* __restrict__ da,
                    const float* __restrict__ stats, const float* __restrict__ delta,
                    const float* __restrict__ mask, const float* __restrict__ valid, int T, int H,
                    int repeat_inc, int add_keypad, float scale, float* __restrict__ dqkv) {
  __shared__ float Qs[QC][DH];
  __shared__ float Gs[QC][DH];
  __shared__ float qm[QC], qil[QC], qd[QC];  // row max, 1 / row sum, delta
  const int D = H * DH, ld = 3 * D;
  const int b = blockIdx.z, h = blockIdx.y;
  const int kj = blockIdx.x * QT + threadIdx.x;
  const bool in_k = kj < T;
  const float* base = qkv + (size_t)b * T * ld;
  const float kmj = (in_k && mask != nullptr) ? mask[(size_t)b * T + kj] : 0.f;
  const float kvj = (in_k && valid != nullptr) ? valid[(size_t)b * T + kj] : 1.f;

  float k[DH], v[DH], dk[DH], dv[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    k[d] = in_k ? base[(size_t)kj * ld + D + h * DH + d] : 0.f;
    v[d] = in_k ? base[(size_t)kj * ld + 2 * D + h * DH + d] : 0.f;
    dk[d] = 0.f;
    dv[d] = 0.f;
  }
  const size_t head = ((size_t)b * H + h) * T;
  for (int q0 = 0; q0 < T; q0 += QC) {
    for (int idx = threadIdx.x; idx < QC * DH; idx += QT) {
      int i = idx / DH, d = idx - i * DH;
      int qi = q0 + i;
      bool in = qi < T;
      Qs[i][d] = in ? base[(size_t)qi * ld + h * DH + d] : 0.f;
      Gs[i][d] = in ? da[((size_t)b * T + qi) * D + h * DH + d] : 0.f;
    }
    for (int i = threadIdx.x; i < QC; i += QT) {
      int qi = q0 + i;
      bool in = qi < T;
      qm[i] = in ? stats[(head + qi) * 2] : 0.f;
      qil[i] = in ? 1.f / stats[(head + qi) * 2 + 1] : 0.f;
      qd[i] = in ? delta[head + qi] : 0.f;
    }
    __syncthreads();
    const int nq = min(QC, T - q0);
    for (int i = 0; i < nq; ++i) {
      float dot = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        dot = fmaf(Qs[i][d], k[d], dot);
        dp = fmaf(Gs[i][d], v[d], dp);
      }
      const float s = fmaf(dot, scale, key_bias(repeat_inc, add_keypad, q0 + i, kj, kmj, kvj));
      const float p = expf(s - qm[i]) * qil[i];
      const float ds = p * (dp - qd[i]);
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        dv[d] = fmaf(p, Gs[i][d], dv[d]);
        dk[d] = fmaf(ds, Qs[i][d], dk[d]);
      }
    }
    __syncthreads();
  }
  if (in_k) {
    float* dst = dqkv + ((size_t)b * T + kj) * ld + h * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      dst[D + d] = dk[d] * scale;
      dst[2 * D + d] = dv[d];
    }
  }
}

template <int DH>
int launch_core(const float* qkv, const float* mask, const float* valid, float* a, float* stats,
                int B, int T, int H, int repeat_inc, int add_keypad, cudaStream_t st) {
  dim3 grid((T + QT - 1) / QT, H, B);
  attn_core_kernel<DH><<<grid, QT, 0, st>>>(qkv, mask, valid, a, stats, T, H, repeat_inc,
                                            add_keypad, 1.f / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

template <int DH>
int launch_core_bwd(const float* qkv, const float* da, const float* a, const float* stats,
                    const float* mask, const float* valid, int B, int T, int H, int repeat_inc,
                    int add_keypad, float* dqkv, float* delta, cudaStream_t st) {
  dim3 grid((T + QT - 1) / QT, H, B);
  const float scale = 1.f / sqrtf((float)DH);
  attn_bwd_dq_kernel<DH><<<grid, QT, 0, st>>>(qkv, da, a, stats, mask, valid, T, H, repeat_inc,
                                              add_keypad, scale, dqkv, delta);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  attn_bwd_dkv_kernel<DH><<<grid, QT, 0, st>>>(qkv, da, stats, delta, mask, valid, T, H,
                                               repeat_inc, add_keypad, scale, dqkv);
  return (int)cudaGetLastError();
}

template <int TN>
int launch_rows(const float* x, const float* mem, int M, const float* wqkv, const float* bqkv,
                const float* wo, const float* bo, const float* gamma, const float* beta,
                float* qkv, float* a, float* y, float* stats, float* r_out, int B, int T, int H,
                int repeat_inc, int add_keypad, const float* mask, const float* valid,
                cudaStream_t st) {
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
    case 16: rc = launch_core<16>(qkv, mask, valid, a, stats, B, T, H, repeat_inc, add_keypad, st); break;
    case 32: rc = launch_core<32>(qkv, mask, valid, a, stats, B, T, H, repeat_inc, add_keypad, st); break;
    case 64: rc = launch_core<64>(qkv, mask, valid, a, stats, B, T, H, repeat_inc, add_keypad, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;

  out_proj_kernel<TN><<<blocks, NT, smem, st>>>(a, x, M, wo, bo, gamma, beta, y, r_out);
  return (int)cudaGetLastError();
}

template <int TN>
int launch_bwd(const float* dy, const float* x, const float* mem, const float* qkv,
               const float* a, const float* stats, const float* r, const float* w_in,
               const float* w_out, const float* gamma, const float* mask, const float* valid,
               int B, int T, int H, int repeat_inc, int add_keypad, int s_w, int s_vec, float* dx,
               float* dmem, float* dw_in, float* db_in, float* dw_out, float* db_out,
               float* ln_out, float* scratch, cudaStream_t st) {
  constexpr int D = 32 * TN;
  const int M = B * T, blocks = (M + BM - 1) / BM;
  const bool self = mem == nullptr;
  const float* m = self ? x : mem;
  float* dr_buf = scratch;                               // M x D
  float* da = dr_buf + (size_t)M * D;                    // M x D
  float* dqkv = da + (size_t)M * D;                      // M x 3D
  float* delta = dqkv + (size_t)M * 3 * D;               // B x H x T
  float* p_ln = delta + round_up(B * H * T, 4);          // blocks x 2D
  float* p_wq = p_ln + (size_t)blocks * 2 * D;           // s_w x D x D
  float* p_wkv = p_wq + (size_t)s_w * D * D;             // s_w x 2D x D
  float* p_wo = p_wkv + (size_t)s_w * 2 * D * D;         // s_w x D x D
  float* p_bin = p_wo + (size_t)s_w * D * D;             // s_vec x 3D
  float* p_bo = p_bin + (size_t)s_vec * 3 * D;           // s_vec x D
  int rc;
#define KIT_CHECK(x) \
  if ((rc = (x)) != 0) return rc
  const float* dr = dy;
  if (gamma != nullptr) {
    ln_bwd_kernel<TN><<<blocks, NT, 0, st>>>(dy, r, gamma, M, dr_buf, p_ln);
    KIT_CHECK((int)cudaGetLastError());
    KIT_CHECK(sum_parts(p_ln, blocks, 2 * D, ln_out, st));
    dr = dr_buf;
  }
  KIT_CHECK(rows_matmul<TN>(dr, D, D, w_out, D, nullptr, M, da, st));  // da = dr Wo^T
  switch (D / H) {
    case 16: rc = launch_core_bwd<16>(qkv, da, a, stats, mask, valid, B, T, H, repeat_inc, add_keypad, dqkv, delta, st); break;
    case 32: rc = launch_core_bwd<32>(qkv, da, a, stats, mask, valid, B, T, H, repeat_inc, add_keypad, dqkv, delta, st); break;
    case 64: rc = launch_core_bwd<64>(qkv, da, a, stats, mask, valid, B, T, H, repeat_inc, add_keypad, dqkv, delta, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  KIT_CHECK(rc);
  // weight gradients in torch's layout: dW_in[j, i] = sum_r dqkv[r, j] m[r, i]
  KIT_CHECK(atb<false>(dqkv, 3 * D, x, D, M, D, D, s_w, p_wq, dw_in, st));
  KIT_CHECK(atb<false>(dqkv + D, 3 * D, m, D, M, 2 * D, D, s_w, p_wkv, dw_in + (size_t)D * D,
                       st));
  KIT_CHECK(atb<false>(dr, D, a, D, M, D, D, s_w, p_wo, dw_out, st));
  KIT_CHECK(colsum(dqkv, 3 * D, M, 3 * D, s_vec, p_bin, db_in, st));
  KIT_CHECK(colsum(dr, D, M, D, s_vec, p_bo, db_out, st));
  if (self) {
    KIT_CHECK(rows_matmul<TN>(dqkv, 3 * D, 3 * D, w_in, D, dr, M, dx, st));
  } else {
    KIT_CHECK(rows_matmul<TN>(dqkv, 3 * D, D, w_in, D, dr, M, dx, st));
    KIT_CHECK(rows_matmul<TN>(dqkv + D, 3 * D, 2 * D, w_in + (size_t)D * D, D, nullptr, M, dmem,
                              st));
  }
#undef KIT_CHECK
  return 0;
}

}  // namespace

// x, mem (B*T, D) -> y (B*T, D).  qkv (B*T, 3D) and a (B*T, D) are buffers
// the caller allocates (the training residuals q, k, v and a).  mask, valid
// (B, T) may be null (no keypad / repeat-inc term, all keys valid); gamma,
// beta null means no LayerNorm.  stats (B, H, T, 2) and r_out (B*T, D), when
// not null, receive each (row, head)'s softmax max and sum and the pre-LN
// sum.  D is 128 or 256 and D / H is 16, 32 or 64.
extern "C" int kit_attn_sublayer(const void* x, const void* mem, int B, int T, int D, int H,
                                 const void* wqkv, const void* bqkv, const void* wo,
                                 const void* bo, const void* gamma, const void* beta,
                                 const void* mask, const void* valid, int repeat_inc,
                                 int add_keypad, void* qkv, void* a, void* y, void* stats,
                                 void* r_out, void* stream) {
  auto st = (cudaStream_t)stream;
  auto p = [](const void* v) { return (const float*)v; };
  auto o = [](void* v) { return (float*)v; };
  const int M = B * T;
  switch (D) {
    case 128:
      return launch_rows<4>(p(x), p(mem), M, p(wqkv), p(bqkv), p(wo), p(bo), p(gamma), p(beta),
                            o(qkv), o(a), o(y), o(stats), o(r_out), B, T, H, repeat_inc,
                            add_keypad, p(mask), p(valid), st);
    case 256:
      return launch_rows<8>(p(x), p(mem), M, p(wqkv), p(bqkv), p(wo), p(bo), p(gamma), p(beta),
                            o(qkv), o(a), o(y), o(stats), o(r_out), B, T, H, repeat_inc,
                            add_keypad, p(mask), p(valid), st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Gradients of kit_attn_sublayer's y given dy = dL/dy (B*T, D), the
// forward's inputs and its residuals qkv, a, stats and r (r with a
// LayerNorm only).  mem null means self-attention (dmem is then unused);
// w_in (3D, D) and w_out (D, D) are in torch's layout (W^T of the Flax
// weights).  Writes dx, dmem, dw_in (3D, D), db_in (3D), dw_out (D, D),
// db_out (D) and, with gamma, ln_out = [dgamma | dbeta].  scratch holds
// 5 M D + B H T (rounded up to 4) + blocks * 2 D + s_w * 4 D^2 +
// s_vec * 4 D floats, M = B*T, blocks = ceil(M / 32).
extern "C" int kit_attn_sublayer_bwd(const void* dy, const void* x, const void* mem,
                                     const void* qkv, const void* a, const void* stats,
                                     const void* r, const void* w_in, const void* w_out,
                                     const void* gamma, const void* mask, const void* valid,
                                     int B, int T, int D, int H, int repeat_inc, int add_keypad,
                                     int s_w, int s_vec, void* dx, void* dmem, void* dw_in,
                                     void* db_in, void* dw_out, void* db_out, void* ln_out,
                                     void* scratch, void* stream) {
  auto st = (cudaStream_t)stream;
  auto p = [](const void* v) { return (const float*)v; };
  auto o = [](void* v) { return (float*)v; };
  switch (D) {
    case 128:
      return launch_bwd<4>(p(dy), p(x), p(mem), p(qkv), p(a), p(stats), p(r), p(w_in), p(w_out),
                           p(gamma), p(mask), p(valid), B, T, H, repeat_inc, add_keypad, s_w,
                           s_vec, o(dx), o(dmem), o(dw_in), o(db_in), o(dw_out), o(db_out),
                           o(ln_out), o(scratch), st);
    case 256:
      return launch_bwd<8>(p(dy), p(x), p(mem), p(qkv), p(a), p(stats), p(r), p(w_in), p(w_out),
                           p(gamma), p(mask), p(valid), B, T, H, repeat_inc, add_keypad, s_w,
                           s_vec, o(dx), o(dmem), o(dw_in), o(db_in), o(dw_out), o(db_out),
                           o(ln_out), o(scratch), st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
