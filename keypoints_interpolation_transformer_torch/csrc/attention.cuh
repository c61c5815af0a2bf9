// The attention core shared by the per-op attention kernels (attention.cu),
// the sublayer kernels (attn_sublayer.cu) and the whole-layer kernels
// (layer_fused.cu): the additive bias built from the 1-D masks, one chunk
// of the online softmax of one query, and the per-query forward and
// backward kernels that the first two run (q, k, v and their gradients at
// any row stride, so a packed [q | k | v] row and three separate tensors
// take the same kernels).
#pragma once

#include "common.cuh"

namespace kit {

// The additive bias of (query qi, key) from the key's mask and valid
// values (ops/pallas/attention.py::_bias_terms): NEG where kind is
// repeat-inc, key > query and mask[key] == 1; + mask[key] when add_keypad;
// + NEG where valid[key] == 0.  The same expression in every forward and
// backward core, so a backward sees its forward's bias bit for bit.
__device__ __forceinline__ float key_bias(int repeat_inc, int add_keypad, int qi, int key,
                                          float km, float kv) {
  float bias = (repeat_inc && key > qi && km > 0.f) ? NEG : 0.f;
  if (add_keypad) bias += km;
  bias += kv > 0.f ? 0.f : NEG;
  return bias;
}

// Head widths: the kernels are built for dh = 16, 32 and 64 exactly (EXACT:
// loops unrolled, rows read as float4, as the flagship's dh = 32 runs), once
// more for any other dh up to 128 (DH = 128, not EXACT: loops over the dh
// columns not unrolled, rows read as scalars), and once for 128 < dh <= 512
// (DH = 512, not EXACT), so that a rare width costs one build, not one per
// width.  by_head picks the build.  In the builds that are not EXACT a
// thread's query row and output (and, backward, its gradient rows) are
// arrays indexed at run time: they live in the thread's local memory (L1
// cached), not in registers; at DH = 512 that is 4-8 KB a thread, so the
// wide build is slow, and right.

// Fold keys key0 .. key0 + KC - 1 into one query's online softmax: s =
// q . k * scale + bias (keys >= T count as -inf), then the running max m,
// sum l and unnormalized output o are rescaled to the new max.  K and V
// point at the chunk's first key and the head's first column in shared
// memory (row stride ld; with EXACT both 16-byte aligned and ld a multiple
// of 4); q and o hold the query's dh (= DH with EXACT) values; km, kv at
// the chunk's mask and valid values.  The chunk must hold a key < T or m
// must already be finite, so that no -inf - -inf arises.
template <int DH, int KC, bool EXACT>
__device__ __forceinline__ void softmax_chunk(const float (&q)[DH], float (&o)[DH], float& m,
                                              float& l, const float* K, const float* V, int ld,
                                              const float* km, const float* kv, int qi, int key0,
                                              int T, int repeat_inc, int add_keypad,
                                              float scale, int dh) {
  static_assert(!EXACT || DH % 4 == 0, "exact head rows are read as float4");
  float s[KC];
  float cmax = -INFINITY;
#pragma unroll
  for (int jj = 0; jj < KC; ++jj) {
    const int key = key0 + jj;
    float dot = 0.f;
    if constexpr (EXACT) {
#pragma unroll
      for (int d = 0; d < DH; d += 4) {
        const float4 k4 = *reinterpret_cast<const float4*>(K + jj * ld + d);
        dot = fmaf(q[d], k4.x, dot);
        dot = fmaf(q[d + 1], k4.y, dot);
        dot = fmaf(q[d + 2], k4.z, dot);
        dot = fmaf(q[d + 3], k4.w, dot);
      }
    } else {
#pragma unroll 1
      for (int d = 0; d < dh; ++d) dot = fmaf(q[d], K[jj * ld + d], dot);
    }
    const float bias = key_bias(repeat_inc, add_keypad, qi, key, km[jj], kv[jj]);
    s[jj] = key < T ? fmaf(dot, scale, bias) : -INFINITY;
    cmax = fmaxf(cmax, s[jj]);
  }
  const float mnew = fmaxf(m, cmax);
  const float corr = expf(m - mnew);
  l *= corr;
#pragma unroll (EXACT ? DH : 1)
  for (int d = 0; d < (EXACT ? DH : dh); ++d) o[d] *= corr;
#pragma unroll
  for (int jj = 0; jj < KC; ++jj) {
    const float p = expf(s[jj] - mnew);
    l += p;
    if constexpr (EXACT) {
#pragma unroll
      for (int d = 0; d < DH; d += 4) {
        const float4 v4 = *reinterpret_cast<const float4*>(V + jj * ld + d);
        o[d] = fmaf(p, v4.x, o[d]);
        o[d + 1] = fmaf(p, v4.y, o[d + 1]);
        o[d + 2] = fmaf(p, v4.z, o[d + 2]);
        o[d + 3] = fmaf(p, v4.w, o[d + 3]);
      }
    } else {
#pragma unroll 1
      for (int d = 0; d < dh; ++d) o[d] = fmaf(p, V[jj * ld + d], o[d]);
    }
  }
  m = mnew;
}

constexpr int ATT_QT = 128;  // queries (keys in the dk / dv pass) per block, one per thread
constexpr int ATT_KC = 16;   // keys per online-softmax chunk (at most one tile)
// keys per shared tile, and queries per shared tile of the key-major
// backward: 64, or 4096 / DH above DH = 64 (32 at 128, 8 at 512), as two
// tiles of DH floats must fit the 48 KB of static shared memory
template <int DH>
__host__ __device__ constexpr int att_tile() { return DH > 64 ? 4096 / DH : 64; }

constexpr int MAX_HEAD = 512;  // the widest head the kernels take (the widest D)

// A build of the head-width kernels: DH columns per query, EXACT or not
// (see softmax_chunk).
template <int DH_, bool EXACT_>
struct HeadBuild {
  static constexpr int DH = DH_;
  static constexpr bool EXACT = EXACT_;
};

// Stage keys [k0, k0 + att_tile) of one head: its first dh k and v columns
// (row stride ld; the rest of each row 0) and the keys' mask and valid
// values; keys >= T read as 0 (mask) and 1 (valid) and are skipped by the
// callers.
template <int DH>
__device__ __forceinline__ void stage_keys(float (*Ks)[DH], float (*Vs)[DH], float* km, float* kv,
                                           const float* __restrict__ kb,
                                           const float* __restrict__ vb, int ld,
                                           const float* __restrict__ mrow,
                                           const float* __restrict__ vrow, int k0, int T,
                                           int dh) {
  constexpr int KT = att_tile<DH>();
  for (int idx = threadIdx.x; idx < KT * DH; idx += blockDim.x) {
    int j = idx / DH, d = idx - j * DH;
    int key = k0 + j;
    bool in = key < T && d < dh;
    Ks[j][d] = in ? kb[(size_t)key * ld + d] : 0.f;
    Vs[j][d] = in ? vb[(size_t)key * ld + d] : 0.f;
  }
  for (int j = threadIdx.x; j < KT; j += blockDim.x) {
    int key = k0 + j;
    km[j] = (key < T && mrow != nullptr) ? mrow[key] : 0.f;
    kv[j] = (key < T && vrow != nullptr) ? vrow[key] : 1.f;
  }
}

// In the kernels below hd is the head width: DH when EXACT (a constant, so
// the loops over it unroll), else the dh argument.

// Forward, one query per thread, keys streamed through shared memory with an
// online softmax: out = softmax(q k^T * scale + bias) v for head blockIdx.y
// of video blockIdx.z.  q, k, v point at the video-0 row 0, column 0 of
// each tensor (row stride ld; head h at column h * hd), out likewise with
// row stride ldo.  stats, when not null, receives each (video, head,
// query)'s row max and row sum (B, H, T, 2): the log-sum-exp in two parts,
// since m + log(l) rounds log(l) away when m = NEG (a row whose keys are
// all blocked).
template <int DH, bool EXACT>
__global__ void __launch_bounds__(ATT_QT)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, int ld, const float* __restrict__ mask,
                const float* __restrict__ valid, float* __restrict__ out, int ldo,
                float* __restrict__ stats, int T, int H, int repeat_inc, int add_keypad,
                float scale, int dh) {
  constexpr int KT = att_tile<DH>();
  constexpr int KC = KT < ATT_KC ? KT : ATT_KC;
  __shared__ __align__(16) float Ks[KT][DH];
  __shared__ __align__(16) float Vs[KT][DH];
  __shared__ float km[KT];  // mask[key]
  __shared__ float kv[KT];  // valid[key]
  const int hd = EXACT ? DH : dh;
  const int b = blockIdx.z, h = blockIdx.y;
  const int qi = blockIdx.x * ATT_QT + threadIdx.x;
  const size_t row0 = (size_t)b * T;
  const float* kb = k + row0 * ld + h * hd;
  const float* vb = v + row0 * ld + h * hd;
  const float* mrow = mask == nullptr ? nullptr : mask + row0;
  const float* vrow = valid == nullptr ? nullptr : valid + row0;

  float qr[DH], o[DH];
#pragma unroll (EXACT ? DH : 1)
  for (int d = 0; d < hd; ++d) {
    qr[d] = qi < T ? q[(row0 + qi) * ld + h * hd + d] : 0.f;
    o[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < T; k0 += KT) {
    stage_keys<DH>(Ks, Vs, km, kv, kb, vb, ld, mrow, vrow, k0, T, hd);
    __syncthreads();
    // the chunk at c0 = 0 of the first tile always holds key 0, so m is
    // finite from then on
    for (int c0 = 0; c0 < KT && k0 + c0 < T; c0 += KC)
      softmax_chunk<DH, KC, EXACT>(qr, o, m, l, &Ks[c0][0], &Vs[c0][0], DH, km + c0,
                                       kv + c0, qi, k0 + c0, T, repeat_inc, add_keypad, scale,
                                       hd);
    __syncthreads();
  }
  if (qi < T) {
    const float inv = 1.f / l;
    float* dst = out + (row0 + qi) * ldo + h * hd;
#pragma unroll (EXACT ? DH : 1)
    for (int d = 0; d < hd; ++d) dst[d] = o[d] * inv;
    if (stats != nullptr) {
      float* st = stats + (((size_t)b * H + h) * T + qi) * 2;
      st[0] = m;
      st[1] = l;
    }
  }
}

// Backward, query-major: one query per thread, keys streamed.  From g =
// dL/dout and the forward's out (both at row stride ldg) and stats: delta =
// g . out per (video, head, query) into delta (B, H, T), p rebuilt, dp =
// g . v, ds = p (dp - delta), dq = scale * sum ds k into dq (row stride ldq).
template <int DH, bool EXACT>
__global__ void __launch_bounds__(ATT_QT)
attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, int ld, const float* __restrict__ g,
                   const float* __restrict__ out, int ldg, const float* __restrict__ stats,
                   const float* __restrict__ mask, const float* __restrict__ valid, int T, int H,
                   int repeat_inc, int add_keypad, float scale, float* __restrict__ dq, int ldq,
                   float* __restrict__ delta, int dh) {
  constexpr int KT = att_tile<DH>();
  __shared__ __align__(16) float Ks[KT][DH];
  __shared__ __align__(16) float Vs[KT][DH];
  __shared__ float km[KT];
  __shared__ float kv[KT];
  const int hd = EXACT ? DH : dh;
  const int b = blockIdx.z, h = blockIdx.y;
  const int qi = blockIdx.x * ATT_QT + threadIdx.x;
  const bool in_q = qi < T;
  const size_t row0 = (size_t)b * T, row = row0 + qi;
  const float* kb = k + row0 * ld + h * hd;
  const float* vb = v + row0 * ld + h * hd;
  const float* mrow = mask == nullptr ? nullptr : mask + row0;
  const float* vrow = valid == nullptr ? nullptr : valid + row0;

  float qr[DH], gr[DH], dqr[DH];
  float dl = 0.f;
#pragma unroll (EXACT ? DH : 1)
  for (int d = 0; d < hd; ++d) {
    qr[d] = in_q ? q[row * ld + h * hd + d] : 0.f;
    gr[d] = in_q ? g[row * ldg + h * hd + d] : 0.f;
    dl = fmaf(gr[d], in_q ? out[row * ldg + h * hd + d] : 0.f, dl);
    dqr[d] = 0.f;
  }
  float m = 0.f, inv_l = 0.f;
  if (in_q) {
    const float* st = stats + (((size_t)b * H + h) * T + qi) * 2;
    m = st[0];
    inv_l = 1.f / st[1];
  }

  for (int k0 = 0; k0 < T; k0 += KT) {
    stage_keys<DH>(Ks, Vs, km, kv, kb, vb, ld, mrow, vrow, k0, T, hd);
    __syncthreads();
    const int nk = min(KT, T - k0);
    for (int j = 0; j < nk; ++j) {
      float dot = 0.f, dp = 0.f;
#pragma unroll (EXACT ? DH : 1)
      for (int d = 0; d < hd; ++d) {
        dot = fmaf(qr[d], Ks[j][d], dot);
        dp = fmaf(gr[d], Vs[j][d], dp);
      }
      const float s = fmaf(dot, scale, key_bias(repeat_inc, add_keypad, qi, k0 + j, km[j], kv[j]));
      const float p = expf(s - m) * inv_l;
      const float ds = p * (dp - dl);
#pragma unroll (EXACT ? DH : 1)
      for (int d = 0; d < hd; ++d) dqr[d] = fmaf(ds, Ks[j][d], dqr[d]);
    }
    __syncthreads();
  }
  if (in_q) {
    float* dst = dq + row * ldq + h * hd;
#pragma unroll (EXACT ? DH : 1)
    for (int d = 0; d < hd; ++d) dst[d] = dqr[d] * scale;
    delta[((size_t)b * H + h) * T + qi] = dl;
  }
}

// Backward, key-major: one key per thread, queries streamed.  dk = scale *
// sum ds q and dv = sum p g into dk and dv (row stride ldkv).
template <int DH, bool EXACT>
__global__ void __launch_bounds__(ATT_QT)
attn_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, int ld, const float* __restrict__ g, int ldg,
                    const float* __restrict__ stats, const float* __restrict__ delta,
                    const float* __restrict__ mask, const float* __restrict__ valid, int T, int H,
                    int repeat_inc, int add_keypad, float scale, float* __restrict__ dk,
                    float* __restrict__ dv, int ldkv, int dh) {
  constexpr int QC = att_tile<DH>();
  __shared__ float Qs[QC][DH];
  __shared__ float Gs[QC][DH];
  __shared__ float qm[QC], qil[QC], qd[QC];  // row max, 1 / row sum, delta
  const int hd = EXACT ? DH : dh;
  const int b = blockIdx.z, h = blockIdx.y;
  const int kj = blockIdx.x * ATT_QT + threadIdx.x;
  const bool in_k = kj < T;
  const size_t row0 = (size_t)b * T;
  const float kmj = (in_k && mask != nullptr) ? mask[row0 + kj] : 0.f;
  const float kvj = (in_k && valid != nullptr) ? valid[row0 + kj] : 1.f;

  float kr[DH], vr[DH], dkr[DH], dvr[DH];
#pragma unroll (EXACT ? DH : 1)
  for (int d = 0; d < hd; ++d) {
    kr[d] = in_k ? k[(row0 + kj) * ld + h * hd + d] : 0.f;
    vr[d] = in_k ? v[(row0 + kj) * ld + h * hd + d] : 0.f;
    dkr[d] = 0.f;
    dvr[d] = 0.f;
  }
  const size_t head = ((size_t)b * H + h) * T;
  for (int q0 = 0; q0 < T; q0 += QC) {
    for (int idx = threadIdx.x; idx < QC * DH; idx += ATT_QT) {
      int i = idx / DH, d = idx - i * DH;
      int qi = q0 + i;
      bool in = qi < T && d < hd;
      Qs[i][d] = in ? q[(row0 + qi) * ld + h * hd + d] : 0.f;
      Gs[i][d] = in ? g[(row0 + qi) * ldg + h * hd + d] : 0.f;
    }
    for (int i = threadIdx.x; i < QC; i += ATT_QT) {
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
#pragma unroll (EXACT ? DH : 1)
      for (int d = 0; d < hd; ++d) {
        dot = fmaf(Qs[i][d], kr[d], dot);
        dp = fmaf(Gs[i][d], vr[d], dp);
      }
      const float s = fmaf(dot, scale, key_bias(repeat_inc, add_keypad, q0 + i, kj, kmj, kvj));
      const float p = expf(s - qm[i]) * qil[i];
      const float ds = p * (dp - qd[i]);
#pragma unroll (EXACT ? DH : 1)
      for (int d = 0; d < hd; ++d) {
        dvr[d] = fmaf(p, Gs[i][d], dvr[d]);
        dkr[d] = fmaf(ds, Qs[i][d], dkr[d]);
      }
    }
    __syncthreads();
  }
  if (in_k) {
#pragma unroll (EXACT ? DH : 1)
    for (int d = 0; d < hd; ++d) {
      dk[(row0 + kj) * ldkv + h * hd + d] = dkr[d] * scale;
      dv[(row0 + kj) * ldkv + h * hd + d] = dvr[d];
    }
  }
}

// The tensors of one attention call: q, k, v at row stride ld; out (the
// forward's output, which the backward reads) at ldo; mask, valid (B, T) or
// null; stats (B, H, T, 2).
struct AttnArgs {
  const float *q, *k, *v;
  int ld;
  const float *mask, *valid;
  float* out;
  int ldo;
  float* stats;
  int B, T, H, repeat_inc, add_keypad;
};

template <int DH, bool EXACT>
int launch_attn_fwd(const AttnArgs& a, int dh, cudaStream_t st) {
  dim3 grid((a.T + ATT_QT - 1) / ATT_QT, a.H, a.B);
  attn_fwd_kernel<DH, EXACT><<<grid, ATT_QT, 0, st>>>(
      a.q, a.k, a.v, a.ld, a.mask, a.valid, a.out, a.ldo, a.stats, a.T, a.H, a.repeat_inc,
      a.add_keypad, 1.f / sqrtf((float)dh), dh);
  return (int)cudaGetLastError();
}

// g = dL/dout at row stride a.ldo (as out); dq at ldq, dk and dv at ldkv;
// delta (B, H, T) scratch.
template <int DH, bool EXACT>
int launch_attn_bwd(const AttnArgs& a, int dh, const float* g, float* dq, int ldq, float* dk,
                    float* dv, int ldkv, float* delta, cudaStream_t st) {
  dim3 grid((a.T + ATT_QT - 1) / ATT_QT, a.H, a.B);
  const float scale = 1.f / sqrtf((float)dh);
  attn_bwd_dq_kernel<DH, EXACT><<<grid, ATT_QT, 0, st>>>(
      a.q, a.k, a.v, a.ld, g, a.out, a.ldo, a.stats, a.mask, a.valid, a.T, a.H, a.repeat_inc,
      a.add_keypad, scale, dq, ldq, delta, dh);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  attn_bwd_dkv_kernel<DH, EXACT><<<grid, ATT_QT, 0, st>>>(
      a.q, a.k, a.v, a.ld, g, a.ldo, a.stats, delta, a.mask, a.valid, a.T, a.H, a.repeat_inc,
      a.add_keypad, scale, dk, dv, ldkv, dh);
  return (int)cudaGetLastError();
}

// f(HeadBuild<DH, EXACT>{}) for the build that takes head width dh (see
// softmax_chunk); cudaErrorInvalidValue above LIMIT (at most MAX_HEAD).  A
// caller whose heads cannot be wider than 128 (a layer of width D = 128)
// passes LIMIT = 128, and the wide build is not instantiated for it.
template <int LIMIT = MAX_HEAD, typename F>
inline int by_head(int dh, F&& f) {
  static_assert(LIMIT <= MAX_HEAD, "no build is wider than MAX_HEAD");
  switch (dh) {
    case 16: return f(HeadBuild<16, true>{});
    case 32: return f(HeadBuild<32, true>{});
    case 64: return f(HeadBuild<64, true>{});
    default:
      if (dh < 1 || dh > LIMIT) return (int)cudaErrorInvalidValue;
      if constexpr (LIMIT > 128) {
        if (dh > 128) return f(HeadBuild<MAX_HEAD, false>{});
      }
      return f(HeadBuild<128, false>{});
  }
}

inline int attn_fwd(const AttnArgs& a, int dh, cudaStream_t st) {
  return by_head(dh, [&](auto hb) {
    using B = decltype(hb);
    return launch_attn_fwd<B::DH, B::EXACT>(a, dh, st);
  });
}

inline int attn_bwd(const AttnArgs& a, int dh, const float* g, float* dq, int ldq, float* dk,
                    float* dv, int ldkv, float* delta, cudaStream_t st) {
  return by_head(dh, [&](auto hb) {
    using B = decltype(hb);
    return launch_attn_bwd<B::DH, B::EXACT>(a, dh, g, dq, ldq, dk, dv, ldkv, delta, st);
  });
}

}  // namespace kit
