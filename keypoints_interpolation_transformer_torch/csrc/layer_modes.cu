// Whole transformer layers in the precision modes "high" (bf16x3) and
// "default" (one bf16 pass), one C entry each: the post-LN encoder layer
// (kit_enc_layer_tc) and the decoder layer (kit_dec_layer_tc: self-attention
// + LN1, cross-attention and, when asked, the FF tail).
//
// Replaces keypoints_interpolation_transformer_tpu/ops/pallas/layer_fused.py
// under those modes: _enc_kernel (enc_layer_high, enc_layer_default) and
// _dec_kernel (dec_layer_high, dec_layer_default), as _enc_fwd_pallas and
// _dec_fwd_pallas call them.  The contract, the TPU kernels' mode
// arithmetic:
//   * the scale log2(e) / sqrt(dh) multiplies Wq and bq in float32 before
//     anything is split (the wrapper folds it, with the weight planes), and
//     log2(e) multiplies the bias's keypad term, so the scores are in the
//     log2 domain and the softmax runs on exp2;
//   * every projection (q / k / v, the memory's k / v, the
//     out-projections, W1, W2) is x_hi W_hi + x_hi W_lo + x_lo W_hi at
//     "high" or x_hi W_hi at "default" (hi = bf16(x), lo = bf16(x - hi),
//     both rounded to nearest even), its float32 sum then + bias; an
//     activation is split once for all the products that read it;
//   * the scores of a head are k_hi q_hi^T + k_hi q_lo^T + k_lo q_hi^T,
//     three dots summed in float32, then + bias (NEG = -1e9, finite); the
//     softmax takes each row's max, exp2(s - max), the sum, and multiplies
//     by 1 / sum BEFORE it rounds the probabilities to one bf16 each, which
//     then multiply v_hi and v_lo as two dots ("default": one term each, p
//     and v in bf16), so a row whose keys are all blocked averages them;
//   * biases, residuals, LayerNorms and the exact-erf GELU stay float32.
// Not copied from the TPU kernel: the key-major score layout, the bb row
// batching, _head_group and the VMEM caps, and the stacked [hi | hi | lo]
// contraction (the same three terms; only the order of the float32 sums
// differs).
//
// What bounds it on an H100: the bf16 tensor cores.  The encoder layer is
// 2 D (4 D + 2 FF) FLOP per token of products plus 4 T D of attention (90
// GFLOP per call at B = 256, T = 128, D = 256, FF = 2048), three passes
// of it at "high" (about 0.27 ms at 989 TFLOP/s) and one at "default"; the
// decoder 2 D (8 D + 2 FF) + 8 T D.  Bytes are small beside that: the layer
// reads x (and the memory) and writes y, 1-2 KB a token, the weight planes
// stay in the 50 MB L2.
//
// Design.  A layer is one call of a short sequence of launches on the
// stream, each phase on the kernel that fits it, its intermediates in
// scratch the wrapper allocates (bf16 planes, and float32 where a
// LayerNorm or a residual reads them), never back in PyTorch:
//   1. split_kernel: x (and the memory) into hi / lo planes;
//   2. the projections on tc_gemm.cuh's tc_gemm_kernel (wgmma m64n128k16
//      from two consumer warpgroups, operands streamed by TMA through an
//      mbarrier ring, 128 x 128 output tiles): q / k / v in one product of
//      [Wq s | Wk | Wv] (the decoder's cross k / v from the memory, its
//      cross q from x1 in two more), the epilogue adding the bias and
//      splitting the result into the planes the attention core reads;
//   3. attn_mode_kernel (below): the attention core per (query block,
//      head, video) on mma.sync m16n8k16, writing the output's planes;
//   4. the out-projection on tc_gemm_kernel, its epilogue adding the bias
//      and the residual (float32); in the decoder, ln_fwd_kernel then makes
//      x1 = LN1(r) and its planes;
//   5. the FF tail: ffn_tc.cuh's ffn_tc_kernel, the FF sublayer's own
//      kernel in the mode (u and z in registers, gelu(u) the register A
//      operand of the second product; its FF split over tc_parts blocks
//      and ffn_finish_kernel at small batches), LN_in before it.
// Why not one launch a layer, as layer_fused.cu walks the float32 layer in
// one cluster per video: the phases want different blocks (the products a
// producer warpgroup and two consumer warpgroups with 200 KB of ring, the
// attention core four warps and a head's keys), each launch's grid fills
// the card at any batch without the cluster machinery (one 128-frame video
// runs its q / k / v on 6 SMs, its attention on 16, its FF on 32), and the
// float32 kernel's intermediates go through device memory (L2) between its
// phases as these do.  What it costs is a launch per phase (5 for an
// encoder layer, 11 for a decoder layer, one more each with the FF split),
// each a host call.
//
// The attention core (attn_mode_kernel): a block of 1-4 warps owns 16
// query rows a warp of one head of one video; q's planes for them, and
// the head's k and v planes for KB keys at a time (all T when they fit,
// which they do for dh <= 32 at T <= 512) with each key's bias, sit in
// shared memory, rows padded so that fragment loads meet no bank conflict
// (v's B fragments come transposed by ldmatrix).  The head width is padded
// with zeros to DP, a multiple of 16 (the k of m16n8k16).  Two sweeps over
// the keys, each recomputing the scores of 16 keys at a time from the
// planes (the three terms in their own accumulators, added as the TPU
// kernel adds its three dots): the row's max and its sum of exp2(s - max)
// (a running max, the sum rescaled as it grows: the same sum in another
// float32 order), then per 32 or 64 columns of the output p = bf16(exp2(s
// - max) * (1 / sum)) as the A fragment of p v_hi and p v_lo, each term in
// its own accumulator.  The scores cost 2 T dh FLOP a query a term and a
// sweep, small beside the projections, and the rounding of p needs the
// row's max and sum before any p.
#include "common.cuh"
#include "ffn_tc.cuh"
#include "grad.cuh"
#include "mma_bf16.cuh"
#include "tc_gemm.cuh"

using namespace kit;

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int ATTN_SMEM = 232448;  // an H100 block's dynamic shared memory

struct AttnMode {      // one attention core in a mode
  const bf16 *qh, *ql;  // q's planes: head h of row t of video b at (b T + t) ldq + h dh
  const bf16 *kh, *kl;  // k's and v's planes, row stride ldkv
  const bf16 *vh, *vl;
  int ldq, ldkv;
  const float* mask;    // (B, T) or null
  const float* valid;   // (B, T) or null: every key valid
  int repeat_inc, add_keypad;
  bf16 *oh, *ol;        // the output's planes, row stride ldo
  int ldo;
  int T, dh, DP, KB;    // DP: dh rounded up to 16; KB: keys a stage, a multiple of 16
};

// d += a b, m16n8k16, bf16 in, float32 accumulate; a the A fragment (4
// registers), b0 / b1 the B fragment.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The shared memory of attn_mode_kernel: q's planes (16 W rows), and KB
// keys of k's and of v's planes, every row DP + 8 wide (a row of 4 mod 8
// words keeps a fragment's 32 loads on 32 banks, and 16-byte rows serve
// ldmatrix), then each key's bias (two floats).
__host__ __device__ constexpr int attn_smem(int planes, int W, int DP, int KB) {
  return 2 * planes * (16 * W + 2 * KB) * (DP + 8) + 8 * KB;
}

// The B fragments of two n8 tiles of p v: v's rows j0 .. j0 + 15 (the k of
// m16n8k16) at columns d0 .. d0 + 15 of a row-major tile (row stride ld),
// transposed by ldmatrix: {b0, b1} of columns d0 .., then of d0 + 8 ...
__device__ __forceinline__ void v_fragments(uint32_t (&b)[4], const bf16* V, int ld, int j0,
                                            int d0, int lane) {
  const bf16* row = V + (j0 + (lane & 15)) * ld + d0 + 8 * (lane >> 4);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(smem_u32(row)));
}

// The attention core of head blockIdx.y of video blockIdx.z for the
// blockDim.x / 2 query rows from blockIdx.x times that (see the note at the
// top): out = softmax(q k^T + bias) v in the mode's passes, written as the
// output's hi / lo planes at the head's dh columns (rows < T only), NO n8
// tiles (8 NO columns) of the output at a time.
template <int PASSES, int NO>
__global__ void __launch_bounds__(128) attn_mode_kernel(const AttnMode p) {
  constexpr int PL = PASSES == 3 ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int QR = blockDim.x / 2;  // 16 rows a warp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, row0 = blockIdx.x * QR, T = p.T, dh = p.dh, DP = p.DP, KB = p.KB;
  const int QLD = DP + 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // PL planes of QR x QLD
  bf16* Ks = Qs + PL * QR * QLD;                  // PL planes of KB x QLD
  bf16* Vs = Ks + PL * KB * QLD;                  // PL planes of KB x QLD
  // key j's bias for a query at or after it, and for one before it
  float2* kbias = reinterpret_cast<float2*>(Vs + PL * KB * QLD);
  const size_t vid = (size_t)blockIdx.z * T;
  const int hc = h * dh;  // the head's first column
  const bool vec = dh % 8 == 0;  // 16-byte rows: whole 8-column chunks
  // rows first .. first + rows - 1 of the head's DP columns of a matrix's
  // planes (row stride ld) into dst's planes (plane stride pstride), zero
  // past T and dh; 8 columns a chunk, four chunks a thread in flight
  auto stage = [&](bf16* dst, int pstride, const bf16* sh, const bf16* sl, int ld, int first,
                   int rows) {
    const int cpr = DP / 8, n = rows * cpr;
    for (int i0 = threadIdx.x; i0 < n; i0 += 4 * blockDim.x) {
      uint4 vh[4], vl[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        vh[u] = vl[u] = make_uint4(0u, 0u, 0u, 0u);
        const int i = i0 + u * blockDim.x;
        if (i >= n) continue;
        const int r = i / cpr, c = 8 * (i - r * cpr), row = first + r;
        if (row >= T || c >= dh) continue;
        const size_t o = (vid + row) * ld + hc + c;
        if (vec) {
          vh[u] = __ldg(reinterpret_cast<const uint4*>(sh + o));
          if (PL == 2) vl[u] = __ldg(reinterpret_cast<const uint4*>(sl + o));
        } else {  // one value at a time, packed in registers
          uint32_t wh[4] = {0u, 0u, 0u, 0u}, wl[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            if (c + e >= dh) break;
            wh[e >> 1] |= (uint32_t)__bfloat16_as_ushort(sh[o + e]) << (16 * (e & 1));
            if (PL == 2)
              wl[e >> 1] |= (uint32_t)__bfloat16_as_ushort(sl[o + e]) << (16 * (e & 1));
          }
          vh[u] = make_uint4(wh[0], wh[1], wh[2], wh[3]);
          vl[u] = make_uint4(wl[0], wl[1], wl[2], wl[3]);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * blockDim.x;
        if (i >= n) continue;
        const int r = i / cpr, c = 8 * (i - r * cpr);
        *reinterpret_cast<uint4*>(dst + r * QLD + c) = vh[u];
        if (PL == 2) *reinterpret_cast<uint4*>(dst + pstride + r * QLD + c) = vl[u];
      }
    }
  };
  stage(Qs, QR * QLD, p.qh, p.ql, p.ldq, row0, QR);
  const float* mask = p.mask == nullptr ? nullptr : p.mask + vid;
  const float* valid = p.valid == nullptr ? nullptr : p.valid + vid;
  // the bias terms in the order of _bias_terms_T: (blocked ? NEG : 0), +
  // the keypad term times log2(e), + NEG on an invalid key; a key past T
  // -inf, so that it weighs nothing
  auto stage_keys = [&](int k0) {
    stage(Ks, KB * QLD, p.kh, p.kl, p.ldkv, k0, KB);
    stage(Vs, KB * QLD, p.vh, p.vl, p.ldkv, k0, KB);
    for (int j = threadIdx.x; j < KB; j += blockDim.x) {
      const int key = k0 + j;
      float2 b = make_float2(-INFINITY, -INFINITY);
      if (key < T) {
        const float km = mask == nullptr ? 0.f : __ldg(mask + key);
        float open = 0.f, shut = (p.repeat_inc && km > 0.f) ? NEG : 0.f;
        if (p.add_keypad) {
          open = open + km * LOG2E;
          shut = shut + km * LOG2E;
        }
        if (valid != nullptr) {
          const float vb = __ldg(valid + key) > 0.f ? 0.f : NEG;
          open = open + vb;
          shut = shut + vb;
        }
        b = make_float2(open, shut);
      }
      kbias[j] = b;
    }
  };
  const int qa = row0 + 16 * warp + g, qb = qa + 8;  // the thread's two query rows
  // s = the scores of keys key0 + 16 (this stage's j0 ..) in the C layout:
  // s[nt][e] is row (e < 2 ? qa : qb), key key0 + 8 nt + 2 t + (e & 1);
  // -inf past T.  The bias in the order of _bias_terms_T.
  auto scores = [&](float (&s)[2][4], int j0, int key0) {
    float hh[2][4], hl[2][4], lh[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) hh[nt][e] = hl[nt][e] = lh[nt][e] = 0.f;
    for (int ks = 0; ks < DP / 16; ++ks) {
      const bf16* qp = Qs + (16 * warp + g) * QLD + 16 * ks + 2 * t;
      const uint32_t ah[4] = {ld32(qp), ld32(qp + 8 * QLD), ld32(qp + 8), ld32(qp + 8 * QLD + 8)};
      uint32_t al[4] = {0u, 0u, 0u, 0u};
      if (PL == 2) {
        const bf16* ql = qp + QR * QLD;
        al[0] = ld32(ql);
        al[1] = ld32(ql + 8 * QLD);
        al[2] = ld32(ql + 8);
        al[3] = ld32(ql + 8 * QLD + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const bf16* kp = Ks + (j0 + 8 * nt + g) * QLD + 16 * ks + 2 * t;
        const uint32_t b0 = ld32(kp), b1 = ld32(kp + 8);
        mma16816(hh[nt], ah, b0, b1);  // k_hi q_hi
        if (PASSES == 3) {
          const bf16* kl = kp + KB * QLD;
          mma16816(hl[nt], al, b0, b1);                // k_hi q_lo
          mma16816(lh[nt], ah, ld32(kl), ld32(kl + 8));  // k_lo q_hi
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = j0 + 8 * nt + 2 * t + c, key = key0 + 8 * nt + 2 * t + c;
        const float2 b = kbias[j];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 2 * r + c;
          const float d = PASSES == 3 ? (hh[nt][e] + hl[nt][e]) + lh[nt][e] : hh[nt][e];
          s[nt][e] = d + (key > (r == 0 ? qa : qb) ? b.y : b.x);
        }
      }
  };
  const bool once = KB >= T;  // every key in one stage
  if (once) stage_keys(0);
  __syncthreads();
  // one sweep over the keys, 16 at a time, body(s, j0) on their scores
  auto sweep = [&](auto&& body) {
    for (int k0 = 0; k0 < T; k0 += KB) {
      if (!once) {
        __syncthreads();  // the previous stage is read
        stage_keys(k0);
        __syncthreads();
      }
      const int nk = min(KB, T - k0);
      for (int j0 = 0; j0 < nk; j0 += 16) {
        float s[2][4];
        scores(s, j0, k0 + j0);
        body(s, j0);
      }
    }
  };
  // each row's max and its sum of exp2(s - max), in one sweep: a lane's
  // running max over its keys, its sum rescaled whenever the max grows,
  // then the quad's four lanes (the row's other keys) joined
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  sweep([&](float (&s)[2][4], int) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float mx = fmaxf(fmaxf(s[0][2 * i], s[0][2 * i + 1]),
                             fmaxf(s[1][2 * i], s[1][2 * i + 1]));
      const float nm = fmaxf(m[i], mx);
      if (nm == -INFINITY) continue;  // every key of the lane so far past T
      const float add = (exp2f(s[0][2 * i] - nm) + exp2f(s[0][2 * i + 1] - nm)) +
                        (exp2f(s[1][2 * i] - nm) + exp2f(s[1][2 * i + 1] - nm));
      l[i] = l[i] * exp2f(m[i] - nm) + add;
      m[i] = nm;
    }
  });
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mq = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
    mq = fmaxf(mq, __shfl_xor_sync(0xffffffffu, mq, 2));  // finite: key 0 < T
    l[i] = l[i] * exp2f(m[i] - mq);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    m[i] = mq;
  }
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  for (int d0 = 0; d0 < DP; d0 += 8 * NO) {
    const int nto = min(NO, (DP - d0) / 8);  // n8 tiles of this chunk of the output
    float oh[NO][4], ol[NO][4];
#pragma unroll
    for (int nt = 0; nt < NO; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) oh[nt][e] = ol[nt][e] = 0.f;
    sweep([&](float (&s)[2][4], int j0) {
      // p = exp2(s - max) (1 / sum), one bf16 each, as the A fragment of
      // the 16 keys: the two n8 score tiles side by side
      float pr[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) pr[nt][e] = exp2f(s[nt][e] - m[e >> 1]) * inv[e >> 1];
      const uint32_t pa[4] = {pack_bf16(pr[0][0], pr[0][1]), pack_bf16(pr[0][2], pr[0][3]),
                              pack_bf16(pr[1][0], pr[1][1]), pack_bf16(pr[1][2], pr[1][3])};
#pragma unroll
      for (int nt = 0; nt < NO; nt += 2) {
        if (nt < nto) {  // nto is even: DP is a multiple of 16
          uint32_t b[4];
          v_fragments(b, Vs, QLD, j0, d0 + 8 * nt, lane);
          mma16816(oh[nt], pa, b[0], b[1]);  // p v_hi
          mma16816(oh[nt + 1], pa, b[2], b[3]);
          if (PASSES == 3) {
            v_fragments(b, Vs + KB * QLD, QLD, j0, d0 + 8 * nt, lane);
            mma16816(ol[nt], pa, b[0], b[1]);  // p v_lo
            mma16816(ol[nt + 1], pa, b[2], b[3]);
          }
        }
      }
    });
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) {
      if (nt >= nto) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? qa : qb, c = d0 + 8 * nt + 2 * t + (e & 1);
        if (row >= T || c >= dh) continue;
        const float o = PASSES == 3 ? oh[nt][e] + ol[nt][e] : oh[nt][e];
        const bf16 hi = __float2bfloat16_rn(o);
        const size_t at = (vid + row) * p.ldo + hc + c;
        p.oh[at] = hi;
        if (PASSES == 3) p.ol[at] = __float2bfloat16_rn(o - __bfloat162float(hi));
      }
    }
  }
}

template <int PASSES>
int attend(AttnMode a, int B, int H, cudaStream_t st) {
  constexpr int PL = PASSES == 3 ? 2 : 1;
  a.DP = round_up(a.dh, 16);
  // the output 32 columns at a time up to dh = 32 (half the accumulators),
  // else 64
  static bool ready4 = false, ready8 = false;
  auto kernel = a.DP <= 32 ? attn_mode_kernel<PASSES, 4> : attn_mode_kernel<PASSES, 8>;
  cudaError_t e = allow_smem(kernel, ATTN_SMEM, a.DP <= 32 ? ready4 : ready8);
  if (e != cudaSuccess) return (int)e;
  // four warps a block, with as many keys a stage as fit (every key where
  // they do); fewer warps only for the widest heads
  const int Tk = round_up(a.T, 16);
  int W = 4, KB = Tk;
  for (W = 4; W >= 1; W /= 2) {
    for (KB = Tk; KB > 16 && attn_smem(PL, W, a.DP, KB) > ATTN_SMEM; KB -= 16) {
    }
    if (attn_smem(PL, W, a.DP, KB) <= ATTN_SMEM) break;
  }
  if (W < 1) return (int)cudaErrorInvalidValue;
  a.KB = KB;
  const dim3 grid((a.T + 16 * W - 1) / (16 * W), H, B);
  kernel<<<grid, 32 * W, attn_smem(PL, W, a.DP, KB), st>>>(a);
  return (int)cudaGetLastError();
}

// One projection on tc_gemm_kernel: A (M, K) planes (row stride K) times
// W (K, N) planes (row stride ldw), the epilogue EPI (EPI_PLANES: + bias,
// split to p.oh / p.ol; EPI_RES: p.out = p.add + (product + bias)).
template <int PASSES, int EPI>
int project(const bf16* ah, const bf16* al, int M, int K, const bf16* wh, const bf16* wl,
            int N, int ldw, GemmArgs p, cudaStream_t st) {
  using G = TcGemm<PASSES>;
  static bool ready = false;
  cudaError_t e = allow_smem(tc_gemm_kernel<PASSES, 0, EPI>, G::SMEM, ready);
  if (e != cudaSuccess) return (int)e;
  GemmMaps mp;
  int rc;
  if ((rc = plane_map(&mp.a[0], ah, M, K, 128)) ||
      (rc = plane_map(&mp.a[1], PASSES == 3 ? al : nullptr, M, K, 128)) ||
      (rc = plane_map(&mp.b[0], wh, K, N, 64, ldw)) ||
      (rc = plane_map(&mp.b[1], PASSES == 3 ? wl : nullptr, K, N, 64, ldw)))
    return rc;
  p.M = M;
  p.N = N;
  p.K = K;
  p.krows = round_up(K, 64);
  p.split = 0;
  const dim3 grid((N + 127) / 128, (M + 127) / 128, 1);
  tc_gemm_kernel<PASSES, 0, EPI><<<grid, WG_THREADS, G::SMEM, st>>>(mp, p);
  return (int)cudaGetLastError();
}

struct AttnW {          // one attention sublayer's weights in a mode
  const bf16 *wh, *wl;  // [Wq s | Wk | Wv] (D, 3D) planes, s = log2(e) / sqrt(dh)
  const float* b;       // [bq s | bk | bv] (3D)
  const bf16 *oh, *ol;  // Wo (D, D) planes
  const float* bo;      // (D)
};

struct FfW {  // the FF tail: W1^T (FF, D) and W2^T (D, FF) planes, LN_in before it
  const bf16 *w1h, *w1l, *w2h, *w2l;
  const float *b1, *b2, *g_in, *be_in, *g_out, *be_out;
  int FF, parts;
  float* partial;  // parts > 1: parts x M x D floats
};

struct Masks {
  const float *mask, *valid;
  int repeat_inc, add_keypad;
};

// A plane pair: hi, and lo at `elems` on (null with one pass).
struct Planes {
  bf16 *hi, *lo;
};

template <int PASSES>
Planes carve(bf16*& at, size_t elems) {
  Planes q{at, PASSES == 3 ? at + elems : nullptr};
  at += (PASSES == 3 ? 2 : 1) * elems;
  return q;
}

GemmArgs planes_out(Planes o, const float* bias) {
  GemmArgs g{};
  g.oh = o.hi;
  g.ol = o.lo;
  g.bias = bias;
  return g;
}

GemmArgs res_out(float* out, int ldo, const float* add, const float* bias) {
  GemmArgs g{};
  g.out = out;
  g.ldo = ldo;
  g.add = add;
  g.bias = bias;
  return g;
}

AttnMode core(Planes q, int ldq, Planes k, Planes v, int ldkv, const Masks& m, Planes o, int D,
              int T, int dh) {
  AttnMode a{};
  a.qh = q.hi;
  a.ql = q.lo;
  a.kh = k.hi;
  a.kl = k.lo;
  a.vh = v.hi;
  a.vl = v.lo;
  a.ldq = ldq;
  a.ldkv = ldkv;
  a.mask = m.mask;
  a.valid = m.valid;
  a.repeat_inc = m.repeat_inc;
  a.add_keypad = m.add_keypad;
  a.oh = o.hi;
  a.ol = o.lo;
  a.ldo = D;
  a.T = T;
  a.dh = dh;
  return a;
}

Planes offset(Planes p, int cols) {
  return Planes{p.hi + cols, p.lo == nullptr ? nullptr : p.lo + cols};
}

#define KIT_CHECK(x) \
  if ((rc = (x)) != 0) return rc

// The FF tail (ffn_tc_kernel): y = LN_out(x1 + FF(x1)), x1 = LN_in(r).
template <int TN, int PASSES>
int ff_tail(const float* r, int M, int n, const FfW& f, float* y, cudaStream_t st) {
  const FfArgs p{r,      M,       n,       f.FF,     f.parts, nullptr, f.b1,    nullptr, f.b2,
                 f.g_in, f.be_in, f.g_out, f.be_out, y,       nullptr, nullptr, f.partial};
  return launch_tc<TN, PASSES>(p, f.w1h, f.w1l, f.w2h, f.w2l, st);
}

// The encoder layer (see the note at the top).  planes: 5 M D bf16 a plane
// (x, q / k / v, the attention output); fs: M D floats (r).
template <int TN, int PASSES>
int enc_layer(const float* x, int B, int T, int n, int H, const AttnW& at, const FfW& ff,
              const Masks& mk, float* y, bf16* planes, float* fs, cudaStream_t st) {
  constexpr int D = 32 * TN;
  const int M = B * T;
  const size_t MD = (size_t)M * D;
  bf16* cur = planes;
  const Planes xp = carve<PASSES>(cur, MD), qkv = carve<PASSES>(cur, 3 * MD),
               ap = carve<PASSES>(cur, MD);
  int rc;
  KIT_CHECK(split_planes(x, MD, xp.hi, xp.lo, st));
  KIT_CHECK((project<PASSES, EPI_PLANES>(xp.hi, xp.lo, M, D, at.wh, at.wl, 3 * D, 3 * D,
                                         planes_out(qkv, at.b), st)));
  if (n < D)  // the columns past the heads, which the padded Wo reads as 0 * a
    KIT_CHECK((int)cudaMemsetAsync(ap.hi, 0, (PASSES == 3 ? 2 : 1) * MD * sizeof(bf16), st));
  KIT_CHECK(attend<PASSES>(core(qkv, 3 * D, offset(qkv, D), offset(qkv, 2 * D), 3 * D, mk, ap, D,
                                T, n / H),
                           B, H, st));
  KIT_CHECK((project<PASSES, EPI_RES>(ap.hi, ap.lo, M, D, at.oh, at.ol, D, D,
                                      res_out(fs, D, x, at.bo), st)));
  return ff_tail<TN, PASSES>(fs, M, n, ff, y, st);
}

// The decoder layer.  planes: 10 M D bf16 a plane (x, the memory, the self
// q / k / v, the cross k / v, the attention output, x1, the cross q); fs:
// 3 M D floats (x + SA(x), x1 and, with the FF tail, r).  ff.w1h null: no
// FF tail, y = r.
template <int TN, int PASSES>
int dec_layer(const float* x, const float* mem, int B, int T, int n, int H, const AttnW& sa,
              const AttnW& ca, const float* g1, const float* be1, const FfW& ff,
              const Masks& sm, const Masks& cm, float* y, bf16* planes, float* fs,
              cudaStream_t st) {
  constexpr int D = 32 * TN;
  const int M = B * T, dh = n / H;
  const size_t MD = (size_t)M * D;
  bf16* cur = planes;
  const Planes xp = carve<PASSES>(cur, MD), mp = carve<PASSES>(cur, MD),
               sqkv = carve<PASSES>(cur, 3 * MD), ckv = carve<PASSES>(cur, 2 * MD),
               ap = carve<PASSES>(cur, MD), x1p = carve<PASSES>(cur, MD),
               q2 = carve<PASSES>(cur, MD);
  float *r1 = fs, *x1 = fs + MD, *r = ff.w1h == nullptr ? y : fs + 2 * MD;
  int rc;
  KIT_CHECK(split_planes(x, MD, xp.hi, xp.lo, st));
  KIT_CHECK(split_planes(mem, MD, mp.hi, mp.lo, st));
  KIT_CHECK((project<PASSES, EPI_PLANES>(xp.hi, xp.lo, M, D, sa.wh, sa.wl, 3 * D, 3 * D,
                                         planes_out(sqkv, sa.b), st)));
  KIT_CHECK((project<PASSES, EPI_PLANES>(mp.hi, mp.lo, M, D, ca.wh + D,
                                         ca.wl == nullptr ? nullptr : ca.wl + D, 2 * D, 3 * D,
                                         planes_out(ckv, ca.b + D), st)));
  if (n < D)
    KIT_CHECK((int)cudaMemsetAsync(ap.hi, 0, (PASSES == 3 ? 2 : 1) * MD * sizeof(bf16), st));
  KIT_CHECK(attend<PASSES>(
      core(sqkv, 3 * D, offset(sqkv, D), offset(sqkv, 2 * D), 3 * D, sm, ap, D, T, dh), B, H,
      st));
  KIT_CHECK((project<PASSES, EPI_RES>(ap.hi, ap.lo, M, D, sa.oh, sa.ol, D, D,
                                      res_out(r1, D, x, sa.bo), st)));
  ln_fwd_kernel<TN><<<(M + BM - 1) / BM, NT, 0, st>>>(r1, g1, be1, M, n, x1, x1p.hi, x1p.lo);
  KIT_CHECK((int)cudaGetLastError());
  KIT_CHECK((project<PASSES, EPI_PLANES>(x1p.hi, x1p.lo, M, D, ca.wh, ca.wl, D, 3 * D,
                                         planes_out(q2, ca.b), st)));
  KIT_CHECK(attend<PASSES>(core(q2, D, ckv, offset(ckv, D), 2 * D, cm, ap, D, T, dh), B, H, st));
  KIT_CHECK((project<PASSES, EPI_RES>(ap.hi, ap.lo, M, D, ca.oh, ca.ol, D, D,
                                      res_out(r, D, x1, ca.bo), st)));
  if (ff.w1h == nullptr) return 0;
  return ff_tail<TN, PASSES>(r, M, n, ff, y, st);
}

#undef KIT_CHECK

// The arguments every entry checks: widths, heads, the mode's lo planes,
// the FF width and its split (as kit_ffn_tc checks them).
bool args_ok(int passes, int D, int n, int H, const AttnW& a, const FfW& f) {
  const bool lo = passes == 3;
  if (!(passes == 1 || passes == 3) || n > D || H <= 0 || n % H) return false;
  if (lo && (a.wl == nullptr || a.ol == nullptr)) return false;
  if (f.w1h == nullptr) return true;
  return f.FF > 0 && f.FF % 16 == 0 && (!lo || (f.w1l && f.w2l)) && f.parts >= 1 &&
         f.parts <= (f.FF + FC_TC - 1) / FC_TC && (f.parts == 1 || f.partial != nullptr);
}

AttnW attn_w(const void* wh, const void* wl, const void* b, const void* oh, const void* ol,
             const void* bo) {
  return AttnW{(const bf16*)wh, (const bf16*)wl, (const float*)b,
               (const bf16*)oh, (const bf16*)ol, (const float*)bo};
}

FfW ff_w(const void* w1h, const void* w1l, const void* b1, const void* w2h, const void* w2l,
         const void* b2, const void* g_in, const void* be_in, const void* g_out,
         const void* be_out, int FF, int parts, void* partial) {
  auto f = [](const void* v) { return (const float*)v; };
  return FfW{(const bf16*)w1h, (const bf16*)w1l, (const bf16*)w2h, (const bf16*)w2l,
             f(b1),            f(b2),            f(g_in),          f(be_in),
             f(g_out),         f(be_out),        FF,               parts,
             (float*)partial};
}

}  // namespace

// x (B, T, D) -> y (B, T, D): one encoder layer in mode passes (3 "high",
// 1 "default").  wh / wl: [Wq s | Wk | Wv] (D, 3D) bf16 planes with s =
// log2(e) / sqrt(n / H) folded into Wq, b = [bq s | bk | bv] (3D); oh / ol
// Wo (D, D) planes, bo; w1h / w1l = W1^T (FF, D) and w2h / w2l = W2^T (D,
// FF) planes (the lo planes null with passes 1), b1, b2, LN1 g1 / be1 and
// LN2 g2 / be2; parts the FF split of ffn_tc_kernel (1: none; else at
// most one part per 64-wide FF chunk, with parts x B T x D floats of
// partial).  mask, valid (B, T) may be null.  planes: 5 B T D bf16 a
// plane (passes 3: two planes); fs: B T D floats.  D is 128, 256, 384 or
// 512; n <= D the model's true width (the operands zero-padded; see
// common.cuh); FF a multiple of 16.
extern "C" int kit_enc_layer_tc(int passes, const void* x, int B, int T, int D, int n, int H,
                                int FF, int parts, const void* wh, const void* wl, const void* b,
                                const void* oh, const void* ol, const void* bo, const void* w1h,
                                const void* w1l, const void* b1, const void* w2h,
                                const void* w2l, const void* b2, const void* g1,
                                const void* be1, const void* g2, const void* be2,
                                const void* mask, const void* valid, int repeat_inc,
                                int add_keypad, void* y, void* planes, void* fs, void* partial,
                                void* stream) {
  const AttnW at = attn_w(wh, wl, b, oh, ol, bo);
  const FfW ff = ff_w(w1h, w1l, b1, w2h, w2l, b2, g1, be1, g2, be2, FF, parts, partial);
  if (w1h == nullptr || !args_ok(passes, D, n, H, at, ff)) return (int)cudaErrorInvalidValue;
  const Masks mk{(const float*)mask, (const float*)valid, repeat_inc, add_keypad};
  return by_width(D, [&](auto tn) {
    constexpr int TN = decltype(tn)::value;
    auto layer = passes == 3 ? enc_layer<TN, 3> : enc_layer<TN, 1>;
    return layer((const float*)x, B, T, n, H, at, ff, mk, (float*)y, (bf16*)planes, (float*)fs,
                 (cudaStream_t)stream);
  });
}

// x, mem (B, T, D) -> y (B, T, D): one decoder layer in mode passes.  s*
// the self-attention weights, c* the cross-attention ones, as
// kit_enc_layer_tc takes them (the q block of c*wh scaled too); g1 / be1
// LN1; w1h null means no FF tail (y = x1 + CA(x1, mem)), else the FF
// weights as kit_enc_layer_tc's with LN2 g2 / be2 and LN3 g3 / be3.
// smask / svalid and cmask / cvalid (B, T) build the self and cross bias
// and may be null.  planes: 10 B T D bf16 a plane; fs: 3 B T D floats;
// partial as kit_enc_layer_tc's.
extern "C" int kit_dec_layer_tc(int passes, const void* x, const void* mem, int B, int T, int D,
                                int n, int H, int FF, int parts, const void* swh,
                                const void* swl, const void* sb, const void* soh,
                                const void* sol, const void* sbo, const void* cwh,
                                const void* cwl, const void* cb, const void* coh,
                                const void* col, const void* cbo, const void* g1,
                                const void* be1, const void* w1h, const void* w1l,
                                const void* b1, const void* w2h, const void* w2l,
                                const void* b2, const void* g2, const void* be2,
                                const void* g3, const void* be3, const void* smask,
                                const void* svalid, int srepeat_inc, int sadd_keypad,
                                const void* cmask, const void* cvalid, int crepeat_inc,
                                int cadd_keypad, void* y, void* planes, void* fs,
                                void* partial, void* stream) {
  const AttnW sa = attn_w(swh, swl, sb, soh, sol, sbo), ca = attn_w(cwh, cwl, cb, coh, col, cbo);
  const FfW ff = ff_w(w1h, w1l, b1, w2h, w2l, b2, g2, be2, g3, be3, FF, parts, partial);
  if (!args_ok(passes, D, n, H, sa, ff) || !args_ok(passes, D, n, H, ca, ff) ||
      (w1h == nullptr && parts != 1))
    return (int)cudaErrorInvalidValue;
  const Masks sm{(const float*)smask, (const float*)svalid, srepeat_inc, sadd_keypad};
  const Masks cm{(const float*)cmask, (const float*)cvalid, crepeat_inc, cadd_keypad};
  return by_width(D, [&](auto tn) {
    constexpr int TN = decltype(tn)::value;
    auto layer = passes == 3 ? dec_layer<TN, 3> : dec_layer<TN, 1>;
    return layer((const float*)x, (const float*)mem, B, T, n, H, sa, ca, (const float*)g1,
                 (const float*)be1, ff, sm, cm, (float*)y, (bf16*)planes, (float*)fs,
                 (cudaStream_t)stream);
  });
}
