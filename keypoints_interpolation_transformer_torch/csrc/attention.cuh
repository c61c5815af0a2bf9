// The attention core shared by the sublayer kernels (attn_sublayer.cu) and
// the whole-layer kernels (layer_fused.cu): the additive bias built from
// the 1-D masks, and one chunk of the online softmax of one query.
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

// Fold keys key0 .. key0 + KC - 1 into one query's online softmax: s =
// q . k * scale + bias (keys >= T count as -inf), then the running max m,
// sum l and unnormalized output o are rescaled to the new max.  K and V
// point at the chunk's first key and the head's first column in shared
// memory (row stride ld; both 16-byte aligned, ld a multiple of 4); km, kv
// at the chunk's mask and valid values.  The chunk must hold a key < T or
// m must already be finite, so that no -inf - -inf arises.
template <int DH, int KC>
__device__ __forceinline__ void softmax_chunk(const float (&q)[DH], float (&o)[DH], float& m,
                                              float& l, const float* K, const float* V, int ld,
                                              const float* km, const float* kv, int qi, int key0,
                                              int T, int repeat_inc, int add_keypad,
                                              float scale) {
  static_assert(DH % 4 == 0, "head rows are read as float4");
  float s[KC];
  float cmax = -INFINITY;
#pragma unroll
  for (int jj = 0; jj < KC; ++jj) {
    const int key = key0 + jj;
    float dot = 0.f;
#pragma unroll
    for (int d = 0; d < DH; d += 4) {
      const float4 k4 = *reinterpret_cast<const float4*>(K + jj * ld + d);
      dot = fmaf(q[d], k4.x, dot);
      dot = fmaf(q[d + 1], k4.y, dot);
      dot = fmaf(q[d + 2], k4.z, dot);
      dot = fmaf(q[d + 3], k4.w, dot);
    }
    const float bias = key_bias(repeat_inc, add_keypad, qi, key, km[jj], kv[jj]);
    s[jj] = key < T ? fmaf(dot, scale, bias) : -INFINITY;
    cmax = fmaxf(cmax, s[jj]);
  }
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
    for (int d = 0; d < DH; d += 4) {
      const float4 v4 = *reinterpret_cast<const float4*>(V + jj * ld + d);
      o[d] = fmaf(p, v4.x, o[d]);
      o[d + 1] = fmaf(p, v4.y, o[d + 1]);
      o[d + 2] = fmaf(p, v4.z, o[d + 2]);
      o[d + 3] = fmaf(p, v4.w, o[d + 3]);
    }
  }
  m = mnew;
}

}  // namespace kit
