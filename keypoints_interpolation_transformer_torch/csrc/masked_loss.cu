// Frame-weighted masked euclidean loss per video.
//
// Replaces keypoints_interpolation_transformer_tpu/ops/pallas/masked_loss.py::
// _loss_kernel:
//     loss[b] = sum_t w[b, t] sum_f (p[b, t, f] - t[b, t, f])^2
//               / max(K * sum_t w[b, t], 1)
// over the F = K * 2 coordinates of each frame (K = 54 keypoints).  Its
// gradient is closed-form and stays in PyTorch, as the JAX package leaves
// it to XLA.
//
// What bounds it on an H100: bytes.  It reads pred and target once (2 B T F
// floats, 7 MB at B = 64, T = 128) for 3 FLOP per value.  Design: one block
// per video; a grid-stride loop of 16-byte loads over the video's T * F
// values (F is a multiple of 4, so the four values of a load share their
// frame and its weight), a warp-shuffle then shared-memory reduction of the
// numerator and of the weight sum, and the division on the card.  Nothing
// between the loads and the two sums reaches device memory.
#include "common.cuh"

using namespace kit;

namespace {

constexpr int LT = 256;  // threads per block

__global__ void __launch_bounds__(LT)
masked_loss_kernel(const float* __restrict__ p, const float* __restrict__ t,
                   const float* __restrict__ w, int T, int F, int K, float* __restrict__ loss) {
  __shared__ float s_num[LT / 32], s_den[LT / 32];
  const int b = blockIdx.x;
  const size_t base = (size_t)b * T * F;
  const float4* p4 = reinterpret_cast<const float4*>(p + base);
  const float4* t4 = reinterpret_cast<const float4*>(t + base);
  const float* wb = w + (size_t)b * T;
  const int n4 = T * F / 4, f4 = F / 4;
  float num = 0.f, den = 0.f;
  for (int i = threadIdx.x; i < n4; i += LT) {
    const float4 a = __ldg(p4 + i), c = __ldg(t4 + i);
    const float dx = a.x - c.x, dy = a.y - c.y, dz = a.z - c.z, dw = a.w - c.w;
    const float sq = dx * dx + dy * dy + dz * dz + dw * dw;
    num = fmaf(sq, __ldg(wb + i / f4), num);
  }
  for (int i = threadIdx.x; i < T; i += LT) den += __ldg(wb + i);
  num = warp_sum(num);
  den = warp_sum(den);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_num[warp] = num;
    s_den[warp] = den;
  }
  __syncthreads();
  if (warp == 0) {
    num = lane < LT / 32 ? s_num[lane] : 0.f;
    den = lane < LT / 32 ? s_den[lane] : 0.f;
    num = warp_sum(num);
    den = warp_sum(den);
    if (lane == 0) loss[b] = num / fmaxf(den * (float)K, 1.f);
  }
}

}  // namespace

// pred, target (B, T, F) and w (B, T) -> loss (B,); pred and target start on
// 16-byte boundaries and F is a multiple of 4.
extern "C" int kit_masked_loss(const void* pred, const void* target, const void* w, int B, int T,
                               int F, int K, void* loss, void* stream) {
  if (F % 4) return (int)cudaErrorInvalidValue;
  masked_loss_kernel<<<B, LT, 0, (cudaStream_t)stream>>>(
      (const float*)pred, (const float*)target, (const float*)w, T, F, K, (float*)loss);
  return (int)cudaGetLastError();
}
