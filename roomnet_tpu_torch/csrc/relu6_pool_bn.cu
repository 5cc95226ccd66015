// Conv-block epilogue y = avgpool_{k,s}(relu6(x)) * w + b over NHWC, with
// the BN folded into (w, b) by ops/blocks.py:bn_fold. Any (k, s): stride 2
// (B3, B5) and k=1, s=1 (B4, relu6 + BN only) included.
//
// Replaces roomnet_tpu/ops/pallas/pool.py:fused_relu6_pool_bn, which was
// stride-1 only (a Mosaic limit) and multiplied by 1/k². What bounds it on
// an H100: bytes. It does ~k² adds per output and must read the input and
// write the output once.
//
// Design: one thread per output element, channel fastest, so a warp reads
// and writes neighbouring channels of one pixel (coalesced). The k x k
// window is re-read from L1/L2 by neighbouring outputs instead of device
// memory. The window is summed in f32 in row-major order, then DIVIDED by
// k*k (parity mode's sum-then-divide, ops/blocks.py:avg_pool_valid), then
// the affine is applied without a fused multiply-add, as the plain version
// rounds it.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
relu6_pool_bn_kernel(const T* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ b, T* __restrict__ y, int H, int W, int C,
                     int Ho, int Wo, int k, int s, long long total) {
  const float denom = (float)(k * k);
  for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x; i < total;
       i += (long long)gridDim.x * THREADS) {
    const int c = (int)(i % C);
    long long p = i / C;
    const int ow = (int)(p % Wo);
    p /= Wo;
    const int oh = (int)(p % Ho);
    const long long n = p / Ho;
    const T* xp = x + ((n * H + (long long)oh * s) * W + (long long)ow * s) * C + c;
    float sum = 0.f;
    for (int dy = 0; dy < k; ++dy)
      for (int dx = 0; dx < k; ++dx) sum += rn::relu6(rn::to_f32(xp[((size_t)dy * W + dx) * C]));
    y[i] = rn::from_f32<T>(rn::affine(sum / denom, w[c], b[c]));
  }
}

template <typename T>
void launch(const void* x, const void* w, const void* b, void* y, int B, int H, int W, int C,
            int k, int s, cudaStream_t stream) {
  const int Ho = (H - k) / s + 1, Wo = (W - k) / s + 1;
  const long long total = (long long)B * Ho * Wo * C;
  relu6_pool_bn_kernel<T><<<rn::grid_for(total, THREADS), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<T*>(y), H, W, C, Ho, Wo, k, s, total);
}

}  // namespace

// x (B,H,W,C) in the io dtype; w, b (C,) f32; y (B,Ho,Wo,C) in the io dtype.
extern "C" int rn_relu6_pool_bn(const void* x, const void* w, const void* b, void* y, int B, int H,
                                int W, int C, int k, int s, int dtype, int device, void* stream) {
  rn::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rn::kBF16) launch<__nv_bfloat16>(x, w, b, y, B, H, W, C, k, s, st);
  else launch<float>(x, w, b, y, B, H, W, C, k, s, st);
  return cudaGetLastError();
}
