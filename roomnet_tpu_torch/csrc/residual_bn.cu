// Residual group out = s * (x + Wh^T . res . Ww) + t over NHWC, with the
// TF1-legacy bilinear interpolation (reference network.py:199) and the BN
// folded into (s, t).
//
// Replaces roomnet_tpu/ops/pallas/residual.py:residual_bn_pallas, which ran
// the resize as two dense MXU matmuls per (image, channel) on channel-major
// blocks and paid three NHWC<->NCHW transposes for a TPU layout reason. What
// bounds it on an H100: bytes (read res and x once, write out once); the
// arithmetic is a few FLOPs per output.
//
// Design: NHWC in and out, one thread per output element, channel fastest.
// Each column of a TF1 interpolation matrix has at most two nonzeros, so the
// wrapper hands the kernel, per output row and per output column, two
// (source index, weight) pairs taken from the port's own float32 matrix
// (bf16-rounded in bf16 mode); a single-source column has weight 0 on its
// second pair. The thread interpolates along H at its two source columns,
// rounds both intermediates to the io dtype (as the einsum pair rounds its
// intermediate), interpolates along W, adds x and applies s*(.)+t.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
residual_bn_kernel(const T* __restrict__ x, const T* __restrict__ res,
                   const int* __restrict__ hidx, const float* __restrict__ hwt,
                   const int* __restrict__ widx, const float* __restrict__ wwt,
                   const float* __restrict__ s, const float* __restrict__ t, T* __restrict__ y,
                   int Hi, int Wi, int Ho, int Wo, int C, long long total) {
  for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x; i < total;
       i += (long long)gridDim.x * THREADS) {
    const int c = (int)(i % C);
    long long p = i / C;
    const int ow = (int)(p % Wo);
    p /= Wo;
    const int oh = (int)(p % Ho);
    const long long n = p / Ho;
    const int h0 = hidx[2 * oh], h1 = hidx[2 * oh + 1];
    const float a0 = hwt[2 * oh], a1 = hwt[2 * oh + 1];
    const int w0 = widx[2 * ow], w1 = widx[2 * ow + 1];
    const float b0 = wwt[2 * ow], b1 = wwt[2 * ow + 1];
    const T* r = res + n * Hi * Wi * C + c;
    const float r00 = rn::to_f32(r[((size_t)h0 * Wi + w0) * C]);
    const float r10 = rn::to_f32(r[((size_t)h1 * Wi + w0) * C]);
    const float r01 = rn::to_f32(r[((size_t)h0 * Wi + w1) * C]);
    const float r11 = rn::to_f32(r[((size_t)h1 * Wi + w1) * C]);
    const float v0 = rn::round_io<T>(__fadd_rn(__fmul_rn(a0, r00), __fmul_rn(a1, r10)));
    const float v1 = rn::round_io<T>(__fadd_rn(__fmul_rn(a0, r01), __fmul_rn(a1, r11)));
    const float up = __fadd_rn(__fmul_rn(b0, v0), __fmul_rn(b1, v1));
    const float sum = __fadd_rn(rn::to_f32(x[i]), up);
    y[i] = rn::from_f32<T>(rn::affine(sum, s[c], t[c]));
  }
}

template <typename T>
void launch(const void* x, const void* res, const void* hidx, const void* hwt, const void* widx,
            const void* wwt, const void* s, const void* t, void* y, int B, int Hi, int Wi, int Ho,
            int Wo, int C, cudaStream_t stream) {
  const long long total = (long long)B * Ho * Wo * C;
  residual_bn_kernel<T><<<rn::grid_for(total, THREADS), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), static_cast<const int*>(hidx),
      static_cast<const float*>(hwt), static_cast<const int*>(widx),
      static_cast<const float*>(wwt), static_cast<const float*>(s),
      static_cast<const float*>(t), static_cast<T*>(y), Hi, Wi, Ho, Wo, C, total);
}

}  // namespace

// x, y (B,Ho,Wo,C) and res (B,Hi,Wi,C) in the io dtype; hidx/hwt (Ho,2) and
// widx/wwt (Wo,2) int32/f32 source pairs; s, t (C,) f32.
extern "C" int rn_residual_bn(const void* x, const void* res, const void* hidx, const void* hwt,
                              const void* widx, const void* wwt, const void* s, const void* t,
                              void* y, int B, int Hi, int Wi, int Ho, int Wo, int C, int dtype,
                              int device, void* stream) {
  rn::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rn::kBF16)
    launch<__nv_bfloat16>(x, res, hidx, hwt, widx, wwt, s, t, y, B, Hi, Wi, Ho, Wo, C, st);
  else
    launch<float>(x, res, hidx, hwt, widx, wwt, s, t, y, B, Hi, Wi, Ho, Wo, C, st);
  return cudaGetLastError();
}
