// Conv-block epilogue y = avgpool_{k,s}(relu6(x)) * w + b over NHWC, with
// the BN folded into (w, b) by ops/blocks.py:bn_fold. Any (k, s): stride 2
// (B3, B5) and k=1, s=1 (B4, relu6 + BN only) included.
//
// Replaces roomnet_tpu/ops/pallas/pool.py:fused_relu6_pool_bn, which was
// stride-1 only (a Mosaic limit) and multiplied by 1/k². What bounds it on
// an H100: bytes. It does ~k² adds per output and must read the input and
// write the output once.
//
// Design: a tiled stencil that reads each input element once. A block owns
// one image, a strip of 8/s output rows and a span of output columns; the
// grid is (column span, strip, image), so no thread divides a 64-bit index.
// The block fetches the strip's input rows at once with 16-byte cp.async (8
// bf16 or 4 f32 channels) into shared memory, up to SMEM_BUDGET, so four
// blocks share an SM and one computes while the others load. A thread owns
// one output column and one channel vector. Walking down the strip, it sums
// the k inputs of its window along W (relu6 and the f32 conversion applied
// as it reads them, relu6 on bf16 pairs) into a register ring of the last
// KMAX row sums; an output row sums the ring's last k entries, so the
// window is summed separably, along W and then along H, in row order. The
// sum is divided by k*k (parity mode's sum-then-divide,
// ops/blocks.py:avg_pool_valid; a multiply by 1/(k*k) where that is a power
// of two, which rounds the same), the affine applied without a fused
// multiply-add as the plain version rounds it, and the result written as
// one 16-byte vector. Offsets inside an image are 32-bit; each image's base
// is one 64-bit multiply. Windows up to KMAX = 4 wide.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int MAX_THREADS = 256;
constexpr int KMAX = 4;                 // the widest window the kernel takes
constexpr size_t SMEM_BUDGET = 56 << 10;  // a strip's input: four blocks share an SM

template <typename T, int VEC>
__device__ __forceinline__ void load_relu6(const T* p, float (&f)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16 && sizeof(T) == 2) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
    const __nv_bfloat162 zero = __float2bfloat162_rn(0.f), six = __float2bfloat162_rn(6.f);
#pragma unroll
    for (int e = 0; e < VEC / 2; ++e) {  // relu6 in bf16 pairs is exact: a clamp rounds nothing
      // The _nan forms keep NaN, as rn::relu6 does.
      const float2 v = __bfloat1622float2(__hmin2_nan(__hmax2_nan(h[e], zero), six));
      f[2 * e] = v.x, f[2 * e + 1] = v.y;
    }
  } else if constexpr (VEC * sizeof(T) == 16) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = rn::relu6(v.x), f[1] = rn::relu6(v.y), f[2] = rn::relu6(v.z), f[3] = rn::relu6(v.w);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) f[e] = rn::relu6(rn::to_f32(p[e]));
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const float (&f)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16 && sizeof(T) == 2) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < VEC / 2; ++e) h[e] = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  } else if constexpr (VEC * sizeof(T) == 16) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) p[e] = rn::from_f32<T>(f[e]);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(MAX_THREADS)
relu6_pool_bn_kernel(const T* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ b, T* __restrict__ y, int H, int W, int C, int Ho,
                     int Wo, int k, int s, int span, int strip) {
  extern __shared__ __align__(16) unsigned char sraw[];
  T* tile = reinterpret_cast<T*>(sraw);  // [input row][column][C]
  const int nv = C / VEC;
  const int tid = threadIdx.x;
  const int v = tid % nv, oc = tid / nv;
  const int n = blockIdx.z, oh0 = blockIdx.y * strip, ow0 = blockIdx.x * span;
  const int rows_out = min(strip, Ho - oh0);
  const int rows_in = (rows_out - 1) * s + k;
  const int col0 = ow0 * s;
  const int units = min((span - 1) * s + k, W - col0) * nv;  // vectors of one row segment
  const int rstride = ((span - 1) * s + k) * C;               // elements of one tile row
  const T* xs = x + (size_t)n * H * W * C + (oh0 * s * W + col0) * C;

  // The strip's whole input, in flight at once.
  for (int r = 0; r < rows_in; ++r) {
    const T* src = xs + r * W * C;
    T* dst = tile + r * rstride;
    for (int i = tid; i < units; i += blockDim.x) {
      if constexpr (VEC * sizeof(T) == 16) rn::cp_async16(dst + i * VEC, src + i * VEC, true);
      else dst[i] = src[i];
    }
  }
  rn::cp_async_commit();
  rn::cp_async_wait<0>();
  __syncthreads();
  if (oc >= span || ow0 + oc >= Wo) return;

  // Row sums along W enter a ring of the last KMAX rows; each output row
  // sums the ring's last k entries in row order, as the window's rows.
  const int c0 = v * VEC;
  const int kk = k * k;
  const bool pow2 = (kk & (kk - 1)) == 0;  // then * (1/kk) is exactly / kk
  const float denom = (float)kk, inv = 1.f / denom;
  float wv[VEC], bv[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) wv[e] = w[c0 + e], bv[e] = b[c0 + e];
  T* yp = y + (size_t)n * Ho * Wo * C + ((oh0 * Wo) + ow0 + oc) * C + c0;
  float ring[KMAX][VEC] = {};
  int due = k - 1;  // the input row that completes the next output row
  for (int r = 0, j = 0; r < rows_in; ++r) {
    const T* row = tile + r * rstride + oc * s * C + c0;
    float hs[VEC];
    load_relu6<T, VEC>(row, hs);
    for (int dx = 1; dx < k; ++dx) {
      float f[VEC];
      load_relu6<T, VEC>(row + dx * C, f);
#pragma unroll
      for (int e = 0; e < VEC; ++e) hs[e] += f[e];
    }
#pragma unroll
    for (int i = 0; i < KMAX - 1; ++i)
#pragma unroll
      for (int e = 0; e < VEC; ++e) ring[i][e] = ring[i + 1][e];
#pragma unroll
    for (int e = 0; e < VEC; ++e) ring[KMAX - 1][e] = hs[e];
    if (r == due) {
      float o[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < KMAX; ++i)
          if (i >= KMAX - k) sum += ring[i][e];
        o[e] = rn::affine(pow2 ? sum * inv : sum / denom, wv[e], bv[e]);
      }
      store<T, VEC>(yp + j * Wo * C, o);
      due += s;
      ++j;
    }
  }
}

template <typename T, int VEC>
int launch(const void* x, const void* w, const void* b, void* y, int B, int H, int W, int C,
           int k, int s, cudaStream_t stream) {
  const int Ho = (H - k) / s + 1, Wo = (W - k) / s + 1;
  const int nv = C / VEC;
  if (k > KMAX || nv > MAX_THREADS) return cudaErrorInvalidConfiguration;
  // A strip of 8/s output rows; as many columns as 256 threads cover, fewer
  // where the strip's input would pass SMEM_BUDGET.
  int strip = 8 / s > 1 ? 8 / s : 1;
  if (strip > Ho) strip = Ho;
  const size_t col_bytes = (size_t)((strip - 1) * s + k) * C * sizeof(T);
  int span = MAX_THREADS / nv;
  const int fit = (int)(SMEM_BUDGET / col_bytes);  // input columns the budget holds
  if ((span - 1) * s + k > fit) span = fit > k ? (fit - k) / s + 1 : 1;
  if (span > Wo) span = Wo;
  const size_t smem = col_bytes * ((span - 1) * s + k);
  auto* kern = relu6_pool_bn_kernel<T, VEC>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Wo + span - 1) / span, (Ho + strip - 1) / strip, B);
  kern<<<grid, nv * span, smem, stream>>>(static_cast<const T*>(x), static_cast<const float*>(w),
                                          static_cast<const float*>(b), static_cast<T*>(y), H, W,
                                          C, Ho, Wo, k, s, span, strip);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* w, const void* b, void* y, int B, int H, int W, int C,
             int k, int s, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (C % V == 0 && aligned) return launch<T, V>(x, w, b, y, B, H, W, C, k, s, stream);
  return launch<T, 1>(x, w, b, y, B, H, W, C, k, s, stream);
}

}  // namespace

// x (B,H,W,C) in the io dtype; w, b (C,) f32; y (B,Ho,Wo,C) in the io dtype.
extern "C" int rn_relu6_pool_bn(const void* x, const void* w, const void* b, void* y, int B, int H,
                                int W, int C, int k, int s, int dtype, int device, void* stream) {
  rn::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rn::kBF16) return dispatch<__nv_bfloat16>(x, w, b, y, B, H, W, C, k, s, st);
  return dispatch<float>(x, w, b, y, B, H, W, C, k, s, st);
}
