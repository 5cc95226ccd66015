// Residual group out = s * (x + Wh^T . res . Ww) + t over NHWC, with the
// TF1-legacy bilinear interpolation (reference network.py:199) and the BN
// folded into (s, t).
//
// Replaces roomnet_tpu/ops/pallas/residual.py:residual_bn_pallas, which ran
// the resize as two dense MXU matmuls per (image, channel) on channel-major
// blocks and paid three NHWC<->NCHW transposes for a TPU layout reason. What
// bounds it on an H100: bytes (read the res rows and columns the resize
// reaches, read x, write out, once each); the arithmetic is a few FLOPs per
// output.
//
// Design: a strip stencil that reads each res element about once. Each
// column of a TF1 interpolation matrix has at most two nonzeros, so the
// wrapper hands the kernel, per output row and per output column, two
// (source index, weight) pairs (ops/kernels/residual.py:source_pairs; a
// single-source column has weight 0 on its second pair), and a plan: per
// strip of output rows the range of res rows it reaches, per span of output
// columns the range of res columns. A block owns one image, one strip and
// one span; the grid is (span, strip, image), so no thread divides a 64-bit
// index: offsets inside an image are 32-bit and each image's base is one
// 64-bit multiply. The block fetches its res rows and columns at once with
// 16-byte cp.async (8 bf16 or 4 f32 channels) into shared memory, at most
// 48 KB, so four blocks share an SM; while they are in flight each thread
// loads its strip's x vectors into registers. A thread owns one output
// column and one channel vector; its (source, weight) column pairs and its
// s, t stay in registers as it walks down the strip. Per output row it
// interpolates along H at its two source columns, rounds both intermediates
// to the io dtype (as the einsum pair rounds its intermediate), interpolates
// along W, adds x and applies s*(.)+t without a fused multiply-add, as
// ops/kernels/residual.py:residual_bn_plain rounds them, and stores one
// 16-byte vector. Channel counts that are not a multiple of the vector, or
// unaligned tensors, take VEC = 1 in the same kernel.
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int MAX_THREADS = 256;
constexpr int MAX_STRIP = 8;            // output rows per block, held in registers
constexpr size_t SMEM_LIMIT = 48 << 10;  // the planner keeps a block's res tile within it

// VEC channels of T moved as one load or store: 16 bytes, or one element.
template <typename T, int VEC>
using Raw = std::conditional_t<VEC * sizeof(T) == 16, uint4, T>;

template <typename T, int VEC>
__device__ __forceinline__ void unpack(const Raw<T, VEC>& r, float (&f)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16 && sizeof(T) == 2) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int e = 0; e < VEC / 2; ++e) {
      const float2 v = __bfloat1622float2(h[e]);
      f[2 * e] = v.x, f[2 * e + 1] = v.y;
    }
  } else if constexpr (VEC * sizeof(T) == 16) {
    const float4 v = *reinterpret_cast<const float4*>(&r);
    f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
  } else {
    f[0] = rn::to_f32(r);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ Raw<T, VEC> pack(const float (&f)[VEC]) {
  Raw<T, VEC> r;
  if constexpr (VEC * sizeof(T) == 16 && sizeof(T) == 2) {
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int e = 0; e < VEC / 2; ++e) h[e] = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
  } else if constexpr (VEC * sizeof(T) == 16) {
    *reinterpret_cast<float4*>(&r) = make_float4(f[0], f[1], f[2], f[3]);
  } else {
    r = rn::from_f32<T>(f[0]);
  }
  return r;
}

// The H pass at one source column: a0 * r0 + a1 * r1 in f32, rounded to the
// io dtype.
template <typename T, int VEC>
__device__ __forceinline__ void hpass(const T* r0, const T* r1, float a0, float a1,
                                      float (&v)[VEC]) {
  float f0[VEC], f1[VEC];
  unpack<T, VEC>(*reinterpret_cast<const Raw<T, VEC>*>(r0), f0);
  unpack<T, VEC>(*reinterpret_cast<const Raw<T, VEC>*>(r1), f1);
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    v[e] = rn::round_io<T>(__fadd_rn(__fmul_rn(a0, f0[e]), __fmul_rn(a1, f1[e])));
}

template <typename T, int VEC>
__global__ void __launch_bounds__(MAX_THREADS)
residual_bn_kernel(const T* __restrict__ x, const T* __restrict__ res,
                   const int* __restrict__ hidx, const float* __restrict__ hwt,
                   const int* __restrict__ widx, const float* __restrict__ wwt,
                   const int* __restrict__ strips, const int* __restrict__ spans,
                   const float* __restrict__ s, const float* __restrict__ t, T* __restrict__ y,
                   int Hi, int Wi, int Ho, int Wo, int C, int strip, int span, int cols_in) {
  using R = Raw<T, VEC>;
  extern __shared__ __align__(16) unsigned char sraw[];
  T* tile = reinterpret_cast<T*>(sraw);  // [res row][res column][C]
  const int nv = C / VEC;
  const int tid = threadIdx.x;
  const int v = tid % nv, oc = tid / nv;
  const int n = blockIdx.z, oh0 = blockIdx.y * strip, ow0 = blockIdx.x * span;
  const int rows_out = min(strip, Ho - oh0);
  const int row0 = __ldg(strips + 2 * blockIdx.y), rows_in = __ldg(strips + 2 * blockIdx.y + 1);
  const int col0 = __ldg(spans + 2 * blockIdx.x), units = __ldg(spans + 2 * blockIdx.x + 1) * nv;
  const int rstride = cols_in * C;  // elements of one tile row

  // The strip's res rows and the span's res columns, all in flight at once.
  const R* rs = reinterpret_cast<const R*>(res + (size_t)n * Hi * Wi * C + (row0 * Wi + col0) * C);
  R* tl = reinterpret_cast<R*>(tile);
  for (int r = 0; r < rows_in; ++r) {
    const R* src = rs + r * Wi * nv;
    R* dst = tl + r * (rstride / VEC);
    for (int i = tid; i < units; i += blockDim.x) {
      if constexpr (VEC * sizeof(T) == 16) rn::cp_async16(dst + i, src + i, true);
      else dst[i] = src[i];
    }
  }
  rn::cp_async_commit();

  // Meanwhile this thread's x vectors for the whole strip.
  const bool active = oc < span && ow0 + oc < Wo;
  const int ow = ow0 + oc;
  const size_t img = (size_t)n * Ho * Wo * C;
  const int at = (oh0 * Wo + ow) * C + v * VEC;  // the thread's first output, inside the image
  const int rowstep = Wo * C;
  R xr[MAX_STRIP];
  if (active) {
#pragma unroll
    for (int j = 0; j < MAX_STRIP; ++j)
      if (j < rows_out) xr[j] = *reinterpret_cast<const R*>(x + img + at + j * rowstep);
  }
  rn::cp_async_wait<0>();
  __syncthreads();
  if (!active) return;

  const int w0 = (__ldg(widx + 2 * ow) - col0) * C + v * VEC;
  const int w1 = (__ldg(widx + 2 * ow + 1) - col0) * C + v * VEC;
  const float b0 = __ldg(wwt + 2 * ow), b1 = __ldg(wwt + 2 * ow + 1);
  float sv[VEC], tv[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) sv[e] = __ldg(s + v * VEC + e), tv[e] = __ldg(t + v * VEC + e);
#pragma unroll
  for (int j = 0; j < MAX_STRIP; ++j) {
    if (j >= rows_out) break;
    const int oh = oh0 + j;
    const T* r0 = tile + (__ldg(hidx + 2 * oh) - row0) * rstride;
    const T* r1 = tile + (__ldg(hidx + 2 * oh + 1) - row0) * rstride;
    const float a0 = __ldg(hwt + 2 * oh), a1 = __ldg(hwt + 2 * oh + 1);
    float v0[VEC], v1[VEC], xf[VEC], o[VEC];
    hpass<T, VEC>(r0 + w0, r1 + w0, a0, a1, v0);
    hpass<T, VEC>(r0 + w1, r1 + w1, a0, a1, v1);
    unpack<T, VEC>(xr[j], xf);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float up = __fadd_rn(__fmul_rn(b0, v0[e]), __fmul_rn(b1, v1[e]));
      o[e] = rn::affine(__fadd_rn(xf[e], up), sv[e], tv[e]);
    }
    *reinterpret_cast<R*>(y + img + at + j * rowstep) = pack<T, VEC>(o);
  }
}

// The operands and the wrapper's plan of one launch.
struct Operands {
  const void *x, *res, *hidx, *hwt, *widx, *wwt, *strips, *spans, *s, *t;
  void* y;
};
struct Plan {
  int B, Hi, Wi, Ho, Wo, C, vec, strip, span, rows_in, cols_in;
};

template <typename T, int VEC>
int launch(const Operands& o, const Plan& p, cudaStream_t stream) {
  const int threads = p.C / VEC * p.span;
  const size_t smem = (size_t)p.rows_in * p.cols_in * p.C * sizeof(T);
  if (p.C % VEC || p.strip < 1 || p.strip > MAX_STRIP || p.span < 1 || threads > MAX_THREADS ||
      smem > SMEM_LIMIT)
    return cudaErrorInvalidConfiguration;
  dim3 grid((p.Wo + p.span - 1) / p.span, (p.Ho + p.strip - 1) / p.strip, p.B);
  residual_bn_kernel<T, VEC><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(o.x), static_cast<const T*>(o.res), static_cast<const int*>(o.hidx),
      static_cast<const float*>(o.hwt), static_cast<const int*>(o.widx),
      static_cast<const float*>(o.wwt), static_cast<const int*>(o.strips),
      static_cast<const int*>(o.spans), static_cast<const float*>(o.s),
      static_cast<const float*>(o.t), static_cast<T*>(o.y), p.Hi, p.Wi, p.Ho, p.Wo, p.C,
      p.strip, p.span, p.cols_in);
  return cudaGetLastError();
}

// VEC = 1, or the 16-byte vector where the plan asks for it and every
// activation is 16-byte aligned; anything else is refused.
template <typename T>
int dispatch(const Operands& o, const Plan& p, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(o.x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(o.res) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(o.y) % 16 == 0;
  if (p.vec == 1) return launch<T, 1>(o, p, stream);
  if (p.vec == V && aligned) return launch<T, V>(o, p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// x, y (B,Ho,Wo,C) and res (B,Hi,Wi,C) in the io dtype; hidx/hwt (Ho,2) and
// widx/wwt (Wo,2) int32/f32 source pairs; strips (ceil(Ho/strip),2) and
// spans (ceil(Wo/span),2) int32 (first res row or column, count); s, t (C,)
// f32. vec, strip, span, rows_in and cols_in are the wrapper's plan
// (ops/kernels/residual.py:plan): channels per thread vector (1, or 16
// bytes' worth), output rows and columns per block, and the most res rows
// and columns one strip and one span reach.
extern "C" int rn_residual_bn(const void* x, const void* res, const void* hidx, const void* hwt,
                              const void* widx, const void* wwt, const void* strips,
                              const void* spans, const void* s, const void* t, void* y, int B,
                              int Hi, int Wi, int Ho, int Wo, int C, int vec, int strip, int span,
                              int rows_in, int cols_in, int dtype, int device, void* stream) {
  rn::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  const Operands o{x, res, hidx, hwt, widx, wwt, strips, spans, s, t, y};
  const Plan p{B, Hi, Wi, Ho, Wo, C, vec, strip, span, rows_in, cols_in};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rn::kBF16) return dispatch<__nv_bfloat16>(o, p, st);
  return dispatch<float>(o, p, st);
}
