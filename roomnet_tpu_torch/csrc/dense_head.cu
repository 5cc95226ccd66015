// The whole dense head in one launch: for each hidden layer
// h = relu6(h @ K) * w + b (BN folded with the caller's eps), then
// logits = relu6(h @ K + bias) and probs = softmax(logits), all in f32
// whatever the io dtype of the flattened input. Writes logits and probs.
//
// Replaces roomnet_tpu/ops/pallas/dense_head.py:dense_head_pallas (fixed at
// four layers). This one takes any flat_len, widths and number of layers.
// What bounds it on an H100: neither bytes nor FLOPs — at 64->32->16->8->6 it
// is ~6 kFLOP per image, so a launch costs more than its bytes or FLOPs, and
// what remains is the latency of one block's weight load and of its chain
// of dependent layers.
//
// Two variants of the kernel, chosen by the wrapper from the packed size
// (ops/kernels/dense_head.py:plan):
//
// - resident: the packed weights fit in shared memory (11.4 KB at 224). A
//   block of WARPS warps loads all of them once with 16-byte cp.async (all
//   in flight at once, with each warp's first input row) and passes one
//   __syncthreads; after that there is no block-level barrier. A
//   warp owns one batch row at a time, its activations in its own slice of
//   shared memory; its lanes own a layer's output units, each summing its
//   dot product in input order with fmaf, and the softmax is a max and a
//   sum by warp shuffles. Batch 256 runs on 64 blocks, batch 1 on one warp.
// - streamed: for heads whose weights do not fit (roomnet-600's 3136x32
//   first layer, ~400 KB). A block owns RB batch rows and 256 threads; the
//   rows' activations live in shared memory, each layer's weights are staged
//   through a shared-memory buffer in chunks of input rows, and each thread
//   owns fixed (row, unit) outputs whose f32 sums carry across the chunks.
#include <algorithm>
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;                   // streamed
constexpr int WARPS = 4;                       // resident
constexpr int MAX_LAYERS = 8;
constexpr size_t RESIDENT_SMEM = 48 << 10;     // the wrapper keeps the resident variant within it
constexpr int RESIDENT_MAX_BLOCKS = 132 * 8;   // warps walk further rows beyond this grid

struct HeadDims {
  int n;                         // number of dense layers
  int width[MAX_LAYERS + 1];     // width[0] = flat_len, width[n] = classes
};

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
dense_head_resident(const T* __restrict__ x, const float* __restrict__ params,
                    float* __restrict__ logits, float* __restrict__ probs, int B, int n_params,
                    int maxw, HeadDims d) {
  extern __shared__ __align__(16) float smem[];
  float* sp = smem;  // all the packed params
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* sa = smem + ((n_params + 3) & ~3) + warp * 2 * maxw;  // this warp's layer input
  float* sb = sa + maxw;                                        // and output

  // All the weights in flight at once (16-byte cp.async where aligned) and,
  // meanwhile, this warp's first row.
  const int n4 = reinterpret_cast<uintptr_t>(params) % 16 == 0 ? n_params / 4 : 0;
  for (int i = threadIdx.x; i < n4; i += blockDim.x)
    rn::cp_async16(sp + 4 * i, params + 4 * i, true);
  rn::cp_async_commit();
  for (int i = 4 * n4 + threadIdx.x; i < n_params; i += blockDim.x) sp[i] = __ldg(params + i);
  const int F = d.width[0], NC = d.width[d.n];
  const int stride = gridDim.x * WARPS;
  int r = blockIdx.x * WARPS + warp;
  for (int f = lane; r < B && f < F; f += 32) sa[f] = rn::to_f32(x[(size_t)r * F + f]);
  rn::cp_async_wait<0>();
  __syncthreads();

  for (; r < B; r += stride) {
    float* a = sa;
    float* b = sb;
    const float* p = sp;
    for (int l = 0; l < d.n; ++l) {
      const int IN = d.width[l], OUT = d.width[l + 1];
      const float* k = p;
      const float* e = p + IN * OUT;  // (w, b) of a hidden layer, the bias of the last
      const bool hidden = l < d.n - 1;
      for (int u = lane; u < OUT; u += 32) {
        float acc = 0.f;
#pragma unroll 8
        for (int f = 0; f < IN; ++f) acc = fmaf(a[f], k[f * OUT + u], acc);
        b[u] = hidden ? rn::affine(rn::relu6(acc), e[u], e[OUT + u])
                      : rn::relu6(__fadd_rn(acc, e[u]));
      }
      p = e + (hidden ? 2 : 1) * OUT;
      __syncwarp();
      float* tmp = a;
      a = b;
      b = tmp;
    }

    float m = -INFINITY;
    for (int u = lane; u < NC; u += 32) m = fmaxf(m, a[u]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
    for (int u = lane; u < NC; u += 32) sum += expf(a[u] - m);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const size_t out = (size_t)r * NC;
    for (int u = lane; u < NC; u += 32) {
      logits[out + u] = a[u];
      probs[out + u] = expf(a[u] - m) / sum;
    }
    __syncwarp();  // the next row overwrites this warp's activations
    for (int f = lane; r + stride < B && f < F; f += 32)
      sa[f] = rn::to_f32(x[(size_t)(r + stride) * F + f]);
    __syncwarp();
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dense_head_streamed(const T* __restrict__ x, const float* __restrict__ params,
                    float* __restrict__ logits, float* __restrict__ probs, int B, int RB,
                    int maxw, int kchunk, HeadDims d) {
  extern __shared__ float smem[];
  float* sa = smem;              // RB x maxw, layer input
  float* sb = sa + RB * maxw;    // RB x maxw, layer output
  float* sk = sb + RB * maxw;    // kchunk floats of weights
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * RB;
  const int rows = min(RB, B - r0);

  const int F = d.width[0];
  for (int i = tid; i < rows * F; i += THREADS)
    sa[(i / F) * maxw + i % F] = rn::to_f32(x[(size_t)r0 * F + i]);

  const float* p = params;
  for (int l = 0; l < d.n; ++l) {
    const int IN = d.width[l], OUT = d.width[l + 1];
    const float* k = p;
    p += (size_t)IN * OUT;
    for (int o = tid; o < rows * OUT; o += THREADS) sb[(o / OUT) * maxw + o % OUT] = 0.f;
    const int fc = max(1, kchunk / OUT);
    for (int f0 = 0; f0 < IN; f0 += fc) {
      const int nf = min(fc, IN - f0);
      __syncthreads();  // sa is written and the previous chunk consumed
      for (int i = tid; i < nf * OUT; i += THREADS) sk[i] = k[(size_t)f0 * OUT + i];
      __syncthreads();
      for (int o = tid; o < rows * OUT; o += THREADS) {
        const int r = o / OUT, u = o % OUT;
        float acc = sb[r * maxw + u];
        for (int f = 0; f < nf; ++f) acc = fmaf(sa[r * maxw + f0 + f], sk[f * OUT + u], acc);
        sb[r * maxw + u] = acc;
      }
    }
    if (l < d.n - 1) {
      const float* w = p;
      const float* b = p + OUT;
      p += 2 * OUT;
      for (int o = tid; o < rows * OUT; o += THREADS) {
        const int u = o % OUT;
        float* v = &sb[(o / OUT) * maxw + u];
        *v = rn::affine(rn::relu6(*v), w[u], b[u]);
      }
    } else {
      const float* bias = p;
      for (int o = tid; o < rows * OUT; o += THREADS) {
        const int u = o % OUT;
        float* v = &sb[(o / OUT) * maxw + u];
        *v = rn::relu6(__fadd_rn(*v, bias[u]));
      }
    }
    __syncthreads();
    float* tmp = sa;
    sa = sb;
    sb = tmp;
  }

  const int NC = d.width[d.n];
  for (int r = tid; r < rows; r += THREADS) {
    const float* l = &sa[r * maxw];
    float m = l[0];
    for (int u = 1; u < NC; ++u) m = fmaxf(m, l[u]);
    float sum = 0.f;
    for (int u = 0; u < NC; ++u) sum += expf(l[u] - m);
    const size_t o = (size_t)(r0 + r) * NC;
    for (int u = 0; u < NC; ++u) {
      logits[o + u] = l[u];
      probs[o + u] = expf(l[u] - m) / sum;
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* params, void* logits, void* probs, int B,
                   int n_params, bool resident, int RB, int maxw, int kchunk, const HeadDims& d,
                   cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const float* pt = static_cast<const float*>(params);
  float* lt = static_cast<float*>(logits);
  float* qt = static_cast<float*>(probs);
  if (resident) {
    const size_t smem = ((size_t)((n_params + 3) & ~3) + (size_t)WARPS * 2 * maxw) * sizeof(float);
    if (smem > RESIDENT_SMEM) return cudaErrorInvalidConfiguration;
    const int blocks = std::min((B + WARPS - 1) / WARPS, RESIDENT_MAX_BLOCKS);
    dense_head_resident<T><<<blocks, WARPS * 32, smem, stream>>>(xt, pt, lt, qt, B, n_params,
                                                                   maxw, d);
    return cudaSuccess;
  }
  const size_t smem = (size_t)(2 * RB * maxw + kchunk) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(dense_head_streamed<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dense_head_streamed<T><<<(B + RB - 1) / RB, THREADS, smem, stream>>>(xt, pt, lt, qt, B, RB,
                                                                        maxw, kchunk, d);
  return cudaSuccess;
}

__global__ void empty_kernel() {}

}  // namespace

// x (B, widths[0]) in the io dtype; params f32, n_params of them, per
// layer: K (in x out) row major, then (w, b) for a hidden layer or the bias
// for the last; logits and probs (B, widths[n_layers]) f32. `resident`
// selects the variant; the streamed one takes RB rows per block and stages
// kchunk floats of weights at a time. The wrapper sizes all three.
extern "C" int rn_dense_head(const void* x, const void* params, void* logits, void* probs, int B,
                             const int* widths, int n_layers, int n_params, int resident, int RB,
                             int kchunk, int dtype, int device, void* stream) {
  if (n_layers < 1 || n_layers > MAX_LAYERS) return cudaErrorInvalidValue;
  rn::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  HeadDims d;
  d.n = n_layers;
  int maxw = 1;
  for (int i = 0; i <= n_layers; ++i) {
    d.width[i] = widths[i];
    maxw = std::max(maxw, widths[i]);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == rn::kBF16
          ? launch<__nv_bfloat16>(x, params, logits, probs, B, n_params, resident != 0, RB, maxw,
                                  kchunk, d, st)
          : launch<float>(x, params, logits, probs, B, n_params, resident != 0, RB, maxw, kchunk,
                          d, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// One launch of an empty kernel: the yardstick of a launch's own cost.
extern "C" int rn_empty_launch(int device, void* stream) {
  rn::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}
