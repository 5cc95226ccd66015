// The whole dense head in one launch: for each hidden layer
// h = relu6(h @ K) * w + b (BN folded with the caller's eps), then
// logits = relu6(h @ K + bias) and probs = softmax(logits), all in f32
// whatever the io dtype of the flattened input. Writes logits and probs.
//
// Replaces roomnet_tpu/ops/pallas/dense_head.py:dense_head_pallas (fixed at
// four layers). This one takes any flat_len, widths and number of layers.
// What bounds it on an H100: neither — at 64->32->16->8->6 it is ~6 kFLOP per
// image, so a launch costs more than its bytes or FLOPs.
//
// Design: a block owns RB batch rows and 256 threads. The rows' activations
// live in shared memory as f32; each layer's weights are staged through a
// shared-memory buffer in chunks of input rows (so roomnet-600's 3136x32
// first layer streams through where it would not fit), and each thread owns
// fixed (row, unit) outputs whose f32 sums carry across the chunks.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_LAYERS = 8;

struct HeadDims {
  int n;                         // number of dense layers
  int width[MAX_LAYERS + 1];     // width[0] = flat_len, width[n] = classes
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
dense_head_kernel(const T* __restrict__ x, const float* __restrict__ params,
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
cudaError_t launch(const void* x, const void* params, void* logits, void* probs, int B, int RB,
                   int maxw, int kchunk, const HeadDims& d, cudaStream_t stream) {
  const size_t smem = (size_t)(2 * RB * maxw + kchunk) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(dense_head_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dense_head_kernel<T><<<(B + RB - 1) / RB, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(params), static_cast<float*>(logits),
      static_cast<float*>(probs), B, RB, maxw, kchunk, d);
  return cudaSuccess;
}

}  // namespace

// x (B, widths[0]) in the io dtype; params f32, per layer: K (in x out) row
// major, then (w, b) for a hidden layer or the bias for the last; logits and
// probs (B, widths[n_layers]) f32. RB rows per block, kchunk floats of
// staged weights; the wrapper sizes both.
extern "C" int rn_dense_head(const void* x, const void* params, void* logits, void* probs, int B,
                             const int* widths, int n_layers, int RB, int kchunk, int dtype,
                             int device, void* stream) {
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
  cudaError_t err = dtype == rn::kBF16
            ? launch<__nv_bfloat16>(x, params, logits, probs, B, RB, maxw, kchunk, d, st)
            : launch<float>(x, params, logits, probs, B, RB, maxw, kchunk, d, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
