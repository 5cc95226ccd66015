// 3x3 VALID convolution, stride 1, NHWC x HWIO -> NHWC, f32 accumulation,
// with an optional per-Cout f32 bias (the folded preprocess of conv 0).
//
// Replaces roomnet_tpu/ops/pallas/conv_b2.py:conv3x3_pallas (an im2col MXU
// matmul over 8-row tiles). What bounds it on an H100: operations. The
// forward's ten convs are ~4.5 GFLOP per image against well under 1 MB of
// activations per image per conv, far above the card's bytes-per-FLOP line.
//
// Design (direct convolution on CUDA cores, plain and right first): a block
// computes an 8x32 tile of output pixels for COT output channels. It stages
// the (8+2)x(32+2) input halo for 8 input channels and the 3x3x8xCOT weight
// slice in shared memory as f32, loops over input-channel chunks, and each
// thread keeps 4 pixels x COT/4 channels of f32 sums in registers. The
// weights are tiled over Cout because the largest (3x3x64x128 f32, 295 KB)
// does not fit a block's 227 KB. Inputs in shared memory are channel-major
// so a warp's 32 lanes read 32 neighbouring pixels without bank conflicts;
// the weight reads are warp-wide broadcasts. Tensor cores (wgmma) and TMA
// are later work.
#include "common.cuh"

namespace {

constexpr int TH = 8;        // output rows per block
constexpr int TW = 32;       // output columns per block
constexpr int CI_T = 8;      // input channels per shared-memory stage
constexpr int THREADS = 256;  // 64 pixel groups x 4 channel groups

template <typename T, int COT>
__global__ void __launch_bounds__(THREADS)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ bias,
               T* __restrict__ y, int H, int W, int Cin, int Cout, int tiles_w) {
  constexpr int QPT = COT / 4;  // output channels per thread
  constexpr int IH = TH + 2, IW = TW + 2;
  __shared__ float sx[CI_T][IH][IW];
  __shared__ __align__(16) float sw[9][CI_T][COT];

  const int Ho = H - 2, Wo = W - 2;
  const int b = blockIdx.z;
  const int co0 = blockIdx.y * COT;
  const int oh0 = (blockIdx.x / tiles_w) * TH;
  const int ow0 = (blockIdx.x % tiles_w) * TW;
  const int tid = threadIdx.x;
  const int pc = tid & 31;         // column in the tile (one warp = 32 columns)
  const int pr = (tid >> 5) & 1;   // rows pr, pr+2, pr+4, pr+6
  const int cq = (tid >> 6) * QPT;  // first output channel of this thread

  float acc[4][QPT];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int q = 0; q < QPT; ++q) acc[j][q] = 0.f;

  const T* xb = x + (size_t)b * H * W * Cin;
  for (int ci0 = 0; ci0 < Cin; ci0 += CI_T) {
    for (int i = tid; i < IH * IW * CI_T; i += THREADS) {
      const int ci = i % CI_T, pos = i / CI_T;
      const int c = pos % IW, r = pos / IW;
      const int gh = oh0 + r, gw = ow0 + c, gc = ci0 + ci;
      float v = 0.f;
      if (gh < H && gw < W && gc < Cin) v = rn::to_f32(xb[((size_t)gh * W + gw) * Cin + gc]);
      sx[ci][r][c] = v;
    }
    for (int i = tid; i < 9 * CI_T * COT; i += THREADS) {
      const int co = i % COT, ci = (i / COT) % CI_T, tap = i / (COT * CI_T);
      const int gc = ci0 + ci, gco = co0 + co;
      float v = 0.f;
      if (gc < Cin && gco < Cout) v = rn::to_f32(w[((size_t)tap * Cin + gc) * Cout + gco]);
      sw[tap][ci][co] = v;
    }
    __syncthreads();
#pragma unroll 2
    for (int ci = 0; ci < CI_T; ++ci) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          float xv[4], wv[QPT];
#pragma unroll
          for (int j = 0; j < 4; ++j) xv[j] = sx[ci][pr + 2 * j + dy][pc + dx];
#pragma unroll
          for (int q = 0; q < QPT; ++q) wv[q] = sw[dy * 3 + dx][ci][cq + q];
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int q = 0; q < QPT; ++q) acc[j][q] = fmaf(xv[j], wv[q], acc[j][q]);
        }
      }
    }
    __syncthreads();
  }

  const int ow = ow0 + pc;
  if (ow >= Wo) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int oh = oh0 + pr + 2 * j;
    if (oh >= Ho) continue;
    T* yp = y + (((size_t)b * Ho + oh) * Wo + ow) * Cout;
#pragma unroll
    for (int q = 0; q < QPT; ++q) {
      const int co = co0 + cq + q;
      if (co < Cout) {
        float v = acc[j][q];
        if (bias != nullptr) v = __fadd_rn(v, bias[co]);
        yp[co] = rn::from_f32<T>(v);
      }
    }
  }
}

template <typename T, int COT>
void launch(const void* x, const void* w, const void* bias, void* y, int B, int H, int W,
            int Cin, int Cout, cudaStream_t stream) {
  const int Ho = H - 2, Wo = W - 2;
  const int tiles_w = (Wo + TW - 1) / TW, tiles_h = (Ho + TH - 1) / TH;
  dim3 grid(tiles_w * tiles_h, (Cout + COT - 1) / COT, B);
  conv3x3_kernel<T, COT><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(bias),
      static_cast<T*>(y), H, W, Cin, Cout, tiles_w);
}

template <typename T>
void dispatch(const void* x, const void* w, const void* bias, void* y, int B, int H, int W,
              int Cin, int Cout, cudaStream_t stream) {
  if (Cout >= 32) launch<T, 32>(x, w, bias, y, B, H, W, Cin, Cout, stream);
  else if (Cout >= 16) launch<T, 16>(x, w, bias, y, B, H, W, Cin, Cout, stream);
  else launch<T, 8>(x, w, bias, y, B, H, W, Cin, Cout, stream);
}

}  // namespace

// x (B,H,W,Cin), w (3,3,Cin,Cout) in the io dtype; bias (Cout,) f32 or null;
// y (B,H-2,W-2,Cout) in the io dtype. All contiguous.
extern "C" int rn_conv3x3(const void* x, const void* w, const void* bias, void* y, int B, int H,
                          int W, int Cin, int Cout, int dtype, int device, void* stream) {
  rn::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rn::kBF16) dispatch<__nv_bfloat16>(x, w, bias, y, B, H, W, Cin, Cout, s);
  else dispatch<float>(x, w, bias, y, B, H, W, Cin, Cout, s);
  return cudaGetLastError();
}
