// 1x1 convolution as a bf16 GEMM on Hopper's wgmma and TMA, with the folded
// BN's bias, an optional residual and an optional ReLU in its epilogue:
// y = relu?(x[:, ::s, ::s] @ w + bias + res?), NHWC, w (Cin, Cout), stride s
// 1 or 2, Cin and Cout multiples of 64. M = B*Ho*Wo, K = Cin, N = Cout.
//
// It replaces no kernel of the JAX package: ResNet-50 v1.5's 36 1x1 convs
// (the bottlenecks' first and last, the four projection shortcuts) are half
// its operations. On an H100 they are bound by HBM (at batch 256 about 10 GB
// of activations against 1.1 ms of tensor-core time a forward), so nothing
// of the bias, the residual add and the ReLU is left to a pass of its own:
// each would re-read and re-write activations that are already the bound.
//
// The kernel is igemm.cuh's implicit GEMM at k = 1, under a name of its own
// (conv1x1_bn_kernel) so that a device trace times it apart from the 3x3
// convs. At stride 1 the pixels are one flat M (a tile: 128 consecutive
// pixels); at stride 2 a tile is a box of output rows read through a tensor
// map of the strided view. The weights are packed by
// ops/kernels/conv3x3.py:pack_stream ([N tile][K step][BN][64], swizzled).
#include <cuda_runtime.h>

#include "common.cuh"
#include "igemm.cuh"

namespace {

template <int BN>
__global__ void __launch_bounds__(rn::igemm::THREADS, 2)
    conv1x1_bn_kernel(const __grid_constant__ rn::igemm::Maps maps, const rn::igemm::Args a) {
  rn::igemm::body<BN>(maps, a);
}

constexpr int REPORT = 8;

// report: {BN, tile columns, rows, images, shared memory, stages, pixel
// tiles, Cout tiles}; given, nothing is launched.
int run(const void* x, const void* w, const void* bias, const void* res, void* y, int B, int H, int W, int Cin,
        int Cout, int stride, int relu, int bn, int device, cudaStream_t s, int* report) {
  if (stride == 1) W = B * H * W, H = 1, B = 1;  // one flat M
  rn::igemm::Args a;
  rn::igemm::Plan p;
  rn::igemm::Maps maps;
  const int e = rn::igemm::prepare(x, w, bias, res, y, B, H, W, Cin, Cout, 1, 0, stride, relu, bn, a, p,
                                   report != nullptr ? nullptr : &maps);
  if (e != 0) return e;
  if (report != nullptr) {
    const int v[REPORT] = {p.bn, p.tw, p.th, p.nb, (int)p.smem, p.stages, p.tiles_w * p.tiles_h * p.tiles_b,
                           a.tiles_n};
    for (int i = 0; i < REPORT; ++i) report[i] = v[i];
    return cudaSuccess;
  }
  return p.bn == 128 ? rn::igemm::launch(conv1x1_bn_kernel<128>, maps, a, p, device, s)
                     : rn::igemm::launch(conv1x1_bn_kernel<64>, maps, a, p, device, s);
}

}  // namespace

// x (B,H,W,Cin) bf16; w packed by pack_stream from (1,1,Cin,Cout) in Cout
// tiles of bn (its dim 2); bias (Cout,) f32 or null; res like y or null; y
// (B,Ho,Wo,Cout) bf16 with Ho = (H - 1) / stride + 1. All contiguous,
// 16-byte aligned.
extern "C" int rn_conv1x1(const void* x, const void* w, const void* bias, const void* res, void* y, int B, int H,
                          int W, int Cin, int Cout, int stride, int relu, int bn, int device, void* stream) {
  rn::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  return run(x, w, bias, res, y, B, H, W, Cin, Cout, stride, relu, bn, device, static_cast<cudaStream_t>(stream),
             nullptr);
}

// What rn_conv1x1 launches for one shape, for reports: out[8] as `run` lays
// it out. Returns 0, or the error rn_conv1x1 would return.
extern "C" int rn_conv1x1_variant(int B, int H, int W, int Cin, int Cout, int stride, int bn, int* out) {
  return run(nullptr, nullptr, nullptr, nullptr, nullptr, B, H, W, Cin, Cout, stride, 0, bn, -1, nullptr, out);
}
