// Implicit-GEMM convolution in bf16 on Hopper's wgmma and TMA, with the
// epilogue y = relu?(conv(x, w) + bias + res?). It replaces no kernel of the
// JAX package: ResNet-50 v1.5 (models/resnet.py) needs padded and strided 3x3
// convs whose weights do not fit in shared memory, and 1x1 convs. The tile
// plan, the input's tensor maps and the operand layout below serve both;
// `body`, one block a tile, is conv3x3.cu's conv_wg_stream (k = 3) alone.
// conv1x1.cu's conv1x1_bn_kernel (k = 1) walks the same tiles with a
// persistent body of its own.
//
// NHWC x HWIO -> NHWC, zero padding `pad`, stride 1 or 2, Cin and Cout
// multiples of 64. M = B*Ho*Wo output pixels, N = Cout, K = k*k*Cin in steps
// of one tap x 64 input channels.
//
// What bounds it on an H100 (batch 256, bf16): the 1x1 convs are bound by
// HBM (they read and write activations at 64-2048 channels with 2*Cin or
// 2*Cout operations a byte), the 3x3 convs by the tensor cores. So the bias,
// the residual and the ReLU are applied in the epilogue, in registers, and
// no pass outside the kernel re-reads the activations. A 3x3 tile takes 9-72
// K steps, which amortise `body`'s one epilogue a block; a 1x1 tile takes
// 1-32, too few to hide an epilogue that waits on its residual reads and
// stores, so conv1x1.cu loads the next tiles and the residual by TMA while
// it finishes one. This design re-reads a tile's input once a tap (from
// L2), which a halo shared by the 9 taps would spare the 3x3 convs.
//
// A tile is BM = 128 output pixels x BN = 64 or 128 output channels
// (blockIdx.x: the N tile fastest, so the blocks of one pixel tile read its
// input from L2). Its pixels are one TMA box of tw columns x th rows x nb
// images (tw*th*nb <= 128, `plan`: the box with the fewest tiles); rows of
// the tile past the box are computed from stale shared memory and dropped.
// A K step's A operand is that box for the tap's input pixels, 64 channels
// (128 bytes) a pixel, one TMA copy swizzled by 128 bytes: wgmma's K-major
// layout with 128-byte swizzle (8-pixel atoms of 1 KB, a k16 step 32 bytes
// on), at any tap. The input is read through 4-D tensor maps of NHWC views
// at the stride: at stride s, s*s maps, map (py, px) holding the pixels
// (s*i + py, s*j + px), so that input pixel s*o + d (d = the tap's offset -
// pad) is map (d mod s)'s pixel o + floor(d / s). A box past the image (the
// padding; the ragged edge) is zero-filled by the TMA. A 1x1 conv at
// stride 1 is one GEMM over the flattened pixels: its caller passes (B, H,
// W) = (1, 1, B*H*W), and a tile's box is 128 consecutive pixels.
//
// B: the weights as ops/kernels/conv3x3.py:pack_stream packs them, [N tile]
// [K step][BN][64] bf16, each output channel's 64 input channels in 16-byte
// chunks swizzled as the TMA swizzles A's (chunk c at c ^ (n % 8)): each
// step's 16 KB (BN 128) is the shared-memory image wgmma reads, one
// contiguous bulk copy.
//
// Block: two consumer warpgroups (tile rows 0-63 and 64-127, one
// wgmma.m64nBNk16 each a k16 step) and a producer warp whose lane 0 keeps
// `stages` K steps in flight, each stage with a full and an empty mbarrier.
// Epilogue: sum + bias (f32), + res (bf16, read at the output's index), the
// ReLU, one rounding to bf16; res read and y written 16 bytes a lane.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <mutex>
#include <set>
#include <utility>

#include "common.cuh"
#include "sm90.cuh"

namespace rn {
namespace igemm {

constexpr int BM = 128;                    // output pixels of a tile
constexpr int BK = 64;                     // input channels of a K step
constexpr int CONSUMERS = 256;             // two warpgroups
constexpr int THREADS = CONSUMERS + 32;    // and the producer warp
constexpr int A_BYTES = BM * BK * 2;       // the tile's pixels, 128 bytes each
constexpr int MAX_SMEM = 232448;           // a block's dynamic shared memory on sm_90
constexpr int MAX_STAGES = 4;

// The input's tensor maps, one per pixel parity at stride 2 ((py, px) at
// py * 2 + px), the first alone at stride 1.
struct Maps {
  CUtensorMap m[4];
};

struct Args {
  const uint8_t* w;           // packed weights
  const float* bias;          // (Cout) or null
  const __nv_bfloat16* res;   // like y, or null
  __nv_bfloat16* y;           // (B, Ho, Wo, Cout)
  int B, Ho, Wo, Cout;
  int kw, pad, stride;        // kernel side, zero padding, stride
  int chunks, ksteps;         // Cin / BK; kw * kw * chunks
  int tw, th, nb;             // the tile's box: columns, rows, images
  int tiles_w, tiles_h, tiles_n;
  int stages, a_bytes;        // K steps in flight; bytes a step's A boxes bring
  int relu;
};

struct Plan {
  int bn = 0, tw = 0, th = 0, nb = 0, tiles_w = 0, tiles_h = 0, tiles_b = 0, stages = 0;
  size_t smem = 0;
};

__host__ __device__ constexpr int b_bytes(int bn) { return bn * BK * 2; }

// For the packed BN: the box of whole output rows (tw = Wo, at most BM) with
// the fewest tiles, images side by side where one box holds all rows; the
// most stages (up to 4) with which two blocks share an SM.
inline Plan plan(int B, int Ho, int Wo, int bn) {
  Plan p;
  p.bn = bn;
  p.tw = Wo < BM ? Wo : BM;
  long long best = -1;
  for (int th = 1; th <= Ho && th * p.tw <= BM; ++th) {
    const int fit = BM / (th * p.tw), nb = th == Ho ? (B < fit ? B : fit) : 1;
    const long long tiles = (long long)((Wo + p.tw - 1) / p.tw) * ((Ho + th - 1) / th) * ((B + nb - 1) / nb);
    if (best < 0 || tiles < best) best = tiles, p.th = th, p.nb = nb;
  }
  p.tiles_w = (Wo + p.tw - 1) / p.tw;
  p.tiles_h = (Ho + p.th - 1) / p.th;
  p.tiles_b = (B + p.nb - 1) / p.nb;
  const int stage = A_BYTES + b_bytes(p.bn);
  p.stages = (MAX_SMEM / 2 - 1024 - 16 * MAX_STAGES) / stage;
  if (p.stages > MAX_STAGES) p.stages = MAX_STAGES;
  p.smem = 1024 + (size_t)p.stages * stage + 16 * p.stages;  // 1024: room to align the base
  return p;
}

// The map of NHWC bf16 `x` (B, H, W, C) seen at stride s from pixel (py, px):
// dims (C, Wv, Hv, B), boxes of 64 channels x tw x th x nb swizzled by 128
// bytes. Returns 0 or rn::kCuResult + the CUresult.
inline int encode_view(CUtensorMap* m, const void* x, int B, int H, int W, int C, int s, int py, int px,
                       const Plan& p) {
  sm90::EncodeTiled fn;
  const int e = sm90::encoder(&fn);
  if (e != 0) return e;
  const cuuint64_t es = 2, c = (cuuint64_t)C, w = (cuuint64_t)W, h = (cuuint64_t)H;
  const cuuint64_t dims[4] = {c, (cuuint64_t)((W - px + s - 1) / s), (cuuint64_t)((H - py + s - 1) / s),
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {s * c * es, s * w * c * es, h * w * c * es};
  const cuuint32_t box[4] = {BK, (cuuint32_t)p.tw, (cuuint32_t)p.th, (cuuint32_t)p.nb};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  void* base = const_cast<char*>(static_cast<const char*>(x)) + ((size_t)py * W + px) * C * es;
  const CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : rn::kCuResult + static_cast<int>(r);
}

// Fills `a` and `p` for y = conv(x, w) with a k x k kernel whose weights are
// packed in Cout tiles of `bn` (64 or 128: the packing's, which the caller
// reads off it), and, given `maps`, encodes x's maps. Returns 0 or the error
// the launch would give.
inline int prepare(const void* x, const void* w, const void* bias, const void* res, void* y, int B, int H,
                   int W, int Cin, int Cout, int k, int pad, int stride, int relu, int bn, Args& a, Plan& p,
                   Maps* maps) {
  if (B < 1 || Cin < BK || Cin % BK || (bn != 64 && bn != 128) || Cout < bn || Cout % bn ||
      (stride != 1 && stride != 2) || pad < 0 || H < stride || W < stride || H + 2 * pad < k || W + 2 * pad < k)
    return cudaErrorInvalidValue;
  const int Ho = (H + 2 * pad - k) / stride + 1, Wo = (W + 2 * pad - k) / stride + 1;
  p = plan(B, Ho, Wo, bn);
  a.w = static_cast<const uint8_t*>(w);
  a.bias = static_cast<const float*>(bias);
  a.res = static_cast<const __nv_bfloat16*>(res);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.B = B, a.Ho = Ho, a.Wo = Wo, a.Cout = Cout;
  a.kw = k, a.pad = pad, a.stride = stride;
  a.chunks = Cin / BK, a.ksteps = k * k * a.chunks;
  a.tw = p.tw, a.th = p.th, a.nb = p.nb;
  a.tiles_w = p.tiles_w, a.tiles_h = p.tiles_h, a.tiles_n = Cout / p.bn;
  a.stages = p.stages, a.a_bytes = p.tw * p.th * p.nb * BK * 2;
  a.relu = relu;
  if (maps != nullptr)
    for (int py = 0; py < stride; ++py)
      for (int px = 0; px < stride; ++px) {
        const int e = encode_view(&maps->m[py * stride + px], x, B, H, W, Cin, stride, py, px, p);
        if (e != 0) return e;
      }
  return 0;
}

// The 4 x 4 transpose of 32-bit words among the four lanes of a quad (t =
// lane % 4): lane t's v[j] becomes lane j's v[t]. Every lane of the warp
// takes part.
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int t) {
  const bool odd = t & 1, high = t & 2;
  uint32_t x0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[1], 1);
  uint32_t x1 = __shfl_xor_sync(0xffffffffu, odd ? v[2] : v[3], 1);
  if (odd) v[0] = x0, v[2] = x1;
  else v[1] = x0, v[3] = x1;
  x0 = __shfl_xor_sync(0xffffffffu, high ? v[0] : v[2], 2);
  x1 = __shfl_xor_sync(0xffffffffu, high ? v[1] : v[3], 2);
  if (high) v[0] = x0, v[1] = x1;
  else v[2] = x0, v[3] = x1;
}

// A wgmma matrix descriptor of a K-major operand swizzled by 128 bytes:
// rows of 128 bytes, 8-row atoms of 1 KB (the stride byte offset), the
// leading offset unused; `addr` steps 32 bytes a k16 step within the atom.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

template <int BN>
__device__ __forceinline__ void body(const Maps& maps, const Args& a) {
  using namespace rn::sm90;
  constexpr int B_BYTES = b_bytes(BN);
  constexpr int NA = BN / 2;  // a consumer thread's accumulators: m64 x BN
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sa = base, sb = base + a.stages * A_BYTES;
  const uint32_t full = sb + a.stages * B_BYTES, empty = full + 8 * a.stages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tn = blockIdx.x % a.tiles_n, tm = blockIdx.x / a.tiles_n;
  const int r = tm / a.tiles_w, x0 = (tm % a.tiles_w) * a.tw;
  const int y0 = (r % a.tiles_h) * a.th, b0 = (r / a.tiles_h) * a.nb;

  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers are initialised; no block-wide barrier follows

  if (warp == CONSUMERS / 32) {  // the producer
    if (lane != 0) return;
    const uint8_t* wt = a.w + (size_t)tn * a.ksteps * B_BYTES;
    for (int k = 0; k < a.ksteps; ++k) {
      const int st = k % a.stages;
      if (k >= a.stages) mbar_wait(empty + 8 * st, ((k / a.stages) - 1) & 1);
      const int tap = k / a.chunks, c = k - tap * a.chunks;
      const int dy = tap / a.kw - a.pad, dx = tap % a.kw - a.pad;  // input offset of the tap
      const int py = (dy % a.stride + a.stride) % a.stride, px = (dx % a.stride + a.stride) % a.stride;
      const CUtensorMap* map = &maps.m[py * a.stride + px];
      const int vx = x0 + (dx - px) / a.stride, vy = y0 + (dy - py) / a.stride;
      const uint32_t bar = full + 8 * st, dst = sa + st * A_BYTES;
      mbar_expect_tx(bar, a.a_bytes + B_BYTES);
      tma_load(dst, map, bar, c * BK, vx, vy, b0);
      bulk_load(sb + st * B_BYTES, wt + (size_t)k * B_BYTES, B_BYTES, bar);
    }
    return;
  }

  // A of k16 step s: the warpgroup's 64 rows from row 64 * wg (8 KB on),
  // 32 s bytes into each row; B: all BN rows, 32 s bytes in.
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, q = (lane & 3) * 2;
  const uint64_t da0 = desc_sw128(sa + wg * 64 * BK * 2), db0 = desc_sw128(sb);
  float acc[NA];
#pragma unroll
  for (int n = 0; n < NA; ++n) acc[n] = 0.f;
  fence_operands(acc);
  for (int k = 0; k < a.ksteps; ++k) {
    const int st = k % a.stages;
    mbar_wait(full + 8 * st, (k / a.stages) & 1);
    const uint64_t da = da0 + (uint64_t)(st * (A_BYTES / 16)), db = db0 + (uint64_t)(st * (B_BYTES / 16));
    // Nothing touches the accumulators between the fence and the commit.
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < BK / 16; ++s)
      Wgmma<BN>::run(acc, da + (uint64_t)(2 * s), db + (uint64_t)(2 * s));
    wgmma_commit();
    // The step before is done: its stage goes back to the producer.
    wgmma_wait<1>();
    if (k > 0 && lane == 0) mbar_arrive(empty + 8 * ((k - 1) % a.stages));
  }
  wgmma_wait<0>();
  fence_operands(acc);

  // C fragment, n8 block n: (A row g, channels 8n + q, +1) in acc[4n],
  // [4n + 1], (row g + 8, the same) in [4n + 2], [4n + 3]; warp wq's rows
  // are 16 wq on in the warpgroup's 64. Tile row rr is box pixel (rr % tw,
  // rr / tw % th, rr / (tw * th)). The four lanes of a row (t = lane % 4)
  // hold 16 bytes of each n8 block: over each 4 n8 blocks a transpose
  // among them (`quad_transpose`) gives lane t block t's 16 bytes, so the
  // residual is read and the output written 16 bytes a lane. Rows past the
  // output shuffle with the rest and touch no memory.
  const int co0 = tn * BN, t = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int rr = wg * 64 + wq * 16 + g + 8 * hh;
    const int i = rr % a.tw, j = rr / a.tw % a.th, kb = rr / (a.tw * a.th);
    const int wo = x0 + i, ho = y0 + j, b = b0 + kb;
    const bool ok = kb < a.nb && wo < a.Wo && ho < a.Ho && b < a.B;
    const size_t m = ok ? ((size_t)b * a.Ho + ho) * a.Wo + wo : 0;
#pragma unroll
    for (int n4 = 0; n4 < BN / 32; ++n4) {
      const size_t at = m * a.Cout + co0 + 32 * n4 + 8 * t;  // lane t's 16 bytes after the transpose
      uint32_t res[4] = {0u, 0u, 0u, 0u}, w[4];
      if (a.res != nullptr) {
        if (ok) {
          const uint4 rv = *reinterpret_cast<const uint4*>(a.res + at);
          res[0] = rv.x, res[1] = rv.y, res[2] = rv.z, res[3] = rv.w;
        }
        quad_transpose(res, t);  // res[jj]: channels 8 (4 n4 + jj) + q, +1
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int n = 4 * n4 + jj, co = co0 + 8 * n + q;
        float v0 = acc[4 * n + 2 * hh], v1 = acc[4 * n + 2 * hh + 1];
        if (a.bias != nullptr) v0 = __fadd_rn(v0, a.bias[co]), v1 = __fadd_rn(v1, a.bias[co + 1]);
        if (a.res != nullptr) {
          const float2 rv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&res[jj]));
          v0 = __fadd_rn(v0, rv.x), v1 = __fadd_rn(v1, rv.y);
        }
        if (a.relu) v0 = v0 < 0.f ? 0.f : v0, v1 = v1 < 0.f ? 0.f : v1;  // NaN stays NaN, as torch.relu
        const __nv_bfloat162 o = __floats2bfloat162_rn(v0, v1);
        w[jj] = *reinterpret_cast<const uint32_t*>(&o);
      }
      quad_transpose(w, t);  // w: lane t's channels 8 (4 n4 + t) .. + 7
      if (ok) *reinterpret_cast<uint4*>(a.y + at) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// Raises `kernel`'s dynamic shared-memory limit to `smem` on its first
// launch on `device`; later calls for the pair do nothing.
inline int raise_smem(const void* kernel, int smem, int device) {
  static std::mutex mu;
  static std::set<std::pair<const void*, int>> raised;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_pair(kernel, device);
  if (raised.count(key) != 0) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) raised.insert(key);
  return e;
}

// Launches `kernel` (an instance of `body`) on the plan's grid.
template <typename Kernel>
int launch(Kernel kernel, const Maps& maps, const Args& a, const Plan& p, int device, cudaStream_t s) {
  const int e = raise_smem(reinterpret_cast<const void*>(kernel), (int)p.smem, device);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)p.tiles_w * p.tiles_h * p.tiles_b * a.tiles_n;
  kernel<<<(unsigned)blocks, THREADS, p.smem, s>>>(maps, a);
  return cudaGetLastError();
}

}  // namespace igemm
}  // namespace rn
