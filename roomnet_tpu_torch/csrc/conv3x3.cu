// 3x3 convolution, NHWC x HWIO -> NHWC, f32 accumulation, with an optional
// per-Cout f32 bias (the folded preprocess of conv 0; a folded BN). VALID at
// stride 1 takes the paths below; zero padding, stride 2 or an epilogue
// (ReLU, a residual) takes the streamed path (`rn_conv3x3_stream`, bf16,
// igemm.cuh's implicit GEMM as the kernel conv_wg_stream, for ResNet-50).
//
// Replaces roomnet_tpu/ops/pallas/conv_b2.py:conv3x3_pallas (an im2col MXU
// matmul over 8-row tiles). It is an implicit GEMM: M = the output pixels of
// a tile, N = Cout, K = 9 * Cin, with the nine taps read as shifted views of
// one input halo tile in shared memory (no im2col buffer). K is cut into
// slices of 8 input channels of one tap (16 bytes per pixel), two slices per
// k16 step; an odd slice count is padded with a zero slice. The weights
// arrive packed by ops/kernels/conv3x3.py:pack_bf16 as [slice][Cout_p][8].
//
// What bounds it on an H100: in bf16 the bytes at 32 channels and about
// evenly bytes and operations at 64 and 128 (205^2x32->64 at batch 256: 0.69
// GB in, 1.35 GB out, 389 GFLOP); in f32 the operations (TF32 passes on the
// tensor cores; CUDA cores at conv 0). So
// the bf16 path has to keep HBM and the tensor cores busy at once, and write
// its output, two thirds of the bytes, in whole lines.
//
// bf16, Cin / 8 a power of two (`wg::conv_wg`): Hopper's wgmma, TMA and
// mbarriers. A persistent block holds all of Cout's weights in shared memory
// for its life (cp.async, once); its two warpgroups each walk their own
// output tiles of 4*MI rows x 14 columns, one started half a tile after the
// other so that each one's epilogue overlaps the other's wgmmas (with one
// block per SM the two would otherwise idle the tensor cores together).
// Each warpgroup's thread 0 keeps
// the halos of its next tiles in flight in a ring of 2 or 3 stages: one 4-D
// TMA box (8 channels x 16 columns x 4*MI+2 rows x 1 image) per 8 input
// channels, zero-filled past the image, each stage signalled by an mbarrier.
// wgmma.m64nNk16 (N = Cout_p) reads both operands from shared memory through
// descriptors, K-major without swizzle (core matrices of 8 rows x 16 bytes):
// B is the resident packed weights as they are (the two slices of a k16
// step Cout_p * 16 bytes apart, n groups 128), and A is 64 consecutive halo
// pixels shifted by the tap, 4 halo lines of 16: 8 consecutive pixels of
// one 8-channel box are 128 contiguous bytes at any tap offset, which is
// what makes the shifted view a canonical operand (the 2 extra columns of a
// line are computed and discarded, 12.5% of the work). A tile's k16 steps
// are issued back to back with nothing between them that touches the
// accumulators (ptxas would serialize them otherwise), then waited on once.
// Epilogue: sum + bias, rounded to bf16 into a staging tile swizzled by its
// pixel stride (conflict-free stores), written by a TMA store that clips the
// ragged edge while the warpgroup goes on to its next tile; where Cout is not
// a multiple of 8 (no 16-byte row stride for TMA), each lane stores its
// values itself.
//
// bf16, other Cin (conv 0's 3 channels, whose 6-byte pixel stride TMA
// refuses, and Cin / 8 no power of two, whose tap the wgmma loop's shift
// cannot find; `tc::conv_tc`): mma.sync.m16n8k16 fed by ldmatrix from a halo,
// two buffers, loaded by 16-byte cp.async where Cin % 8 == 0 and else by
// element loads zero-padded to 8 channels.
//
// f32, Cin a multiple of 8 up to 256 (`tf::conv_tf32x3`): TF32 passes on
// wgmma over a hi/lo split, f32-accurate as the reference's
// Precision.HIGHEST contraction (six bf16 passes of the TPU's MXU) is. Each
// f32 operand is split into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna,
// ties away from zero), and each k8 step computes the four products
// lo_a*lo_b, lo_a*hi_b, hi_a*lo_b and hi_a*hi_b. Three (without lo_a*lo_b,
// below f32's own rounding) are as accurate on the card; the fourth is there
// for chip_smoke.py phase 10 (b), whose moment gate failed with three
// (PERF.md §6). B is one operand of N = 2 * NT, the hi and lo weights of a
// tile's NT output channels side by side ([hi | lo]), so the four products
// are two wgmmas, lo_a*[hi | lo] and hi_a*[hi | lo], and each A tile is read
// from shared memory twice, not four times: at NT 32 a k8 step reads 8 KB of
// operands in its 64 tensor-core clocks, not 12 KB, within shared memory's
// 128 bytes a clock (sites 1-9 at batch 256: 17.46 ms, four wgmmas of N = NT
// 20.94; H100). The halo, the
// descriptors and the tile walk are the bf16 wgmma path's with a 4-channel
// TMA box (16 bytes a pixel, as the bf16 box of 8), so that 8 consecutive
// halo pixels are again one core matrix at any tap offset. K runs in chunks
// of 8 channels, one halo stage each (Cin 128's whole halo would not fit
// beside its weights): a warpgroup splits each stage in place into hi and a
// lo twin once it lands, then issues the chunk's 9 taps x 2 wgmmas x m64
// blocks, and adds the chunk's sums into f32 registers rounded to nearest,
// the lo-weight columns before the hi-weight ones (the tensor cores' own
// accumulation truncates: over a whole K of 1152 the error reached the 1e-4
// gate). B comes packed and split by ops/kernels/conv3x3.py:pack_tf32x3 as
// [Cout tile][slice][hi, lo][NT][4]; a block holds one Cout tile of NT
// channels (hi + lo at most 144 KB: Cin 64 takes NT 32, Cin 128 NT 16), the
// Cout tiles over blockIdx.y. Each lane stores its output pairs (8 lanes of
// a pixel fill 32-byte sectors). Bound: the tensor cores' TF32 rate over
// the three passes f32 accuracy needs, 2.5x above the CUDA cores' f32 rate.
//
// f32, other Cin (conv 0's 3 channels: `cc::conv_f32`): full f32 on CUDA
// cores, no TF32. K is staged in chunks
// of 4 input channels (the halo chunk and its 9 x 4 x NT weights, 16-byte
// cp.async, two buffers so chunk c+1 loads while chunk c computes). Each
// thread keeps 8 rows x 8 output channels of sums in registers; per tap it
// reads 8 float4 of inputs (its 8 rows, 4 channels) and 8 float4 of
// weights (a warp-wide broadcast) for 256 FMAs. Cout is split over
// blockIdx.y in tiles of NT channels. Weights are packed by
// ops/kernels/conv3x3.py:pack_f32 as [Cout tile][chunk][tap][4][NT].
//
// The packed layout is decided in Python alone: the caller passes its Cout_p
// (bf16) or NT (f32), read off the packed tensor's shape. This file picks
// the path by shape alone (dtype, Cin) and the tile that goes with it; it
// never falls back from one path to another.
//
// Epilogue (all): sum + bias in f32, then one rounding to the io dtype, as
// ops/kernels/conv3x3.py:conv3x3_plain rounds.
#include <cuda.h>  // CUtensorMap and its enums; the encode function comes from the runtime
#include <cstdint>
#include <initializer_list>
#include <map>
#include <mutex>
#include <tuple>

#include "common.cuh"
#include "igemm.cuh"
#include "sm90.cuh"

namespace {

using namespace rn::sm90;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SMEM = 232448;  // a block's dynamic shared memory on sm_90

// How a kernel fits on a device: the SM count and the blocks of THREADS
// threads with a given dynamic shared memory that one SM holds.
struct Fit {
  int sms = 0, per_sm = 0;
};

// Worked out on a variant's first launch on a device with `smem` bytes and
// kept, so a launch makes no attribute or occupancy query: the first one also
// raises the kernel's dynamic shared-memory limit to `smem_max`, the most any
// of its launches asks for.
cudaError_t fit(const void* k, int device, int smem_max, size_t smem, Fit& out) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, size_t>, Fit> seen;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(k, device, smem);
  const auto it = seen.find(key);
  if (it != seen.end()) {
    out = it->second;
    return cudaSuccess;
  }
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&out.sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out.per_sm, k, THREADS, smem);
  if (e == cudaSuccess) seen.emplace(key, out);
  return e;
}

// What one launch runs, for reports: report[REPORT] = {path (kF32 CUDA cores,
// kMmaSync, kWgmma, kTf32x3), Cout_p (bf16) or NT (f32), rows per warp (bf16,
// tf32x3: m64 blocks per warpgroup) or warp width (f32 CUDA cores), tile rows,
// tile columns, dynamic shared memory bytes, consumer warpgroups (wgmma; else
// 0), halo stages (buffers), 1 if TMA stores the output (else each lane stores
// its values), the output staging's swizzle bytes (0: none), Cout tiles over
// blockIdx.y and input channels per halo stage (tf32x3; else 0), wgmmas a tap
// and m64 block issue for the TF32 products (tf32x3: 2, B [hi | lo]; else
// 0)}. A launch given a report fills it and launches nothing.
constexpr int REPORT = 13;
enum Path : int { kF32 = 0, kMmaSync = 1, kWgmma = 2, kTf32x3 = 3, kStream = 4 };

void fill(int* report, std::initializer_list<int> v) {
  int i = 0;
  for (int x : v) report[i++] = x;
  for (; i < REPORT; ++i) report[i] = 0;
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, int co, int cout, float v0, float v1) {
  if (co + 1 < cout && (cout & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p + co) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (co < cout) p[co] = __float2bfloat16_rn(v0);
    if (co + 1 < cout) p[co + 1] = __float2bfloat16_rn(v1);
  }
}

// ---- bf16, other Cin: mma.sync on a cp.async or element-load halo -----------

namespace tc {

constexpr int TW = 16;       // output columns of one m16 tile
constexpr int HWD = TW + 2;  // halo columns

struct Args {
  const __nv_bfloat16* x;
  const uint4* w;  // [nsp][Cout_p][8] bf16
  const float* bias;
  __nv_bfloat16* y;
  int H, W, Cin, Cout, Ho, Wo;
  int c8;    // 16-byte channel groups of a pixel, ceil(Cin / 8)
  int ustr;  // halo pixel stride in 16-byte units: c8, made odd
  int nsp;   // K slices, 9 * c8 rounded up to even
  int tiles_w, tiles_h, tiles;
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int COUT_P, int MI>
__global__ void __launch_bounds__(THREADS) conv_tc(const Args a) {
  constexpr int TH = WARPS * MI;
  constexpr int NI = COUT_P / 8;
  extern __shared__ uint4 smem[];
  uint4* sw = smem;
  int* soff = reinterpret_cast<int*>(sw + a.nsp * COUT_P);
  uint4* shalo = sw + a.nsp * COUT_P + (a.nsp + 3) / 4;
  const int stage = (TH + 2) * HWD * a.ustr;  // 16-byte units of one halo buffer
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // Weights: a straight copy of the packed image. Slice j = tap * c8 + c is
  // channel group c of tap (dy, dx); soff[j] is its halo offset in units.
  for (int i = tid; i < a.nsp * COUT_P; i += THREADS) rn::cp_async16(sw + i, a.w + i, true);
  for (int j = tid; j < a.nsp; j += THREADS) {
    int off = 0;  // the padding slice reads real pixels against zero weights
    if (j < 9 * a.c8) {
      const int tap = j / a.c8, c = j - tap * a.c8;
      off = ((tap / 3) * HWD + tap % 3) * a.ustr + c;
    }
    soff[j] = off;
  }
  rn::cp_async_commit();

  auto load_halo = [&](int t, uint4* dst) {
    const int tw = t % a.tiles_w, r = t / a.tiles_w, th = r % a.tiles_h, b = r / a.tiles_h;
    const int h0 = th * TH, w0 = tw * TW;
    const __nv_bfloat16* xb = a.x + (size_t)b * a.H * a.W * a.Cin;
    const int n = (TH + 2) * HWD * a.c8;
    for (int i = tid; i < n; i += THREADS) {
      const int pix = i / a.c8, c = i - pix * a.c8;
      const int hr = pix / HWD, hc = pix - hr * HWD;
      const int gh = h0 + hr, gw = w0 + hc;
      const bool in = gh < a.H && gw < a.W;
      uint4* d = dst + pix * a.ustr + c;
      const __nv_bfloat16* src = xb + ((size_t)gh * a.W + gw) * a.Cin + c * 8;
      if ((a.Cin & 7) == 0) {
        rn::cp_async16(d, in ? src : a.x, in);
      } else {  // conv 0's 3 channels: element loads, zero-padded to 8
        __align__(16) __nv_bfloat16 v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = (in && c * 8 + e < a.Cin) ? src[e] : __float2bfloat16_rn(0.f);
        *d = *reinterpret_cast<const uint4*>(v);
      }
    }
  };

  int t = blockIdx.x;
  if (t < a.tiles) load_halo(t, shalo);
  rn::cp_async_commit();

  // ldmatrix row addresses. A (16 pixels x 16 k): lane l gives pixel l & 15
  // of the m16 tile, k half l >> 4 (slice 2s + (l >> 4)). B (16 k x 16 n,
  // two n8 tiles): lane l gives n row ((l >> 4) & 1) * 8 + (l & 7), k half
  // (l >> 3) & 1.
  const uint32_t sw_addr = smem_u32(sw);
  const uint32_t a_lane = ((warp * MI) * HWD + (lane & 15)) * a.ustr * 16;
  const uint32_t a_row = HWD * a.ustr * 16;
  const int a_half = lane >> 4, b_half = (lane >> 3) & 1;
  const uint32_t b_lane = ((((lane >> 4) & 1) * 8) + (lane & 7)) * 16;
  const int g = lane >> 2, q = (lane & 3) * 2;

  for (int it = 0; t < a.tiles; ++it, t += gridDim.x) {
    const int tn = t + gridDim.x;
    if (tn < a.tiles) load_halo(tn, shalo + ((it + 1) & 1) * stage);
    rn::cp_async_commit();
    rn::cp_async_wait<1>();
    __syncthreads();

    const uint32_t hs = smem_u32(shalo + (it & 1) * stage) + a_lane;
    float acc[MI][NI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int n = 0; n < NI; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;

#pragma unroll 2
    for (int j = 0; j < a.nsp; j += 2) {
      const uint32_t offa = soff[j + a_half] * 16;
      uint32_t af[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) ldmatrix_x4(af[i], hs + i * a_row + offa);
      const uint32_t wrow = sw_addr + (j + b_half) * COUT_P * 16 + b_lane;
      if constexpr (NI == 1) {
        uint32_t b0, b1;
        ldmatrix_x2(b0, b1, wrow);
#pragma unroll
        for (int i = 0; i < MI; ++i) mma(acc[i][0], af[i], b0, b1);
      } else {
#pragma unroll
        for (int p = 0; p < NI / 2; ++p) {
          uint32_t bf[4];
          ldmatrix_x4(bf, wrow + p * 16 * 16);
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            mma(acc[i][2 * p], af[i], bf[0], bf[1]);
            mma(acc[i][2 * p + 1], af[i], bf[2], bf[3]);
          }
        }
      }
    }

    // Epilogue: C fragment (g, q..q+1) and (g + 8, q..q+1) of each n8 tile.
    const int tw = t % a.tiles_w, r = t / a.tiles_w, th = r % a.tiles_h, b = r / a.tiles_h;
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int oh = th * TH + warp * MI + i;
      if (oh >= a.Ho) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int ow = tw * TW + g + hh * 8;
        if (ow >= a.Wo) continue;
        __nv_bfloat16* yp = a.y + (((size_t)b * a.Ho + oh) * a.Wo + ow) * a.Cout;
#pragma unroll
        for (int n = 0; n < NI; ++n) {
          const int co = n * 8 + q;
          float v0 = acc[i][n][2 * hh], v1 = acc[i][n][2 * hh + 1];
          if (a.bias != nullptr) {
            if (co < a.Cout) v0 = __fadd_rn(v0, a.bias[co]);
            if (co + 1 < a.Cout) v1 = __fadd_rn(v1, a.bias[co + 1]);
          }
          store2(yp, co, a.Cout, v0, v1);
        }
      }
    }
    __syncthreads();  // the buffer just read is the next prefetch's target
  }
  rn::cp_async_wait<0>();
}

size_t smem_bytes(const Args& a, int cout_p, int mi) {
  return 16 * ((size_t)a.nsp * cout_p + (a.nsp + 3) / 4 + 2 * (size_t)(WARPS * mi + 2) * HWD * a.ustr);
}

Args make_args(const void* x, const void* w, const void* bias, void* y, int H, int W, int Cin,
               int Cout) {
  Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = static_cast<const uint4*>(w);
  a.bias = static_cast<const float*>(bias);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.H = H, a.W = W, a.Cin = Cin, a.Cout = Cout, a.Ho = H - 2, a.Wo = W - 2;
  a.c8 = (Cin + 7) / 8;
  a.ustr = a.c8 | 1;
  a.nsp = (9 * a.c8 + 1) / 2 * 2;
  return a;
}

// Rows per warp for the packed Cout_p: the most the accumulators allow
// whose shared memory still lets two blocks share an SM, else the most that
// fits at all (0 if none does).
int rows_per_warp(const Args& a, int cout_p) {
  const int mi_max = cout_p >= 128 ? 1 : (cout_p >= 64 ? 2 : 4);
  for (int m = mi_max; m >= 1; m /= 2)
    if (smem_bytes(a, cout_p, m) <= MAX_SMEM / 2 - 1024) return m;
  for (int m = mi_max; m >= 1; m /= 2)
    if (smem_bytes(a, cout_p, m) <= MAX_SMEM) return m;
  return 0;
}

template <int COUT_P, int MI>
int launch(Args a, int B, cudaStream_t s, int device, int* report) {
  a.tiles_w = (a.Wo + TW - 1) / TW;
  a.tiles_h = (a.Ho + WARPS * MI - 1) / (WARPS * MI);
  a.tiles = a.tiles_w * a.tiles_h * B;
  const size_t smem = smem_bytes(a, COUT_P, MI);
  if (report != nullptr) {
    fill(report, {kMmaSync, COUT_P, MI, WARPS * MI, TW, (int)smem, 0, 2});
    return cudaSuccess;
  }
  auto* k = conv_tc<COUT_P, MI>;
  Fit f;
  const cudaError_t e = fit(reinterpret_cast<const void*>(k), device, MAX_SMEM, smem, f);
  if (e != cudaSuccess) return e;
  const int resident = (f.per_sm > 0 ? f.per_sm : 1) * f.sms;
  k<<<a.tiles < resident ? a.tiles : resident, THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

template <int COUT_P>
int launch_mi(const Args& a, int mi, int B, cudaStream_t s, int device, int* report) {
  if constexpr (COUT_P <= 32) {
    if (mi == 4) return launch<COUT_P, 4>(a, B, s, device, report);
  }
  if constexpr (COUT_P <= 64) {
    if (mi == 2) return launch<COUT_P, 2>(a, B, s, device, report);
  }
  return launch<COUT_P, 1>(a, B, s, device, report);
}

int run(const Args& a, int cout_p, int B, cudaStream_t s, int device, int* report) {
  if (a.Cout > cout_p) return cudaErrorInvalidValue;
  const int mi = rows_per_warp(a, cout_p);
  if (mi == 0) return cudaErrorInvalidConfiguration;
  switch (cout_p) {
    case 8: return launch_mi<8>(a, mi, B, s, device, report);
    case 16: return launch_mi<16>(a, mi, B, s, device, report);
    case 32: return launch_mi<32>(a, mi, B, s, device, report);
    case 64: return launch_mi<64>(a, mi, B, s, device, report);
    case 128: return launch_mi<128>(a, mi, B, s, device, report);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

// ---- bf16, Cin / 8 a power of two: wgmma on TMA halo tiles ----------------

namespace wg {

using namespace rn::sm90;  // wg::desc, wg::tma_load, ... as tf names them

constexpr int TW = 14;       // output columns of a tile
constexpr int HWD = TW + 2;  // halo columns: one line of 16 A rows
constexpr int WARPGROUPS = WARPS / 4;

// The smem plan of one launch, byte offsets from the block's 1024-aligned
// base: [warpgroup][stage][c8][box] halo | [warpgroup][obox][obox_bytes]
// output staging | weights | one mbarrier per warpgroup and stage.
struct Plan {
  int mi = 0, stages = 0;
  int box_bytes = 0, stage_bytes = 0;        // one 8-channel box; a stage of c8 boxes
  int olg = 0, obox = 0, obox_bytes = 0;     // output boxes (0: each lane stores its values)
  int off_out = 0, off_w = 0, off_bar = 0;
  size_t smem = 0;
};

struct Args {
  const uint4* w;  // [nsp][Cout_p][8] bf16
  const float* bias;
  __nv_bfloat16* y;
  int Ho, Wo, Cout;
  int c8, nsp;  // 16-byte channel groups of a pixel (Cin / 8); K slices, 9 * c8 made even
  int tiles_w, tiles_h, tiles;
  Plan p;
};

// The 16-byte chunk `c` of pixel `p` in a TMA box whose pixel stride is
// 16 << lg bytes and whose swizzle span is that stride (lg = 0: none): TMA's
// 32/64/128-byte swizzle XORs the chunk index with bits 7.. of the offset.
__device__ __forceinline__ uint32_t swizzled(int p, int c, int lg) {
  return (static_cast<uint32_t>(p) << (4 + lg)) + ((c ^ ((p >> (3 - lg)) & ((1 << lg) - 1))) << 4);
}

// Each warpgroup walks its own tiles, half a tile behind the other, so
// one's epilogue overlaps the other's wgmma: tile rows 4*MI, MI wgmma blocks of
// 64 A rows, each 4 halo lines of 16 pixels (14 outputs, 2 discarded). Warp
// w % 4 holds the sums of line 4i + w % 4 of block i. The warpgroup's
// thread 0 issues its TMA copies.
template <int COUT_P, int MI>
__global__ void __launch_bounds__(THREADS, 2) conv_wg(const __grid_constant__ CUtensorMap xmap,
                                                      const __grid_constant__ CUtensorMap ymap,
                                                      const Args a) {
  constexpr int TH = 4 * MI;
  constexpr int NA = COUT_P / 2;  // accumulators of one m64 x Cout_p block per thread
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const Plan p = a.p;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gen = smem_raw + (base - raw);  // the same bytes, generic address
  uint4* sw = reinterpret_cast<uint4*>(gen + p.off_w);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0), wq = warp & 3;  // wg: warp-uniform
  const bool lead = (tid & 127) == 0;
  const uint32_t halo = base + wg * p.stages * p.stage_bytes;
  const uint32_t outs = base + p.off_out + wg * p.obox * p.obox_bytes;
  const uint32_t bar0 = base + p.off_bar + 8 * p.stages * wg;
  const int slot = 2 * blockIdx.x + wg, stride = 2 * gridDim.x;

  auto load_tile = [&](int t, int st) {  // the warpgroup's thread 0
    const int tw = t % a.tiles_w, r = t / a.tiles_w, th = r % a.tiles_h, b = r / a.tiles_h;
    const uint32_t bar = bar0 + 8 * st;
    mbar_expect_tx(bar, p.stage_bytes);
    for (int c = 0; c < a.c8; ++c)
      tma_load(halo + st * p.stage_bytes + c * p.box_bytes, &xmap, bar, 8 * c, tw * TW, th * TH, b);
  };
  auto wg_sync = [&] { asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory"); };

  if (lead) {
    for (int s = 0; s < p.stages; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Weights: a straight copy of the packed image (slice j = tap * c8 + c is
  // channel group c of tap (dy, dx)).
  for (int i = tid; i < a.nsp * COUT_P; i += THREADS) rn::cp_async16(sw + i, a.w + i, true);
  rn::cp_async_commit();
  __syncthreads();  // the barriers are initialised before any TMA signals them
  if (lead)
    for (int s = 0; s < p.stages; ++s)
      if (slot + s * stride < a.tiles) load_tile(slot + s * stride, s);
  rn::cp_async_wait<0>();
  fence_proxy_async();  // cp.async wrote the weights that wgmma reads
  __syncthreads();

  // B: slice 2s at 2s * Cout_p * 16 bytes, the k halves Cout_p * 16 apart,
  // groups of 8 output channels 128 apart.
  const uint64_t b0 = desc(base + p.off_w, COUT_P * 16, 128);
  const int g = lane >> 2, q = (lane & 3) * 2;
  const int steps = a.nsp / 2, lc = 31 - __clz(a.c8), box16 = p.box_bytes >> 4;  // c8 = 1 << lc (`takes`)

  int t = slot;
  if (wg == 1 && t < a.tiles) asm volatile("bar.sync 3, 256;\n" ::: "memory");
  for (int it = 0; t < a.tiles; ++it, t += stride) {
    const int st = it % p.stages;
    mbar_wait(bar0 + 8 * st, (it / p.stages) & 1);
    // A of block i, k16 step (tap, c): the 64 halo pixels from line 4i
    // shifted by the tap (dy * 16 + dx pixels, 16 bytes each) in chunk box
    // c, the second k half one box on (leading offset box_bytes), groups of 8
    // pixels 128 bytes apart. B of slices j, j + 1: j * Cout_p * 16 bytes on.
    // Where Cin = 8 a step's k halves are taps 2s and 2s + 1 (the padding
    // slice reads tap 8 again against zero weights): the leading offset is
    // the taps' distance.
    uint64_t a0[MI];
#pragma unroll
    for (int i = 0; i < MI; ++i)
      a0[i] = desc(halo + st * p.stage_bytes + i * 64 * 16, a.c8 == 1 ? 0 : p.box_bytes, 128);

    float acc[MI][NA];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
#pragma unroll
      for (int n = 0; n < NA; ++n) acc[i][n] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < MI; ++i) fence_operands(acc[i]);
    // One loop, no branch and nothing that touches the accumulators between
    // the fence and the commit: either makes ptxas serialize the wgmmas
    // (its info C7515).
    wgmma_fence();
    for (int s = 0; s < steps; ++s) {
      const int j = 2 * s, tap = j >> lc, c = j & (a.c8 - 1), t1 = tap + 1;
      const int toff = (tap / 3) * HWD + tap % 3;
      const int lbo = a.c8 == 1 && t1 < 9 ? (t1 / 3) * HWD + t1 % 3 - toff : 0;  // Cin = 8: the next tap
      const uint64_t da = (uint64_t)(toff + c * box16) | ((uint64_t)lbo << 16);
      const uint64_t db = b0 + (uint64_t)(j * COUT_P);
#pragma unroll
      for (int i = 0; i < MI; ++i) Wgmma<COUT_P>::run(acc[i], a0[i] + da, db);
    }
    wgmma_commit();
    // Once: warpgroup 1 starts its first tile after warpgroup 0 has issued
    // its first, so that, with equal work per tile, their epilogues keep
    // falling in each other's wgmmas.
    if (it == 0 && wg == 0 && slot + 1 < a.tiles) asm volatile("bar.arrive 3, 256;\n" ::: "memory");
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < MI; ++i) fence_operands(acc[i]);

    // The warpgroup is done with stage st, and its last TMA store has read
    // the staging tile: refill st, then stage this tile's output.
    if (lead) bulk_wait_read();
    wg_sync();
    const int tw = t % a.tiles_w, r = t / a.tiles_w, th = r % a.tiles_h, b = r / a.tiles_h;
    const int tn = t + p.stages * stride;
    if (lead && tn < a.tiles) load_tile(tn, st);

    // C fragment of block i, n8 block n: (A row g, channels 8n+q, +1) in
    // acc[i][4n], [4n+1], (row g + 8, the same) in [4n+2], [4n+3]; A row
    // g + 8hh of warp wq is column g + 8hh of tile row 4i + wq.
    if (p.obox > 0) {
#pragma unroll
      for (int i = 0; i < MI; ++i) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int col = g + hh * 8;
          if (col >= TW) continue;
          const int pix = (4 * i + wq) * TW + col;
#pragma unroll
          for (int n = 0; n < COUT_P / 8; ++n) {
            const int co = n * 8 + q;
            if (n * 8 >= a.Cout) continue;
            float v0 = acc[i][4 * n + 2 * hh], v1 = acc[i][4 * n + 2 * hh + 1];
            if (a.bias != nullptr) v0 = __fadd_rn(v0, a.bias[co]), v1 = __fadd_rn(v1, a.bias[co + 1]);
            const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
            const uint32_t addr = outs + (n >> p.olg) * p.obox_bytes +
                                  swizzled(pix, n & ((1 << p.olg) - 1), p.olg) + q * 2;
            st_shared(addr, *reinterpret_cast<const uint32_t*>(&v));
          }
        }
      }
      fence_proxy_async();  // the staging tile is read by TMA
      wg_sync();
      if (lead) {
        for (int ob = 0; ob < p.obox; ++ob)
          tma_store(&ymap, outs + ob * p.obox_bytes, ob << (3 + p.olg), tw * TW, th * TH, b);
        bulk_commit();
      }
    } else {
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int oh = th * TH + 4 * i + wq;
        if (oh >= a.Ho) continue;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int col = g + hh * 8, ow = tw * TW + col;
          if (col >= TW || ow >= a.Wo) continue;
          __nv_bfloat16* yp = a.y + (((size_t)b * a.Ho + oh) * a.Wo + ow) * a.Cout;
#pragma unroll
          for (int n = 0; n < COUT_P / 8; ++n) {
            const int co = n * 8 + q;
            float v0 = acc[i][4 * n + 2 * hh], v1 = acc[i][4 * n + 2 * hh + 1];
            if (a.bias != nullptr) {
              if (co < a.Cout) v0 = __fadd_rn(v0, a.bias[co]);
              if (co + 1 < a.Cout) v1 = __fadd_rn(v1, a.bias[co + 1]);
            }
            store2(yp, co, a.Cout, v0, v1);
          }
        }
      }
    }
  }
  if (lead) bulk_wait();  // the last stores have left shared memory
}

int up(int v, int m) { return (v + m - 1) / m * m; }

// log2 of the largest of 1, 2, 4, 8 that divides n.
int lg_chunks(int n) { return n % 8 == 0 ? 3 : n % 4 == 0 ? 2 : n % 2 == 0 ? 1 : 0; }

Plan layout(const Args& a, int cout_p, int mi, int stages) {
  Plan p;
  const int th = 4 * mi;
  p.mi = mi, p.stages = stages;
  p.box_bytes = (th + 2) * HWD * 16;  // a multiple of 128 bytes
  p.stage_bytes = a.c8 * p.box_bytes;
  if (a.Cout % 8 == 0) {
    p.olg = lg_chunks(a.Cout / 8);
    p.obox = (a.Cout / 8) >> p.olg;
    p.obox_bytes = up(th * TW * (16 << p.olg), 1024);  // 1024-aligned: the 128-byte swizzle's period
  }
  p.off_out = up(WARPGROUPS * stages * p.stage_bytes, 1024);
  p.off_w = p.off_out + WARPGROUPS * p.obox * p.obox_bytes;
  p.off_bar = p.off_w + a.nsp * cout_p * 16;
  p.smem = 1024 + p.off_bar + 8 * WARPGROUPS * stages;  // 1024: room to align the base
  return p;
}

// Rows per warp and stages for the packed Cout_p: the most rows the
// accumulators allow (64 per thread), then 3 stages before 2, whose shared
// memory still lets two blocks share an SM, else the first that fits at all
// (mi 0 if none does).
Plan plan(const Args& a, int cout_p) {
  const int mi_max = cout_p >= 128 ? 1 : (cout_p >= 64 ? 2 : 4);
  for (size_t limit : {(size_t)MAX_SMEM / 2 - 1024, (size_t)MAX_SMEM})
    for (int m = mi_max; m >= 1; m /= 2)
      for (int stages = 3; stages >= 2; --stages) {
        const Plan p = layout(a, cout_p, m, stages);
        if (p.smem <= limit) return p;
      }
  return Plan{};
}

template <int COUT_P, int MI>
int launch(Args a, const void* x, int B, int H, int W, int Cin, cudaStream_t s, int device, int* report) {
  const Plan& p = a.p;
  constexpr int TH = 4 * MI;
  if (report != nullptr) {
    fill(report, {kWgmma, COUT_P, MI, TH, TW, (int)p.smem, WARPGROUPS, p.stages, p.obox > 0,
                  p.obox > 0 && p.olg ? 16 << p.olg : 0});
    return cudaSuccess;
  }
  CUtensorMap xmap{}, ymap{};
  int e = encode(&xmap, x, B, H, W, Cin, 0, HWD, TH + 2, CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
  if (e == 0 && p.obox > 0)
    e = encode(&ymap, a.y, B, a.Ho, a.Wo, a.Cout, p.olg, TW, TH, CU_TENSOR_MAP_L2_PROMOTION_NONE);
  if (e != 0) return e;
  auto* k = conv_wg<COUT_P, MI>;
  Fit f;
  const cudaError_t fe = fit(reinterpret_cast<const void*>(k), device, MAX_SMEM, p.smem, f);
  if (fe != cudaSuccess) return fe;
  const int resident = (f.per_sm > 0 ? f.per_sm : 1) * f.sms, blocks = (a.tiles + 1) / 2;
  k<<<blocks < resident ? blocks : resident, THREADS, p.smem, s>>>(xmap, ymap, a);
  return cudaGetLastError();
}

template <int COUT_P>
int launch_mi(Args& a, const void* x, int B, int H, int W, int Cin, cudaStream_t s, int device,
              int* report) {
  a.tiles_w = (a.Wo + TW - 1) / TW;
  a.tiles_h = (a.Ho + 4 * a.p.mi - 1) / (4 * a.p.mi);
  a.tiles = a.tiles_w * a.tiles_h * B;
  if constexpr (COUT_P <= 32) {
    if (a.p.mi == 4) return launch<COUT_P, 4>(a, x, B, H, W, Cin, s, device, report);
  }
  if constexpr (COUT_P <= 64) {
    if (a.p.mi == 2) return launch<COUT_P, 2>(a, x, B, H, W, Cin, s, device, report);
  }
  return launch<COUT_P, 1>(a, x, B, H, W, Cin, s, device, report);
}

// Takes Cin / 8 a power of two: a k16 step's two slices lie in one tap (or
// are the two taps of Cin = 8), and the step loop finds the tap by a shift.
// A multiply by ceil(2^16 / c8) there, which would take Cin 48, 96 and 112
// too, made the main-path sites 7% slower in all on an H100.
bool takes(int Cin) { return Cin % 8 == 0 && ((Cin / 8) & (Cin / 8 - 1)) == 0; }

int run(const void* x, const void* w, const void* bias, void* y, int B, int H, int W, int Cin, int Cout,
        int cout_p, cudaStream_t s, int device, int* report) {
  if (Cout > cout_p) return cudaErrorInvalidValue;
  Args a;
  a.w = static_cast<const uint4*>(w);
  a.bias = static_cast<const float*>(bias);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.Ho = H - 2, a.Wo = W - 2, a.Cout = Cout;
  a.c8 = Cin / 8;
  a.nsp = (9 * a.c8 + 1) / 2 * 2;
  a.p = plan(a, cout_p);
  if (a.p.mi == 0) return cudaErrorInvalidConfiguration;
  switch (cout_p) {
    case 8: return launch_mi<8>(a, x, B, H, W, Cin, s, device, report);
    case 16: return launch_mi<16>(a, x, B, H, W, Cin, s, device, report);
    case 32: return launch_mi<32>(a, x, B, H, W, Cin, s, device, report);
    case 64: return launch_mi<64>(a, x, B, H, W, Cin, s, device, report);
    case 128: return launch_mi<128>(a, x, B, H, W, Cin, s, device, report);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace wg

// ---- f32, Cin % 8 == 0: TF32 passes over a hi/lo split, wgmma on TMA halo tiles

namespace tf {

constexpr int TW = wg::TW;    // output columns of a tile
constexpr int HWD = wg::HWD;  // halo columns: one line of 16 A rows
constexpr int WARPGROUPS = wg::WARPGROUPS;
constexpr int KB = 2;  // 4-channel TMA boxes of one K chunk: 8 input channels, one k8 step per tap
// Hi + lo weights of one Cout tile at most (ops/kernels/conv3x3.py:TF32_W_MAX,
// which picks NT so that they fit).
constexpr int W_MAX = 147456;

// The smem plan of one launch, byte offsets from the block's 1024-aligned
// base: [warpgroup][stage][KB][box] halo (TMA; rewritten in place as hi) |
// [warpgroup][KB][box] lo twin | weights (pack_tf32x3's image of one Cout
// tile) | one mbarrier per warpgroup and stage.
struct Plan {
  int mi = 0, stages = 0;
  int box_bytes = 0, chunk_bytes = 0;  // one 4-channel box; the KB boxes of a stage
  int off_lo = 0, off_w = 0, off_bar = 0;
  size_t smem = 0;
};

struct Args {
  const uint4* w;  // [Cout tile][slice][hi, lo][NT][4] f32 holding TF32 values
  const float* bias;
  float* y;
  int Ho, Wo, Cout;
  int chunks, nsp;  // K chunks (Cin / 8); slices of 4 channels (9 * Cin / 4)
  int tiles_w, tiles_h, tiles;
  Plan p;
};

// Tf32<N>::run(d, da, db, scale_d): one wgmma.mma_async.m64nNk8, TF32 in,
// the f32 sums accumulated in d (scale_d 1) or written to it (0); A (64 x 8)
// and B (8 x N) read from shared memory through the descriptors da and db,
// both K-major (TF32 has no other).
template <int N> struct Tf32;
template <> struct Tf32<16> {
  __device__ static void run(float (&d)[8], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <> struct Tf32<32> {
  __device__ static void run(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <> struct Tf32<64> {
  __device__ static void run(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <> struct Tf32<128> {
  __device__ static void run(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// v rounded to TF32, to nearest with ties away from zero, its 13 low
// mantissa bits zero (the bits wgmma reads).
__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r & 0xFFFFE000u;
}
// v = hi + lo to f32 accuracy: hi = tf32(v), lo = tf32(v - hi); lo is 0
// where v - hi is not finite, so NaN stays NaN (in hi) and an infinity is
// not made NaN. ops/kernels/conv3x3.py:tf32_split is its twin.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  const float r = __fsub_rn(v, __uint_as_float(hi));
  lo = tf32(fabsf(r) < __int_as_float(0x7f800000) ? r : 0.f);
}

// Each warpgroup walks its own tiles of 4*MI rows x 14 columns, half a tile
// behind the other, and each tile in K chunks of 8 input channels: one halo
// stage per chunk (two 4-channel TMA boxes of 4*MI+2 lines of 16 pixels),
// ring of `stages` per warpgroup. Once a stage lands, the warpgroup splits it
// in place into hi and its lo twin, then issues, per tap and m64 block, the
// four products lo_a*lo_b, lo_a*hi_b, hi_a*lo_b and hi_a*hi_b as two wgmmas
// of N = 2 * NT over B = [hi | lo]: lo_a*[hi | lo], then hi_a*[hi | lo], each
// reading its A tile once, the hi-weight products summed in the
// accumulator's first NT columns and the lo-weight ones in the last NT, the
// chunk's first product overwriting it. It waits for the chunk (its thread 0
// then refills the stage) and adds the chunk's sums into f32 registers,
// rounded to nearest, smallest first (the lo-weight columns, then the
// hi-weight ones): the tensor cores' accumulation truncates, and over Cin
// 128's 432 wgmmas of three passes the truncations summed to 1e-4 (max |d|
// at site 7, H100); over a chunk's they stay at f32's own rounding. The
// other warpgroup's wgmmas fill the tensor cores meanwhile. The block holds
// Cout tile blockIdx.y's hi and lo weights.
template <int NT, int MI>
__global__ void __launch_bounds__(THREADS, 1) conv_tf32x3(const __grid_constant__ CUtensorMap xmap,
                                                          const Args a) {
  constexpr int TH = 4 * MI;
  constexpr int NB = 2 * NT;                // N of one wgmma: [hi | lo]
  constexpr int NA = NB / 2, NS = NT / 2;  // a thread's accumulators of one m64 block; its f32 sums
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const Plan p = a.p;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gen = smem_raw + (base - raw);  // the same bytes, generic address
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wt = tid & 127;
  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0), wq = warp & 3;  // wg: warp-uniform
  const bool lead = wt == 0;
  const int off_halo = wg * p.stages * p.chunk_bytes, ls = p.off_lo + wg * p.chunk_bytes;
  const uint32_t bar0 = base + p.off_bar + 8 * p.stages * wg;
  const int slot = 2 * blockIdx.x + wg, stride = 2 * gridDim.x, ct = blockIdx.y;
  const int items = slot < a.tiles ? ((a.tiles - 1 - slot) / stride + 1) * a.chunks : 0;

  auto load_item = [&](int it, int st) {  // the warpgroup's thread 0
    const int t = slot + it / a.chunks * stride, k = it % a.chunks;
    const int tw = t % a.tiles_w, r = t / a.tiles_w, th = r % a.tiles_h, b = r / a.tiles_h;
    const uint32_t bar = bar0 + 8 * st, dst = base + off_halo + st * p.chunk_bytes;
    wg::mbar_expect_tx(bar, p.chunk_bytes);
#pragma unroll
    for (int c = 0; c < KB; ++c)
      wg::tma_load(dst + c * p.box_bytes, &xmap, bar, 4 * (KB * k + c), tw * TW, th * TH, b);
  };
  auto wg_sync = [&] { asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory"); };

  if (lead) {
    for (int s = 0; s < p.stages; ++s) wg::mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Weights: Cout tile ct's packed image as it is (slice j = (chunk * 9 +
  // tap) * KB + box, [hi, lo][NT][4] each).
  const int wunits = 2 * a.nsp * NT;
  uint4* sw = reinterpret_cast<uint4*>(gen + p.off_w);
  for (int i = tid; i < wunits; i += THREADS) rn::cp_async16(sw + i, a.w + (size_t)ct * wunits + i, true);
  rn::cp_async_commit();
  __syncthreads();  // the barriers are initialised before any TMA signals them
  if (lead)
    for (int s = 0; s < p.stages && s < items; ++s) load_item(s, s);
  rn::cp_async_wait<0>();
  wg::fence_proxy_async();  // cp.async wrote the weights that wgmma reads
  __syncthreads();

  // B of chunk k, tap: slices (k * 9 + tap) * KB and the next, NB * 16 bytes
  // apart (the k halves), groups of 8 rows 128 apart: rows 0 to NT - 1 the hi
  // weights of the tile's NT output channels, NT to 2 NT - 1 their lo.
  const uint64_t bw = wg::desc(base + p.off_w, NB * 16, 128);
  const int g = lane >> 2, q = (lane & 3) * 2;
  float acc[MI][NA], sum[MI][NS];  // one chunk's sums (wgmma); the tile's (f32, rounded to nearest)
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int n = 0; n < NA; ++n) acc[i][n] = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) sum[i][n] = 0.f;
  }

  if (wg == 1 && items > 0) asm volatile("bar.sync 3, 256;\n" ::: "memory");
  int it = 0;
  for (int t = slot; t < a.tiles; t += stride) {
    for (int k = 0; k < a.chunks; ++k, ++it) {
      const int st = it % p.stages, hs = off_halo + st * p.chunk_bytes;
      wg::mbar_wait(bar0 + 8 * st, (it / p.stages) & 1);
      // The split: hi over the stage, lo into the twin (the chunk before,
      // its last reader, is done).
      for (int i = wt; i < p.chunk_bytes / 16; i += 128) {
        const float4 v = *reinterpret_cast<const float4*>(gen + hs + 16 * i);
        uint4 h, l;
        split(v.x, h.x, l.x);
        split(v.y, h.y, l.y);
        split(v.z, h.z, l.z);
        split(v.w, h.w, l.w);
        *reinterpret_cast<uint4*>(gen + hs + 16 * i) = h;
        *reinterpret_cast<uint4*>(gen + ls + 16 * i) = l;
      }
      wg::fence_proxy_async();  // wgmma reads what this thread wrote
      wg_sync();
      // A of block i, tap (dy, dx): the 64 halo pixels from line 4i shifted
      // by dy * 16 + dx pixels (16 bytes each) in box 0, the second k half
      // one box on (leading offset box_bytes), groups of 8 pixels 128 bytes
      // apart. Rows of the 2 columns past the tile's 14 may read 2 pixels
      // past the last box: their sums are discarded.
      const uint64_t ah = wg::desc(base + hs, p.box_bytes, 128), al = wg::desc(base + ls, p.box_bytes, 128);
      const uint64_t bk = (uint64_t)(k * 9 * KB * NB);
      // Nothing touches the accumulators between the fence and the commit
      // (ptxas would serialize the wgmmas otherwise, its info C7515).
      wg::wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const uint64_t db = bk + (uint64_t)(tap * KB * NB);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const uint64_t da = (uint64_t)((tap / 3) * HWD + tap % 3 + i * 64);
          Tf32<NB>::run(acc[i], al + da, bw + db, tap > 0);
          Tf32<NB>::run(acc[i], ah + da, bw + db, 1);
        }
      }
      wg::wgmma_commit();
      // Once: warpgroup 1 starts after warpgroup 0 has issued half a tile,
      // so that their epilogues fall in each other's wgmmas.
      if (it == a.chunks / 2 && wg == 0 && slot + 1 < a.tiles) asm volatile("bar.arrive 3, 256;\n" ::: "memory");
      wg::wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < MI; ++i) wg::fence_operands(acc[i]);
      // The chunk is done with its stage: refill it; then add its sums (the
      // lo-weight columns n8 blocks NT / 8 on, registers NS on).
      if (lead && it + p.stages < items) load_item(it + p.stages, st);
#pragma unroll
      for (int i = 0; i < MI; ++i) {
#pragma unroll
        for (int n = 0; n < NS; ++n)
          sum[i][n] = __fadd_rn(__fadd_rn(sum[i][n], acc[i][n + NS]), acc[i][n]);
      }
    }

    // C fragment of block i, n8 block n: (A row g, channels 8n+q, +1) in
    // sum[i][4n], [4n+1], (row g + 8, the same) in [4n+2], [4n+3]; A row
    // g + 8hh of warp wq is column g + 8hh of tile row 4i + wq. Each lane
    // stores its two channels: 8 lanes of a pixel fill 32-byte sectors.
    const int tw = t % a.tiles_w, r = t / a.tiles_w, th = r % a.tiles_h, b = r / a.tiles_h;
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int oh = th * TH + 4 * i + wq;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int col = g + hh * 8, ow = tw * TW + col;
        if (oh >= a.Ho || col >= TW || ow >= a.Wo) continue;
        float* yp = a.y + (((size_t)b * a.Ho + oh) * a.Wo + ow) * a.Cout;
#pragma unroll
        for (int n = 0; n < NT / 8; ++n) {
          const int co = ct * NT + n * 8 + q;
          float v0 = sum[i][4 * n + 2 * hh], v1 = sum[i][4 * n + 2 * hh + 1];
          if (a.bias != nullptr) {
            if (co < a.Cout) v0 = __fadd_rn(v0, a.bias[co]);
            if (co + 1 < a.Cout) v1 = __fadd_rn(v1, a.bias[co + 1]);
          }
          if (co + 1 < a.Cout && (a.Cout & 1) == 0) {
            *reinterpret_cast<float2*>(yp + co) = make_float2(v0, v1);
          } else {
            if (co < a.Cout) yp[co] = v0;
            if (co + 1 < a.Cout) yp[co + 1] = v1;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MI; ++i) {
#pragma unroll
      for (int n = 0; n < NS; ++n) sum[i][n] = 0.f;
    }
  }
}

Plan layout(int nsp, int nt, int mi, int stages) {
  Plan p;
  p.mi = mi, p.stages = stages;
  p.box_bytes = (4 * mi + 2) * HWD * 16;  // a multiple of 256 bytes
  p.chunk_bytes = KB * p.box_bytes;
  p.off_lo = WARPGROUPS * stages * p.chunk_bytes;
  p.off_w = p.off_lo + WARPGROUPS * p.chunk_bytes;
  p.off_bar = p.off_w + 2 * nsp * nt * 16;
  p.smem = 1024 + p.off_bar + 8 * WARPGROUPS * stages;  // 1024: room to align the base
  return p;
}

// Blocks per warpgroup and stages for the packed NT: the most m64 blocks
// whose accumulators (NT a thread and block at N = 2 * NT) and f32 sums (NT /
// 2) ptxas holds without spills, then 4 stages before 3 and 2 (mi 0 if
// nothing fits). That is 192 registers of them at 4 blocks of NT 32 and at 2
// of NT 64 (215 and 221 in all, no spills, sm_90a). On an H100 at batch 256,
// 4 blocks beat 2 at sites 2, 3 and 5 (3.43 / 2.99 / 2.80 ms against 3.64 /
// 3.28 / 2.90; site 6 1.37 against 1.53, site 1 alone the other way, 1.13
// against 1.05: one K chunk a tile), sites 1-9 17.74 against 18.43 ms; 2
// blocks beat 1 at site 4 (5.13 against 5.64). Blocks before stages: 4
// blocks and 3 stages beat 2 blocks and 4 by 3-10% at Cin 64 and 128 (H100,
// four wgmmas a tap).
Plan plan(int nsp, int nt) {
  const int mi_max = nt >= 64 ? 2 : 4;
  for (int m = mi_max; m >= 1; m /= 2)
    for (int stages : {4, 3, 2}) {
      const Plan p = layout(nsp, nt, m, stages);
      if (p.smem <= (size_t)MAX_SMEM) return p;
    }
  return Plan{};
}

template <int NT, int MI>
int launch(Args a, const void* x, int B, int H, int W, int Cin, cudaStream_t s, int device, int* report) {
  const Plan& p = a.p;
  constexpr int TH = 4 * MI;
  const int ny = (a.Cout + NT - 1) / NT;
  if (report != nullptr) {
    fill(report, {kTf32x3, NT, MI, TH, TW, (int)p.smem, WARPGROUPS, p.stages, 0, 0, ny, 4 * KB, 2});
    return cudaSuccess;
  }
  CUtensorMap xmap{};
  const int e = wg::encode(&xmap, x, B, H, W, Cin, 0, HWD, TH + 2, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                           CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (e != 0) return e;
  auto* k = conv_tf32x3<NT, MI>;
  Fit f;
  const cudaError_t fe = fit(reinterpret_cast<const void*>(k), device, MAX_SMEM, p.smem, f);
  if (fe != cudaSuccess) return fe;
  // Persistent: every block resident at once, so the Cout tiles of one
  // output tile run close together and read its halo from L2.
  const int resident = (f.per_sm > 0 ? f.per_sm : 1) * f.sms, per_y = resident / ny > 0 ? resident / ny : 1;
  const int blocks = (a.tiles + 1) / 2;
  k<<<dim3(blocks < per_y ? blocks : per_y, ny), THREADS, p.smem, s>>>(xmap, a);
  return cudaGetLastError();
}

template <int NT>
int launch_mi(Args& a, const void* x, int B, int H, int W, int Cin, cudaStream_t s, int device,
              int* report) {
  a.tiles_w = (a.Wo + TW - 1) / TW;
  a.tiles_h = (a.Ho + 4 * a.p.mi - 1) / (4 * a.p.mi);
  a.tiles = a.tiles_w * a.tiles_h * B;
  if constexpr (NT <= 32) {
    if (a.p.mi == 4) return launch<NT, 4>(a, x, B, H, W, Cin, s, device, report);
  }
  if (a.p.mi == 2) return launch<NT, 2>(a, x, B, H, W, Cin, s, device, report);
  return launch<NT, 1>(a, x, B, H, W, Cin, s, device, report);
}

// Takes Cin a multiple of 8 up to 256 (ops/kernels/conv3x3.py:tf32_takes): a
// K chunk is 8 channels, its taps a loop the compiler unrolls (no tap is
// found by arithmetic on Cin), and one Cout tile's weights fit at NT = 8.
bool takes(int Cin) { return Cin % 8 == 0 && Cin <= 256; }

int run(const void* x, const void* w, const void* bias, void* y, int B, int H, int W, int Cin, int Cout, int nt,
        cudaStream_t s, int device, int* report) {
  if ((nt != 8 && nt != 16 && nt != 32 && nt != 64) || 72 * Cin * nt > W_MAX) return cudaErrorInvalidValue;
  Args a;
  a.w = static_cast<const uint4*>(w);
  a.bias = static_cast<const float*>(bias);
  a.y = static_cast<float*>(y);
  a.Ho = H - 2, a.Wo = W - 2, a.Cout = Cout;
  a.chunks = Cin / 8;
  a.nsp = 9 * Cin / 4;
  a.p = plan(a.nsp, nt);
  if (a.p.mi == 0) return cudaErrorInvalidConfiguration;
  switch (nt) {
    case 8: return launch_mi<8>(a, x, B, H, W, Cin, s, device, report);
    case 16: return launch_mi<16>(a, x, B, H, W, Cin, s, device, report);
    case 32: return launch_mi<32>(a, x, B, H, W, Cin, s, device, report);
    default: return launch_mi<64>(a, x, B, H, W, Cin, s, device, report);
  }
}

}  // namespace tf

// ---- f32: full f32 on CUDA cores --------------------------------------------

namespace cc {

struct Args {
  const float* x;
  const float4* w;  // [Cout tile][chunk][tap][4][NT] f32
  const float* bias;
  float* y;
  int H, W, Cin, Cout, Ho, Wo;
  int nchunks;  // ceil(Cin / 4)
  int tiles_w;
};

// NT output channels per block (8 per thread), warps of WC columns x 32/WC
// strips of 8 rows; the tile is TH x WC.
template <int NT, int WC>
struct Tile {
  static constexpr int CG = NT / 8;  // channel groups, one per warp
  static constexpr int SUB = 32 / WC;
  static constexpr int TW = WC;
  static constexpr int TH = (WARPS / CG) * SUB * 8;
  static constexpr int HWD = TW + 2;
  static constexpr int HALO = (TH + 2) * HWD;  // float4 units: 4 channels of a pixel
  static constexpr int WU = 9 * NT;            // float4 units of a chunk's weights
  static constexpr size_t SMEM = 2 * 16 * (size_t)(HALO + WU);
};

template <int NT, int WC>
__global__ void __launch_bounds__(THREADS, 2) conv_f32(const Args a) {
  using L = Tile<NT, WC>;
  extern __shared__ float4 fsm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = warp % L::CG, strip = warp / L::CG;
  const int col = lane % WC, sub = lane / WC;
  const int r0 = (strip * L::SUB + sub) * 8;  // first of this thread's 8 rows
  const int b = blockIdx.z, nt = blockIdx.y;
  const int th = blockIdx.x / a.tiles_w, tw = blockIdx.x - th * a.tiles_w;
  const int h0 = th * L::TH, w0 = tw * L::TW;
  const float* xb = a.x + (size_t)b * a.H * a.W * a.Cin;
  const float4* wb = a.w + (size_t)nt * a.nchunks * L::WU;

  auto load = [&](int c, int st) {
    float4* dh = fsm + st * (L::HALO + L::WU);
    float4* dw = dh + L::HALO;
    for (int i = tid; i < L::HALO; i += THREADS) {
      const int hr = i / L::HWD, hc = i - hr * L::HWD;
      const int gh = h0 + hr, gw = w0 + hc;
      const bool in = gh < a.H && gw < a.W;
      const float* src = xb + ((size_t)gh * a.W + gw) * a.Cin + c * 4;
      if ((a.Cin & 3) == 0) {
        rn::cp_async16(dh + i, in ? src : a.x, in);
      } else {  // conv 0's 3 channels: element loads, zero-padded to 4
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = (in && c * 4 + e < a.Cin) ? src[e] : 0.f;
        dh[i] = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    for (int i = tid; i < L::WU; i += THREADS) rn::cp_async16(dw + i, wb + c * L::WU + i, true);
  };

  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int o = 0; o < 8; ++o) acc[p][o] = 0.f;

  load(0, 0);
  rn::cp_async_commit();
  for (int c = 0; c < a.nchunks; ++c) {
    if (c + 1 < a.nchunks) load(c + 1, (c + 1) & 1);
    rn::cp_async_commit();
    rn::cp_async_wait<1>();
    __syncthreads();
    const float4* hx = fsm + (c & 1) * (L::HALO + L::WU) + r0 * L::HWD + col;
    const float4* hw = fsm + (c & 1) * (L::HALO + L::WU) + L::HALO + cg * 2;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - dy * 3;
      float4 xv[8];
#pragma unroll
      for (int p = 0; p < 8; ++p) xv[p] = hx[(p + dy) * L::HWD + dx];
#pragma unroll
      for (int ci = 0; ci < 4; ++ci) {
        const float4 lo = hw[(tap * 4 + ci) * (NT / 4)], hi = hw[(tap * 4 + ci) * (NT / 4) + 1];
        const float wv[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          const float xc = ci == 0 ? xv[p].x : (ci == 1 ? xv[p].y : (ci == 2 ? xv[p].z : xv[p].w));
#pragma unroll
          for (int o = 0; o < 8; ++o) acc[p][o] = fmaf(xc, wv[o], acc[p][o]);
        }
      }
    }
    __syncthreads();  // the buffer just read is the next prefetch's target
  }
  rn::cp_async_wait<0>();

  const int ow = w0 + col, co0 = nt * NT + cg * 8;
  if (ow >= a.Wo || co0 >= a.Cout) return;
  float bv[8];
#pragma unroll
  for (int o = 0; o < 8; ++o) bv[o] = (a.bias != nullptr && co0 + o < a.Cout) ? a.bias[co0 + o] : 0.f;
  const bool vec = (a.Cout & 3) == 0 && co0 + 8 <= a.Cout;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int oh = h0 + r0 + p;
    if (oh >= a.Ho) break;
    float v[8];
#pragma unroll
    for (int o = 0; o < 8; ++o) v[o] = a.bias != nullptr ? __fadd_rn(acc[p][o], bv[o]) : acc[p][o];
    float* yp = a.y + (((size_t)b * a.Ho + oh) * a.Wo + ow) * a.Cout + co0;
    if (vec) {
      reinterpret_cast<float4*>(yp)[0] = make_float4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<float4*>(yp)[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
#pragma unroll
      for (int o = 0; o < 8; ++o)
        if (co0 + o < a.Cout) yp[o] = v[o];
    }
  }
}

Args make_args(const void* x, const void* w, const void* bias, void* y, int H, int W, int Cin,
               int Cout) {
  Args a;
  a.x = static_cast<const float*>(x);
  a.w = static_cast<const float4*>(w);
  a.bias = static_cast<const float*>(bias);
  a.y = static_cast<float*>(y);
  a.H = H, a.W = W, a.Cin = Cin, a.Cout = Cout, a.Ho = H - 2, a.Wo = W - 2;
  a.nchunks = (Cin + 3) / 4;
  return a;
}

// Output pixels computed (the padded tile area) at warp width wc.
long long padded(const Args& a, int nt, int wc) {
  const int th = (WARPS / (nt / 8)) * (32 / wc) * 8;
  return (long long)((a.Ho + th - 1) / th * th) * ((a.Wo + wc - 1) / wc * wc);
}

template <int NT, int WC>
int launch(Args a, int B, cudaStream_t s, int device, int* report) {
  using L = Tile<NT, WC>;
  if (report != nullptr) {
    fill(report, {kF32, NT, WC, L::TH, L::TW, (int)L::SMEM, 0, 2});
    return cudaSuccess;
  }
  auto* k = conv_f32<NT, WC>;
  Fit f;
  const cudaError_t e = fit(reinterpret_cast<const void*>(k), device, (int)L::SMEM, L::SMEM, f);
  if (e != cudaSuccess) return e;
  a.tiles_w = (a.Wo + L::TW - 1) / L::TW;
  const int tiles_h = (a.Ho + L::TH - 1) / L::TH;
  dim3 grid(a.tiles_w * tiles_h, (a.Cout + NT - 1) / NT, B);
  k<<<grid, THREADS, L::SMEM, s>>>(a);
  return cudaGetLastError();
}

// The warp width for the packed NT: the one that computes the fewer padded
// pixels.
template <int NT>
int launch_wc(const Args& a, int B, cudaStream_t s, int device, int* report) {
  if constexpr (NT >= 16) {
    if (padded(a, NT, 16) < padded(a, NT, 32)) return launch<NT, 16>(a, B, s, device, report);
  }
  return launch<NT, 32>(a, B, s, device, report);
}

int run(const Args& a, int nt, int B, cudaStream_t s, int device, int* report) {
  switch (nt) {
    case 8: return launch_wc<8>(a, B, s, device, report);
    case 16: return launch_wc<16>(a, B, s, device, report);
    case 32: return launch_wc<32>(a, B, s, device, report);
    case 64: return launch_wc<64>(a, B, s, device, report);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace cc

// ---- bf16, padded, strided or with an epilogue: weights streamed ----------

namespace streamed {

// igemm.cuh's implicit GEMM at k = 3: the weights stream through shared
// memory a K step (one tap x 64 input channels) at a time, Cout in tiles of
// BN over blocks, the zero padding from the TMA's out-of-bounds fill.
template <int BN>
__global__ void __launch_bounds__(rn::igemm::THREADS, 2)
    conv_wg_stream(const __grid_constant__ rn::igemm::Maps maps, const rn::igemm::Args a) {
  rn::igemm::body<BN>(maps, a);
}

int run(const void* x, const void* w, const void* bias, const void* res, void* y, int B, int H, int W, int Cin,
        int Cout, int pad, int stride, int relu, int bn, int device, cudaStream_t s, int* report) {
  rn::igemm::Args a;
  rn::igemm::Plan p;
  rn::igemm::Maps maps;
  const int e = rn::igemm::prepare(x, w, bias, res, y, B, H, W, Cin, Cout, 3, pad, stride, relu, bn, a, p,
                                   report != nullptr ? nullptr : &maps);
  if (e != 0) return e;
  if (report != nullptr) {
    fill(report, {kStream, p.bn, p.nb, p.th, p.tw, (int)p.smem, 2, p.stages, 0, 0, a.tiles_n, rn::igemm::BK, 0});
    return cudaSuccess;
  }
  return p.bn == 128 ? rn::igemm::launch(conv_wg_stream<128>, maps, a, p, device, s)
                     : rn::igemm::launch(conv_wg_stream<64>, maps, a, p, device, s);
}

}  // namespace streamed

int dispatch(const void* x, const void* w, const void* bias, void* y, int B, int H, int W,
             int Cin, int Cout, int cp, int dtype, int device, cudaStream_t s, int* report) {
  if (dtype == rn::kBF16) {
    if (wg::takes(Cin)) return wg::run(x, w, bias, y, B, H, W, Cin, Cout, cp, s, device, report);
    return tc::run(tc::make_args(x, w, bias, y, H, W, Cin, Cout), cp, B, s, device, report);
  }
  if (tf::takes(Cin)) return tf::run(x, w, bias, y, B, H, W, Cin, Cout, cp, s, device, report);
  return cc::run(cc::make_args(x, w, bias, y, H, W, Cin, Cout), cp, B, s, device, report);
}

}  // namespace

// x (B,H,W,Cin) in the io dtype; w the packed weights of
// ops/kernels/conv3x3.py (pack_bf16, pack_tf32x3 or pack_f32, by dtype and
// Cin) and cp their Cout_p (bf16, w's dim 1) or NT (f32: pack_tf32x3's dim 3,
// pack_f32's last dim); bias (Cout,) f32 or
// null; y (B,H-2,W-2,Cout) in the io dtype. All contiguous, 16-byte aligned.
// bf16 with Cin / 8 a power of two takes the wgmma + TMA path, other bf16 mma.sync;
// f32 with Cin % 8 == 0 (up to 256) TF32 passes over a hi/lo split on wgmma (pack_tf32x3's
// layout, cp its NT), other f32 the CUDA cores.
extern "C" int rn_conv3x3(const void* x, const void* w, const void* bias, void* y, int B, int H,
                          int W, int Cin, int Cout, int cp, int dtype, int device, void* stream) {
  rn::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  return dispatch(x, w, bias, y, B, H, W, Cin, Cout, cp, dtype, device,
                  static_cast<cudaStream_t>(stream), nullptr);
}

// The variant rn_conv3x3 launches for one shape (the same dispatch, stopped
// before the launch), for reports: out[REPORT] as `fill` lays it out; every
// variant runs 256 threads. Returns 0, or the error rn_conv3x3 would return.
extern "C" int rn_conv3x3_variant(int H, int W, int Cin, int Cout, int cp, int dtype, int* out) {
  return dispatch(nullptr, nullptr, nullptr, nullptr, 1, H, W, Cin, Cout, cp, dtype, -1, nullptr,
                  out);
}

// The streamed path (igemm.cuh): y = relu?(conv(x, w) + bias + res?), bf16,
// 3x3 with zero padding `pad` and stride 1 or 2, Cin a multiple of 64; w
// packed by ops/kernels/conv3x3.py:pack_stream in Cout tiles of bn (its dim
// 2; Cout a multiple of it); bias (Cout,) f32 or null; res like y or null; y
// (B, Ho, Wo, Cout), Ho = (H + 2 pad - 3) / stride + 1. All contiguous,
// 16-byte aligned.
extern "C" int rn_conv3x3_stream(const void* x, const void* w, const void* bias, const void* res, void* y, int B,
                                 int H, int W, int Cin, int Cout, int pad, int stride, int relu, int bn,
                                 int device, void* stream) {
  rn::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  return streamed::run(x, w, bias, res, y, B, H, W, Cin, Cout, pad, stride, relu, bn, device,
                       static_cast<cudaStream_t>(stream), nullptr);
}

// rn_conv3x3_variant's report for the streamed path: path kStream, BN, images
// a tile (in `sub`), the tile's rows and columns, shared memory, consumer
// warpgroups, stages, Cout tiles and the K step's input channels (in `chunk`).
extern "C" int rn_conv3x3_stream_variant(int B, int H, int W, int Cin, int Cout, int pad, int stride, int bn,
                                         int* out) {
  return streamed::run(nullptr, nullptr, nullptr, nullptr, nullptr, B, H, W, Cin, Cout, pad, stride, 0, bn, -1,
                       nullptr, out);
}
