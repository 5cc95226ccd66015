// 3x3 VALID convolution, stride 1, NHWC x HWIO -> NHWC, f32 accumulation,
// with an optional per-Cout f32 bias (the folded preprocess of conv 0).
//
// Replaces roomnet_tpu/ops/pallas/conv_b2.py:conv3x3_pallas (an im2col MXU
// matmul over 8-row tiles). It is an implicit GEMM: M = the output pixels of
// a tile, N = Cout, K = 9 * Cin, with the nine taps read as shifted views of
// one input halo tile in shared memory (no im2col buffer). What bounds it on
// an H100: bytes in bf16 (tensor cores do the ~4.5 GFLOP per image faster
// than HBM delivers the activations), operations in f32 (CUDA cores).
//
// bf16 (`conv_tc`): tensor cores, mma.sync.m16n8k16 (bf16 in, f32 sums) fed
// by ldmatrix. A persistent block holds all of Cout's weights in shared
// memory for its life (the largest, 3x3x64x128, is 147 KB) and walks over
// output tiles of (8*MI) rows x 16 columns; the input halo of the next tile
// is fetched with 16-byte cp.async into a second buffer while the current
// one is computed, once for all of Cout. K is cut into slices of 8 input
// channels of one tap (16 bytes per pixel), two slices per k16 step, so
// Cin = 3 or 8 wastes no half-empty k16 step on a whole tap; an odd slice
// count is padded with a zero slice. The halo's pixel stride in 16-byte
// units is odd and the weights are slice-major, so each ldmatrix phase of 8
// rows hits 8 distinct bank groups at any tap offset. Warp w computes rows
// w*MI .. w*MI+MI-1 of the tile (one m16 tile = 16 columns of one row) for
// all of Cout. The weights arrive packed by ops/kernels/conv3x3.py:pack_bf16
// as [slice][Cout_p][8] (the shared-memory image).
//
// f32 (`conv_f32`): full f32 on CUDA cores, no TF32. K is staged in chunks
// of 4 input channels (the halo chunk and its 9 x 4 x NT weights, 16-byte
// cp.async, two buffers so chunk c+1 loads while chunk c computes). Each
// thread keeps 8 rows x 8 output channels of sums in registers; per tap it
// reads 8 float4 of inputs (its 8 rows, 4 channels) and 8 float4 of
// weights (a warp-wide broadcast) for 256 FMAs. Cout is split over
// blockIdx.y in tiles of NT channels. Weights are packed by
// ops/kernels/conv3x3.py:pack_f32 as [Cout tile][chunk][tap][4][NT].
//
// The packed layout is decided in Python alone: the caller passes its Cout_p
// (bf16) or NT (f32), read off the packed tensor's shape, and this file only
// picks the tile (rows per warp, warp width) that goes with it.
//
// Epilogue (both): sum + bias in f32, then one rounding to the io dtype, as
// ops/kernels/conv3x3.py:conv3x3_plain rounds.
#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SMEM = 232448;  // a block's dynamic shared memory on sm_90

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

// What one launch runs, for reports: report[5] = {Cout_p (bf16) or NT (f32),
// rows per warp (bf16) or warp width (f32), tile rows, tile columns, dynamic
// shared memory bytes}. A launch given a report fills it and launches nothing.
void fill(int* report, int cp, int sub, int rows, int cols, size_t smem) {
  report[0] = cp, report[1] = sub, report[2] = rows, report[3] = cols, report[4] = (int)smem;
}

// ---- bf16: implicit GEMM on tensor cores ------------------------------------

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

__device__ __forceinline__ void store2(__nv_bfloat16* p, int co, int cout, float v0, float v1) {
  if (co + 1 < cout && (cout & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p + co) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (co < cout) p[co] = __float2bfloat16_rn(v0);
    if (co + 1 < cout) p[co + 1] = __float2bfloat16_rn(v1);
  }
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
    fill(report, COUT_P, MI, WARPS * MI, TW, smem);
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
    fill(report, NT, WC, L::TH, L::TW, L::SMEM);
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

int dispatch(const void* x, const void* w, const void* bias, void* y, int B, int H, int W,
             int Cin, int Cout, int cp, int dtype, int device, cudaStream_t s, int* report) {
  if (dtype == rn::kBF16)
    return tc::run(tc::make_args(x, w, bias, y, H, W, Cin, Cout), cp, B, s, device, report);
  return cc::run(cc::make_args(x, w, bias, y, H, W, Cin, Cout), cp, B, s, device, report);
}

}  // namespace

// x (B,H,W,Cin) in the io dtype; w the packed weights of
// ops/kernels/conv3x3.py (pack_bf16 or pack_f32, by dtype) and cp their
// Cout_p (bf16, w's dim 1) or NT (f32, w's last dim); bias (Cout,) f32 or
// null; y (B,H-2,W-2,Cout) in the io dtype. All contiguous, 16-byte aligned.
extern "C" int rn_conv3x3(const void* x, const void* w, const void* bias, void* y, int B, int H,
                          int W, int Cin, int Cout, int cp, int dtype, int device, void* stream) {
  rn::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  return dispatch(x, w, bias, y, B, H, W, Cin, Cout, cp, dtype, device,
                  static_cast<cudaStream_t>(stream), nullptr);
}

// The variant rn_conv3x3 launches for one shape (the same dispatch, stopped
// before the launch), for reports: out[5] as `fill` lays it out; every
// variant runs 256 threads. Returns 0, or the error rn_conv3x3 would return.
extern "C" int rn_conv3x3_variant(int H, int W, int Cin, int Cout, int cp, int dtype, int* out) {
  return dispatch(nullptr, nullptr, nullptr, nullptr, 1, H, W, Cin, Cout, cp, dtype, -1, nullptr,
                  out);
}
