// 1x1 convolution as a bf16 GEMM on Hopper's wgmma and TMA, with the folded
// BN's bias, an optional residual and an optional ReLU in its epilogue:
// y = relu?(x[:, ::s, ::s] @ w + bias + res?), NHWC, w (Cin, Cout), stride s
// 1 or 2, Cin and Cout multiples of 64. M = B*Ho*Wo, K = Cin, N = Cout.
//
// It replaces no kernel of the JAX package: ResNet-50 v1.5's 36 1x1 convs
// (the bottlenecks' first and last, the four projection shortcuts) are half
// its operations. On an H100 they are bound by HBM: at batch 256 they read
// and write about 10 GB of activations a forward against 1.1 ms of
// tensor-core time, and 71% of that bound lies in sites of 1-8 K steps
// (Cin / 64), where a tile's loads, its few wgmmas and its epilogue take
// about as long as each other. So nothing of the bias, the residual add and
// the ReLU is left to a pass of its own (each would re-read and re-write
// activations that are already the bound), and no part of a tile waits on
// another's memory traffic.
//
// The kernel is persistent: one block on each SM (min(tiles, SMs) blocks)
// walks the launch's output tiles (t = blockIdx.x, t += gridDim.x), in
// igemm.cuh's order, the Cout tile fastest, so the blocks that share a pixel
// tile run side by side and read its A from HBM once, from L2 after that. A
// tile is igemm.cuh's: BM = 128 output pixels (one TMA box of whole rows of
// the NHWC view at the stride; at stride 1 the pixels are one flat M and a
// box is 128 consecutive pixels) x BN = 64 or 128 output channels, K in steps
// of 64 input channels, A and B swizzled by 128 bytes (B packed by
// ops/kernels/conv3x3.py:pack_stream). Its warps:
//
//  - the operand producer (one lane) keeps `stages` K steps of A and B in
//    flight in a ring that runs on across the block's tiles, so the next
//    tiles' loads are in flight while the consumers finish this one;
//  - the slot producer (one lane) owns `slots` staging buffers of a whole
//    tile (BN / 64 boxes of 128 pixels x 64 channels, swizzled by 128
//    bytes). At a residual site it loads each tile's residual box into its
//    slot by TMA, up to slots - 1 tiles ahead; else it hands the slot over
//    empty once its last store has read it;
//  - two consumer warpgroups (tile rows 0-63 and 64-127, one
//    wgmma.m64nBNk16 each a k16 step) run the wgmmas, then the epilogue in
//    place in the slot: sum + bias (f32), + the residual (bf16, read from
//    the slot), the ReLU, one rounding to bf16, written back where the
//    residual was; one thread then stores the tile by TMA (the ragged edge
//    clipped by the map) and goes on to the next tile. The slot is handed
//    back once the store after it has been issued and the store of it has
//    read shared memory.
//
// The arithmetic is igemm.cuh's `body` (used by the 3x3 convs, which keep
// it): f32 sums over K in the same step order, + bias, + residual, ReLU, one
// rounding. The kernel keeps its name (conv1x1_bn_kernel), so that a device
// trace times it apart from the 3x3 convs.
#include <cuda_runtime.h>

#include <climits>

#include "common.cuh"
#include "igemm.cuh"

namespace {

using rn::igemm::A_BYTES;
using rn::igemm::BK;
using rn::igemm::BM;
using rn::igemm::CONSUMERS;

constexpr int THREADS = CONSUMERS + 64;  // two consumer warpgroups, the operand and the slot producer
constexpr int BOX_BYTES = BM * BK * 2;   // one box of a slot: 128 pixels x 64 channels
constexpr int MAX_STAGES = 8;

// The input's view at the stride, the output and the residual (like the
// output, or unused): boxes of 64 channels x the tile's pixels, swizzled by
// 128 bytes.
struct Maps {
  CUtensorMap x, y, res;
};

struct Args {
  rn::igemm::Args g;  // the GEMM: operands, shape, the tile's box, stages
  int tiles;          // pixel tiles x Cout tiles
  int slots;          // staging buffers of a whole tile
};

struct Plan {
  int stages = 0, slots = 0, tiles = 0, blocks = 0;
  size_t smem = 0;
};

// Residual sites keep a slot for the tile in its epilogue, one whose store
// drains and one loading ahead; elsewhere two do. The stages take the rest
// of a block's shared memory (one block an SM), up to MAX_STAGES.
Plan plan(const rn::igemm::Plan& g, int tiles_n, bool residual, int sms) {
  Plan p;
  p.slots = residual ? 3 : 2;
  const size_t stage = A_BYTES + rn::igemm::b_bytes(g.bn) + 16, slot = (size_t)BM * g.bn * 2 + 16;
  const size_t fixed = 1024 + p.slots * slot;  // 1024: room to align the base; 16 a stage or slot: its barriers
  p.stages = (int)((rn::igemm::MAX_SMEM - fixed) / stage);
  if (p.stages > MAX_STAGES) p.stages = MAX_STAGES;
  p.smem = fixed + p.stages * stage;
  const long long tiles = (long long)g.tiles_w * g.tiles_h * g.tiles_b * tiles_n;
  p.tiles = tiles > INT_MAX ? 0 : (int)tiles;
  p.blocks = p.tiles < sms ? p.tiles : sms;
  return p;
}

struct Tile {
  int tn, x0, y0, b0;  // Cout tile; the box's first column, row and image
};

__device__ __forceinline__ Tile tile_of(const rn::igemm::Args& a, int t) {
  const int tm = t / a.tiles_n, r = tm / a.tiles_w;
  return {t % a.tiles_n, (tm % a.tiles_w) * a.tw, (r % a.tiles_h) * a.th, (r / a.tiles_h) * a.nb};
}

__device__ __forceinline__ uint32_t ld_shared(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
    conv1x1_bn_kernel(const __grid_constant__ Maps maps, const Args args) {
  using namespace rn::sm90;
  const rn::igemm::Args& a = args.g;
  constexpr int B_BYTES = rn::igemm::b_bytes(BN);
  constexpr int SLOT_BYTES = (BN / BK) * BOX_BYTES;
  constexpr int NA = BN / 2;  // a consumer thread's accumulators: m64 x BN
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const int S = a.stages, R = args.slots;
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sa = base, sb = sa + S * A_BYTES, so = sb + S * B_BYTES;
  const uint32_t full = so + R * SLOT_BYTES, empty = full + 8 * S, rfull = empty + 8 * S, rempty = rfull + 8 * R;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS / 32);
    }
    for (int r = 0; r < R; ++r) {
      mbar_init(rfull + 8 * r, 1);
      mbar_init(rempty + 8 * r, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers are initialised; no block-wide barrier follows

  if (warp == CONSUMERS / 32) {  // the operand producer: step `it` of the block's walk in stage it % S
    if (lane != 0) return;
    int it = 0;
    for (int t = blockIdx.x; t < args.tiles; t += gridDim.x) {
      const Tile p = tile_of(a, t);
      const uint8_t* wt = a.w + (size_t)p.tn * a.ksteps * B_BYTES;
      for (int k = 0; k < a.ksteps; ++k, ++it) {
        const int st = it % S;
        if (it >= S) mbar_wait(empty + 8 * st, ((it / S) - 1) & 1);
        const uint32_t bar = full + 8 * st;
        mbar_expect_tx(bar, a.a_bytes + B_BYTES);
        tma_load(sa + st * A_BYTES, &maps.x, bar, k * BK, p.x0, p.y0, p.b0);
        bulk_load(sb + st * B_BYTES, wt + (size_t)k * B_BYTES, B_BYTES, bar);
      }
    }
    return;
  }
  if (warp == CONSUMERS / 32 + 1) {  // the slot producer: the block's tile j in slot j % R
    if (lane != 0) return;
    int j = 0;
    for (int t = blockIdx.x; t < args.tiles; t += gridDim.x, ++j) {
      const int r = j % R;
      if (j >= R) mbar_wait(rempty + 8 * r, ((j / R) - 1) & 1);
      const uint32_t bar = rfull + 8 * r;
      if (a.res != nullptr) {
        const Tile p = tile_of(a, t);
        mbar_expect_tx(bar, (BN / BK) * a.a_bytes);
        for (int c = 0; c < BN / BK; ++c)
          tma_load(so + r * SLOT_BYTES + c * BOX_BYTES, &maps.res, bar, p.tn * BN + c * BK, p.x0, p.y0, p.b0);
      } else {
        mbar_arrive(bar);
      }
    }
    return;
  }

  // A of k16 step s: the warpgroup's 64 rows from row 64 * wg (8 KB on),
  // 32 s bytes into each row; B: all BN rows, 32 s bytes in.
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, q = (lane & 3) * 2;
  const uint64_t da0 = rn::igemm::desc_sw128(sa + wg * 64 * BK * 2), db0 = rn::igemm::desc_sw128(sb);
  float acc[NA];
  int it = 0, j = 0;
  for (int t = blockIdx.x; t < args.tiles; t += gridDim.x, ++j) {
    const Tile p = tile_of(a, t);
#pragma unroll
    for (int n = 0; n < NA; ++n) acc[n] = 0.f;
    fence_operands(acc);
    for (int k = 0; k < a.ksteps; ++k, ++it) {
      const int st = it % S;
      mbar_wait(full + 8 * st, (it / S) & 1);
      const uint64_t da = da0 + (uint64_t)(st * (A_BYTES / 16)), db = db0 + (uint64_t)(st * (B_BYTES / 16));
      // Nothing touches the accumulators between the fence and the commit.
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < BK / 16; ++s)
        Wgmma<BN>::run(acc, da + (uint64_t)(2 * s), db + (uint64_t)(2 * s));
      wgmma_commit();
      // The step before is done: its stage goes back to the producer.
      wgmma_wait<1>();
      if (k > 0 && lane == 0) mbar_arrive(empty + 8 * ((it - 1) % S));
    }
    wgmma_wait<0>();
    fence_operands(acc);
    if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % S));  // the tile's last step

    // C fragment, n8 block n: (A row g, channels 8n + q, +1) in acc[4n],
    // [4n + 1], (row g + 8, the same) in [4n + 2], [4n + 3]; warp wq's rows
    // are 16 wq on in the warpgroup's 64. Tile row rr is the slot's row rr
    // in each box (box pixel rr % tw, rr / tw % th, rr / (tw * th)), 128
    // bytes a row, 16-byte chunk c at c ^ (rr % 8): a warp's 4-byte reads
    // and writes of one n8 block fall in 32 banks. Rows past the box read
    // and write stale bytes that no store takes.
    const int r = j % R;
    const uint32_t slot = so + r * SLOT_BYTES;
    mbar_wait(rfull + 8 * r, (j / R) & 1);
    const int co0 = p.tn * BN;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      const int co = co0 + 8 * n + q;
      const float bv0 = a.bias != nullptr ? a.bias[co] : 0.f, bv1 = a.bias != nullptr ? a.bias[co + 1] : 0.f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int rr = wg * 64 + wq * 16 + g + 8 * hh;  // rr % 8 == g
        const uint32_t addr = slot + (n / 8) * BOX_BYTES + rr * 128 + (((n % 8) ^ g) << 4) + q * 2;
        float v0 = acc[4 * n + 2 * hh], v1 = acc[4 * n + 2 * hh + 1];
        if (a.bias != nullptr) v0 = __fadd_rn(v0, bv0), v1 = __fadd_rn(v1, bv1);
        if (a.res != nullptr) {
          const uint32_t rv = ld_shared(addr);
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rv));
          v0 = __fadd_rn(v0, f.x), v1 = __fadd_rn(v1, f.y);
        }
        if (a.relu) v0 = v0 < 0.f ? 0.f : v0, v1 = v1 < 0.f ? 0.f : v1;  // NaN stays NaN, as torch.relu
        const __nv_bfloat162 o = __floats2bfloat162_rn(v0, v1);
        st_shared(addr, *reinterpret_cast<const uint32_t*>(&o));
      }
    }
    fence_proxy_async();  // the TMA store reads what this thread wrote
    asm volatile("bar.sync 1, 256;\n" ::: "memory");  // the consumers alone
    if (tid == 0) {
      for (int c = 0; c < BN / BK; ++c) tma_store(&maps.y, slot + c * BOX_BYTES, co0 + c * BK, p.x0, p.y0, p.b0);
      bulk_commit();
      // The tile before's stores have read their slot: it goes back to the
      // slot producer.
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      if (j > 0) mbar_arrive(rempty + 8 * ((j - 1) % R));
    }
  }
  if (tid == 0) bulk_wait();  // the last stores have left shared memory
}

// The first launch of each kernel on a device raises its dynamic
// shared-memory limit to the most a block may have.
template <int BN>
int launch(const Maps& maps, const Args& a, const Plan& p, int device, cudaStream_t s) {
  const int e = rn::igemm::raise_smem(reinterpret_cast<const void*>(conv1x1_bn_kernel<BN>), rn::igemm::MAX_SMEM,
                                      device);
  if (e != cudaSuccess) return e;
  conv1x1_bn_kernel<BN><<<p.blocks, THREADS, p.smem, s>>>(maps, a);
  return cudaGetLastError();
}

constexpr int REPORT = 12;

// report: {BN, tile columns, rows, images, shared memory, stages, pixel
// tiles, Cout tiles, slots, tiles, blocks, tiles a block walks at most};
// given, nothing is launched. `residual` stands for res where report is
// given; `sms`: the device's SMs, one block each.
int run(const void* x, const void* w, const void* bias, const void* res, void* y, int B, int H, int W, int Cin,
        int Cout, int stride, int relu, int bn, int sms, bool residual, int device, cudaStream_t s, int* report) {
  if (sms < 1) return cudaErrorInvalidValue;
  if (stride == 1) W = B * H * W, H = 1, B = 1;  // one flat M
  Args a;
  rn::igemm::Plan g;
  int e = rn::igemm::prepare(x, w, bias, res, y, B, H, W, Cin, Cout, 1, 0, stride, relu, bn, a.g, g, nullptr);
  if (e != 0) return e;
  const Plan p = plan(g, a.g.tiles_n, report != nullptr ? residual : res != nullptr, sms);
  if (p.tiles < 1) return cudaErrorInvalidValue;
  a.g.stages = p.stages;
  a.tiles = p.tiles, a.slots = p.slots;
  if (report != nullptr) {
    const int v[REPORT] = {g.bn, g.tw, g.th, g.nb, (int)p.smem, p.stages, g.tiles_w * g.tiles_h * g.tiles_b,
                           a.g.tiles_n, p.slots, p.tiles, p.blocks, (p.tiles + p.blocks - 1) / p.blocks};
    for (int i = 0; i < REPORT; ++i) report[i] = v[i];
    return cudaSuccess;
  }
  Maps maps = {};
  if ((e = rn::igemm::encode_view(&maps.x, x, B, H, W, Cin, stride, 0, 0, g)) != 0 ||
      (e = rn::igemm::encode_view(&maps.y, y, a.g.B, a.g.Ho, a.g.Wo, Cout, 1, 0, 0, g)) != 0 ||
      (res != nullptr && (e = rn::igemm::encode_view(&maps.res, res, a.g.B, a.g.Ho, a.g.Wo, Cout, 1, 0, 0, g)) != 0))
    return e;
  return g.bn == 128 ? launch<128>(maps, a, p, device, s) : launch<64>(maps, a, p, device, s);
}

}  // namespace

// x (B,H,W,Cin) bf16; w packed by pack_stream from (1,1,Cin,Cout) in Cout
// tiles of bn (its dim 2); bias (Cout,) f32 or null; res like y or null; y
// (B,Ho,Wo,Cout) bf16 with Ho = (H - 1) / stride + 1. All contiguous,
// 16-byte aligned. sms: the device's streaming multiprocessors.
extern "C" int rn_conv1x1(const void* x, const void* w, const void* bias, const void* res, void* y, int B, int H,
                          int W, int Cin, int Cout, int stride, int relu, int bn, int sms, int device, void* stream) {
  rn::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  return run(x, w, bias, res, y, B, H, W, Cin, Cout, stride, relu, bn, sms, false, device,
             static_cast<cudaStream_t>(stream), nullptr);
}

// What rn_conv1x1 launches for one shape, with or without a residual, on a
// device of `sms` SMs, for reports: out[12] as `run` lays it out. Returns 0,
// or the error rn_conv1x1 would return.
extern "C" int rn_conv1x1_variant(int B, int H, int W, int Cin, int Cout, int stride, int residual, int bn, int sms,
                                  int* out) {
  return run(nullptr, nullptr, nullptr, nullptr, nullptr, B, H, W, Cin, Cout, stride, 0, bn, sms, residual != 0,
             -1, nullptr, out);
}
