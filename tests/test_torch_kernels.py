"""The port's four kernels: each plain version against the Pallas kernel it
replaces, run as tests/test_pallas_kernels.py runs it (interpret mode on the
CPU), and each wrapper's dispatch (plain on the CPU, raise elsewhere).

Tolerances: f32 at rtol = atol = 1e-5, the conv at 1e-4 in rtol (sum
order), as the JAX package's kernel tests hold them. bf16 within one bf16
ulp (rtol 2^-7), the residual also within one ulp of its bf16-rounded
intermediate scaled by the BN scale (atol 2^-7 * max|s| * max|res|). The
CUDA kernels themselves are held against these plain versions on the card
by tests/test_torch_cuda.py and chip_smoke.py.
"""

import ctypes
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roomnet_tpu.ops import blocks as JB
from roomnet_tpu.ops.pallas.conv_b2 import conv3x3_pallas
from roomnet_tpu.ops.pallas.dense_head import dense_head_pallas
from roomnet_tpu.ops.pallas.pool import fused_relu6_pool_bn
from roomnet_tpu.ops.pallas.residual import residual_bn_pallas
from roomnet_tpu.params import schema as jschema
from roomnet_tpu_torch.ops import blocks as TB
from roomnet_tpu_torch.ops.kernels import _build
from roomnet_tpu_torch.ops.kernels import conv1x1 as KC1
from roomnet_tpu_torch.ops.kernels import conv3x3 as KC
from roomnet_tpu_torch.ops.kernels import dense_head as KD
from roomnet_tpu_torch.ops.kernels import pool as KP
from roomnet_tpu_torch.ops.kernels import residual as KR
from roomnet_tpu_torch.ops.kernels.conv3x3 import conv3x3_plain
from roomnet_tpu_torch.ops.kernels.dense_head import dense_head_plain, pack_head
from roomnet_tpu_torch.ops.kernels.pool import relu6_pool_bn_plain
from roomnet_tpu_torch.ops.kernels.residual import residual_bn_plain, source_pairs
from roomnet_tpu_torch.ops.resize import interp_matrix_tf1
from tests.conftest import ARTIFACTS, GOLDEN_DIR
from tests import torch_port_util as U
from tests.torch_port_util import outputs, random_bn, torch_tree, wrapper_cases

BF16_ULP = 2.0 ** -7
T = torch.from_numpy


@pytest.fixture(scope="module")
def dense_layers_np():
    with np.load(ARTIFACTS / "roomnet_params.npz") as data:
        flat = dict(data)
    return jschema.unflatten_jax(flat)["dense"]


def _affine(bn, eps=JB.BN_EPS):
    w, b = TB.bn_fold(torch_tree(bn), eps)
    return w, b


# -- conv3x3 -----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 18, 20, 8, 16), (2, 10, 13, 3, 8), (1, 26, 9, 32, 32)])
def test_conv3x3_plain_matches_pallas(shape):
    b, h, w, cin, cout = shape
    rng = np.random.RandomState(1)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    k = (rng.randn(3, 3, cin, cout) * 0.1).astype(np.float32)
    want = np.asarray(conv3x3_pallas(x, k, row_tile=8, interpret=True))
    got = conv3x3_plain(T(x), T(k)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_conv3x3_plain_bias_is_added_in_f32():
    """The folded conv-0 bias: conv + bias, matching the JAX forward's
    ``conv2d_valid(x, k') + b'`` in f32."""
    rng = np.random.RandomState(2)
    x = rng.randint(0, 256, size=(2, 12, 12, 3)).astype(np.float32)
    k = (rng.randn(3, 3, 3, 8) * 0.01).astype(np.float32)
    bias = rng.randn(8).astype(np.float32)
    want = np.asarray(JB.conv2d_valid(x, k) + bias)
    got = conv3x3_plain(T(x), T(k), T(bias)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_conv3x3_plain_bf16_rounds_once():
    rng = np.random.RandomState(3)
    x = T(rng.randn(1, 9, 9, 8).astype(np.float32)).bfloat16()
    k = T(rng.randn(3, 3, 8, 16).astype(np.float32)).bfloat16()
    got = conv3x3_plain(x, k)
    assert got.dtype == torch.bfloat16
    want = TB.conv2d_valid(x.float(), k.float()).bfloat16()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# (Cin, Cout) of the ten convs of the 224 forward, in order.
MAIN_PATH_CONVS = [(3, 8), (8, 32), (32, 32), (32, 32), (32, 64), (64, 64), (64, 128),
                   (128, 16), (16, 16), (16, 16)]


def _conv_operands(cin, cout, dtype, seed):
    """x (2,11,13,Cin) and an HWIO kernel scaled so outputs are O(1)."""
    rng = np.random.RandomState(seed)
    x = T(rng.randn(2, 11, 13, cin).astype(np.float32)).to(dtype)
    k = T((rng.randn(3, 3, cin, cout) / np.sqrt(9 * cin)).astype(np.float32)).to(dtype)
    return x, k


def _unpack_bf16(packed, cin, cout):
    """HWIO back from pack_bf16's [slice][Cout_p][8]."""
    c8, cout_p = -(-cin // 8), packed.shape[1]
    k = packed[: 9 * c8].reshape(9, c8, cout_p, 8).permute(0, 1, 3, 2).reshape(9, 8 * c8, cout_p)
    return k[:, :cin, :cout].reshape(3, 3, cin, cout)


def _unpack_f32(packed, cin, cout):
    """HWIO back from pack_f32's [Cout tile][chunk][tap][4][NT]."""
    tiles, chunks, _, _, nt = packed.shape
    k = packed.permute(2, 1, 3, 0, 4).reshape(9, 4 * chunks, tiles * nt)
    return k[:, :cin, :cout].reshape(3, 3, cin, cout)


def _gemm_bf16(x, packed, cout):
    """The bf16 kernel's implicit GEMM in PyTorch: per K slice (8 channels of
    one tap), the shifted view of the zero-padded input times the slice's
    [Cout_p][8] weights, summed in f32 and rounded once."""
    b, h, w, cin = x.shape
    c8 = -(-cin // 8)
    xp = torch.nn.functional.pad(x.float(), (0, 8 * c8 - cin))
    y = torch.zeros((b, h - 2, w - 2, packed.shape[1]))
    for j in range(packed.shape[0]):
        tap, c = divmod(min(j, 9 * c8 - 1), c8)  # the padding slice is all zeros
        dy, dx = divmod(tap, 3)
        y += xp[:, dy:dy + h - 2, dx:dx + w - 2, 8 * c:8 * c + 8] @ packed[j].float().T
    return y[..., :cout].to(x.dtype)


def _gemm_f32(x, packed, cout):
    """The f32 kernel's implicit GEMM in PyTorch: per Cout tile, chunk of 4
    input channels and tap, the shifted view times the [4][NT] weights."""
    b, h, w, cin = x.shape
    tiles, chunks, _, _, nt = packed.shape
    xp = torch.nn.functional.pad(x, (0, 4 * chunks - cin))
    y = torch.zeros((b, h - 2, w - 2, tiles * nt))
    for t in range(tiles):
        for c in range(chunks):
            for tap in range(9):
                dy, dx = divmod(tap, 3)
                view = xp[:, dy:dy + h - 2, dx:dx + w - 2, 4 * c:4 * c + 4]
                y[..., t * nt:(t + 1) * nt] += view @ packed[t, c, tap]
    return y[..., :cout]


@pytest.mark.parametrize("site", range(len(MAIN_PATH_CONVS)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_conv3x3_packed_implicit_gemm_matches_plain(site, dtype):
    cin, cout = MAIN_PATH_CONVS[site]
    x, k = _conv_operands(cin, cout, dtype, seed=10 + site)
    want = conv3x3_plain(x, k)
    if dtype == torch.bfloat16:
        got = _gemm_bf16(x, KC.pack_bf16(k), cout)
        torch.testing.assert_close(got.float(), want.float(), rtol=BF16_ULP, atol=1e-5)
    else:
        got = _gemm_f32(x, KC.pack_f32(k), cout)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("site", range(len(MAIN_PATH_CONVS)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_conv3x3_pack_unpacks_to_hwio(site, dtype):
    cin, cout = MAIN_PATH_CONVS[site]
    _, k = _conv_operands(cin, cout, dtype, seed=30 + site)
    if dtype == torch.bfloat16:
        packed = KC.pack_bf16(k)
        assert packed.shape[0] % 2 == 0 and packed.shape[1:] == (KC.cout_padded(cout), 8)
        back = _unpack_bf16(packed, cin, cout)
    else:
        packed = KC.pack_f32(k)
        assert packed.shape[4] == min(KC.F32_NT, KC.cout_padded(cout))
        back = _unpack_f32(packed, cin, cout)
    assert packed.dtype == dtype
    assert torch.equal(back, k)
    assert packed.count_nonzero() == k.count_nonzero()  # the padding is zeros


def test_conv3x3_packed_kernel_is_cached_per_tensor_and_version():
    _, k = _conv_operands(8, 16, torch.float32, seed=5)
    first = KC.packed_kernel(k, torch.float32)
    assert KC.packed_kernel(k, torch.float32) is first
    assert KC.packed_kernel(k, torch.bfloat16).dtype == torch.bfloat16
    k.mul_(2.0)  # an in-place change repacks
    again = KC.packed_kernel(k, torch.float32)
    assert again is not first
    assert torch.equal(_unpack_f32(again, 8, 16), k)


def test_conv3x3_refuses_cout_past_128():
    with pytest.raises(ValueError, match="not supported"):
        KC.cout_padded(129)


# -- conv3x3's wgmma + TMA path, replayed by its twin (tests/torch_port_util.py)

# (Cin, Cout) of the main path's convs with Cin % 8 == 0 (sites 1-9), and
# Cout 8 and 16 at other Cin.
WG_PAIRS = sorted({(ci, co) for _, ci, co in U.CONV_SITES[1:]} | {(8, 8), (64, 8), (32, 16), (128, 8)})
# Every Cin up to 128 that the path takes.
WG_CINS = [cin for cin in range(8, 129, 8) if U.wg_takes(cin)]


@pytest.mark.parametrize("cin,cout", WG_PAIRS)
def test_conv3x3_wgmma_b_descriptor_reads_the_hwio_kernel(cin, cout):
    """Every k16 step's B element (k, n), read from pack_bf16's bytes at the
    descriptor's canonical K-major offsets, is the HWIO kernel's weight of
    slice 2s + k // 8 (zero in the padding slice and past Cout)."""
    _, k = _conv_operands(cin, cout, torch.bfloat16, seed=50 + cin + cout)
    packed = KC.pack_bf16(k)
    cout_p, c8 = packed.shape[1], cin // 8
    desc = U.wg_b_descriptor(cout_p)
    # The descriptor's fields fit their bits: 14 bits of 16-byte units each.
    assert desc["lbo"] % 16 == 0 and desc["lbo"] >> 4 < 1 << 14 and desc["sbo"] >> 4 < 1 << 14
    raw = packed.view(torch.int16).numpy().view(np.uint8).reshape(-1)
    kk, nn = np.meshgrid(np.arange(16), np.arange(cout_p), indexing="ij")
    hwio = k.float().reshape(9, cin, cout)
    for s in range(packed.shape[0] // 2):
        off = U.wg_b_offset(desc, s, kk, nn)
        got = torch.from_numpy((raw[off] | (raw[off + 1].astype(np.uint16) << 8)).astype(np.int16))
        got = got.view(torch.bfloat16).float()
        want = torch.zeros((16, cout_p))
        for half in (0, 1):
            j = 2 * s + half
            if j < 9 * c8:
                tap, c = divmod(j, c8)
                want[8 * half:8 * half + 8, :cout] = hwio[tap, 8 * c:8 * c + 8]
        assert torch.equal(got, want), f"k16 step {s}"


@pytest.mark.parametrize("cin", WG_CINS)
def test_conv3x3_wgmma_a_descriptor_reads_the_shifted_halo(cin):
    """Each k16 step's A descriptor, over a stage of 8-channel TMA boxes,
    gives row m of block i the 16 channels of slices 2s, 2s + 1 at halo
    pixel 64i + m shifted by each slice's tap (zeros against the padding
    slice's weights): tagged pixels read back at the descriptor's offsets."""
    p = U.wg_plan(cin, 16)
    th, c8 = p["th"], p["c8"]
    npix = (th + 2) * U.WG_HWD
    # Tag every (pixel, channel) where the TMA box of its 8-channel group put it.
    stage = np.full(p["stage_bytes"] // 2 + 32, -1, np.int64)
    pix, ch = np.meshgrid(np.arange(npix), np.arange(8 * c8), indexing="ij")
    stage[(ch // 8) * (p["box_bytes"] // 2) + pix * 8 + ch % 8] = pix * 1000 + ch
    rows, ks = np.meshgrid(np.arange(64), np.arange(16), indexing="ij")
    for s in range(p["nsp"] // 2):
        d = U.wg_a_descriptor(p, s)
        assert d["lbo"] % 16 == 0 and d["lbo"] >> 4 < 1 << 14 and d["start"] % 16 == 0
        for blk in range(p["mi"]):
            got = stage[U.desc_offset({**d, "start": d["start"] + blk * 64 * 16}, rows, ks) // 2]
            for half in (0, 1):
                j = 2 * s + half
                if j >= 9 * c8:
                    continue  # zero weights: what it reads is never summed
                tap, c = divmod(j, c8)
                dy, dx = divmod(tap, 3)
                row_pix = blk * 64 + rows[:, :8] + dy * U.WG_HWD + dx
                want = row_pix * 1000 + 8 * c + ks[:, :8]
                # Rows of the 2 discarded columns may read past the halo.
                keep = (rows[:, :8] + blk * 64) % U.WG_HWD < U.WG_TW
                assert np.array_equal(got[:, 8 * half:8 * half + 8][keep], want[keep]), f"step {s}"


@pytest.mark.parametrize("cin", [24, 48, 96, 112])
def test_conv3x3_wgmma_leaves_cin_whose_tap_a_shift_misses(cin):
    """Cin / 8 no power of two goes to mma.sync: at such Cin the kernel's
    shift and mask (the twin's A descriptor) name another tap than slice
    j's, which the halo test above would read as wrong pixels."""
    assert not U.wg_takes(cin)
    c8 = cin // 8
    lc = c8.bit_length() - 1
    assert any((j >> lc, j & (c8 - 1)) != divmod(j, c8) for j in range(0, 9 * c8, 2))


@pytest.mark.parametrize("cout", [8, 16, 32, 64, 128, 24])
def test_conv3x3_wgmma_staged_output_is_what_the_tma_store_reads(cout):
    """The epilogue's swizzled staging offset of every (pixel, channel pair)
    is where the TMA store's swizzled box reads it, and each 8-lane phase of
    the staging stores hits 8 distinct 16-byte bank groups."""
    p = U.wg_plan(16, cout)
    olg, span = p["olg"], 16 << p["olg"]
    for pix in range(p["th"] * U.WG_TW):
        for ch in range(0, cout, 2):
            n, e = divmod(ch, 8)
            wrote = U.wg_swizzled(pix, n & ((1 << olg) - 1), olg) + 2 * e
            assert wrote == U.tma_swizzle(pix * span + 16 * (n & ((1 << olg) - 1)) + 2 * e, span)
    for row in range(p["th"]):
        for col in (0, 8):  # lanes g = 0..7 of one q: columns col + g of one row
            for n in range(cout // 8):
                pixels = [row * U.WG_TW + col + g for g in range(8) if col + g < U.WG_TW]
                groups = {(U.wg_swizzled(x, n & ((1 << olg) - 1), olg) >> 4) & 7 for x in pixels}
                assert len(groups) == len(pixels)


@pytest.mark.parametrize("site", range(1, len(U.CONV_SITES)))
@pytest.mark.parametrize("batch,ragged", [(1, 0), (3, 0), (3, 5)])
def test_conv3x3_wgmma_tile_walk_covers_each_output_once(site, batch, ragged):
    """The persistent warpgroups' walk (t = 2 * block + g, then on by twice
    the grid) over the tiles covers every output pixel once (the TMA store's
    box clipped at the edge), and each tile's halo arrives in the
    warpgroup's stage it waits on with the parity of that stage's completed
    loads."""
    h, cin, cout = U.CONV_SITES[site]
    p = U.wg_plan(cin, cout)
    ho, wo = h - 2, h - 2 + ragged
    tiles = U.wg_tiles(ho, wo, batch, p["th"])
    per_sm = 2 if p["smem"] <= U.WG_MAX_SMEM // 2 - 1024 else 1
    grid = min(-(-len(tiles) // 2), 132 * per_sm)
    seen = np.zeros((batch, ho, wo), np.int64)
    for slot in range(U.WG_GROUPS * grid):  # warpgroup g of block b: slot 2b + g
        ring = {}  # stage -> [tile index, loads so far]
        walk = list(range(slot, len(tiles), U.WG_GROUPS * grid))
        for k in range(min(p["stages"], len(walk))):
            ring[k] = [walk[k], 1]
        for it, t in enumerate(walk):
            st = it % p["stages"]
            assert ring[st][0] == t and (ring[st][1] - 1) & 1 == (it // p["stages"]) & 1
            if it + p["stages"] < len(walk):
                ring[st] = [walk[it + p["stages"]], ring[st][1] + 1]
            b, r0, c0 = tiles[t]
            seen[b, r0:r0 + p["th"], c0:c0 + U.WG_TW] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("cin,cout,shape", [
    (8, 32, (1, 19, 37)), (16, 16, (3, 13, 11)), (32, 64, (1, 20, 21)), (64, 128, (1, 12, 20)),
    (128, 16, (1, 11, 23)), (16, 12, (2, 10, 9)), (64, 64, (1, 22, 18)), (8, 6, (2, 9, 17))])
def test_conv3x3_wgmma_replay_matches_plain(cin, cout, shape):
    """The whole path by its twin's index arithmetic (TMA boxes, A and B
    descriptors, staged output, the store's clip) gives conv3x3_plain within
    one bf16 ulp."""
    rng = np.random.RandomState(cin + cout)
    x = T(rng.randn(*shape, cin).astype(np.float32)).to(torch.bfloat16)
    k = T((rng.randn(3, 3, cin, cout) / np.sqrt(9 * cin)).astype(np.float32)).to(torch.bfloat16)
    bias = T(rng.randn(cout).astype(np.float32))
    got = U.wg_replay(x, KC.pack_bf16(k), cout, bias)
    want = conv3x3_plain(x, k, bias)
    torch.testing.assert_close(got.float(), want.float(), rtol=BF16_ULP, atol=1e-5)


# -- conv3x3's f32 TF32 path over a hi/lo split, replayed by its twin (tests/torch_port_util.py)

# Every Cin up to 128 that the path takes.
TF_CINS = [cin for cin in range(1, 129) if KC.tf32_takes(cin)]
# (Cin, Cout) of the main path's f32 sites it takes (1-9), the TP slice of
# block 4 (Cout 64), Cout that no tile width holds whole (6, 36), Cin 48.
TF_PAIRS = sorted({(ci, co) for _, ci, co in U.CONV_SITES[1:]} | {(64, 64), (8, 6), (16, 36), (48, 24)})
# Main-path sites 1-9, narrowed: (B, H, W) with tiles cut by H and W.
TF_SHAPES = [(2, 19, 33), (3, 13, 11)]


def _relu6_range_operands(shape, cin, cout, seed):
    """x in ReLU6's range [0, 6), a Glorot-scaled HWIO kernel and a bias, f32:
    the operands the f32 path sees past conv 0."""
    rng = np.random.RandomState(seed)
    x = T((rng.rand(*shape, cin) * 6).astype(np.float32))
    k = T((rng.randn(3, 3, cin, cout) / np.sqrt(9 * cin)).astype(np.float32))
    return x, k, T(rng.randn(cout).astype(np.float32))


def _outside_gate(got, want, tol=1e-4):
    """Values of `got` outside phase 2's f32 conv gate (rtol = atol = 1e-4)."""
    return int(((got - want).abs() > tol + tol * want.abs()).sum())


def _tf_b_columns(p, wflat_tile, chunk, tap):
    """(8, 2 * NT): B element (k, n) of (chunk, tap), read at the [hi | lo]
    descriptor's offsets of one Cout tile's packed image."""
    d = U.tf_b_descriptor(p, chunk, tap)
    assert d["lbo"] == p["nb"] * 16 and d["lbo"] >> 4 < 1 << 14 and d["start"] % 16 == 0
    nn, kk = np.meshgrid(np.arange(p["nb"]), np.arange(8), indexing="ij")
    return wflat_tile[U.desc_offset32(d, nn, kk) // 4].T


def test_conv3x3_tf32_takes_multiples_of_8_up_to_256():
    """The path admits Cin % 8 == 0 up to 256 (csrc/conv3x3.cu:tf::takes),
    and every such Cin has a plan at Cout 8, 16 and 128; conv 0's 3 channels
    stay on the CUDA cores."""
    for cin in range(1, 300):
        assert KC.tf32_takes(cin) == (cin % 8 == 0 and cin <= 256), cin
        if KC.tf32_takes(cin):
            for cout in (8, 16, 128):
                p = U.tf_plan(cin, cout)
                assert p["smem"] <= U.WG_MAX_SMEM and 72 * cin * p["nt"] <= KC.TF32_W_MAX
    assert not KC.tf32_takes(U.CONV_SITES[0][1])


@pytest.mark.parametrize("cin", TF_CINS)
def test_conv3x3_tf32_a_descriptor_reads_the_shifted_halo(cin):
    """Each chunk's A descriptors, over a stage of two 4-channel TMA boxes,
    give row m of block i the 8 channels of the chunk at halo pixel 64i + m
    shifted by the tap: tagged pixels read back at the descriptor's offsets,
    at every Cin the path takes (the taps are an unrolled loop: nothing is
    found by arithmetic on Cin)."""
    p = U.tf_plan(cin, 16)
    npix = (p["th"] + 2) * U.WG_HWD
    rows, ks = np.meshgrid(np.arange(64), np.arange(8), indexing="ij")
    keep = None
    for k in range(p["chunks"]):
        # Tag every (pixel, channel) of chunk k where its box put it.
        stage = np.full(p["chunk_bytes"] // 4 + 8, -1, np.int64)
        pix, ch = np.meshgrid(np.arange(npix), np.arange(8), indexing="ij")
        stage[(ch // 4) * (p["box_bytes"] // 4) + pix * 4 + ch % 4] = pix * 1000 + 8 * k + ch
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            for blk in range(p["mi"]):
                d = U.tf_a_descriptor(p, tap, blk)
                assert d["lbo"] % 16 == 0 and d["lbo"] >> 4 < 1 << 14 and d["start"] % 16 == 0
                got = stage[U.desc_offset32(d, rows, ks) // 4]
                want = (blk * 64 + rows + dy * U.WG_HWD + dx) * 1000 + 8 * k + ks
                # Rows of the 2 discarded columns may read past the halo.
                keep = (rows + blk * 64) % U.WG_HWD < U.WG_TW
                assert np.array_equal(got[keep], want[keep]), f"chunk {k} tap {tap} block {blk}"
    assert keep is not None


@pytest.mark.parametrize("cin,cout", TF_PAIRS)
def test_conv3x3_tf32_b_descriptor_reads_the_split_kernel(cin, cout):
    """Every (chunk, tap) B element (k, n) of every Cout tile, read from
    pack_tf32x3's bytes at the [hi | lo] descriptor's K-major offsets, is
    the hi (n < NT) or lo part of the HWIO weight of channel 8 * chunk + k,
    output channel tile * NT + n % NT (zero past Cout)."""
    _, kern, _ = _relu6_range_operands((1, 3, 3), cin, cout, seed=60 + cin + cout)
    packed = KC.pack_tf32x3(kern)
    p = U.tf_plan(cin, cout)
    tiles, nsp, nt = p["cout_tiles"], p["nsp"], p["nt"]
    assert packed.shape == (tiles, nsp, 2, nt, 4)
    wflat = packed.numpy().reshape(tiles, -1)
    hwio = np.zeros((9, cin, tiles * nt), np.float32)
    hwio[..., :cout] = kern.numpy().reshape(9, cin, cout)
    hi, lo = (t.numpy() for t in KC.tf32_split(T(hwio)))
    for y in range(tiles):
        for k in range(p["chunks"]):
            for tap in range(9):
                got = _tf_b_columns(p, wflat[y], k, tap)
                for part, want in ((0, hi), (1, lo)):
                    assert np.array_equal(got[:, part * nt:(part + 1) * nt],
                                          want[tap, 8 * k:8 * k + 8, y * nt:(y + 1) * nt]), (y, k, tap, part)


@pytest.mark.parametrize("site", range(1, len(U.CONV_SITES)))
def test_conv3x3_pack_tf32x3_unpacks_to_hwio(site):
    """hi + lo of every packed weight is the HWIO kernel within 2^-23 of it
    (lo's own TF32 rounding: half a TF32 ulp of |k - hi| <= 2^-12 |k|), both
    TF32 values (the 13 low mantissa bits zero), hi the rna rounding of
    the weight; the padding is zeros."""
    _, cin, cout = U.CONV_SITES[site]
    _, kern, _ = _relu6_range_operands((1, 3, 3), cin, cout, seed=70 + site)
    packed = KC.pack_tf32x3(kern)
    p = U.tf_plan(cin, cout)
    tiles, nt = p["cout_tiles"], p["nt"]
    bits = packed.view(torch.int32)
    assert not (bits & 0x1FFF).any()
    # [tile][chunk][tap][b][part][n][e] -> (tap, chunk, b, e) = Cin, (tile, n) = Cout.
    parts = packed.reshape(tiles, cin // 8, 9, 2, 2, nt, 4).permute(4, 2, 1, 3, 6, 0, 5).reshape(2, 9, cin, -1)
    back = (parts[0].double() + parts[1].double())[..., :cout].reshape(3, 3, cin, cout)
    torch.testing.assert_close(back, kern.double(), rtol=2.0 ** -23, atol=0)
    assert torch.equal(parts[0][..., :cout].reshape(3, 3, cin, cout), KC.tf32(kern))
    assert not parts[:, ..., cout:].any()


@pytest.mark.parametrize("site", range(1, len(U.CONV_SITES)))
def test_conv3x3_tf32_cat_b_descriptor_reads_hi_then_lo(site):
    """At each main-path site, the B that each (chunk, tap) issues is one
    operand of N = 2 * NT, a wgmma width, whose columns 0..NT-1 are the hi
    and NT..2NT-1 the lo part of the same HWIO weights (hi the rna rounding,
    hi + lo within 2^-23 of the weight): two wgmmas a tap and m64 block."""
    _, cin, cout = U.CONV_SITES[site]
    _, kern, _ = _relu6_range_operands((1, 3, 3), cin, cout, seed=110 + site)
    p = U.tf_plan(cin, cout)
    tiles, nt = p["cout_tiles"], p["nt"]
    assert (p["nb"], p["tap_wgmmas"]) == (2 * nt, 2)
    assert p["nb"] % 8 == 0 and p["nb"] <= 256
    wflat = KC.pack_tf32x3(kern).numpy().reshape(tiles, -1)
    hwio = np.zeros((9, cin, tiles * nt), np.float32)
    hwio[..., :cout] = kern.numpy().reshape(9, cin, cout)
    for y in range(tiles):
        for k in range(p["chunks"]):
            for tap in range(9):
                got = _tf_b_columns(p, wflat[y], k, tap)
                want = hwio[tap, 8 * k:8 * k + 8, y * nt:(y + 1) * nt]
                assert np.array_equal(got[:, :nt], KC.tf32(T(want)).numpy()), (y, k, tap)
                np.testing.assert_allclose(got[:, :nt].astype(np.float64) + got[:, nt:], want, rtol=2.0 ** -23,
                                           atol=0)


def test_conv3x3_tf32x3_packed_kernel_is_cached_per_tensor_and_version():
    """The TF32 split layout is cached beside the CUDA cores' one, per
    kernel tensor, and made again after an in-place change."""
    _, k, _ = _relu6_range_operands((1, 3, 3), 32, 64, seed=6)
    first = KC.packed_kernel(k, torch.float32, tf32x3=True)
    cores = KC.packed_kernel(k, torch.float32)
    assert KC.packed_kernel(k, torch.float32, tf32x3=True) is first
    assert KC.packed_kernel(k, torch.float32) is cores and cores.shape != first.shape
    assert torch.equal(first, KC.pack_tf32x3(k))
    k.mul_(2.0)
    again = KC.packed_kernel(k, torch.float32, tf32x3=True)
    assert again is not first and torch.equal(again, KC.pack_tf32x3(k))


@pytest.mark.parametrize("site", range(1, len(U.CONV_SITES)))
@pytest.mark.parametrize("shape", TF_SHAPES, ids=["19x33", "13x11"])
@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
def test_conv3x3_tf32_replay_matches_plain(site, shape, with_bias):
    """The whole path by its twin's index arithmetic (TMA boxes per K chunk,
    the rna split, A and B descriptors, four products, the tile walk's clip)
    gives conv3x3_plain within phase 2's f32 conv gate at every main-path
    site's channels, tiles cut by H and W."""
    _, cin, cout = U.CONV_SITES[site]
    x, k, bias = _relu6_range_operands(shape, cin, cout, seed=80 + site)
    bias = bias if with_bias else None
    got = U.tf_replay(x, KC.pack_tf32x3(k), cout, bias)
    want = conv3x3_plain(x, k, bias)
    assert got.shape == want.shape and _outside_gate(got, want) == 0
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cin,cout", [(64, 64), (8, 6), (16, 36), (48, 24)])
def test_conv3x3_tf32_replay_matches_plain_off_the_main_path(cin, cout):
    """The TP slice of block 4 (Cout 64 in two tiles of 32), Cout that no
    tile width holds whole, Cin 48 (six chunks), with bias."""
    x, k, bias = _relu6_range_operands((2, 12, 17), cin, cout, seed=90 + cin + cout)
    torch.testing.assert_close(U.tf_replay(x, KC.pack_tf32x3(k), cout, bias), conv3x3_plain(x, k, bias),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("site", range(1, len(U.CONV_SITES)))
def test_conv3x3_tf32_one_pass_mutant_fails_the_gate(site):
    """The same twin with one TF32 pass (hi_a * hi_b alone) falls outside
    the gate that four products and three (without lo_a * lo_b) meet: the
    gate sees the difference."""
    _, cin, cout = U.CONV_SITES[site]
    x, k, bias = _relu6_range_operands(TF_SHAPES[0], cin, cout, seed=80 + site)
    want = conv3x3_plain(x, k, bias)
    for passes in (4, 3):
        assert _outside_gate(U.tf_replay(x, KC.pack_tf32x3(k), cout, bias, passes=passes), want) == 0
    assert _outside_gate(U.tf_replay(x, KC.pack_tf32x3(k), cout, bias, passes=1), want) > 0


@pytest.mark.parametrize("site", range(1, len(U.CONV_SITES)))
def test_conv3x3_tf32_two_accumulator_replay_within_the_gate(site):
    """With the kernel's order (B = [hi | lo]: the lo-weight products summed
    in their own NT columns and added to the f32 sums before the hi-weight
    ones) the twin stays within the gate at every main-path site; without
    the lo-weight products (a * hi_b alone) it falls outside: the gate sees
    those columns."""
    _, cin, cout = U.CONV_SITES[site]
    x, k, bias = _relu6_range_operands(TF_SHAPES[1], cin, cout, seed=120 + site)
    packed, want = KC.pack_tf32x3(k), conv3x3_plain(x, k, bias)
    got = U.tf_replay(x, packed, cout, bias)
    assert got.shape == want.shape and _outside_gate(got, want) == 0
    without_lo_b = U.tf_replay(x, packed, cout, bias, passes=(("lo", "hi"), ("hi", "hi")))
    assert _outside_gate(without_lo_b, want) > 0


@pytest.mark.parametrize("cin,cout", [(8, 32), (32, 64), (64, 128), (128, 16)])
def test_conv3x3_tf32_replay_matches_pallas_highest(cin, cout):
    """The twin against the Pallas kernel it replaces, run in interpret mode
    at its Precision.HIGHEST contraction, within the same gate."""
    x, k, _ = _relu6_range_operands((1, 18, 23), cin, cout, seed=100 + cin)
    want = np.asarray(conv3x3_pallas(x.numpy(), k.numpy(), row_tile=8, interpret=True))
    got = U.tf_replay(x, KC.pack_tf32x3(k), cout)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_conv3x3_tf32_twin_forward_matches_the_tf_golden(monkeypatch):
    """The port's f32 forward on the 7-image golden batch with every conv
    the path takes swapped for its twin (conv 0 stays plain, as it stays on
    the CUDA cores): logits within 1e-4 of the TF graph, argmax exact."""
    from roomnet_tpu_torch.models import roomnet as M
    from roomnet_tpu_torch.params.schema import load_npz

    replayed = []

    def twin(x, kernel, bias=None):
        if not KC.tf32_takes(x.shape[3]):
            return conv3x3_plain(x, kernel, bias)
        replayed.append(x.shape[3])
        return U.tf_replay(x, KC.pack_tf32x3(kernel), kernel.shape[3], bias)

    g = dict(np.load(GOLDEN_DIR / "forward_golden.npz"))
    variables = load_npz(ARTIFACTS / "roomnet_params.npz", device="cpu")
    monkeypatch.setattr(M, "conv3x3", twin)
    monkeypatch.setattr(M, "conv3x3_autograd", twin)
    with torch.no_grad():
        logits = M.forward(variables, M.normalize_bgr_uint8(T(g["x_uint8_bgr"])), M.DEFAULT_CONFIG).numpy()
    assert replayed == [cin for _, cin, _ in U.CONV_SITES[1:]]
    np.testing.assert_array_equal(logits.argmax(-1), g["argmax"])
    assert np.abs(logits - g["logits"]).max() <= 1e-4


# -- relu6_pool_bn -----------------------------------------------------------

@pytest.mark.parametrize("shape", [(12, 12, 8, 3), (13, 15, 32, 4), (107, 53, 8, 3)])
def test_pool_plain_matches_pallas_stride1(shape):
    h, w, c, k = shape
    rng = np.random.RandomState(0)
    x = (rng.randn(2, h, w, c) * 3).astype(np.float32)
    bn = random_bn(rng, c)
    jw, jb = JB.bn_fold(bn, JB.BN_EPS)
    want = np.asarray(fused_relu6_pool_bn(x, jw, jb, ksize=k, stride=1, interpret=True))
    got = relu6_pool_bn_plain(T(x), *_affine(bn), ksize=k, stride=1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(203, 203, 4, 4, 2), (19, 19, 16, 4, 2), (14, 11, 8, 1, 1)])
def test_pool_plain_matches_blocks_composition(shape):
    """Stride 2 (the Pallas kernel refuses it) and B4's 1x1 window, against
    the JAX forward's relu6 -> avg_pool_valid -> batch_norm."""
    h, w, c, k, s = shape
    rng = np.random.RandomState(1)
    x = (rng.randn(2, h, w, c) * 3).astype(np.float32)
    bn = random_bn(rng, c)
    want = np.asarray(JB.batch_norm(JB.avg_pool_valid(JB.relu6(x), k, s), bn))
    got = relu6_pool_bn_plain(T(x), *_affine(bn), ksize=k, stride=s).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_pool_plain_divides_by_window_area():
    """Sum then divide, as parity mode requires: a 3x3 window summing to 17
    gives float32(17)/9, which is not float32(17) * float32(1/9)."""
    x = torch.full((1, 3, 3, 1), 2.0)
    x[0, 0, 0, 0] = 1.0
    got = relu6_pool_bn_plain(x, torch.ones(1), torch.zeros(1), ksize=3, stride=1).item()
    assert got == np.float32(17) / np.float32(9)
    assert got != np.float32(17) * (np.float32(1) / np.float32(9))


def test_pool_wrapper_refuses_windows_past_kmax():
    """The kernel's register ring holds KMAX row sums; a wider window is refused
    before any launch (here on the meta device, which never launches)."""
    x, w = torch.zeros((1, 9, 9, 8), device="meta"), torch.ones(8, device="meta")
    with pytest.raises(ValueError, match="windows up to 4"):
        KP.relu6_pool_bn(x, w, w, ksize=KP.KMAX + 1, stride=1)


# -- residual_bn ---------------------------------------------------------------

@pytest.mark.parametrize("shapes", [((21, 19), (25, 23)), ((48, 48), (100, 100)), ((2, 2), (21, 21))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_residual_plain_matches_pallas(shapes, dtype):
    (ho, wo), (hi, wi) = shapes
    rng = np.random.RandomState(3)
    c = 8
    bn = random_bn(rng, c)
    x = rng.randn(2, ho, wo, c).astype(np.float32)
    res = rng.randn(2, hi, wi, c).astype(np.float32)
    jdt = getattr(jnp, dtype)
    want = np.asarray(residual_bn_pallas(jnp.asarray(x, jdt), jnp.asarray(res, jdt), bn,
                                         interpret=True).astype(jnp.float32))
    s, t = _affine(bn)
    tdt = getattr(torch, dtype)
    got = residual_bn_plain(T(x).to(tdt), T(res).to(tdt), s, t).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        xb = T(res).to(tdt).float()
        atol = BF16_ULP * s.abs().max().item() * xb.abs().max().item()
        np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=atol)


@pytest.mark.parametrize("src,dst", [(215, 205), (100, 48), (21, 2), (7, 13), (9, 9)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_residual_source_pairs_rebuild_the_interp_matrix(src, dst, dtype):
    """The kernel's two (index, weight) pairs per output hold exactly the
    nonzeros of the port's own float32 matrix (bf16-rounded in bf16)."""
    m = torch.from_numpy(interp_matrix_tf1(src, dst)).to(dtype).float().numpy()
    idx, wts = source_pairs(src, dst, dtype)
    rebuilt = np.zeros_like(m)
    for j in range(dst):
        for p in range(2):
            if wts[j, p] != 0:
                rebuilt[idx[j, p], j] += wts[j, p]
    np.testing.assert_array_equal(rebuilt, m)


# The residual's launch plan: (src, dst, C) of the three main-path sites, an
# upsampling and an identity pair, and a height and width the strip and span
# do not divide.
PLAN_CASES = [(215, 205, 32), (100, 48, 64), (21, 2, 16), (7, 13, 8), (9, 9, 12), (131, 101, 128)]


@pytest.mark.parametrize("src,dst,c", PLAN_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_residual_plan_covers_every_nonzero_within_the_budget(src, dst, c, dtype):
    """Each strip's res rows and each span's res columns hold every nonzero
    of interp_matrix_tf1 (bf16-rounded in bf16) in its outputs' columns; the
    strips and spans tile the output; a block stays within the kernel's
    threads, strip and shared-memory limits."""
    p = KR.plan(src, src, dst, dst, c, dtype)
    m = torch.from_numpy(interp_matrix_tf1(src, dst)).to(dtype).float().numpy()
    for groups, step in ((p.strips, p.strip), (p.spans, p.span)):
        assert len(groups) == -(-dst // step)
        for g, (first, count) in enumerate(groups):
            nz = np.flatnonzero(m[:, g * step:(g + 1) * step].any(axis=1))
            assert first <= nz.min() and nz.max() < first + count <= src
    assert p.strip <= KR.MAX_STRIP and p.threads <= KR.MAX_THREADS
    assert p.smem == p.rows_in * p.cols_in * c * p.itemsize <= KR.SMEM_LIMIT
    assert p.grid(3) == (len(p.spans), len(p.strips), 3)


@pytest.mark.parametrize("c,dtype,wide,vec", [
    (32, torch.bfloat16, True, 8), (32, torch.float32, True, 4), (12, torch.bfloat16, True, 1),
    (12, torch.float32, True, 4), (32, torch.bfloat16, False, 1), (6, torch.float32, True, 1)])
def test_residual_plan_vector_width(c, dtype, wide, vec):
    """16 bytes of channels per thread where C is a multiple of them and the
    tensors are 16-byte aligned, else one channel."""
    assert KR.plan(21, 19, 13, 17, c, dtype, wide).vec == vec


@pytest.mark.parametrize("c,dtype", [(1028, torch.float32), (4104, torch.bfloat16)])
def test_residual_plan_refuses_more_channels_than_a_column_of_threads(c, dtype):
    with pytest.raises(ValueError, match="threads"):
        KR.plan(9, 9, 9, 9, c, dtype)


def test_residual_plan_halves_strip_then_span_to_fit_the_budget():
    """100->48 at 64 bf16 channels: 8 rows reach 17 res rows, too many for
    48 KB; the strip halves to 2. 1000->50 reaches 20 res columns per output
    column: at one row the span halves from 50 to 25."""
    p = KR.plan(100, 100, 48, 48, 64, torch.bfloat16)
    assert (p.strip, p.span, p.rows_in) == (2, 24, 4) and p.smem <= KR.SMEM_LIMIT
    p = KR.plan(1000, 1000, 50, 50, 32, torch.bfloat16)
    assert (p.strip, p.span) == (1, 25) and p.smem <= KR.SMEM_LIMIT


def _residual_by_blocks(x, res, s, t):
    """csrc/residual_bn.cu's arithmetic block by block in PyTorch: each block
    stages its strip's res rows and span's res columns, indexes them relative
    to that tile, and rounds as the kernel does (each product and sum
    separately, the H pass to the io dtype)."""
    b, ho, wo, c = x.shape
    _, hi, wi, _ = res.shape
    p = KR.plan(hi, wi, ho, wo, c, x.dtype)
    hidx, hwt = source_pairs(hi, ho, x.dtype)
    widx, wwt = source_pairs(wi, wo, x.dtype)
    y = torch.empty_like(x)
    for by, (r0, nr) in enumerate(p.strips):
        for bx, (c0, nc) in enumerate(p.spans):
            tile = res[:, r0:r0 + nr, c0:c0 + nc].float()
            oh = slice(by * p.strip, min((by + 1) * p.strip, ho))
            ow = slice(bx * p.span, min((bx + 1) * p.span, wo))
            h, w = hidx[oh] - r0, widx[ow] - c0
            assert h.min() >= 0 and h.max() < nr and w.min() >= 0 and w.max() < nc
            a, bw = T(hwt[oh])[None, :, None, None], T(wwt[ow])[None, None, :, None]

            def hpass(col):
                return (a[..., 0] * tile[:, h[:, 0]][:, :, col]
                        + a[..., 1] * tile[:, h[:, 1]][:, :, col]).to(x.dtype).float()

            up = bw[..., 0] * hpass(w[:, 0]) + bw[..., 1] * hpass(w[:, 1])
            y[:, oh, ow] = (s * (x[:, oh, ow].float() + up) + t).to(x.dtype)
    return y


@pytest.mark.parametrize("src,dst,c", PLAN_CASES[:5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_residual_blocks_of_the_plan_match_plain(src, dst, c, dtype):
    rng = np.random.RandomState(src + c)
    s, t = _affine(random_bn(rng, c))
    x = T(rng.randn(2, dst, dst, c).astype(np.float32)).to(dtype)
    res = T(rng.randn(2, src, src, c).astype(np.float32)).to(dtype)
    got, want = _residual_by_blocks(x, res, s, t), residual_bn_plain(x, res, s, t)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        atol = BF16_ULP * s.abs().max().item() * res.float().abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), rtol=BF16_ULP, atol=atol)


# -- dense_head ----------------------------------------------------------------

@pytest.mark.parametrize("widths,variant", [
    ((64, 32, 16, 8, 6), "resident"), ((256, 16, 8, 6), "resident"),
    ((256, 32, 16, 8, 6), "resident"), ((3136, 32, 16, 8, 6), "streamed")],
    ids=["224", "tiny", "300", "600"])
def test_dense_head_plan_picks_the_variant_from_the_packed_size(widths, variant):
    """Resident where the weights and four warps' activations fit 48 KB of
    shared memory (roomnet-300's 36 KB of weights do), streamed beyond:
    roomnet-600's 3136x32 first layer is 401 KB."""
    rng, n = np.random.RandomState(0), len(widths) - 1
    layers = [{"kernel": np.zeros(widths[i:i + 2], np.float32),
               "bias": np.zeros(widths[-1], np.float32) if i == n - 1 else None,
               "bn": None if i == n - 1 else random_bn(rng, widths[i + 1])} for i in range(n)]
    packed, got = pack_head(torch_tree(layers))
    p = KD.plan(got, packed.numel())
    assert (p.variant, p.rows) == (variant, KD.WARPS if variant == "resident" else 1)
    if variant == "resident":
        weights = -(-packed.numel() // 4) * 4
        assert p.smem == (weights + KD.WARPS * 2 * max(widths)) * 4 <= KD.RESIDENT_SMEM
    else:
        assert packed.numel() * 4 > KD.RESIDENT_SMEM


@pytest.mark.parametrize("bsz", [1, 16, 300])
def test_dense_head_plain_matches_pallas(dense_layers_np, bsz):
    x = np.random.RandomState(0).randn(bsz, 64).astype(np.float32)
    want = np.asarray(dense_head_pallas(dense_layers_np, x))
    logits, probs = dense_head_plain(T(x), *pack_head(torch_tree(dense_layers_np)))
    np.testing.assert_allclose(probs.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=1e-5)
    assert logits.min() >= 0 and logits.max() <= 6


def test_dense_head_plain_honors_bn_eps(dense_layers_np):
    eps = 1e-2
    x = np.random.RandomState(1).randn(8, 64).astype(np.float32)
    want = np.asarray(dense_head_pallas(dense_layers_np, x, bn_eps=eps))
    tl = torch_tree(dense_layers_np)
    _, got = dense_head_plain(T(x), *pack_head(tl, eps))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    _, default = dense_head_plain(T(x), *pack_head(tl))
    assert (default - got).abs().max() > 1e-6


def test_dense_head_plain_takes_any_widths():
    """roomnet-tiny's 256 -> 16 -> 8 -> 6 head (three layers), against the
    JAX forward's dense -> relu6 -> BN chain."""
    rng = np.random.RandomState(2)
    widths = (256, 16, 8, 6)
    layers = []
    for i in range(3):
        last = i == 2
        layers.append({"kernel": (rng.randn(widths[i], widths[i + 1]) * 0.2).astype(np.float32),
                       "bias": rng.randn(6).astype(np.float32) if last else None,
                       "bn": None if last else random_bn(rng, widths[i + 1])})
    x = rng.randn(5, 256).astype(np.float32)
    h = x
    for layer in layers:
        h = JB.relu6(JB.dense(h, layer["kernel"], layer["bias"]))
        if layer["bn"] is not None:
            h = JB.batch_norm(h, layer["bn"])
    packed, got_widths = pack_head(torch_tree(layers))
    assert got_widths == widths
    logits, probs = dense_head_plain(T(x), packed, got_widths)
    np.testing.assert_allclose(logits.numpy(), np.asarray(h), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jax.nn.softmax(h, -1)), rtol=1e-5, atol=1e-6)


# -- the wrappers: plain on CPU, kernel or raise elsewhere -----------------------

def _cpu_cases():
    """wrapper_cases on the CPU, then conv1x1's (bf16 on the card, any dtype
    in its plain version): stride 2, bias, residual and ReLU."""
    g = torch.Generator().manual_seed(5)
    x, k, bias = torch.randn(2, 7, 6, 64, generator=g), torch.randn(1, 1, 64, 64, generator=g), torch.randn(64)
    conv1x1 = (KC1.conv1x1, KC1.conv1x1_plain, (x, k, bias),
               {"stride": 2, "relu": True, "residual": torch.randn(2, 4, 3, 64, generator=g)})
    return wrapper_cases("cpu") + [conv1x1]


@pytest.mark.parametrize("case", range(5), ids=["conv3x3", "relu6_pool_bn", "residual_bn", "dense_head", "conv1x1"])
def test_wrapper_on_cpu_runs_plain_and_counts_one_launch(case):
    """The plain version stands in the launch's place: the wrapper's call
    moves its kernel's counter by one, and no other; the plain version
    called by itself counts nothing."""
    kern, plain, args, kwargs = _cpu_cases()[case]
    before = _build.launch_counts()
    for a, b in zip(outputs(kern(*args, **kwargs)), outputs(plain(*args, **kwargs))):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert _build.launches_since(before) == {n: int(n == kern.__name__) for n in _build.SOURCES}


@pytest.mark.parametrize("case", range(5), ids=["conv3x3", "relu6_pool_bn", "residual_bn", "dense_head", "conv1x1"])
def test_card_reading_refuses_a_region_that_ran_a_plain_version(case):
    """A wrapper's CPU call also moves `kernel/plain.<kernel>`, so the reading
    that the card's checks take fails where a plain version stood in a
    launch's place, while `launches_since` counts it."""
    kern, _, args, kwargs = _cpu_cases()[case]
    before = _build.launch_counts()
    kern(*args, **kwargs)
    assert _build.launches_since(before, [kern.__name__]) == {kern.__name__: 1}
    with pytest.raises(AssertionError, match=rf"^plain versions ran in place of launches: "
                                             rf"\{{'kernel/plain\.{kern.__name__}': 1\}}$"):
        _build.card_launches_since(before)


@pytest.mark.parametrize("case", range(4))
def test_wrapper_on_meta_device_raises(case):
    """No fallback: a tensor that is neither on the CPU nor on a CUDA card is
    refused, and a refused call counts no launch."""
    kern, _, args, kwargs = wrapper_cases("meta")[case]
    before = _build.launch_counts()
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kern(*args, **kwargs)
    assert _build.launch_counts() == before


def test_launch_binds_each_entry_once_counts_and_raises(monkeypatch):
    """`_build.launch` binds an entry at its first call and no more, counts
    every launch that reaches the entry, a failing one too, and raises with
    the library's error string."""
    def rn_fake(rc):
        return rc

    loads = []
    lib = types.SimpleNamespace(rn_fake=rn_fake, rn_error_string=lambda rc: b"fake error")
    monkeypatch.setattr(_build, "load", lambda name: loads.append(name) or lib)
    monkeypatch.setattr(_build, "_entries", {})
    before = _build.launch_counts()
    for _ in range(3):
        _build.launch("dense_head", "rn_fake", [ctypes.c_int], 0)
    assert loads == ["dense_head"] and rn_fake.argtypes == [ctypes.c_int] and rn_fake.restype is ctypes.c_int
    with pytest.raises(RuntimeError, match=r"^rn_fake: CUDA error 7 \(fake error\)$"):
        _build.launch("dense_head", "rn_fake", [ctypes.c_int], 7)
    assert _build.card_launches_since(before) == {n: 4 * (n == "dense_head") for n in _build.SOURCES}


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
