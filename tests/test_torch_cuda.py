"""The port's CUDA kernels on the card: each against its plain version, and
the forward through all four against the TF-graph goldens; the classifier's
pipeline (pinned ring, copy stream, results copied back behind each forward)
against one batch at a time, fed arrays through its decode seam; each
kernel's autograd Function against autograd through its plain version, and
the launches of one training step; the training loop against hand-driven
steps, its staging under slow steps and slow copies, its stall checkpoint
while steps are in flight, and `device_prefetch` under a slow consumer;
two ranks on the one card over gloo against one rank, and the DCP store
with tensors on the card; the mesh server (a world of one over NCCL, and
two ranks on the card over gloo) against the server without a mesh;
ResNet-50's streamed conv3x3 path and persistent conv1x1 GEMM against their
plain versions at every site and at the edges of the 1x1's tile walk, the
launches of a ResNet-50 forward, RoomNet's conv variants and
ResNet-50's 3x3 variants pinned to the reports they had before the streamed
path and the persistent 1x1, and the benchmark's ResNet-50 reference
against torchvision's where torchvision is installed.

Every test here is marked `cuda` and skips where no GPU is present. The file
imports neither JAX nor roomnet_tpu, so it runs on a machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: f32 at rtol = atol = 1e-5, the conv at rtol 1e-4 (sum order);
bf16 within one bf16 ulp (rtol 2^-7; atol 2^-7 * 8 covers the residual's
rounded intermediate at these inputs, |s| * |res| <= 8); the head computes
in f32 in both modes. Against the TF graph: f32 logits <= 1e-4, bf16 < 0.15,
argmax exact (tests/test_forward_golden.py's gates).
"""

import pathlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import chip_smoke
from roomnet_tpu_torch.infer.classify import RoomNetClassifier, load_fill
from roomnet_tpu_torch.models import registry
from roomnet_tpu_torch.models import roomnet as M
from roomnet_tpu_torch.ops.kernels.conv3x3 import conv3x3, conv3x3_plain
from roomnet_tpu_torch.ops.blocks import bn_fold
from roomnet_tpu_torch.ops.kernels import _build
from roomnet_tpu_torch.ops.kernels import conv3x3 as KC
from roomnet_tpu_torch.ops.kernels import dense_head as KD
from roomnet_tpu_torch.ops.kernels import pool as KP
from roomnet_tpu_torch.ops.kernels import residual as KR
from roomnet_tpu_torch.ops.kernels.dense_head import dense_head, dense_head_plain, pack_head
from roomnet_tpu_torch.ops.kernels.pool import relu6_pool_bn, relu6_pool_bn_plain
from roomnet_tpu_torch.ops.kernels.residual import residual_bn, residual_bn_plain
from roomnet_tpu_torch.params.schema import load_npz
# Imported by its own name (pytest puts tests/ on sys.path): on a machine with
# another `tests` package installed, `tests.torch_port_util` would not resolve.
import torch_port_util as U
from torch_port_util import (cuda_device, img_bytes, launched, outputs, post, random_bn,  # noqa: F401
                             tiny_classifier, torch_tree, wrapper_cases)

REPO = pathlib.Path(__file__).resolve().parents[1]
BF16_ULP = 2.0 ** -7


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(4), ids=["conv3x3", "relu6_pool_bn", "residual_bn", "dense_head"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_kernel_matches_plain(cuda_device, case, dtype):
    kern, plain, args, kwargs = wrapper_cases(cuda_device, dtype)[case]
    before = _build.launch_counts()
    got, want = outputs(kern(*args, **kwargs)), outputs(plain(*args, **kwargs))
    torch.cuda.synchronize()
    assert launched(before, _build.SOURCES) == [int(n == kern.__name__) for n in _build.SOURCES]
    f32 = dtype == torch.float32 or kern is dense_head
    for a, b in zip(got, want):
        rtol = (1e-4 if kern is conv3x3 else 1e-5) if f32 else BF16_ULP
        atol = 1e-5 if f32 else BF16_ULP * 8
        torch.testing.assert_close(a.float(), b.float(), rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_cuda_launch_on_another_card_keeps_the_current_device(cuda_device):
    """Each C entry makes its tensors' device current and restores the
    caller's, so PyTorch's current device is the same after the launch."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs")
    other = torch.device("cuda", torch.cuda.device_count() - 1)
    before = torch.cuda.current_device()
    assert before != other.index
    for kern, plain, args, kwargs in wrapper_cases(other):
        got, want = outputs(kern(*args, **kwargs)), outputs(plain(*args, **kwargs))
        torch.cuda.synchronize(other)
        assert torch.cuda.current_device() == before
        for a, b in zip(got, want):
            assert a.device == other
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg_name", ["roomnet-224", "roomnet-224-bf16"])
def test_cuda_forward_golden_through_the_kernels(cuda_device, cfg_name):
    g = dict(np.load(REPO / "tests" / "golden" / "forward_golden.npz"))
    variables = load_npz(REPO / "artifacts" / "roomnet_params.npz", device=cuda_device)
    x = M.normalize_bgr_uint8(torch.from_numpy(g["x_uint8_bgr"]).to(cuda_device))
    before = _build.launch_counts()
    logits = M.forward(variables, x, registry.get(cfg_name)).cpu().numpy()
    assert launched(before) == [10, 10, 3, 1]
    np.testing.assert_array_equal(logits.argmax(-1), g["argmax"])
    limit = 1e-4 if cfg_name == "roomnet-224" else 0.15
    assert np.abs(logits - g["logits"]).max() <= limit


@pytest.mark.cuda
@pytest.mark.parametrize("case", [1, 3], ids=["relu6_pool_bn", "dense_head"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_relu6_keeps_nan_as_the_plain_versions_do(cuda_device, case, dtype):
    """NaN in the input stays NaN through relu6, as in the plain versions
    and JAX's jnp.clip (fminf/fmaxf alone turn it into 0): the serving
    daemon's reload probe rejects a NaN tree only if it does."""
    kern, plain, args, kwargs = wrapper_cases(cuda_device, dtype)[case]
    x = args[0].clone()
    x.view(-1)[:: 7] = float("nan")
    args = (x, *args[1:])
    got, want = outputs(kern(*args, **kwargs)), outputs(plain(*args, **kwargs))
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.isnan(b).any()
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        keep = ~torch.isnan(b)
        torch.testing.assert_close(a[keep].float(), b[keep].float(), rtol=BF16_ULP, atol=BF16_ULP * 8)


# The new designs' edges: tiles cut by H and W, batch 1 and 3, bias on and off.
# (Cin, Cout) of the 224 forward's convs, each Cin with its Cout.
CONV_SHAPES = [(3, 8), (8, 32), (16, 16), (32, 32), (32, 64), (64, 64), (64, 128), (128, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", CONV_SHAPES)
@pytest.mark.parametrize("batch,h,w", [(1, 19, 37), (3, 13, 11)])
@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_conv3x3_at_tile_edges(cuda_device, cin, cout, batch, h, w, with_bias, dtype):
    rng = np.random.RandomState(cin * 1000 + cout + h)
    x = torch.from_numpy(rng.randn(batch, h, w, cin).astype(np.float32)).to(cuda_device, dtype)
    k = torch.from_numpy((rng.randn(3, 3, cin, cout) / np.sqrt(9 * cin)).astype(np.float32))
    k = k.to(cuda_device, dtype)
    bias = torch.from_numpy(rng.randn(cout).astype(np.float32)).to(cuda_device) if with_bias else None
    got, want = conv3x3(x, k, bias), conv3x3_plain(x, k, bias)
    torch.cuda.synchronize()
    assert got.shape == (batch, h - 2, w - 2, cout)
    rtol, atol = (1e-4, 1e-5) if dtype == torch.float32 else (BF16_ULP, BF16_ULP * 8)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", CONV_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_conv3x3_blocks_walk_many_tiles(cuda_device, cin, cout, dtype):
    """More output tiles than an H100 holds blocks (132 SMs x at most 8
    blocks of 256 threads): each persistent bf16 block walks several tiles,
    through its prefetch of the next halo into the other buffer."""
    batch = 640  # 17x17 outputs: 2 tiles of 16 columns per image at least
    rng = np.random.RandomState(cin + cout)
    x = torch.from_numpy(rng.randn(batch, 19, 19, cin).astype(np.float32)).to(cuda_device, dtype)
    k = torch.from_numpy((rng.randn(3, 3, cin, cout) / np.sqrt(9 * cin)).astype(np.float32))
    k = k.to(cuda_device, dtype)
    got, want = conv3x3(x, k), conv3x3_plain(x, k)
    torch.cuda.synchronize()
    rtol, atol = (1e-4, 1e-5) if dtype == torch.float32 else (BF16_ULP, BF16_ULP * 8)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,cp", [(torch.bfloat16, 8), (torch.bfloat16, 24), (torch.float32, 24)],
                         ids=["bf16-narrow", "bf16-odd", "f32-odd"])
def test_cuda_conv3x3_entry_refuses_a_layout_it_does_not_know(cuda_device, dtype, cp):
    """The C entry takes the packed layout's Cout_p (bf16) or NT (f32) from
    the wrapper and refuses one narrower than Cout or not one of its tiles."""
    x = torch.zeros((1, 5, 5, 8), dtype=dtype, device=cuda_device)
    packed = KC.packed_kernel(torch.zeros((3, 3, 8, 16), dtype=dtype, device=cuda_device), dtype)
    y = torch.empty((1, 3, 3, 16), dtype=dtype, device=cuda_device)
    fn = _build.entry("conv3x3", "rn_conv3x3", KC._ARGS)
    rc = fn(x.data_ptr(), packed.data_ptr(), None, y.data_ptr(), 1, 5, 5, 8, 16, cp,
            int(dtype == torch.bfloat16), x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    assert rc != 0


# The bf16 wgmma + TMA path (csrc/conv3x3.cu, namespace wg), held against
# conv3x3_plain within one bf16 ulp at every main-path shape it takes, many
# tiles per warpgroup, ragged edges, every (Cin, Cout) it takes, the TP
# slice of block 4; its plan against the twin in tests/torch_port_util.py.
def _bf16_conv_case(device, batch, h, w, cin, cout, seed, with_bias=False):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(batch, h, w, cin).astype(np.float32)).to(device, torch.bfloat16)
    k = torch.from_numpy((rng.randn(3, 3, cin, cout) / np.sqrt(9 * cin)).astype(np.float32))
    bias = torch.from_numpy(rng.randn(cout).astype(np.float32)).to(device) if with_bias else None
    return x, k.to(device, torch.bfloat16), bias


def _assert_bf16_conv(x, k, bias):
    got, want = conv3x3(x, k, bias), conv3x3_plain(x, k, bias)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=BF16_ULP, atol=BF16_ULP * 8)


@pytest.mark.cuda
@pytest.mark.parametrize("site", range(1, len(U.CONV_SITES)))
@pytest.mark.parametrize("batch", [1, 3, 256, 640])
def test_cuda_conv3x3_wgmma_main_path_shapes(cuda_device, site, batch):
    h, cin, cout = U.CONV_SITES[site]
    assert KC.variant((batch, h, h, cin), cout, torch.bfloat16)["path"] == "wgmma+TMA"
    _assert_bf16_conv(*_bf16_conv_case(cuda_device, batch, h, h, cin, cout, seed=site + batch))
    torch.cuda.empty_cache()  # up to 6 GB at batch 640: hand it back before later tests spawn ranks


@pytest.mark.cuda
@pytest.mark.parametrize("cin", [8, 16, 32, 64, 128, 48, 96])
@pytest.mark.parametrize("cout", [6, 8, 12, 16, 32, 36, 64, 128])
@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
def test_cuda_conv3x3_wgmma_channels_and_ragged_edges(cuda_device, cin, cout, with_bias):
    """Every (Cin, Cout) the path takes, at ragged heights and widths (tiles
    of 4 * rows-per-warp rows and 14 columns cut at the edge), Cout not a
    multiple of 8 (each lane stores its values); Cin 48 and 96 (Cin / 8 no
    power of two) take mma.sync and are held to the same bound; Cin 128
    with Cout 64 or 128 and Cin 96 with Cout 128 are refused (the weights
    and halo outgrow shared memory)."""
    if (cin == 128 and cout > 32) or (cin == 96 and cout > 64):
        with pytest.raises(RuntimeError, match="invalid configuration"):
            KC.variant((1, 8, 8, cin), cout, torch.bfloat16)
        return
    want = "wgmma+TMA" if U.wg_takes(cin) else "mma.sync"
    assert KC.variant((1, 8, 8, cin), cout, torch.bfloat16)["path"] == want
    for batch, h, w in ((2, 23, 31), (1, 9, 45), (3, 30, 16)):
        _assert_bf16_conv(*_bf16_conv_case(cuda_device, batch, h, w, cin, cout, seed=cin + cout + h,
                                           with_bias=with_bias))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [3, 256])
def test_cuda_conv3x3_wgmma_tensor_parallel_slice(cuda_device, batch):
    """Block 4's conv column-sharded over a 'model' axis of 2: 48^2 x 64 -> 64."""
    _assert_bf16_conv(*_bf16_conv_case(cuda_device, batch, 48, 48, 64, 64, seed=batch))


@pytest.mark.cuda
@pytest.mark.parametrize("site", range(len(U.CONV_SITES)))
def test_cuda_conv3x3_dispatch_by_shape(cuda_device, site):
    """bf16: Cin = 3 takes mma.sync, Cin 8 and multiples of 16 wgmma + TMA
    with the twin's plan (rows per warp, stages, tile, shared memory, the
    output's stores). f32: Cin = 3 stays on the CUDA cores, the others take
    TF32 passes over a hi/lo split with the twin's plan (NT, m64 blocks, stages, Cout
    tiles, 8 channels a stage, shared memory, the 2 wgmmas a tap and block
    issue over B = [hi | lo]); the other paths report 0 such wgmmas."""
    h, cin, cout = U.CONV_SITES[site]
    v = KC.variant((256, h, h, cin), cout, torch.bfloat16)
    f = KC.variant((256, h, h, cin), cout, torch.float32)
    assert v["tap_wgmmas"] == 0
    if not KC.tf32_takes(cin):
        assert f["path"] == "f32 CUDA cores" and f["tap_wgmmas"] == 0
    else:
        t = U.tf_plan(cin, cout)
        assert f["path"] == "tf32x3 wgmma+TMA" and f["warpgroups"] == U.WG_GROUPS and not f["tma_store"]
        assert (f["cp"], f["sub"], f["stages"], f["rows"], f["cols"], f["smem"], f["cout_tiles"], f["chunk"],
                f["tap_wgmmas"]) == (t["nt"], t["mi"], t["stages"], t["th"], U.WG_TW, t["smem"], t["cout_tiles"],
                                     8, t["tap_wgmmas"])
    if not U.wg_takes(cin):
        assert v["path"] == "mma.sync"
        return
    p = U.wg_plan(cin, cout)
    assert v["path"] == "wgmma+TMA" and v["warpgroups"] == U.WG_GROUPS
    assert (v["sub"], v["stages"], v["rows"], v["cols"], v["smem"]) == (p["mi"], p["stages"], p["th"], U.WG_TW,
                                                                          p["smem"])
    assert v["tma_store"] == (p["obox"] > 0)


# The f32 TF32 path over a hi/lo split (csrc/conv3x3.cu, namespace tf), held against
# conv3x3_plain at phase 2's f32 conv gate (rtol = atol = 1e-4; one TF32
# pass misses it, tests/test_torch_kernels.py) at every main-path shape it
# takes, many tiles per warpgroup, ragged edges, the TP slice, roomnet-600;
# inputs in ReLU6's range, as the f32 path sees them past conv 0.
def _f32_conv_case(device, batch, h, w, cin, cout, seed, with_bias=False):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.rand(batch, h, w, cin) * 6).astype(np.float32)).to(device)
    k = torch.from_numpy((rng.randn(3, 3, cin, cout) / np.sqrt(9 * cin)).astype(np.float32)).to(device)
    bias = torch.from_numpy(rng.randn(cout).astype(np.float32)).to(device) if with_bias else None
    return x, k, bias


def _assert_f32_conv(x, k, bias, path="tf32x3 wgmma+TMA"):
    assert KC.variant(tuple(x.shape), k.shape[3], torch.float32)["path"] == path
    got, want = conv3x3(x, k, bias), conv3x3_plain(x, k, bias)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("site", range(1, len(U.CONV_SITES)))
@pytest.mark.parametrize("batch", [8, 640])
def test_cuda_conv3x3_tf32x3_main_path_shapes(cuda_device, site, batch):
    h, cin, cout = U.CONV_SITES[site]
    _assert_f32_conv(*_f32_conv_case(cuda_device, batch, h, h, cin, cout, seed=site + batch, with_bias=True))
    torch.cuda.empty_cache()  # up to 12 GB at batch 640: hand it back before later tests spawn ranks


@pytest.mark.cuda
@pytest.mark.parametrize("cin", [8, 16, 32, 64, 128, 48])
@pytest.mark.parametrize("cout", [6, 8, 16, 32, 36, 64, 128])
@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
def test_cuda_conv3x3_tf32x3_channels_and_ragged_edges(cuda_device, cin, cout, with_bias):
    """Tiles of 4 * blocks rows and 14 columns cut at the edge, Cout tiles
    cut at Cout (6, 36), several Cout tiles (Cin 64 and 128 at Cout >= 32),
    Cin 48 (six K chunks)."""
    for batch, h, w in ((2, 23, 31), (1, 9, 45), (3, 30, 16)):
        _assert_f32_conv(*_f32_conv_case(cuda_device, batch, h, w, cin, cout, seed=cin + cout + h,
                                         with_bias=with_bias))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [3, 256])
def test_cuda_conv3x3_tf32x3_tensor_parallel_slice(cuda_device, batch):
    """Block 4's conv column-sharded over a 'model' axis of 2: 48^2 x 64 -> 64."""
    _assert_f32_conv(*_f32_conv_case(cuda_device, batch, 48, 48, 64, 64, seed=batch))


@pytest.mark.cuda
def test_cuda_conv3x3_tf32x3_roomnet_600_shapes(cuda_device):
    """Every conv of roomnet-600's forward at batch 2: conv 0 on the CUDA
    cores, the rest TF32 passes over a hi/lo split."""
    cfg = registry.get("roomnet-600")
    side, cin, seen = cfg.im_side, 3, 0
    for bi, (filters, depth) in enumerate(zip(cfg.block_filters, cfg.block_depths)):
        for d in range(depth):
            c = cin if d == 0 else filters
            path = "tf32x3 wgmma+TMA" if KC.tf32_takes(c) else "f32 CUDA cores"
            _assert_f32_conv(*_f32_conv_case(cuda_device, 2, side, side, c, filters, seed=bi * 10 + d), path=path)
            seen += path != "f32 CUDA cores"
            side -= 2
            if cfg.block_pools[bi] is not None:
                pk, pst = cfg.block_pools[bi]
                side = (side - pk) // pst + 1
        cin = filters
    assert seen == 9


@pytest.mark.cuda
@pytest.mark.parametrize("cin", [3, 4, 12, 20, 264])
def test_cuda_conv3x3_f32_cin_the_path_refuses_stays_on_the_cuda_cores(cuda_device, cin):
    """Cin not a multiple of 8, or past 256: the CUDA cores' full f32."""
    assert not KC.tf32_takes(cin)
    _assert_f32_conv(*_f32_conv_case(cuda_device, 2, 13, 19, cin, 16, seed=cin, with_bias=True),
                     path="f32 CUDA cores")


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(8, 32), (64, 128), (128, 16)])
def test_cuda_conv3x3_tf32x3_keeps_nan(cuda_device, cin, cout):
    """NaN in the input stays NaN through the split (hi keeps it, lo is 0):
    the outputs that see one are NaN exactly where the plain version's are,
    the rest within the gate."""
    x, k, bias = _f32_conv_case(cuda_device, 2, 17, 23, cin, cout, seed=cin)
    x[:, ::6, ::7, cin // 2] = float("nan")
    got, want = conv3x3(x, k, bias), conv3x3_plain(x, k, bias)
    torch.cuda.synchronize()
    assert torch.isnan(want).any() and not torch.isnan(want).all()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    keep = ~torch.isnan(want)
    torch.testing.assert_close(got[keep], want[keep], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("ksize,stride", [(1, 1), (3, 1), (4, 1), (4, 2)])
@pytest.mark.parametrize("c", [3, 8, 16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_relu6_pool_bn_at_strip_edges(cuda_device, ksize, stride, c, dtype):
    rng = np.random.RandomState(c + 10 * ksize + stride)
    x = torch.from_numpy((rng.randn(3, 23, 37, c) * 4).astype(np.float32)).to(cuda_device, dtype)
    w = torch.from_numpy((rng.rand(c) + 0.5).astype(np.float32)).to(cuda_device)
    b = torch.from_numpy(rng.randn(c).astype(np.float32)).to(cuda_device)
    got = relu6_pool_bn(x, w, b, ksize=ksize, stride=stride)
    want = relu6_pool_bn_plain(x, w, b, ksize=ksize, stride=stride)
    torch.cuda.synchronize()
    rtol, atol = (1e-5, 1e-5) if dtype == torch.float32 else (BF16_ULP, BF16_ULP * 8)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


def _residual_operands(device, dtype, batch, src, dst, c, seed):
    """x (B, *dst, C) and res (B, *src, C) in `dtype`, and the folded BN (s, t)."""
    rng = np.random.RandomState(seed)
    s, t = (v.to(device) for v in bn_fold(torch_tree(random_bn(rng, c))))

    def act(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(device, dtype)

    return act(batch, *dst, c), act(batch, *src, c), s, t


def _check_residual(x, res, s, t):
    got, want = residual_bn(x, res, s, t), residual_bn_plain(x, res, s, t)
    torch.cuda.synchronize()
    assert got.shape == x.shape and got.dtype == x.dtype
    if x.dtype == torch.float32:
        rtol = atol = 1e-5
    else:  # one ulp of the output, and one of the rounded intermediate scaled by s
        rtol = BF16_ULP
        atol = BF16_ULP * s.abs().max().item() * res.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


# The residual's strip stencil at its edges: (res H, W) -> (x H, W), C.
RESIDUAL_MAIN = [((215, 215), (205, 205), 32), ((100, 100), (48, 48), 64), ((21, 21), (2, 2), 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("src,dst,c", RESIDUAL_MAIN, ids=["215-205", "100-48", "21-2"])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_residual_bn_main_path_shapes(cuda_device, src, dst, c, batch, dtype):
    _check_residual(*_residual_operands(cuda_device, dtype, batch, src, dst, c, seed=src[0] + batch))


@pytest.mark.cuda
@pytest.mark.parametrize("src,dst", [((7, 7), (13, 13)), ((9, 9), (9, 9))], ids=["up-7-13", "id-9-9"])
@pytest.mark.parametrize("c", [8, 16, 32, 64, 128, 12])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_residual_bn_upsampling_identity_and_channels(cuda_device, src, dst, c, dtype):
    _check_residual(*_residual_operands(cuda_device, dtype, 2, src, dst, c, seed=c + src[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [8, 32, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_residual_bn_partial_last_strip_and_span(cuda_device, c, dtype):
    """A height and a width that the plan's strip and span do not divide."""
    src, dst = (37, 331), (29, 301)
    p = KR.plan(*src, *dst, c, dtype)
    assert dst[0] % p.strip and dst[1] % p.span
    _check_residual(*_residual_operands(cuda_device, dtype, 3, src, dst, c, seed=c))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_residual_bn_unaligned_tensors_take_one_channel_per_thread(cuda_device, dtype):
    """x one element past a 16-byte boundary: the plan takes one channel per
    thread, which the kernel launches like the vector."""
    x, res, s, t = _residual_operands(cuda_device, dtype, 2, (21, 19), (13, 17), 16, seed=7)
    buf = torch.empty(x.numel() + 1, dtype=dtype, device=cuda_device)
    xu = buf[1:].view(x.shape)
    xu.copy_(x)
    assert xu.data_ptr() % 16 and KR.plan_for(xu, res).vec == 1
    _check_residual(xu, res, s, t)


def _head(widths, seed):
    rng = np.random.RandomState(seed)
    layers = []
    for i in range(len(widths) - 1):
        last = i == len(widths) - 2
        k = (rng.randn(widths[i], widths[i + 1]) / np.sqrt(widths[i])).astype(np.float32)
        layers.append({"kernel": k, "bias": rng.randn(widths[-1]).astype(np.float32) if last else None,
                       "bn": None if last else random_bn(rng, widths[i + 1])})
    packed, got = pack_head(torch_tree(layers))
    assert got == tuple(widths)
    return packed


# 224, roomnet-tiny and roomnet-600 (whose weights do not fit: streamed).
HEAD_WIDTHS = {"224": (64, 32, 16, 8, 6), "tiny": (256, 16, 8, 6), "600": (3136, 32, 16, 8, 6)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(HEAD_WIDTHS))
@pytest.mark.parametrize("batch", [1, 3, 255, 256, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_dense_head_variants(cuda_device, name, batch, dtype):
    widths = HEAD_WIDTHS[name]
    packed = _head(widths, seed=batch).to(cuda_device)
    assert KD.plan(widths, packed.numel()).variant == ("streamed" if name == "600" else "resident")
    rng = np.random.RandomState(batch + 1)
    x = torch.from_numpy(rng.randn(batch, widths[0]).astype(np.float32)).to(cuda_device, dtype)
    got, want = dense_head(x, packed, widths), dense_head_plain(x, packed, widths)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.shape == (batch, widths[-1])
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def classifiers():
    """roomnet-224 f32 and bf16 classifiers at batch 16 on the card (the
    module's tests skip through cuda_device before using them)."""
    made = {}

    def get(cfg_name, device, batch_size=16):
        key = (cfg_name, batch_size)
        if key not in made:
            variables = load_npz(REPO / "artifacts" / "roomnet_params.npz", device=device)
            made[key] = RoomNetClassifier(variables, registry.get(cfg_name), batch_size=batch_size,
                                          device=device)
        return made[key]

    return get


def _one_batch_at_a_time(clf, x):
    """(ids, probs) of `_predict` on each batch of pageable input in turn,
    synchronously: the reference for the pipeline."""
    ids, probs = [], []
    for i in range(0, len(x), clf.batch_size):
        bid, bprobs = clf._predict(clf.variables, torch.from_numpy(x[i: i + clf.batch_size]).to(clf.device))
        ids.append(bid.cpu().numpy())
        probs.append(bprobs.cpu().numpy())
    return np.concatenate(ids), np.concatenate(probs)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [640, 641], ids=["40x16", "40x16+1"])
@pytest.mark.parametrize("cfg_name", ["roomnet-224", "roomnet-224-bf16"])
def test_cuda_predict_ring_wraps(cuda_device, classifiers, n, cfg_name):
    """40 batches of 16 wrap the ring of 3 pinned slots 13 times; 641 ends
    on a batch of 1. Every batch's ids and probs equal one batch at a time."""
    clf = classifiers(cfg_name, cuda_device)
    x = np.random.RandomState(n).randint(0, 256, size=(n, 224, 224, 3), dtype=np.uint8)
    ids, probs = clf.predict(x)
    want_ids, want_probs = _one_batch_at_a_time(clf, x)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(probs, want_probs)


@pytest.mark.cuda
def test_cuda_predict_memory_does_not_grow_with_batches(cuda_device, classifiers):
    """At most RING batches are on the device at once: the peak for 40
    batches is the peak for 3, give or take one batch of input."""
    clf = classifiers("roomnet-224-bf16", cuda_device)
    x = np.random.RandomState(4).randint(0, 256, size=(640, 224, 224, 3), dtype=np.uint8)
    peaks = []
    for n in (48, 640):
        clf.predict(x[:n])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(cuda_device)
        clf.predict(x[:n])
        peaks.append(torch.cuda.max_memory_allocated(cuda_device))
    assert peaks[1] <= peaks[0] + x[:16].nbytes, peaks


@pytest.mark.cuda
def test_cuda_predict_pinned_input_matches_pageable(cuda_device, classifiers):
    clf = classifiers("roomnet-224-bf16", cuda_device)
    x = np.random.RandomState(5).randint(0, 256, size=(40, 224, 224, 3), dtype=np.uint8)
    pinned = torch.from_numpy(x).pin_memory()
    assert pinned.is_pinned()
    got, want = clf.predict(pinned), clf.predict(x)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.cuda
def test_cuda_slow_forward_reads_its_own_batch(cuda_device, classifiers, monkeypatch):
    """Each forward sleeps on the compute stream before it reads its batch,
    so the copy stream runs ahead of it. The batch's device buffer, freed by
    the host after the forward is enqueued, must not be handed to a later
    copy before that forward has read it (record_stream), nor its pinned
    slot refilled early: every batch still classifies its own pixels."""
    clf = classifiers("roomnet-224-bf16", cuda_device)
    x = np.random.RandomState(6).randint(0, 256, size=(12 * 16, 224, 224, 3), dtype=np.uint8)
    want_ids, want_probs = _one_batch_at_a_time(clf, x)
    real = clf._predict

    def slow(variables, xb):
        torch.cuda._sleep(50_000_000)  # tens of ms of device time, before xb is read
        return real(variables, xb)

    monkeypatch.setattr(clf, "_predict", slow)
    ids, probs = clf.predict(x)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(probs, want_probs)


@pytest.mark.cuda
def test_cuda_predict_stream_leaves_out_unread_items(cuda_device, classifiers):
    """The decode seam: items fill could not read get id -1 and conf 0; the
    rest match one batch at a time, compacted into ragged batches."""
    clf = classifiers("roomnet-224", cuda_device)
    x = np.random.RandomState(7).randint(0, 256, size=(37, 224, 224, 3), dtype=np.uint8)
    missing = {0, 5, 16, 17, 36}
    items = [None if i in missing else x[i] for i in range(len(x))]
    with ThreadPoolExecutor(4) as pool:
        ids, confs, ok = clf.predict_stream(len(items), load_fill(items, lambda a: a, pool))
    keep = np.array([i not in missing for i in range(len(x))])
    np.testing.assert_array_equal(ok, keep)
    assert (ids[~keep] == -1).all() and (confs[~keep] == 0).all()
    want_ids, want_probs = _one_batch_at_a_time(clf, x[keep])
    np.testing.assert_array_equal(ids[keep], want_ids)
    np.testing.assert_allclose(confs[keep], want_probs, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_cuda_predict_counts_launches_per_forward(cuda_device, classifiers):
    clf = classifiers("roomnet-224-bf16", cuda_device)
    x = np.random.RandomState(8).randint(0, 256, size=(33, 224, 224, 3), dtype=np.uint8)
    before = _build.launch_counts()
    clf.predict(x)
    assert launched(before) == [30, 30, 9, 3]


# -- the autograd Functions of the training step ------------------------------
# Each Function (the kernel forward, a PyTorch backward) against autograd
# through the kernel's plain version on the same inputs: the forward at the
# tolerances above, every input's gradient within chip_smoke.GRAD_RTOL *
# (|ref| + max|ref|) (f32 1e-4, bf16 2^-6: both sides compute in f32 and
# round once to the io dtype, in another order).

def _check_autograd(fn, plain, args, kwargs, dtype, seed=0):
    leaves = [a.detach().clone().requires_grad_() if isinstance(a, torch.Tensor) and a.is_floating_point()
              else a for a in args]
    grad_of = [a for a in leaves if isinstance(a, torch.Tensor) and a.requires_grad]
    got, want = outputs(fn(*leaves, **kwargs))[0], outputs(plain(*leaves, **kwargs))[0]
    f32 = dtype == torch.float32 or fn is KD.dense_head_autograd
    rtol = (1e-4 if fn is KC.conv3x3_autograd else 1e-5) if f32 else BF16_ULP
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=1e-5 if f32 else BF16_ULP * 8)
    up = torch.randn(want.shape, generator=torch.Generator(want.device).manual_seed(seed), device=want.device)
    up = up.to(want.dtype)
    grtol = chip_smoke.GRAD_RTOL["f32" if dtype == torch.float32 else "bf16"]
    for a, b in zip(torch.autograd.grad(got, grad_of, up), torch.autograd.grad(want, grad_of, up)):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.isfinite(a).all()
        a, b = a.float(), b.float()
        assert ((a - b).abs() <= grtol * (b.abs() + b.abs().max())).all(), (a - b).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", CONV_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_conv3x3_autograd_matches_plain(cuda_device, cin, cout, dtype):
    rng = np.random.RandomState(cin + 7 * cout)
    x = torch.from_numpy(rng.randn(3, 13, 11, cin).astype(np.float32)).to(cuda_device, dtype)
    k = torch.from_numpy((rng.randn(3, 3, cin, cout) / np.sqrt(9 * cin)).astype(np.float32)).to(cuda_device)
    _check_autograd(KC.conv3x3_autograd, conv3x3_plain, (x, k, None), {}, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("ksize,stride", [(1, 1), (3, 1), (4, 1), (4, 2)])
@pytest.mark.parametrize("c", [8, 12, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_relu6_pool_bn_autograd_matches_plain_with_ties(cuda_device, ksize, stride, c, dtype):
    """An eighth of the inputs exactly 0 or 6, where relu6's derivative is
    0.5 on both sides."""
    rng = np.random.RandomState(ksize * 100 + stride * 10 + c)
    x = (rng.randn(2, 17, 14, c) * 4 + 3).astype(np.float32)
    tie = rng.rand(*x.shape)
    x[tie < 1 / 16], x[tie > 15 / 16] = 0.0, 6.0
    w, b = (v.to(cuda_device) for v in bn_fold(torch_tree(random_bn(rng, c))))
    _check_autograd(KP.relu6_pool_bn_autograd, relu6_pool_bn_plain,
                    (torch.from_numpy(x).to(cuda_device, dtype), w, b), {"ksize": ksize, "stride": stride}, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("src,dst", [((215, 215), (205, 205)), ((12, 13), (4, 5)), ((7, 7), (13, 13))],
                         ids=["215-205", "12x13-4x5", "up-7-13"])
@pytest.mark.parametrize("c", [16, 12])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_residual_bn_autograd_matches_plain(cuda_device, src, dst, c, dtype):
    rng = np.random.RandomState(src[0] + dst[1] + c)
    x = torch.from_numpy(rng.randn(2, *dst, c).astype(np.float32)).to(cuda_device, dtype)
    res = torch.from_numpy(rng.randn(2, *src, c).astype(np.float32)).to(cuda_device, dtype)
    s, t = (v.to(cuda_device) for v in bn_fold(torch_tree(random_bn(rng, c))))
    _check_autograd(KR.residual_bn_autograd, residual_bn_plain, (x, res, s, t), {}, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(HEAD_WIDTHS))
@pytest.mark.parametrize("batch", [1, 45, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_dense_head_autograd_matches_plain(cuda_device, name, batch, dtype):
    rng = np.random.RandomState(batch)
    widths = HEAD_WIDTHS[name]
    layers = [{"kernel": (rng.randn(a, b) / np.sqrt(a)).astype(np.float32), "bias": None,
               "bn": random_bn(rng, b)} for a, b in zip(widths[:-2], widths[1:-1])]
    layers.append({"kernel": rng.randn(widths[-2], widths[-1]).astype(np.float32),
                   "bias": rng.randn(widths[-1]).astype(np.float32), "bn": None})
    packed, got_widths = pack_head(torch_tree(layers, cuda_device))
    x = torch.from_numpy(rng.randn(batch, widths[0]).astype(np.float32)).to(cuda_device, dtype)
    _check_autograd(KD.dense_head_autograd, dense_head_plain, (x, packed, got_widths), {}, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg_name", ["roomnet-224", "roomnet-224-bf16"])
def test_cuda_train_step_launches_and_updates(cuda_device, cfg_name):
    """One step at 224 (batch 2, converted weights) per BN mode: 10/10/3/1
    launches with TrainHParams(), 10/10/3/0 with batch statistics; finite
    loss, every trainable moved, the caller's variables untouched."""
    from roomnet_tpu_torch.params import schema
    from roomnet_tpu_torch.train.step import TrainHParams, init_train_state, make_train_step

    variables = load_npz(REPO / "artifacts" / "roomnet_params.npz", device=cuda_device)
    before = {k: v.clone() for k, v in schema.flatten_tensors(variables).items()}
    rng = np.random.RandomState(9)
    x = torch.from_numpy(rng.randint(0, 256, size=(2, 224, 224, 3), dtype=np.uint8)).to(cuda_device)
    y = torch.tensor([1, 4], device=cuda_device)
    for batch_stats, head in ((False, 1), (True, 0)):
        hp = TrainHParams(compute_bn_mean_var=batch_stats, update_bn_moving=batch_stats)
        state = init_train_state(variables, hp)
        counts = _build.launch_counts()
        new, metrics = make_train_step(hp, registry.get(cfg_name))(state, x, y)
        assert launched(counts) == [10, 10, 3, head]
        assert torch.isfinite(metrics["loss"]) and int(new.step) == 1
        assert all(not torch.equal(v, state.train_vars[p]) for p, v in new.train_vars.items())
    for k, v in schema.flatten_tensors(variables).items():
        assert torch.equal(v, before[k]), k


# -- the serving daemon on the card --------------------------------------------

def _decoded(clf, bodies):
    import cv2

    return np.stack([clf.prep_decoded(cv2.imdecode(np.frombuffer(b, np.uint8), cv2.IMREAD_COLOR))
                     for b in bodies])


def _assert_results(results, ids, probs):
    for r, i, p in zip(results, ids, probs):
        assert r["class_id"] == int(i), (r, i)
        np.testing.assert_allclose(r["probs"], p, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_cuda_server_buckets_match_the_batch_forward(cuda_device):
    """/classify and /classify_batch of 1-4 images (buckets 1, 2, 4) answer
    as `predict` of the same decoded batch, with each device call launching
    each kernel as often as one forward does; e2e spans of predict on the
    card include the copy to the device."""
    import base64
    import json

    from roomnet_tpu_torch.infer.server import ClassifierServer
    from roomnet_tpu_torch.utils.profiling import SPANS

    clf = tiny_classifier(0, batch_size=4, device=cuda_device)
    bodies = [img_bytes(seed) for seed in range(4)]
    ids, probs = clf.predict(_decoded(clf, bodies))
    SPANS.reset()
    clf.predict(_decoded(clf, bodies * 3))
    assert SPANS.summary()["e2e/device_put"]["count"] == 3 and SPANS.summary()["e2e/wait_put"]["count"] == 3
    srv = ClassifierServer(clf, port=0, warmup=True).start()
    try:
        before = _build.launch_counts()
        calls0 = SPANS.summary().get("serve/device_call", {}).get("count", 0)
        for n in (1, 2, 3, 4):
            status, out = post(srv, "/classify_batch",
                               json.dumps({"images": [base64.b64encode(b).decode() for b in bodies[:n]]}).encode())
            assert status == 200
            _assert_results(out["results"], ids[:n], probs[:n])
        for i, b in enumerate(bodies):
            status, out = post(srv, "/classify", b)
            assert status == 200
            _assert_results([out], ids[i:i + 1], probs[i:i + 1])
        calls = SPANS.summary()["serve/device_call"]["count"] - calls0
        assert calls == 8
        assert launched(before) == [3 * calls, 3 * calls, calls, calls]
    finally:
        srv.stop()


@pytest.mark.cuda
def test_cuda_server_reload_under_live_traffic(cuda_device, tmp_path):
    """/reload racing 32 requests on the card: every request answers 200,
    and afterwards every answer is the new weights' (`predict` on them)."""
    import threading

    from roomnet_tpu_torch.infer.server import ClassifierServer
    from roomnet_tpu_torch.params.checkpoint import CheckpointStore

    clf = tiny_classifier(1, batch_size=4, device=cuda_device)
    new = tiny_classifier(2, batch_size=4, device=cuda_device)
    mdir = str(tmp_path / "models")
    CheckpointStore(mdir).save(new.variables, 3)
    bodies = [img_bytes(seed) for seed in range(4)]
    want_ids, want_probs = new.predict(_decoded(new, bodies))
    srv = ClassifierServer(clf, port=0, max_inflight=64, model_dir=mdir, warmup=True).start()
    try:
        statuses = []
        lock = threading.Lock()

        def hit(i):
            s, _ = post(srv, "/classify", bodies[i % 4])
            with lock:
                statuses.append(s)

        threads = [threading.Thread(target=hit, args=(i,)) for i in range(32)]
        for t in threads:
            t.start()
        st, out = post(srv, "/reload", b"")
        assert st == 200 and out["step"] == 3
        for t in threads:
            t.join(timeout=60)
        assert len(statuses) == 32 and all(s == 200 for s in statuses), statuses
        for i, b in enumerate(bodies):
            st, out = post(srv, "/classify", b)
            _assert_results([out], want_ids[i:i + 1], want_probs[i:i + 1])
    finally:
        srv.stop()


@pytest.mark.cuda
def test_cuda_server_slow_forward_reads_its_own_staged_batch(cuda_device):
    """A /classify_batch of 12 images at batch 4 is one round of three
    bucket-4 chunks. Each forward first sleeps on the device, so chunk k's
    copy waits behind chunk k-1's sleep while the worker stages chunk k+1:
    a staging buffer kept and rewritten would hand chunk k chunk k+1's
    pixels. A fresh pinned tensor per chunk (the caching host allocator
    reuses a block only after its copy) keeps every row its own."""
    import base64
    import json

    from roomnet_tpu_torch.infer.server import ClassifierServer

    clf = tiny_classifier(3, batch_size=4, device=cuda_device)
    bodies = [img_bytes(seed) for seed in range(12)]
    ids, probs = clf.predict(_decoded(clf, bodies))
    real = clf._predict

    def slow(variables, xb):
        torch.cuda._sleep(50_000_000)  # tens of ms of device time, before xb is read
        return real(variables, xb)

    srv = ClassifierServer(clf, port=0, max_inflight=64, warmup=True).start()
    clf._predict = slow
    try:
        for _ in range(3):
            status, out = post(srv, "/classify_batch",
                               json.dumps({"images": [base64.b64encode(b).decode() for b in bodies]}).encode())
            assert status == 200
            _assert_results(out["results"], ids, probs)
    finally:
        srv.stop()


@pytest.mark.cuda
def test_cuda_swaps_keep_the_packed_weight_cache_flat(cuda_device):
    """20 assignments of `clf.variables` (a new tree each time, as a reload
    loads one), each followed by a forward through the kernels: the conv's
    packed-weight cache holds what one did."""
    import dataclasses
    import gc

    from roomnet_tpu_torch.models.roomnet import init_variables
    from roomnet_tpu_torch.ops.kernels import conv3x3 as KC

    for dtype in (torch.float32, torch.bfloat16):
        clf = tiny_classifier(4, batch_size=4, device=cuda_device)
        clf.cfg = dataclasses.replace(clf.cfg, compute_dtype=dtype)
        x = torch.zeros((4, 32, 32, 3), dtype=torch.uint8, device=cuda_device)
        sizes = []
        for i in range(20):
            clf.variables = init_variables(torch.Generator(cuda_device).manual_seed(5 + i % 2), clf.cfg)
            clf._predict(clf.variables, x)
            torch.cuda.synchronize()
            gc.collect()
            sizes.append(len(KC._packed))
        assert sizes == [sizes[0]] * 20, (dtype, sizes)


# -- the training loop on the card ---------------------------------------------
# tests/tiny.py's geometry (chip_smoke.tiny_config) with 2 classes, over 20
# PNG files of 40x48 written here; one forward launches conv3x3 3 times,
# relu6_pool_bn 3, residual_bn 1 and dense_head 1.

def _loop_setup(tmp_path, **kw):
    """(TrainConfig, cfg) of a tiny run over a fresh 2-class directory, its
    list files written."""
    import dataclasses

    from roomnet_tpu_torch.data.dataset import extract_fpaths
    from roomnet_tpu_torch.train.loop import Phase, TrainConfig

    rng = np.random.RandomState(0)
    for cls, base in [("Kitchen", 40), ("Bedroom", 200)]:
        d = tmp_path / "data" / cls
        d.mkdir(parents=True)
        for i in range(10):
            im = np.clip(rng.randint(base - 30, base + 60, (40, 48, 3)), 0, 255).astype(np.uint8)
            (d / f"im_{i}.png").write_bytes(chip_smoke.png_bytes(im))
    base = dict(data_dir=str(tmp_path / "data"), train_list_fpath=str(tmp_path / "train_list.txt"),
                val_list_fpath=str(tmp_path / "val_list.txt"), stats_fpath=str(tmp_path / "stats.json"),
                model_dir=str(tmp_path / "models"), img_side=32, train_steps=1000, save_freq=5, val_batch_size=2,
                learn_rate=1e-3, l2_coeff=6e-2, stall_timeout_s=0,
                phases=(Phase(until_step=1 << 62, batch_size=4),))
    base.update(kw)
    tc = TrainConfig(**base)
    extract_fpaths(tc.data_dir, tc.train_list_fpath, tc.val_list_fpath, str(tmp_path / "labels.json"), seed=0)
    return tc, dataclasses.replace(chip_smoke.tiny_config(), num_classes=2)


def _feeder_batches(tc, n):
    """The first n (x, y) of a fresh TrainFeeder over tc's list and seed."""
    from roomnet_tpu_torch.data.loader import TrainFeeder

    with open(tc.train_list_fpath) as f:
        lines = f.readlines()
    with TrainFeeder(lines, batch_size=tc.phases[0].batch_size, shuffle=True, im_side=tc.img_side,
                     random_crop=True, preprocess=True, seed=tc.seed) as feeder:
        return [feeder.dequeue() for _ in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("steps_per_call", [1, 3])
def test_cuda_trainer_matches_hand_driven_steps(cuda_device, tmp_path, steps_per_call):
    """chip_smoke.py phase 9 (b) at tiny: Trainer.train(6) equals six
    hand-driven steps within 1e-5 (params, BN stats, Adam state, losses);
    the launches over the run are 6 step forwards and 1 validation forward.
    Both run with deterministic cuDNN algorithms (chip_smoke.deterministic)."""
    import json

    from roomnet_tpu_torch.train.loop import Trainer

    tc, cfg = _loop_setup(tmp_path, steps_per_call=steps_per_call)
    tr = Trainer(tc, cfg)
    with chip_smoke.deterministic():
        states, want_losses = chip_smoke.hand_driven(tr, 6)
        losses = chip_smoke.record_losses(tr)
        before = _build.launch_counts()
        state = tr.train(total_steps=6, log_every=1)
    assert launched(before) == [21, 21, 7, 7]
    assert chip_smoke.state_gap(chip_smoke.state_tensors(state), chip_smoke.state_tensors(states[-1]), 1e-5) <= 1e-5
    if steps_per_call == 1:
        np.testing.assert_allclose([float(v) for v in losses], want_losses, rtol=1e-5, atol=1e-5)
    stats = json.load(open(tc.stats_fpath))
    assert [s["step"] for s in stats] == [5]
    assert [p.rsplit("/", 1)[1] for _, _, p in tr.store.list_checkpoints()] == [
        f"roomnet--{stats[0]['accuracy']}--5.npz"]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["slow-step", "copy-behind-step", "slow-copy"])
def test_cuda_slow_step_reads_its_own_batch(cuda_device, tmp_path, monkeypatch, mode):
    """Each step sums the batch it was given on the compute stream, and the
    loop reads no loss until its end (log_every past the run), so the host
    stages batches ahead of the steps. slow-step: each step first sleeps on
    the compute stream; a device batch handed to a later copy before its
    step ran (no record_stream) would sum other pixels. copy-behind-step:
    the same, and the copy stream waits for the compute stream before each
    copy, so a staged batch's copy runs only after the previous step while
    the host has already written the next batch: a pinned buffer kept and
    rewritten would hand that copy the next batch's pixels. slow-copy: the
    copy stream sleeps before each copy and the step reads at once; a step
    that did not wait for its copy's event would read the buffer early.
    Each sum must be that of the batch a fresh feeder dequeues at its step."""
    from roomnet_tpu_torch.train import loop
    from roomnet_tpu_torch.train.loop import Trainer

    tc, cfg = _loop_setup(tmp_path, save_freq=0)
    want = [int(x.astype(np.int64).sum()) for x, _ in _feeder_batches(tc, 12)]
    tr = Trainer(tc, cfg)
    orig, seen = tr._step_fn, []

    def step_fn(ph, **kw):
        fn = orig(ph, **kw)

        def wrapped(state, x, *a):
            if mode != "slow-copy":
                torch.cuda._sleep(50_000_000)  # tens of ms of device time, before x is read
            seen.append(x.sum(dtype=torch.int64))
            return fn(state, x, *a)
        return wrapped

    tr._step_fn = step_fn
    real = loop.to_device_async

    def staged(arrays, device, stream):
        if mode == "copy-behind-step":
            stream.wait_stream(torch.cuda.current_stream(device))
        elif mode == "slow-copy":
            with torch.cuda.stream(stream):
                torch.cuda._sleep(50_000_000)
        return real(arrays, device, stream)

    monkeypatch.setattr(loop, "to_device_async", staged)
    tr.train(total_steps=12, log_every=1000)
    assert [int(s) for s in seen] == want


@pytest.mark.cuda
def test_cuda_stall_save_writes_the_last_completed_state(cuda_device, tmp_path):
    """Each step leaves device work in flight (a long sleep on the compute
    stream) and then sleeps on the host past the stall timeout, so the
    watchdog thread saves while the main thread keeps issuing steps. Every
    stall checkpoint holds the hand-driven state of the step it names."""
    import time

    from roomnet_tpu_torch.train.loop import Trainer

    tc, cfg = _loop_setup(tmp_path, save_freq=1000, stall_timeout_s=0.25)
    tr = Trainer(tc, cfg)
    with chip_smoke.deterministic():
        states, _ = chip_smoke.hand_driven(tr, 5)
    orig = tr._step_fn

    def stalling_step_fn(ph, **kw):
        fn = orig(ph, **kw)

        def wrapped(*a):
            out = fn(*a)
            torch.cuda._sleep(500_000_000)  # a few hundred ms of device work behind the step
            time.sleep(0.6)
            return out
        return wrapped

    tr._step_fn = stalling_step_fn
    with chip_smoke.deterministic():
        tr.train(total_steps=5, log_every=1)
    stalls = [(s, p) for s, sfx, p in tr.store.list_checkpoints() if sfx == "stall"]
    assert stalls
    for step, path in stalls:
        with np.load(path) as f:
            saved = dict(f)
        assert int(saved["meta/step"]) == step
        assert chip_smoke.state_gap(saved, chip_smoke.state_tensors(states[step - 1]), 1e-5) <= 1e-5


@pytest.mark.cuda
def test_cuda_device_prefetch_with_a_slow_consumer(cuda_device):
    """The consumer sleeps on its stream before it reads each batch, while
    device_prefetch copies the next ones on its own stream: every batch is
    read as it was on the host, in order."""
    from roomnet_tpu_torch.data.loader import device_prefetch

    rng = np.random.RandomState(12)
    batches = [(rng.randint(0, 256, (8, 32, 32, 3), np.uint8), rng.randint(0, 6, 8).astype(np.int32))
               for _ in range(16)]
    seen = []
    for x, y in device_prefetch(iter(batches), size=2, device=cuda_device):
        assert x.device.type == "cuda" and x.dtype == torch.uint8 and y.dtype == torch.int32
        torch.cuda._sleep(20_000_000)
        seen.append((x.sum(dtype=torch.int64), y.sum(dtype=torch.int64)))
    assert [(int(a), int(b)) for a, b in seen] == [(int(x.astype(np.int64).sum()), int(y.sum()))
                                                    for x, y in batches]


def _dp_inputs():
    """tiny-geometry variables with random BN fields (as a trained model
    has) and a batch of 8, from numpy seeds."""
    from roomnet_tpu_torch.params import schema

    rng = np.random.RandomState(21)
    flat = schema.flatten_variables(M.init_variables(torch.Generator().manual_seed(3), chip_smoke.tiny_config()))
    for k in flat:
        if "bn/" in k:
            n = flat[k].shape
            flat[k] = {"scale": rng.rand(*n) + 0.5, "bias": rng.randn(*n) * 0.1, "mean": rng.randn(*n) * 0.1,
                       "var": rng.rand(*n) + 0.5}[k.rsplit("/", 1)[1]].astype(np.float32)
    x = rng.randint(0, 256, (8, 32, 32, 3)).astype(np.uint8)
    y = rng.randint(0, 4, (8,)).astype(np.int32)
    return flat, x, y


@pytest.mark.cuda
def test_cuda_two_ranks_on_one_card_match_one_rank(cuda_device, tmp_path):
    """Two ranks on the one card over gloo (NCCL refuses two ranks on one
    device): three DP steps, inference BN and batch statistics, against the
    global batch on one rank in this process. Params, moving stats and the
    Adam count within 1e-4, the moments under batch statistics within 5e-3
    of their largest (tests/test_torch_parallel.py's rule); both ranks hold
    the same state; each rank launches 10/10/3/1 kernels per tiny step with
    inference BN (3 convs, 3 pools, 1 residual at tiny) and no head with
    batch statistics."""
    import torch_dp_worker as W

    flat, x, y = _dp_inputs()
    hp = dict(learn_rate=1e-3, num_steps=1000, l2_coeff=6e-2)
    cases = {"infbn": dict(hp=hp, steps=3),
             "trainbn": dict(hp=dict(hp, compute_bn_mean_var=True, update_bn_moving=True), steps=3)}
    ranks = W.spawn("dp_steps", 2, tmp_path, flat=flat, x=x, y=y, cases=cases, device="cuda")
    for name, c in cases.items():
        one = W._steps(flat, x, y, c["hp"], c["steps"], group=None, rank=0, world=1, device="cuda")
        got = ranks[0][name]["state"]
        for k, v in got.items():
            np.testing.assert_array_equal(ranks[1][name]["state"][k], v, err_msg=k)
        moments = {k for k in got if k.startswith(("opt/mu/", "opt/nu/"))} if name == "trainbn" else set()
        for k in moments:
            assert np.abs(got[k].astype(np.float64) - one["state"][k]).max() <= 5e-3 * np.abs(one["state"][k]).max()
        chip_smoke.state_gap({k: v for k, v in got.items() if k not in moments},
                             {k: v for k, v in one["state"].items() if k not in moments}, 1e-4)
        per_step = [3, 3, 1, 1] if name == "infbn" else [3, 3, 1, 0]
        for r in ranks:
            assert r[name]["launches"] == [n * 3 for n in per_step], r[name]["launches"]


@pytest.mark.cuda
def test_cuda_dcp_store_on_the_card(cuda_device, tmp_path):
    """The orbax (DCP) store with variables and Adam state on the card: an
    asynchronous save, `wait`, and a load equal to what was saved."""
    from roomnet_tpu_torch.params import schema
    from roomnet_tpu_torch.params.orbax_io import OrbaxCheckpointStore
    from roomnet_tpu_torch.train.optimizer import flatten_opt_state
    from roomnet_tpu_torch.train.step import init_train_state

    flat, _, _ = _dp_inputs()
    state = init_train_state(schema.variables_from_numpy(flat, chip_smoke.tiny_config(), cuda_device))
    store = OrbaxCheckpointStore(str(tmp_path), async_save=True)
    store.save(state.variables(chip_smoke.tiny_config()), 4, suffix="0.5",
               opt_state_flat=flatten_opt_state(state.opt_state))
    store.wait()
    var_flat, step, opt = store.load(with_opt_state=True)
    assert step == 4 and set(var_flat) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(var_flat[k], v, err_msg=k)
    assert int(opt["count"]) == 0


def _mesh_flat() -> dict:
    from roomnet_tpu_torch.params import schema

    cfg = chip_smoke.tiny_config()
    return schema.flatten_variables(M.init_variables(torch.Generator().manual_seed(3), cfg))


def _one_process_answers(flat: dict, requests: dict, device) -> dict:
    from roomnet_tpu_torch.infer.server import ClassifierServer
    from roomnet_tpu_torch.params import schema

    cfg = chip_smoke.tiny_config()
    clf = RoomNetClassifier(schema.variables_from_numpy(flat, cfg, device), cfg, batch_size=8,
                            class_labels=["A", "B", "C", "D"], device=device)
    srv = ClassifierServer(clf, port=0, warmup=True).start()
    try:
        return chip_smoke.classify_requests(srv.port, requests)
    finally:
        srv.stop()


@pytest.mark.cuda
def test_cuda_world_of_one_mesh_server_equals_no_mesh(cuda_device):
    """make_mesh() without a group on the card: a world of one over NCCL.
    Its server answers as the server without a mesh, bit for bit, with
    buckets from 1 and 3/3/1/1 launches per tiny device call."""
    import torch.distributed as dist

    from roomnet_tpu_torch.infer.server import ClassifierServer
    from roomnet_tpu_torch.parallel import distributed
    from roomnet_tpu_torch.parallel.mesh import make_mesh
    from roomnet_tpu_torch.params import schema

    flat, requests = _mesh_flat(), chip_smoke.mesh_requests(n_stream=20)
    want = _one_process_answers(flat, requests, cuda_device)
    cfg = chip_smoke.tiny_config()
    try:
        mesh = make_mesh()
        assert dist.get_backend() == "nccl"
        clf = RoomNetClassifier(schema.variables_from_numpy(flat, cfg, cuda_device), cfg, batch_size=8,
                                class_labels=["A", "B", "C", "D"], mesh=mesh)
        srv = ClassifierServer(clf, port=0, warmup=True).start()
        try:
            sizes = chip_smoke.count_predicts(clf)
            before = _build.launch_counts()
            got = chip_smoke.classify_requests(srv.port, requests)
            launches = launched(before)
        finally:
            srv.stop()
        assert srv._bucket_sizes == [1, 2, 4, 8]
        assert chip_smoke.answers_gap(got, want, "world of one") == (0.0, True)
        assert launches == [3 * len(sizes), 3 * len(sizes), len(sizes), len(sizes)]
    finally:
        distributed.shutdown()


@pytest.mark.cuda
def test_cuda_two_rank_mesh_server_on_one_card(cuda_device, tmp_path):
    """Two ranks on the one card over gloo (tests/torch_dp_worker.py:
    mesh_server): buckets [2, 4, 8], both ranks make the same calls, the
    answers within 1e-5 of the server without a mesh with class_id equal,
    3/3/1/1 launches per rank per tiny call, /reload of a second tree on
    both ranks, and both ranks end with 0."""
    import torch_dp_worker as W

    flat, requests = _mesh_flat(), chip_smoke.mesh_requests(n_stream=20)
    second = dict(flat, **{"dense/2/kernel": np.roll(flat["dense/2/kernel"], 1, axis=1)})
    ranks = W.spawn("mesh_server", 2, tmp_path, flat=flat, requests=requests,
                    runs={"serve": {"reloads": [(12, second)]}}, device="cuda")
    r0, r1 = (r["serve"] for r in ranks)
    assert r0["rc"] == r1["rc"] == 0 and "error" not in r0["client"], r0["client"]
    assert r0["buckets"] == [2, 4, 8] and r0["sizes"] == r1["sizes"]
    gap, same = chip_smoke.answers_gap(r0["client"]["initial"], _one_process_answers(flat, requests, cuda_device),
                                       "two ranks")
    assert same and gap <= 1e-5, gap
    reload = r0["client"]["reloads"][0]
    assert reload["status"] == 200 and r1["model_version"]["step"] == 12
    gap, same = chip_smoke.answers_gap(reload["answers"], _one_process_answers(second, requests, cuda_device),
                                       "two ranks after /reload")
    assert same and gap <= 1e-5, gap
    for r in (r0, r1):
        n = len(r["sizes"])
        assert r["launches"] == {"conv3x3": 3 * n, "relu6_pool_bn": 3 * n, "residual_bn": n, "dense_head": n}


# ResNet-50 v1.5's convs (models/resnet.py): the streamed conv3x3 path and
# the persistent conv1x1 GEMM (csrc/conv1x1.cu) against their plain versions
# at each of the 16 3x3 and 36 1x1 sites at batch 8, and at batch 256 at
# each stage's first block's 3x3 and at every 1x1 site (batch 256 is where
# a block walks many tiles), within one bf16 ulp, with the site's bias, ReLU
# and residual.
R50_SITES = registry.get("resnet50-v1.5-224-bf16").conv_sites()
R50_FIRST = [i for i, s in enumerate(R50_SITES) if "/0/" in s["site"] and not s["site"].endswith("conv1")]
R50_B256 = sorted(set(R50_FIRST) | {i for i, s in enumerate(R50_SITES) if s["kernel"] == "conv1x1"})


def _r50_case(device, site, batch, seed):
    from roomnet_tpu_torch.ops.kernels import conv1x1 as K1

    g = torch.Generator(device=device).manual_seed(seed)
    side, cin, cout, stride, k = site["side"], site["cin"], site["cout"], site["stride"], 3 \
        if site["kernel"] == "conv3x3" else 1
    so = (side - 1) // stride + 1
    x = torch.randn(batch, side, side, cin, generator=g, device=device).to(torch.bfloat16)
    w = (torch.randn(k, k, cin, cout, generator=g, device=device) / (k * cin ** 0.5)).to(torch.bfloat16)
    bias = torch.randn(cout, generator=g, device=device)
    res = torch.randn(batch, so, so, cout, generator=g, device=device).to(torch.bfloat16) if site["residual"] \
        else None
    kw = {"stride": stride, "relu": site["relu"], "residual": res}
    if k == 3:
        return conv3x3, conv3x3_plain, (x, w, bias), dict(kw, padding=1)
    return K1.conv1x1, K1.conv1x1_plain, (x, w, bias), kw


@pytest.mark.cuda
@pytest.mark.parametrize("batch,site", [(8, i) for i in range(len(R50_SITES))] + [(256, i) for i in R50_B256],
                         ids=[f"b8-{s['site']}" for s in R50_SITES] + [f"b256-{R50_SITES[i]['site']}"
                                                                         for i in R50_B256])
def test_cuda_resnet50_convs_match_plain(cuda_device, batch, site):
    kern, plain, args, kwargs = _r50_case(cuda_device, R50_SITES[site], batch, seed=site)
    before = _build.launch_counts()
    got, want = kern(*args, **kwargs), plain(*args, **kwargs)
    torch.cuda.synchronize()
    assert launched(before, [kern.__name__]) == [1] and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=BF16_ULP, atol=BF16_ULP * 8)


# The persistent 1x1 at the edges of its walk: a ragged last pixel tile
# (batch 3 at 7x7: 147 pixels, one whole tile and 19 rows), fewer tiles than
# blocks (batch 1 at layer4's 2048 -> 512: 4 tiles), and stride 2 at batch
# 256 (layer3's projection; and layer2's input with a residual and a ReLU,
# whose residual and output boxes are 4 rows of 28 pixels).
CONV1X1_EDGES = {  # (B, H, W, Cin), Cout, stride, relu, residual
    "ragged-b3-7x7": ((3, 7, 7, 512), 2048, 1, True, True),
    "fewer-tiles-than-blocks-b1": ((1, 7, 7, 2048), 512, 1, True, False),
    "stride2-proj-b256": ((256, 28, 28, 512), 1024, 2, False, False),
    "stride2-residual-b256": ((256, 56, 56, 256), 512, 2, True, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CONV1X1_EDGES))
def test_cuda_conv1x1_persistent_walk_matches_plain(cuda_device, case):
    from roomnet_tpu_torch.ops.kernels import conv1x1 as K1

    shape, cout, stride, relu, with_res = CONV1X1_EDGES[case]
    g = torch.Generator(device=cuda_device).manual_seed(22)
    B, H, W, cin = shape
    so = (H - 1) // stride + 1
    x = torch.randn(shape, generator=g, device=cuda_device).to(torch.bfloat16)
    w = (torch.randn(1, 1, cin, cout, generator=g, device=cuda_device) / cin ** 0.5).to(torch.bfloat16)
    bias = torch.randn(cout, generator=g, device=cuda_device)
    res = torch.randn(B, so, so, cout, generator=g, device=cuda_device).to(torch.bfloat16) if with_res else None
    kw = {"stride": stride, "relu": relu, "residual": res}
    got, want = K1.conv1x1(x, w, bias, **kw), K1.conv1x1_plain(x, w, bias, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=BF16_ULP, atol=BF16_ULP * 8)
    v = K1.variant(shape, cout, stride=stride, residual=with_res)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert v["tiles"] == v["pixel_tiles"] * v["cout_tiles"] and v["blocks"] == min(v["tiles"], sms)
    assert v["tiles_per_block"] == -(-v["tiles"] // v["blocks"]) and v["slots"] == (3 if with_res else 2)
    if case == "ragged-b3-7x7":
        assert (v["cols"], v["pixel_tiles"]) == (128, 2)
    elif case == "fewer-tiles-than-blocks-b1":
        assert v["tiles"] == v["blocks"] == 4 < sms
    else:
        assert v["cols"] == so and v["rows"] * so <= 128 and v["tiles_per_block"] > 1


@pytest.mark.cuda
def test_cuda_resnet50_forward_counts_conv1x1_and_conv3x3_launches(cuda_device):
    """One ResNet-50 forward (batch 8) moves kernel/launches.conv1x1 by 36
    and kernel/launches.conv3x3 by 16, and no other kernel's counter."""
    from roomnet_tpu_torch.models import resnet as R

    cfg, batch = registry.get("resnet50-v1.5-224-bf16"), 8
    assert [s["kernel"] for s in cfg.conv_sites()].count("conv1x1") == 36
    clf = RoomNetClassifier(R.init_variables(torch.Generator(device=cuda_device).manual_seed(0), cfg), cfg,
                            batch_size=batch, device=cuda_device)
    x = torch.randint(0, 256, (batch, cfg.im_side, cfg.im_side, 3), dtype=torch.uint8, device=cuda_device)
    before = _build.launch_counts()
    clf._predict(clf.variables, x)
    torch.cuda.synchronize()
    moved = launched(before, _build.SOURCES)
    clf.close()
    assert dict(zip(_build.SOURCES, moved)) == {"conv3x3": 16, "conv1x1": 36, "relu6_pool_bn": 0, "residual_bn": 0,
                                                "dense_head": 0}


@pytest.mark.cuda
def test_cuda_streamed_paths_refuse_what_they_do_not_take(cuda_device):
    from roomnet_tpu_torch.ops.kernels import conv1x1 as K1

    x = torch.zeros((1, 8, 8, 64), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(TypeError):
        conv3x3(x.float(), torch.zeros((3, 3, 64, 64), device=cuda_device), padding=1)
    with pytest.raises(ValueError):
        conv3x3(x[..., :48].contiguous(), torch.zeros((3, 3, 48, 64), device=cuda_device), padding=1)
    with pytest.raises(TypeError):
        K1.conv1x1(x.float(), torch.zeros((1, 1, 64, 64), device=cuda_device))
    with pytest.raises(ValueError):
        K1.conv1x1(x, torch.zeros((1, 1, 64, 96), device=cuda_device))


# What conv3x3.variant() reported at ResNet-50's 16 3x3 sites (batch 256)
# before the 1x1 GEMM took a persistent body of its own: the streamed path
# (igemm.cuh's `body`) keeps its tile, stages and shared memory.
R50_3X3_VARIANTS = (  # VARIANT_FIELDS, one tuple a site, in conv_sites() order
    [('wgmma streamed', 64, 1, 2, 56, 99392, 2, 4, 0, 0, 1, 64, 0)] * 3
    + [('wgmma streamed', 128, 1, 4, 28, 99376, 2, 3, 0, 0, 1, 64, 0)] * 4
    + [('wgmma streamed', 128, 1, 7, 14, 99376, 2, 3, 0, 0, 2, 64, 0)] * 6
    + [('wgmma streamed', 128, 2, 7, 7, 99376, 2, 3, 0, 0, 4, 64, 0)] * 3
)


@pytest.mark.cuda
def test_cuda_conv3x3_resnet50_variants_are_pinned(cuda_device):
    sites = [s for s in R50_SITES if s["kernel"] == "conv3x3"]
    got = [KC.variant((256, s["side"], s["side"], s["cin"]), s["cout"], torch.bfloat16, padding=1,
                      stride=s["stride"]) for s in sites]
    assert [tuple(v[f] for f in KC.VARIANT_FIELDS) for v in got] == R50_3X3_VARIANTS


# What conv3x3.variant() reported at RoomNet's 10 sites (tests/torch_port_util.py
# CONV_SITES, batch 256) before the streamed path was added: their paths,
# tiles and plans stay as they were.
ROOMNET_VARIANTS = {  # VARIANT_FIELDS, one tuple a site
    "torch.bfloat16": [
        ('mma.sync', 8, 4, 32, 16, 20912, 0, 2, 0, 0, 0, 0, 0),
        ('wgmma+TMA', 32, 4, 16, 14, 62512, 2, 3, 1, 64, 0, 0, 0),
        ('wgmma+TMA', 32, 2, 8, 14, 95280, 2, 3, 1, 64, 0, 0, 0),
        ('wgmma+TMA', 32, 2, 8, 14, 95280, 2, 3, 1, 64, 0, 0, 0),
        ('wgmma+TMA', 64, 2, 8, 14, 107552, 2, 2, 1, 128, 0, 0, 0),
        ('wgmma+TMA', 64, 2, 8, 14, 226352, 2, 3, 1, 128, 0, 0, 0),
        ('wgmma+TMA', 128, 1, 4, 14, 226336, 2, 2, 1, 128, 0, 0, 0),
        ('wgmma+TMA', 16, 2, 8, 14, 209952, 2, 2, 1, 32, 0, 0, 0),
        ('wgmma+TMA', 16, 4, 16, 14, 75312, 2, 3, 1, 32, 0, 0, 0),
        ('wgmma+TMA', 16, 4, 16, 14, 75312, 2, 3, 1, 32, 0, 0, 0),
    ],
    "torch.float32": [
        ('f32 CUDA cores', 8, 32, 64, 32, 74112, 0, 2, 0, 0, 0, 0, 0),
        ('tf32x3 wgmma+TMA', 32, 4, 16, 14, 111680, 2, 4, 0, 0, 1, 8, 2),
        ('tf32x3 wgmma+TMA', 32, 4, 16, 14, 166976, 2, 4, 0, 0, 1, 8, 2),
        ('tf32x3 wgmma+TMA', 32, 4, 16, 14, 166976, 2, 4, 0, 0, 1, 8, 2),
        ('tf32x3 wgmma+TMA', 64, 2, 8, 14, 199744, 2, 4, 0, 0, 1, 8, 2),
        ('tf32x3 wgmma+TMA', 32, 4, 16, 14, 222256, 2, 3, 0, 0, 2, 8, 2),
        ('tf32x3 wgmma+TMA', 32, 4, 16, 14, 222256, 2, 3, 0, 0, 4, 8, 2),
        ('tf32x3 wgmma+TMA', 16, 4, 16, 14, 222256, 2, 3, 0, 0, 1, 8, 2),
        ('tf32x3 wgmma+TMA', 16, 4, 16, 14, 111680, 2, 4, 0, 0, 1, 8, 2),
        ('tf32x3 wgmma+TMA', 16, 4, 16, 14, 111680, 2, 4, 0, 0, 1, 8, 2),
    ],
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cuda_conv3x3_roomnet_variants_are_pinned(cuda_device, dtype):
    got = [KC.variant((256, h, h, cin), cout, dtype) for h, cin, cout in U.CONV_SITES]
    assert [tuple(v[f] for f in KC.VARIANT_FIELDS) for v in got] == ROOMNET_VARIANTS[str(dtype)]


def _torchvision_state(v: dict) -> dict:
    """The reference's flat variables under torchvision's resnet50 names
    (conv kernels HWIO -> OIHW, the FC's (in, out) -> (out, in))."""
    field = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
    state = {}
    for path, t in v.items():
        parts = path.split("/")
        if parts[0] == "fc":
            state[f"fc.{'weight' if parts[1] == 'kernel' else 'bias'}"] = t.t() if parts[1] == "kernel" else t
            continue
        if parts[0] == "stem":
            prefix, rest = ("conv1" if parts[1] == "conv" else "bn1"), parts[2:]
        elif parts[2] == "proj":
            prefix, rest = f"{parts[0]}.{parts[1]}.downsample.{0 if parts[3] == 'conv' else 1}", parts[4:]
        else:
            prefix, rest = ".".join(parts[:3]), parts[3:]
        state[f"{prefix}.{field[rest[0]]}" if rest else f"{prefix}.weight"] = t if rest else t.permute(3, 2, 0, 1)
    return state


@pytest.mark.cuda
def test_cuda_resnet50_reference_is_torchvisions(cuda_device):
    """The benchmark's reference (benchmark/arch/resnet50/reference.py) and
    torchvision's resnet50 (weights=None, loaded with the same seeded
    weights) give the same logits, both in f32 with TF32 off. Skips where
    torchvision is not installed; nothing is downloaded."""
    tv = pytest.importorskip("torchvision")
    import json

    from benchmark.lib import harness, images

    arch = harness.load_arch("resnet50")
    cfg = json.loads((REPO / "benchmark" / "configs" / "resnet50-v1.5-224-bf16.json").read_text())
    x, _ = images.pool(2**33 + 3, 16, 224, 4, 16, cuda_device)
    v = arch.weights.make(cfg, 2**33 + 3, x, cuda_device)
    model = tv.models.resnet50(weights=None).to(cuda_device).eval()
    missing, unexpected = model.load_state_dict(_torchvision_state(v), strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing), (unexpected, missing)
    with arch.reference.precision("f32"), torch.no_grad():
        want = model(arch.reference.normalize(torch.as_tensor(x).to(cuda_device), cfg))
        got = arch.reference.forward(v, torch.as_tensor(x).to(cuda_device), cfg, "f32")
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * want.abs().max().item())
