"""Shared helpers of the tests of the PyTorch port (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages as
arrays; JAX runs on the CPU, PyTorch on the CPU unless a test is marked
`cuda` (skipped where no GPU is present).
"""

import numpy as np
import pytest
import torch

from roomnet_tpu_torch.ops.blocks import bn_fold
from roomnet_tpu_torch.ops.kernels.conv3x3 import conv3x3, conv3x3_plain
from roomnet_tpu_torch.ops.kernels.dense_head import dense_head, dense_head_plain, pack_head
from roomnet_tpu_torch.ops.kernels.pool import relu6_pool_bn, relu6_pool_bn_plain
from roomnet_tpu_torch.ops.kernels.residual import residual_bn, residual_bn_plain


@pytest.fixture
def cuda_device():
    """The CUDA device for a `cuda`-marked test; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode); run on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def random_bn(rng: np.random.RandomState, c: int) -> dict[str, np.ndarray]:
    return {
        "scale": (rng.rand(c) + 0.5).astype(np.float32),
        "bias": rng.randn(c).astype(np.float32),
        "mean": rng.randn(c).astype(np.float32),
        "var": (rng.rand(c) + 0.5).astype(np.float32),
    }


def torch_tree(tree, device="cpu"):
    """numpy/JAX leaves -> torch tensors, same structure."""
    if isinstance(tree, dict):
        return {k: torch_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [torch_tree(v, device) for v in tree]
    return None if tree is None else torch.from_numpy(np.array(tree)).to(device)


def wrapper_cases(device, dtype=torch.float32):
    """(wrapper, plain, args, kwargs) of each of the four kernels at a small
    shape, activations in `dtype` on `device`."""
    rng = np.random.RandomState(4)
    s, t = (v.to(device) for v in bn_fold(torch_tree(random_bn(rng, 8))))

    def act(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(device, dtype)

    x, k, res, flat = act(2, 12, 11, 8), act(3, 3, 8, 8), act(2, 15, 14, 8), act(5, 8)
    packed, widths = pack_head(torch_tree([
        {"kernel": rng.randn(8, 4).astype(np.float32), "bias": None, "bn": random_bn(rng, 4)},
        {"kernel": rng.randn(4, 3).astype(np.float32), "bias": rng.randn(3).astype(np.float32),
         "bn": None}]))
    return [
        (conv3x3, conv3x3_plain, (x, k, s), {}),
        (relu6_pool_bn, relu6_pool_bn_plain, (x, s, t), {"ksize": 4, "stride": 2}),
        (residual_bn, residual_bn_plain, (x, res, s, t), {}),
        (dense_head, dense_head_plain, (flat, packed.to(device), widths), {}),
    ]


def outputs(y):
    """A kernel's result as a tuple of tensors."""
    return (y,) if isinstance(y, torch.Tensor) else tuple(y)


# -- the serving daemon --------------------------------------------------------

LABELS4 = ["A", "B", "C", "D"]


def tiny_classifier(seed: int = 0, batch_size: int = 4, device="cpu", **kw):
    """A port classifier at tests/tiny.py's geometry (chip_smoke.tiny_config),
    weights from the port's `init_variables` with `seed`, labels LABELS4."""
    from chip_smoke import tiny_config
    from roomnet_tpu_torch.infer.classify import RoomNetClassifier
    from roomnet_tpu_torch.models.roomnet import init_variables

    cfg = tiny_config()
    variables = init_variables(torch.Generator(device).manual_seed(seed), cfg)
    return RoomNetClassifier(variables, cfg, batch_size=batch_size, class_labels=LABELS4,
                             device=device, **kw)


def img_bytes(seed: int = 0, shape=(60, 80, 3)) -> bytes:
    """PNG bytes of a random BGR image (chip_smoke.png_bytes: zlib only)."""
    from chip_smoke import png_bytes

    return png_bytes(np.random.RandomState(seed).randint(0, 255, shape, np.uint8))


def url(server, path: str) -> str:
    return f"http://127.0.0.1:{server.port}{path}"


def post(server, path: str, body: bytes, headers: dict | None = None):
    """(status, parsed JSON body) of one POST; HTTP errors are answers too."""
    import json
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url(server, path), data=body, method="POST", headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def get_json(server, path: str):
    import json
    import urllib.request

    with urllib.request.urlopen(url(server, path), timeout=10) as r:
        return json.loads(r.read())


# -- a twin of the bf16 conv's wgmma + TMA path (csrc/conv3x3.cu, namespace wg)

# (H, Cin, Cout) of the ten convs of the 224 forward, in order (square inputs).
CONV_SITES = [(224, 3, 8), (220, 8, 32), (215, 32, 32), (210, 32, 32), (205, 32, 64), (100, 64, 64),
              (48, 64, 128), (46, 128, 16), (21, 16, 16), (8, 16, 16)]
WG_GROUPS, WG_TW, WG_HWD = 2, 14, 16  # warpgroups of a block, tile columns, halo line
WG_MAX_SMEM = 232448


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def _lg_chunks(n: int) -> int:
    """log2 of the largest of 1, 2, 4, 8 that divides n (wg::lg_chunks)."""
    return 3 if n % 8 == 0 else 2 if n % 4 == 0 else 1 if n % 2 == 0 else 0


def wg_takes(cin: int) -> bool:
    """wg::takes: Cin / 8 a power of two."""
    return cin % 8 == 0 and (cin // 8) & (cin // 8 - 1) == 0


def wg_layout(cin: int, cout: int, cout_p: int, mi: int, stages: int) -> dict:
    """wg::layout: the shared-memory plan of one launch, bytes from the
    block's 1024-aligned base."""
    c8 = cin // 8
    nsp = (9 * c8 + 1) // 2 * 2
    th = 4 * mi  # tile rows of one warpgroup
    p = {"mi": mi, "stages": stages, "th": th, "c8": c8, "nsp": nsp}
    p["box_bytes"] = (th + 2) * WG_HWD * 16
    p["stage_bytes"] = c8 * p["box_bytes"]
    p["olg"] = p["obox"] = p["obox_bytes"] = 0
    if cout % 8 == 0:
        p["olg"] = _lg_chunks(cout // 8)
        p["obox"] = (cout // 8) >> p["olg"]
        p["obox_bytes"] = _up(th * WG_TW * (16 << p["olg"]), 1024)
    p["off_out"] = _up(WG_GROUPS * stages * p["stage_bytes"], 1024)
    p["off_w"] = p["off_out"] + WG_GROUPS * p["obox"] * p["obox_bytes"]
    p["off_bar"] = p["off_w"] + nsp * cout_p * 16
    p["smem"] = 1024 + p["off_bar"] + 8 * WG_GROUPS * stages
    return p


def wg_plan(cin: int, cout: int) -> dict:
    """wg::plan: the most rows per warp (64 accumulators a thread), 3 stages
    before 2, that let two blocks share an SM, else the first that fits."""
    from roomnet_tpu_torch.ops.kernels.conv3x3 import cout_padded

    cout_p = cout_padded(cout)
    mi_max = 1 if cout_p >= 128 else 2 if cout_p >= 64 else 4
    for limit in (WG_MAX_SMEM // 2 - 1024, WG_MAX_SMEM):
        for mi in (m for m in (4, 2, 1) if m <= mi_max):
            for stages in (3, 2):
                p = wg_layout(cin, cout, cout_p, mi, stages)
                if p["smem"] <= limit:
                    return p
    raise ValueError(f"conv3x3: no plan fits Cin {cin}, Cout {cout}")


def _toff(tap: int) -> int:
    dy, dx = divmod(tap, 3)
    return dy * WG_HWD + dx


def wg_a_descriptor(p: dict, step: int) -> dict:
    """K16 step `step`'s A descriptor for halo pixel 0 of a stage at offset
    0, in bytes (no swizzle, K-major), as the kernel adds it up: start
    (chunk box c, tap offset), leading offset (to the second k half: the
    next box, or the next tap where Cin = 8, the same tap for the padding
    slice), stride offset 128 (8 pixels). The tap and channel box are the
    kernel's shift and mask of slice j (c8 a power of two)."""
    j, lc = 2 * step, p["c8"].bit_length() - 1
    tap, c = j >> lc, j & (p["c8"] - 1)
    lbo = p["box_bytes"]
    if p["c8"] == 1:
        lbo = (_toff(tap + 1) - _toff(tap)) * 16 if tap + 1 < 9 else 0
    return {"start": c * p["box_bytes"] + _toff(tap) * 16, "lbo": lbo, "sbo": 128}


def wg_b_descriptor(cout_p: int) -> dict:
    """The B matrix descriptor of k16 step 0 (no swizzle, K-major), in bytes
    from the weights' start: leading offset (the two k halves), stride
    offset (n groups of 8)."""
    return {"start": 0, "lbo": cout_p * 16, "sbo": 128}


def desc_offset(desc: dict, row, k):
    """Byte offset of element (row, k) of a K-major no-swizzle operand whose
    descriptor is `desc`: core matrix (row // 8, k // 8) of 8 rows x 16 bytes."""
    return desc["start"] + (row // 8) * desc["sbo"] + (k // 8) * desc["lbo"] + (row % 8) * 16 + (k % 8) * 2


def wg_b_offset(desc: dict, step: int, k, n):
    """Byte offset of B element (k, n) of k16 step `step`: the descriptor's
    start advanced by the step's two slices."""
    return desc_offset({**desc, "start": desc["start"] + step * 2 * desc["lbo"]}, n, k)


def wg_swizzled(pix, chunk, lg: int):
    """wg::swizzled: byte offset of 16-byte chunk `chunk` of pixel `pix` in a
    box of 16 << lg bytes per pixel, swizzled by that span (numpy-friendly)."""
    return (pix << (4 + lg)) + ((chunk ^ ((pix >> (3 - lg)) & ((1 << lg) - 1))) << 4)


def tma_swizzle(raw, span: int):
    """TMA's 32/64/128-byte swizzle of a byte offset in a 1024-aligned box:
    bits 4.. (as many as the span holds 16-byte chunks) XOR bits 7.."""
    if span <= 16:
        return raw
    mask = span // 16 - 1
    return raw ^ (((raw >> 7) & mask) << 4)


def wg_tiles(ho: int, wo: int, batch: int, th: int) -> list:
    """(batch, row0, col0) of every output tile, in the kernel's order t;
    warpgroup g of block b walks t = 2b + g, then on by twice the grid."""
    tw, tt = -(-wo // WG_TW), -(-ho // th)
    return [(t // (tw * tt), (t // tw) % tt * th, t % tw * WG_TW) for t in range(tw * tt * batch)]


def wg_replay(x: torch.Tensor, packed: torch.Tensor, cout: int, bias=None) -> torch.Tensor:
    """The wgmma + TMA path replayed with its own index arithmetic: each
    tile's halo, one TMA box per 8 input channels; each k16 step's A rows
    read at the A descriptor's offsets (64 halo pixels a block, 4 lines of
    16, 2 of them past the tile's 14 columns), B at the weights'
    descriptor; f32 sums; the output staged at the swizzled staging offsets
    and read back by the TMA store's box, clipped at the edge. bf16 x
    (B,H,W,Cin) with wg_takes(Cin)."""
    b_, h, w, cin = x.shape
    cout_p = packed.shape[1]
    p = wg_plan(cin, cout)
    th = p["th"]
    ho, wo = h - 2, w - 2
    bits = x.contiguous().view(torch.int16).numpy().view(np.uint16)
    wbytes = packed.contiguous().view(torch.int16).numpy().view(np.uint8).reshape(-1)
    bdesc = wg_b_descriptor(cout_p)
    kk, nn = np.meshgrid(np.arange(16), np.arange(cout_p), indexing="ij")
    rows, ks = np.meshgrid(np.arange(64), np.arange(16), indexing="ij")
    y = torch.zeros((b_, ho, wo, cout), dtype=torch.bfloat16)
    hr, hc = np.meshgrid(np.arange(th + 2), np.arange(WG_HWD), indexing="ij")
    for bi, r0, c0 in wg_tiles(ho, wo, b_, th):
        # The stage: c8 boxes of (th + 2) lines x 16 pixels x 8 channels, zero
        # past the image, and NaN after it: A reads 2 pixels past the last box,
        # which must land only in the 2 discarded columns.
        stage = np.full(p["stage_bytes"] // 2 + 32, 0x7FC0, np.uint16)
        gh, gw = r0 + hr, c0 + hc
        inside = (gh < h) & (gw < w)
        for c in range(p["c8"]):
            vals = np.zeros((th + 2, WG_HWD, 8), np.uint16)
            vals[inside] = bits[bi, gh[inside], gw[inside], 8 * c:8 * c + 8]
            stage[c * p["box_bytes"] // 2:(c + 1) * p["box_bytes"] // 2] = vals.reshape(-1)
        acc = np.zeros((th * WG_HWD // 64, 64, cout_p), np.float32)
        for s in range(p["nsp"] // 2):
            ad = wg_a_descriptor(p, s)
            boff = wg_b_offset(bdesc, s, kk, nn)
            bmat = (wbytes[boff] | (wbytes[boff + 1].astype(np.uint16) << 8)).astype(np.uint32) << 16
            for blk in range(acc.shape[0]):  # the warpgroup's MI blocks, in line order
                off = desc_offset({**ad, "start": ad["start"] + blk * 64 * 16}, rows, ks)
                amat = stage[off // 2].astype(np.uint32) << 16
                acc[blk] += amat.view(np.float32) @ bmat.view(np.float32)
        out = torch.from_numpy(acc.reshape(th, WG_HWD, cout_p)[:, :WG_TW, :cout].reshape(th * WG_TW, cout))
        if bias is not None:
            out = out + bias.float()
        out = out.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
        if p["obox"]:
            # Staged at the epilogue's swizzled offsets, read back by the TMA
            # store's box (pixel stride 16 << olg bytes, swizzled by it).
            olg, ospan = p["olg"], 16 << p["olg"]
            pix, ch = np.meshgrid(np.arange(th * WG_TW), np.arange(cout), indexing="ij")
            n, e = ch // 8, ch % 8
            staged = np.zeros((p["obox"], p["obox_bytes"] // 2), np.uint16)
            staged[n >> olg, (wg_swizzled(pix, n & ((1 << olg) - 1), olg) + 2 * e) // 2] = out
            out = staged[n >> olg, tma_swizzle(pix * ospan + 16 * (n & ((1 << olg) - 1)) + 2 * e, ospan) // 2]
        out = torch.from_numpy(out.astype(np.int16)).view(torch.bfloat16).reshape(th, WG_TW, cout)
        nr, nc = min(th, ho - r0), min(WG_TW, wo - c0)
        y[bi, r0:r0 + nr, c0:c0 + nc] = out[:nr, :nc]
    return y


# -- a twin of the f32 conv's TF32 path over a hi/lo split (csrc/conv3x3.cu, namespace tf)

TF_KB = 2  # 4-channel TMA boxes of one K chunk (8 input channels)
# The four TF32 products (A part, B part) of a k8 step; the kernel issues
# them as lo_a * [hi | lo], then hi_a * [hi | lo].
TF_PRODUCTS = (("lo", "lo"), ("lo", "hi"), ("hi", "lo"), ("hi", "hi"))


def tf_layout(nsp: int, nt: int, mi: int, stages: int) -> dict:
    """tf::layout: the shared-memory plan of one launch, bytes from the
    block's 1024-aligned base."""
    p = {"mi": mi, "stages": stages, "th": 4 * mi, "nt": nt, "nsp": nsp}
    p["box_bytes"] = (4 * mi + 2) * WG_HWD * 16
    p["chunk_bytes"] = TF_KB * p["box_bytes"]
    p["off_lo"] = WG_GROUPS * stages * p["chunk_bytes"]
    p["off_w"] = p["off_lo"] + WG_GROUPS * p["chunk_bytes"]
    p["off_bar"] = p["off_w"] + 2 * nsp * nt * 16
    p["smem"] = 1024 + p["off_bar"] + 8 * WG_GROUPS * stages
    return p


def tf_plan(cin: int, cout: int) -> dict:
    """tf::plan for the packed NT (ops/kernels/conv3x3.py:tf32_nt): the
    most m64 blocks the accumulators allow (NT a thread and block at N = 2 *
    NT, and NT / 2 f32 sums: 192 at 4 blocks below NT 64, at 2 from it),
    then 4 stages before 3 and 2; plus the K chunks, the Cout tiles, a
    wgmma's N (`nb`, B = [hi | lo]) and the wgmmas a tap and block issue
    (`tap_wgmmas`)."""
    from roomnet_tpu_torch.ops.kernels.conv3x3 import tf32_nt

    nt, nsp = tf32_nt(cin, cout), 9 * cin // 4
    mi_max = 2 if nt >= 64 else 4
    for mi in (m for m in (4, 2, 1) if m <= mi_max):
        for stages in (4, 3, 2):
            p = tf_layout(nsp, nt, mi, stages)
            if p["smem"] <= WG_MAX_SMEM:
                return {**p, "chunks": cin // 8, "cout_tiles": -(-cout // nt), "nb": 2 * nt, "tap_wgmmas": 2}
    raise ValueError(f"conv3x3: no TF32 split plan fits Cin {cin}, Cout {cout}")


def desc_offset32(desc: dict, row, k):
    """Byte offset of f32 element (row, k) of a K-major no-swizzle operand
    whose descriptor is `desc`: core matrix (row // 8, k // 4) of 8 rows x 16
    bytes (4 TF32 values)."""
    return desc["start"] + (row // 8) * desc["sbo"] + (k // 4) * desc["lbo"] + (row % 8) * 16 + (k % 4) * 4


def tf_a_descriptor(p: dict, tap: int, blk: int) -> dict:
    """The A descriptor of m64 block `blk` at `tap` over a stage (or its lo
    twin) at offset 0, in bytes: the 64 halo pixels from line 4 * blk
    shifted by the tap, the second k half (box 1) one box on, 8 pixels
    128 bytes apart. The same at every chunk: the taps are the kernel's
    unrolled loop, no arithmetic on Cin."""
    return {"start": blk * 64 * 16 + _toff(tap) * 16, "lbo": p["box_bytes"], "sbo": 128}


def tf_b_descriptor(p: dict, chunk: int, tap: int) -> dict:
    """The B descriptor of (chunk, tap) in bytes from one Cout tile's packed
    image: the operand [hi | lo] of N = 2 * NT (rows 0..NT-1 the hi weights,
    NT..2NT-1 the lo), slices (chunk * 9 + tap) * 2 and the next N * 16
    bytes apart, groups of 8 rows 128 apart."""
    nb = p["nb"]
    return {"start": (chunk * 9 + tap) * TF_KB * nb * 16, "lbo": nb * 16, "sbo": 128}


def tf_replay(x: torch.Tensor, packed: torch.Tensor, cout: int, bias=None, passes=4) -> torch.Tensor:
    """The TF32 split path replayed with its own index arithmetic, all tiles
    at once: per K chunk each tile's halo stage (two 4-channel TMA boxes,
    zero past the image, NaN past the stage, where the shifted A of the 2
    discarded columns reads), split by the kernel's rna rule into hi and a
    lo twin; per tap and m64 block A read at the A descriptor's offsets, B
    (hi and lo of every Cout tile) at the [hi | lo] descriptor's; the
    products lo_a*lo_b, lo_a*hi_b, hi_a*lo_b and hi_a*hi_b summed in f32 per
    chunk into two accumulators, the lo-weight products and the hi-weight
    ones, each chunk's then added to the tile's sums in f32, the lo-weight
    first; the tile's 14 columns clipped at the edge, plus the bias.
    `passes`: the last n of TF_PRODUCTS (3: without lo_a*lo_b; 1: hi_a*hi_b
    alone, the one-pass mutant), or a tuple of them. f32 x (B,H,W,Cin) with
    tf32_takes(Cin), packed by pack_tf32x3."""
    from roomnet_tpu_torch.ops.kernels.conv3x3 import tf32_split

    b_, h, w, cin = x.shape
    p = tf_plan(cin, cout)
    th, nt, mi = p["th"], p["nt"], p["mi"]
    ho, wo = h - 2, w - 2
    tiles = np.array(wg_tiles(ho, wo, b_, th))
    xs = x.float().numpy()
    wflat = packed.float().numpy().reshape(p["cout_tiles"], -1)
    box_f, chunk_f = p["box_bytes"] // 4, p["chunk_bytes"] // 4
    hr, hc = np.meshgrid(np.arange(th + 2), np.arange(WG_HWD), indexing="ij")
    gh, gw = tiles[:, 1, None, None] + hr, tiles[:, 2, None, None] + hc
    inside = (gh < h) & (gw < w)
    rows, ks = np.meshgrid(np.arange(64), np.arange(8), indexing="ij")
    nn, kk = np.meshgrid(np.arange(p["nb"]), np.arange(8), indexing="ij")
    products = TF_PRODUCTS[-passes:] if isinstance(passes, int) else passes
    acc = np.zeros((len(tiles), mi, 64, p["cout_tiles"] * nt), np.float32)
    for k in range(p["chunks"]):
        vals = np.zeros((len(tiles), th + 2, WG_HWD, 8), np.float32)
        vals[inside] = xs[np.broadcast_to(tiles[:, 0, None, None], gh.shape)[inside], gh[inside], gw[inside],
                          8 * k:8 * k + 8]
        stage = np.concatenate([vals[..., 4 * c:4 * c + 4].reshape(len(tiles), box_f) for c in range(TF_KB)], 1)
        hi, lo = (np.concatenate([t.numpy(), np.full((len(tiles), 8), np.nan, np.float32)], 1)
                  for t in tf32_split(torch.from_numpy(stage)))
        assert hi.shape[1] == chunk_f + 8
        # A rows of every tap of each block, the taps along K as the kernel issues them.
        offs = np.stack([np.stack([desc_offset32(tf_a_descriptor(p, tap, blk), rows, ks) // 4 for tap in range(9)], 1)
                         for blk in range(mi)])  # (mi, 64, 9, 8) floats
        # Each tap's [hi | lo] of every Cout tile: hi its first NT columns, lo the last.
        cat = [np.concatenate([wflat[y][desc_offset32(tf_b_descriptor(p, k, tap), nn, kk) // 4].T
                               for tap in range(9)], 0) for y in range(p["cout_tiles"])]  # (9 * 8, 2 * nt) each
        bmats = {"hi": np.concatenate([c[:, :nt] for c in cat], 1),
                 "lo": np.concatenate([c[:, nt:] for c in cat], 1)}  # (9 * 8, cout_tiles * nt)
        for blk in range(mi):  # the chunk's two accumulators, then added to the tile's sums
            a = {"hi": hi[:, offs[blk]].reshape(len(tiles) * 64, 72),
                 "lo": lo[:, offs[blk]].reshape(len(tiles) * 64, 72)}
            for part in ("lo", "hi"):  # the lo-weight columns first, as the kernel adds them
                pairs = [(pa, pb) for pa, pb in products if pb == part]
                if pairs:
                    chunk = np.concatenate([a[pa] for pa, _ in pairs], 1) @ np.concatenate(
                        [bmats[pb] for _, pb in pairs], 0)
                    acc[:, blk] += chunk.reshape(len(tiles), 64, -1)
    out = torch.from_numpy(acc.reshape(len(tiles), th, WG_HWD, -1)[:, :, :WG_TW, :cout].copy())
    if bias is not None:
        out = out + bias.float()
    y = torch.zeros((b_, ho, wo, cout), dtype=torch.float32)
    for t, (bi, r0, c0) in enumerate(tiles):
        nr, nc = min(th, ho - r0), min(WG_TW, wo - c0)
        y[bi, r0:r0 + nr, c0:c0 + nc] = out[t, :nr, :nc]
    return y
