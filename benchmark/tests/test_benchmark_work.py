"""RoomNet's frozen work counts (benchmark/arch/roomnet/work.py) against hand
counts, and against the kernel table's bounds (chip_smoke.py phase 3,
PERF.md)."""

from __future__ import annotations

import json

import pytest

from benchmark.lib import harness
from benchmark.lib.peaks import PEAK_BF16, PEAK_F32, PEAK_TF32

ROOMNET = harness.load_arch("roomnet")
work, ref = ROOMNET.work, ROOMNET.reference


def config(name: str) -> dict:
    return json.loads((harness.ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


BF16, F32 = config("roomnet-224-bf16"), config("roomnet-224")


def site(cfg, name):
    return next(launch for launch in work.launches(cfg, 256) if launch["site"] == name)


def test_one_conv_site_by_hand():
    # b1.conv0 (PERF.md's site 2): 215x215x32 -> 213x213x32, a 3x3 kernel.
    c = site(BF16, "b1.conv1")
    macs = 256 * 213 * 213 * 32 * 9 * 32
    assert c["flops"] == 2 * macs and c["ops"] == 2 * macs
    assert c["bytes"] == 2 * (256 * 215 * 215 * 32 + 9 * 32 * 32 + 256 * 213 * 213 * 32)
    f = site(F32, "b1.conv1")
    assert f["ops"] == 3 * 2 * macs and f["peak"] == PEAK_TF32  # the TF32 split: three products
    assert f["bytes"] == 2 * c["bytes"]
    first = site(F32, "b0.conv0")  # Cin 3: the CUDA cores' f32
    assert first["peak"] == PEAK_F32 and first["ops"] == first["flops"]


def test_one_pool_site_by_hand():
    # b0.pool0: 222x222x8, k3 s1 -> 220x220x8; every row and column read.
    p = site(BF16, "b0.pool0")
    read = 256 * 222 * 222 * 8
    assert p["ops"] == 256 * 220 * 220 * 8 * (9 + 3) + read
    assert p["bytes"] == 2 * (read + 256 * 220 * 220 * 8) + 2 * 4 * 8
    # b4.pool1: 19x19x16, k4 s2 -> 8x8; the last row and column are in no
    # window: (8 - 1) * 2 + 4 = 18 rows and columns read.
    assert site(BF16, "b4.pool1")["bytes"] == 2 * (256 * 18 * 18 * 16 + 256 * 8 * 8 * 16) + 2 * 4 * 16


def test_one_residual_by_hand():
    # b4.residual: the 21x21x16 shortcut resized to 2x2 (TF1 legacy: sources
    # 0 and 10, each with its right neighbour at weight 0 or 0.5).
    m = ref.interp_tf1(21, 2)
    used = [i for i in range(21) if m[i].any()]
    assert used == [0, 10, 11]
    r = site(BF16, "b4.residual")
    assert r["ops"] == 3 * 256 * 2 * 3 * 16 + 6 * 256 * 2 * 2 * 16
    assert r["bytes"] == 2 * 256 * (3 * 3 * 16 + 2 * 2 * 2 * 16) + 2 * 4 * 16
    # Two taps per axis: the three residuals, resize, add and BN, are about
    # 3.6 GFLOP per 256 images, where dense contractions would be 326.6.
    assert sum(x["flops"] for x in work.launches(BF16, 256) if x["kernel"] == "residual_bn") < 4e9


@pytest.mark.parametrize("cfg,kernel,ms", [
    (BF16, "conv3x3", 2.1796), (BF16, "relu6_pool_bn", 2.1357), (BF16, "residual_bn", 0.7650),
    (F32, "conv3x3", 7.3392), (F32, "relu6_pool_bn", 4.2714), (F32, "residual_bn", 1.5301)])
def test_bounds_are_the_kernel_tables(cfg, kernel, ms):
    assert work.bound_s(cfg, 256, kernel) * 1e3 == pytest.approx(ms, abs=6e-5)


def test_forward_work():
    conv = sum(x["flops"] for x in work.launches(BF16, 256) if x["kernel"] == "conv3x3")
    assert conv / 1e9 == pytest.approx(1148.516352)
    assert work.forward_flops(BF16, 256) / 1e9 == pytest.approx(1180.168, abs=1e-3)
    # bf16: all at 989 TFLOP/s.
    assert work.forward_ideal_s(BF16, 256) == pytest.approx(work.forward_flops(BF16, 256) / PEAK_BF16)
    # f32: the convs with Cin % 8 == 0 at 495 / 3 TFLOP/s, conv 0 and the rest at 67.
    tf32 = sum(x["flops"] for x in work.launches(F32, 256) if x["kernel"] == "conv3x3" and x["site"] != "b0.conv0")
    rest = work.forward_flops(F32, 256) - tf32
    assert work.forward_ideal_s(F32, 256) == pytest.approx(tf32 / (495e12 / 3) + rest / 67e12)
