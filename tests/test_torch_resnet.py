"""ResNet-50 v1.5 (models/resnet.py) on the CPU, where the kernel wrappers
run their plain versions: the port's forward against the benchmark's plain
reference (benchmark/arch/resnet50/reference.py) on seeded calibrated
weights at the tiny size (a stride-2 stage and projection shortcuts), the
mutants that the comparison must catch, and the new arguments of the conv
wrappers' plain versions against torch.nn.functional.conv2d."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.lib import harness, images
from roomnet_tpu_torch.infer.classify import RoomNetClassifier
from roomnet_tpu_torch.models import family, registry, resnet
from roomnet_tpu_torch.ops.kernels import _build
from roomnet_tpu_torch.ops.kernels import conv1x1 as C1
from roomnet_tpu_torch.ops.kernels import conv3x3 as C3
from roomnet_tpu_torch.utils.profiling import SPANS

ARCH = harness.load_arch("resnet50")
ref, weights, program = ARCH.reference, ARCH.weights, ARCH.program
SEEDS = (1, 2, 3, 2**33 + 5)
F32_TOL = 1e-5
# bf16 against the f32 reference: each of the 9 bottleneck convs and the stem
# rounds its output to bf16 (8 mantissa bits, 2^-9 relative) and the folded
# kernels are bf16 too, so the probabilities move by up to 0.011 at the tiny
# size (8 seeds); 0.03 leaves 2.7 times that and is half the float8
# reference's least gap (0.061).
BF16_TOL = 0.03


def case(prec: str, seed: int, n: int = 32):
    cfg = dict(ref.TINY, precision=prec)
    x, _ = images.pool(seed, n, cfg["im_side"], 8, 16, "cpu")
    return cfg, x, weights.make(cfg, seed, x, "cpu")


def program_probs(cfg: dict, x: np.ndarray, v: dict, model_cfg=None) -> np.ndarray:
    mc = model_cfg or program.model_config(cfg)
    folded = resnet.fold_variables(weights.nest({k: t.clone() for k, t in v.items()}, cfg), mc)
    _, probs = resnet.forward_folded(folded, resnet.normalize_bgr_uint8(torch.from_numpy(x), mc), mc)
    return probs.double().numpy()


def gap(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max())


@pytest.mark.parametrize("seed", SEEDS)
def test_the_forward_is_the_references_in_f32(seed):
    cfg, x, v = case("f32", seed)
    assert gap(program_probs(cfg, x, v), ref.probs(v, x, cfg, "f32")) < F32_TOL


@pytest.mark.parametrize("seed", SEEDS)
def test_the_bf16_forward_is_within_bf16s_rounding_and_float8_is_not(seed):
    cfg, x, v = case("bf16", seed)
    want = ref.probs(v, x, cfg, "f32")
    assert gap(program_probs(cfg, x, v), want) < BF16_TOL
    assert gap(ref.probs(v, x, cfg, "fp8"), want) > BF16_TOL


def _dropped_residual(conv):
    def mutant(*args, residual=None, **kw):
        return conv(*args, **kw)
    return mutant


def _no_relu(conv):
    def mutant(*args, relu=False, **kw):
        return conv(*args, **kw)
    return mutant


def _valid_3x3(conv):
    def mutant(x, *args, padding=0, **kw):  # no zero padding; the output zero-padded back to its shape
        y = conv(x, *args, padding=0, **kw)
        return F.pad(y, (0, 0, padding, padding, padding, padding)) if kw.get("stride", 1) == 1 else \
            F.pad(y, (0, 0, 0, 1, 0, 1))
    return mutant


@pytest.mark.parametrize("mutant", ["v1_stride_on_the_1x1", "dropped_residual", "no_relu", "padding_0"])
def test_mutants_fail_the_bf16_tolerance(mutant, monkeypatch):
    cfg, x, v = case("bf16", SEEDS[0])
    mc = program.model_config(cfg)
    if mutant == "v1_stride_on_the_1x1":
        mc = dataclasses.replace(mc, stride_on_3x3=False)
    elif mutant == "dropped_residual":
        monkeypatch.setattr(resnet, "conv1x1", _dropped_residual(resnet.conv1x1))
    elif mutant == "no_relu":
        monkeypatch.setattr(resnet, "conv1x1", _no_relu(resnet.conv1x1))
    else:
        monkeypatch.setattr(resnet, "conv3x3", _valid_3x3(resnet.conv3x3))
    assert gap(program_probs(cfg, x, v, mc), ref.probs(v, x, cfg, "f32")) > BF16_TOL


def test_the_reference_counts_resnet50s_parameters():
    cfg = dict(ref.TINY, num_classes=1000, im_side=224, stem_width=64, mid_widths=[64, 128, 256, 512],
               depths=[3, 4, 6, 3])
    shapes = ref.param_paths(cfg)
    assert sum(int(np.prod(s)) for s in shapes.values()) == 25_557_032
    assert sum(int(np.prod(s)) for p, s in shapes.items() if "/bn" in p) == 53_120
    assert len(ref.stat_paths(cfg)) == 2 * 53
    assert ARCH.work.forward_flops(dict(cfg, precision="bf16"), 1) / 1e9 == pytest.approx(8.18, abs=5e-3)


def test_the_classifier_runs_resnet_through_its_configuration():
    """The classifier's predict on the registered tiny ResNet: the family's
    fold, normalisation, forward and labels, one launch counter per conv."""
    cfg = registry.get("resnet50-tiny")
    assert family.of(cfg) is family.RESNET and family.of(registry.get("roomnet-tiny")) is family.ROOMNET
    variables = resnet.init_variables(torch.Generator().manual_seed(0), cfg)
    clf = RoomNetClassifier(variables, cfg, batch_size=4, device="cpu")
    assert clf.class_labels == [f"class_{i}" for i in range(10)]
    x = np.random.RandomState(0).randint(0, 256, (6, 32, 32, 3), dtype=np.uint8)
    before = _build.launch_counts()
    ids, probs = clf.predict(x)
    after = SPANS.summary()
    launches = _build.launches_since(before)
    clf.close()
    _, want = resnet.forward_folded(resnet.fold_variables(variables, cfg),
                                    resnet.normalize_bgr_uint8(torch.from_numpy(x), cfg), cfg)
    assert probs.shape == (6, 10) and np.abs(probs - want.numpy()).max() < 1e-6
    assert (ids == want.argmax(-1).numpy()).all()
    assert launches == {"conv3x3": 2 * 3, "conv1x1": 2 * 8, "relu6_pool_bn": 0, "residual_bn": 0,
                        "dense_head": 0}  # two batches
    assert {f"forward/r50.{p}" for p in ("stem", "stage1", "stage2", "head")} <= set(after)


def test_serving_and_training_refuse_resnet():
    from roomnet_tpu_torch.infer.server import ClassifierServer
    from roomnet_tpu_torch.train.loop import TrainConfig, Trainer
    from roomnet_tpu_torch.train.step import make_train_step

    cfg = registry.get("resnet50-tiny")
    clf = RoomNetClassifier(resnet.init_variables(torch.Generator().manual_seed(0), cfg), cfg, device="cpu")
    with pytest.raises(TypeError, match="RoomNet only"):
        ClassifierServer(clf, port=0)
    clf.close()
    with pytest.raises(TypeError, match="RoomNet only"):
        Trainer(TrainConfig(img_side=32), cfg, device="cpu")
    with pytest.raises(TypeError, match="RoomNet only"):
        make_train_step(cfg=cfg)


def _nchw_conv(x, k, bias, stride, padding):
    y = F.conv2d(x.float().permute(0, 3, 1, 2), k.to(x.dtype).float().permute(3, 2, 0, 1), bias, stride=stride,
                 padding=padding)
    return y.permute(0, 2, 3, 1)


def _close(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Within the io dtype's rounding of the f32 sums (f32: another order of
    the sums, 1e-5 of the largest)."""
    rel = 1e-5 if got.dtype == torch.float32 else 2 ** -8
    return got.shape == want.shape and bool((got.float() - want).abs().max() <= rel * want.abs().max())


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("padding", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_plain_pads_strides_and_fuses_its_epilogue(stride, padding, dtype):
    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, 9, 8, 16, generator=g).to(dtype)
    k = torch.randn(3, 3, 16, 24, generator=g) * 0.2
    bias = torch.randn(24, generator=g)
    want = _nchw_conv(x, k, bias, stride, padding)
    got = C3.conv3x3(x, k, bias, padding=padding, stride=stride)
    assert got.dtype == dtype and _close(got, want)
    res = torch.randn(want.shape, generator=g).to(dtype)
    assert _close(C3.conv3x3(x, k, bias, padding=padding, stride=stride, relu=True, residual=res),
                  torch.relu(want + res.float()))


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv1x1_plain_strides_and_fuses_its_epilogue(stride, dtype):
    g = torch.Generator().manual_seed(8)
    x = torch.randn(2, 7, 6, 64, generator=g).to(dtype)
    k = torch.randn(1, 1, 64, 32, generator=g) * 0.2
    bias = torch.randn(32, generator=g)
    want = _nchw_conv(x, k, bias, stride, 0)
    got = C1.conv1x1(x, k, bias, stride=stride)
    assert got.dtype == dtype and _close(got, want)
    res = torch.randn(want.shape, generator=g).to(dtype)
    assert _close(C1.conv1x1(x, k, bias, stride=stride, relu=True, residual=res), torch.relu(want + res.float()))


def test_stream_packing_is_the_kernels_layout():
    """pack_stream: K step k = tap * Cin / 64 + chunk, row n (an output
    channel of the tile), its 16-byte chunk s of input channels at s ^ (n %
    8), 8 channels each (csrc/igemm.cuh's 128-byte swizzle)."""
    k = torch.arange(3 * 3 * 128 * 192, dtype=torch.float32).reshape(3, 3, 128, 192)
    p = C3.pack_stream(k)
    assert C3.stream_bn(192) == 64 and C3.stream_bn(256) == 128 and p.shape == (3, 9 * 2, 64, 8, 8)
    for tile, tap, chunk, s, n, c in [(0, 0, 0, 0, 0, 0), (2, 4, 1, 3, 17, 5), (1, 8, 1, 7, 63, 7), (0, 2, 0, 6, 9, 1)]:
        assert p[tile, tap * 2 + chunk, n, s ^ (n % 8), c] == k[tap // 3, tap % 3, chunk * 64 + s * 8 + c,
                                                                tile * 64 + n]
    with pytest.raises(ValueError):
        C3.pack_stream(torch.zeros(3, 3, 48, 64))
