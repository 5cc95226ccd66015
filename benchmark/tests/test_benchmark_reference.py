"""RoomNet's reference (benchmark/arch/roomnet/reference.py) against the
program's plain path on the CPU (where the port's kernel wrappers run their
plain PyTorch versions), and its parts."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchmark.lib import compare, harness, images

ROOMNET = harness.load_arch("roomnet")
ref, weights, program = ROOMNET.reference, ROOMNET.weights, ROOMNET.program
F32_TINY = dict(ref.TINY, precision="f32")


def f32_224() -> dict:
    return json.loads((harness.ROOT / "benchmark" / "configs" / "roomnet-224.json").read_text())


def seeded(cfg, n: int, seed: int = 3):
    x, y = images.pool(seed, n, cfg["im_side"], 16, 16, "cpu")
    return x, y, weights.make(cfg, seed, x[: min(n, 32)], "cpu")


@pytest.mark.parametrize("cfg,n", [(F32_TINY, 24), (f32_224(), 4)], ids=["tiny", "224"])
def test_the_reference_forward_is_the_programs_plain_forward(cfg, n):
    x, _, v = seeded(cfg, n)
    clf = program.classifier(weights.nest({k: t.clone() for k, t in v.items()}, cfg), cfg, 8, "cpu")
    _, got = clf.predict(x)
    clf.close()
    want = ref.probs(v, x, cfg, "f32")
    assert compare.prob_gap(got, want) < 2e-6


def test_rounding_emulates_the_lower_precisions():
    x = torch.linspace(-500, 500, 10001)
    assert torch.equal(ref.rounder("bf16")(x), x.to(torch.bfloat16).float())
    fp8 = ref.rounder("fp8")(x)
    assert fp8.abs().max().item() == pytest.approx(500) and torch.isfinite(fp8).all()
    assert ((fp8 - x).abs() <= x.abs() / 16 + 1e-3).all()  # three mantissa bits
    assert (fp8 != x).any()
    small = ref.rounder("fp8")(x * 1e-6)  # the per-tensor scale: nothing flushes to zero
    assert (small[x.abs() > 0.05] != 0).all()
    assert torch.equal(ref.rounder("f32")(x), x) and torch.equal(ref.rounder("tf32")(x), x)
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    with ref.precision("tf32"):
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    with ref.precision("f32"):
        assert not (torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32)
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == saved


def test_calibration_spreads_the_logits_and_keeps_the_blocks():
    cfg = F32_TINY
    x, _, _ = seeded(cfg, 64)
    v0 = weights.glorot(cfg, 3, "cpu")
    v = ref.calibrate(v0, torch.from_numpy(x), cfg)
    for k in v0:
        if k.startswith("blocks/"):
            assert torch.equal(v[k], v0[k])
    with torch.no_grad():
        z = ref.forward(v, torch.from_numpy(x), cfg)
    assert z.mean().item() == pytest.approx(ref.LOGIT_MEAN, abs=0.05)
    assert z.std(0).mean().item() == pytest.approx(1.0, abs=0.1)


def test_the_same_seed_gives_the_same_inputs_and_weights():
    a = images.pool(2**35 + 3, 8, 32, 4, 16, "cpu")
    b = images.pool(2**35 + 3, 8, 32, 4, 16, "cpu")
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert not np.array_equal(a[0], images.pool(2**35 + 4, 8, 32, 4, 16, "cpu")[0])
    wa, wb = weights.glorot(ref.TINY | {"precision": "f32"}, 9, "cpu"), weights.glorot(F32_TINY, 9, "cpu")
    assert all(torch.equal(wa[k], wb[k]) for k in wa)
    assert len({tuple(r.tobytes() for r in a[0])}) == 1 and len({r.tobytes() for r in a[0]}) == 8
