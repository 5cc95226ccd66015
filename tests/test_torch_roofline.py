"""The port's analytic roofline (roomnet_tpu_torch/utils/roofline.py)
against roomnet_tpu's: the same groups, FLOPs and bytes for any config and
batch, the same summary given the same constants, and the JAX module's
three tests (tests/test_roofline.py) on the port's, with the H100's
constants as its defaults."""

import dataclasses

import numpy as np
import pytest

from roomnet_tpu.models.roomnet import DEFAULT_CONFIG as JAX_DEFAULT
from roomnet_tpu.utils import roofline as JR
from roomnet_tpu_torch.models.roomnet import DEFAULT_CONFIG
from roomnet_tpu_torch.utils import roofline as R
from tests.tiny import TINY
from tests.torch_dp_worker import tiny


@pytest.mark.parametrize("batch", [1, 256])
@pytest.mark.parametrize("which", ["default", "tiny"])
def test_forward_groups_equal_the_jax_modules(which, batch):
    """Names, FLOPs and bytes of every group, in order, in bf16 and f32."""
    cfg, jcfg = (DEFAULT_CONFIG, JAX_DEFAULT) if which == "default" else (tiny(), TINY)
    for dtype_bytes in (2, 4):
        got = [dataclasses.astuple(g) for g in R.forward_groups(cfg, batch, dtype_bytes)]
        want = [dataclasses.astuple(g) for g in JR.forward_groups(jcfg, batch, dtype_bytes)]
        assert got == want


@pytest.mark.parametrize("measured_s", [None, 0.0337])
def test_summarize_equals_the_jax_modules_given_its_constants(measured_s):
    """With the JAX module's v5e constants the summary is its summary, keys
    and values; the port's defaults are the H100's."""
    consts = dict(peak_flops=JR.V5E_BF16_PEAK_FLOPS, hbm_bw=JR.V5E_HBM_BYTES_PER_S)
    assert R.summarize(DEFAULT_CONFIG, 256, measured_s=measured_s, **consts) == JR.summarize(
        JAX_DEFAULT, 256, measured_s=measured_s, **consts)
    h100 = dict(peak_flops=R.H100_BF16_PEAK_FLOPS, hbm_bw=R.H100_HBM_BYTES_PER_S)
    assert R.summarize(DEFAULT_CONFIG, 256) == JR.summarize(JAX_DEFAULT, 256, **h100)
    assert (R.H100_BF16_PEAK_FLOPS, R.H100_F32_PEAK_FLOPS, R.H100_HBM_BYTES_PER_S) == (989e12, 67e12, 3.35e12)


def test_b2_conv_flops():
    """Each interior B2 conv is ~214 GFLOP at batch 256 (2 * out_elems * 9 *
    Cin): a count of the geometry, whatever the chip."""
    groups = {g.name: g for g in R.forward_groups(DEFAULT_CONFIG, 256)}
    assert abs(groups["b2.conv1"].flops / 1e9 - 214) < 2


def test_summary_fields_and_consistency():
    """A forward of 33.7 ms at batch 256 (a time given, not measured):
    ~1.5 TFLOP, the ideal below it, a share of the bf16 peak below 100% at
    the H100's default and at the v5e's constants."""
    for consts in ({}, dict(peak_flops=JR.V5E_BF16_PEAK_FLOPS, hbm_bw=JR.V5E_HBM_BYTES_PER_S)):
        s = R.summarize(DEFAULT_CONFIG, 256, measured_s=0.0337, **consts)
        assert s["total_gflops"] > 1000
        assert 0.0 < s["hbm_bound_time_fraction"] <= 1.0
        assert s["ideal_ms"] < s["measured_ms"]
        assert 0 < s["pct_bf16_roofline"] < 100
        assert 0 < s["pct_of_ideal"] < 100
        np.testing.assert_allclose(s["achieved_tflops"], s["total_gflops"] / 1e3 / 0.0337, rtol=1e-6)


def test_scales_linearly_with_batch():
    """Conv, pool and residual terms scale with the batch; the dense weight
    reads do not (1% slack)."""
    a, b = R.summarize(DEFAULT_CONFIG, 128), R.summarize(DEFAULT_CONFIG, 256)
    np.testing.assert_allclose(2 * a["total_gflops"], b["total_gflops"], rtol=0.01)
    np.testing.assert_allclose(2 * a["total_hbm_GB"], b["total_hbm_GB"], rtol=0.01)


def test_f32_forward_counts_the_three_pass_convs_at_their_rate():
    """With the f32 conv's rule (three TF32 passes at 495 TFLOP/s where the
    port takes the Cin, the f32 peak at conv 0), a forward of 18 ms (a time
    given, not measured) faster than the CUDA cores' ideal reads under 100%
    of the three-pass ideal and of its operations' least time."""
    from roomnet_tpu_torch.ops.kernels.conv3x3 import tf32_takes

    def rule(cin):
        return R.H100_TF32_PEAK_FLOPS / R.TF32X3_PASSES if tf32_takes(cin) else R.H100_F32_PEAK_FLOPS

    assert R.conv_inputs(DEFAULT_CONFIG) == {"b1.conv0": 3, "b2.conv0": 8, "b2.conv1": 32, "b2.conv2": 32,
                                            "b3.conv0": 32, "b3.conv1": 64, "b4.conv0": 64, "b5.conv0": 128,
                                            "b5.conv1": 16, "b5.conv2": 16}
    f32 = dict(dtype_bytes=4, peak_flops=R.H100_F32_PEAK_FLOPS, measured_s=0.018)
    cores = R.summarize(DEFAULT_CONFIG, 256, **f32)
    three = R.summarize(DEFAULT_CONFIG, 256, conv_peak_flops=rule, **f32)
    assert R.H100_TF32_PEAK_FLOPS == 495e12 and R.TF32X3_PASSES == 3
    assert three["ideal_ms"] < 18 < cores["ideal_ms"] and three["total_gflops"] == cores["total_gflops"]
    assert cores["pct_of_ideal"] > 100
    assert 0 < three["pct_bf16_roofline"] < three["pct_of_ideal"] < 100
    # No rule: the JAX module's summary, as before.
    assert R.summarize(DEFAULT_CONFIG, 256, conv_peak_flops=None, **f32) == cores
