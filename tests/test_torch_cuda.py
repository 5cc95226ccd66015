"""The port's CUDA kernels on the card: each against its plain version, and
the forward through all four against the TF-graph goldens.

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

import numpy as np
import pytest
import torch

from roomnet_tpu_torch.models import registry
from roomnet_tpu_torch.models import roomnet as M
from roomnet_tpu_torch.ops.kernels.conv3x3 import conv3x3
from roomnet_tpu_torch.ops.kernels.dense_head import dense_head
from roomnet_tpu_torch.ops.kernels.pool import relu6_pool_bn
from roomnet_tpu_torch.ops.kernels.residual import residual_bn
from roomnet_tpu_torch.params.schema import load_npz
# Imported by its own name (pytest puts tests/ on sys.path): on a machine with
# another `tests` package installed, `tests.torch_port_util` would not resolve.
from torch_port_util import cuda_device, outputs, wrapper_cases  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
BF16_ULP = 2.0 ** -7


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(4), ids=["conv3x3", "relu6_pool_bn", "residual_bn", "dense_head"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_kernel_matches_plain(cuda_device, case, dtype):
    kern, plain, args, kwargs = wrapper_cases(cuda_device, dtype)[case]
    before = kern.launches
    got, want = outputs(kern(*args, **kwargs)), outputs(plain(*args, **kwargs))
    torch.cuda.synchronize()
    assert kern.launches == before + 1
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
    kernels = (conv3x3, relu6_pool_bn, residual_bn, dense_head)
    for k in kernels:
        k.launches = 0
    logits = M.forward(variables, x, registry.get(cfg_name)).cpu().numpy()
    assert [k.launches for k in kernels] == [10, 10, 3, 1]
    np.testing.assert_array_equal(logits.argmax(-1), g["argmax"])
    limit = 1e-4 if cfg_name == "roomnet-224" else 0.15
    assert np.abs(logits - g["logits"]).max() <= limit
