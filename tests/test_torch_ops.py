"""The port's resize and blocks against the TF/cv2 goldens and roomnet_tpu.

Tolerances: f32 results at rtol = atol = 1e-5 (the JAX package's own
tests/test_resize.py values); the interpolation matrices bit-identical; bf16
results within one bf16 ulp (rtol 2^-7) of the JAX bf16 op.
"""

import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roomnet_tpu.ops import blocks as JB
from roomnet_tpu.ops import resize as JR
from roomnet_tpu_torch import default_device
from roomnet_tpu_torch.ops import blocks as TB
from roomnet_tpu_torch.ops import resize as TR
from tests.torch_port_util import random_bn, torch_tree

REPO = pathlib.Path(__file__).resolve().parents[1]
CASES = [(215, 205), (100, 48), (21, 2), (7, 13)]
BF16_RTOL = 2.0 ** -7


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@pytest.mark.parametrize("src,dst", CASES)
@pytest.mark.parametrize("convention", ["legacy", "half"])
def test_resize_matches_tf(resize_golden, src, dst, convention):
    fn = TR.resize_bilinear_tf1 if convention == "legacy" else TR.resize_bilinear_half_pixel
    x = torch.from_numpy(resize_golden[f"x_{src}_{dst}"])
    got = _np(fn(x, (dst, dst)))
    np.testing.assert_allclose(got, resize_golden[f"{convention}_{src}_{dst}"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("src_h,src_w,dst", [(300, 300, 224), (517, 517, 224), (150, 150, 224)])
def test_half_pixel_resize_matches_cv2_uint8(cv2_resize_golden, src_h, src_w, dst):
    """Within one gray level of cv2's 11-bit fixed point, as the JAX test allows."""
    x = torch.from_numpy(cv2_resize_golden[f"x_{src_h}_{src_w}_{dst}"].astype(np.float32)[None])
    want = cv2_resize_golden[f"y_{src_h}_{src_w}_{dst}"].astype(np.float32)
    diff = np.abs(np.round(_np(TR.resize_bilinear_half_pixel(x, (dst, dst)))[0]) - want)
    assert np.mean(diff <= 1.0) > 0.999 and diff.max() <= 2.0


@pytest.mark.parametrize("src,dst", CASES + [(9, 9), (4, 31)])
def test_interp_matrices_bit_identical_to_jax(src, dst):
    np.testing.assert_array_equal(TR.interp_matrix_tf1(src, dst), JR.interp_matrix_tf1(src, dst))
    np.testing.assert_array_equal(
        TR.interp_matrix_half_pixel(src, dst), JR.interp_matrix_half_pixel(src, dst))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fn_name", ["resize_bilinear_tf1", "resize_bilinear_half_pixel"])
def test_resize_matches_roomnet_tpu(dtype, fn_name):
    rng = np.random.RandomState(5)
    x = rng.uniform(-3, 3, size=(2, 25, 19, 4)).astype(np.float32)
    want = np.asarray(getattr(JR, fn_name)(jnp.asarray(x, dtype), (11, 30)).astype(jnp.float32))
    got = _np(getattr(TR, fn_name)(torch.from_numpy(x).to(getattr(torch, dtype)), (11, 30)))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=1e-2)


def test_relu6_matches_roomnet_tpu():
    x = np.random.RandomState(0).uniform(-9, 9, size=(3, 5, 7, 2)).astype(np.float32)
    np.testing.assert_array_equal(_np(TB.relu6(torch.from_numpy(x))), np.asarray(JB.relu6(x)))


@pytest.mark.parametrize("cin,cout", [(3, 8), (8, 16)])
def test_conv2d_valid_matches_roomnet_tpu(cin, cout):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 11, 9, cin).astype(np.float32)
    k = (rng.randn(3, 3, cin, cout) * 0.2).astype(np.float32)
    got = _np(TB.conv2d_valid(torch.from_numpy(x), torch.from_numpy(k)))
    np.testing.assert_allclose(got, np.asarray(JB.conv2d_valid(x, k)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("dtype,accum", [("f32", None), ("f32", "f32"), ("bf16", "f32"), ("bf16", None)])
def test_conv2d_valid_stride_and_accum_dtype_match_roomnet_tpu(stride, dtype, accum):
    """stride= and accum_dtype= as the JAX function takes them: f32 within
    1e-5; bf16 inputs summed in f32 (the port's default for bf16, JAX's with
    accum_dtype=f32), the output in bf16, within one bf16 ulp."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 12, 11, 8).astype(np.float32)
    k = (rng.randn(3, 3, 8, 16) * 0.2).astype(np.float32)
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = JB.conv2d_valid(jnp.asarray(x, jdt), jnp.asarray(k), stride=stride, accum_dtype=jnp.float32)
    got = TB.conv2d_valid(torch.from_numpy(x).to(tdt), torch.from_numpy(k), stride=stride,
                          accum_dtype=None if accum is None else torch.float32)
    assert got.dtype == tdt and want.dtype == jdt
    assert tuple(got.shape) == want.shape == (2, (12 - 3) // stride + 1, (11 - 3) // stride + 1, 16)
    tol = 1e-5 if dtype == "f32" else BF16_RTOL
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("k,s", [(3, 1), (4, 1), (4, 2), (1, 1)])
def test_avg_pool_valid_matches_roomnet_tpu(k, s):
    x = np.random.RandomState(2).uniform(0, 6, size=(2, 13, 12, 5)).astype(np.float32)
    got = _np(TB.avg_pool_valid(torch.from_numpy(x), k, s))
    np.testing.assert_allclose(got, np.asarray(JB.avg_pool_valid(x, k, s)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("eps", [1e-3, 1e-2])
def test_bn_fold_and_batch_norm_match_roomnet_tpu(eps):
    rng = np.random.RandomState(3)
    bn = random_bn(rng, 7)
    x = rng.randn(4, 3, 3, 7).astype(np.float32)
    tw, tb = TB.bn_fold(torch_tree(bn), eps)
    jw, jb = JB.bn_fold(bn, eps)
    np.testing.assert_allclose(_np(tw), np.asarray(jw), rtol=1e-6)
    np.testing.assert_allclose(_np(tb), np.asarray(jb), rtol=1e-6, atol=1e-6)
    got = _np(TB.batch_norm(torch.from_numpy(x), torch_tree(bn), eps))
    np.testing.assert_allclose(got, np.asarray(JB.batch_norm(x, bn, eps)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("with_bias", [False, True])
def test_dense_matches_roomnet_tpu(with_bias):
    rng = np.random.RandomState(4)
    x = rng.randn(5, 12).astype(np.float32)
    k = rng.randn(12, 6).astype(np.float32)
    b = rng.randn(6).astype(np.float32) if with_bias else None
    got = _np(TB.dense(torch.from_numpy(x), torch.from_numpy(k),
                       None if b is None else torch.from_numpy(b)))
    np.testing.assert_allclose(got, np.asarray(JB.dense(x, k, b)), rtol=1e-5, atol=1e-5)


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        default_device()
    assert default_device("cpu") == torch.device("cpu")


def test_port_imports_neither_jax_nor_roomnet_tpu():
    """Every module of the port, and chip_smoke.py, import without pulling
    `jax` or `roomnet_tpu` (exact names: roomnet_tpu_torch shares the prefix)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import roomnet_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(roomnet_tpu_torch.__path__, 'roomnet_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n in ('jax', 'roomnet_tpu')\n"
        "             or n.startswith(('jax.', 'roomnet_tpu.')))\n"
        "n = sum(1 for n in sys.modules if n.startswith('roomnet_tpu_torch.'))\n"
        "print(n, bad)\n"
        "sys.exit(1 if bad or n < 15 else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
