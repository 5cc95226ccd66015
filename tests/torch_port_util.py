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
