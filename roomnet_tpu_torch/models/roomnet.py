"""RoomNet inference forward in PyTorch, through the port's four kernels.

Port of roomnet_tpu/models/roomnet.py (inference). The architecture
(reference network.py:225-244):

    input (B,224,224,3) in [-1,1], RGB — or raw uint8 BGR (folded into conv 0)
    B1: 8ch   depth1, pool3/s1
    B2: 32ch  depth3, pool4/s1, residual (TF1-legacy bilinear 215->205)
    B3: 64ch  depth2, pool4/s2, residual (100->48)
    B4: 128ch depth1, no pool
    B5: 16ch  depth3, pool4/s2, residual (21->2)
    flatten -> 64 -> dense head 32 -> 16 -> 8 -> 6 (ReLU6-clipped logits)

Every layer runs through one kernel wrapper of `ops.kernels`: each conv
through `conv3x3`, each relu6 -> pool -> BN through `relu6_pool_bn` (B4's
with a 1x1 window), each residual BN(x + resize(res)) through `residual_bn`,
and the head through `dense_head` — 10 / 10 / 3 / 1 launches per forward at
224. On a CUDA tensor those are the CUDA kernels; on a CPU tensor their
plain PyTorch versions.

Variables are the JAX package's pytree with torch tensors for leaves:

    {"blocks": [{"conv": [HWIO...], "bn": [BN...], "res_bn": BN|None} x5],
     "dense":  [{"kernel": (in,out), "bias": (out,)|None, "bn": BN|None} x4]}
    BN = {"scale","bias","mean","var"} each (C,)
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import blocks as B
from ..ops.kernels.conv3x3 import conv3x3
from ..ops.kernels.dense_head import dense_head, pack_head
from ..ops.kernels.pool import relu6_pool_bn
from ..ops.kernels.residual import residual_bn

Variables = dict


@dataclasses.dataclass(frozen=True)
class RoomNetConfig:
    """Static architecture config (reference network.py:225-237).

    The JAX config's `pool_impl` (an XLA lowering choice) has no counterpart:
    the relu6_pool_bn kernel is the only pool.
    """

    num_classes: int = 6
    im_side: int = 224
    block_filters: tuple[int, ...] = (8, 32, 64, 128, 16)
    block_depths: tuple[int, ...] = (1, 3, 2, 1, 3)
    # (pool_ksize, pool_stride) or None for no pooling.
    block_pools: tuple[tuple[int, int] | None, ...] = ((3, 1), (4, 1), (4, 2), None, (4, 2))
    kernel_size: int = 3
    dense_units: tuple[int, ...] = (32, 16, 8)
    bn_eps: float = B.BN_EPS
    bn_momentum: float = B.BN_MOMENTUM
    compute_dtype: torch.dtype = torch.float32

    def spatial_sizes(self) -> list[list[int]]:
        """Per-block list of activation side lengths after each depth."""
        s = self.im_side
        sizes = []
        for bi in range(len(self.block_filters)):
            cur = []
            for _ in range(self.block_depths[bi]):
                s = s - (self.kernel_size - 1)
                if self.block_pools[bi] is not None:
                    k, st = self.block_pools[bi]
                    s = (s - k) // st + 1
                cur.append(s)
            sizes.append(cur)
        return sizes

    @property
    def flat_len(self) -> int:
        side = self.spatial_sizes()[-1][-1]
        return side * side * self.block_filters[-1]


DEFAULT_CONFIG = RoomNetConfig()
# Fast serving config: bf16 activations and conv weights, f32 accumulation
# in every kernel, an f32 head. Params stay f32; logits return f32.
FAST_CONFIG = RoomNetConfig(compute_dtype=torch.bfloat16)


def _fold_preprocess_into_first_conv(k0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold BGR->RGB + [-1,1] normalization into block 0's conv.

    ``conv(k, bgr*2/255 - 1 reversed)`` equals ``conv(k', bgr) + b'`` with
    ``k' = flip_cin(k) * 2/255`` and ``b'[co] = -sum_{dy,dx,ci} k[...]``, so a
    uint8 batch costs a dtype cast and nothing else.
    """
    k = k0.float()
    return k.flip(2) * (2.0 / 255.0), -k.sum(dim=(0, 1, 2))


def fold_variables(variables: Variables, cfg: RoomNetConfig = DEFAULT_CONFIG, *,
                   uint8_input: bool = False) -> dict:
    """The operands of every kernel launch of one forward, computed once.

    Conv kernels are cast to the compute dtype (conv 0 folded with the
    uint8 preprocess when `uint8_input`), every BN is folded to an f32
    affine with cfg.bn_eps, and the dense head is packed.
    """
    blocks = []
    for bi, blk in enumerate(variables["blocks"]):
        layers = []
        for d, (kern, bn) in enumerate(zip(blk["conv"], blk["bn"])):
            bias = None
            if bi == 0 and d == 0 and uint8_input:
                kern, bias = _fold_preprocess_into_first_conv(kern)
            w, b = B.bn_fold(bn, cfg.bn_eps)
            layers.append((kern.to(cfg.compute_dtype).contiguous(), bias, w, b))
        res = B.bn_fold(blk["res_bn"], cfg.bn_eps) if blk["res_bn"] is not None else None
        blocks.append({"layers": layers, "res": res})
    return {"blocks": blocks, "head": pack_head(variables["dense"], cfg.bn_eps),
            "uint8_input": uint8_input}


def forward_folded(folded: dict, x: torch.Tensor, cfg: RoomNetConfig = DEFAULT_CONFIG):
    """(logits, probs), both (B, num_classes) f32, from `fold_variables`."""
    if (x.dtype == torch.uint8) != folded["uint8_input"]:
        raise ValueError("fold_variables(uint8_input=...) does not match the input's dtype")
    x = x.to(cfg.compute_dtype).contiguous()
    for bi, blk in enumerate(folded["blocks"]):
        k, s = cfg.block_pools[bi] or (1, 1)
        res_in = None
        for d, (kern, bias, w, b) in enumerate(blk["layers"]):
            x = relu6_pool_bn(conv3x3(x, kern, bias), w, b, ksize=k, stride=s)
            if d == 0:
                res_in = x
        if blk["res"] is not None:  # make_residual (reference network.py:181-182, 198-203)
            x = residual_bn(x, res_in, *blk["res"])
    return dense_head(x.reshape(x.shape[0], -1), *folded["head"])


def forward(variables: Variables, x: torch.Tensor, cfg: RoomNetConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """Logits (B, num_classes) f32, ReLU6-clipped like the reference.

    Input: normalized RGB float NHWC in [-1,1], or raw uint8 BGR, which
    takes the preprocess fold into conv 0.
    """
    folded = fold_variables(variables, cfg, uint8_input=x.dtype == torch.uint8)
    return forward_folded(folded, x, cfg)[0]


def predict(variables: Variables, x: torch.Tensor, cfg: RoomNetConfig = DEFAULT_CONFIG):
    """(argmax ids, softmax probs) — the optimized-inference heads (network.py:44-45)."""
    folded = fold_variables(variables, cfg, uint8_input=x.dtype == torch.uint8)
    _, probs = forward_folded(folded, x, cfg)
    return probs.argmax(dim=-1), probs


def normalize_bgr_uint8(x_bgr: torch.Tensor) -> torch.Tensor:
    """BGR uint8 -> RGB float in [-1,1] (reference network.py:129,153,159)."""
    return (x_bgr.flip(-1).float() / 255.0) * 2.0 - 1.0


def param_count(tree) -> int:
    """Number of scalars in a variables tree (dicts, lists, None, tensors)."""
    if isinstance(tree, dict):
        return sum(param_count(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(param_count(v) for v in tree)
    return 0 if tree is None else tree.numel()
