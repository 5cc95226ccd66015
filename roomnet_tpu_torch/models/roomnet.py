"""RoomNet forward in PyTorch, through the port's four kernels.

Port of roomnet_tpu/models/roomnet.py. The architecture
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

Two forwards share that walk. `forward_folded` serves: every operand folded
once by `fold_variables`, no autograd. `forward` trains: it takes the
variables themselves and calls each kernel through its autograd Function,
folding the BN inside the graph, so gradients reach every kernel, BN scale
and bias (never the moving mean and variance). With batch statistics
(`use_batch_stats`) each pool and residual launches with the identity
affine and `batch_norm_train` follows it; with batch statistics or dropout
the head is torch ops, since either changes the function between its
layers: 10 / 10 / 3 / 0 launches.

Variables are the JAX package's pytree with torch tensors for leaves:

    {"blocks": [{"conv": [HWIO...], "bn": [BN...], "res_bn": BN|None} x5],
     "dense":  [{"kernel": (in,out), "bias": (out,)|None, "bn": BN|None} x4]}
    BN = {"scale","bias","mean","var"} each (C,)
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..ops import blocks as B
from ..ops.kernels.conv3x3 import conv3x3, conv3x3_autograd
from ..ops.kernels.dense_head import dense_head, dense_head_autograd, pack_head
from ..ops.kernels.pool import relu6_pool_bn, relu6_pool_bn_autograd
from ..ops.kernels.residual import residual_bn, residual_bn_autograd
from ..parallel.tensor import copy_to_model, gather_model

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


def _bn_init(c: int, device) -> dict:
    return {"scale": torch.ones(c, device=device), "bias": torch.zeros(c, device=device),
            "mean": torch.zeros(c, device=device), "var": torch.ones(c, device=device)}


def _glorot(shape: tuple[int, ...], generator: torch.Generator) -> torch.Tensor:
    """Glorot-uniform f32 of an HWIO or (in, out) kernel, JAX's fans: the
    receptive field times the second-to-last and the last axis."""
    receptive = math.prod(shape[:-2])
    limit = math.sqrt(6.0 / (receptive * (shape[-2] + shape[-1])))
    out = torch.empty(shape, device=generator.device)
    return out.uniform_(-limit, limit, generator=generator)


def init_variables(generator: torch.Generator, cfg: RoomNetConfig = DEFAULT_CONFIG) -> Variables:
    """Glorot-uniform kernels and identity BN (the tf.layers defaults,
    network.py:184, 212), drawn from `generator` on its device."""
    dev = generator.device
    blocks, in_ch, k = [], 3, cfg.kernel_size
    for filters, depth in zip(cfg.block_filters, cfg.block_depths):
        convs = [_glorot((k, k, in_ch if d == 0 else filters, filters), generator) for d in range(depth)]
        blocks.append({"conv": convs, "bn": [_bn_init(filters, dev) for _ in range(depth)],
                       "res_bn": _bn_init(filters, dev) if depth > 1 else None})
        in_ch = filters
    dense, d_in = [], cfg.flat_len
    for units in cfg.dense_units:
        dense.append({"kernel": _glorot((d_in, units), generator), "bias": None, "bn": _bn_init(units, dev)})
        d_in = units
    dense.append({"kernel": _glorot((d_in, cfg.num_classes), generator),
                  "bias": torch.zeros(cfg.num_classes, device=dev), "bn": None})
    return {"blocks": blocks, "dense": dense}


def forward(variables: Variables, x: torch.Tensor, cfg: RoomNetConfig = DEFAULT_CONFIG, *,
            use_batch_stats: bool = False, collect_batch_stats: bool = False,
            dropout_rate: float | None = None, generator: torch.Generator | None = None,
            batch_row_mask: torch.Tensor | None = None, group=None, tp=None):
    """Logits (B, num_classes) f32, ReLU6-clipped like the reference, under
    autograd.

    Input: normalized RGB float NHWC in [-1,1], or raw uint8 BGR, which
    takes the preprocess fold into conv 0.

    use_batch_stats: BN normalizes with batch statistics
      (`compute_bn_mean_var=True`, network.py:193).
    collect_batch_stats: also return {path: BNStats} of every BN, for
      `update_moving_stats`.
    dropout_rate, generator: dropout after every block and every dense
      layer, the logits' included (network.py:204-206, 219-221), its masks
      drawn from `generator` site by site in that order; off when either is
      None.
    batch_row_mask: float (B,) of 1.0 (real) / 0.0 (padded row); with batch
      statistics, the moments leave the padded rows out.
    group: a mesh's data group (`parallel/mesh.py`). With batch statistics
      the moments are the global batch's, and dropout keeps this rank's rows
      of the global batch's masks (`blocks.batch_norm_train`,
      `blocks.dropout`): every rank's logits are then its rows of the
      single-device forward of the global batch. The kernels run as without.
    tp: the placements over the mesh's 'model' axis
      (`parallel/tensor.py:TensorParallel`), whose split leaves `variables`
      holds as this rank's slices. A conv kernel split on its output
      channels runs column-parallel: the conv kernel launches on this
      rank's channels, every rank's are gathered, and the pool and BN run on
      all of them (conv 0 may not be split: the uint8 fold derives its bias
      from the whole kernel). Split dense kernels are gathered whole before
      the head, which stays one launch. Every rank of the row then returns
      the same logits, those of the unsplit variables.

    Returns logits, or (logits, stats) with `collect_batch_stats`.
    """
    stats: dict[str, B.BNStats] = {}
    drop = dropout_rate is not None and generator is not None

    def maybe_dropout(h):
        return B.dropout(h, dropout_rate, generator, group) if drop else h

    def batch_bn(h, bn, path):
        h, st = B.batch_norm_train(h, bn, cfg.bn_eps, row_weights=batch_row_mask, group=group)
        if collect_batch_stats:
            stats[path] = B.BNStats(*(t.detach() for t in st))
        return h

    def identity(c):
        return torch.ones(c, device=x.device), torch.zeros(c, device=x.device)

    split = {} if tp is None else tp.axes
    tp_group = None if tp is None else tp.group
    for path, axis in split.items():
        conv = path.startswith("blocks/") and "/conv/" in path
        if not ((conv and axis == 3) or (path.startswith("dense/") and path.endswith("/kernel"))):
            raise ValueError(f"tensor parallelism splits conv kernels on their output axis and dense kernels; "
                             f"not {path} on axis {axis}")
        if path == "blocks/0/conv/0":
            raise ValueError("blocks/0/conv/0 may not be split over 'model': the uint8 fold derives its bias from "
                             "the whole kernel")

    uint8_input = x.dtype == torch.uint8
    x = x.to(cfg.compute_dtype).contiguous()
    for bi, blk in enumerate(variables["blocks"]):
        k, s = cfg.block_pools[bi] or (1, 1)
        res_in = None
        for d, (kern, bn) in enumerate(zip(blk["conv"], blk["bn"])):
            bias = None
            if bi == 0 and d == 0 and uint8_input:
                kern, bias = _fold_preprocess_into_first_conv(kern)
            if f"blocks/{bi}/conv/{d}" in split:  # column-parallel
                x = gather_model(conv3x3_autograd(copy_to_model(x, tp_group), kern, bias), -1, tp_group)
            else:
                x = conv3x3_autograd(x, kern, bias)
            if use_batch_stats:
                x = batch_bn(relu6_pool_bn_autograd(x, *identity(x.shape[-1]), ksize=k, stride=s),
                             bn, f"blocks/{bi}/bn/{d}")
            else:
                x = relu6_pool_bn_autograd(x, *B.bn_fold(bn, cfg.bn_eps), ksize=k, stride=s)
            if d == 0:
                res_in = x
        if blk["res_bn"] is not None:  # make_residual (reference network.py:181-182, 198-203)
            if use_batch_stats:
                x = batch_bn(residual_bn_autograd(x, res_in, *identity(x.shape[-1])),
                             blk["res_bn"], f"blocks/{bi}/res_bn")
            else:
                x = residual_bn_autograd(x, res_in, *B.bn_fold(blk["res_bn"], cfg.bn_eps))
        x = maybe_dropout(x)

    x = x.reshape(x.shape[0], -1)  # NHWC row-major flatten (network.py:234)
    dense = [{**layer, "kernel": gather_model(layer["kernel"], split[f"dense/{di}/kernel"], tp_group)}
             if f"dense/{di}/kernel" in split else layer for di, layer in enumerate(variables["dense"])]
    if not (use_batch_stats or drop):
        logits = dense_head_autograd(x, *pack_head(dense, cfg.bn_eps))[0]
    else:
        for di, layer in enumerate(dense):
            x = B.relu6(B.dense(x, layer["kernel"], layer["bias"]))
            if layer["bn"] is not None:
                x = (batch_bn(x, layer["bn"], f"dense/{di}/bn") if use_batch_stats
                     else B.batch_norm(x, layer["bn"], cfg.bn_eps))
            x = maybe_dropout(x)
        logits = x.float()
    return (logits, stats) if collect_batch_stats else logits


def update_moving_stats(variables: Variables, stats: dict[str, B.BNStats],
                        momentum: float = B.BN_MOMENTUM) -> Variables:
    """A new variables tree with each BN's moving mean and variance moved
    toward its batch statistics (tf.layers semantics): new = momentum * old
    + (1 - momentum) * batch, the variance Bessel-corrected. BNs without
    stats, and every other leaf, are the same tensors as before."""

    def upd(bn, key):
        if bn is None or key not in stats:
            return bn
        st = stats[key]
        return {"scale": bn["scale"], "bias": bn["bias"],
                "mean": momentum * bn["mean"] + (1 - momentum) * st.mean,
                "var": momentum * bn["var"] + (1 - momentum) * st.var_unbiased}

    blocks = [{"conv": blk["conv"], "bn": [upd(bn, f"blocks/{bi}/bn/{d}") for d, bn in enumerate(blk["bn"])],
               "res_bn": upd(blk["res_bn"], f"blocks/{bi}/res_bn")}
              for bi, blk in enumerate(variables["blocks"])]
    dense = [{**layer, "bn": upd(layer["bn"], f"dense/{di}/bn")}
             for di, layer in enumerate(variables["dense"])]
    return {"blocks": blocks, "dense": dense}


def predict(variables: Variables, x: torch.Tensor, cfg: RoomNetConfig = DEFAULT_CONFIG):
    """(argmax ids, softmax probs) — the optimized-inference heads (network.py:44-45)."""
    folded = fold_variables(variables, cfg, uint8_input=x.dtype == torch.uint8)
    _, probs = forward_folded(folded, x, cfg)
    return probs.argmax(dim=-1), probs


def normalize_bgr_uint8(x_bgr: torch.Tensor) -> torch.Tensor:
    """BGR uint8 -> RGB float in [-1,1] (reference network.py:129,153,159)."""
    return (x_bgr.flip(-1).float() / 255.0) * 2.0 - 1.0


def param_count(variables) -> int:
    """Number of scalars in a variables tree (dicts, lists, None, tensors)."""
    if isinstance(variables, dict):
        return sum(param_count(v) for v in variables.values())
    if isinstance(variables, list):
        return sum(param_count(v) for v in variables)
    return 0 if variables is None else variables.numel()
