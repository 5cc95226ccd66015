"""ResNet-50 v1.5 forward in PyTorch, through the port's conv kernels.

The architecture (He et al., arXiv:1512.03385, "Deep Residual Learning for
Image Recognition"; torchvision's `resnet50`, models/resnet.py `Bottleneck`,
with its "v1.5" stride placement: a downsampling bottleneck strides on its
3x3 conv, not on its first 1x1):

    input (B,S,S,3) uint8 BGR -> x / 255, (x - mean) / std (RGB order)
    stem: conv 7x7/2 pad 3, 64 channels -> BN -> ReLU -> max pool 3x3/2 pad 1
    4 stages of bottlenecks, mid widths 64/128/256/512, outputs 4x, depths 3/4/6/3:
        h = relu(bn1(conv1x1(x)))
        h = relu(bn2(conv3x3(h, pad 1, stride s)))   s = 2 in the first block of stages 2-4
        y = relu(bn3(conv1x1(h)) + shortcut)         shortcut = bn(conv1x1(x, stride s)) in
                                                     a stage's first block, else x
    global average pool -> FC 2048 -> classes (f32) -> softmax

Every bottleneck conv runs through a kernel wrapper with its BN folded into
its weights and an f32 bias (`blocks.bn_fold`): each 1x1 through `conv1x1`,
each 3x3 through `conv3x3` at padding 1, the residual add and the ReLU in
their epilogues, so that a conv's output is rounded once to bf16. That is
16 conv3x3 and 36 conv1x1 launches per forward (one counter each in
utils/profiling.SPANS). The stem (one `F.conv2d` on channels-last tensors,
cuDNN on the card, the ReLU after the max pool, which commutes with it),
the max pool, the average pool and the head (cuBLAS, f32) are plain
PyTorch. On a CPU tensor the kernel wrappers run their plain versions. The
forward marks its stem, its four stages and its head with
`trace("forward/r50.<part>")`.

The stem pads by 3 in normalised space, so the input is normalised on the
device before it (`normalize_bgr_uint8`: x * (1 / (255 std)) - mean / std
in one pass, and one rounding to the compute dtype) rather than folded into
the stem's weights: a folded mean would pad with the mean's image, not with
zeros. The channels stay in BGR order; the folded stem kernel takes its
input channels reversed, which is exact.

Variables, a nested tree of tensors:

    {"stem": {"conv": (7,7,3,w) HWIO, "bn": BN},
     "stages": [[{"conv1": (1,1,cin,m), "bn1", "conv2": (3,3,m,m), "bn2",
                  "conv3": (1,1,m,4m), "bn3", "proj": {"conv": (1,1,cin,4m), "bn"} | None}
                 per block] per stage],
     "fc": {"kernel": (4 * mids[-1], classes), "bias": (classes,)}}
    BN = {"scale", "bias", "mean", "var"} each (C,)
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..ops import blocks as B
from ..ops.kernels.conv1x1 import conv1x1
from ..ops.kernels.conv3x3 import conv3x3
from ..utils.profiling import trace

Variables = dict


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    """Static architecture config (torchvision's resnet50; the paper's Table 1).

    stride_on_3x3: v1.5's stride placement (torchvision); False puts it on a
    downsampling block's first 1x1 conv, as the paper's v1 does.
    """

    num_classes: int = 1000
    im_side: int = 224
    stem_width: int = 64
    mid_widths: tuple[int, ...] = (64, 128, 256, 512)
    depths: tuple[int, ...] = (3, 4, 6, 3)
    expansion: int = 4
    stride_on_3x3: bool = True
    bn_eps: float = 1e-5
    mean: tuple[float, float, float] = (0.485, 0.456, 0.406)  # RGB, of x / 255
    std: tuple[float, float, float] = (0.229, 0.224, 0.225)
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def class_labels(self) -> list[str]:
        """The classes' names: their indices (the seeded weights have no
        meaning to name)."""
        return [f"class_{i}" for i in range(self.num_classes)]

    def blocks(self):
        """(stage, block, cin, mid, stride) of every bottleneck, in order."""
        cin = self.stem_width
        for si, (mid, depth) in enumerate(zip(self.mid_widths, self.depths)):
            for bi in range(depth):
                yield si, bi, cin, mid, 2 if bi == 0 and si > 0 else 1
                cin = mid * self.expansion

    def conv_sites(self) -> list[dict]:
        """Every bottleneck conv launch of a forward, in order: {"kernel"
        ("conv1x1" or "conv3x3"), "site", "side" (its input's), "cin",
        "cout", "stride", "relu", "residual"}."""
        side = ((self.im_side - 1) // 2) // 2 + 1  # after the stem's conv and max pool
        out = []
        for si, bi, cin, mid, stride in self.blocks():
            p, c = f"layer{si + 1}/{bi}", mid * self.expansion
            s1, s3 = (1, stride) if self.stride_on_3x3 else (stride, 1)
            mid_side = (side - 1) // s1 + 1
            out.append({"kernel": "conv1x1", "site": f"{p}/conv1", "side": side, "cin": cin, "cout": mid,
                        "stride": s1, "relu": True, "residual": False})
            out.append({"kernel": "conv3x3", "site": f"{p}/conv2", "side": mid_side, "cin": mid, "cout": mid,
                        "stride": s3, "relu": True, "residual": False})
            if bi == 0:
                out.append({"kernel": "conv1x1", "site": f"{p}/proj", "side": side, "cin": cin, "cout": c,
                            "stride": stride, "relu": False, "residual": False})
            side = (side - 1) // stride + 1
            out.append({"kernel": "conv1x1", "site": f"{p}/conv3", "side": side, "cin": mid, "cout": c,
                        "stride": 1, "relu": True, "residual": True})
        return out


RESNET50 = ResNetConfig()


def _fold(conv: torch.Tensor, bn: dict, cfg: ResNetConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """(kernel scaled by the BN's, in the compute dtype; the BN's f32 bias)."""
    w, b = B.bn_fold(bn, cfg.bn_eps)
    return (conv.float() * w).to(cfg.compute_dtype).contiguous(), b.contiguous()


def fold_variables(variables: Variables, cfg: ResNetConfig = RESNET50) -> dict:
    """The operands of every launch of one forward, computed once: each BN
    folded into its conv (`_fold`), the stem's kernel with its input
    channels in BGR order as a channels-last OIHW tensor, the head in f32.
    The forward's input is normalised BGR (`normalize_bgr_uint8`)."""
    k, b = _fold(variables["stem"]["conv"].flip(2), variables["stem"]["bn"], cfg)
    stem = (k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last), b.to(cfg.compute_dtype))
    stages = []
    for stage in variables["stages"]:
        folded = []
        for blk in stage:
            proj = blk["proj"]
            folded.append({"conv1": _fold(blk["conv1"], blk["bn1"], cfg),
                           "conv2": _fold(blk["conv2"], blk["bn2"], cfg),
                           "conv3": _fold(blk["conv3"], blk["bn3"], cfg),
                           "proj": None if proj is None else _fold(proj["conv"], proj["bn"], cfg)})
        stages.append(folded)
    head = (variables["fc"]["kernel"].float().contiguous(), variables["fc"]["bias"].float().contiguous())
    return {"stem": stem, "stages": stages, "head": head}


def normalize_bgr_uint8(x_bgr: torch.Tensor, cfg: ResNetConfig = RESNET50) -> torch.Tensor:
    """BGR uint8 NHWC -> (x / 255 - mean) / std per channel, in BGR order
    (the folded stem's), computed in f32 as x * scale + shift and rounded
    once to the compute dtype."""
    std = torch.tensor(cfg.std[::-1], dtype=torch.float64)
    scale = (1.0 / (255.0 * std)).float().to(x_bgr.device)
    shift = (-torch.tensor(cfg.mean[::-1], dtype=torch.float64) / std).float().to(x_bgr.device)
    return torch.addcmul(shift, x_bgr, scale).to(cfg.compute_dtype)


def bottleneck(x: torch.Tensor, blk: dict, stride: int, cfg: ResNetConfig) -> torch.Tensor:
    """One folded bottleneck on NHWC x: three conv launches, four with the
    projection."""
    s1, s3 = (1, stride) if cfg.stride_on_3x3 else (stride, 1)
    h = conv1x1(x, *blk["conv1"], stride=s1, relu=True)
    h = conv3x3(h, *blk["conv2"], padding=1, stride=s3, relu=True)
    shortcut = x if blk["proj"] is None else conv1x1(x, *blk["proj"], stride=stride)
    return conv1x1(h, *blk["conv3"], relu=True, residual=shortcut)


def forward_folded(folded: dict, x: torch.Tensor, cfg: ResNetConfig = RESNET50):
    """(logits, probs), both (B, num_classes) f32, from `fold_variables` and
    the normalised BGR input (B, S, S, 3)."""
    with trace("forward/r50.stem"):
        k, b = folded["stem"]
        h = F.conv2d(x.to(cfg.compute_dtype).permute(0, 3, 1, 2), k, b, stride=2, padding=3)
        h = F.max_pool2d(h, 3, 2, 1).relu_()  # max pool and ReLU commute
        h = h.permute(0, 2, 3, 1).contiguous()
    for si, stage in enumerate(folded["stages"]):
        with trace(f"forward/r50.stage{si + 1}"):
            for bi, blk in enumerate(stage):
                h = bottleneck(h, blk, 2 if bi == 0 and si > 0 else 1, cfg)
    with trace("forward/r50.head"):
        kernel, bias = folded["head"]
        logits = torch.addmm(bias, h.float().mean((1, 2)), kernel)
        return logits, torch.softmax(logits, -1)


def _bn_init(c: int, device) -> dict:
    return {"scale": torch.ones(c, device=device), "bias": torch.zeros(c, device=device),
            "mean": torch.zeros(c, device=device), "var": torch.ones(c, device=device)}


def _he(shape: tuple[int, ...], generator: torch.Generator) -> torch.Tensor:
    """He-normal f32 HWIO kernel, fan out (torchvision's kaiming_normal_)."""
    std = math.sqrt(2.0 / (shape[0] * shape[1] * shape[3]))
    return torch.randn(shape, generator=generator, device=generator.device) * std


def init_variables(generator: torch.Generator, cfg: ResNetConfig = RESNET50) -> Variables:
    """He-normal conv kernels, identity BN and a uniform FC (torchvision's
    initialisation), drawn from `generator` on its device."""
    dev = generator.device
    w = cfg.stem_width
    stages = [[] for _ in cfg.mid_widths]
    for si, bi, cin, mid, stride in cfg.blocks():
        out = mid * cfg.expansion
        proj = None
        if bi == 0:
            proj = {"conv": _he((1, 1, cin, out), generator), "bn": _bn_init(out, dev)}
        stages[si].append({"conv1": _he((1, 1, cin, mid), generator), "bn1": _bn_init(mid, dev),
                           "conv2": _he((3, 3, mid, mid), generator), "bn2": _bn_init(mid, dev),
                           "conv3": _he((1, 1, mid, out), generator), "bn3": _bn_init(out, dev), "proj": proj})
    d_in = cfg.mid_widths[-1] * cfg.expansion
    bound = 1.0 / math.sqrt(d_in)
    fc = {"kernel": torch.empty((d_in, cfg.num_classes), device=dev).uniform_(-bound, bound, generator=generator),
          "bias": torch.empty(cfg.num_classes, device=dev).uniform_(-bound, bound, generator=generator)}
    return {"stem": {"conv": _he((7, 7, 3, w), generator), "bn": _bn_init(w, dev)}, "stages": stages, "fc": fc}

