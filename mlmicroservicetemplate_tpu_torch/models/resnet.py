"""ResNet-50 image classifier (v1.5), channels-last.

Counterpart of the JAX package's ``models/resnet.py``: the stride of a
bottleneck's downsample sits on its 3x3 conv (torchvision and HF
``ResNetForImageClassification``), inference BatchNorm is a per-channel
affine after each conv, and the global average pool and the classifier
run in f32.  Conv weights are OIHW and activations NCHW-logical, both in
``torch.channels_last`` memory format (the reference's NHWC/HWIO in
memory), so cuDNN runs every conv without a layout transpose.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from .common import batchnorm, batchnorm_affine, batchnorm_init, conv2d, dense


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    embedding_size: int = 64
    hidden_sizes: tuple[int, ...] = (256, 512, 1024, 2048)
    depths: tuple[int, ...] = (3, 4, 6, 3)
    num_labels: int = 1000
    downsample_in_first_stage: bool = False
    image_size: int = 224
    reduction: int = 4


class Conv(nn.Module):
    """A bias-free conv: OIHW ``weight``, its stride and padding."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int = 1, padding: int = 0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in, k, k))
        self.stride, self.padding = stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.weight, self.stride, self.padding)


class BatchNorm(nn.Module):
    """Inference BN.  The state is the running statistics and the affine
    (``scale``, ``bias``, ``mean``, ``var``); ``prepare`` forms the ``g``,
    ``b`` the forward applies once, from that state in f32."""

    def __init__(self, c: int):
        super().__init__()
        for name, init in batchnorm_init(c).items():
            self.register_buffer(name, init)
        self.register_buffer("g", None, persistent=False)
        self.register_buffer("b", None, persistent=False)

    def prepare(self, dtype: torch.dtype) -> None:
        self.g, self.b = batchnorm_affine(self.scale, self.bias, self.mean, self.var, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return batchnorm(x, self.g.to(x.dtype), self.b.to(x.dtype))


class Shortcut(nn.Module):
    def __init__(self, c_in: int, c_out: int, stride: int):
        super().__init__()
        self.conv = Conv(c_in, c_out, 1, stride)
        self.bn = BatchNorm(c_out)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride here, v1.5) -> 1x1, with a projected shortcut
    exactly when the width or the resolution changes."""

    def __init__(self, c_in: int, c_out: int, stride: int, reduction: int):
        super().__init__()
        c_mid = c_out // reduction
        self.conv1, self.bn1 = Conv(c_in, c_mid, 1), BatchNorm(c_mid)
        self.conv2, self.bn2 = Conv(c_mid, c_mid, 3, stride, 1), BatchNorm(c_mid)
        self.conv3, self.bn3 = Conv(c_mid, c_out, 1), BatchNorm(c_out)
        self.shortcut = Shortcut(c_in, c_out, stride) if c_in != c_out or stride != 1 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        if self.shortcut is not None:
            residual = self.shortcut.bn(self.shortcut.conv(x))
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + residual)


class Embedder(nn.Module):
    def __init__(self, cfg: ResNetConfig):
        super().__init__()
        self.conv = Conv(3, cfg.embedding_size, 7, 2, 3)
        self.bn = BatchNorm(cfg.embedding_size)


def _stage_strides(cfg: ResNetConfig) -> list[int]:
    first = 2 if cfg.downsample_in_first_stage else 1
    return [first] + [2] * (len(cfg.depths) - 1)


class ResNet(nn.Module):
    """The weights; ``apply`` runs the forward."""

    def __init__(self, cfg: ResNetConfig):
        super().__init__()
        self.cfg = cfg
        self.embedder = Embedder(cfg)
        stages = []
        c_in = cfg.embedding_size
        for depth, c_out, stride in zip(cfg.depths, cfg.hidden_sizes, _stage_strides(cfg)):
            blocks = []
            for bi in range(depth):
                blocks.append(Bottleneck(c_in, c_out, stride if bi == 0 else 1, cfg.reduction))
                c_in = c_out
            stages.append(nn.ModuleList(blocks))
        self.stages = nn.ModuleList(stages)
        self.classifier = nn.Linear(cfg.hidden_sizes[-1], cfg.num_labels)


def apply(model: ResNet, images: torch.Tensor) -> torch.Tensor:
    """images: [B, 3, H, W] normalized, channels-last, in the compute type
    -> logits [B, labels] f32."""
    e = model.embedder
    x = F.relu(e.bn(e.conv(images)))
    # torch's implicit max-pool padding is -inf, as the reference's window.
    x = F.max_pool2d(x, 3, 2, padding=1)
    for blocks in model.stages:
        for block in blocks:
            x = block(x)
    # Global average pool -> classifier, in f32 for an exact argmax.
    pooled = x.float().mean(dim=(2, 3))
    return dense(pooled, model.classifier.weight, model.classifier.bias)


def init_params(cfg: ResNetConfig, generator: torch.Generator) -> dict[str, torch.Tensor]:
    """Random weights in ``ResNet``'s state-dict layout, drawn on the CPU
    from ``generator``: He-normal convs (fan in), Xavier-uniform
    classifier, zero biases, BN at its init (unit scale and variance)."""
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in ResNet(cfg).state_dict().items()}
    out = {}
    for name, shape in shapes.items():
        leaf = name.rpartition(".")[2]
        if name == "classifier.weight":
            a = math.sqrt(6.0 / (shape[0] + shape[1]))
            out[name] = torch.empty(shape).uniform_(-a, a, generator=generator)
        elif leaf == "weight":  # conv, OIHW
            fan_in = shape[1] * shape[2] * shape[3]
            out[name] = torch.empty(shape).normal_(0.0, math.sqrt(2.0 / fan_in),
                                                   generator=generator)
        elif leaf in ("scale", "var"):
            out[name] = torch.ones(shape)
        else:
            out[name] = torch.zeros(shape)
    return out


def build_model(cfg: ResNetConfig, state: dict[str, torch.Tensor], device: torch.device,
                dtype: torch.dtype) -> ResNet:
    """A ``ResNet`` holding ``state`` (strictly: every key, no extras) on
    ``device``: conv and classifier weights in ``dtype``, the conv weights
    channels-last; the BN state stays f32 and its affine is formed once,
    in ``dtype``."""
    with torch.device("meta"):
        model = ResNet(cfg)
    bn_names = {f"{m}.{leaf}" for m, mod in model.named_modules() if isinstance(mod, BatchNorm)
                for leaf in ("scale", "bias", "mean", "var")}
    placed = {}
    for name, v in state.items():
        t = torch.as_tensor(v)
        if name in bn_names:
            placed[name] = t.to(device=device, dtype=torch.float32)
        elif t.dim() == 4:
            placed[name] = t.to(device=device, dtype=dtype).contiguous(
                memory_format=torch.channels_last)
        else:
            placed[name] = t.to(device=device, dtype=dtype)
    model.load_state_dict(placed, strict=True, assign=True)
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            mod.prepare(dtype)
    return model.eval()
