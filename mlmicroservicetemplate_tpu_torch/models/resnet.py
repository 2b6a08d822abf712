"""ResNet-50 image classifier (v1.5), channels-last.

Counterpart of the JAX package's ``models/resnet.py``: the stride of a
bottleneck's downsample sits on its 3x3 conv (torchvision and HF
``ResNetForImageClassification``), inference BatchNorm is a per-channel
affine after each conv, and the global average pool and the classifier
run in f32.  Conv weights are OIHW and activations NCHW-logical, both in
``torch.channels_last`` memory format (the reference's NHWC/HWIO in
memory), so cuDNN runs every conv without a layout transpose.

The weights load in the reference's layout, a BN state beside each conv;
``build_model`` then folds each BN's affine into its conv (the weight
scaled per output channel, a bias added), in f32, and casts the result
once to the compute type.  The forward runs 53 convs with bias and no
separate BN pass; on the card each conv with a ReLU after it is one cuDNN
call with its bias, the residual add and the ReLU fused.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from .common import batchnorm_affine, batchnorm_init, conv2d


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
    """A conv: OIHW ``weight``, its stride and padding, and the ``bias``
    its BN folds into (None until ``fold_batchnorm``)."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int = 1, padding: int = 0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in, k, k))
        self.register_parameter("bias", None)
        self.stride, self.padding = stride, padding

    def forward(self, x: torch.Tensor, relu: bool = False,
                residual: torch.Tensor | None = None) -> torch.Tensor:
        """The conv and its bias, then (``relu``) ``residual`` added and a
        ReLU: one fused cuDNN call on the card (``common.conv2d``)."""
        return conv2d(x, self.weight, self.bias, self.stride, self.padding, relu, residual)


class BatchNorm(nn.Module):
    """An inference BN's state: the running statistics and the affine
    (``scale``, ``bias``, ``mean``, ``var``), as the checkpoint holds it.
    It has no forward: ``fold_batchnorm`` folds it into its conv."""

    def __init__(self, c: int):
        super().__init__()
        for name, init in batchnorm_init(c).items():
            self.register_buffer(name, init)


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
        """The folded block: each conv carries its BN, and the last one the
        residual add and the ReLU."""
        residual = x if self.shortcut is None else self.shortcut.conv(x)
        y = self.conv2(self.conv1(x, relu=True), relu=True)
        return self.conv3(y, relu=True, residual=residual)


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


def _conv_bn_pairs(model: ResNet):
    """(module, conv name, BN name) of every conv and the BN after it."""
    for mod in model.modules():
        if isinstance(mod, (Embedder, Shortcut)):
            yield mod, "conv", "bn"
        elif isinstance(mod, Bottleneck):
            for i in (1, 2, 3):
                yield mod, f"conv{i}", f"bn{i}"


def fold_batchnorm(model: ResNet, dtype: torch.dtype) -> None:
    """Fold every BN into the conv before it, in f32 (``W * g`` per output
    channel, bias ``b``, from ``batchnorm_affine``), cast once to ``dtype``
    (conv weights channels-last), and remove the BN modules."""
    for mod, conv_name, bn_name in _conv_bn_pairs(model):
        conv, bn = getattr(mod, conv_name), getattr(mod, bn_name)
        g, b = batchnorm_affine(bn.scale, bn.bias, bn.mean, bn.var, torch.float32)
        w = conv.weight.float() * g[:, None, None, None]
        conv.weight = nn.Parameter(w.to(dtype).contiguous(memory_format=torch.channels_last),
                                   requires_grad=False)
        conv.bias = nn.Parameter(b.to(dtype), requires_grad=False)
        delattr(mod, bn_name)
    model.folded = True


def apply(model: ResNet, images: torch.Tensor) -> torch.Tensor:
    """images: [B, 3, H, W] normalized, channels-last, in the compute type
    -> logits [B, labels] f32.  ``model`` is folded (``build_model``)."""
    if not getattr(model, "folded", False):
        raise ValueError("resnet.apply takes a model whose BNs are folded (build_model)")
    e = model.embedder
    x = e.conv(images, relu=True)
    # torch's implicit max-pool padding is -inf, as the reference's window.
    x = F.max_pool2d(x, 3, 2, padding=1)
    for blocks in model.stages:
        for block in blocks:
            x = block(x)
    # Global average pool -> classifier, in f32 for an exact argmax: one
    # product a row (a batched GEMV over the broadcast weight), so a row's
    # logits never depend on the batch bucket it rides in.
    pooled = x.float().mean(dim=(2, 3))
    n = pooled.shape[0]
    w = model.classifier.weight.float().t().expand(n, -1, -1)
    b = model.classifier.bias.float().expand(n, 1, -1)
    return torch.baddbmm(b, pooled[:, None, :], w)[:, 0]


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
    ``device``, loaded in f32, its BNs folded into the convs
    (``fold_batchnorm``), then conv weights and biases and the classifier
    in ``dtype``, the conv weights channels-last."""
    with torch.device("meta"):
        model = ResNet(cfg)
    placed = {name: torch.as_tensor(v).to(device=device, dtype=torch.float32)
              for name, v in state.items()}
    model.load_state_dict(placed, strict=True, assign=True)
    fold_batchnorm(model, dtype)
    model.classifier.to(dtype)
    return model.eval()
