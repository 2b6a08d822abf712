"""Weight-only int8 quantization (``QUANTIZE=int8``) and the symmetric int8
formula the int8 KV cache stores with.

Counterpart of the JAX package's ``models/quant.py``.  The selection rule
is the reference's: a float weight of rank >= 2 with at least
``MIN_QUANT_SIZE`` elements is stored as int8 with f32 scales; norms,
biases and small tables (T5's ``rel_bias``, BERT's ``token_type``) stay as
they are.  The reference scales an embedding table per row and every
other weight per output channel.  The port keeps ``nn.Linear``'s ``[d_out,
d_in]``, ``nn.Embedding``'s ``[V, D]`` and OIHW convs, so both rules are
one here: the scale reduces over every dim but the first (the JAX
``[d_in, d_out]`` kernel reduces over axis 0, HWIO over axes 0-2; its q8
and scale are this one's, transposed).  Quantization runs after the cast
to the parameter type, as the reference's ``_maybe_quantize`` does, so a
bf16 service rounds bf16 weights.

A quantized weight lives in an ``Int8Linear``, ``Int8Embedding`` or
``Int8Conv`` module: an int8 ``q8`` buffer and an f32 ``scale`` buffer, put
in place at build time (``quantize_model``), so a CUDA graph captures
their addresses as it captures the weights'.  Each forward dequantizes in
the compute type, ``q8.to(dtype) * scale.to(dtype)``, as the reference's
``maybe_dequant``; an embedding gathers the rows and their scales first,
and a quantized LM head factors its per-row scale out of the f32 product
(``common.lm_head_logits``).  These are plain PyTorch ops, as the
reference's are plain XLA: no kernel of their own.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
from torch import nn

log = logging.getLogger(__name__)

MIN_QUANT_SIZE = 4096  # below this, int8 saves nothing worth the hop

# The leaf names a quantized weight's state-dict entries take in place of
# ``weight``.
Q8, SCALE = "q8", "scale"


def symmetric_int8(x: torch.Tensor, dim) -> tuple[torch.Tensor, torch.Tensor]:
    """q = round(x / s) clamped to [-127, 127], s = max|x| / 127 over
    ``dim`` (kept), at least 1e-8 / 127.  All in f32; ``torch.round``
    rounds half to even, as ``jnp.round`` does.  Returns (int8 q, f32 s)."""
    xf = x.float()
    amax = xf.abs().amax(dim=dim, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q8 = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q8, scale


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 q8, f32 scale) of a weight in the port's layout: one scale per
    index of dim 0 (a row of a table, an output channel of a dense or conv
    weight)."""
    return symmetric_int8(w, dim=tuple(range(1, w.ndim)))


def dequant(q8: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The reference's ``maybe_dequant``: ``q8 * scale``, both in ``dtype``."""
    return q8.to(dtype) * scale.to(dtype)


class Int8Linear(nn.Module):
    """A quantized dense: ``q8`` [d_out, d_in] int8, ``scale`` [d_out, 1]
    f32, the float ``bias`` (or None); computes in its input's type."""

    def __init__(self, q8: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor | None):
        super().__init__()
        self.register_buffer(Q8, q8)
        self.register_buffer(SCALE, scale)
        self.bias = None if bias is None else nn.Parameter(bias, requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from .common import dense

        return dense(x, dequant(self.q8, self.scale, x.dtype), self.bias)


class Int8Embedding(nn.Module):
    """A quantized table: ``q8`` [V, D] int8 and one f32 scale a row, ``scale``
    [V, 1]."""

    def __init__(self, q8: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self.register_buffer(Q8, q8)
        self.register_buffer(SCALE, scale)

    def lookup(self, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """Rows ``ids`` dequantized in ``dtype``: the rows and their scales
        gathered, then multiplied (the table is never dequantized whole)."""
        rows = torch.nn.functional.embedding(ids, self.q8)
        scales = torch.nn.functional.embedding(ids, self.scale)
        return rows.to(dtype) * scales.to(dtype)


class Int8Conv(nn.Module):
    """A quantized ResNet conv: ``q8`` OIHW int8 (channels-last), ``scale``
    [O, 1, 1, 1] f32, the ``bias`` its BN folds into, its stride and
    padding; the forward of ``resnet.Conv``."""

    def __init__(self, q8: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor | None,
                 stride: int, padding: int):
        super().__init__()
        self.register_buffer(Q8, q8.contiguous(memory_format=torch.channels_last))
        self.register_buffer(SCALE, scale)
        self.bias = None if bias is None else nn.Parameter(bias, requires_grad=False)
        self.stride, self.padding = stride, padding

    def forward(self, x: torch.Tensor, relu: bool = False,
                residual: torch.Tensor | None = None) -> torch.Tensor:
        from .common import conv2d

        return conv2d(x, dequant(self.q8, self.scale, x.dtype), self.bias, self.stride,
                      self.padding, relu, residual)


def _int8_module(mod: nn.Module, q8: torch.Tensor, scale: torch.Tensor) -> nn.Module:
    """The int8 counterpart of ``mod`` holding ``q8`` and ``scale``."""
    if isinstance(mod, nn.Embedding):
        return Int8Embedding(q8, scale)
    if isinstance(mod, nn.Linear):
        return Int8Linear(q8, scale, mod.bias)
    return Int8Conv(q8, scale, mod.bias, mod.stride, mod.padding)


def _eligible(mod: nn.Module) -> bool:
    """A float dense, table or conv weight of rank >= 2 and at least
    ``MIN_QUANT_SIZE`` elements (the reference's rule)."""
    w = getattr(mod, "weight", None)
    return (isinstance(w, torch.Tensor) and w.ndim >= 2 and w.is_floating_point()
            and w.numel() >= MIN_QUANT_SIZE
            and (isinstance(mod, (nn.Linear, nn.Embedding)) or hasattr(mod, "stride")))


def _swap(model: nn.Module, name: str, new: nn.Module) -> None:
    parent, _, leaf = name.rpartition(".")
    setattr(model.get_submodule(parent) if parent else model, leaf, new)


def quantize_model(model: nn.Module, dtype: torch.dtype | None = None) -> int:
    """Quantize every eligible weight of ``model`` in place, from its values
    in ``dtype`` (None: as they are, in the parameter type): each module is
    replaced by its int8 counterpart.  Modules already int8 stay.  Returns
    how many were quantized."""
    n = total = 0
    for name, mod in list(model.named_modules()):
        if name and _eligible(mod):
            w = mod.weight.detach()
            q8, scale = quantize_weight(w if dtype is None else w.to(dtype))
            _swap(model, name, _int8_module(mod, q8, scale))
            n += 1
            total += q8.numel()
    log.info("int8-quantized %d weight tensors (%.1fM params); norms/biases kept",
             n, total / 1e6)
    return n


def prepare_int8_modules(model: nn.Module, state: dict[str, torch.Tensor]) -> None:
    """Replace, in a meta-device ``model``, every module whose state-dict
    entries in ``state`` are ``q8``/``scale`` (a checkpoint quantized by the
    reference, carried across by ``convert.jax_params``) by its int8
    counterpart, so ``load_state_dict`` takes them."""
    for key in [k for k in state if k.endswith("." + Q8)]:
        name = key[: -len(Q8) - 1]
        mod = model.get_submodule(name)
        _swap(model, name, _int8_module(mod, torch.empty_like(state[key], device="meta"),
                                        torch.empty_like(state[f"{name}.{SCALE}"],
                                                         device="meta")))


def place_state(state: dict[str, torch.Tensor], device: torch.device,
                dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """``state`` on ``device``: float weights in ``dtype``, int8 payloads as
    they are, and the f32 scales of quantized weights in f32."""
    def place(key: str, v: torch.Tensor) -> torch.Tensor:
        if v.dtype == torch.int8 or (key.endswith("." + SCALE)
                                     and f"{key[:-len(SCALE)]}{Q8}" in state):
            return v.to(device=device)
        return v.to(device=device, dtype=dtype)

    return {k: place(k, v) for k, v in state.items()}


def load_weights(model: nn.Module, state: dict[str, torch.Tensor], device: torch.device,
                 dtype: torch.dtype, quantize: bool = False) -> nn.Module:
    """A meta-device ``model`` loaded with ``state`` (strictly: every key, no
    extras) on ``device``, float weights in ``dtype`` and int8 ones as given;
    with ``quantize`` every eligible weight left float is then quantized
    (``QUANTIZE=int8``, after the cast).  In eval mode."""
    prepare_int8_modules(model, state)
    model.load_state_dict(place_state(state, device, dtype), strict=True, assign=True)
    if quantize:
        quantize_model(model)
    return model.eval()


def quant_error_stats(w, q8, scale) -> dict:
    """Max/mean abs reconstruction error (test/diagnostic helper)."""
    rec = np.asarray(q8, np.float32) * np.asarray(scale, np.float32)
    err = np.abs(np.asarray(w, np.float32) - rec)
    return {"max": float(err.max()), "mean": float(err.mean())}
