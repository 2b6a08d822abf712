"""Device selection and dtype policy.

The ``DEVICE`` contract of the JAX package (``tpu|cpu``) becomes
``cuda|cpu``.  ``cuda`` is the default and must find a GPU: a service
asked for the card never carries on on the CPU.  ``cpu`` is the explicit
opt-in the tests use.
"""

from __future__ import annotations

import dataclasses

import torch

VALID_DEVICES = ("cuda", "cpu")


def configure_precision() -> None:
    """Full-precision f32 products everywhere (the JAX package's tests run
    XLA at "highest" matmul precision); bf16 serving is unaffected.  cuDNN
    picks its conv algorithms by heuristics, not by timing them: on an H100
    timing gave ResNet-50 no faster forward at B=32 and cost ~9 s of warmup
    in every dispatch thread (PERF.md §5)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False


def get_device(name: str) -> torch.device:
    """``cuda`` or ``cpu`` as a ``torch.device``; raises for ``cuda`` when
    no GPU is visible."""
    name = name.lower()
    if name not in VALID_DEVICES:
        raise ValueError(f"DEVICE must be one of {VALID_DEVICES}, got {name!r}")
    configure_precision()
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "DEVICE=cuda but torch sees no GPU; set DEVICE=cpu to run on the CPU"
        )
    return torch.device(name)


@dataclasses.dataclass(frozen=True)
class DtypePolicy:
    """Parameter, compute and output types.  bf16 params and compute on the
    card halve weight and activation bytes; logits come back in f32 so
    argmax and label probabilities are exact."""

    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32


def default_policy(device: str = "cuda") -> DtypePolicy:
    """bf16 on the card; f32 on the CPU (the parity path)."""
    if device == "cpu":
        return DtypePolicy(torch.float32, torch.float32, torch.float32)
    return DtypePolicy()
