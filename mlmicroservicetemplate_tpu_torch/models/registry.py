"""Model registry: name -> loaded, servable ``ModelBundle``.

Weights come from, in order: a param pytree handed in by the caller (the
JAX package's layout, as numpy arrays), ``MODEL_PATH`` (an HF state dict,
mapped through the same pytree layout), or a deterministic random init
drawn on the CPU from a seeded ``torch.Generator``.  All three go through
``convert.jax_params.bert_params_from_jax`` or produce its output layout.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Callable

import numpy as np
import torch

from ..runtime.device import DtypePolicy, default_policy, get_device
from . import bert as bert_mod
from .preprocess import load_labels, softmax_np
from .tokenizer import build_tokenizer

log = logging.getLogger(__name__)

KIND_TEXT = "text_classification"
# Seed of the random init when no weights are given.
INIT_SEED = 0


@dataclasses.dataclass
class ModelBundle:
    """Everything the engine, scheduler and API need to serve one model."""

    name: str
    kind: str
    cfg: Any
    model: torch.nn.Module
    device: torch.device
    policy: DtypePolicy
    tokenizer: Any
    labels: list[str] | None
    # (input_ids [B, S] int32, attention_mask [B, S] int32) on the device
    # -> f32 logits [B, num_labels].
    forward: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

    def preprocess(self, item: "RawItem") -> dict[str, np.ndarray]:
        if item.text is None:
            raise ValueError("this model expects a text payload")
        ids, mask = self.tokenizer.encode(item.text, self.cfg.max_position)
        n = int(mask.sum())
        return {"input_ids": ids[:n], "length": np.int32(n)}

    def postprocess(self, row: np.ndarray) -> dict:
        probs = softmax_np(row)
        label_id = int(np.argmax(probs))
        return {
            "prediction": {
                "label_id": label_id,
                **({"label": self.labels[label_id]} if self.labels else {}),
                "score": round(float(probs[label_id]), 6),
            },
            "probs": [round(float(p), 6) for p in probs],
        }


@dataclasses.dataclass
class RawItem:
    """One unparsed /predict payload."""

    text: str | None = None


def _bert_state(svc_cfg, cfg: bert_mod.BertConfig, params) -> dict[str, torch.Tensor]:
    from ..convert.jax_params import bert_params_from_jax

    if params is not None:
        return bert_params_from_jax(params, cfg)
    if svc_cfg.model_path:
        from ..convert.hf_maps import bert_state_to_pytree
        from .checkpoint import load_state_dict

        if os.path.isdir(svc_cfg.model_path):
            raise ValueError(
                f"MODEL_PATH={svc_cfg.model_path!r} is a directory; the port loads "
                "HF state dicts (.npz, .safetensors, .bin), not orbax checkpoints"
            )
        log.info("loading bert-base checkpoint from %s", svc_cfg.model_path)
        state = load_state_dict(svc_cfg.model_path)
        return bert_params_from_jax(bert_state_to_pytree(state, cfg.num_layers), cfg)
    log.info("no MODEL_PATH for bert-base: deterministic random init (seed %d)", INIT_SEED)
    return bert_mod.init_params(cfg, torch.Generator().manual_seed(INIT_SEED))


def _build_bert(svc_cfg, policy: DtypePolicy, device: torch.device,
                params=None) -> ModelBundle:
    cfg = bert_mod.BertConfig()
    model = bert_mod.build_model(cfg, _bert_state(svc_cfg, cfg, params), device,
                                 policy.param_dtype)

    def forward(input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        # The key mask always goes in, so attention runs fused_attention:
        # the CUDA kernel on the card, its plain version on the CPU.
        return model.classify(input_ids, attention_mask, dtype=policy.compute_dtype,
                              use_kernel=True)

    return ModelBundle(
        name="bert-base",
        kind=KIND_TEXT,
        cfg=cfg,
        model=model,
        device=device,
        policy=policy,
        tokenizer=build_tokenizer(svc_cfg.tokenizer_path),
        labels=load_labels(svc_cfg.labels_path),
        forward=forward,
    )


MODEL_REGISTRY: dict[str, Callable] = {
    "bert-base": _build_bert,
    "bert-base-uncased": _build_bert,
}
# Served by the JAX package, not by this port yet.
NOT_PORTED = ("resnet50", "resnet-50", "bert-long", "t5-small", "t5small",
              "gpt2", "llama", "tinyllama")


def build_model(svc_cfg, policy: DtypePolicy | None = None, params=None) -> ModelBundle:
    """Build the bundle for ``svc_cfg.model_name`` on ``svc_cfg.device``.
    ``params``: optional JAX-layout param pytree of numpy arrays."""
    device = get_device(svc_cfg.device)
    if policy is None:
        policy = default_policy(svc_cfg.device)
    builder = MODEL_REGISTRY.get(svc_cfg.model_name)
    if builder is None:
        if svc_cfg.model_name in NOT_PORTED:
            raise ValueError(
                f"model {svc_cfg.model_name!r} is not ported to PyTorch yet; "
                f"available: {sorted(MODEL_REGISTRY)}"
            )
        raise ValueError(
            f"unknown model {svc_cfg.model_name!r}; available: {sorted(MODEL_REGISTRY)}"
        )
    return builder(svc_cfg, policy, device, params)
