"""HuggingFace BERT state dict -> the JAX package's param pytree layout.

A copy of the BERT part of the JAX package's ``convert/hf_maps.py``:
``MODEL_PATH`` checkpoints go HF names -> this pytree (numpy, linear
weights transposed to ``[in, out]``) -> ``convert.jax_params``, so the
port serves exactly the weights the JAX package serves from the same file.
"""

from __future__ import annotations

import numpy as np

State = dict[str, np.ndarray]


def _lin(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (1, 0)))


def bert_state_to_pytree(state: State, n_layers: int = 12) -> dict:
    def ln(prefix: str) -> dict:
        return {"scale": state[f"{prefix}.weight"], "bias": state[f"{prefix}.bias"]}

    def lin(prefix: str) -> dict:
        return {"kernel": _lin(state[f"{prefix}.weight"]), "bias": state[f"{prefix}.bias"]}

    p: dict = {
        "embeddings": {
            "word": {"embedding": state["bert.embeddings.word_embeddings.weight"]},
            "position": {"embedding": state["bert.embeddings.position_embeddings.weight"]},
            "token_type": {"embedding": state["bert.embeddings.token_type_embeddings.weight"]},
            "ln": ln("bert.embeddings.LayerNorm"),
        },
        "layers": [],
    }
    for i in range(n_layers):
        base = f"bert.encoder.layer.{i}"
        p["layers"].append(
            {
                "attn": {
                    "q": lin(f"{base}.attention.self.query"),
                    "k": lin(f"{base}.attention.self.key"),
                    "v": lin(f"{base}.attention.self.value"),
                    "out": lin(f"{base}.attention.output.dense"),
                    "ln": ln(f"{base}.attention.output.LayerNorm"),
                },
                "mlp": {
                    "up": lin(f"{base}.intermediate.dense"),
                    "down": lin(f"{base}.output.dense"),
                    "ln": ln(f"{base}.output.LayerNorm"),
                },
            }
        )
    if "bert.pooler.dense.weight" in state:
        p["pooler"] = lin("bert.pooler.dense")
    if "classifier.weight" in state:
        p["classifier"] = lin("classifier")
    return p
