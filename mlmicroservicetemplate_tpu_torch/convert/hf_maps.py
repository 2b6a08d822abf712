"""HuggingFace state dicts -> the JAX package's param pytree layout.

A copy of the BERT, T5, GPT-2 and Llama parts of the JAX package's
``convert/hf_maps.py`` (T5's with its optional untied ``lm_head.weight``):
``MODEL_PATH`` checkpoints go HF names -> this pytree (numpy, linear
weights transposed to ``[in, out]``) -> ``convert.jax_params``, so the
port serves exactly the weights the JAX package serves from the same file.

GPT-2's linear layers are HF ``Conv1D`` modules, stored ``[in, out]``
already: ``gpt2_state_to_pytree`` keeps them as they are (as the JAX map
does), and ``convert.jax_params.gpt_params_from_jax`` then transposes them
into ``nn.Linear``'s ``[out, in]``, so a Conv1D weight reaches the port
transposed, unlike every other family's HF linear weight.

ResNet is the exception: HF's layouts (OIHW convs, ``[out, in]`` linear)
are the port's, so ``resnet_state_to_pytree`` maps HF names straight onto
``ResNet``'s state-dict names (the JAX pytree's paths) and moves no axis.
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


def t5_state_to_pytree(state: State, n_layers: int = 6) -> dict:
    def rms(prefix: str) -> dict:
        return {"scale": state[f"{prefix}.weight"]}

    def lin(prefix: str) -> dict:
        # T5 linears have no bias.
        return {"kernel": _lin(state[f"{prefix}.weight"])}

    def attn(base: str, cross: bool = False) -> dict:
        d = {
            "q": lin(f"{base}.q"),
            "k": lin(f"{base}.k"),
            "v": lin(f"{base}.v"),
            "out": lin(f"{base}.o"),
        }
        rp = f"{base}.relative_attention_bias.weight"
        if rp in state:
            d["rel_bias"] = {"embedding": state[rp]}
        return d

    p: dict = {
        "shared": {"embedding": state["shared.weight"]},
        "encoder": {"layers": [], "final_ln": rms("encoder.final_layer_norm")},
        "decoder": {"layers": [], "final_ln": rms("decoder.final_layer_norm")},
    }
    for i in range(n_layers):
        b = f"encoder.block.{i}.layer"
        p["encoder"]["layers"].append(
            {
                "attn": attn(f"{b}.0.SelfAttention"),
                "attn_ln": rms(f"{b}.0.layer_norm"),
                "mlp": {
                    "wi": lin(f"{b}.1.DenseReluDense.wi"),
                    "wo": lin(f"{b}.1.DenseReluDense.wo"),
                },
                "mlp_ln": rms(f"{b}.1.layer_norm"),
            }
        )
    for i in range(n_layers):
        b = f"decoder.block.{i}.layer"
        p["decoder"]["layers"].append(
            {
                "self_attn": attn(f"{b}.0.SelfAttention"),
                "self_attn_ln": rms(f"{b}.0.layer_norm"),
                "cross_attn": attn(f"{b}.1.EncDecAttention", cross=True),
                "cross_attn_ln": rms(f"{b}.1.layer_norm"),
                "mlp": {
                    "wi": lin(f"{b}.2.DenseReluDense.wi"),
                    "wo": lin(f"{b}.2.DenseReluDense.wo"),
                },
                "mlp_ln": rms(f"{b}.2.layer_norm"),
            }
        )
    if "lm_head.weight" in state:
        p["lm_head"] = {"kernel": _lin(state["lm_head.weight"])}
    return p


def gpt2_state_to_pytree(state: State, n_layers: int = 12) -> dict:
    """HF ``GPT2LMHeadModel`` names (``transformer.*``) -> the JAX
    ``models/gpt.init_params`` layout; Conv1D weights stay ``[in, out]``."""

    def ln(prefix: str) -> dict:
        return {"scale": state[f"{prefix}.weight"], "bias": state[f"{prefix}.bias"]}

    def conv1d(prefix: str) -> dict:
        return {"kernel": state[f"{prefix}.weight"], "bias": state[f"{prefix}.bias"]}

    p: dict = {
        "wte": {"embedding": state["transformer.wte.weight"]},
        "wpe": {"embedding": state["transformer.wpe.weight"]},
        "layers": [],
        "final_ln": ln("transformer.ln_f"),
    }
    for i in range(n_layers):
        b = f"transformer.h.{i}"
        p["layers"].append({
            "ln1": ln(f"{b}.ln_1"),
            "attn": {"qkv": conv1d(f"{b}.attn.c_attn"), "out": conv1d(f"{b}.attn.c_proj")},
            "ln2": ln(f"{b}.ln_2"),
            "mlp": {"up": conv1d(f"{b}.mlp.c_fc"), "down": conv1d(f"{b}.mlp.c_proj")},
        })
    return p


def llama_state_to_pytree(state: State, n_layers: int | None = None) -> dict:
    """HF Llama-family names -> the JAX package's ``llama.init_params``
    layout: every projection is an ``nn.Linear`` (``[out, in]``,
    transposed here), norms are RMSNorm weight vectors, ``lm_head.weight``
    ``[V, D]`` becomes the untied ``[D, V]`` kernel.  A tied checkpoint
    (no ``lm_head.weight``) uses the embedding table."""
    if n_layers is None:
        n_layers = 1 + max(
            int(k.split(".")[2]) for k in state if k.startswith("model.layers.")
        )

    def lin(prefix: str) -> dict:
        return {"kernel": _lin(state[f"{prefix}.weight"])}

    embed_w = state["model.embed_tokens.weight"]
    p: dict = {
        "embed": {"embedding": embed_w},
        "layers": [],
        "final_ln": {"scale": state["model.norm.weight"]},
        "lm_head": {"kernel": _lin(state.get("lm_head.weight", embed_w))},
    }
    for i in range(n_layers):
        b = f"model.layers.{i}"
        p["layers"].append(
            {
                "attn_ln": {"scale": state[f"{b}.input_layernorm.weight"]},
                "attn": {
                    "q": lin(f"{b}.self_attn.q_proj"),
                    "k": lin(f"{b}.self_attn.k_proj"),
                    "v": lin(f"{b}.self_attn.v_proj"),
                    "o": lin(f"{b}.self_attn.o_proj"),
                },
                "mlp_ln": {"scale": state[f"{b}.post_attention_layernorm.weight"]},
                "mlp": {
                    "gate": lin(f"{b}.mlp.gate_proj"),
                    "up": lin(f"{b}.mlp.up_proj"),
                    "down": lin(f"{b}.mlp.down_proj"),
                },
            }
        )
    return p


def resnet_state_to_pytree(state: State, depths=(3, 4, 6, 3)) -> State:
    """HF ``ResNetForImageClassification`` names -> ``ResNet``'s state
    dict (numpy, layouts unchanged): the JAX package's map of the same
    name, with ``weight`` for its ``kernel`` and no transposes."""

    def bn(dst: str, src: str) -> None:
        for leaf, hf in (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
                         ("var", "running_var")):
            out[f"{dst}.{leaf}"] = state[f"{src}.{hf}"]

    out: State = {"embedder.conv.weight": state["resnet.embedder.embedder.convolution.weight"]}
    bn("embedder.bn", "resnet.embedder.embedder.normalization")
    for si, depth in enumerate(depths):
        for bi in range(depth):
            src, dst = f"resnet.encoder.stages.{si}.layers.{bi}", f"stages.{si}.{bi}"
            if f"{src}.shortcut.convolution.weight" in state:
                out[f"{dst}.shortcut.conv.weight"] = state[f"{src}.shortcut.convolution.weight"]
                bn(f"{dst}.shortcut.bn", f"{src}.shortcut.normalization")
            for li in range(3):
                out[f"{dst}.conv{li + 1}.weight"] = state[f"{src}.layer.{li}.convolution.weight"]
                bn(f"{dst}.bn{li + 1}", f"{src}.layer.{li}.normalization")
    out["classifier.weight"] = state["classifier.1.weight"]
    out["classifier.bias"] = state["classifier.1.bias"]
    return out
