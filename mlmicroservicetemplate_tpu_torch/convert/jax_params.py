"""Carry weights from the JAX package's param pytree into the port.

The JAX BERT keeps its params as a nested dict of arrays
(``{"embeddings": {"word": {"embedding": ...}}, "layers": [...], ...}``,
``dense`` kernels in ``[d_in, d_out]``).  ``bert_params_from_jax`` maps
that pytree, given as numpy arrays, onto ``BertModel``'s state dict: each
dense kernel is transposed into ``nn.Linear``'s ``[d_out, d_in]``; every
other leaf passes through.  ``llama_params_from_jax`` does the same for the
JAX llama pytree (``{"embed", "layers": [{"attn_ln", "attn", "mlp_ln",
"mlp"}], "final_ln", "lm_head"}``) onto ``LlamaModel``,
``gpt_params_from_jax`` the JAX GPT-2 pytree (``{"wte", "wpe", "layers":
[{"ln1", "attn": {"qkv", "out"}, "ln2", "mlp": {"up", "down"}}],
"final_ln"}``) onto ``GPTModel``, ``t5_params_from_jax`` the JAX T5 pytree
(``{"shared", "encoder", "decoder"}`` with layer 0's ``rel_bias`` tables,
and an optional untied ``lm_head`` kernel) onto ``T5Model``, and
``resnet_params_from_jax`` the JAX ResNet pytree (HWIO conv kernels, BN
``scale``/``bias``/``mean``/``var``) onto ``ResNet``, each conv kernel
permuted to OIHW.  All raise on a missing leaf, an unused leaf or a shape
that does not fit the config, so a wrong checkpoint never serves.  A leaf
the JAX package quantized (``QUANTIZE=int8``: ``{"q8", "scale"}``) comes
across as the port's int8 module entries (``<module>.q8`` and
``<module>.scale``, both in the port's layout), which the family's
``build_model`` loads into ``quant``'s int8 modules.
``paged_state_from_jax`` carries a JAX paged decode state (numpy leaves)
into the port's ``PagedState``, so a test can step both from the very same
pool.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.bert import BertConfig, BertModel
from ..models.gpt import GPTConfig, GPTModel, PagedState
from ..models.llama import LlamaConfig, LlamaModel
from ..models.resnet import ResNet, ResNetConfig
from ..models.sampling import SampleParams
from ..models.t5 import T5Config, T5Model

# JAX layout -> the port's: a dense kernel [in, out] -> [out, in], a conv
# kernel HWIO -> OIHW.
DENSE, CONV = (1, 0), (3, 2, 0, 1)


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix[:-1]: np.asarray(tree)}
    out: dict[str, np.ndarray] = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{k}."))
    return out


def _jax_name(port_name: str) -> tuple[str, tuple[int, ...] | None]:
    """JAX leaf path for a port state-dict key, and the axis permutation
    that carries the leaf across (dense kernels are transposed)."""
    mod, _, leaf = port_name.rpartition(".")
    if mod.endswith(".ln"):
        return f"{mod}.{'scale' if leaf == 'weight' else 'bias'}", None
    if mod.startswith("embeddings."):
        return f"{mod}.embedding", None  # nn.Embedding.weight
    if leaf == "weight":
        return f"{mod}.kernel", DENSE
    return f"{mod}.bias", None


def _llama_jax_name(port_name: str) -> tuple[str, tuple[int, ...] | None]:
    """As ``_jax_name``, for ``LlamaModel``: RMSNorm weights are JAX
    ``scale`` leaves, the embedding an ``embedding`` leaf, every other
    weight (the LM head included) a transposed ``kernel``."""
    mod, _, _ = port_name.rpartition(".")
    if mod.endswith("_ln"):
        return f"{mod}.scale", None
    if mod == "embed":
        return "embed.embedding", None
    return f"{mod}.kernel", DENSE


def _gpt_jax_name(port_name: str) -> tuple[str, tuple[int, ...] | None]:
    """As ``_jax_name``, for ``GPTModel``: LayerNorm weights are JAX
    ``scale`` leaves, the two tables ``embedding`` leaves, every other
    weight a transposed ``kernel``."""
    mod, _, leaf = port_name.rpartition(".")
    if mod in ("wte", "wpe"):
        return f"{mod}.embedding", None
    if mod.endswith(("ln1", "ln2")) or mod == "final_ln":
        return f"{mod}.{'scale' if leaf == 'weight' else 'bias'}", None
    if leaf == "weight":
        return f"{mod}.kernel", DENSE
    return port_name, None


def _t5_jax_name(port_name: str) -> tuple[str, tuple[int, ...] | None]:
    """As ``_jax_name``, for ``T5Model``, whose module paths are the JAX
    pytree's: RMSNorm weights are ``scale`` leaves, the shared table and
    the relative-position tables ``embedding`` leaves, every other weight
    (the untied head included) a transposed ``kernel``."""
    mod, _, _ = port_name.rpartition(".")
    if mod.endswith("_ln"):
        return f"{mod}.scale", None
    if mod == "shared" or mod.endswith(".rel_bias"):
        return f"{mod}.embedding", None
    return f"{mod}.kernel", DENSE


def _resnet_jax_name(port_name: str) -> tuple[str, tuple[int, ...] | None]:
    """As ``_jax_name``, for ``ResNet``: the module paths are the JAX
    pytree's; a ``weight`` is a ``kernel`` (the classifier's dense, every
    other a conv's); BN and bias leaves keep their names."""
    mod, _, leaf = port_name.rpartition(".")
    if leaf != "weight":
        return port_name, None
    return f"{mod}.kernel", DENSE if mod == "classifier" else CONV


def bert_params_from_jax(pytree, cfg: BertConfig) -> dict[str, torch.Tensor]:
    """The JAX BERT param pytree (numpy leaves) as ``BertModel``'s state
    dict, f32 on the CPU."""
    with torch.device("meta"):
        expected = BertModel(cfg).state_dict()
    return _from_jax(pytree, expected, _jax_name, "BERT", cfg)


def llama_params_from_jax(pytree, cfg: LlamaConfig) -> dict[str, torch.Tensor]:
    """The JAX llama param pytree (numpy leaves) as ``LlamaModel``'s state
    dict, f32 on the CPU."""
    with torch.device("meta"):
        expected = LlamaModel(cfg).state_dict()
    return _from_jax(pytree, expected, _llama_jax_name, "llama", cfg)


def gpt_params_from_jax(pytree, cfg: GPTConfig) -> dict[str, torch.Tensor]:
    """The JAX GPT-2 param pytree (numpy leaves) as ``GPTModel``'s state
    dict, f32 on the CPU."""
    with torch.device("meta"):
        expected = GPTModel(cfg).state_dict()
    return _from_jax(pytree, expected, _gpt_jax_name, "GPT-2", cfg)


def t5_params_from_jax(pytree, cfg: T5Config) -> dict[str, torch.Tensor]:
    """The JAX T5 param pytree (numpy leaves) as ``T5Model``'s state dict,
    f32 on the CPU; with ``lm_head.weight`` when the pytree carries an
    untied ``lm_head``."""
    with torch.device("meta"):
        expected = T5Model(cfg, untied_head="lm_head" in pytree).state_dict()
    return _from_jax(pytree, expected, _t5_jax_name, "T5", cfg)


def resnet_params_from_jax(pytree, cfg: ResNetConfig) -> dict[str, torch.Tensor]:
    """The JAX ResNet param pytree (numpy leaves) as ``ResNet``'s state
    dict, f32 on the CPU."""
    with torch.device("meta"):
        expected = ResNet(cfg).state_dict()
    return _from_jax(pytree, expected, _resnet_jax_name, "ResNet", cfg)


def _from_jax(pytree, expected, jax_name, family: str, cfg) -> dict[str, torch.Tensor]:
    leaves = _flatten(pytree)
    out: dict[str, torch.Tensor] = {}
    missing = []
    for name, ref in expected.items():
        jname, perm = jax_name(name)
        arr = leaves.pop(jname, None)
        if arr is None and f"{jname}.q8" in leaves:
            # A leaf the reference quantized ({"q8", "scale"}): both carried
            # across in the same layout, as the port's int8 module's entries.
            mod = name.rpartition(".")[0]
            q8 = _carry(leaves.pop(f"{jname}.q8"), perm, ref, jname, name, cfg)
            scale = leaves.pop(f"{jname}.scale", None)
            if scale is None:
                missing.append(f"{jname}.scale")
                continue
            if perm is not None and scale.ndim == len(perm):
                scale = np.transpose(scale, perm)
            out[f"{mod}.q8"] = torch.from_numpy(np.array(q8, dtype=np.int8, order="C"))
            out[f"{mod}.scale"] = torch.from_numpy(np.array(scale, dtype=np.float32, order="C"))
            continue
        if arr is None:
            missing.append(jname)
            continue
        arr = _carry(arr, perm, ref, jname, name, cfg)
        # an owned, row-major copy
        out[name] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))
    if missing:
        raise KeyError(f"JAX {family} params lack {len(missing)} leaves: {missing[:8]}")
    if leaves:
        raise KeyError(
            f"JAX {family} params have {len(leaves)} unused leaves: {sorted(leaves)[:8]}"
        )
    return out


def _carry(arr: np.ndarray, perm, ref, jname: str, name: str, cfg) -> np.ndarray:
    """A JAX leaf in the port's layout (``perm`` applied), checked against
    the shape the port's ``name`` needs."""
    if perm is not None and arr.ndim == len(perm):
        arr = np.transpose(arr, perm)
    if tuple(arr.shape) != tuple(ref.shape):
        raise ValueError(
            f"JAX leaf {jname} has shape {tuple(arr.shape)}; the port's "
            f"{name} needs {tuple(ref.shape)} for {cfg}"
        )
    return arr


def paged_state_from_jax(state) -> PagedState:
    """A JAX ``PagedState`` (numpy leaves; pools ``[NB, BS, KVH, D]``, int8
    pools as ``(payload, scale)``) as the port's, on the CPU: each pool
    gains the port's scratch block ``NB`` (zeros; scale pools ones), the
    per-row indices become int64 and the sampling field becomes the port's
    ``SampleParams`` (u32 key words in int64)."""

    def pool(x, fill):
        x = torch.from_numpy(np.array(x))
        return torch.cat([x, torch.full((1,) + tuple(x.shape[1:]), fill, dtype=x.dtype)])

    def entry(c):
        if isinstance(c, tuple):
            return (pool(c[0], 0), pool(c[1], 1))
        return pool(c, 0)

    def t(x, dtype=None):
        x = torch.from_numpy(np.array(x))
        return x if dtype is None else x.to(dtype)

    return PagedState(
        cache_k=[entry(c) for c in state.cache_k],
        cache_v=[entry(c) for c in state.cache_v],
        key_valid=t(state.key_valid, torch.int32),
        write_idx=t(state.write_idx, torch.long),
        pos=t(state.pos, torch.long),
        last_token=t(state.last_token, torch.long),
        done=t(state.done, torch.bool),
        tokens=t(state.tokens, torch.int32),
        sample=SampleParams(t(state.sample.rng, torch.long), t(state.sample.temperature),
                            t(state.sample.top_k), t(state.sample.top_p)),
    )
