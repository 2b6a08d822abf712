"""Model registry: name -> loaded, servable ``ModelBundle``.

Weights come from, in order: a param pytree handed in by the caller (the
JAX package's layout, as numpy arrays), ``MODEL_PATH`` (an HF state dict,
mapped through the same pytree layout; ResNet's HF layouts are the port's,
so its map gives the state dict directly), or a deterministic random init
drawn on the CPU from a seeded ``torch.Generator``.  All three go through
``convert.jax_params`` or produce its output layout.  ``QUANTIZE=int8``
stores every model's large weights as int8 with f32 scales
(``models/quant.py``), quantized after the cast, as the reference does.

Three kinds are served: image classification (ResNet-50), text
classification (BERT-base, and bert-long, the long-context BERT whose
attention runs as a ring over sequence shards), and generation with llama,
GPT-2 and the T5-small encoder-decoder (``KIND_SEQ2SEQ``, the JAX
package's kind for every generative model), greedy or sampled per request,
whole or streamed through the continuous decode loop over a contiguous or
(``PAGED_KV=1``, the decoder-only families) block-paged KV cache, and with
``SPEC_DECODE=ngram`` by speculative verify rounds (``models/spec.py``).
``register_model`` adds a model of the user's own under a name.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
from typing import Any, Callable

import numpy as np
import torch

from ..runtime.device import DtypePolicy, default_policy, get_device
from . import bert as bert_mod
from . import gpt as gpt_mod
from . import lora
from . import llama as llama_mod
from . import resnet as resnet_mod
from . import spec as spec_mod
from . import t5 as t5_mod
from .preprocess import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    decode_image_u8,
    load_labels,
    normalize_imagenet,
    softmax_np,
    topk_np,
)
from .tokenizer import build_tokenizer

log = logging.getLogger(__name__)

KIND_IMAGE = "image_classification"
KIND_TEXT = "text_classification"
KIND_SEQ2SEQ = "seq2seq"
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
    # Text classification: (input_ids [B, S] int32, attention_mask [B, S]
    # int32) on the device -> f32 logits [B, num_labels].  Image
    # classification: (images [B, S, S, 3] uint8 on the device) -> f32
    # logits [B, num_labels].
    forward: Callable[..., torch.Tensor] | None = None
    # Generation: (input_ids, attention_mask, max_len, sample=None,
    # prefix_kv=None) -> decode state after prefill (``sample``: per-row
    # SampleParams; ``prefix_kv``: a cached prefix's per-layer K/V, whose
    # suffix the ids are, else the global ``prompt_prefix``), and (state,
    # n_steps, sample=False) -> (state, tokens [B, n_steps]), where
    # ``sample`` picks per-row sampling over argmax (the JAX static arg).
    # The decoder families' generation callables (these, ``paged_chunk`` and
    # the two window ones) take ``adapters=``: a LoRA overlay
    # (``models/lora.py``), None for the base model.
    init_state: Callable | None = None
    generate_chunk: Callable | None = None
    # Paged generation (PAGED_KV=1, the continuous loop): (PagedState,
    # table [B, T] int32 on the device, n_steps, sample=False) -> (state,
    # tokens).
    paged_chunk: Callable | None = None
    # Chunked prefill (PREFILL_CHUNK, the decoder-only families; None for
    # the others): (batch, s_total, max_len) -> an all-dead decode state
    # ``s_total`` prompt positions plus ``max_len`` wide; (state, ids [B,
    # C], mask [B, C], start) consumes one prompt window at the absolute
    # position ``start`` (a 0-d device tensor) into it, in place; and
    # (paged_state, table_row [T], ids [1, C], mask [1, C], start) writes
    # one window straight into the stream's pool blocks.
    empty_state: Callable | None = None
    prefill_chunk: Callable | None = None
    paged_prefill_chunk: Callable | None = None
    # Encoder-decoders: (n_slots, encoder width, max_len) -> the continuous
    # loop's slot state, every row dead (decoder-only families: None, the
    # loop builds a ``gpt.GPTState`` or ``gpt.PagedState``).
    slot_state: Callable | None = None
    # Speculative decoding (gpt2, llama, t5; None for the others): (state,
    # input_ids, attention_mask, prefix_ids=None) -> ``spec.SpecState`` over
    # a fresh prefill state (``prefix_ids`` [1, P]: a prefix-cache hit's own
    # leading tokens, drafted from), and (spec_state, n_verify, spec_k,
    # sample=False) -> (state, out [B, n_verify, K + 1], n_emit [B,
    # n_verify]), ``n_verify`` verify rounds in place.
    init_spec: Callable | None = None
    spec_chunk: Callable | None = None
    # Cap on a tokenized prompt (generation keeps position-table room for
    # the decode budget).
    max_prompt_len: int | None = None
    # A causal decoder whose prompt may carry a prefix (gpt2, llama): it
    # serves PROMPT_PREFIX and PREFIX_CACHE, and a preempted greedy stream
    # resumes by prefilling its prompt and the tokens it delivered
    # (``engine/streams.py``).
    supports_prefix: bool = False
    # PROMPT_PREFIX's per-layer K/V ({"k": [...], "v": [...]} of [1, P,
    # KVH, D], (int8, scale) pairs under QUANT_KV=int8), computed once at
    # startup; every generation's cache holds it at [0, P).
    prompt_prefix: dict | None = None
    # Sequence-parallel placement (bert-long): the engine hands ``forward``
    # lists of sequence shards placed by it instead of tensors.
    placement: Any = None
    # Image classification: the side of the square crop the model takes.
    image_size: int = 224

    def preprocess(self, item: "RawItem") -> dict[str, np.ndarray]:
        if self.kind == KIND_IMAGE:
            if item.image is None:
                raise ValueError("this model expects an image payload")
            # uint8 on the wire; the normalization runs on the device.
            return {"image": decode_image_u8(item.image, self.image_size)}
        if item.text is None:
            raise ValueError("this model expects a text payload")
        max_len = self.max_prompt_len or self.cfg.max_position
        ids, mask = self.tokenizer.encode(item.text, max_len)
        n = int(mask.sum())
        feats = {"input_ids": ids[:n], "length": np.int32(n)}
        if self.kind == KIND_SEQ2SEQ:
            if item.temperature > 0.0:
                feats["temperature"] = float(item.temperature)
                feats["top_k"] = int(item.top_k)
                feats["top_p"] = float(item.top_p)
                if item.seed is not None:
                    feats["seed"] = int(item.seed)
            if item.max_tokens is not None:
                # The engine stops spending decode chunks on a row once its
                # budget is reached.
                feats["max_tokens"] = int(item.max_tokens)
        return feats

    def postprocess(self, row: np.ndarray) -> dict:
        if self.kind == KIND_IMAGE:
            idx, probs = topk_np(row[None], k=5)
            top = [
                {
                    "class_id": int(i),
                    "score": round(float(p), 6),
                    **({"label": self.labels[int(i)]} if self.labels else {}),
                }
                for i, p in zip(idx[0], probs[0])
            ]
            return {"prediction": top[0], "topk": top}
        if self.kind == KIND_SEQ2SEQ:  # row is a token id vector
            return {"prediction": {"text": self.tokenizer.decode(row)}}
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
    """One unparsed /predict payload: image bytes or a text.  The
    generation fields apply to generative models only: temperature 0 is
    greedy (the default); an unseeded sampled request draws a fresh seed."""

    image: bytes | None = None
    text: str | None = None
    # Streamed through the continuous decode loop.
    stream: bool = False
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int | None = None
    # Generation stops after this many tokens (None = the server's
    # MAX_DECODE_LEN budget) or where a stop string appears.
    max_tokens: int | None = None
    stop: tuple[str, ...] = ()


def _quantize(svc_cfg) -> bool:
    """QUANTIZE=int8: every builder quantizes its weights after the cast to
    the parameter type (``models/quant.py``), random or loaded alike, as
    the reference's ``_maybe_quantize`` does; weights the reference already
    quantized (a JAX param tree with ``{"q8", "scale"}`` leaves) load as
    they are."""
    return getattr(svc_cfg, "quantize", None) == "int8"


def _bert_pytree(svc_cfg, cfg: bert_mod.BertConfig, params, name: str):
    """BERT weights in the JAX package's layout: ``params`` if given, else
    MODEL_PATH's HF state dict mapped onto it; None means random init."""
    if params is None and svc_cfg.model_path:
        from ..convert.hf_maps import bert_state_to_pytree

        state = _load_hf_state(svc_cfg.model_path, name)
        params = bert_state_to_pytree(state, cfg.num_layers)
    return params


def _bert_state(svc_cfg, cfg: bert_mod.BertConfig, params,
                name: str = "bert-base") -> dict[str, torch.Tensor]:
    from ..convert.jax_params import bert_params_from_jax

    if params is None and name == "bert-base":
        state = _port_checkpoint(svc_cfg, name, cfg)
        if state is not None:
            return state
    params = _bert_pytree(svc_cfg, cfg, params, name)
    if params is not None:
        return bert_params_from_jax(params, cfg)
    log.info("no MODEL_PATH for %s: deterministic random init (seed %d)", name, INIT_SEED)
    return bert_mod.init_params(cfg, torch.Generator().manual_seed(INIT_SEED))


def _port_checkpoint(svc_cfg, name: str, cfg) -> dict[str, torch.Tensor] | None:
    """MODEL_PATH's parameters when it is a directory the converter CLI
    wrote (``python -m mlmicroservicetemplate_tpu_torch.convert``): loaded
    as they are, no HF mapping; else None."""
    from .checkpoint import is_checkpoint_dir, load_checkpoint

    path = svc_cfg.model_path
    if not path or not is_checkpoint_dir(path):
        return None
    log.info("loading converted %s checkpoint from %s", name, path)
    return load_checkpoint(path, name, getattr(cfg, "num_layers", None))


def param_config(name: str, num_layers: int | None = None):
    """The config whose parameter shapes a checkpoint of ``name`` has: the
    model's standard widths (llama's as ``LLAMA_CONFIG`` sets them, as the
    service reads that variable), at ``num_layers`` when given.  The
    converter CLI carries its parameters into the port's names with it."""
    layers = {} if num_layers is None else {"num_layers": int(num_layers)}
    if name == "resnet50":
        return resnet_mod.ResNetConfig()
    if name == "bert-base":
        return bert_mod.BertConfig(**layers)
    if name == "t5-small":
        return t5_mod.T5Config(**layers)
    if name == "gpt2":
        return gpt_mod.GPTConfig(**layers)
    if name == "llama":
        overrides = json.loads(os.environ.get("LLAMA_CONFIG") or "{}")
        return llama_mod.LlamaConfig(**{**overrides, **layers})
    raise ValueError(f"no checkpoint config for {name!r}")


def _load_hf_state(path: str, name: str) -> dict[str, np.ndarray]:
    from .checkpoint import load_state_dict

    if os.path.isdir(path):
        raise ValueError(
            f"MODEL_PATH={path!r} is a directory; the port loads HF state dicts "
            "(.npz, .safetensors, .bin) and the directories its converter writes "
            "(python -m mlmicroservicetemplate_tpu_torch.convert), not orbax checkpoints"
        )
    log.info("loading %s checkpoint from %s", name, path)
    return load_state_dict(path)


def _build_resnet(svc_cfg, policy: DtypePolicy, device: torch.device,
                  params=None) -> ModelBundle:
    """ResNet-50 v1.5 at full width: weights from ``params`` (the JAX
    package's layout), MODEL_PATH's HF state dict, or a random init."""
    from ..convert.jax_params import resnet_params_from_jax

    cfg = resnet_mod.ResNetConfig()
    if params is not None:
        state = resnet_params_from_jax(params, cfg)
    elif (converted := _port_checkpoint(svc_cfg, "resnet50", cfg)) is not None:
        state = converted
    elif svc_cfg.model_path:
        from ..convert.hf_maps import resnet_state_to_pytree

        state = resnet_state_to_pytree(_load_hf_state(svc_cfg.model_path, "resnet50"),
                                       cfg.depths)
    else:
        log.info("no MODEL_PATH for resnet50: deterministic random init (seed %d)", INIT_SEED)
        state = resnet_mod.init_params(cfg, torch.Generator().manual_seed(INIT_SEED))
    model = resnet_mod.build_model(cfg, state, device, policy.param_dtype, _quantize(svc_cfg))
    # On the device once: a per-call copy from the host would wait for the
    # previous forward.
    stats = [torch.from_numpy(a).to(device) for a in (IMAGENET_MEAN, IMAGENET_STD)]

    def forward(images: torch.Tensor) -> torch.Tensor:
        # uint8 NHWC in; normalize on the device, then NCHW-logical with
        # channels-last strides (the permute of NHWC already has them).
        x = normalize_imagenet(images, *stats).permute(0, 3, 1, 2)
        x = x.to(policy.compute_dtype).contiguous(memory_format=torch.channels_last)
        return resnet_mod.apply(model, x)

    return ModelBundle(
        name="resnet50",
        kind=KIND_IMAGE,
        cfg=cfg,
        model=model,
        device=device,
        policy=policy,
        tokenizer=None,
        labels=load_labels(svc_cfg.labels_path),
        forward=forward,
        image_size=cfg.image_size,
    )


def _build_bert(svc_cfg, policy: DtypePolicy, device: torch.device,
                params=None) -> ModelBundle:
    cfg = bert_mod.BertConfig()
    model = bert_mod.build_model(cfg, _bert_state(svc_cfg, cfg, params), device,
                                 policy.param_dtype, _quantize(svc_cfg))

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


def _build_bert_long(svc_cfg, policy: DtypePolicy, device: torch.device,
                     params=None) -> ModelBundle:
    """Long-context BERT classifier served with ring attention.

    The sequence axis shards over ``SP`` devices (``parallel.SeqParallelSet``;
    0 = every visible card, one shard on the CPU) and every encoder layer's
    attention runs as a ring across the shards (``parallel.ring_attention``,
    kernel K4 on the card at every hop).  The position table covers the
    largest seq bucket (at least 512 rows); every seq bucket must divide by
    the shard count."""
    from ..parallel import SeqParallelSet, make_sp_devices

    placement = SeqParallelSet(make_sp_devices(device.type, svc_cfg.sp))
    width = placement.seq_multiple()
    bad = [s for s in svc_cfg.seq_buckets if s % width]
    if bad:
        raise ValueError(f"SEQ_BUCKETS {bad} not divisible by sp mesh width {width}")
    max_pos = max(max(svc_cfg.seq_buckets), 512)
    cfg = bert_mod.BertConfig(max_position=max_pos)
    params = _bert_pytree(svc_cfg, cfg, params, "bert-long")
    if params is not None:
        # The position table must cover the long buckets: an embedding
        # lookup past it would fail at the first long request (the JAX
        # package's jnp.take would clamp it and serve wrong logits), so fail
        # at startup instead.
        pos = params["embeddings"]["position"]["embedding"]
        pos_rows = int(np.shape(pos["q8"] if isinstance(pos, dict) else pos)[0])
        if pos_rows < max_pos:
            raise ValueError(
                f"bert-long needs a position-embedding table with >= {max_pos} rows for "
                f"SEQ_BUCKETS={svc_cfg.seq_buckets}, but the loaded checkpoint has "
                f"{pos_rows}; extend the table (e.g. interpolate) or lower the buckets"
            )
        cfg = dataclasses.replace(cfg, max_position=pos_rows)
    state = _bert_state(svc_cfg, cfg, params, "bert-long")
    replicas = placement.place_params(
        lambda dev: bert_mod.build_model(cfg, state, dev, policy.param_dtype,
                                         _quantize(svc_cfg)))

    def forward(input_ids: list[torch.Tensor], attention_mask: list[torch.Tensor]):
        # Sequence shards in, logits [B, num_labels] f32 on the first
        # shard's device out; ring_hop runs the kernel on the card.
        return bert_mod.classify_seq_parallel(replicas, input_ids, attention_mask,
                                              dtype=policy.compute_dtype)

    return ModelBundle(
        name="bert-long",
        kind=KIND_TEXT,
        cfg=cfg,
        model=replicas[0],
        device=placement.devices[0],
        policy=policy,
        tokenizer=build_tokenizer(svc_cfg.tokenizer_path),
        labels=load_labels(svc_cfg.labels_path),
        forward=forward,
        placement=placement,
    )


def decode_budget(svc_cfg) -> int:
    """MAX_DECODE_LEN rounded up to whole STREAM_CHUNK_TOKENS chunks: the
    decode width of every generation's cache."""
    chunk = svc_cfg.stream_chunk_tokens
    return int(math.ceil(svc_cfg.max_decode_len / chunk) * chunk)


def _decode_position_budget(svc_cfg, max_position: int, p_len: int, family: str) -> int:
    """Prefix, prompt and decode must fit the position table (an embedding
    lookup past it would fail, where the JAX package's would silently
    clamp): returns the longest prompt; raises when no prompt fits or a seq
    bucket exceeds it."""
    budget = decode_budget(svc_cfg)
    if budget + p_len >= max_position:
        raise ValueError(
            f"MAX_DECODE_LEN(+chunk rounding)={budget} plus prefix {p_len} leaves no room "
            f"for a prompt within {family}'s {max_position} positions"
        )
    max_prompt = max_position - budget - p_len
    bad = [s for s in svc_cfg.seq_buckets if s > max_prompt]
    if bad:
        raise ValueError(
            f"SEQ_BUCKETS {bad} exceed {family}'s position budget: max prompt = "
            f"{max_position} - {budget} decode - {p_len} prefix = {max_prompt}"
        )
    return max_prompt


def prompt_prefix_ids(tokenizer, prefix: str, max_positions: int) -> np.ndarray:
    """A PROMPT_PREFIX's ids: the request tokenizer's, less the terminal
    specials it appends (an EOS, a [SEP]), which inside every served context
    would cut the prefix off from the prompt; a leading BOS stays.  A
    prefix of nothing else raises."""
    ids, mask = tokenizer.encode(prefix, max_positions)
    n = int(mask.sum())
    terminal = {int(t) for t in (getattr(tokenizer, "eos_id", None),
                                 getattr(tokenizer, "sep_id", None)) if t is not None}
    while n > 0 and int(ids[n - 1]) in terminal:
        n -= 1
    if n == 0:
        raise ValueError("PROMPT_PREFIX tokenized to zero (non-special) tokens")
    return np.asarray(ids[:n], np.int32)


def _attach_prompt_prefix(model, family, tokenizer, svc_cfg, policy: DtypePolicy,
                          max_positions: int) -> dict | None:
    """PROMPT_PREFIX's per-layer K/V (``family.compute_prefix_kv`` over
    ``prompt_prefix_ids``, one prefill at startup), or None without one."""
    if not svc_cfg.prompt_prefix:
        return None
    ids = prompt_prefix_ids(tokenizer, svc_cfg.prompt_prefix, max_positions)
    with torch.inference_mode():
        pkv = family.compute_prefix_kv(model, ids, dtype=policy.compute_dtype)
    log.info("cached prompt prefix: %d tokens", len(ids))
    return pkv


def _llama_config(svc_cfg, tokenizer) -> llama_mod.LlamaConfig:
    overrides = {}
    if svc_cfg.llama_config:
        overrides = json.loads(svc_cfg.llama_config)
        if not isinstance(overrides, dict):
            raise ValueError(f"LLAMA_CONFIG must be a JSON object, got {svc_cfg.llama_config!r}")
    known = {f.name for f in dataclasses.fields(llama_mod.LlamaConfig)}
    unknown = sorted(set(overrides) - known)
    if unknown:
        raise ValueError(
            f"LLAMA_CONFIG keys {unknown} are not LlamaConfig fields of the port "
            "(the TPU kernel knobs pallas_* and tp are not ported yet)"
        )
    # The model's EOS/pad are the tokenizer's ids, as in the JAX package.
    overrides.setdefault("eos_id", int(tokenizer.eos_id))
    overrides.setdefault("pad_id", int(tokenizer.pad_id))
    if svc_cfg.quant_kv == "int8":
        overrides["kv_quant"] = True
    cfg = llama_mod.LlamaConfig(**overrides)
    max_id = int(getattr(tokenizer, "vocab_size", 1)) - 1
    if max_id >= cfg.vocab_size:
        raise ValueError(
            f"tokenizer at {svc_cfg.tokenizer_path!r} can emit id {max_id} "
            f">= llama embedding table rows {cfg.vocab_size}"
        )
    if not (0 <= cfg.eos_id < cfg.vocab_size and 0 <= cfg.pad_id < cfg.vocab_size):
        raise ValueError(
            f"eos_id={cfg.eos_id}/pad_id={cfg.pad_id} outside llama vocab of {cfg.vocab_size}"
        )
    return cfg


def _llama_state(svc_cfg, cfg: llama_mod.LlamaConfig, params) -> dict[str, torch.Tensor]:
    from ..convert.jax_params import llama_params_from_jax

    if params is not None:
        return llama_params_from_jax(params, cfg)
    state = _port_checkpoint(svc_cfg, "llama", cfg)
    if state is not None:
        return state
    if svc_cfg.model_path:
        from ..convert.hf_maps import llama_state_to_pytree

        state = _load_hf_state(svc_cfg.model_path, "llama")
        return llama_params_from_jax(llama_state_to_pytree(state), cfg)
    log.info("no MODEL_PATH for llama: deterministic random init (seed %d)", INIT_SEED)
    return llama_mod.init_params(cfg, torch.Generator().manual_seed(INIT_SEED))


def _build_llama(svc_cfg, policy: DtypePolicy, device: torch.device,
                 params=None) -> ModelBundle:
    """Llama-family generation.  Default dims are TinyLlama-1.1B;
    ``LLAMA_CONFIG`` takes a JSON object of ``LlamaConfig`` overrides and
    ``QUANT_KV=int8`` turns on the int8 KV cache."""
    # Llama prompts start with <s> and end in no </s> (T5's convention
    # inverted), so a SentencePiece file loads with add_bos and without
    # add_eos; other paths, and none, take the generative fallback (the
    # byte tokenizer with a trailing EOS), as in the JAX package.
    tok_path = svc_cfg.tokenizer_path
    if tok_path and tok_path.endswith((".model", ".tsv", ".vocab")):
        from .sentencepiece import load_sentencepiece

        tokenizer = load_sentencepiece(tok_path, add_eos=False, add_bos=True)
    else:
        tokenizer = build_tokenizer(tok_path, for_t5=True)
    cfg = _llama_config(svc_cfg, tokenizer)
    model = llama_mod.build_model(cfg, _llama_state(svc_cfg, cfg, params), device,
                                  policy.param_dtype, _quantize(svc_cfg))
    # The shared prefix carries the BOS; the prompts after it then take none.
    prefix = _attach_prompt_prefix(model, llama_mod, tokenizer, svc_cfg, policy,
                                   cfg.max_position)
    if prefix is not None and cfg.kv_quant:
        # The int8 cache holds every row as int8 and a scale, the prefix's
        # too: quantized once here.
        prefix = llama_mod.quantize_prefix_kv(prefix)
    if prefix is not None and getattr(tokenizer, "add_bos", False):
        tokenizer.add_bos = False
    p_len = 0 if prefix is None else gpt_mod.prefix_len(prefix["k"][0])
    max_prompt = _decode_position_budget(svc_cfg, cfg.max_position, p_len, "llama")
    return _generative_bundle("llama", llama_mod, model, cfg, tokenizer, svc_cfg, policy,
                              device, max_prompt, prefix)


def _generative_bundle(name: str, family, model, cfg, tokenizer, svc_cfg,
                       policy: DtypePolicy, device: torch.device,
                       max_prompt: int, prompt_prefix: dict | None = None) -> ModelBundle:
    """A ``KIND_SEQ2SEQ`` bundle over a decoder family's module (``gpt`` or
    ``llama``: ``init_decode_state``, ``generate_chunk``,
    ``generate_chunk_paged``), behind ``prompt_prefix`` when given.  The
    prefill, decode and window callables take an ``adapters`` overlay
    (``models/lora.py``; the continuous loop's, under ADAPTER_DIR), None
    for the base model."""

    def init_state(input_ids, attention_mask, max_len: int, sample=None, prefix_kv=None,
                   adapters=None):
        return family.init_decode_state(
            lora.attach(model, adapters), input_ids, attention_mask, max_len,
            dtype=policy.compute_dtype, sample=sample,
            prefix_kv=prompt_prefix if prefix_kv is None else prefix_kv)

    def generate_chunk(state, n_steps: int, sample: bool = False, adapters=None):
        return family.generate_chunk(lora.attach(model, adapters), state, n_steps, sample)

    def paged_chunk(state, table, n_steps: int, sample: bool = False, adapters=None):
        return family.generate_chunk_paged(lora.attach(model, adapters), state, table,
                                           svc_cfg.kv_block_size, n_steps, sample)

    def empty_state(batch: int, s_total: int, max_len: int):
        return family.empty_decode_state(model, batch, s_total, max_len,
                                         dtype=policy.compute_dtype)

    def prefill_chunk(state, ids, mask, start, adapters=None):
        return family.prefill_chunk(lora.attach(model, adapters), state, ids, mask, start)

    def paged_prefill_chunk(state, table_row, ids, mask, start, adapters=None):
        return family.paged_prefill_chunk(lora.attach(model, adapters), state, table_row, ids,
                                          mask, start, svc_cfg.kv_block_size)

    p_len = 0 if prompt_prefix is None else gpt_mod.prefix_len(prompt_prefix["k"][0])

    return ModelBundle(
        name=name,
        kind=KIND_SEQ2SEQ,
        cfg=cfg,
        model=model,
        device=device,
        policy=policy,
        tokenizer=tokenizer,
        labels=None,
        init_state=init_state,
        generate_chunk=generate_chunk,
        paged_chunk=paged_chunk,
        empty_state=empty_state,
        prefill_chunk=prefill_chunk,
        paged_prefill_chunk=paged_prefill_chunk,
        init_spec=spec_mod.make_init_spec_fn(p_len),
        spec_chunk=_spec_chunk_fn(lambda st, toks: family.multi_step(model, st, toks), cfg,
                                  svc_cfg),
        max_prompt_len=max_prompt,
        supports_prefix=True,
        prompt_prefix=prompt_prefix,
    )


def _spec_chunk_fn(multi_fn, cfg, svc_cfg):
    """The bundle's ``spec_chunk`` over a family's verify window
    ``multi_fn(state, tokens) -> logits``, at ``SPEC_NGRAM``."""
    def spec_chunk(spec_state, n_verify: int, spec_k: int, sample: bool = False):
        return spec_mod.spec_chunk(spec_state, n_verify, spec_k, int(svc_cfg.spec_ngram),
                                   multi_fn, cfg.eos_id, cfg.pad_id, sample)

    return spec_chunk


def _gpt_state(svc_cfg, cfg: gpt_mod.GPTConfig, params) -> dict[str, torch.Tensor]:
    from ..convert.jax_params import gpt_params_from_jax

    if params is not None:
        return gpt_params_from_jax(params, cfg)
    state = _port_checkpoint(svc_cfg, "gpt2", cfg)
    if state is not None:
        return state
    if svc_cfg.model_path:
        from ..convert.hf_maps import gpt2_state_to_pytree

        state = _load_hf_state(svc_cfg.model_path, "gpt2")
        return gpt_params_from_jax(gpt2_state_to_pytree(state, cfg.num_layers), cfg)
    log.info("no MODEL_PATH for gpt2: deterministic random init (seed %d)", INIT_SEED)
    return gpt_mod.init_params(cfg, torch.Generator().manual_seed(INIT_SEED))


def _build_gpt(svc_cfg, policy: DtypePolicy, device: torch.device,
               params=None) -> ModelBundle:
    """GPT-2 small generation, greedy or sampled, whole or streamed.
    Tokenizer: a GPT-2 ``vocab.json`` (with ``merges.txt``) through
    ``TOKENIZER_PATH``, else the byte-level fallback, whose eos and pad the
    model takes so that EOS detection agrees with the detokenizer."""
    tokenizer = build_tokenizer(svc_cfg.tokenizer_path, for_t5=True)
    cfg = gpt_mod.GPTConfig(eos_id=int(tokenizer.eos_id), pad_id=int(tokenizer.pad_id))
    # An id past the embedding table would fail at lookup (the JAX package's
    # would be silently clamped): compare the largest id the tokenizer can
    # emit, not its vocab count.
    max_id = int(getattr(tokenizer, "max_token_id", getattr(tokenizer, "vocab_size", 1) - 1))
    if max_id >= cfg.vocab_size:
        raise ValueError(
            f"tokenizer at {svc_cfg.tokenizer_path!r} can emit id {max_id} >= gpt2 "
            f"embedding table rows {cfg.vocab_size}; out-of-range ids would be silently "
            "clamped"
        )
    if not (0 <= cfg.eos_id < cfg.vocab_size and 0 <= cfg.pad_id < cfg.vocab_size):
        raise ValueError(
            f"tokenizer eos_id={cfg.eos_id}/pad_id={cfg.pad_id} outside gpt2 vocab of "
            f"{cfg.vocab_size}"
        )
    model = gpt_mod.build_model(cfg, _gpt_state(svc_cfg, cfg, params), device,
                                policy.param_dtype, _quantize(svc_cfg))
    prefix = _attach_prompt_prefix(model, gpt_mod, tokenizer, svc_cfg, policy,
                                   cfg.max_position)
    p_len = 0 if prefix is None else gpt_mod.prefix_len(prefix["k"][0])
    max_prompt = _decode_position_budget(svc_cfg, cfg.max_position, p_len, "gpt2")
    return _generative_bundle("gpt2", gpt_mod, model, cfg, tokenizer, svc_cfg, policy, device,
                              max_prompt, prefix)


# T5 has no position table (relative positions), so its prompts are capped
# at 512 tokens whatever the seq buckets are, as in the JAX package.
T5_MAX_PROMPT = 512


def _t5_state(svc_cfg, cfg: t5_mod.T5Config, params) -> dict[str, torch.Tensor]:
    from ..convert.jax_params import t5_params_from_jax

    if params is not None:
        return t5_params_from_jax(params, cfg)
    state = _port_checkpoint(svc_cfg, "t5-small", cfg)
    if state is not None:
        return state
    if svc_cfg.model_path:
        from ..convert.hf_maps import t5_state_to_pytree

        state = _load_hf_state(svc_cfg.model_path, "t5-small")
        return t5_params_from_jax(t5_state_to_pytree(state, cfg.num_layers), cfg)
    log.info("no MODEL_PATH for t5-small: deterministic random init (seed %d)", INIT_SEED)
    return t5_mod.init_params(cfg, torch.Generator().manual_seed(INIT_SEED))


def _build_t5(svc_cfg, policy: DtypePolicy, device: torch.device,
              params=None) -> ModelBundle:
    """T5-small seq2seq, greedy or sampled, whole or streamed.  ``init_state``
    encodes (K1 with the relative-position bias on the card) and builds the
    decode state with the cross K/V projected once; the continuous loop's
    slots hold self caches ``MAX_DECODE_LEN`` wide and cross K/V as wide as
    the largest seq bucket.  Tokenizer: a SentencePiece ``TOKENIZER_PATH``
    (with a trailing EOS), else the byte fallback."""
    cfg = t5_mod.T5Config()
    tokenizer = build_tokenizer(svc_cfg.tokenizer_path, for_t5=True)
    max_id = int(getattr(tokenizer, "vocab_size", 1)) - 1
    if max_id >= cfg.vocab_size:
        raise ValueError(
            f"tokenizer at {svc_cfg.tokenizer_path!r} can emit id {max_id} >= t5-small "
            f"embedding table rows {cfg.vocab_size}"
        )
    model = t5_mod.build_model(cfg, _t5_state(svc_cfg, cfg, params), device,
                               policy.param_dtype, _quantize(svc_cfg))

    def init_state(input_ids, attention_mask, max_len: int, sample=None):
        enc = t5_mod.encode(model, input_ids, attention_mask, policy.compute_dtype)
        return t5_mod.init_decode_state(model, enc, attention_mask, max_len, sample=sample)

    def generate_chunk(state, n_steps: int, sample: bool = False):
        return t5_mod.generate_chunk(model, state, n_steps, sample)

    def slot_state(n_slots: int, enc_width: int, max_len: int):
        return t5_mod.empty_state(cfg, n_slots, enc_width, max_len, policy.compute_dtype,
                                  device)

    # Summaries quote their input: the drafting history is [encoder ids |
    # decoder tokens], so lookups land in the document.
    def init_spec(state, input_ids, attention_mask, prefix_ids=None):
        return t5_mod.init_spec_state(state, input_ids, attention_mask)

    return ModelBundle(
        name="t5-small",
        kind=KIND_SEQ2SEQ,
        cfg=cfg,
        model=model,
        device=device,
        policy=policy,
        tokenizer=tokenizer,
        labels=None,
        init_state=init_state,
        generate_chunk=generate_chunk,
        slot_state=slot_state,
        init_spec=init_spec,
        spec_chunk=_spec_chunk_fn(lambda st, toks: t5_mod.multi_step(model, st, toks), cfg,
                                  svc_cfg),
        max_prompt_len=T5_MAX_PROMPT,
    )


MODEL_REGISTRY: dict[str, Callable] = {
    "resnet50": _build_resnet,
    "resnet-50": _build_resnet,
    "bert-base": _build_bert,
    "bert-base-uncased": _build_bert,
    "bert-long": _build_bert_long,
    "llama": _build_llama,
    "tinyllama": _build_llama,
    "gpt2": _build_gpt,
    "t5-small": _build_t5,
    "t5small": _build_t5,
}


def register_model(name: str, builder: Callable) -> None:
    """The template's extension point: serve your own model under a name.

    ``builder(svc_cfg, policy, device, params=None) -> ModelBundle`` (the
    port's builder signature: the JAX package's takes ``(svc_cfg,
    policy)``) gets the service config, the dtype policy, the
    ``torch.device`` to place the model on and the ``params`` handed to
    ``build_service`` (None unless the caller gives some).  Set
    ``MODEL_NAME=<name>`` and the engine, batcher and API serve it
    unchanged: a ``KIND_TEXT`` or ``KIND_IMAGE`` bundle through its
    ``forward``."""
    if not callable(builder):
        raise TypeError(
            "builder must be callable(svc_cfg, policy, device, params=None) -> ModelBundle")
    if name in MODEL_REGISTRY:
        log.warning("register_model: overriding existing model %r", name)
    MODEL_REGISTRY[name] = builder


def build_model(svc_cfg, policy: DtypePolicy | None = None, params=None) -> ModelBundle:
    """Build the bundle for ``svc_cfg.model_name`` on ``svc_cfg.device``.
    ``params``: optional JAX-layout param pytree of numpy arrays."""
    device = get_device(svc_cfg.device)
    if policy is None:
        policy = default_policy(svc_cfg.device)
    builder = MODEL_REGISTRY.get(svc_cfg.model_name)
    if builder is None:
        raise ValueError(
            f"unknown model {svc_cfg.model_name!r}; available: {sorted(MODEL_REGISTRY)}"
        )
    if svc_cfg.quant_kv and MODEL_REGISTRY[svc_cfg.model_name] is not _build_llama:
        raise ValueError(
            f"QUANT_KV is not supported for {svc_cfg.model_name!r} "
            "(int8 KV cache covers the llama family)"
        )
    if svc_cfg.paged_kv and builder not in (_build_llama, _build_gpt):
        raise ValueError(
            f"PAGED_KV is not supported for {svc_cfg.model_name!r} "
            "(block-paged KV covers the decoder families: gpt2, llama)"
        )
    bundle = builder(svc_cfg, policy, device, params)
    # The prefix knobs, refused where they would be dropped or collide,
    # with the JAX package's messages.
    if svc_cfg.prompt_prefix and not bundle.supports_prefix:
        raise ValueError(
            f"PROMPT_PREFIX is not supported for {svc_cfg.model_name!r} "
            "(cached-prefix serving covers the decoder families: gpt2, llama)"
        )
    # SPEC_DECODE, refused where it would be dropped: an operator who turned
    # it on must not serve without it.
    if svc_cfg.spec_decode and bundle.spec_chunk is None:
        raise ValueError(
            f"SPEC_DECODE is not supported for {svc_cfg.model_name!r} "
            "(speculative decoding covers the generative families: "
            "gpt2, llama, t5-small)"
        )
    if svc_cfg.spec_continuous and not svc_cfg.spec_decode:
        raise ValueError(
            "SPEC_CONTINUOUS requires SPEC_DECODE=ngram (it is the "
            "continuous-loop extension of speculative decoding)"
        )
    if svc_cfg.paged_kv and svc_cfg.prompt_prefix:
        raise ValueError(
            "PAGED_KV and PROMPT_PREFIX are mutually exclusive: the "
            "global prefix overlay predates the block pool — use "
            "PREFIX_CACHE=1, whose hits SHARE prompt blocks by "
            "refcount"
        )
    if svc_cfg.paged_kv and svc_cfg.spec_continuous:
        raise ValueError(
            "PAGED_KV does not yet compose with SPEC_CONTINUOUS "
            "(speculative verify windows write multi-token spans "
            "through the table; planned follow-up)"
        )
    if svc_cfg.prefill_chunk > 0:
        # Chunked prefill changes the loop's dispatch unit: a combination it
        # does not serve refuses to start rather than serve monolithic.
        if bundle.prefill_chunk is None:
            raise ValueError(
                f"PREFILL_CHUNK is not supported for {svc_cfg.model_name!r} "
                "(chunked prefill covers the decoder families gpt2/llama; "
                "encoder-decoders like t5 prefill the DECODER from a start "
                "token — the encoder pass has no incremental KV to chunk)"
            )
        if svc_cfg.prompt_prefix:
            raise ValueError(
                "PREFILL_CHUNK and PROMPT_PREFIX are mutually exclusive: "
                "the global prefix overlay seeds positions 0..P inside "
                "init_decode_state, which chunked prefill bypasses — use "
                "PREFIX_CACHE=1, whose hits suffix-prefill in chunks"
            )
        if svc_cfg.spec_continuous:
            raise ValueError(
                "PREFILL_CHUNK does not compose with SPEC_CONTINUOUS "
                "(the spec slot insert rebuilds the drafting history from "
                "a monolithic collated prompt; planned follow-up)"
            )
        if svc_cfg.paged_kv and svc_cfg.prefill_chunk % svc_cfg.kv_block_size:
            raise ValueError(
                f"PREFILL_CHUNK={svc_cfg.prefill_chunk} must be a "
                f"multiple of KV_BLOCK_SIZE={svc_cfg.kv_block_size} so every window "
                "boundary is block-aligned (per-chunk block growth "
                "stays exact)"
            )
    if svc_cfg.prefix_cache:
        if not bundle.supports_prefix:
            raise ValueError(
                f"PREFIX_CACHE is not supported for {svc_cfg.model_name!r} "
                "(per-request prefix caching covers the decoder "
                "families: gpt2, llama)"
            )
        if svc_cfg.prompt_prefix:
            raise ValueError(
                "PREFIX_CACHE and PROMPT_PREFIX are mutually exclusive: "
                "the global prefix occupies positions 0..P that "
                "per-request prefixes need (the cache generalizes the "
                "global knob — drop PROMPT_PREFIX)"
            )
    return bundle
