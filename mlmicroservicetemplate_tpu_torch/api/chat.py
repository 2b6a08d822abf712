"""Chat templates: OpenAI ``messages`` lists -> one prompt string.

A copy of the JAX package's ``api/chat.py`` (pure Python).  A chat-tuned
checkpoint only behaves when prompted in the exact format it was tuned
on, and a wrong template degrades output silently, so beside the
renderers this module carries a startup-time validator that probes the
model's own tokenizer for each template's special markers and warns when
the vocabulary does not know them.

Templates:

- ``plain``: neutral ``role: content`` lines, for base (not chat-tuned)
  checkpoints.
- ``llama2``: ``[INST] <<SYS>> ... [/INST]`` (Llama-2-chat).
- ``chatml``: ``<|im_start|>role ... <|im_end|>`` (Qwen and others).
- ``zephyr``: ``<|system|>/<|user|>/<|assistant|>`` with ``</s>`` turn
  terminators (Zephyr, TinyLlama-1.1B-Chat).
- ``llama3``: ``<|start_header_id|>role<|end_header_id|>`` /
  ``<|eot_id|>`` (Llama-3-Instruct); the leading ``<|begin_of_text|>`` is
  left to the tokenizer's BOS.
"""

from __future__ import annotations

import logging

log = logging.getLogger(__name__)

ROLES = ("system", "user", "assistant")


def _check_messages(messages) -> None:
    if not isinstance(messages, list) or not messages:
        raise ValueError('"messages" must be a non-empty list')
    for m in messages:
        if (
            not isinstance(m, dict)
            or m.get("role") not in ROLES
            or not isinstance(m.get("content"), str)
        ):
            raise ValueError(
                'each message needs role in {system,user,assistant} and '
                'string "content"'
            )


def _render_plain(messages: list[dict]) -> str:
    lines = [f"{m['role']}: {m['content']}" for m in messages]
    lines.append("assistant:")
    return "\n".join(lines)


def _render_llama2(messages: list[dict]) -> str:
    if not any(m["role"] == "user" for m in messages):
        # The [INST] format has no rendering for a conversation with
        # no instruction — an empty "[INST]  [/INST]" is garbage.
        raise ValueError("llama2 template requires at least one user message")
    system = "".join(m["content"] for m in messages if m["role"] == "system")
    turns = [m for m in messages if m["role"] != "system"]
    out = []
    pending: list[str] = []  # consecutive user messages accumulate
    first_inst = True

    def inst(user_text: str) -> str:
        nonlocal first_inst
        sys_block = (
            f"<<SYS>>\n{system}\n<</SYS>>\n\n" if system and first_inst else ""
        )
        first_inst = False
        return f"[INST] {sys_block}{user_text} [/INST]"

    for m in turns:
        if m["role"] == "user":
            pending.append(m["content"])
        elif pending:  # assistant turn closes the pair
            out.append(f"{inst(chr(10).join(pending))} {m['content']}")
            pending = []
        else:
            # Assistant content with no preceding instruction
            # (assistant-first transcript): continue it as-is.
            out.append(m["content"])
    if pending:
        out.append(inst(chr(10).join(pending)))
    return " ".join(out)


def _render_chatml(messages: list[dict]) -> str:
    out = [f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n" for m in messages]
    out.append("<|im_start|>assistant\n")
    return "".join(out)


def _render_zephyr(messages: list[dict]) -> str:
    # TinyLlama-1.1B-Chat / HF Zephyr format: role tag on its own line,
    # content, </s> terminator; generation cued by a bare <|assistant|>.
    out = [f"<|{m['role']}|>\n{m['content']}</s>\n" for m in messages]
    out.append("<|assistant|>\n")
    return "".join(out)


def _render_llama3(messages: list[dict]) -> str:
    out = [
        f"<|start_header_id|>{m['role']}<|end_header_id|>\n\n{m['content']}<|eot_id|>"
        for m in messages
    ]
    out.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
    return "".join(out)


TEMPLATES = {
    "plain": _render_plain,
    "llama2": _render_llama2,
    "chatml": _render_chatml,
    "zephyr": _render_zephyr,
    "llama3": _render_llama3,
}

# The marker strings a chat-tuned checkpoint's tokenizer must know as
# (near-)atomic special tokens for the template to be the one it was
# tuned on.  ``plain`` has none — it is safe for any vocabulary.
_MARKERS = {
    "plain": (),
    "llama2": ("[INST]", "[/INST]"),
    "chatml": ("<|im_start|>", "<|im_end|>"),
    # "</s>" is NOT probed for zephyr: eos is a control token that
    # never encodes from literal text (the SP loader excludes TYPE_
    # CONTROL pieces from the encodable vocab), so probing it could
    # only false-positive on correctly-paired checkpoints.
    "zephyr": ("<|system|>", "<|user|>", "<|assistant|>"),
    "llama3": ("<|start_header_id|>", "<|end_header_id|>", "<|eot_id|>"),
}


def render_chat(messages: list[dict], template: str) -> str:
    """Render a validated message list; ValueError on malformed
    messages (handlers map it to 400), LookupError on an unknown
    template name (server misconfiguration → 500; ``build_app``
    rejects it at startup so this should never fire in serving)."""
    fn = TEMPLATES.get(template)
    if fn is None:
        raise LookupError(
            f"unknown CHAT_TEMPLATE {template!r} ({'|'.join(TEMPLATES)})"
        )
    _check_messages(messages)
    return fn(messages)


def validate_chat_template(template: str, tokenizer) -> list[str]:
    """Probe the serving tokenizer for the template's special markers;
    returns human-readable warnings (empty = no mismatch detected).

    A marker that the vocabulary knows encodes to very few ids
    (1 for a registered special, ≤3 with SP word-boundary prefixes);
    one the checkpoint was never tuned on shatters into per-byte /
    per-character pieces.  The threshold is deliberately lenient — this
    is a mismatch DETECTOR, not a gate: serving proceeds, the operator
    gets a loud startup log line and a ``/status`` field.
    """
    warnings: list[str] = []
    if tokenizer is None:
        return warnings
    for marker in _MARKERS.get(template, ()):
        try:
            ids, mask = tokenizer.encode(marker, 64)
            n = int(mask.sum())
            # Terminal specials (eos/sep) appended by the tokenizer
            # inflate the count by ~1-2; allow them on top of the
            # "atomic or nearly so" budget of 3.
            if n > 5:
                warnings.append(
                    f"CHAT_TEMPLATE={template}: marker {marker!r} splits into "
                    f"{n} tokens — this checkpoint's vocabulary does not know "
                    f"it as a special token, so the model was likely not "
                    f"tuned on the {template} format (output quality will "
                    f"silently degrade; pick the template the checkpoint was "
                    f"trained with)"
                )
        except Exception as e:  # pragma: no cover - defensive
            log.debug("template probe failed on %r: %s", marker, e)
    return warnings
