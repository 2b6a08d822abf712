"""Tokenizers for the text models: pure Python, no external assets.

Copies of the JAX package's ``ByteTokenizer``, ``WordPieceTokenizer`` and
``ByteLevelBPETokenizer`` and of its ``build_tokenizer``, which routes
SentencePiece files (``.model``, ``.tsv``, ``.vocab``) to
``sentencepiece.load_sentencepiece``:

- ``WordPieceTokenizer``: BERT-style WordPiece (basic tokenize, then greedy
  longest-match subwords) over a standard ``vocab.txt``
  (``TOKENIZER_PATH``).
- ``ByteTokenizer``: byte-level fallback needing no assets; ids = byte +
  offset, specials laid out inside BERT's 30522-id vocab.
- ``ByteLevelBPETokenizer``: GPT-2's byte-level BPE over ``vocab.json`` and
  ``merges.txt``.  GPT-2's split pattern needs Unicode letter and number
  classes; the JAX package compiles it with the third-party ``regex``
  module, the port scans it with the standard library (``gpt2_pretokenize``).

Both expose ``encode(text, max_len) -> (ids, mask)`` and
``decode(ids) -> text``.
"""

from __future__ import annotations

import functools
import json
import os
import unicodedata

import numpy as np


class ByteTokenizer:
    """Byte-level tokenizer: token = byte value + offset. No assets.

    Layout (T5-compatible specials): pad=0, eos=1, unk=2, cls=3, sep=4,
    bytes at 5..260.
    """

    pad_id = 0
    eos_id = 1
    unk_id = 2
    cls_id = 3
    sep_id = 4
    _byte_offset = 5

    def __init__(self, add_cls_sep: bool = False, add_eos: bool = False):
        self.add_cls_sep = add_cls_sep
        self.add_eos = add_eos

    @property
    def vocab_size(self) -> int:
        return self._byte_offset + 256

    def encode(self, text: str, max_len: int) -> tuple[np.ndarray, np.ndarray]:
        raw = list(text.encode("utf-8"))
        specials = (2 if self.add_cls_sep else 0) + (1 if self.add_eos else 0)
        raw = raw[: max_len - specials]
        ids = [b + self._byte_offset for b in raw]
        if self.add_cls_sep:
            ids = [self.cls_id] + ids + [self.sep_id]
        if self.add_eos:
            ids = ids + [self.eos_id]
        n = len(ids)
        out = np.full((max_len,), self.pad_id, np.int32)
        out[:n] = ids
        mask = np.zeros((max_len,), np.int32)
        mask[:n] = 1
        return out, mask

    def decode(self, ids) -> str:
        bs = bytearray()
        for i in ids:
            i = int(i)
            if i == self.eos_id:
                break
            # Ids past the byte range (a model's vocab may exceed the
            # tokenizer's) decode to nothing rather than crashing.
            if self._byte_offset <= i < self._byte_offset + 256:
                bs.append(i - self._byte_offset)
        return bs.decode("utf-8", errors="replace")


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


class WordPieceTokenizer:
    """BERT-style WordPiece over a standard ``vocab.txt`` file."""

    def __init__(self, vocab_path: str, lowercase: bool = True, max_chars_per_word: int = 100):
        with open(vocab_path, encoding="utf-8") as f:
            tokens = [line.rstrip("\n") for line in f]
        self.vocab = {t: i for i, t in enumerate(tokens)}
        self.inv_vocab = tokens
        self.lowercase = lowercase
        self.max_chars_per_word = max_chars_per_word
        self.pad_id = self.vocab.get("[PAD]", 0)
        self.unk_id = self.vocab.get("[UNK]", 100)
        self.cls_id = self.vocab.get("[CLS]", 101)
        self.sep_id = self.vocab.get("[SEP]", 102)
        self.eos_id = self.sep_id

    @property
    def vocab_size(self) -> int:
        return len(self.inv_vocab)

    def _basic_tokenize(self, text: str) -> list[str]:
        text = unicodedata.normalize("NFC", text)
        if self.lowercase:
            text = text.lower()
            text = "".join(
                c for c in unicodedata.normalize("NFD", text)
                if unicodedata.category(c) != "Mn"
            )
        out: list[str] = []
        word = []
        for ch in text:
            if ch.isspace():
                if word:
                    out.append("".join(word))
                    word = []
            elif _is_punct(ch):
                if word:
                    out.append("".join(word))
                    word = []
                out.append(ch)
            else:
                word.append(ch)
        if word:
            out.append("".join(word))
        return out

    def _wordpiece(self, word: str) -> list[int]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_id]
        ids: list[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    def encode(self, text: str, max_len: int) -> tuple[np.ndarray, np.ndarray]:
        ids: list[int] = [self.cls_id]
        for w in self._basic_tokenize(text):
            ids.extend(self._wordpiece(w))
            if len(ids) >= max_len - 1:
                break
        ids = ids[: max_len - 1] + [self.sep_id]
        n = len(ids)
        out = np.full((max_len,), self.pad_id, np.int32)
        out[:n] = ids
        mask = np.zeros((max_len,), np.int32)
        mask[:n] = 1
        return out, mask

    # Spacing heuristics for detokenization (WordPiece has no offsets,
    # so original whitespace is unrecoverable; these render natural
    # text instead of "don ' t"-style surfaces).
    _GLUE_BOTH = set("'’-/")  # joins to neighbors on both sides
    _NO_SPACE_BEFORE = set(".,!?;:%)]}\"") | _GLUE_BOTH
    _NO_SPACE_AFTER = set("([{$#'’")

    def decode(self, ids) -> str:
        toks = []
        for i in ids:
            i = int(i)
            if i in (self.pad_id, self.cls_id):
                continue
            if i == self.sep_id:
                break
            t = self.inv_vocab[i] if 0 <= i < len(self.inv_vocab) else "[UNK]"
            if t.startswith("##") and toks:
                toks[-1] += t[2:]
            else:
                toks.append(t)
        text = ""
        glue = True  # no leading space
        for t in toks:
            if glue or (len(t) == 1 and t in self._NO_SPACE_BEFORE):
                text += t
            else:
                text += " " + t
            glue = len(t) == 1 and (t in self._GLUE_BOTH or t in self._NO_SPACE_AFTER)
        return text


# ---------------------------------------------------------------------------
# GPT-2 byte-level BPE


@functools.lru_cache(maxsize=1)
def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte -> printable-unicode table: printable latin
    bytes map to themselves, the rest to 256 + n."""
    bs = list(range(33, 127)) + list(range(161, 173)) + list(range(174, 256))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _is_space(ch: str) -> bool:
    """``\\s`` of GPT-2's pattern: Python's whitespace less the information
    separators U+001C-U+001F, which the pattern's regex engine does not
    count as space."""
    return ch.isspace() and not "\x1c" <= ch <= "\x1f"


def _cls(ch: str) -> str:
    """'L' (letter), 'N' (number), 'S' (whitespace) or 'P' (anything else)."""
    if _is_space(ch):
        return "S"
    cat = unicodedata.category(ch)[0]
    return cat if cat in "LN" else "P"


def gpt2_pretokenize(text: str) -> list[str]:
    """GPT-2's pre-tokenizer, ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+|
    ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+`` read left to right,
    with the standard library's Unicode categories ('L*' letters, 'N*'
    numbers)."""
    out = []
    i, n = 0, len(text)
    classes = [_cls(ch) for ch in text]

    def run(j: int, c: str) -> int:
        while j < n and classes[j] == c:
            j += 1
        return j

    while i < n:
        if text[i] == "'":
            hit = next((c for c in _CONTRACTIONS if text.startswith(c, i)), None)
            if hit is not None:
                out.append(hit)
                i += len(hit)
                continue
        # ' ?X+' for X in letters, numbers, other: an optional leading space
        # (U+0020 only) joins the run that follows it.
        start = i + 1 if text[i] == " " and i + 1 < n and classes[i + 1] != "S" else i
        c = classes[start]
        if c != "S":
            j = run(start, c)
            out.append(text[i:j])
            i = j
            continue
        # Whitespace: the run less its last character when a non-space
        # follows it (that character then leads the next piece), else all.
        j = run(i, "S")
        if j < n and j - i > 1:
            j -= 1
        out.append(text[i:j])
        i = j
    return out


class ByteLevelBPETokenizer:
    """GPT-2 style byte-level BPE over ``vocab.json`` + ``merges.txt``
    (beside it unless given)."""

    def __init__(self, vocab_path: str, merges_path: str | None = None):
        if merges_path is None:
            merges_path = os.path.join(os.path.dirname(vocab_path), "merges.txt")
        with open(vocab_path, encoding="utf-8") as f:
            self.vocab: dict[str, int] = json.load(f)
        self.inv_vocab = {i: t for t, i in self.vocab.items()}
        with open(merges_path, encoding="utf-8") as f:
            lines = [ln.rstrip("\n") for ln in f]
        # Only the first line is a header ("#version: ..."); a real merge may
        # start with '#' (the "# #" merge that builds "##").
        if lines and lines[0].startswith("#version"):
            lines = lines[1:]
        merges = [tuple(ln.split()) for ln in lines if ln]
        self.ranks = {pair: i for i, pair in enumerate(m for m in merges if len(m) == 2)}
        self.byte_enc = _bytes_to_unicode()
        self.byte_dec = {c: b for b, c in self.byte_enc.items()}
        self.eos_id = self.vocab.get("<|endoftext|>", len(self.vocab) - 1)
        self.pad_id = self.eos_id  # GPT-2 has no pad token
        self._cache: dict[str, tuple[str, ...]] = {}

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    @property
    def max_token_id(self) -> int:
        """The largest id this tokenizer can emit (a sparse vocab.json may
        hold ids past its length): what embedding-table checks compare."""
        return max(self.vocab.values()) if self.vocab else 0

    def _bpe(self, token: str) -> tuple[str, ...]:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        if len(self._cache) >= 65536:  # bounded under high-cardinality traffic
            self._cache.clear()
        word = tuple(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.ranks.get(p, 1 << 60))
            if best not in self.ranks:
                break
            a, b = best
            merged: list[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    merged.append(a + b)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        self._cache[token] = word
        return word

    def encode(self, text: str, max_len: int) -> tuple[np.ndarray, np.ndarray]:
        ids: list[int] = []
        for tok in gpt2_pretokenize(text):
            mapped = "".join(self.byte_enc[b] for b in tok.encode("utf-8"))
            for piece in self._bpe(mapped):
                piece_id = self.vocab.get(piece)
                if piece_id is None:
                    # Only a truncated vocab lacks a byte; skip it rather
                    # than cut the prompt with an eos (GPT-2 has no unk).
                    continue
                ids.append(piece_id)
                if len(ids) >= max_len:
                    break
            if len(ids) >= max_len:
                break
        n = len(ids)
        out = np.full((max_len,), self.pad_id, np.int32)
        out[:n] = ids
        mask = np.zeros((max_len,), np.int32)
        mask[:n] = 1
        return out, mask

    def decode(self, ids) -> str:
        chars: list[str] = []
        for i in ids:
            i = int(i)
            if i == self.eos_id:
                break
            tok = self.inv_vocab.get(i)
            if tok is not None:
                chars.append(tok)
        data = bytes(self.byte_dec.get(c, 32) for c in "".join(chars))
        return data.decode("utf-8", errors="replace")


def build_tokenizer(tokenizer_path: str | None, for_t5: bool = False):
    """By ``tokenizer_path``: a SentencePiece ``spiece.model`` / ``.tsv`` /
    ``.vocab`` -> ``SentencePieceTokenizer`` (a trailing EOS with
    ``for_t5``), a GPT-2 ``vocab.json`` (with ``merges.txt`` beside it) ->
    byte-level BPE, any other file -> WordPiece (a BERT ``vocab.txt``);
    unset -> the byte-level tokenizer: with [CLS]/[SEP] for the
    classifiers, with a trailing EOS and no [CLS]/[SEP] for the generative
    models (``for_t5``, the JAX package's name for that fallback)."""
    if tokenizer_path and tokenizer_path.endswith((".model", ".tsv", ".vocab")):
        from .sentencepiece import load_sentencepiece

        return load_sentencepiece(tokenizer_path, add_eos=for_t5)
    if tokenizer_path and tokenizer_path.endswith(".json"):
        return ByteLevelBPETokenizer(tokenizer_path)
    if tokenizer_path:
        return WordPieceTokenizer(tokenizer_path)
    return ByteTokenizer(add_cls_sep=not for_t5, add_eos=for_t5)
