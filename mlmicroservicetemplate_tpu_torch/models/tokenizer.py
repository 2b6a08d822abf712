"""Tokenizers for the text models: pure Python, no external assets.

Copies of the JAX package's ``ByteTokenizer`` and ``WordPieceTokenizer``
and of ``build_tokenizer``'s WordPiece and byte-fallback branches
(SentencePiece and byte-level BPE files raise "not ported yet"):

- ``WordPieceTokenizer``: BERT-style WordPiece (basic tokenize, then greedy
  longest-match subwords) over a standard ``vocab.txt``
  (``TOKENIZER_PATH``).
- ``ByteTokenizer``: byte-level fallback needing no assets; ids = byte +
  offset, specials laid out inside BERT's 30522-id vocab.

Both expose ``encode(text, max_len) -> (ids, mask)`` and
``decode(ids) -> text``.
"""

from __future__ import annotations

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


def build_tokenizer(tokenizer_path: str | None, for_t5: bool = False):
    """WordPiece over ``tokenizer_path`` (a BERT ``vocab.txt``) when given,
    else the byte-level tokenizer: with [CLS]/[SEP] for the classifiers,
    with a trailing EOS and no [CLS]/[SEP] for the generative models
    (``for_t5``, the JAX package's name for that fallback)."""
    if tokenizer_path and tokenizer_path.endswith((".model", ".tsv", ".vocab", ".json")):
        raise ValueError(
            f"TOKENIZER_PATH={tokenizer_path!r}: SentencePiece and byte-level BPE "
            "vocabularies are not ported yet (WordPiece vocab.txt only)"
        )
    if tokenizer_path:
        return WordPieceTokenizer(tokenizer_path)
    return ByteTokenizer(add_cls_sep=not for_t5, add_eos=for_t5)
