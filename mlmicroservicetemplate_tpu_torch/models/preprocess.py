"""Host-side post-processing of the text path (numpy in/out)."""

from __future__ import annotations

import numpy as np


def softmax_np(logits: np.ndarray) -> np.ndarray:
    z = logits - logits.max(axis=-1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=-1, keepdims=True)


def load_labels(path: str | None) -> list[str] | None:
    """Optional label file: one class name per line (LABELS_PATH)."""
    if not path:
        return None
    with open(path, encoding="utf-8") as f:
        return [line.rstrip("\n") for line in f]
