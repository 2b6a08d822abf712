"""Pre- and post-processing: host-side image decode and label helpers
(numpy in/out), and the ImageNet normalization that runs on the device.

The image half of the JAX package's ``models/preprocess.py``: decode and
resize on the host give uint8, which crosses to the device at a quarter
of f32's bytes, and the mean/std affine runs there.
"""

from __future__ import annotations

import io

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def decode_image_u8(data: bytes, image_size: int = 224) -> np.ndarray:
    """JPEG/PNG bytes -> [H, W, 3] uint8: PIL's bilinear resize of the
    shortest side to ``round(image_size * 256 / 224)``, then a centre crop,
    byte for byte the JAX package's.  PIL is needed only here."""
    from PIL import Image

    img = Image.open(io.BytesIO(data)).convert("RGB")
    w, h = img.size
    short = int(round(image_size * 256 / 224))
    if w < h:
        nw, nh = short, max(1, int(round(h * short / w)))
    else:
        nw, nh = max(1, int(round(w * short / h))), short
    img = img.resize((nw, nh), Image.BILINEAR)
    left = (nw - image_size) // 2
    top = (nh - image_size) // 2
    img = img.crop((left, top, left + image_size, top + image_size))
    return np.asarray(img, np.uint8)


def normalize_imagenet(x: torch.Tensor, mean: torch.Tensor | None = None,
                       std: torch.Tensor | None = None) -> torch.Tensor:
    """uint8 [..., 3] -> f32 ``(x / 255 - mean) / std`` on x's device.
    ``mean``/``std``: ``IMAGENET_MEAN``/``IMAGENET_STD`` already on that
    device (else copied there, a host-synchronous copy on the card)."""
    if mean is None or std is None:
        mean = torch.from_numpy(IMAGENET_MEAN).to(x.device)
        std = torch.from_numpy(IMAGENET_STD).to(x.device)
    return (x.float() / 255.0 - mean) / std


def softmax_np(logits: np.ndarray) -> np.ndarray:
    z = logits - logits.max(axis=-1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=-1, keepdims=True)


def topk_np(logits: np.ndarray, k: int = 5) -> tuple[np.ndarray, np.ndarray]:
    """Per-row top-k (indices, probabilities), sorted descending."""
    probs = softmax_np(logits.astype(np.float32))
    idx = np.argpartition(-probs, kth=min(k, probs.shape[-1] - 1), axis=-1)[..., :k]
    vals = np.take_along_axis(probs, idx, axis=-1)
    order = np.argsort(-vals, axis=-1)
    return np.take_along_axis(idx, order, axis=-1), np.take_along_axis(vals, order, axis=-1)


def load_labels(path: str | None) -> list[str] | None:
    """Optional label file: one class name per line (LABELS_PATH)."""
    if not path:
        return None
    with open(path, encoding="utf-8") as f:
        return [line.rstrip("\n") for line in f]
