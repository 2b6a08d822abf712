"""Checkpoint IO: an HF state dict from disk as ``{name: numpy array}``.

Formats: ``*.safetensors`` (``safetensors`` imported only when used),
``*.npz`` and torch's ``*.bin`` / ``*.pt`` / ``*.pth``.
"""

from __future__ import annotations

import numpy as np
import torch


def load_state_dict(path: str) -> dict[str, np.ndarray]:
    if path.endswith(".safetensors"):
        from safetensors.numpy import load_file

        return load_file(path)
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    if path.endswith((".bin", ".pt", ".pth")):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        return {k: v.float().numpy() for k, v in sd.items()}
    raise ValueError(f"unrecognized checkpoint format: {path}")
