"""Checkpoint IO: an HF state dict from disk as ``{name: numpy array}``, and
the port's own converted checkpoint.

- ``load_state_dict``: ``*.safetensors`` (``safetensors`` imported only when
  used), ``*.npz`` and torch's ``*.bin`` / ``*.pt`` / ``*.pth``.
- ``save_checkpoint`` / ``load_checkpoint``: what the converter CLI
  (``python -m mlmicroservicetemplate_tpu_torch.convert``) writes and
  ``MODEL_PATH`` loads with no HF mapping: a directory holding the model's
  parameters under the port modules' state-dict names in ``params.npz``
  (numpy only, so it loads wherever the port runs) and
  ``port_checkpoint.json`` naming the model and its layer count.  The JAX
  package writes an orbax directory instead; the port does not read those.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

CHECKPOINT_META = "port_checkpoint.json"
PARAMS_FILE = "params.npz"
FORMAT = 1


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


def is_checkpoint_dir(path: str) -> bool:
    """Whether ``path`` is a directory the converter CLI wrote."""
    return os.path.isdir(path) and os.path.isfile(os.path.join(path, CHECKPOINT_META))


def save_checkpoint(path: str, model: str, num_layers: int | None,
                    state: dict[str, torch.Tensor | np.ndarray]) -> None:
    """Write ``state`` (the port's parameter names; tensors or arrays) and the
    metadata into the directory ``path``; the metadata goes last, by an
    atomic rename, so a half-written directory is never taken for a
    checkpoint."""
    os.makedirs(path, exist_ok=True)
    meta_path = os.path.join(path, CHECKPOINT_META)
    if os.path.exists(meta_path):
        os.remove(meta_path)
    arrays = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
              for k, v in state.items()}
    with open(os.path.join(path, PARAMS_FILE), "wb") as f:
        np.savez(f, **arrays)
    meta = {"format": FORMAT, "model": model, "num_layers": num_layers,
            "params": PARAMS_FILE}
    tmp = f"{meta_path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, meta_path)


def load_checkpoint(path: str, model: str, num_layers: int | None) -> dict[str, torch.Tensor]:
    """The parameters of the converted checkpoint at ``path``, CPU tensors
    by the port's names; ValueError when it holds another model or another
    layer count than the one being built."""
    with open(os.path.join(path, CHECKPOINT_META)) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(f"{path}: checkpoint format {meta.get('format')!r}, expected {FORMAT}")
    if meta.get("model") != model:
        raise ValueError(f"MODEL_PATH={path!r} holds a {meta.get('model')!r} checkpoint; "
                         f"MODEL_NAME is {model!r}")
    if num_layers is not None and meta.get("num_layers") not in (None, num_layers):
        raise ValueError(f"MODEL_PATH={path!r} holds {meta['num_layers']} layers; the "
                         f"{model} being built has {num_layers}")
    with np.load(os.path.join(path, meta.get("params", PARAMS_FILE))) as z:
        return {k: torch.from_numpy(np.array(z[k])) for k in z.files}
