"""Adapter pool: N LoRA adapters paged through S stacked device slots.

Counterpart of the JAX package's ``tenancy/adapters.py``.  Host copies
(loaded once from ``ADAPTER_DIR``) are the source of truth; a fixed number
of device slots serve live traffic, and a cold slot is demoted by simple
overwrite (the host copy never leaves RAM).

- **Loading**: ``ADAPTER_DIR/*.npz`` (and ``*.safetensors`` when that
  library is importable; never a hard dependency), one file per adapter,
  id = file stem.  Keys ``layers.{li}.{proj}.lora_a`` ``[d_in, r]`` and
  ``.lora_b`` ``[r, d_out]`` per layer and projection, an optional scalar
  ``alpha`` (the scale alpha / r is folded into B at load).  Ranks may
  differ per adapter; the stacks are zero-padded to the largest (exact:
  padded rank columns contribute nothing).
- **Slots**: ``ADAPTER_SLOTS`` device slots plus the all-zero slot 0
  (rows without an adapter).  ``acquire`` refcounts a resident slot or
  installs into a free or the coldest idle one; every slot held by a live
  stream raises :class:`AdapterBusy` (a retryable shed).  The stacks are
  allocated once, at fixed addresses, and an install copies into its slot
  in place, so a CUDA graph captured over them replays every later install
  and nothing is captured anew (the reference's "never recompile").  An
  install runs under the device's dispatch lock, so no copy lands inside
  another thread's capture.
- **Overlay**: ``overlay(rows)`` is the ``models/lora.py`` overlay of the
  stacks and a per-row slot vector (the caller's device buffer).
"""

from __future__ import annotations

import contextlib
import os
import threading

import numpy as np
import torch

from ..models.lora import Overlay
from ..utils import metrics


class AdapterBusy(Exception):
    """Every adapter slot is refcounted by a live stream: shed the request
    (503, retryable) instead of blocking the decode loop."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


def _load_file(path: str) -> dict[str, np.ndarray]:
    """Flat name -> array dict of one adapter file."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: np.asarray(z[k]) for k in z.files}
    if path.endswith(".safetensors"):
        try:
            from safetensors.numpy import load_file
        except Exception:
            raise ValueError(
                f"{path}: safetensors not importable in this runtime; "
                "convert the adapter to .npz"
            ) from None
        return dict(load_file(path))
    raise ValueError(f"{path}: unsupported adapter format")


def _parse_adapter(name: str, raw: dict[str, np.ndarray]) -> dict:
    """``{proj: (A [L, d_in, r], B [L, r, d_out])}`` (scale folded into B)
    from the flat key convention; strict: a malformed adapter file fails
    the boot, not a request."""
    alpha = float(raw["alpha"]) if "alpha" in raw else 0.0
    layers: dict[str, dict[int, list]] = {}
    n_layers = -1
    for key, arr in raw.items():
        if key in ("alpha", "r"):
            continue
        parts = key.split(".")
        if (len(parts) != 4 or parts[0] != "layers"
                or parts[3] not in ("lora_a", "lora_b")):
            raise ValueError(
                f"adapter {name!r}: unexpected key {key!r} (want "
                "layers.<li>.<proj>.lora_a|lora_b)"
            )
        li, proj = int(parts[1]), parts[2]
        slot = layers.setdefault(proj, {}).setdefault(li, [None, None])
        slot[0 if parts[3] == "lora_a" else 1] = np.asarray(arr, np.float32)
        n_layers = max(n_layers, li + 1)
    if not layers:
        raise ValueError(f"adapter {name!r}: no layers.* keys")
    out = {}
    for proj, per_layer in layers.items():
        a_rows, b_rows = [], []
        for li in range(n_layers):
            ent = per_layer.get(li)
            if ent is None or ent[0] is None or ent[1] is None:
                raise ValueError(
                    f"adapter {name!r}: projection {proj!r} missing "
                    f"lora_a/lora_b at layer {li}"
                )
            a, b = ent
            if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
                raise ValueError(
                    f"adapter {name!r}: {proj!r} layer {li} rank "
                    f"mismatch ({a.shape} vs {b.shape})"
                )
            r = a.shape[1]
            scale = (alpha / r) if alpha else 1.0
            a_rows.append(a)
            b_rows.append(b * np.float32(scale))
        out[proj] = (np.stack(a_rows), np.stack(b_rows))
    return out


def load_adapter_dir(path: str) -> dict[str, dict]:
    """Every adapter under ``path`` (sorted, so ids are deterministic); an
    empty or missing directory raises: a configured ADAPTER_DIR with
    nothing to serve is a deployment mistake."""
    if not os.path.isdir(path):
        raise ValueError(f"ADAPTER_DIR {path!r} is not a directory")
    names = sorted(f for f in os.listdir(path) if f.endswith((".npz", ".safetensors")))
    if not names:
        raise ValueError(f"ADAPTER_DIR {path!r} holds no .npz/.safetensors")
    out = {}
    for fname in names:
        aid = fname.rsplit(".", 1)[0]
        out[aid] = _parse_adapter(aid, _load_file(os.path.join(path, fname)))
    return out


class AdapterPool:
    """Refcounted device-slot pool over host-resident LoRA adapters, one per
    engine.  Thread-safe: streams acquire at submit (the event loop) and the
    decode loop releases at their end."""

    def __init__(self, host: dict[str, dict], slots: int = 8, model: str = "",
                 device: torch.device | str = "cpu", device_lock=None):
        if not host:
            raise ValueError("AdapterPool needs at least one adapter")
        self.model = model
        self.host = dict(host)
        self.n_slots = max(1, int(slots))
        self.device = torch.device(device)
        self._device_lock = device_lock
        first = next(iter(host.values()))
        self.projections = tuple(sorted(first))
        self.num_layers = first[self.projections[0]][0].shape[0]
        self.rank = 0
        for ad in host.values():
            if tuple(sorted(ad)) != self.projections:
                raise ValueError(
                    "adapters disagree on projection set "
                    f"({tuple(sorted(ad))} vs {self.projections})"
                )
            for proj, (a, _b) in ad.items():
                if a.shape[0] != self.num_layers:
                    raise ValueError(f"adapters disagree on layer count for {proj!r}")
                self.rank = max(self.rank, a.shape[2])
        self._lock = threading.Lock()
        # slot (1-based; 0 is the permanent zero adapter) -> adapter id,
        # refcount, last-use tick.
        self._slot_of: dict[str, int] = {}
        self._aid_at: dict[int, str] = {}
        self._refs: dict[int, int] = {}
        self._tick = 0
        self._lru: dict[int, int] = {}
        self.installs = 0
        self.demotions = 0
        self._stacks: dict[str, tuple[torch.Tensor, torch.Tensor]] = {}
        self._build_stacks()
        self._note_gauges()

    # -- construction -------------------------------------------------------

    @classmethod
    def from_cfg(cls, cfg, model: str = "", device: torch.device | str = "cpu",
                 device_lock=None):
        """The pool of ``ADAPTER_DIR``/``ADAPTER_SLOTS``, or None when the
        knob is unset."""
        path = getattr(cfg, "adapter_dir", None)
        if not path:
            return None
        return cls(load_adapter_dir(path), slots=int(getattr(cfg, "adapter_slots", 8) or 8),
                   model=model, device=device, device_lock=device_lock)

    def _build_stacks(self) -> None:
        """``[S, L, d_in, r]`` / ``[S, L, r, d_out]`` f32 zeros per
        projection, ``S`` = slots + the zero slot, allocated once."""
        s = self.n_slots + 1
        ref = next(iter(self.host.values()))
        for proj in self.projections:
            a, b = ref[proj]
            d_in, d_out = a.shape[1], b.shape[2]
            self._stacks[proj] = (
                torch.zeros((s, self.num_layers, d_in, self.rank), device=self.device),
                torch.zeros((s, self.num_layers, self.rank, d_out), device=self.device))

    def _padded(self, arr: np.ndarray, axis: int) -> torch.Tensor:
        """The rank axis zero-padded to the pool's rank (exact: the padded
        factor columns multiply to nothing)."""
        if arr.shape[axis] != self.rank:
            pad = [(0, 0)] * arr.ndim
            pad[axis] = (0, self.rank - arr.shape[axis])
            arr = np.pad(arr, pad)
        return torch.from_numpy(np.ascontiguousarray(arr, np.float32))

    def _device_locked(self):
        return self._device_lock if self._device_lock is not None else contextlib.nullcontext()

    def _write_slot(self, slot: int, factors: dict) -> None:
        """Copy each projection's ``(A, B)`` into ``slot`` of its stacks, in
        place (the stacks keep their addresses)."""
        with self._device_locked(), torch.inference_mode():
            for proj, (a, b) in factors.items():
                sa, sb = self._stacks[proj]
                sa[slot].copy_(a)
                sb[slot].copy_(b)

    def _install_locked(self, aid: str, slot: int) -> None:
        old = self._aid_at.pop(slot, None)
        if old is not None:
            self._slot_of.pop(old, None)
            self.demotions += 1
        self._write_slot(slot, {proj: (self._padded(a, 2), self._padded(b, 1))
                                for proj, (a, b) in self.host[aid].items()})
        self._slot_of[aid] = slot
        self._aid_at[slot] = aid
        self.installs += 1

    def warm(self) -> None:
        """Run the install path once by rewriting slot 0's zero delta (a
        no-op in value), so a serving install meets nothing new."""
        with self._lock:
            self._write_slot(0, {proj: (torch.zeros(sa.shape[1:]), torch.zeros(sb.shape[1:]))
                                 for proj, (sa, sb) in self._stacks.items()})

    # -- serving ------------------------------------------------------------

    def known(self, aid: str) -> bool:
        return aid in self.host

    def ids(self) -> list[str]:
        return sorted(self.host)

    def acquire(self, aid: str) -> int:
        """The slot serving ``aid``, one reference taken; installs into a
        free or the coldest idle slot when it is not resident."""
        if aid not in self.host:
            raise KeyError(f"unknown adapter {aid!r}")
        with self._lock:
            self._tick += 1
            slot = self._slot_of.get(aid)
            if slot is None:
                slot = self._find_slot_locked()
                if slot is None:
                    raise AdapterBusy(
                        f"all {self.n_slots} adapter slots are serving live streams")
                self._install_locked(aid, slot)
            self._refs[slot] = self._refs.get(slot, 0) + 1
            self._lru[slot] = self._tick
        self._note_gauges()
        return slot

    def _find_slot_locked(self) -> int | None:
        for slot in range(1, self.n_slots + 1):
            if slot not in self._aid_at:
                return slot
        idle = [s for s in range(1, self.n_slots + 1) if not self._refs.get(s)]
        if not idle:
            return None
        return min(idle, key=lambda s: self._lru.get(s, 0))

    def release(self, slot: int) -> None:
        """Drop one reference on ``slot`` (slot 0, the zero adapter, is never
        refcounted)."""
        if slot <= 0:
            return
        with self._lock:
            self._refs[slot] = max(0, self._refs.get(slot, 0) - 1)
        self._note_gauges()

    def overlay(self, rows: torch.Tensor) -> Overlay:
        """The ``models/lora.py`` overlay of one dispatch whose row ``i``
        runs adapter slot ``rows[i]`` (int64, on the stacks' device)."""
        return Overlay(rows, dict(self._stacks))

    # -- observability ------------------------------------------------------

    def _note_gauges(self) -> None:
        with self._lock:
            resident = len(self._aid_at)
            active = sum(1 for r in self._refs.values() if r > 0)
            free = self.n_slots - resident
        g = metrics.ADAPTER_SLOTS.labels
        g(self.model, "resident").set(resident)
        g(self.model, "active").set(active)
        g(self.model, "free").set(free)
        g(self.model, "host").set(len(self.host))

    def status(self) -> dict:
        """``/status.tenancy.adapters``: residency and lifetime counts."""
        with self._lock:
            residents = {
                str(slot): {"adapter": aid, "refs": self._refs.get(slot, 0)}
                for slot, aid in sorted(self._aid_at.items())
            }
            return {
                "slots": self.n_slots,
                "host_adapters": len(self.host),
                "resident": residents,
                "installs": self.installs,
                "demotions": self.demotions,
                "live_refs": sum(r for r in self._refs.values() if r > 0),
            }

    def validate_against(self, model) -> None:
        """Boot-time shape check against the served model: a
        wrong-architecture ADAPTER_DIR fails startup, not the first adapted
        request.  A projection stored int8 (``QUANTIZE=int8``) fails it too:
        the reference's check reads a dense kernel's shape there and fails
        on the quantized one, so the two knobs do not serve together."""
        from ..models.quant import Int8Linear

        layers = getattr(model, "layers", None)
        if not layers:
            raise ValueError("adapter validation: model has no layers")
        attn = getattr(layers[0], "attn", None)
        names = sorted(n for n, _ in attn.named_children()) if attn is not None else []
        for proj in self.projections:
            tgt = getattr(attn, proj, None) if proj in names else None
            if isinstance(tgt, Int8Linear):
                raise ValueError(
                    f"adapter projection {proj!r} is int8-quantized (QUANTIZE=int8): "
                    "ADAPTER_DIR needs the dense kernels")
            if not isinstance(tgt, torch.nn.Linear):
                raise ValueError(
                    f"adapters target projection {proj!r} but the model's "
                    f"attention block has {names}"
                )
            sa, sb = self._stacks[proj]
            d_in, d_out = sa.shape[2], sb.shape[3]
            kernel = (tgt.weight.shape[1], tgt.weight.shape[0])  # the reference's [in, out]
            if kernel != (d_in, d_out):
                raise ValueError(
                    f"adapter projection {proj!r} is [{d_in}, {d_out}] "
                    f"but the model kernel is {kernel}"
                )
        if len(layers) != self.num_layers:
            raise ValueError(
                f"adapters cover {self.num_layers} layers but the model "
                f"has {len(layers)}"
            )
