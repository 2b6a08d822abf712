"""Decode-kernel autotuner: a measured choice of K3's key split at warm-up.

Counterpart of the JAX package's ``ops/autotune.py``.  The Pallas kernel's
tuning axes (block folding, head batching, native MXU width, scale folding)
have no meaning on the card; the Hopper kernel's own axis is the split of
each row's keys across CTAs (``csrc/decode_sm90.cuh``): ``split_plan`` picks
it from the shapes alone, for about two CTAs per SM.  Which split count is
fastest at the paged loop's serving shape (slots, KV heads, group, block
size, table width, dense or int8) is measured here instead:

1. **Enumerate** the split counts a plan over the table can have
   (``paged_attention.feasible_splits``: whole ``block_unit_tiles`` units,
   at most ``MAX_SPLIT_TILES`` tiles a split, every split holding a key),
   ``split_plan``'s own choice first.  Variant keys are ``s<N>``.
2. **Verify** every candidate against the plain version
   ``paged_attention_ref`` on probe data at the real shapes, rows with no
   valid key among them; a candidate that fails is counted
   (``reject_verify``, or ``reject_error`` for a failed launch) and never
   timed.
3. **Time** the survivors with CUDA events on the current stream: the
   calls queue behind a short device spin (``torch.cuda._sleep``), so the
   events bracket back-to-back device work, not the host's launch rate;
   one warm call first, then the median over ``SWEEP_REPS`` reps of
   ``PALLAS_AUTOTUNE_ITERS`` calls.  No host clock is read.
4. **Install** the winner into the process table that K3's plans read
   (``lookup``; a plan cached before the table changed is not reused:
   ``generation``) and persist it, so a second engine, or the next process
   on the same table, hits it without a sweep.

The sweep runs once per tuning key per process, at the paged loop's warm-up
and before its chunk graphs are captured, so the graphs replay the
winner's grid.  ``PALLAS_VARIANT`` pins a split count and skips the sweep;
its grammar is checked when the configuration loads and its fit to the
table at the warm-up, both before readiness.  On the CPU the kernel does
not run: ``ensure_tuned`` takes an injectable ``launch`` and ``timer``.

The counters are the reference's names; ``reject_vmem`` stays 0: the CUDA
kernel streams 64-key tiles through shared memory of a fixed size at any
split count, so no candidate is refused for its memory.  Imports neither
the kernels nor torch's CUDA state at module import.
"""

from __future__ import annotations

import json
import os
import threading

#: back-to-back calls a timing rep brackets (PALLAS_AUTOTUNE_ITERS sets
#: them), and reps whose median is kept.
SWEEP_ITERS = 4
SWEEP_REPS = 5

GRAMMAR = "s<N>: N key splits of K3's grid per (KV head, row)"

_LOCK = threading.RLock()
_TABLE: dict[str, str] = {}
_RESULTS: dict[str, dict] = {}
_LOADED: set[str] = set()
_GENERATION = [0]
_COUNTS = {
    "sweeps": 0,          # measured sweeps run (one per new key)
    "candidates": 0,      # split counts enumerated across all sweeps
    "timed": 0,           # candidates that survived to measurement
    "hits": 0,            # table lookups answered without a sweep
    "pins": 0,            # PALLAS_VARIANT pins honored
    "installs": 0,        # winners installed into the process table
    "reject_vmem": 0,     # no meaning on the card (module docstring)
    "reject_verify": 0,   # candidates that mismatched the plain version
    "reject_error": 0,    # candidates whose launch failed
    "persist_errors": 0,  # tuning-table write/load failures (non-fatal)
}


def _event(name: str) -> None:
    from ..utils import metrics

    metrics.PALLAS_AUTOTUNE_EVENTS.labels(name).inc()


def _count(name: str, n: int = 1) -> None:
    with _LOCK:
        _COUNTS[name] += n


def tune_key(kind: str, *, b: int, kvh: int, n_rep: int,
             d: int, block_size: int, t: int, dtype: str,
             quant: bool, tp: int = 1) -> str:
    """Stable string key for one tuning problem, in the reference's format:
    every shape the kernel's cost depends on, and nothing else, so two
    models with the same decode shapes share an entry."""
    q8 = "-q8" if quant else ""
    tps = f"-tp{tp}" if int(tp) > 1 else ""
    return (
        f"{kind}/B{b}-G{kvh}-R{n_rep}-D{d}"
        f"-bs{block_size}-T{t}-{dtype}{q8}{tps}"
    )


def lookup(kind: str, *, b: int, kvh: int, n_rep: int, d: int,
           block_size: int, t: int, dtype: str, quant: bool,
           tp: int = 1, default: str = "") -> str:
    """The variant ``ensure_tuned`` recorded for this shape, else
    ``default``: what a K3 plan built for these inputs uses."""
    key = tune_key(kind, b=b, kvh=kvh, n_rep=n_rep, d=d,
                   block_size=block_size, t=t, dtype=dtype, quant=quant, tp=tp)
    with _LOCK:
        return _TABLE.get(key, default)


def generation() -> int:
    """Bumped whenever the table changes: part of K3's plan-cache key."""
    return _GENERATION[0]


def _set(key: str, vkey: str) -> None:
    with _LOCK:
        if _TABLE.get(key) != vkey:
            _TABLE[key] = vkey
            _GENERATION[0] += 1


def parse_variant(key: str | None) -> int:
    """``"s4"`` -> 4 splits; ``""``/None -> 0 (``split_plan``'s choice).
    ValueError on anything else, a Pallas key such as ``b4-hb`` included,
    so a typo'd ``PALLAS_VARIANT`` fails at boot."""
    if not key:
        return 0
    if key.startswith("s") and key[1:].isdigit() and int(key[1:]) >= 1:
        return int(key[1:])
    raise ValueError(
        f"variant {key!r} is not a K3 split variant (the port's grammar: {GRAMMAR}; "
        "the Pallas kernel's keys such as 'b4-hb' name TPU tuning points)")


def variant_key(splits: int) -> str:
    return f"s{int(splits)}"


def enumerate_variants(*, b: int, kvh: int, t: int, bs: int) -> list[int]:
    """The sweep set for one shape: ``split_plan``'s split count first,
    then every other split count a plan over the table can have."""
    from .paged_attention import feasible_splits, split_count

    default = split_count(b, kvh, t, bs)[0]
    return [default] + [n for n in feasible_splits(t, bs) if n != default]


def _probe(*, b: int, kvh: int, n_rep: int, d: int, bs: int, t: int, dtype: str,
           quant: bool, device, seed: int = 0) -> tuple:
    """Probe tensors at the serving shapes (K3's positional arguments from
    ``q`` to ``v_scale``) and the plain version's output.  Row 1 has no
    valid key (its output is the plain mean of what its table names: the
    closed form every split must merge to), every other row a part-filled
    tail block and random holes; the pool has a few blocks past the table,
    as a live pool does."""
    import numpy as np
    import torch

    from .paged_attention import paged_attention_ref

    rng = np.random.default_rng(seed)
    h = kvh * n_rep
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    nb_pool = t + 2
    q = torch.from_numpy(rng.standard_normal((b, h, d)).astype(np.float32))
    kf = rng.standard_normal((nb_pool, bs, kvh, d)).astype(np.float32)
    vf = rng.standard_normal((nb_pool, bs, kvh, d)).astype(np.float32)
    table = np.stack([rng.permutation(nb_pool)[:t] for _ in range(b)]).astype(np.int32)
    valid = (rng.random((b, t * bs)) < 0.8).astype(np.int32)
    valid[:, -max(bs // 2, 1):] = 0
    if b > 1:
        valid[1] = 0
    if quant:
        ks = np.abs(kf).max(axis=3, keepdims=True) / 127.0 + 1e-6
        vs = np.abs(vf).max(axis=3, keepdims=True) / 127.0 + 1e-6
        kp = torch.from_numpy(np.clip(np.round(kf / ks), -127, 127).astype(np.int8))
        vp = torch.from_numpy(np.clip(np.round(vf / vs), -127, 127).astype(np.int8))
        scales = [torch.from_numpy(x.astype(np.float32)).to(device, dt) for x in (ks, vs)]
    else:
        kp, vp = (torch.from_numpy(x).to(dt) for x in (kf, vf))
        scales = [None, None]
    args = (q.to(device, dt), kp.to(device), vp.to(device),
            torch.from_numpy(table).to(device), torch.from_numpy(valid).to(device),
            *scales)
    ref = paged_attention_ref(*args[:5], bs, k_scale=args[5], v_scale=args[6])
    return args, ref


def _verify(out, ref, dtype: str) -> bool:
    """The reference's tolerance: 3e-2 in bf16, 1e-4 in f32."""
    a, r = out.float().cpu(), ref.float().cpu()
    tol = 3e-2 if dtype == "bfloat16" else 1e-4
    return bool(a.isfinite().all()) and bool((a - r).abs().le(tol + tol * r.abs()).all())


def _cuda_timer(fn, args, iters: int, reps: int) -> float:
    """Seconds a call of ``fn`` takes on the device: one warm call, then per
    rep ``iters`` calls bracketed by CUDA events on the current stream,
    queued behind a spin long enough to hold the launches back; the median
    rep over ``iters``."""
    import torch

    fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000 + 200_000 * iters)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3 / iters)
    return sorted(times)[len(times) // 2]


def default_table_path(configured: str | None = None) -> str:
    """``configured`` (PALLAS_TUNE_TABLE), else ``pallas_tune.json`` in the
    kernels' build directory (``build/torch_kernels``, beside the libraries
    it tunes)."""
    if configured:
        return configured
    from ._build import BUILD_DIR

    return str(BUILD_DIR / "pallas_tune.json")


def _load_table(path: str | None) -> None:
    if not path:
        return
    with _LOCK:
        if path in _LOADED:
            return
        _LOADED.add(path)
    try:
        with open(path) as f:
            data = json.load(f)
        entries = data.get("table", {})
        if not isinstance(entries, dict):
            raise ValueError("tuning table is not an object")
        for key, vkey in entries.items():
            parse_variant(vkey)  # junk on disk must not reach a plan
        with _LOCK:
            for key, vkey in entries.items():
                if key not in _TABLE:
                    _set(key, vkey)
    except FileNotFoundError:
        pass
    except Exception:
        _count("persist_errors")
        _event("persist_error")


def _persist_table(path: str | None) -> None:
    if not path:
        return
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with _LOCK:
            body = {"version": 1, "table": dict(sorted(_TABLE.items()))}
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(body, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)  # atomic: concurrent readers see old or new
    except Exception:
        _count("persist_errors")
        _event("persist_error")


def _install(key: str, vkey: str) -> None:
    """The winner into the process table, where the next K3 plan built for
    its key reads it."""
    _set(key, vkey)
    _count("installs")
    _event("install")


def _sweep(key: str, *, b, kvh, n_rep, d, block_size, t, dtype, quant, device,
           iters: int, launch=None, timer=None) -> str:
    from .paged_attention import paged_decode_attention

    cands = enumerate_variants(b=b, kvh=kvh, t=t, bs=block_size)
    _count("sweeps")
    _count("candidates", len(cands))
    _event("sweep")
    args, ref = _probe(b=b, kvh=kvh, n_rep=n_rep, d=d, bs=block_size, t=t, dtype=dtype,
                       quant=quant, device=device)
    timings: dict[str, float] = {}
    best_key, best_t = variant_key(cands[0]), float("inf")
    for n in cands:
        if launch is None:
            def fn(*a, n=n):
                return paged_decode_attention(*a[:5], block_size, k_scale=a[5],
                                              v_scale=a[6], splits=n)
        else:
            def fn(*a, n=n):
                return launch(n, *a)
        try:
            if not _verify(fn(*args), ref, dtype):
                _count("reject_verify")
                _event("reject_verify")
                continue
            per = (timer or _cuda_timer)(fn, args, iters, SWEEP_REPS)
        except Exception:
            _count("reject_error")
            _event("reject_error")
            continue
        _count("timed")
        timings[variant_key(n)] = per
        if per < best_t:
            best_key, best_t = variant_key(n), per
    with _LOCK:
        _RESULTS[key] = {
            "winner": best_key,
            "default": variant_key(cands[0]),
            "candidates": len(cands),
            "timed": len(timings),
            "per_call_us": {k: round(v * 1e6, 3) for k, v in sorted(timings.items())},
        }
    return best_key


def ensure_tuned(kind: str, *, b: int, kvh: int, n_rep: int, d: int,
                 block_size: int, t: int, dtype: str, quant: bool = False,
                 device=None, pin: str | None = None, table_path: str | None = "",
                 iters: int = SWEEP_ITERS, launch=None, timer=None) -> str:
    """Resolve the split variant for one serving shape: honor a pin, answer
    from the (persisted) table, or run a measured sweep; then install the
    winner.  Returns its key.  ``table_path``: ``""`` = the default
    (``default_table_path``), None = no persistence.  ``launch(splits,
    *args)`` and ``timer(fn, args, iters, reps)`` stand in for the kernel
    and the CUDA-event timer (the CPU tests)."""
    from .paged_attention import feasible_splits

    key = tune_key(kind, b=b, kvh=kvh, n_rep=n_rep, d=d, block_size=block_size, t=t,
                   dtype=dtype, quant=quant)
    path = default_table_path() if table_path == "" else table_path
    if pin:
        n = parse_variant(pin)  # ValueError on junk: fail at boot
        if n not in feasible_splits(t, block_size):
            raise ValueError(
                f"PALLAS_VARIANT={pin!r}: {n} splits do not fit a table of {t} blocks "
                f"of {block_size} (feasible: {feasible_splits(t, block_size)})")
        _count("pins")
        _event("pin")
        _install(key, variant_key(n))
        return variant_key(n)
    _load_table(path)
    with _LOCK:
        got = _TABLE.get(key)
    if got is not None:
        if parse_variant(got) in feasible_splits(t, block_size):
            _count("hits")
            _event("hit")
            _install(key, got)
            return got
        # An entry no plan can have (a hand-edited file): swept again.
        _count("persist_errors")
        _event("persist_error")
    winner = _sweep(key, b=b, kvh=kvh, n_rep=n_rep, d=d, block_size=block_size, t=t,
                    dtype=dtype, quant=quant, device=device, iters=max(1, iters),
                    launch=launch, timer=timer)
    _set(key, winner)
    _persist_table(path)
    _install(key, winner)
    return winner


def stats() -> dict:
    """Counters, table and the last sweep of each key: /status.decode reads
    this one snapshot."""
    with _LOCK:
        return {
            "counts": dict(_COUNTS),
            "table": dict(sorted(_TABLE.items())),
            "sweeps": {k: dict(v) for k, v in sorted(_RESULTS.items())},
        }


def clear() -> None:
    """Test hook: forget tables, results and counters (files on disk stay;
    pass a fresh table path to isolate persistence tests)."""
    with _LOCK:
        _TABLE.clear()
        _RESULTS.clear()
        _LOADED.clear()
        _GENERATION[0] += 1
        for k in _COUNTS:
            _COUNTS[k] = 0
