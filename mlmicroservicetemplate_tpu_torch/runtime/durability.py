"""Durable serving: the write-ahead stream journal, the disk KV tier and
the reconnect registry (``JOURNAL_DIR``).

Counterpart of the JAX package's ``runtime/durability.py``, with its
names, defaults, file formats and semantics:

- **StreamJournal**: an append-only log of every stream's admission
  record and delivered-token cursor.  Each record is one JSON object
  framed by a ``<u32 length><u32 crc32>`` header, so a torn tail (the
  write a kill interrupted) is found and truncated at replay.  Records
  land BEFORE tokens reach the consumer, so the cursor covers everything
  a client may have seen; at startup the server replays the journal and
  resumes every incomplete stream through the loop's recast/replay
  resume, token-identically after ``kill -9``.  One process owns a
  directory (an exclusive ``flock`` on ``.lock``); opening compacts the
  live state into a fresh segment (``_KEEP_DONE`` finished streams,
  ``_KEEP_RESULTS`` unary results, ``_KEEP_TOMBS`` tombstones).
  ``JOURNAL_FSYNC``: ``always`` fsyncs each record, ``interval`` at most
  every 50 ms, ``off`` never (a process kill loses nothing either way:
  the page cache outlives the process).
- **KVDiskTier** (``KV_DISK_BUDGET_MB``): the rung below the host tier.
  Host entries the LRU evicts spill here, and stream checkpoints write
  through, so a resume after a restart prefetches disk -> host -> device
  instead of prefilling again.  Payloads live in one memmap file per
  pool leaf; the entries in a framed index log with the journal's
  torn-tail rule.  The index's meta records the leaf layout, and a
  layout that differs wipes the tier.  A bf16 leaf is stored bit for bit
  as 16-bit integers under the tag ``bf16``, so it never matches an f16
  leaf (``<f2``) of the same shape.
- **StreamRegistry**: resumed streams run headless (their connection
  died with the process); clients reconnect by request id through
  ``GET /v1/streams/{request_id}`` and drain the journaled tokens and
  the live continuation, each token once.

``JOURNAL_DIR`` unset (the default) builds none of this.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import struct
import threading
import time
import zlib

import numpy as np
import torch

from ..utils import metrics

log = logging.getLogger(__name__)

_HDR = struct.Struct("<II")  # payload length, crc32(payload)
_FSYNC_INTERVAL_S = 0.05
# Compaction bounds: finished streams and unary results kept across
# restarts (reconnects and X-Request-Id dedup), and the tombstones of
# compacted streams (their reconnect answers 410, not 404).
_KEEP_DONE = 256
_KEEP_RESULTS = 1024
_KEEP_TOMBS = 4096

# The admission record's feats: what a token-identical resume needs.  No
# deadline: a stream that survived a crash must not 504 on replay because
# its deadline passed while the server was down.
_FEAT_KEYS = (
    "length", "temperature", "top_k", "top_p", "seed", "max_tokens",
    "priority", "request_id",
)


def append_frame(f, payload: bytes) -> None:
    """One framed record: header, then the payload (which ends in
    ``\\n``, so the log stays greppable)."""
    f.write(_HDR.pack(len(payload), zlib.crc32(payload)) + payload)


def read_frames(path: str) -> tuple[list[bytes], int]:
    """Every intact record, and the byte offset of the first torn or bad
    frame (the file's size when it is clean).  A short header, a short
    payload or a CRC mismatch ends the scan: frames are self-delimiting,
    so nothing after a torn write is reachable."""
    out: list[bytes] = []
    good = 0
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        return out, 0
    n = len(data)
    while good + _HDR.size <= n:
        length, crc = _HDR.unpack_from(data, good)
        end = good + _HDR.size + length
        if end > n:
            break
        payload = data[good + _HDR.size:end]
        if zlib.crc32(payload) != crc:
            break
        out.append(payload)
        good = end
    return out, good


def record_bytes(rec: dict, compact: bool = False) -> bytes:
    """One record's payload: its JSON and a newline (``compact`` for
    appends, as the reference writes them)."""
    sep = (",", ":") if compact else None
    return (json.dumps(rec, separators=sep) + "\n").encode()


class RecoveredStream:
    """One stream's replayed state: its admission record and its
    delivered-token cursor."""

    __slots__ = ("rid", "feats", "klass", "budget", "tokens", "done", "outcome", "stop")

    def __init__(self, rid: str, feats: dict, klass: str, budget: int, stop=()):
        self.rid = rid
        self.feats = feats  # the JSON form
        self.klass = klass
        self.budget = int(budget)
        self.tokens: list[int] = []
        self.done = False
        self.outcome: str | None = None
        self.stop = tuple(stop or ())

    def np_feats(self) -> dict:
        """The feats dict the engine takes (arrays restored)."""
        f = dict(self.feats)
        ids = np.asarray(f.get("input_ids", []), np.int32)
        f["input_ids"] = ids
        f["length"] = np.int32(int(f.get("length", ids.size)))
        return f


def _lock_dir(path: str):
    """The exclusive advisory lock of a journal directory, or RuntimeError."""
    f = open(os.path.join(path, ".lock"), "a+")
    try:
        import fcntl

        fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
    except ImportError:  # not a unix
        pass
    except OSError:
        f.close()
        raise RuntimeError(
            f"journal dir {path!r} is locked by another process "
            f"(one server per JOURNAL_DIR)") from None
    return f


def _unlock_dir(f) -> None:
    try:
        import fcntl

        fcntl.flock(f, fcntl.LOCK_UN)
    except Exception:
        pass
    try:
        f.close()
    except Exception:
        pass


class SegmentLog:
    """Numbered append-only segments ``<prefix>NNNNNN.log`` of one
    directory, with the journal's fsync policy on appends."""

    def __init__(self, dir: str, prefix: str, fsync: str, model: str):
        self.dir = dir
        self.prefix = prefix
        self.fsync = str(fsync or "always").lower()
        self.model = model or "unknown"
        self._lock = threading.RLock()
        self._last_fsync = 0.0
        self.records_written = 0
        self.torn_bytes = 0
        self._f = None

    def segments(self) -> list[tuple[int, str]]:
        out = []
        n = len(self.prefix)
        for name in os.listdir(self.dir):
            if name.startswith(self.prefix) and name.endswith(".log"):
                try:
                    out.append((int(name[n:-4]), os.path.join(self.dir, name)))
                except ValueError:
                    pass
        return sorted(out)

    def replay(self, apply, what: str) -> list[tuple[int, str]]:
        """Feed every intact record of every segment to ``apply``; returns
        the segments read (deleted once the compaction has landed)."""
        segs = self.segments()
        for _, path in segs:
            frames, good = read_frames(path)
            sz = os.path.getsize(path)
            if good < sz:
                self.torn_bytes += sz - good
                log.warning("%s %s: torn tail (%d bytes) truncated at replay", what, path,
                            sz - good)
            for payload in frames:
                try:
                    apply(json.loads(payload))
                except Exception:
                    log.exception("%s: unreadable record skipped", what)
        return segs

    def open_next(self, segs) -> None:
        nxt = (segs[-1][0] + 1) if segs else 1
        self._f = open(os.path.join(self.dir, f"{self.prefix}{nxt:06d}.log"), "ab")

    def write_compacted(self, frames: list[bytes]) -> None:
        with self._lock:
            for payload in frames:
                append_frame(self._f, payload)
            self._f.flush()
            os.fsync(self._f.fileno())

    def append(self, rec: dict, observe=None) -> bool:
        """One record; False once closed."""
        payload = record_bytes(rec, compact=True)
        with self._lock:
            if self._f is None or self._f.closed:
                return False
            append_frame(self._f, payload)
            self._f.flush()
            self.records_written += 1
            now = time.monotonic()
            if self.fsync == "always" or (
                    self.fsync == "interval" and now - self._last_fsync >= _FSYNC_INTERVAL_S):
                t0 = time.perf_counter()
                os.fsync(self._f.fileno())
                if observe is not None:
                    observe(time.perf_counter() - t0)
                self._last_fsync = now
        return True

    def close(self) -> None:
        with self._lock:
            if self._f is not None and not self._f.closed:
                self._f.flush()
                try:
                    os.fsync(self._f.fileno())
                except OSError:
                    pass
                self._f.close()


class StreamJournal:
    """The write-ahead journal of one serving process (module docstring).
    Thread-safe: the loop thread appends token cursors while the event
    loop appends admissions."""

    def __init__(self, dir: str, fsync: str = "always", model: str = ""):
        self.dir = dir
        os.makedirs(dir, exist_ok=True)
        self._lockfile = _lock_dir(dir)
        self._seg = SegmentLog(dir, "wal-", fsync, model)
        self.fsync = self._seg.fsync
        self.model = self._seg.model
        self._lock = self._seg._lock
        # Replay every segment in order, compact the live state into a fresh
        # one and delete the old: replay cost follows the live state, not
        # all of history.
        self.streams: dict[str, RecoveredStream] = {}
        self.results: dict[str, list[int]] = {}
        self.tombs: dict[str, str] = {}
        segs = self._seg.replay(self._apply, "journal")
        self._seg.open_next(segs)
        self._compact_into_open_segment()
        for _, path in segs:
            try:
                os.unlink(path)
            except OSError:
                pass

    @property
    def records_written(self) -> int:
        return self._seg.records_written

    @property
    def torn_bytes(self) -> int:
        return self._seg.torn_bytes

    # -- replay --------------------------------------------------------

    def _apply(self, rec: dict) -> None:
        k = rec.get("k")
        rid = str(rec.get("rid", ""))
        if k == "admit":
            rs = RecoveredStream(rid, rec.get("feats", {}), rec.get("klass", "interactive"),
                                 rec.get("budget", 0), stop=rec.get("stop", ()))
            # A compacted admit carries its whole cursor: replay resets the
            # rid to it, so a crash mid-compaction (both segments present)
            # never counts a delta twice.
            rs.tokens = [int(t) for t in rec.get("delivered", [])]
            self.streams[rid] = rs
            self.tombs.pop(rid, None)  # the rid lives again
        elif k == "tokens":
            rs = self.streams.get(rid)
            if rs is not None:
                rs.tokens.extend(int(t) for t in rec.get("t", []))
        elif k == "done":
            rs = self.streams.get(rid)
            if rs is not None:
                rs.done = True
                rs.outcome = rec.get("outcome", "end")
        elif k == "result":
            self.results[rid] = [int(t) for t in rec.get("row", [])]
        elif k == "tomb":
            self.tombs[rid] = str(rec.get("outcome", "end"))

    def _compact_into_open_segment(self) -> None:
        done = [rs for rs in self.streams.values() if rs.done]
        for rs in done[: max(0, len(done) - _KEEP_DONE)]:
            self.streams.pop(rs.rid, None)
            # The token history goes; the outcome stays as a tombstone.
            self.tombs[rs.rid] = rs.outcome or "end"
        for rid in list(self.tombs)[: max(0, len(self.tombs) - _KEEP_TOMBS)]:
            self.tombs.pop(rid)
        for rid in list(self.results)[: max(0, len(self.results) - _KEEP_RESULTS)]:
            self.results.pop(rid, None)
        frames = []
        for rs in self.streams.values():
            frames.append(record_bytes({"k": "admit", "rid": rs.rid, "feats": rs.feats,
                                  "klass": rs.klass, "budget": rs.budget,
                                  "stop": list(rs.stop), "delivered": rs.tokens}))
            if rs.done:
                frames.append(record_bytes({"k": "done", "rid": rs.rid,
                                      "outcome": rs.outcome or "end"}))
        for rid, row in self.results.items():
            frames.append(record_bytes({"k": "result", "rid": rid, "row": row}))
        for rid, outcome in self.tombs.items():
            frames.append(record_bytes({"k": "tomb", "rid": rid, "outcome": outcome}))
        self._seg.write_compacted(frames)

    def incomplete(self) -> list[RecoveredStream]:
        return [rs for rs in self.streams.values() if not rs.done]

    def lookup_result(self, rid: str) -> list[int] | None:
        with self._lock:
            row = self.results.get(rid)
            return list(row) if row is not None else None

    def terminal_status(self, rid: str) -> str | None:
        """The outcome of a finished stream, tracked or compacted to a
        tombstone (the reconnect's 410); None when this journal never saw
        it finish (its 404)."""
        with self._lock:
            rs = self.streams.get(rid)
            if rs is not None and rs.done:
                return rs.outcome or "end"
            return self.tombs.get(rid)

    # -- appends (write-ahead) -----------------------------------------

    def _append(self, kind: str, rec: dict) -> None:
        if self._seg.append(rec, metrics.JOURNAL_FSYNC.labels(self.model).observe):
            metrics.JOURNAL_RECORDS.labels(self.model, kind).inc()

    def admit(self, rid: str, feats: dict, klass: str, budget: int, stop=()) -> None:
        ids = np.asarray(feats.get("input_ids", []), np.int32)
        ser: dict = {"input_ids": [int(t) for t in ids.tolist()]}
        for key in _FEAT_KEYS:
            v = feats.get(key)
            if v is not None:
                ser[key] = (float(v) if key in ("temperature", "top_p")
                            else str(v) if key in ("priority", "request_id") else int(v))
        stop = tuple(feats.get("stop_strs") or stop or ())
        with self._lock:
            self.streams[rid] = RecoveredStream(rid, ser, klass, budget, stop=stop)
            self.tombs.pop(rid, None)  # the rid lives again
        self._append("admit", {"k": "admit", "rid": rid, "feats": ser, "klass": klass,
                               "budget": int(budget), "stop": list(stop)})

    def tokens(self, rid: str, toks) -> None:
        lst = [int(t) for t in np.asarray(toks).reshape(-1).tolist()]
        if not lst:
            return
        with self._lock:
            rs = self.streams.get(rid)
            if rs is not None:
                rs.tokens.extend(lst)
        self._append("tokens", {"k": "tokens", "rid": rid, "t": lst})

    def checkpoint(self, rid: str) -> None:
        """A checkpoint site's marker (preemption, dry pool, supervised
        recovery): the cursor the resume continues from.  Replay reads the
        cursor off the ``tokens`` records; this makes the journal an
        account of every resume."""
        with self._lock:
            rs = self.streams.get(rid)
            cursor = len(rs.tokens) if rs is not None else 0
        self._append("checkpoint", {"k": "checkpoint", "rid": rid, "cursor": cursor})

    def done(self, rid: str, outcome: str = "end") -> None:
        with self._lock:
            rs = self.streams.get(rid)
            if rs is None or rs.done:
                return
            rs.done = True
            rs.outcome = outcome
        self._append("done", {"k": "done", "rid": rid, "outcome": outcome})

    def result(self, rid: str, row) -> None:
        lst = [int(t) for t in np.asarray(row).reshape(-1).tolist()]
        with self._lock:
            self.results[rid] = lst
        self._append("result", {"k": "result", "rid": rid, "row": lst})

    def stats(self) -> dict:
        with self._lock:
            inc = sum(1 for r in self.streams.values() if not r.done)
            return {
                "dir": self.dir,
                "fsync": self.fsync,
                "records_written": self.records_written,
                "streams_tracked": len(self.streams),
                "streams_incomplete": inc,
                "results_kept": len(self.results),
                "tombstones": len(self.tombs),
                "torn_bytes_truncated": self.torn_bytes,
            }

    def close(self) -> None:
        with self._lock:
            self._seg.close()
            _unlock_dir(self._lockfile)


# ---------------------------------------------------------------------------
# the disk block tier (KV_DISK_BUDGET_MB), below the host tier


def leaf_layout(leaf_specs) -> list[tuple[tuple[int, ...], str]]:
    """``[(per-block shape, tag)]`` of the host pool's leaves: numpy's
    type string where numpy has the type (``<f4``, ``<f2``, ``|i1``, as
    the reference writes them), ``bf16`` for bfloat16."""
    out = []
    for shape, dtype in leaf_specs:
        shape = tuple(int(s) for s in shape)
        if dtype == torch.bfloat16:
            out.append((shape, "bf16"))
        else:
            out.append((shape, torch.empty(0, dtype=dtype).numpy().dtype.str))
    return out


def _storage(tag: str) -> np.dtype:
    """The memmap type of a layout tag (bf16's bits as 16-bit integers)."""
    return np.dtype(np.int16) if tag == "bf16" else np.dtype(tag)


def _to_storage(vals, tag: str) -> np.ndarray:
    if isinstance(vals, torch.Tensor):
        t = vals.detach().cpu().contiguous()
        if tag == "bf16":
            return t.view(torch.int16).numpy()
        return t.numpy()
    return np.asarray(vals)


def _from_storage(arr: np.ndarray, tag: str) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.view(torch.bfloat16) if tag == "bf16" else t


class DiskBlockPool:
    """Blocks on disk: the host pool's layout (one buffer per pool leaf)
    in memmap files under the tier's directory.  Allocation is a
    ``BlockPool``'s, by delegation (a wipe swaps the book); the payload
    files open once the leaf layout is known (``attach``)."""

    def __init__(self, num_blocks: int, block_bytes: int, dir: str):
        from ..engine.kv_blocks import BlockPool

        self.book = BlockPool(num_blocks, block_bytes)
        self.num_blocks = int(num_blocks)
        self.block_bytes = int(block_bytes)
        self.dir = dir
        self.leaves: list | None = None
        self.leaf_specs: list | None = None

    def alloc(self, n):
        return self.book.alloc(n)

    def free(self, ids):
        self.book.free(ids)

    def take(self, ids):
        self.book.take(ids)

    @property
    def free_blocks(self):
        return self.book.free_blocks

    @property
    def used_blocks(self):
        return self.book.used_blocks

    def attach(self, leaf_specs) -> None:
        """Open (or create) one memmap per leaf; a file of another size is
        recreated."""
        os.makedirs(self.dir, exist_ok=True)
        layout = leaf_layout(leaf_specs)
        leaves = []
        for i, (shape, tag) in enumerate(layout):
            path = os.path.join(self.dir, f"leaf-{i}.dat")
            full = (self.num_blocks,) + shape
            dt = _storage(tag)
            nbytes = int(np.prod(full)) * dt.itemsize
            mode = "r+" if os.path.exists(path) and os.path.getsize(path) == nbytes else "w+"
            leaves.append(np.memmap(path, dtype=dt, mode=mode, shape=full))
        self.leaves = leaves
        self.leaf_specs = layout

    def write(self, ids: list[int], leaf_vals) -> None:
        """Store block rows: ``leaf_vals[i]`` is ``[len(ids), bs, ...]``
        (torch tensors or arrays, in the leaf's type)."""
        idx = np.asarray(ids, np.int64)
        for buf, vals, (_, tag) in zip(self.leaves, leaf_vals, self.leaf_specs):
            buf[idx] = _to_storage(vals, tag)

    def read(self, ids: list[int]) -> list[torch.Tensor]:
        """Block rows, one ``[len(ids), bs, ...]`` tensor per leaf."""
        idx = np.asarray(ids, np.int64)
        return [_from_storage(buf[idx], tag) for buf, (_, tag) in zip(self.leaves,
                                                                      self.leaf_specs)]

    def read_into(self, ids: list[int], pool, dst_ids: list[int]) -> None:
        """Block rows into another pool's buffers in place (the host pool's
        pinned ones): one read and one ``index_copy_`` a leaf."""
        src = np.asarray(ids, np.int64)
        dst = torch.as_tensor(list(dst_ids), dtype=torch.long)
        for buf, host, (_, tag) in zip(self.leaves, pool.leaves, self.leaf_specs):
            host.index_copy_(0, dst, _from_storage(buf[src], tag))

    def flush(self) -> None:
        for buf in self.leaves or ():
            buf.flush()


def _json_key(key) -> list:
    """The index's form of an entry key: ``("stream", rid)``, or the prefix
    cache's ``(p_len, blake2b bytes)``."""
    if isinstance(key, tuple) and len(key) == 2 and isinstance(key[1], bytes):
        return ["p", int(key[0]), key[1].hex()]
    return ["s", str(key[1]) if isinstance(key, tuple) else str(key)]


def _from_json_key(j):
    if not isinstance(j, list) or not j:
        return None
    if j[0] == "p" and len(j) == 3:
        return (int(j[1]), bytes.fromhex(j[2]))
    if j[0] == "s" and len(j) == 2:
        return ("stream", j[1])
    return None


def _tuple_key(key):
    return key if isinstance(key, tuple) else ("stream", str(key))


# One tier object per directory per process: a second engine over the
# same JOURNAL_DIR shares it instead of opening a second index writer.
_DISK_TIERS: dict[str, "KVDiskTier"] = {}
_DISK_TIERS_LOCK = threading.Lock()


def get_disk_tier(budget_mb: float, block_bytes: int, dir: str) -> "KVDiskTier":
    """The process's tier of ``dir``: the first open builds it (and replays
    its index), later ones return it; ``close`` forgets it, so a new tier
    (a simulated restart) rebuilds from disk."""
    key = os.path.realpath(dir)
    with _DISK_TIERS_LOCK:
        tier = _DISK_TIERS.get(key)
        if tier is None:
            tier = KVDiskTier(budget_mb, block_bytes, dir)
            tier._registry_key = key
            _DISK_TIERS[key] = tier
        return tier


class KVDiskTier:
    """The disk rung of the KV tiers: host entries the LRU evicts demote
    here, and stream checkpoints write through so their resume outlives
    the process.  Keys are ``("stream", rid)`` for checkpoints and the
    prefix cache's content-hash key for prefixes; the index log replays
    across restarts, and its meta guards the payload layout."""

    def __init__(self, budget_mb: float, block_bytes: int, dir: str):
        from ..engine.kv_blocks import SwapLedger

        self.budget_bytes = int(float(budget_mb) * 1e6)
        self.block_bytes = int(block_bytes)
        self.num_blocks = self.budget_bytes // max(1, self.block_bytes)
        self.dir = dir
        self.pool = DiskBlockPool(self.num_blocks, self.block_bytes, dir)
        self.ledger = SwapLedger(self.pool)
        self.ledger.on_release = self._index_del
        self._index_path = os.path.join(dir, "index.log")
        self._meta_specs = None
        self._lock = threading.RLock()
        self._index_f = None
        self.spills = 0
        self.promotes = 0
        self.model = None
        os.makedirs(dir, exist_ok=True)
        self._load_index()

    @property
    def enabled(self) -> bool:
        return self.num_blocks > 0

    # -- index ---------------------------------------------------------

    def _load_index(self) -> None:
        frames, good = read_frames(self._index_path)
        sz = os.path.getsize(self._index_path) if os.path.exists(self._index_path) else 0
        if good < sz:
            log.warning("disk-tier index: torn tail truncated at replay")
        live: dict = {}
        meta_ok = True
        for payload in frames:
            try:
                rec = json.loads(payload)
            except Exception:
                continue
            op = rec.get("op")
            if op == "meta":
                if (int(rec.get("block_bytes", -1)) != self.block_bytes
                        or int(rec.get("num_blocks", -1)) > self.num_blocks):
                    meta_ok = False
                    break
                self._meta_specs = rec.get("leaf_specs")
            elif op == "put":
                key = _from_json_key(rec.get("key"))
                ids = [int(i) for i in rec.get("ids", [])]
                if key is None or any(i >= self.num_blocks for i in ids):
                    continue
                live[_tuple_key(key)] = (key, ids, int(rec.get("tokens", 0)),
                                         str(rec.get("kind", "stream")))
            elif op == "del":
                key = _from_json_key(rec.get("key"))
                if key is not None:
                    live.pop(_tuple_key(key), None)
        if not meta_ok:
            self.wipe()
            live = {}
        # The ledger from the net state, then the index rewritten compact,
        # so it does not grow across restarts.
        self.ledger.on_release = None
        for key, ids, tokens, kind in live.values():
            try:
                self.ledger.restore(ids, tokens, kind, key)
            except Exception:
                log.exception("disk-tier index: unrestorable entry dropped")
        self.ledger.on_release = self._index_del
        self._index_f = open(self._index_path + ".new", "wb")
        self._index_meta()
        for key, ids, tokens, kind in live.values():
            append_frame(self._index_f, record_bytes({
                "op": "put", "key": _json_key(key), "ids": ids, "tokens": tokens, "kind": kind}))
        self._index_f.flush()
        os.fsync(self._index_f.fileno())
        self._index_f.close()
        os.replace(self._index_path + ".new", self._index_path)
        self._index_f = open(self._index_path, "ab")

    def _index_meta(self) -> None:
        append_frame(self._index_f, record_bytes({
            "op": "meta", "block_bytes": self.block_bytes, "num_blocks": self.num_blocks,
            "leaf_specs": self._meta_specs}))

    def _index_append(self, rec: dict) -> None:
        with self._lock:
            if self._index_f is None or self._index_f.closed:
                return
            append_frame(self._index_f, record_bytes(rec))
            self._index_f.flush()

    def _index_del(self, entry) -> None:
        if entry.key is not None:
            self._index_append({"op": "del", "key": _json_key(entry.key)})

    # -- storage -------------------------------------------------------

    def attach(self, leaf_specs) -> bool:
        """Open (or check) the payload files against the live pool leaves'
        layout; a layout that differs from the persisted one wipes the
        tier (stale KV never reaches the pools).  False when the tier is
        off or attached already to another layout."""
        if not self.enabled:
            return False
        with self._lock:
            want = leaf_layout(leaf_specs)
            if self.pool.leaves is not None:
                return self.pool.leaf_specs == want
            if self._meta_specs is not None and [
                    (tuple(s), d) for s, d in (tuple(e) for e in self._meta_specs)] != want:
                log.warning("disk KV tier: leaf layout changed; wiping stale tier")
                self.wipe()
            self.pool.attach(leaf_specs)
            if self._meta_specs is None:
                self._meta_specs = [[list(shape), tag] for shape, tag in self.pool.leaf_specs]
                self._index_meta()
                self._index_f.flush()
            return True

    def wipe(self) -> None:
        from ..engine.kv_blocks import SwapLedger

        with self._lock:
            for name in list(os.listdir(self.dir)):
                if name.startswith("leaf-") or name.startswith("index.log"):
                    try:
                        os.unlink(os.path.join(self.dir, name))
                    except OSError:
                        pass
            self.pool = DiskBlockPool(self.num_blocks, self.block_bytes, self.dir)
            self.ledger = SwapLedger(self.pool)
            self.ledger.on_release = self._index_del
            self._meta_specs = None
            if self._index_f is not None and not self._index_f.closed:
                self._index_f.close()
            self._index_f = open(self._index_path, "ab")

    # -- entries -------------------------------------------------------

    def put(self, key, tokens: int, kind: str, leaf_vals):
        """Store one entry's blocks, superseding an older entry at the same
        key; None when the tier cannot hold it even after LRU eviction.
        ``leaf_vals[i]`` is ``[n_blocks, block, ...]`` in pool-leaf order
        (what ``HostBlockPool.read`` returns)."""
        if self.pool.leaves is None:
            return None
        n = int(leaf_vals[0].shape[0]) if leaf_vals else 0
        with self._lock:
            old = self.ledger.get(key)
            if old is not None:
                self.ledger.release(old)
            entry = self.ledger.reserve(n, tokens, kind, key=key)
            if entry is None:
                return None
            try:
                self.pool.write(entry.ids, leaf_vals)
            except Exception:
                log.exception("disk KV tier: write failed")
                self.ledger.release(entry)
                return None
            entry.ready = True
            self._index_append({"op": "put", "key": _json_key(key), "ids": entry.ids,
                                "tokens": int(tokens), "kind": kind})
            self.spills += 1
        self._note_gauges()
        return entry

    def get(self, key):
        return self.ledger.get(key)

    def prefix_get(self, key):
        """The host tier's ``prefix_get``, so the prefix cache's
        ``host_lookup`` probes this rung with the same call; only once the
        payload files are attached (an index-only hit promises KV this
        process cannot read yet)."""
        if self.pool.leaves is None:
            return None
        return self.ledger.get(key)

    def release(self, entry) -> None:
        self.ledger.release(entry)
        self._note_gauges()

    def release_key(self, key) -> None:
        e = self.ledger.get(key)
        if e is not None:
            self.ledger.release(e)
            self._note_gauges()

    def _note_gauges(self, model: str | None = None) -> None:
        m = model or self.model or "unknown"
        metrics.KV_DISK_POOL_BLOCKS.labels(m, "used").set(self.pool.used_blocks)
        metrics.KV_DISK_POOL_BLOCKS.labels(m, "free").set(self.pool.free_blocks)

    def stats(self) -> dict:
        base = {
            "budget_bytes": self.budget_bytes,
            "block_bytes": self.block_bytes,
            "num_blocks": self.num_blocks,
            "spills": self.spills,
            "promotes": self.promotes,
            "attached": self.pool.leaves is not None,
        }
        base.update(self.ledger.stats())
        return base

    def close(self) -> None:
        with self._lock:
            self.pool.flush()
            if self._index_f is not None and not self._index_f.closed:
                self._index_f.flush()
                self._index_f.close()
        key = getattr(self, "_registry_key", None)
        if key is not None:
            with _DISK_TIERS_LOCK:
                if _DISK_TIERS.get(key) is self:
                    del _DISK_TIERS[key]


# ---------------------------------------------------------------------------
# the reconnect registry (GET /v1/streams/{request_id})


class StreamRecord:
    """One resumed stream's reconnect state: the journaled tokens and the
    live continuation, on the server's event loop."""

    def __init__(self, rid: str, tokens: list[int], max_tokens=None, stop=()):
        self.rid = rid
        self.tokens = list(tokens)
        self.max_tokens = max_tokens
        self.stop = tuple(stop or ())
        self.done = False
        self.error: str | None = None
        self._waiters: list = []

    def _wake(self) -> None:
        for fut in self._waiters:
            if not fut.done():
                fut.set_result(None)
        self._waiters = []

    def extend(self, toks) -> None:
        self.tokens.extend(int(t) for t in np.asarray(toks).reshape(-1))
        self._wake()

    def complete(self) -> None:
        self.done = True
        self._wake()

    def fail(self, msg: str) -> None:
        self.error = msg
        self.done = True
        self._wake()

    async def wait_past(self, n: int) -> None:
        """Until more than ``n`` tokens exist or the stream ends."""
        while len(self.tokens) <= n and not self.done:
            fut = asyncio.get_running_loop().create_future()
            self._waiters.append(fut)
            if len(self.tokens) > n or self.done:
                fut.cancel()
                return
            await fut


class StreamRegistry:
    """rid -> StreamRecord of every stream the journal replay saw."""

    def __init__(self):
        self._records: dict[str, StreamRecord] = {}

    def add(self, rec: StreamRecord) -> StreamRecord:
        self._records[rec.rid] = rec
        return rec

    def get(self, rid: str) -> StreamRecord | None:
        return self._records.get(rid)

    def stats(self) -> dict:
        live = sum(1 for r in self._records.values() if not r.done)
        return {"streams": len(self._records), "live": live}
