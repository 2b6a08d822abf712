"""Multi-tenant accounts and weighted fair share (``TENANTS``,
``TENANTS_FILE``, ``X-Api-Key``) in the port against the JAX package, f32 on
the CPU, on the cases of the JAX package's ``tests/test_tenancy.py``
(sections 1, 2, 4 and 5) at a small llama:

- ``parse_tenants``: the same specs, or the same ``ValueError`` message,
  over the JAX test's garbage and a hypothesis sweep of inline and file
  tables.
- The quota ledger: one script of admits, readmits, releases and a double
  release under one injected clock gives equal ``usage()``, ``totals()``,
  ``QuotaExceeded`` messages and ``retry_after_s``.
- ``WeightedFairShare``: random weights, eligible sets and costs give the
  same picks and snapshot; ``DeadlineQueue`` with a fair share pops the JAX
  queue's items, one for one, over two classes, deadlines, tenants and a
  ``fits`` gate; without one it pops plain EDF.
- The loop: two tenants at 3:1 and anonymous callers, all queued behind two
  slots, through the contiguous and the paged loop, greedy and seeded:
  each request's tokens, the fair share's pick sequence and
  ``/status.tenancy`` equal the JAX service's.
- Over HTTP on both apps: the JAX test's script (a held stream at
  ``max_concurrency=1``, its tenant's second request 429 with Retry-After,
  another tenant served, an unknown ``X-Adapter`` 400) and a token-window
  429: the same statuses and Retry-After, ``/status.tenancy`` whole, and the
  ``tenant_*`` series of ``/metrics``.
- Unset, nothing is built; leases are conserved through a preemption, a
  recovery checkpoint and a bulk job's lines: the ledgers go back to zero
  in both packages.

A loop is held by gating its ``_dispatch_chunk`` (both packages call it
once per live chunk after the iteration's admission; the gate of
``test_torch_stream_shed.py``)."""

import asyncio
import dataclasses
import json
import os
import tempfile
import threading
import time

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from hypothesis import given, settings
from hypothesis import strategies as hs
from test_torch_stream_shed import _Gate

import jax

from test_torch_jax_cache import isolated_jax_cache  # noqa: F401
from mlmicroservicetemplate_tpu.api import build_app as jax_build_app
from mlmicroservicetemplate_tpu.models.registry import RawItem as JaxRawItem
from mlmicroservicetemplate_tpu.scheduler.policy import DeadlineQueue as JaxQueue
from mlmicroservicetemplate_tpu.serve import build_service as jax_build_service
from mlmicroservicetemplate_tpu.tenancy import accounts as jax_accounts
from mlmicroservicetemplate_tpu.tenancy.fairshare import WeightedFairShare as JaxFairShare
from mlmicroservicetemplate_tpu_torch.api.app import build_app
from mlmicroservicetemplate_tpu_torch.models import lora
from mlmicroservicetemplate_tpu_torch.models.registry import RawItem
from mlmicroservicetemplate_tpu_torch.scheduler.policy import DeadlineQueue
from mlmicroservicetemplate_tpu_torch.serve import build_service
from mlmicroservicetemplate_tpu_torch.tenancy import accounts
from mlmicroservicetemplate_tpu_torch.tenancy.fairshare import WeightedFairShare

SMALL = dict(vocab_size=300, d_model=64, num_heads=4, num_kv_heads=2, num_layers=2, d_ff=128,
             max_position=128)
SERVE = {"MODEL_NAME": "llama", "DEVICE": "cpu", "WARMUP": "0", "SEQ_BUCKETS": "16,32",
         "BATCH_BUCKETS": "1,2,4", "MAX_DECODE_LEN": "8", "STREAM_CHUNK_TOKENS": "4",
         "BATCH_TIMEOUT_MS": "1", "KV_BLOCK_SIZE": "8"}
# The byte tokenizer's ids for "hi": its two bytes and the end token.
HI_IDS = 3


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# parse_tenants


def _parse(mod, inline, path):
    """Specs as dicts, or the ValueError's message."""
    try:
        return [dataclasses.asdict(s) for s in mod.parse_tenants(inline, path)]
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("inline", ["=3", "a=notanumber", "a=-1", "a=3,b", " a = 2 , ,b=0.5",
                                    "a=0", "a=nan", "a=inf,a=2", "", None])
def test_parse_tenants_inline_matches_jax(inline):
    want = _parse(jax_accounts, inline, None)
    assert _parse(accounts, inline, None) == want
    if inline == "a=3,b":
        assert {s["name"]: s["weight"] for s in want} == {"a": 3.0, "b": 1.0}


_FILE_DOCS = [
    [{"name": "acme", "weight": 3, "api_keys": ["k1", "k2"], "max_concurrency": 2,
      "tokens_per_window": 100, "kv_mb": 1.5, "adapter": "alpha"}, {"name": "bob"}],
    {"tenants": [{"name": "a"}]},
    {"other": 1}, "not a list", [1], [{"weight": 2}], [{"name": "x", "weight": 0}],
    [{"name": "x", "max_concurrency": -1}], [{"name": "x", "weight": "heavy"}],
    [{"name": "x", "kv_mb": None}],
]


@pytest.mark.parametrize("doc", range(len(_FILE_DOCS) + 2))
def test_parse_tenants_file_matches_jax(tmp_path, doc):
    path = tmp_path / "tenants.json"
    if doc == len(_FILE_DOCS):
        path.write_text("{bad json")
    elif doc < len(_FILE_DOCS):
        path.write_text(json.dumps(_FILE_DOCS[doc]))
    # doc == len + 1: the file does not exist.
    for inline in (None, "acme=2,zed"):
        assert _parse(accounts, inline, str(path)) == _parse(jax_accounts, inline, str(path))


_NAMES = hs.sampled_from(["a", "b", "acme", " c ", "", "x y"])
_WEIGHTS = hs.sampled_from(["", "1", "3", "0.5", "0", "-2", "nan", "inf", "w"])
_VALUES = hs.one_of(hs.integers(-2, 5), hs.floats(-1, 5, allow_nan=False), hs.none(),
                    hs.sampled_from(["3", "x", ""]))


@settings(max_examples=60, deadline=None)
@given(parts=hs.lists(hs.tuples(_NAMES, _WEIGHTS, hs.booleans()), max_size=5),
       entries=hs.lists(hs.dictionaries(
           hs.sampled_from(["name", "weight", "api_keys", "max_concurrency",
                            "tokens_per_window", "kv_mb", "adapter"]),
           hs.one_of(_VALUES, _NAMES, hs.lists(_NAMES, max_size=2))), max_size=4),
       wrap=hs.booleans())
def test_parse_tenants_sweep_matches_jax(parts, entries, wrap):
    inline = ",".join(n if bare else f"{n}={w}" for n, w, bare in parts)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "t.json")
        with open(path, "w") as f:
            json.dump({"tenants": entries} if wrap else entries, f)
        for args in ((inline, None), (None, path), (inline, path)):
            assert _parse(accounts, *args) == _parse(jax_accounts, *args)


# ---------------------------------------------------------------------------
# the ledger


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _ledger_script(mod) -> list:
    """The JAX test's conservation script plus a KV quota, a readmit, an
    anonymous caller and a second tenant, every observation recorded."""
    clock = _Clock()
    acme = mod.TenantSpec(name="acme", weight=2.0, api_keys=("k1",), max_concurrency=2,
                          tokens_per_window=100, kv_budget_mb=1.0)
    kv = mod.TenantSpec(name="kv", kv_budget_mb=0.001)
    reg = mod.TenantRegistry([acme, kv], model="m", window_s=60.0, topk=1, clock=clock)
    out = []

    def step(fn):
        try:
            out.append(("ok", fn()))
        except mod.QuotaExceeded as e:
            out.append(("quota", str(e), e.tenant, e.retry_after_s))
        out.append((reg.usage(), reg.totals()))

    leases = []
    step(lambda: leases.append(reg.admit(acme, tokens=40, kv_bytes=1024)))
    clock.t += 3.5
    step(lambda: leases.append(reg.admit(acme, tokens=40, kv_bytes=1024)))
    step(lambda: reg.admit(acme, tokens=1, kv_bytes=0))
    clock.t += 10.0
    step(lambda: reg.admit(acme, tokens=40, kv_bytes=0))
    step(lambda: reg.release(leases[0]))
    step(lambda: reg.release(leases[0]))
    step(lambda: reg.admit(acme, tokens=40, kv_bytes=0))
    r = []
    step(lambda: r.append(reg.readmit("acme", kv_bytes=512)))
    step(lambda: reg.release(r[0]))
    step(lambda: reg.release(leases[1]))
    step(lambda: reg.admit(kv, tokens=5, kv_bytes=2000))
    k = []
    step(lambda: k.append(reg.admit(kv, tokens=5, kv_bytes=1000)))
    step(lambda: reg.release(k[0]))
    step(lambda: reg.release(None))
    out.append([reg.label(n) for n in ("acme", "kv", "", "nobody")])
    out.append([dataclasses.asdict(reg.classify(key)) for key in ("k1", "kv", None, "?")])
    clock.t += 61.0
    step(lambda: reg.admit(acme, tokens=100, kv_bytes=0))
    return out


def test_ledger_script_matches_jax():
    want = _ledger_script(jax_accounts)
    got = _ledger_script(accounts)
    assert got == want
    quota = [x for x in got if x[0] == "quota"]
    assert [q[3] for q in quota] == [1.0, 1.0, 46.5, 1.0]
    assert got[-1][1] == {"active": 1, "kv_bytes": 0}


def test_ledger_conserves_under_threads():
    """Twelve threads admit, readmit and release (each lease twice) against
    one registry with a short switch interval: no charge is lost or doubled,
    the ledger ends at zero and no shed is counted (no quota binds)."""
    import sys

    spec = accounts.TenantSpec(name="t", max_concurrency=0)
    reg = accounts.TenantRegistry([spec], window_s=60.0, clock=_Clock())
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        for i in range(300):
            lease = (reg.admit(spec, tokens=1, kv_bytes=8) if i % 3
                     else reg.readmit("t", kv_bytes=8))
            reg.release(lease)
            reg.release(lease)

    try:
        threads = [threading.Thread(target=work) for _ in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert reg.totals() == {"active": 0, "kv_bytes": 0}
    u = reg.usage()["t"]
    assert u["window_tokens"] == 12 * 200 and u["sheds"] == 0


# ---------------------------------------------------------------------------
# the fair share and the queue


@settings(max_examples=80, deadline=None)
@given(weights=hs.dictionaries(hs.sampled_from("abcde"), hs.floats(0.1, 8)),
       default=hs.floats(0.1, 4),
       steps=hs.lists(hs.tuples(hs.sets(hs.sampled_from("abcdef")), hs.floats(0.0, 5.0)),
                      max_size=40))
def test_fair_share_picks_match_jax(weights, default, steps):
    want, got = JaxFairShare(weights, default), WeightedFairShare(weights, default)
    for eligible, cost in steps:
        order = sorted(eligible)
        t = want.pick(order)
        assert got.pick(order) == t
        if t is not None:
            want.charge(t, cost)
            got.charge(t, cost)
        assert got.snapshot() == want.snapshot()


def test_weighted_ratio_and_idle_credit():
    """The JAX tests' properties: 3:1 under contention (±10%), and an idle
    tenant banks no credit."""
    fs = WeightedFairShare({"heavy": 3.0, "light": 1.0})
    picks = []
    for _ in range(400):
        picks.append(fs.pick(("heavy", "light")))
        fs.charge(picks[-1])
    assert abs(picks.count("heavy") / 400 - 0.75) <= 0.075
    fs = WeightedFairShare({"a": 1.0, "b": 1.0})
    for _ in range(100):
        fs.charge("a")
    picks = []
    for _ in range(10):
        picks.append(fs.pick(("a", "b")))
        fs.charge(picks[-1])
    assert picks.count("b") <= 6


class _Item:
    def __init__(self, i, tenant, klass, deadline, size):
        self.i, self.tenant, self.klass, self.deadline, self.size = i, tenant, klass, deadline, size
        self.started = False


def _queue_run(queue_cls, fs_cls, seed: int, fair: bool) -> list:
    rng = np.random.default_rng(seed)
    q = queue_cls(64, weight=2, clock=lambda: 0.0)
    if fair:
        q.set_fairshare(fs_cls({"acme": 3.0, "bob": 1.0}, 1.0))
    out = []
    budget = [8]

    def fits(it):
        return it.size <= budget[0]

    n = 0
    for _ in range(60):
        if rng.random() < 0.55:
            dl = None if rng.random() < 0.3 else float(rng.integers(1, 20))
            q.put(_Item(n, str(rng.choice(["acme", "bob", "", "carol"])),
                        str(rng.choice(["interactive", "batch"])), dl, int(rng.integers(1, 10))))
            n += 1
        else:
            budget[0] = int(rng.integers(0, 12))
            it = q.pop_nowait(fits=fits if rng.random() < 0.7 else None)
            out.append(None if it is None else it.i)
    while q.qsize():
        out.append(q.pop_nowait().i)
    if fair:
        out.append(q._fairshare.snapshot())
    return out


@pytest.mark.parametrize("fair", [True, False])
@pytest.mark.parametrize("seed", range(4))
def test_deadline_queue_fair_pops_match_jax(seed, fair):
    want = _queue_run(JaxQueue, JaxFairShare, seed, fair)
    assert _queue_run(DeadlineQueue, WeightedFairShare, seed, fair) == want


def test_fair_queue_no_starvation_and_edf_within_tenant():
    """The JAX test: eight heavy waiters with earlier deadlines than one
    light one; the light one is served within two pops, and the heavy ones
    in EDF order."""
    q = DeadlineQueue(64)
    q.set_fairshare(WeightedFairShare({"heavy": 1.0, "light": 1.0}))
    items = [_Item(i, "heavy", "interactive", 1e9 + i, 1) for i in range(8)]
    for it in items:
        q.put(it)
    light = _Item(8, "light", "interactive", 2e9, 1)
    q.put(light)
    popped = [q.pop_nowait() for _ in range(9)]
    assert light in popped[:2]
    assert [it for it in popped if it is not light] == items


# ---------------------------------------------------------------------------
# services


def _services(env: dict, jax_env: dict | None = None, port_env: dict | None = None):
    """The JAX (cfg, bundle, engine, batcher) and the port's, on the same
    weights."""
    os.environ["LLAMA_CONFIG"] = json.dumps(SMALL)
    try:
        jcfg, jbundle, jengine, jbatcher, _ = jax_build_service(
            {**SERVE, **env, **(jax_env or {}), "REPLICAS": "1"})
        port = build_service({**SERVE, **env, **(port_env or {})},
                             params=jax.tree.map(np.asarray, jbundle.params))
    finally:
        del os.environ["LLAMA_CONFIG"]
    return (jcfg, jbundle, jengine, jbatcher), port


def _tenants_file(path, specs) -> str:
    path.write_text(json.dumps(specs))
    return str(path)


async def _tokens(gen) -> list[int]:
    return [t async for chunk in gen for t in np.asarray(chunk).tolist()]


def _log_picks(queue) -> list:
    """Record the fair share's picks on ``queue``: (eligible, picked)."""
    fs = queue._fairshare
    log = []
    pick = fs.pick

    def logged(eligible):
        eligible = sorted(eligible)
        t = pick(eligible)
        log.append((tuple(eligible), t))
        return t

    fs.pick = logged
    return log


def _loop_case(batcher, bundle, item_cls, sampled: bool):
    """Ten streams (six acme, two bob, two anonymous), all queued before the
    loop's thread starts, behind two slots."""
    who = ["acme", "bob", "acme", "", "acme", "acme", "bob", "", "acme", "acme"]
    feats = []
    for i, tenant in enumerate(who):
        raw = item_cls(text=f"request number {i}", max_tokens=8,
                       temperature=0.8 if sampled and i % 2 else 0.0,
                       seed=100 + i if sampled and i % 2 else None)
        f = dict(bundle.preprocess(raw), priority="batch")
        if tenant:
            f["tenant"] = tenant
        feats.append(f)
    loop = batcher._cdl
    picks = _log_picks(loop.queue)

    async def body():
        loop._ensure_thread = lambda: None
        try:
            gens = [batcher.submit_stream(f) for f in feats]
        finally:
            del loop._ensure_thread
        loop._ensure_thread()
        return list(await asyncio.gather(*(_tokens(g) for g in gens)))

    try:
        toks = asyncio.run(body())
        for _ in range(200):
            if batcher.tenants.totals()["active"] == 0:
                break
            time.sleep(0.01)
        return toks, picks, batcher.tenancy_status(), loop.queue._fairshare.snapshot()
    finally:
        asyncio.run(batcher.stop())


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("sampled", [False, True])
def test_loop_tokens_picks_and_status_match_jax(tmp_path, paged, sampled):
    env = {"MAX_STREAMS": "2", "MAX_STREAM_QUEUE": "16", "PAGED_KV": "1" if paged else "0",
           "TENANTS_FILE": _tenants_file(tmp_path / "t.json", [
               {"name": "acme", "weight": 3}, {"name": "bob", "weight": 1}])}
    (_, jbundle, _, jbatcher), (_, bundle, engine, batcher) = _services(env)
    want = _loop_case(jbatcher, jbundle, JaxRawItem, sampled)
    got = _loop_case(batcher, bundle, RawItem, sampled)
    toks, picks, status, loop_fs = got
    assert toks == want[0]
    assert picks == want[1]
    assert status == want[2]
    assert loop_fs == want[3]
    assert all(len(t) > 0 for t in toks)
    # Ten pops, each charged; while both had waiters acme took 3 of 4.
    assert {t: v["served"] for t, v in loop_fs.items()} == {"acme": 6, "bob": 2, "": 2}
    both = [p for e, p in picks if {"acme", "bob"} <= set(e) and p in ("acme", "bob")]
    assert both[:4].count("acme") == 3
    assert status["totals"] == {"active": 0, "kv_bytes": 0}
    # acme's window: each of its six requests' prompt and decode budget.
    assert status["tenants"]["acme"]["window_tokens"] == sum(
        int(bundle.preprocess(RawItem(text=f"request number {i}"))["length"]) + 8
        for i in (0, 2, 4, 5, 8, 9))
    if paged:
        assert engine.kv_pool.used_blocks == 0


# ---------------------------------------------------------------------------
# HTTP


def _tenant_series(text: str) -> dict:
    """The ``tenant_*`` samples of the app's model in a /metrics body
    ({line key: value}; the registries are process-wide, other tests add
    series of other models) and its HELP/TYPE lines (under key None); the
    counters' ``_created`` timestamps are the clock's and are left out."""
    out: dict = {None: set()}
    for line in text.splitlines():
        if line.startswith("# ") and " tenant_" in line:
            out[None].add(line)
        elif (line.startswith("tenant_") and "_created{" not in line
              and 'model="llama"' in line):
            key, _, value = line.rpartition(" ")
            out[key] = float(value)
    return out


def _delta(after: dict, before: dict) -> dict:
    """Counters as deltas (the registries are process-wide), gauges as
    they are."""
    return {k: (v - before.get(k, 0.0) if "_total" in k else v)
            for k, v in after.items() if k is not None}


async def _http_script(app, batcher):
    client = TestClient(TestServer(app))
    await client.start_server()
    gate = _Gate()
    loop = batcher._cdl
    loop._dispatch_chunk = gate.wrap(loop._dispatch_chunk)
    try:
        for _ in range(400):
            if (await client.get("/readyz")).status == 200:
                break
            await asyncio.sleep(0.05)
        before = _tenant_series(await (await client.get("/metrics")).text())
        acme = {"X-Api-Key": "key-acme"}
        out = []

        async def post(body, headers, path="/predict"):
            r = await client.post(path, json=body, headers=headers)
            text = await r.text()
            return r.status, r.headers.get("Retry-After"), text

        gate.hold()
        held = asyncio.ensure_future(post({"text": "a long prompt here", "stream": True}, acme))
        for _ in range(400):
            if loop._admitted == 1:
                break
            await asyncio.sleep(0.01)
        out.append((await post({"text": "hi"}, acme))[:2])
        out.append((await post({"text": "hi", "max_tokens": 4},
                               {"X-Api-Key": "key-bob"}))[:2])
        out.append((await post({"text": "hi"}, {"X-Adapter": "nope", **acme}))[:2])
        carol = {"X-Api-Key": "key-carol"}
        for _ in range(3):
            out.append((await post({"text": "hi", "max_tokens": 4}, carol))[:2])
        out.append((await post({"text": "hi", "max_tokens": 4}, {"X-Api-Key": "stranger"}))[:2])
        mid = (await (await client.get("/status")).json())["tenancy"]
        gate.release()
        status, _, body = await held
        out.append(status)
        assert body.strip().splitlines()[-1].startswith("{")
        for _ in range(400):
            ten = (await (await client.get("/status")).json())["tenancy"]
            if ten["totals"]["active"] == 0:
                break
            await asyncio.sleep(0.02)
        after = _tenant_series(await (await client.get("/metrics")).text())
        return out, mid, ten, _delta(after, before), after[None]
    finally:
        gate.release()
        await client.close()


def test_http_quota_429_and_status_tenancy_match_jax(tmp_path):
    """acme at max_concurrency=1 holds a stream; its second request is 429
    with Retry-After 1; bob is served; an unknown X-Adapter is 400; carol's
    token window takes two requests and answers the third 429 with the
    window's Retry-After; a stranger's key is anonymous.  Statuses,
    Retry-After, /status.tenancy while held and drained, and the tenant_*
    series equal the JAX app's."""
    cost = HI_IDS + 4  # carol's requests: "hi" and a budget of 4
    specs = [{"name": "acme", "weight": 3.0, "api_keys": ["key-acme"], "max_concurrency": 1},
             {"name": "bob", "api_keys": ["key-bob"]},
             {"name": "carol", "api_keys": ["key-carol"], "tokens_per_window": 2 * cost}]
    env = {"MAX_STREAMS": "2", "MAX_DECODE_LEN": "16", "STREAM_CHUNK_TOKENS": "2",
           "TENANTS_FILE": _tenants_file(tmp_path / "t.json", specs)}
    (jcfg, jbundle, jengine, jbatcher), (cfg, bundle, engine, batcher) = _services(env)
    want = asyncio.run(_http_script(jax_build_app(jcfg, jbundle, jengine, jbatcher), jbatcher))
    got = asyncio.run(_http_script(build_app(cfg, bundle, engine, batcher), batcher))
    out, mid, drained, series, helps = got
    assert out == want[0]
    assert out == [(429, "1"), (200, None), (400, None), (200, None), (200, None),
                   (429, "60"), (200, None), 200]
    assert mid == want[1]
    assert mid["totals"]["active"] == 1 and mid["tenants"]["acme"]["active"] == 1
    assert drained == want[2]
    assert drained["totals"] == {"active": 0, "kv_bytes": 0}
    assert drained["tenants"]["acme"]["sheds"] == 1 and drained["tenants"]["carol"]["sheds"] == 1
    assert series == want[3]
    assert helps == want[4]
    assert series['tenant_requests_shed_total{model="llama",reason="quota",tenant="acme"}'] == 1


# ---------------------------------------------------------------------------
# unset, and lease conservation


def test_tenancy_unset_builds_nothing():
    """No TENANTS, TENANTS_FILE or ADAPTER_DIR: no registry, no pool, no
    fair share on either queue, no /status block, no adapter rows in the
    loop, and the model carries no overlay."""
    os.environ["LLAMA_CONFIG"] = json.dumps(SMALL)
    try:
        _, bundle, engine, batcher = build_service({**SERVE, "PAGED_KV": "1"})
    finally:
        del os.environ["LLAMA_CONFIG"]
    loop = batcher._cdl
    try:
        assert batcher.tenants is None and batcher.adapters is None
        assert batcher.tenancy_status() is None
        assert batcher.admission.tenants is None
        assert loop.tenants is None and loop.adapters is None
        assert batcher._queue._fairshare is None and loop.queue._fairshare is None

        async def one():
            return await _tokens(batcher.submit_stream(bundle.preprocess(RawItem(text="hi"))))

        assert asyncio.run(one())
        assert loop._ad_rows is None and loop._wave_rows([]) is None
        assert lora.adapter_tables(engine.bundle.model) is None
    finally:
        asyncio.run(batcher.stop())


def _preempt_case(batcher, bundle, item_cls):
    """An acme batch-class stream holds the only slot; a bob interactive
    stream preempts it; both finish.  Returns the tokens, the ledger seen
    while acme waited checkpointed, and the ledger at the end."""
    loop = batcher._cdl
    gate = _Gate()
    loop._dispatch_chunk = gate.wrap(loop._dispatch_chunk)
    seen = []

    def watch(fn):
        def wrapped(st):
            fn(st)
            seen.append(batcher.tenants.totals())

        return wrapped

    loop._requeue_preempted = watch(loop._requeue_preempted)

    async def body():
        a = dict(bundle.preprocess(item_cls(text="the batch stream goes first", max_tokens=16)),
                 tenant="acme", priority="batch")
        b = dict(bundle.preprocess(item_cls(text="interactive", max_tokens=8)),
                 tenant="bob", priority="interactive")
        gate.hold()
        ga = batcher.submit_stream(a)
        ta = asyncio.ensure_future(_tokens(ga))
        for _ in range(400):
            if len(loop.active) == 1:
                break
            await asyncio.sleep(0.01)
        gb = batcher.submit_stream(b)
        tb = asyncio.ensure_future(_tokens(gb))
        for _ in range(400):
            if loop.queue.qsize() == 1:
                break
            await asyncio.sleep(0.01)
        gate.release()
        return await ta, await tb

    try:
        toks = asyncio.run(body())
        for _ in range(200):
            if batcher.tenants.totals()["active"] == 0:
                break
            time.sleep(0.01)
        return toks, loop.preemptions, seen, batcher.tenants.usage(), batcher.tenants.totals()
    finally:
        gate.release()
        asyncio.run(batcher.stop())


@pytest.mark.parametrize("paged", [False, True])
def test_lease_conserved_through_preemption_like_jax(tmp_path, paged):
    # Paged, a pool of more than one stream's worst case: bob's arrival must
    # not find it short (it would wait as batch instead of preempting).
    env = {"MAX_STREAMS": "1", "MAX_STREAM_QUEUE": "4", "PREEMPT": "1", "MAX_DECODE_LEN": "16",
           "PAGED_KV": "1" if paged else "0", "KV_BUDGET_MB": "1" if paged else "0",
           "TENANTS": "acme=3,bob"}
    (_, jbundle, _, jbatcher), (_, bundle, engine, batcher) = _services(env)
    want = _preempt_case(jbatcher, jbundle, JaxRawItem)
    got = _preempt_case(batcher, bundle, RawItem)
    assert got[0] == want[0] and got[1] == want[1] >= 1
    # The checkpoint returned acme's lease: only bob's was live.
    assert got[2] == want[2] and got[2][0]["active"] == 1
    assert got[3] == want[3] and got[4] == want[4] == {"active": 0, "kv_bytes": 0}
    if paged:
        assert engine.kv_pool.used_blocks == 0


def _recovery_case(batcher, bundle, item_cls):
    async def body():
        gens = [batcher.submit_stream(dict(bundle.preprocess(
            item_cls(text=f"recover me {i}", max_tokens=16)), tenant=t))
            for i, t in enumerate(("acme", "bob", "acme"))]
        return list(await asyncio.gather(*(_tokens(g) for g in gens)))

    try:
        toks = asyncio.run(body())
        for _ in range(200):
            if batcher.tenants.totals()["active"] == 0:
                break
            time.sleep(0.01)
        return (toks, batcher._cdl.supervisor.stats()["restarts"], batcher.tenants.usage(),
                batcher.tenants.totals())
    finally:
        asyncio.run(batcher.stop())


@pytest.mark.parametrize("paged", [False, True])
def test_lease_conserved_through_recovery_like_jax(paged):
    """A fatal fault at the second chunk: the supervisor checkpoints and
    requeues every stream (each lease returned, then charged again at its
    resume); the tokens, the restart and the drained ledger are the JAX
    service's."""
    env = {"MAX_STREAMS": "4", "MAX_DECODE_LEN": "16", "PAGED_KV": "1" if paged else "0",
           "TENANTS": "acme=3,bob", "FAULT_SPEC": "chunk:fatal@2"}
    (_, jbundle, _, jbatcher), (_, bundle, engine, batcher) = _services(env)
    want = _recovery_case(jbatcher, jbundle, JaxRawItem)
    got = _recovery_case(batcher, bundle, RawItem)
    assert got == want
    assert got[1] == 1 and got[3] == {"active": 0, "kv_bytes": 0}


async def _job_case(app, batcher):
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        for _ in range(400):
            if (await client.get("/readyz")).status == 200:
                break
            await asyncio.sleep(0.05)
        r = await client.post("/v1/batches", json={"lines": [{"text": f"bulk {i}",
                                                               "max_tokens": 4}
                                                              for i in range(3)]})
        jid = (await r.json())["id"]
        live = await client.post("/v1/completions", json={"prompt": "tenant work",
                                                          "max_tokens": 8},
                                 headers={"X-Api-Key": "acme"})
        completion = (live.status, (await live.json())["choices"][0]["text"])
        for _ in range(600):
            job = await (await client.get(f"/v1/batches/{jid}")).json()
            if job["status"] == "completed":
                break
            await asyncio.sleep(0.05)
        rows = (await (await client.get(f"/v1/batches/{jid}/results")).text()).splitlines()
        for _ in range(200):
            ten = (await (await client.get("/status")).json())["tenancy"]
            if ten["totals"]["active"] == 0:
                break
            await asyncio.sleep(0.02)
        return completion, job["status"], [json.loads(x)["text"] for x in rows], ten
    finally:
        await client.close()


def test_lease_conserved_through_a_job_line_like_jax(tmp_path):
    """A bulk job's lines (anonymous: the job store keeps no tenant) beside
    an acme request: the lines complete, the ledger drains, and
    /status.tenancy equals the JAX app's."""
    env = {"TENANTS": "acme=2", "JOBS_ENABLED": "1", "MAX_STREAMS": "4"}
    (jcfg, jbundle, jengine, jbatcher), (cfg, bundle, engine, batcher) = _services(
        env, {"JOURNAL_DIR": str(tmp_path / "jax")}, {"JOURNAL_DIR": str(tmp_path / "port")})
    want = asyncio.run(_job_case(jax_build_app(jcfg, jbundle, jengine, jbatcher), jbatcher))
    got = asyncio.run(_job_case(build_app(cfg, bundle, engine, batcher), batcher))
    assert got == want
    assert got[1] == "completed" and got[3]["totals"] == {"active": 0, "kv_bytes": 0}
