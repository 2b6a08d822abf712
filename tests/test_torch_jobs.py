"""The bulk-job lane (``JOBS_ENABLED``; ``jobs/``, ``/v1/batches``) of the
port against the JAX package's, f32 on the CPU, on the small gpt2 of
``test_torch_durability.py`` (the same weights in both apps):

- The job store: a round trip, exactly-once results, idempotency keys, the
  terminal-state guard and the TTL, through both stores on the same calls;
  each package's store reads the other's segments.
- The backfill governor's targets and the admission's ``backfill_ok``
  gate, against the JAX classes.
- With ``JOBS_ENABLED`` unset nothing is built and the routes are absent;
  set without ``JOURNAL_DIR`` or on a non-generative model, the build
  refuses with the JAX messages.
- ``/v1/batches`` end to end: every line's result equals the interactive
  ``/v1/completions`` answer and the JAX app's job results; an idempotent
  retry, cancel, list and the 400s answer as the JAX app does.
- A job resumes from its last completed line: no completed line runs
  again (the stream submissions are counted), the rest match the JAX
  app's resume of the same store.
"""

import asyncio
import dataclasses
import json
import os
import shutil
import time

import pytest
from aiohttp.test_utils import TestClient, TestServer
from test_torch_durability import _app, _port, _reference

from test_torch_jax_cache import isolated_jax_cache  # noqa: F401
from mlmicroservicetemplate_tpu.jobs import store as jax_store
from mlmicroservicetemplate_tpu.scheduler.admission import AdmissionController as JaxAdmission
from mlmicroservicetemplate_tpu.scheduler.policy import BackfillGovernor as JaxGovernor
from mlmicroservicetemplate_tpu_torch.jobs import store as port_store
from mlmicroservicetemplate_tpu_torch.scheduler.admission import AdmissionController
from mlmicroservicetemplate_tpu_torch.scheduler.batcher import Batcher
from mlmicroservicetemplate_tpu_torch.scheduler.policy import BackfillGovernor

JOBS = dict(jobs_enabled=True, journal_fsync="off", job_max_concurrent_lines=2,
            max_stream_queue=4)


def _line(text: str, **kw) -> dict:
    return {"text": text, "temperature": 0.0, "top_k": 0, "top_p": 1.0, "seed": None,
            "max_tokens": None, "stop": [], **kw}


def _job_state(store) -> list:
    """Every job's key, lines, results, state and counts (no ids or
    clocks), in creation order."""
    return [(j.key, j.lines, dict(j.results), j.state, j.counts(), j.remaining(),
             j.done_at is not None) for j in store.list()]


def _store_script(mod, d: str) -> list:
    out = []
    store = mod.JobStore(d, fsync="off", model="t")
    job, created = store.create([_line("a"), _line("b", seed=3, temperature=0.5),
                                 _line("c")], key="k1")
    again, created2 = store.create([_line("x")], key="k1")
    out.append((created, created2, again is job, job.total, job.state))
    store.set_state(job.id, "running")
    out.append(store.line_done(job.id, 0, "r0", 4, "stop"))
    out.append(store.line_done(job.id, 2, "r2", 4, "length"))
    out.append(store.line_done(job.id, 0, "DIFFERENT", 9, "stop"))  # refused
    # An index past the manifest is recorded, as the reference records it
    # (replay drops it: ``_apply`` keeps only indices in range).
    out.append(store.line_done(job.id, 7, "nope", 1, "stop"))
    with pytest.raises(ValueError) as e:
        store.create([])
    out.append(str(e.value))
    with pytest.raises(ValueError) as e:
        store.create([_line("z")] * (mod.MAX_LINES + 1))
    out.append(str(e.value))
    store.close()
    store2 = mod.JobStore(d, fsync="off", model="t")
    out.append(_job_state(store2))
    store2.line_done(job.id, 1, "r1", 2, "stop", error="boom")
    store2.set_state(job.id, "completed")
    store2.set_state(job.id, "running")  # a terminal state never regresses
    out.append(_job_state(store2))
    out.append({k: v for k, v in store2.stats().items() if k != "dir"})
    store2.close()
    store3 = mod.JobStore(d, fsync="off", model="t", ttl_s=0.01)
    time.sleep(0.05)
    out.append((store3.sweep(), store3.get(job.id), "k1" in store3.by_key))
    store3.close()
    store4 = mod.JobStore(d, fsync="off", model="t", ttl_s=0.01)
    out.append(_job_state(store4))
    store4.close()
    return out


def test_job_store_roundtrip_exactly_once_and_ttl_like_jax(tmp_path):
    got = _store_script(port_store, str(tmp_path / "port"))
    want = _store_script(jax_store, str(tmp_path / "jax"))
    assert got == want
    assert got[0] == (True, False, True, 3, "queued") and got[1:5] == [True, True, False, True]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_job_store(tmp_path, writer):
    mods = {"port": port_store, "jax": jax_store}
    reader = "jax" if writer == "port" else "port"
    d = str(tmp_path / "jobs")
    store = mods[writer].JobStore(d, fsync="off", model="t")
    job, _ = store.create([_line("a"), _line("b")], key="kk")
    store.set_state(job.id, "running")
    store.line_done(job.id, 1, "r1", 3, "length")
    store.close()
    shutil.copytree(d, str(tmp_path / "copy"))
    got = mods[reader].JobStore(d, fsync="off", model="t")
    want = mods[writer].JobStore(str(tmp_path / "copy"), fsync="off", model="t")
    assert _job_state(got) == _job_state(want) and got.get(job.id).id == job.id
    assert got.by_key == want.by_key == {"kk": job.id}
    got.close()
    want.close()


def test_backfill_governor_and_admission_gate_like_jax():
    for cap in (1, 2, 3, 8, 256):
        for live in (False, True):
            for waiting in (False, True):
                assert (BackfillGovernor(cap).target(live, waiting)
                        == JaxGovernor(cap).target(live, waiting))
    assert [BackfillGovernor(8).target(*f) for f in
            ((False, False), (True, False), (True, True))] == [8, 4, 1]
    jengine, _ = _reference("gpt2")
    for kw in ({}, dict(paged_kv=True, kv_block_size=8), dict(kv_budget_mb=0.01)):
        cfg, engine = _port("gpt2", **kw)
        adm = AdmissionController(cfg, engine)
        ref = JaxAdmission(cfg, jengine) if not kw.get("paged_kv") else None
        assert adm.backfill_ok() and (ref is None or ref.backfill_ok())
        if engine.kv_pool is not None:
            # A dry pool: no headroom, the claim waits.
            ids = engine.kv_pool.alloc(engine.kv_pool.free_blocks)
            assert not adm.backfill_ok()
            engine.kv_pool.free(ids)
        adm.draining = True
        assert not adm.backfill_ok()


def test_jobs_disabled_default_builds_nothing(tmp_path):
    """JOBS_ENABLED unset: no JobManager and no /v1/batches route; set
    without JOURNAL_DIR, or on a model that does not generate, the build
    refuses with the JAX package's messages."""
    app, engine = _app("port", str(tmp_path / "j"))

    async def probe():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            return (await client.post("/v1/batches", json={"lines": ["x"]})).status
        finally:
            await client.close()

    assert asyncio.run(probe()) == 404
    cfg, engine = _port("gpt2")
    assert Batcher(engine, cfg).jobs is None
    with pytest.raises(ValueError, match="JOBS_ENABLED=1 requires JOURNAL_DIR"):
        Batcher(engine, dataclasses.replace(cfg, jobs_enabled=True))
    engine.bundle.kind = "text_classification"
    try:
        with pytest.raises(ValueError, match="requires a generative"):
            Batcher(engine, dataclasses.replace(cfg, jobs_enabled=True,
                                                journal_dir=str(tmp_path / "k")))
    finally:
        engine.bundle.kind = "seq2seq"


async def _ready(client) -> None:
    for _ in range(400):
        if (await client.get("/readyz")).status == 200:
            return
        await asyncio.sleep(0.05)
    raise RuntimeError("never ready")


async def _wait_job(client, jid: str, want: str = "completed", timeout: float = 60.0):
    deadline = time.monotonic() + timeout
    body = None
    while time.monotonic() < deadline:
        body = await (await client.get(f"/v1/batches/{jid}")).json()
        if body["status"] == want:
            return body
        await asyncio.sleep(0.05)
    raise AssertionError(f"job never reached {want}: {body}")


async def _results(client, jid: str) -> list[dict]:
    r = await client.get(f"/v1/batches/{jid}/results")
    assert r.status == 200
    return [json.loads(x) for x in (await r.text()).splitlines()]


PROMPTS = [f"bulk prompt number {i}" for i in range(5)]
BAD = [
    ("not-json\n", {"Content-Type": "application/x-ndjson"}),
    (json.dumps({"lines": []}), {"Content-Type": "application/json"}),
    (json.dumps({"nolines": 1}), {"Content-Type": "application/json"}),
    ("[1]\n", {"Content-Type": "application/x-ndjson"}),
    (json.dumps({"lines": [{"text": "ok"}, {"text": "x", "temperature": -1}]}),
     {"Content-Type": "application/json"}),
    (json.dumps({"lines": [{"text": ""}]}), {"Content-Type": "application/json"}),
    ("{bad json", {"Content-Type": "application/json"}),
]


async def _end_to_end(app):
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        await _ready(client)
        expected = []
        for p in PROMPTS:
            r = await client.post("/v1/completions", json={"prompt": p, "max_tokens": 8})
            assert r.status == 200
            expected.append((await r.json())["choices"][0]["text"])
        payload = "\n".join(json.dumps({"text": p, "max_tokens": 8}) for p in PROMPTS)
        headers = {"Content-Type": "application/x-ndjson", "Idempotency-Key": "same-key"}
        r = await client.post("/v1/batches", data=payload, headers=headers)
        first = (r.status, await r.json())
        r2 = await client.post("/v1/batches", data=payload, headers=headers)
        retry = (r2.status, (await r2.json())["id"] == first[1]["id"])
        final = await _wait_job(client, first[1]["id"])
        rows = await _results(client, first[1]["id"])
        listed = [j["id"] for j in (await (await client.get("/v1/batches")).json())["data"]]
        status = await (await client.get("/status")).json()
        r = await client.post("/v1/batches", json={
            "lines": [{"text": f"cancel me {i}"} for i in range(8)]})
        j2 = await r.json()
        cancelled = (await (await client.post(f"/v1/batches/{j2['id']}/cancel")).json())
        await asyncio.sleep(0.3)
        after = (await (await client.get(f"/v1/batches/{j2['id']}")).json())["status"]
        errors = [(await client.get("/v1/batches/nope")).status]
        for data, hdrs in BAD:
            r = await client.post("/v1/batches", data=data, headers=hdrs)
            errors.append((r.status, r.reason))
        return dict(expected=expected, first=(first[0], first[1]["line_counts"],
                                              first[1]["status"], first[1]["object"]),
                    retry=retry, final=(final["status"], final["line_counts"]),
                    rows=rows, listed=first[1]["id"] in listed,
                    jobs=status["jobs"], cancelled=(cancelled["status"], after),
                    errors=errors)
    finally:
        await client.close()


def test_job_api_end_to_end_like_jax(tmp_path):
    """Submit JSONL (with an idempotency key, retried), complete, results,
    list, cancel and the malformed bodies, on both apps: each line's
    result is the interactive answer of its prompt and the JAX app's."""
    got = want = None
    for kind in ("jax", "port"):
        app, _ = _app(kind, str(tmp_path / kind), **JOBS)
        out = asyncio.run(_end_to_end(app))
        if kind == "jax":
            want = out
        else:
            got = out
    assert [row["text"] for row in got["rows"]] == got["expected"]
    assert got["rows"] == want["rows"] and got["expected"] == want["expected"]
    for key in ("first", "retry", "final", "listed", "cancelled", "errors"):
        assert got[key] == want[key], key
    assert got["first"][0] == 201 and got["retry"] == (200, True)
    assert got["final"] == ("completed", {"total": 5, "completed": 5, "failed": 0})
    assert got["cancelled"] == ("cancelled", "cancelled")
    for key in set(want["jobs"]) - {"dir"}:
        assert got["jobs"][key] == want["jobs"][key], key
    assert set(got["jobs"]) == set(want["jobs"])


def test_job_resume_from_last_completed_line_like_jax(tmp_path):
    """A store the JAX package wrote, holding a half-done job: at startup
    each app resumes only the unfinished lines (the recorded ones come back
    verbatim and no stream is submitted for them); the lines that ran equal
    the JAX app's and the interactive answers."""
    prompts = [f"resume line {i}" for i in range(4)]
    src = str(tmp_path / "src" / "jobs")
    store = jax_store.JobStore(src, fsync="off", model="gpt2")
    job, _ = store.create([_line(p, max_tokens=8) for p in prompts])
    store.set_state(job.id, "running")
    store.line_done(job.id, 0, "SENTINEL-0", 3, "stop")
    store.line_done(job.id, 2, "SENTINEL-2", 3, "stop")
    store.close()
    outs = {}
    for kind in ("jax", "port"):
        jd = str(tmp_path / kind)
        shutil.copytree(src, os.path.join(jd, "jobs"))
        app, engine = _app(kind, jd, **JOBS)
        from mlmicroservicetemplate_tpu_torch.api.app import K_BATCHER
        submitted = []
        if kind == "port":
            batcher = app[K_BATCHER]
            submit = batcher.submit_stream

            def counted(feats, submit=submit):
                submitted.append(feats.get("input_ids").tolist())
                return submit(feats)

            batcher.submit_stream = counted

        async def body(app=app):
            client = TestClient(TestServer(app))
            await client.start_server()
            try:
                await _ready(client)
                final = await _wait_job(client, job.id)
                rows = {r["line"]: r for r in await _results(client, job.id)}
                st = await (await client.get("/status")).json()
                interactive = []
                for i in (1, 3):
                    r = await client.post("/v1/completions",
                                          json={"prompt": prompts[i], "max_tokens": 8})
                    interactive.append((await r.json())["choices"][0]["text"])
                return final["line_counts"], rows, st["jobs"]["replay"], interactive
            finally:
                await client.close()

        outs[kind] = asyncio.run(body())
        if kind == "port":
            assert len(submitted) == 2  # lines 1 and 3 only
    counts, rows, replay, interactive = outs["port"]
    assert outs["port"][:3] == outs["jax"][:3]
    assert counts == {"total": 4, "completed": 4, "failed": 0}
    assert replay == {"resumed": 1, "complete": 0, "failed": 0}
    assert rows[0]["text"] == "SENTINEL-0" and rows[2]["text"] == "SENTINEL-2"
    assert [rows[1]["text"], rows[3]["text"]] == interactive
