"""The port's lock-order detector (``utils/locktrace.py``) against the JAX
package's.

``LockTracer`` is driven directly, with stand-in locks and no patching of
``threading``, so no test process is left patched (the JAX package's
``tests/conftest.py`` installs its own detector under ``LOCKTRACE=1``): the
same acquisition, release and dispatch sequence gives the reference's
violations.  ``install`` and ``serve.build_service``'s ``auto_install`` run
in a subprocess: the patched factories trace ``Lock``, ``RLock`` and
``Condition``, and a small llama served through the continuous loop, whose
dispatches run under the engine's lock (registered with
``allow_across_dispatch``), leaves no violation.
"""

import os
import subprocess
import sys
import textwrap

import pytest

from mlmicroservicetemplate_tpu.utils import locktrace as jax_locktrace
from mlmicroservicetemplate_tpu_torch.utils import locktrace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Lock:
    """A stand-in for a traced lock: its name and the uid the tracer gave it."""

    def __init__(self, tracer, name: str):
        self._lt_name = name
        self._lt_uid = tracer.register(self)


def _run(mod, script):
    tracer = mod.LockTracer()
    locks = {name: _Lock(tracer, name) for name in ("a", "b", "c", "d")}
    for op, *args in script:
        if op == "acq":
            tracer.note_acquire(locks[args[0]])
        elif op == "rel":
            tracer.note_release(locks[args[0]])
        elif op == "allow":
            tracer.allow_across_dispatch(locks[args[0]])
        else:
            tracer.note_dispatch(args[0])
    return tracer.violation_list


SCRIPTS = {
    # a then b, later b then a: one inversion, reported once.
    "inversion": [("acq", "a"), ("acq", "b"), ("rel", "b"), ("rel", "a"),
                  ("acq", "b"), ("acq", "a"), ("rel", "a"), ("rel", "b"),
                  ("acq", "b"), ("acq", "a"), ("rel", "a"), ("rel", "b")],
    # a -> b -> c, then c -> a: the cycle through b is caught.
    "transitive": [("acq", "a"), ("acq", "b"), ("rel", "b"), ("rel", "a"),
                   ("acq", "b"), ("acq", "c"), ("rel", "c"), ("rel", "b"),
                   ("acq", "c"), ("acq", "a"), ("rel", "a"), ("rel", "c")],
    # Held across dispatches: flagged once a (lock, site), the allowed lock
    # never; a lock released before the dispatch is not held.
    "dispatch": [("allow", "d"), ("acq", "d"), ("acq", "a"), ("dispatch", "chunk"),
                 ("dispatch", "chunk"), ("dispatch", "fetch"), ("rel", "a"),
                 ("dispatch", "prefill"), ("rel", "d"), ("acq", "b"), ("rel", "b"),
                 ("dispatch", "chunk")],
    # Re-entry (an RLock's second level) makes no self-edge; releases out
    # of order are legal.
    "reentry": [("acq", "a"), ("acq", "a"), ("acq", "b"), ("rel", "a"), ("rel", "a"),
                ("rel", "b"), ("acq", "b"), ("acq", "c"), ("rel", "b"), ("rel", "c")],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_violations_equal_the_reference(name):
    got, want = _run(locktrace, SCRIPTS[name]), _run(jax_locktrace, SCRIPTS[name])
    assert got == want
    kinds = [v["kind"] for v in got]
    assert kinds == {"inversion": ["lock_order_inversion"],
                     "transitive": ["lock_order_inversion"],
                     "dispatch": ["held_across_dispatch"] * 2,
                     "reentry": []}[name]


def test_nothing_is_patched_without_the_knob():
    assert not locktrace.auto_install({"LOCKTRACE": "0"})
    assert not locktrace.auto_install({})
    assert locktrace.tracer() is None and not locktrace.is_active()
    assert locktrace.violations() == []
    locktrace.note_dispatch("chunk")  # a no-op off
    locktrace.allow_across_dispatch(object())


_SERVE = textwrap.dedent("""
    import asyncio, json, threading
    import numpy as np
    from mlmicroservicetemplate_tpu_torch.serve import build_service
    from mlmicroservicetemplate_tpu_torch.utils import locktrace

    small = dict(vocab_size=300, d_model=256, num_heads=4, num_kv_heads=2, num_layers=2,
                 d_ff=512, max_position=128)
    cfg, bundle, engine, batcher = build_service({
        "MODEL_NAME": "llama", "DEVICE": "cpu", "WARMUP": "0", "LOCKTRACE": "1",
        "LLAMA_CONFIG": json.dumps(small), "SEQ_BUCKETS": "16,32", "MAX_DECODE_LEN": "12",
        "STREAM_CHUNK_TOKENS": "4", "MAX_STREAMS": "2", "PAGED_KV": "1", "KV_BLOCK_SIZE": "8",
        "FAULT_SPEC": "chunk:transient@2", "DISPATCH_BACKOFF_S": "0.001"})
    assert locktrace.is_active() and threading.Lock is locktrace._TracedLock
    assert isinstance(engine._lock, locktrace._TracedLock)
    cond = threading.Condition()  # the RLock wrapper speaks the Condition protocol
    with cond:
        cond.wait(0.001)

    async def main():
        await batcher.start()
        try:
            async def read(ids):
                feats = {"input_ids": np.asarray(ids, np.int32), "length": np.int32(len(ids))}
                return [t async for c in batcher.submit_stream(feats) for t in c.tolist()]
            return await asyncio.gather(read(range(5, 14)), read(range(7, 27)))
        finally:
            await batcher.stop()

    rows = asyncio.run(main())
    assert [len(r) for r in rows] == [12, 12], rows
    assert engine.dispatch_counts["chunk"] > 0
    print(json.dumps(locktrace.violations()))
    locktrace.uninstall()
    assert threading.Lock is locktrace._REAL_LOCK and not locktrace.is_active()
""")


def test_serving_under_locktrace_leaves_no_violation():
    env = {k: v for k, v in os.environ.items() if k != "LOCKTRACE"}
    out = subprocess.run([sys.executable, "-c", _SERVE], cwd=REPO, env=env, timeout=240,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout[-2000:]
