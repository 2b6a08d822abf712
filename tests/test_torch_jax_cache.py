"""Isolation of the port's tests from JAX's persistent compilation cache.

``mlmicroservicetemplate_tpu.runtime.device.enable_compilation_cache`` with
an explicit directory switches JAX's persistent cache on for the rest of the
process (the JAX package's ``tests/test_config.py`` does so, and never off
again), and under xdist a later test on the same worker then compiles the
JAX reference through that cache.  ``isolated_jax_cache`` is imported by
every port test module that runs the JAX package: each of its tests
compiles with the cache off, and the state that was there is put back
after it, so the JAX package's own tests see what they would have seen.

The same fixture drops JAX's in-memory caches when a test of another file
first takes it (``_clear_between_files``): under ``-n 6`` a worker that
kept every file's executables grew past 6 GB and died inside XLA's compile
more often than one that keeps one file's (``scripts/xdist_rss.py``)."""

import os

import pytest

import jax
import jax.numpy as jnp
from jax._src import compilation_cache

# The test file whose tests last took ``isolated_jax_cache`` in this process.
_last_file = [None]


def _clear_between_files() -> None:
    """Drop JAX's in-memory compilation and tracing caches when a test of
    another file first takes the fixture: each file builds its own JAX
    references, and a worker's resident memory then holds one file's
    executables, not every file's it ran before."""
    current = os.environ.get("PYTEST_CURRENT_TEST", "").split("::")[0]
    if current and current != _last_file[0]:
        if _last_file[0] is not None:
            jax.clear_caches()
        _last_file[0] = current


@pytest.fixture(autouse=True)
def isolated_jax_cache():
    _clear_between_files()
    old = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", None)
    compilation_cache.reset_cache()
    try:
        yield
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
        compilation_cache.reset_cache()


@pytest.fixture
def cache_left_on(tmp_path):
    """The state an earlier test leaves: the cache switched on, latched."""
    from mlmicroservicetemplate_tpu.runtime.device import enable_compilation_cache

    jax.config.update("jax_compilation_cache_dir", None)
    compilation_cache.reset_cache()
    assert enable_compilation_cache("cpu", str(tmp_path / "xla")) == str(tmp_path / "xla")
    jax.jit(lambda x: x + 1)(jnp.ones(3))
    yield tmp_path / "xla"
    jax.config.update("jax_compilation_cache_dir", None)
    compilation_cache.reset_cache()


def test_compiles_run_without_the_persistent_cache(isolated_jax_cache):
    assert jax.config.jax_compilation_cache_dir is None
    jax.jit(lambda x: x * 3)(jnp.ones(5))
    assert not compilation_cache.is_persistent_cache_enabled()


@pytest.mark.parametrize("n", [1, 2])
def test_the_state_left_behind_is_put_back(cache_left_on, n):
    """Entered and left under a cache another test switched on: off inside,
    the same directory after, and a compile inside writes nothing there."""
    before = sorted(p.name for p in cache_left_on.iterdir())
    fixture = isolated_jax_cache.__wrapped__()
    next(fixture)
    assert jax.config.jax_compilation_cache_dir is None
    jax.jit(lambda x: x * (n + 7))(jnp.ones(4))
    with pytest.raises(StopIteration):
        next(fixture)
    assert jax.config.jax_compilation_cache_dir == str(cache_left_on)
    assert sorted(p.name for p in cache_left_on.iterdir()) == before


def test_caches_clear_when_another_file_takes_the_fixture(monkeypatch):
    """``jax.clear_caches`` runs once when the file changes, not between
    tests of one file, and not for the first file a process sees."""
    calls = []
    monkeypatch.setattr(jax, "clear_caches", lambda: calls.append(1))
    saved = _last_file[0]
    try:
        _last_file[0] = None
        for path in ("tests/a.py", "tests/a.py", "tests/b.py", "tests/b.py", "tests/a.py"):
            monkeypatch.setenv("PYTEST_CURRENT_TEST", f"{path}::test_x (setup)")
            _clear_between_files()
        assert len(calls) == 2
    finally:
        _last_file[0] = saved
