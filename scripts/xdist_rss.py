"""Peak resident memory of each pytest-xdist worker, per test file.

A pytest plugin and its report.  Loaded into a run, each process (every
xdist worker, or the one process without xdist) appends one JSON line per
finished test to ``$XDIST_RSS_DIR/<worker>.jsonl``: the test's file, the
process's ``VmHWM`` (peak resident set since it started) and ``VmRSS``
(resident now) in KiB, read from ``/proc/self/status``.  A line is written
as each test ends, so a worker that dies mid-run leaves its lines up to
the test before the one that killed it.

Run the suite's command with the plugin (the repo's root and ``scripts``
on ``PYTHONPATH``), then print the report::

    XDIST_RSS_DIR=/tmp/rss PYTHONPATH=.:scripts JAX_PLATFORMS=cpu \\
        python -m pytest tests/ -q -m 'not slow' -p xdist -n 6 --dist load -p xdist_rss
    python scripts/xdist_rss.py /tmp/rss

The report lists, per worker, its last test file and peak, and per test
file the largest peak any worker had when it finished a test of that file
and the largest growth of a worker's peak across one of its tests there.
Linux only (``/proc``); elsewhere the plugin records nothing.
"""

from __future__ import annotations

import json
import os
import sys


def _status_kib() -> dict:
    out = {}
    try:
        with open("/proc/self/status") as f:
            for line in f:
                key, _, rest = line.partition(":")
                if key in ("VmHWM", "VmRSS"):
                    out[key] = int(rest.split()[0])
    except OSError:
        pass
    return out


class _Recorder:
    def __init__(self, directory: str):
        worker = os.environ.get("PYTEST_XDIST_WORKER", "main")
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, f"{worker}.jsonl")
        self.worker = worker
        self.last_hwm = _status_kib().get("VmHWM", 0)

    def pytest_runtest_logfinish(self, nodeid, location):
        kib = _status_kib()
        if not kib:
            return
        hwm = kib.get("VmHWM", 0)
        line = {"w": self.worker, "file": nodeid.split("::")[0], "test": nodeid,
                "hwm_kib": hwm, "rss_kib": kib.get("VmRSS", 0),
                "grew_kib": max(0, hwm - self.last_hwm)}
        self.last_hwm = hwm
        with open(self.path, "a") as f:
            f.write(json.dumps(line) + "\n")


def pytest_configure(config):
    directory = os.environ.get("XDIST_RSS_DIR")
    if directory:
        config.pluginmanager.register(_Recorder(directory), "xdist_rss_recorder")


def report(directory: str) -> dict:
    """Per worker and per test file, from the JSON lines under
    ``directory``."""
    workers: dict = {}
    files: dict = {}
    for name in sorted(os.listdir(directory)):
        if not name.endswith(".jsonl"):
            continue
        with open(os.path.join(directory, name)) as f:
            lines = [json.loads(x) for x in f if x.strip()]
        if not lines:
            continue
        last = lines[-1]
        workers[name[:-6]] = {"tests": len(lines), "last_file": last["file"],
                              "last_test": last["test"],
                              "peak_gib": round(max(x["hwm_kib"] for x in lines) / 2**20, 3)}
        for x in lines:
            e = files.setdefault(x["file"], {"peak_gib": 0.0, "max_growth_gib": 0.0,
                                             "workers": set()})
            e["peak_gib"] = max(e["peak_gib"], round(x["hwm_kib"] / 2**20, 3))
            e["max_growth_gib"] = max(e["max_growth_gib"], round(x["grew_kib"] / 2**20, 3))
            e["workers"].add(x["w"])
    for e in files.values():
        e["workers"] = sorted(e["workers"])
    return {"workers": workers,
            "files": dict(sorted(files.items(), key=lambda kv: -kv[1]["max_growth_gib"]))}


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit("usage: python scripts/xdist_rss.py DIRECTORY")
    print(json.dumps(report(sys.argv[1]), indent=1))
