#!/usr/bin/env python3
"""Run ``chip_smoke.py`` under a sampling profiler of its main thread.

    python3 scripts/profile_chip_smoke.py [--out FILE] [chip_smoke arguments]

Every 50 ms a thread samples the main thread's stack.  The wall time is
attributed (a) to each chain of ``chip_smoke.py`` frames (function and
line, outermost first) and (b) inclusively to each function of the repo's
files.  Both go to ``--out`` (JSON, default ``smoke_profile.json``) when
the run ends; the smoke's own output and exit code are unchanged.  The
sampler holds the GIL for a few microseconds a sample, so host-bound
phases run about as fast as without it.
"""

import argparse
import collections
import json
import os
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

DT = 0.05


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="smoke_profile.json")
    args, rest = ap.parse_known_args()
    main_id = threading.get_ident()
    chains: collections.Counter = collections.Counter()
    inclusive: collections.Counter = collections.Counter()
    done = threading.Event()

    def sample() -> None:
        while not done.wait(DT):
            frame = sys._current_frames().get(main_id)
            chain, seen = [], set()
            while frame is not None:
                code = frame.f_code
                if code.co_filename.startswith(ROOT):
                    rel = os.path.relpath(code.co_filename, ROOT)
                    key = f"{rel}:{code.co_name}"
                    if key not in seen:
                        seen.add(key)
                        inclusive[key] += 1
                    if rel == "chip_smoke.py":
                        chain.append(f"{code.co_name}:{frame.f_lineno}")
                frame = frame.f_back
            chains[">".join(reversed(chain))] += 1

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    t0 = time.monotonic()
    try:
        rc = chip_smoke.main(rest)
    finally:
        done.set()
        sampler.join()
        with open(args.out, "w") as fh:
            json.dump({"wall_s": time.monotonic() - t0, "sample_s": DT,
                       "chains": [[k, n * DT] for k, n in chains.most_common()],
                       "inclusive": [[k, n * DT] for k, n in inclusive.most_common(300)]},
                      fh, indent=0)
    return rc


if __name__ == "__main__":
    sys.exit(main())
