"""Builds the package's CUDA sources (``csrc/*.cu``) at first use.

Each source becomes one shared library with a plain C interface, compiled
by ``nvcc`` for Hopper (``sm_90a``) and loaded with ``ctypes``; PyTorch's
headers are never included, so a build takes seconds, not minutes.  The
libraries go into ``build/torch_kernels/`` beside the package, named by a
hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is reused.

Nothing here runs at import: the CPU tests import every module of the
package on machines that have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # registers, shared memory and spills of every kernel, kept in the
    # build log beside the library
    "-Xptxas=-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


@dataclass(frozen=True)
class Built:
    name: str
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str  # nvcc's output (ptxas resource usage)


def sources() -> list[str]:
    """Names of every kernel source, ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA toolkit is "
            "needed to build the package's kernels"
        )
    return str(path)


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: list[str] | None = None) -> list[Built]:
    """Compile the named sources (default: all), one ``nvcc`` per source,
    all started together.  Raises with nvcc's output if any fails."""
    names = sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    done: list[Built] = []
    running = []
    for name in names:
        out = library_path(name)
        if out.exists():
            log_path = out.with_suffix(".log")
            log = log_path.read_text() if log_path.exists() else ""
            done.append(Built(name, out, 0.0, log))
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running.append((name, out, tmp, proc, time.monotonic()))
    failures = []
    for name, out, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        seconds = time.monotonic() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed on {name}.cu (rc {proc.returncode}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
        done.append(Built(name, out, seconds, log))
    if failures:
        raise RuntimeError("\n".join(failures))
    return done


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            (built,) = build([name])
            lib = ctypes.CDLL(str(built.path))
            _loaded[name] = lib
        return lib
