"""Import discipline of the PyTorch port: importing it pulls in neither
jax nor the JAX package (the way tests/test_no_torch.py pins the
reverse), no module of it or chip_smoke.py imports either, and importing
the attention op or the ring neither builds nor loads the CUDA library."""

import ast
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "mlmicroservicetemplate_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "mlmicroservicetemplate_tpu")


def _port_modules() -> list[str]:
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        parts = list(path.relative_to(REPO).with_suffix("").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_importing_the_port_loads_no_jax():
    check = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('OK')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", check], capture_output=True, text=True, cwd=REPO, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "OK" in out.stdout


def _imports(path: pathlib.Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


@pytest.mark.parametrize(
    "path",
    [*sorted(PORT.rglob("*.py")), REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_no_source_imports_jax_or_the_jax_package(path):
    bad = [n for n in _imports(path) if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_importing_attention_op_builds_nothing():
    """The kernel build module is not even imported until a CUDA tensor
    reaches the wrapper: neither importing the op and the model nor a CPU
    call touches it."""
    check = (
        "import sys, torch\n"
        "from mlmicroservicetemplate_tpu_torch.ops import attention\n"
        "import mlmicroservicetemplate_tpu_torch.models.registry\n"
        "q = torch.zeros(1, 32, 1, 64)\n"
        "attention.fused_attention(q, q, q, torch.ones(1, 32, dtype=torch.int32))\n"
        "assert 'mlmicroservicetemplate_tpu_torch.ops._build' not in sys.modules\n"
        "assert attention.fused_attention.launches == 0\n"
        "print('OK')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", check], capture_output=True, text=True, cwd=REPO, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "OK" in out.stdout


def test_port_modules_cover_the_parallel_package():
    mods = _port_modules()
    for name in ("parallel", "parallel.mesh", "parallel.ring"):
        assert f"mlmicroservicetemplate_tpu_torch.{name}" in mods, name


def test_port_modules_cover_the_image_slice_and_the_template():
    mods = _port_modules()
    for name in ("models.resnet", "api.registration", "__main__"):
        assert f"mlmicroservicetemplate_tpu_torch.{name}" in mods, name


def test_ring_on_the_cpu_builds_nothing():
    """A CPU ring (the plain hop) neither imports the build module nor
    counts a launch."""
    check = (
        "import sys, torch\n"
        "from mlmicroservicetemplate_tpu_torch.parallel import ring\n"
        "q = torch.zeros(1, 8, 1, 64)\n"
        "m = torch.ones(1, 8, dtype=torch.int32)\n"
        "ring.ring_attention(q.chunk(2, 1), q.chunk(2, 1), q.chunk(2, 1), m.chunk(2, 1))\n"
        "assert 'mlmicroservicetemplate_tpu_torch.ops._build' not in sys.modules\n"
        "assert ring.ring_hop.launches == 0\n"
        "print('OK')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", check], capture_output=True, text=True, cwd=REPO, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "OK" in out.stdout
