"""The port stands alone: no JAX and nothing of rmnet_tpu in rmnet_tpu_torch/,
chip_smoke.py, chip_bwd_probe.py or the card's test file (which runs where
JAX is not installed), checked on the source (ast) and on an import with JAX
made unimportable."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "rmnet_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "chip_bwd_probe.py",
    ROOT / "tests" / "test_torch_kernels_gpu.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "optax") or top == "rmnet_tpu"


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax_and_no_rmnet_tpu(path):
    bad = [f"{path.name}:{line} imports {mod}" for line, mod in _imports(path)
           if _forbidden(mod)]
    assert not bad, bad


def test_sources_found():
    names = {p.name for p in SOURCES}
    assert {"engine.py", "train.py", "flash_attention.py", "losses.py", "rmnet.py",
            "chip_smoke.py"} <= names
    kernels = {p.name for p in (ROOT / "rmnet_tpu_torch" / "csrc").glob("*.cu")}
    assert {"flash_read_fwd.cu", "flash_read_bwd.cu"} <= kernels


def test_import_with_jax_blocked():
    """Import every module of the port with ``sys.modules['jax'] = None``
    (any ``import jax`` then raises) and list what of rmnet_tpu got loaded."""
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in (ROOT / "rmnet_tpu_torch").rglob("*.py"))
    code = (
        "import importlib, sys\n"
        "for name in ('jax', 'jaxlib', 'flax'):\n"
        "    sys.modules[name] = None\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "print(sorted(m for m in sys.modules if m == 'rmnet_tpu' "
        "or m.startswith('rmnet_tpu.')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
