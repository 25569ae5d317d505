"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level name (the port's name starts with the JAX package's); the
reference imports nothing of the program either."""

import ast
import subprocess
import sys
import types

import pytest

from vosbench import harness, manifest

SOURCES = sorted(p for p in manifest.HERE.rglob("*.py") if "__pycache__" not in p.parts)
REFERENCE = sorted((manifest.HERE / "reference").rglob("*.py"))


def _top_levels(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(manifest.ROOT)))
def test_source_imports_nothing_forbidden(path):
    bad = [(line, top) for line, top in _top_levels(path) if top in harness.FORBIDDEN]
    assert not bad, bad


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    bad = [(line, top) for line, top in _top_levels(path)
           if top in harness.FORBIDDEN or top == "rmnet_tpu_torch"]
    assert not bad, bad


def test_whole_name_comparison(monkeypatch):
    monkeypatch.setitem(sys.modules, "rmnet_tpu_torch_probe", types.ModuleType("probe"))
    monkeypatch.setitem(sys.modules, "jaxlike.sub", types.ModuleType("probe"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "rmnet_tpu.models", types.ModuleType("probe"))
    assert harness.forbidden_modules() == ["rmnet_tpu"]


def test_benchmark_modules_load_with_jax_blocked():
    """Import the harness, every driver and every metric reader, and the
    program they drive, with JAX made unimportable: nothing asks for it."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax'):\n"
        "    sys.modules[name] = None\n"
        "from vosbench import calibrate, harness, manifest, run\n"
        "import json\n"
        "for w in json.load(open('BENCHMARK.json'))['workloads']:\n"
        "    cell = manifest.cell(w['name'])\n"
        "    manifest.driver(cell.driver)\n"
        "import rmnet_tpu_torch.engine, rmnet_tpu_torch.train\n"
        "print(sorted(m for m in harness.forbidden_modules() if sys.modules[m] is not None))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
