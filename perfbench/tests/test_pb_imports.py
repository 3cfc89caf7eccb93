"""Nothing the benchmark runs imports JAX, the JAX package or the
program's own benchmark module: the sources' imports, and the run-time
check by whole top-level names (the port's name begins with the JAX
package's)."""

import ast
import sys

from perfbench import harness

BANNED = {"jax", "jaxlib", "flax", "spalign_tpu"}


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_sources_import_nothing_banned():
    for path in harness.HERE.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in BANNED, (path, name)
            assert name != "spalign_tpu_torch.bench", (path, name)


def test_runtime_check_whole_names(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "spalign_tpu_torch_extra", object())
    assert "spalign_tpu_torch_extra" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "spalign_tpu.ops", object())
    assert "spalign_tpu" in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "spalign_tpu_torch.bench", object())
    assert "spalign_tpu_torch.bench" in harness.forbidden_modules()
