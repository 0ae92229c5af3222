"""The port stands alone: nothing under ``src/repro_torch`` nor
``chip_smoke.py`` imports jax or the JAX package ``repro``, and the port
imports in a process where jax cannot be imported at all."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_port_imports_with_jax_blocked():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
        "import repro_torch, pkgutil, importlib\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from repro_torch.core import registry\n"
        "assert registry.names() == ('dc_s3gd', 'stale'), registry.names()\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")},
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_unported_names_raise_key_errors_naming_them():
    from repro_torch.core import registry
    for kind, name in ((registry.ALGORITHM, "ssgd"),
                       (registry.REDUCER, "gossip"),
                       (registry.REDUCER, "topk"),
                       (registry.STALENESS_POLICY, "dynamic_ssp"),
                       (registry.LOCAL_OPTIMIZER, "nesterov")):
        with pytest.raises(KeyError, match=name):
            registry._lookup(kind, name)
