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
        "assert registry.names() == ('dc_asgd', 'dc_s3gd', 'ssgd', "
        "'stale'), registry.names()\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")},
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_unported_names_raise_key_errors_naming_them():
    """Every name of the reference is ported now: an unknown name of any
    kind raises a KeyError naming it."""
    from repro_torch.core import registry
    for kind, name in ((registry.ALGORITHM, "async_ps"),
                       (registry.REDUCER, "ring_allreduce"),
                       (registry.STALENESS_POLICY, "bounded_delay"),
                       (registry.LOCAL_OPTIMIZER, "adagrad"),
                       (registry.COMPENSATOR, "taylor2")):
        with pytest.raises(KeyError, match=name):
            registry._lookup(kind, name)


@pytest.mark.parametrize("package", ["checkpoint", "cluster"])
def test_state_subpackages_are_covered_and_import_alone(package):
    """The checkpoint and elastic-membership subpackages are among the
    files checked above and import in a process where jax and repro
    cannot be imported."""
    files = {p.name for p in PORT_FILES
             if p.parent.name == package and p.parent.parent.name ==
             "repro_torch"}
    assert "__init__.py" in files and len(files) >= 2, files
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None\n"
            f"import repro_torch.{package} as m\n"
            "print(sorted(m.__all__))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")},
                         timeout=300)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("module", ["models.rglru", "models.ssm",
                                    "models.transformer",
                                    "configs.recurrentgemma_9b"])
def test_recurrent_family_modules_are_covered_and_import_alone(module):
    """The RG-LRU block, the chunked scan and the multi-stage model are
    among the files checked above and import in a process where jax and
    repro cannot be imported."""
    path = ROOT / "src" / "repro_torch" / (module.replace(".", "/") + ".py")
    assert path in PORT_FILES
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None\n"
            f"import repro_torch.{module} as m\n"
            "print(m.__name__)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")},
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == f"repro_torch.{module}"


@pytest.mark.parametrize("module", ["models.moe", "configs.olmoe_1b_7b",
                                    "configs.phi35_moe_42b",
                                    "configs.minicpm3_4b"])
def test_moe_and_mla_modules_are_covered_and_import_alone(module):
    """The MoE FFN and the three configs of the MoE and MLA slice are
    among the files checked above and import in a process where jax and
    repro cannot be imported."""
    path = ROOT / "src" / "repro_torch" / (module.replace(".", "/") + ".py")
    assert path in PORT_FILES
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None\n"
            f"import repro_torch.{module} as m\n"
            "print(m.__name__)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")},
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == f"repro_torch.{module}"


@pytest.mark.parametrize("module", ["configs.qwen2_vl_7b",
                                    "configs.whisper_large_v3",
                                    "models.layers", "models.attention",
                                    "models.cache", "serve.oneshot",
                                    "launch.serve", "launch.train"])
def test_vlm_and_encdec_modules_are_covered_and_import_alone(module):
    """The two configs of the vlm and encdec slice and the modules it
    changed (M-RoPE, sinusoidal positions, the plain MLP, cross-attention,
    the cross cache, one-shot serving with patches and frames, the
    launchers) are among the files checked above and import in a process
    where jax and repro cannot be imported."""
    path = ROOT / "src" / "repro_torch" / (module.replace(".", "/") + ".py")
    assert path in PORT_FILES
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None\n"
            f"import repro_torch.{module} as m\n"
            "print(m.__name__)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")},
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == f"repro_torch.{module}"


ANALYSIS = ("optrace", "roofline", "report", "autotune", "astlint", "lint")


@pytest.mark.parametrize("module", ANALYSIS)
def test_analysis_modules_are_covered_and_import_alone(module):
    """The analysis layer (op traces, the H100 roofline, the findings
    schema, the autotuner and both lint layers) is among the files checked
    above and imports, CLI included, in a process where jax and repro
    cannot be imported: it keeps its own copy of the reference's
    ``report`` rather than importing it."""
    path = ROOT / "src" / "repro_torch" / "analysis" / f"{module}.py"
    assert path in PORT_FILES
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None\n"
            f"import repro_torch.analysis.{module} as m\n"
            "assert 'jax' not in {k.split('.')[0] for k, v in "
            "sys.modules.items() if v is not None}\n"
            "print(m.__name__)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")},
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == f"repro_torch.analysis.{module}"


def test_kernels_and_algorithms_sit_below_the_analysis_layer():
    """The kernel wrappers, the algorithms and the pipeline carry their
    trace hooks from `repro_torch.instrument`, which imports only torch:
    importing them loads nothing of `repro_torch.analysis`."""
    path = ROOT / "src" / "repro_torch" / "instrument.py"
    assert path in PORT_FILES
    assert {m.split(".")[0] for m in _imported_modules(path)} <= {
        "__future__", "functools", "typing", "torch"}
    code = ("import sys, importlib\n"
            "for m in ('kernels.dc_update', 'kernels.compress', "
            "'kernels.paged_attention', 'kernels.flash_attention', "
            "'kernels.ssm_scan', 'core.dc_s3gd', 'core.ssgd', "
            "'parallel.pipeline', 'models.transformer', 'serve'):\n"
            "    importlib.import_module('repro_torch.' + m)\n"
            "bad = [k for k in sys.modules "
            "if k.startswith('repro_torch.analysis')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")},
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
