"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
torch and numpy, never jax, nothing of the JAX package ``repro`` and
nothing of its ``benchmarks``."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_file_imports_neither_jax_nor_repro(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "benchmarks"), (path,
                                                                     name)
    text = path.read_text()
    assert "importlib" not in text and "__import__" not in text, path


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.serve, "
            "repro_torch.launch.serve, repro_torch.models.weights, "
            "repro_torch.train, repro_torch.launch.train, "
            "repro_torch.analysis, repro_torch.analysis.sweep, "
            "repro_torch.roofline, repro_torch.configs.shapes, "
            "repro_torch.optim.compression, repro_torch.runtime.elastic; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); "
            "assert not bad, bad; print('clean')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
