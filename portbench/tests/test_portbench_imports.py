"""Nothing under portbench/ pulls in JAX, its libraries or the JAX
package (top-level names compared whole: the port's name begins with the
JAX package's), and the plain reference pulls in nothing of the port."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from portbench.harness import FORBIDDEN, REPO, ROOT

FILES = sorted(p for p in ROOT.rglob("*.py") if "__pycache__" not in p.parts)


def _imported(path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not _imported(path) & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((ROOT / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "vqgan_tpu_torch" not in _imported(path)


def _loaded_after(code: str) -> list:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split("
         "'.')[0] for m in sys.modules}))"],
        cwd=REPO, capture_output=True, text=True, check=True)
    return eval(out.stdout.strip().splitlines()[-1])


def test_the_harness_loads_no_forbidden_module():
    """Every module of the benchmark, the drivers and their program
    imports included (the drivers import the port when they run; here its
    modules that they name)."""
    code = "\n".join([
        "import importlib, pkgutil, portbench",
        "for m in pkgutil.walk_packages(portbench.__path__, 'portbench.'):",
        "    if '.tests' not in m.name: importlib.import_module(m.name)",
        "import vqgan_tpu_torch.training.vqgan_trainer",
        "import vqgan_tpu_torch.training.ldm_trainer",
        "import vqgan_tpu_torch.generate",
    ])
    loaded = _loaded_after(code)
    assert not set(loaded) & set(FORBIDDEN)
    assert "vqgan_tpu_torch" in loaded


def test_the_reference_loads_nothing_of_the_port():
    loaded = _loaded_after("import portbench.reference.vqgan, "
                           "portbench.reference.ldm, portbench.weights, "
                           "portbench.work")
    assert "vqgan_tpu_torch" not in loaded
    assert not set(loaded) & set(FORBIDDEN)
