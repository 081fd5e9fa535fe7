"""No module under ``wowbench/`` imports ``jax``, ``jaxlib``, ``flax`` or
the JAX package ``repro``, and ``reference.py`` imports nothing of the
program ``repro_torch``.  Names are compared whole, by the part before the
first dot, since ``repro_torch`` begins with ``repro``."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
MODULES = sorted(HERE.rglob("*.py"))


def top_imports(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


def test_the_scan_compares_whole_names(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import repro_torch.core\nfrom repro.core import x\n"
                 "import importlib\nimportlib.import_module('jax.numpy')\n")
    assert top_imports(p) == {"repro_torch", "repro", "importlib", "jax"}


@pytest.mark.parametrize("path", MODULES, ids=lambda p: p.name)
def test_no_jax_and_no_reference_package(path):
    assert not top_imports(path) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    found = top_imports(HERE / "reference.py")
    assert "repro_torch" not in found and not found & FORBIDDEN
    assert found <= {"__future__", "numpy", "torch"}
