"""No module of the benchmark imports JAX or the JAX package, compared by
whole top-level name (the port's name begins with the JAX package's), and
the plain reference imports nothing of the program."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "bemstokes_tpu"}
SOURCES = sorted(HERE.rglob("*.py"))


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "id", getattr(node.func, "attr", "")) in (
            "__import__",
            "import_module",
        ):
            if node.args and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str):
                names.add(node.args[0].value.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(HERE)) for p in SOURCES])
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_the_scan_tells_the_port_from_the_jax_package(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import bemstokes_tpu_torch.ops\nfrom bemstokes_tpu.ops import x\n")
    assert top_level_imports(f) & FORBIDDEN == {"bemstokes_tpu"}


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert "bemstokes_tpu_torch" not in names and "stokesbench" not in names
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.level > 1:
            raise AssertionError(f"{path.name} imports from outside reference/")
