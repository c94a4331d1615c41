"""Nothing under rtbench/ imports JAX or the JAX package, and the plain
reference imports nothing of the program.  Top-level module names are
compared whole: ``cudaraytracer_tpu_torch`` is not ``cudaraytracer_tpu``."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "cudaraytracer_tpu"}
PROGRAM = "cudaraytracer_tpu_torch"


def top_level_imports(path: Path) -> set:
    """Top-level names of every absolute import in a file."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".", 1)[0])
    return names


def sources():
    return sorted(HERE.rglob("*.py"))


def test_the_walk_sees_every_module():
    names = {p.relative_to(HERE).as_posix() for p in sources()}
    assert {"harness.py", "run.py", "reference/tracer.py",
            "drivers/render.py"} <= names


@pytest.mark.parametrize("path", sources(),
                         ids=lambda p: p.relative_to(HERE).as_posix())
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert PROGRAM not in names
    assert "rtbench" not in names       # nor the harness, which does


def test_names_are_compared_whole(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import cudaraytracer_tpu_torch.ops\n"
                 "from cudaraytracer_tpu_torch import config\n")
    assert not top_level_imports(f) & FORBIDDEN
    f.write_text("from cudaraytracer_tpu.ops import render\n")
    assert top_level_imports(f) & FORBIDDEN
