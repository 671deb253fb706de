"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path: Path):
    """Top-level names of every import in ``path`` (relative imports
    resolved inside the benchmark)."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


SOURCES = sorted(p for p in BENCH.rglob("*.py")
                 if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax(path):
    names = set(imported(path))
    assert not names & FORBIDDEN, f"{path} imports {names & FORBIDDEN}"


REFERENCE = sorted((BENCH / "reference").glob("*.py"))


@pytest.mark.parametrize("path", REFERENCE, ids=[p.name for p in REFERENCE])
def test_reference_is_plain(path):
    names = set(imported(path))
    assert "repro_torch" not in names, f"{path} imports the program"
    assert names <= {"torch", "math", "dataclasses", "typing",
                     "__future__"}, names


def test_guard_compares_whole_names():
    from bench import run
    import sys
    assert "repro_torch" not in run.FORBIDDEN
    sys.modules.setdefault("repro_torch_like", None)
    assert "repro_torch_like" not in run.forbidden_modules()
