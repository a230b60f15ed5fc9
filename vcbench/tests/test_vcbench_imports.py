"""What the benchmark runs is the port's: no module under vcbench/ imports
JAX or the JAX package, the reference imports nothing of the program, and
nothing reads the JAX package's TPU records or bench."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
JAX_NAMES = {"jax", "jaxlib", "flax", "alivevc_tpu"}
FILES = sorted(HERE.rglob("*.py"))


def imported_tops(path: Path) -> set:
    """Top-level names of every module the file imports, whole."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not imported_tops(path) & JAX_NAMES


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not imported_tops(path) & (JAX_NAMES | {"alivevc_tpu_torch", "program", "cell", "common"})


def test_whole_name_comparison():
    assert "alivevc_tpu_torch" not in JAX_NAMES
    import cell

    assert "alivevc_tpu" in cell.FORBIDDEN and "alivevc_tpu_torch" not in cell.FORBIDDEN


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_era_records(path):
    text = path.read_text()
    for name in ("bench.py", "BASELINE.json", "BENCH_r", "MULTICHIP_", "STREAMING_r03"):
        assert name not in text or path.name.startswith("test_vcbench_imports")
