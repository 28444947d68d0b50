"""Import hygiene: nothing the benchmark runs imports JAX, jaxlib, flax
or the JAX package (``repro``, compared by whole top-level name, since
the port's ``repro_torch`` begins with it); the plain references import
nothing of the program."""
import ast
from pathlib import Path

from bench import manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    files = sorted(manifest.BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not imported_roots(f) & FORBIDDEN, f


def test_the_references_import_nothing_of_the_program():
    for f in sorted((manifest.BENCH / "ref").glob("*.py")):
        roots = imported_roots(f)
        assert "repro_torch" not in roots, f
        assert roots <= {"__future__", "math", "re", "numpy", "torch"}, \
            (f, roots)
    # the comparison itself reads the references and torch/numpy only
    assert imported_roots(manifest.BENCH / "check.py") <= {
        "__future__", "contextlib", "numpy", "torch"}
