"""Nothing under portbench imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's),
and the reference imports nothing of the port."""

import ast
from pathlib import Path

import pytest

BASE = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "tracer_tpu"}
FILES = sorted(BASE.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BASE)))
def test_no_jax(path):
    assert not top_level_imports(path) & JAX
    if path != Path(__file__).resolve():   # nothing reads the JAX bench
        assert "bench.py" not in path.read_text()
        assert "benchmarks/" not in path.read_text()


@pytest.mark.parametrize("path", sorted((BASE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_independent_of_the_port(path):
    assert not top_level_imports(path) & (JAX | {"tracer_tpu_torch"})


def test_the_scan_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import tracer_tpu_torch.ops\nfrom jax import numpy\n")
    assert top_level_imports(f) == {"tracer_tpu_torch", "jax"}
