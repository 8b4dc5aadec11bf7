"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program; names are compared whole at
the top level, so `repro_torch` is not `repro`."""
from __future__ import annotations

import ast
from pathlib import Path

from bench import harness

BENCH = Path(__file__).resolve().parents[1]


def top_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_whole_top_level_names():
    assert harness.forbidden_modules({"repro_torch", "repro_torch.core",
                                      "reprox", "numpy"}) == []
    assert harness.forbidden_modules({"repro.core", "repro_torch"}) == \
        ["repro"]
    assert harness.forbidden_modules({"jaxlib.xla_client", "flax"}) == \
        ["flax", "jaxlib"]


def test_no_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not top_imports(path) & set(harness.FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert "repro_torch" not in top_imports(path), path
