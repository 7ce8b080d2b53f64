"""Nothing under ``bench/`` imports JAX or the JAX package, by top-level
module names compared whole (the port's ``repro_torch`` starts with
``repro``), and the references import nothing of the program."""
import ast

import pytest

from bench.harness.spec import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(BENCH.rglob("*.py"))


def _top_levels(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not set(_top_levels(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_program(path):
    assert not set(_top_levels(path)) & (FORBIDDEN | {"repro_torch", "bench"})


def test_module_check_compares_whole_names():
    from bench.run import forbidden_modules

    assert forbidden_modules({"repro_torch": 1, "repro_torch.models": 1, "jaxtyping": 1}) == []
    assert forbidden_modules({"repro.models": 1, "jax": 1, "torch": 1}) == ["jax", "repro"]
