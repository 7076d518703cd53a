"""Nothing under bench/ imports JAX, the JAX package ``repro`` or the old
``benchmarks``, compared by whole top-level names (``repro_torch`` is not
``repro``), and the reference imports nothing of the program."""
import ast

import pytest

from bench.harness import manifest
from bench.run import FORBIDDEN, forbidden_modules

FILES = sorted(p for p in manifest.BENCH.rglob("*.py")
               if ".cache" not in p.parts)


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value.split(".")[0]


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(manifest.BENCH)))
def test_no_forbidden_import(path):
    assert not set(_imports(path)) & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted(
    (manifest.BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert set(_imports(path)) <= {"__future__", "numpy", "torch", "bench"}


def test_forbidden_modules_compares_whole_names():
    assert forbidden_modules(["repro_torch", "repro_torch.core",
                              "jaxtyping", "reprox"]) == []
    assert forbidden_modules(["repro.core", "jax", "flax.linen",
                              "benchmarks.conv_arith"]) == \
        ["benchmarks", "flax", "jax", "repro"]
