"""Nothing the benchmark runs loads JAX or the JAX package; the yardstick
(the reference, the counts and the peaks) loads nothing of the program.
Top-level module names are compared whole: the program's name begins with
the JAX package's."""

import ast

import pytest

from benchmark.harness import common

FORBIDDEN = {"jax", "jaxlib", "flax", "srgan_tpu"}
YARDSTICK = ("reference",)
FILES = sorted(p for p in common.BENCH_DIR.rglob("*.py")
               if "__pycache__" not in p.parts)


def imported(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(common.BENCH_DIR))
                              for p in FILES])
def test_no_jax_and_a_free_yardstick(path):
    names = imported(path)
    assert not names & FORBIDDEN, names & FORBIDDEN
    rel = path.relative_to(common.BENCH_DIR).parts
    if rel[0] in YARDSTICK:
        assert "srgan_tpu_torch" not in names


def test_the_walk_sees_the_imports():
    assert "srgan_tpu_torch" in imported(common.BENCH_DIR / "harness"
                                         / "train.py")
    assert len(FILES) > 20
