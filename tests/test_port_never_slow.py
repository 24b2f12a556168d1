"""The port's tests stay in tier 1: no test in a `tests/test_torch_*.py`
file carries the `slow` mark (pytest.ini). Read from the files' source, so
this imports neither jax nor torch."""

import ast
from pathlib import Path

PORT_TEST_FILES = sorted(Path(__file__).parent.glob("test_torch_*.py"))


def _slow_marked(tree):
    """Names of the test functions and classes (or `<module>`) under which
    `<...>.mark.slow` appears: decorators, `pytestmark`, `pytest.param`."""
    found = []

    def visit(node, owner):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            owner = node.name
        if (isinstance(node, ast.Attribute) and node.attr == "slow"
                and isinstance(node.value, ast.Attribute)
                and node.value.attr == "mark"):
            found.append(owner)
        for child in ast.iter_child_nodes(node):
            visit(child, owner)

    visit(tree, "<module>")
    return found


def test_no_port_test_is_slow():
    assert _slow_marked(ast.parse(
        "import pytest\n@pytest.mark.slow\ndef test_x(): pass")) == ["test_x"]
    assert PORT_TEST_FILES
    marked = [f"{path.name}::{name}" for path in PORT_TEST_FILES
              for name in _slow_marked(ast.parse(path.read_text()))]
    assert not marked, f"port tests marked slow: {marked}"
