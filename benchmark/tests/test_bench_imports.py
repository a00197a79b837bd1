"""Nothing the benchmark runs imports JAX or the JAX package; the reference
imports nothing of the program; the load processes carry neither torch nor
the program. Top-level names are compared whole: valkey_search_tpu_torch
begins with valkey_search_tpu."""

import ast
import os

import pytest

from benchmark import spec

FOREIGN = {"jax", "jaxlib", "flax", "valkey_search_tpu"}
PORT = "valkey_search_tpu_torch"


def sources():
    for root, _, names in os.walk(spec.HERE):
        for n in sorted(names):
            if n.endswith(".py"):
                yield os.path.join(root, n)


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", list(sources()),
                         ids=lambda p: os.path.relpath(p, spec.HERE))
def test_no_jax(path):
    assert not top_level_imports(path) & FOREIGN


def test_the_reference_imports_nothing_of_the_program():
    names = top_level_imports(os.path.join(spec.HERE, "reference.py"))
    assert PORT not in names and not names & FOREIGN


@pytest.mark.parametrize("name", ["loadgen.py", "resp_client.py"])
def test_the_load_carries_neither_torch_nor_the_program(name):
    names = top_level_imports(os.path.join(spec.HERE, name))
    assert names <= {"__future__", "json", "os", "random", "selectors",
                     "socket", "sys", "time", "benchmark"}


def test_the_scan_sees_a_planted_import(tmp_path):
    p = tmp_path / "x.py"
    p.write_text("import jax.numpy as jnp\nfrom valkey_search_tpu.ops import"
                 " x\nimport valkey_search_tpu_torch\n")
    assert top_level_imports(str(p)) & FOREIGN == {"jax",
                                                   "valkey_search_tpu"}
