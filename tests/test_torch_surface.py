"""The port's public surface against the JAX package's, read with ``ast``.

Neither package is imported here: both are parsed from their sources.

- Every module of ``valkey_search_tpu/`` has a counterpart file in
  ``valkey_search_tpu_torch/`` at the same path, or at the one ``MODULES``
  names; ``__graft_entry__.py``'s counterpart is ``entry.py``.
- Every public name that a JAX module defines at its top level (function,
  class, assignment) is defined or imported at the top level of its
  counterpart, under the name ``RENAMES`` gives, unless ``EXEMPT`` names it
  with its reason. Names the JAX module only imports are not its own.
- Every public method of such a class (dunders included) is defined by the
  counterpart class.
- Every ``pl.pallas_call`` of ``valkey_search_tpu/ops/pallas_scan.py`` is
  named as ``valkey_search_tpu/ops/pallas_scan.py:<line>`` in
  ``chip_smoke.py``'s kernel list, so a new Pallas call site without a
  Hopper counterpart fails here.
"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = "valkey_search_tpu"
PORT = "valkey_search_tpu_torch"

# JAX module -> the port's counterpart, where the paths differ
MODULES = {
    "runtime/jaxinit.py": "runtime/device.py",
    "ops/pallas_scan.py": "ops/bucket_scan.py",
}
ENTRY = "__graft_entry__.py"  # at the repository root; the port's entry.py

# (JAX module, JAX name) -> the port's name
RENAMES = {
    ("ops/ivf.py", "IvfDeviceIndex"): "IvfIndex",
    # the Pallas kernels' plain jnp versions are the CUDA kernels' plain
    # torch versions
    ("ops/pallas_scan.py", "bucket_min_scan_reference"):
        "bucket_min_scan_plain",
    ("ops/pallas_scan.py", "bucket_min_scan_i8_packed_reference"):
        "bucket_min_scan_i8_packed_plain",
    ("ops/pallas_scan.py", "bucket_min_scan_i8_reference"):
        "bucket_min_scan_i8_plain",
}

_TILING = ("the Pallas kernels' grid-step constants: the Mosaic 128-lane "
           "tiling is a TPU mechanic the port does not carry over (the "
           "strided bucket layout stays only as the output contract; "
           "BUCKET and GROUP are kept)")

# (JAX module, JAX name) -> why the port has no counterpart (ROADMAP.md,
# "Not to port" and "Do not carry over TPU mechanics")
EXEMPT = {
    ("ops/ivf.py", "ivf_build_plan"):
        "it models the JAX build's live arrays against a 15.75 GiB v5e; the "
        "port sizes its working sets from torch.cuda.mem_get_info and reads "
        "its peak from torch.cuda.max_memory_allocated",
    ("ops/distance.py", "resolve_precision"):
        "every product in the port is fp32 with TF32 off, so no precision "
        "value changes a result",
    ("runtime/jaxinit.py", "init"):
        "runtime/jaxinit.py is not ported: its counterpart is "
        "runtime/device.py (set_device, get_device)",
    ("ops/pallas_scan.py", "BLOCK_N"): _TILING,
    ("ops/pallas_scan.py", "NBT"): _TILING,
    ("ops/pallas_scan.py", "OUT_W"): _TILING,
    ("ops/pallas_scan.py", "REVISIT"): _TILING,
}


def _jax_modules():
    out = []
    base = os.path.join(ROOT, JAX)
    for dirpath, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(dirpath, f), base))
    return sorted(out) + [ENTRY]


def _paths(rel):
    if rel == ENTRY:
        return os.path.join(ROOT, ENTRY), os.path.join(ROOT, PORT, "entry.py")
    return (os.path.join(ROOT, JAX, rel),
            os.path.join(ROOT, PORT, MODULES.get(rel, rel)))


def _top_statements(tree):
    """The module's top-level statements, those under a top-level ``if`` or
    ``try`` included."""
    out = []

    def walk(stmts):
        for s in stmts:
            if isinstance(s, (ast.If, ast.Try)):
                walk(s.body)
                walk(s.orelse)
                walk(getattr(s, "finalbody", []))
                for h in getattr(s, "handlers", []):
                    walk(h.body)
            else:
                out.append(s)

    walk(tree.body)
    return out


def _surface(path):
    """(names defined at the top level, names imported there, classes)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    defined, imported, classes = set(), set(), {}
    for s in _top_statements(tree):
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defined.add(s.name)
        elif isinstance(s, ast.ClassDef):
            defined.add(s.name)
            classes[s.name] = s
        elif isinstance(s, (ast.Assign, ast.AnnAssign)):
            targets = s.targets if isinstance(s, ast.Assign) else [s.target]
            for t in targets:
                defined.update(n.id for n in ast.walk(t)
                               if isinstance(n, ast.Name))
        elif isinstance(s, (ast.Import, ast.ImportFrom)):
            imported.update((a.asname or a.name).split(".")[0]
                            for a in s.names)
    return defined, imported, classes


def _public(name):
    return not name.startswith("_")


def _methods(cls):
    return {s.name for s in cls.body
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef))
            and (_public(s.name) or s.name.startswith("__"))}


def _missing(rel):
    """(public names the counterpart lacks, {class: methods it lacks})."""
    jpath, tpath = _paths(rel)
    jdef, _, jcls = _surface(jpath)
    tdef, timp, tcls = _surface(tpath)
    names, methods = [], {}
    for name in sorted(filter(_public, jdef)):
        if (rel, name) in EXEMPT:
            continue
        tname = RENAMES.get((rel, name), name)
        if tname not in tdef and tname not in timp:
            names.append(name)
        elif name in jcls and tname in tcls:
            lack = _methods(jcls[name]) - _methods(tcls[tname])
            if lack:
                methods[name] = sorted(lack)
    return names, methods


@pytest.mark.parametrize("rel", _jax_modules())
def test_module_has_its_counterpart_with_every_public_name(rel):
    jpath, tpath = _paths(rel)
    assert os.path.exists(tpath), f"{rel}: no counterpart {tpath}"
    names, methods = _missing(rel)
    assert not names, f"{rel}: the port lacks {names}"
    assert not methods, f"{rel}: the port's classes lack {methods}"


def test_every_rename_and_exemption_is_still_needed():
    """A stale entry would hide a later gap: each JAX name still exists, a
    renamed one exists in the port under its new name only, and an exempt
    one does not exist in the port at all."""
    for (rel, name), tname in RENAMES.items():
        jpath, tpath = _paths(rel)
        tdef = _surface(tpath)[0]
        assert name in _surface(jpath)[0], (rel, name)
        assert tname in tdef and name not in tdef, (rel, name, tname)
    for (rel, name), reason in EXEMPT.items():
        jpath, tpath = _paths(rel)
        tdef, timp, _ = _surface(tpath)
        assert name in _surface(jpath)[0], (rel, name)
        assert name not in tdef | timp, (rel, name)
        assert reason


def _pallas_call_lines():
    path = os.path.join(ROOT, JAX, "ops", "pallas_scan.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    return sorted(
        n.lineno for n in ast.walk(tree)
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
        and n.func.attr == "pallas_call"
        and isinstance(n.func.value, ast.Name) and n.func.value.id == "pl")


def test_every_pallas_call_is_named_in_chip_smokes_kernel_list():
    lines = _pallas_call_lines()
    assert len(lines) >= 4, lines
    path = os.path.join(ROOT, "chip_smoke.py")
    with open(path) as f:
        strings = {n.value for n in ast.walk(ast.parse(f.read(), path))
                   if isinstance(n, ast.Constant) and isinstance(n.value, str)}
    for line in lines:
        site = f"{JAX}/ops/pallas_scan.py:{line}"
        assert site in strings, f"{site} has no kernel in chip_smoke.py"


def test_no_other_jax_module_calls_pallas():
    for rel in _jax_modules():
        if rel == "ops/pallas_scan.py":
            continue
        with open(_paths(rel)[0]) as f:
            assert "pallas_call" not in f.read(), rel
