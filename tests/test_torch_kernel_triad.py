"""The port's kernel triad, read off the source (an AST walk; nothing
runs): every public CUDA binding ``*_cuda`` (or ``*_cuda_``, in place)
in ``src/repro_torch/kernels/*.py`` has

1. a wrapper in ``kernels/ops.py`` that calls it;
2. in that wrapper, outside its ``is_cuda`` branch, a call of a plain
   version that exists: a ``ref.*_ref`` of ``kernels/ref.py``, or
   ``_contend_device`` (the plain loop that the contention loop kernel
   replaces, handed ``ref.contention_event_ref``);
3. a ``tests/test_torch_*.py`` that names the wrapper.

This is the port's twin of the reference's triad rule
(``tools/reprolint/rules/kernels.py``), which sees only ``*_pallas``.
"""
import ast
import glob
import os
import re

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
KERNELS = os.path.join(HERE, "..", "src", "repro_torch", "kernels")
NOT_BINDINGS = ("ops.py", "ref.py", "build.py", "__init__.py")
#: the plain versions that are not a ``ref.*_ref``
PLAIN_ELSEWHERE = ("_contend_device",)


def _tree(path):
    with open(path) as f:
        return ast.parse(f.read(), path)


def _top_defs(tree):
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}


def _bindings():
    out = []
    for path in sorted(glob.glob(os.path.join(KERNELS, "*.py"))):
        if os.path.basename(path) in NOT_BINDINGS:
            continue
        for name in _top_defs(_tree(path)):
            if not name.startswith("_") and re.search(r"_cuda_?$", name):
                out.append((os.path.basename(path), name))
    return out


def _names(nodes):
    """Every name and attribute name used under ``nodes``."""
    seen = set()
    for node in nodes:
        for n in ast.walk(node):
            if isinstance(n, ast.Name):
                seen.add(n.id)
            elif isinstance(n, ast.Attribute):
                seen.add(n.attr)
    return seen


def _ref_calls(nodes):
    """``ref.X`` attributes used under ``nodes``, and the names listed in
    ``PLAIN_ELSEWHERE``."""
    out = set()
    for node in nodes:
        for n in ast.walk(node):
            if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name) \
                    and n.value.id == "ref":
                out.add(n.attr)
            elif isinstance(n, ast.Name) and n.id in PLAIN_ELSEWHERE:
                out.add(n.id)
    return out


def _outside_cuda_branch(fn):
    """The statements of ``fn`` that a CPU tensor can reach: everything
    but the body of an ``if ... is_cuda ...:`` (its ``else`` kept), or
    the body alone of an ``if not ... is_cuda:``."""
    kept = []

    def visit(stmts):
        for s in stmts:
            if isinstance(s, ast.If) and "is_cuda" in _names([s.test]):
                negated = isinstance(s.test, ast.UnaryOp) and \
                    isinstance(s.test.op, ast.Not)
                visit(s.body if negated else s.orelse)
            else:
                kept.append(s)
    visit(fn.body)
    return kept


OPS = _top_defs(_tree(os.path.join(KERNELS, "ops.py")))
REF = _top_defs(_tree(os.path.join(KERNELS, "ref.py")))
BINDINGS = _bindings()


def _wrappers(binding):
    return sorted(name for name, fn in OPS.items()
                  if binding in _names(fn.body))


def test_the_walk_sees_every_kernel_file():
    files = {f for f, _ in BINDINGS}
    assert files == {os.path.basename(p) for p in glob.glob(
        os.path.join(KERNELS, "*.py"))} - set(NOT_BINDINGS)
    assert ("token_sum.py", "token_sum_cuda") in BINDINGS
    assert len(BINDINGS) >= 12


@pytest.mark.parametrize("binding", [b for _, b in BINDINGS])
def test_binding_has_a_wrapper_a_plain_version_and_a_test(binding):
    wrappers = _wrappers(binding)
    assert wrappers, f"{binding}: no ops.py wrapper calls it"
    tests = {}
    for path in glob.glob(os.path.join(HERE, "test_torch_*.py")):
        if os.path.basename(path) == os.path.basename(__file__):
            continue
        with open(path) as f:
            tests[os.path.basename(path)] = f.read()
    for w in wrappers:
        plain = _ref_calls(_outside_cuda_branch(OPS[w]))
        assert plain, f"{binding}: its wrapper ops.{w} calls no plain " \
            "version outside its is_cuda branch"
        for name in plain:
            assert name in REF or name in PLAIN_ELSEWHERE, \
                f"ops.{w} calls ref.{name}, which ref.py does not define"
        assert any(name.endswith("_ref") or name in PLAIN_ELSEWHERE
                   for name in plain), (w, plain)
        assert any(re.search(rf"\b{w}\b", text) for text in tests.values()), \
            f"no tests/test_torch_*.py names ops.{w}"
