"""Drift check of the host modules the port copies from the JAX package.

``same_tpu`` cannot be imported without jax (its ``__init__`` reaches
``solver/tearing.py``), so ``same_tpu_torch`` carries copies of its jax-free
modules. This file reads both trees as text and imports neither package:

- the copies listed in ``IDENTICAL`` must stay byte-identical;
- the copies in ``PINNED`` differ from the original only where the port
  needs it (a docstring line, the ``device`` argument, the RBF written with
  scipy, the repair's spans and counters); each one's diff is pinned by its count of changed lines and a
  hash of them, and any other change fails with the diff printed;
- every public name of ``same_tpu`` and of its subpackages exists in
  ``same_tpu_torch``.

To change a pinned copy on purpose (or the original it follows), make the
edit, run ``python tests/test_torch_copies.py``, which prints each copy's
diff and its current pin, check that diff, and paste the pin into
``PINNED``.
"""

import ast
import difflib
import hashlib
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "same_tpu")
PORT_PKG = os.path.join(REPO, "same_tpu_torch")

IDENTICAL = (
    "eval", "geometry", "metacell", "warmstart", "utils/params", "utils/concurrency",
    "utils/native", "solver/milp_oracle", "viz",
)
# module: (changed lines, the first 16 hex digits of their sha256)
PINNED = {
    "candidates": (34, "0a4b7dd05df5fb2e"),
    "io": (2, "08309f4772d76b9d"),
    "mesh_checks": (2, "0a003e7261fe58bf"),
    "robustness": (2, "49d934c7529f7ca1"),
    "solver/repair": (425, "8032f8edb7bfd87a"),
    "synthetic": (16, "8d443238a302be2b"),
}
SUBPACKAGES = ("", "parallel", "ops", "solver", "models", "utils")


def _read(pkg, module):
    with open(os.path.join(pkg, module + ".py"), encoding="utf-8") as f:
        return f.read()


def _diff(module):
    """The unified diff of the original against the port's copy."""
    return list(difflib.unified_diff(
        _read(JAX_PKG, module).splitlines(), _read(PORT_PKG, module).splitlines(),
        f"same_tpu/{module}.py", f"same_tpu_torch/{module}.py", n=0, lineterm=""))


def _pin(diff):
    """(count, hash) of a diff's changed lines, ignoring their positions."""
    changed = [line for line in diff[2:] if line[:1] in "+-"]
    return len(changed), hashlib.sha256("\n".join(changed).encode()).hexdigest()[:16]


def test_identical_copies_stay_identical():
    drifted = {m: "\n".join(_diff(m)) for m in IDENTICAL
               if _read(JAX_PKG, m) != _read(PORT_PKG, m)}
    assert not drifted, "\n\n".join(drifted.values())


@pytest.mark.parametrize("module", sorted(PINNED))
def test_pinned_copies_differ_only_where_recorded(module):
    diff = _diff(module)
    assert _pin(diff) == PINNED[module], (
        f"{module}: pin {_pin(diff)}, recorded {PINNED[module]}; the diff:\n"
        + "\n".join(diff))


def _public_names(pkg, sub):
    """The public names of package ``pkg/sub``: its modules and subpackages,
    and the names its ``__init__`` lists in ``__all__`` or binds."""
    path = os.path.join(pkg, sub)
    names = {
        entry[:-3] if entry.endswith(".py") else entry
        for entry in os.listdir(path)
        if not entry.startswith("_") and (
            entry.endswith(".py")
            or os.path.isfile(os.path.join(path, entry, "__init__.py")))
    }
    with open(os.path.join(path, "__init__.py"), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.module == "__future__":
            continue
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Name) and target.id == "__all__":
                    names.update(ast.literal_eval(node.value))
                elif isinstance(target, ast.Name):
                    names.add(target.id)
    return {n for n in names if not n.startswith("_")}


def test_every_public_name_has_a_counterpart():
    missing = {}
    for sub in SUBPACKAGES:
        gone = _public_names(JAX_PKG, sub) - _public_names(PORT_PKG, sub)
        if gone:
            missing[sub or "(top level)"] = sorted(gone)
    assert not missing, missing


if __name__ == "__main__":
    for name in sorted(PINNED):
        d = _diff(name)
        print("\n".join(d))
        print(f"    {name!r}: {_pin(d)},\n")
