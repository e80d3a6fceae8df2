"""No run loads JAX or the JAX package; the reference loads nothing of the
program; the measurement path raises without a card."""

import ast
import os
import subprocess
import sys

from port_bench import guard, run, spec


def test_forbidden_names_are_compared_whole():
    assert guard.forbidden_loaded({"same_tpu_torch": 1, "same_tpu_torch.core": 1,
                                   "jaxtyping": 1, "numpy": 1}) == []
    assert guard.forbidden_loaded({"same_tpu.core": 1, "jax.numpy": 1,
                                   "jaxlib": 1, "flax.linen": 1}) == [
        "flax", "jax", "jaxlib", "same_tpu"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def _files(folder):
    for root, _dirs, names in os.walk(folder):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(root, n)


def test_no_file_imports_jax_or_the_jax_package():
    for path in _files(spec.HERE):
        assert not set(_imports(path)) & set(guard.FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    folder = os.path.join(spec.HERE, "reference")
    for path in _files(folder):
        assert "same_tpu_torch" not in set(_imports(path)), path
    code = ("import sys, port_bench.reference.window; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'same_tpu_torch', 'same_tpu', 'jax', 'torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, check=True).stdout
    assert out.strip() == "[]"


def test_run_raises_without_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        return  # this check is for a machine without a card
    rc = run.main(["--workload", "luad.dp25.window", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc == 3 and out == "" and "CUDA card" in err
