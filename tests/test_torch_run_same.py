"""Port parity: same_tpu_torch.run_same against same_tpu.run_same.

One small labeled window (an 8x8 jittered grid with two cell types and
their probability columns, built like __graft_entry__.py's example problem),
collapsed with greedy_triangle_collapse at MS=1, goes through both
packages' run_same. The repair budget lets HiGHS finish, so the outputs must
be identical: the matched (aligned_idx, ref_idx) pairs, triangle_violation,
the objective (to rel 1e-6) and the flip fraction.

The last test imports same_tpu_torch in a fresh interpreter where importing
jax fails, and solves a window there: the port never imports jax.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import same_tpu
import same_tpu_torch
from torch_parity import labeled_window, run_window


@pytest.fixture(scope="module")
def both():
    ref, qry = labeled_window()
    return run_window(same_tpu, ref, qry), run_window(same_tpu_torch, ref, qry)


def test_run_same_match_pairs_identical(both):
    (mj, _vj), (mt, _vt) = both
    assert len(mj) > 0.8 * 64
    pairs_j = list(zip(mj["aligned_idx"], mj["ref_idx"]))
    pairs_t = list(zip(mt["aligned_idx"], mt["ref_idx"]))
    assert pairs_t == pairs_j
    assert list(mt.columns) == list(mj.columns)


def test_run_same_violations_and_objective(both):
    (mj, vj), (mt, vt) = both
    np.testing.assert_array_equal(
        mt["triangle_violation"].to_numpy(), mj["triangle_violation"].to_numpy()
    )
    tj, tt = vj["tpu"], vt["tpu"]
    assert tt["objective"] == pytest.approx(tj["objective"], rel=1e-6)
    assert tt["flip_fraction"] == tj["flip_fraction"]
    assert tt["tear_rounds"] == tj["tear_rounds"]
    assert tt["auction_rounds_total"] == tj["auction_rounds_total"]
    # The window exercised the separation loop.
    assert tj["tear_rounds"] >= 2


def test_port_imports_no_jax(tmp_path):
    """same_tpu_torch imports and solves with jax made unimportable."""
    tests_dir = os.path.dirname(os.path.abspath(__file__))
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        f"sys.path[:0] = [{os.path.dirname(tests_dir)!r}, {tests_dir!r}]\n"
        "import numpy as np\n"
        "import same_tpu_torch\n"
        "from torch_parity import labeled_window, run_window\n"
        "ref, qry = labeled_window(n_side=6)\n"
        "m, v = run_window(same_tpu_torch, ref, qry)\n"
        "assert len(m) > 0 and np.isfinite(v['tpu']['objective'])\n"
        "loaded = [k for k, mod in sys.modules.items()\n"
        "          if (k == 'jax' or k.startswith(('jax.', 'jaxlib', 'same_tpu.')))\n"
        "          and mod is not None]\n"
        "assert not loaded, loaded\n"
        "print('OK', len(m))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path,
        env=dict(os.environ, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().startswith("OK")
