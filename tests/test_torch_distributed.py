"""Port parity of ``same_tpu_torch.parallel.distributed`` (torch.distributed
over gloo) against ``same_tpu.parallel.distributed``.

The single-process behaviour and the slicing are the twins of
tests/test_distributed.py. Two real processes then meet over gloo at a
localhost port, as tests/test_distributed_multiprocess.py runs the JAX
package's: a gather of small frames, and the multi-process window grid
(``sliding_window_matching(host_shard=True)``) on tests/test_torch_windows.py's
tissue, whose gathered rows must be the JAX package's single-process rows.
The workers import no jax.
"""

import json
import os
import socket
import subprocess
import sys

import pandas as pd

import same_tpu
import same_tpu_torch
from same_tpu_torch.parallel import distributed
from test_torch_windows import KEY, OPTIM, TYPES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT_S = 60
WORKER_TIMEOUT_S = 180


def test_init_distributed_single_process_is_noop(monkeypatch):
    for var in distributed.TORCHRUN_VARS:
        monkeypatch.delenv(var, raising=False)
    assert distributed.init_distributed() is False
    assert distributed.process_count() == 1 and distributed.process_index() == 0


def test_host_window_slice_single_process_covers_all():
    s = distributed.host_window_slice(7)
    assert (s.start, s.stop) == (0, 7)


def test_gather_matches_single_process_identity():
    df = pd.DataFrame({"a": [1, 2], "b": ["x", "y"]})
    out = distributed.gather_matches(df)
    pd.testing.assert_frame_equal(out, df)


def test_host_window_slice_balanced(monkeypatch):
    monkeypatch.setattr(distributed, "process_count", lambda: 3)
    sizes = []
    for p in range(3):
        monkeypatch.setattr(distributed, "process_index", lambda p=p: p)
        s = distributed.host_window_slice(10)
        sizes.append(s.stop - s.start)
    assert sum(sizes) == 10
    assert max(sizes) - min(sizes) <= 1


PRELUDE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import pandas as pd
from same_tpu_torch.parallel import distributed

pid, addr, args = int(sys.argv[2]), sys.argv[3], json.loads(sys.argv[4])
assert distributed.init_distributed(
    addr, 2, pid, timeout_s=args["group_timeout_s"]) is True
assert (distributed.process_index(), distributed.process_count()) == (pid, 2)
"""

GATHER_WORKER = PRELUDE + r"""
sl = distributed.host_window_slice(5)
assert (sl.start, sl.stop) == {0: (0, 2), 1: (2, 5)}[pid], (pid, sl)
local = pd.DataFrame({"window_id": list(range(sl.start, sl.stop)), "host": pid})
merged = distributed.gather_matches(local)
if pid == 0:
    assert merged is not None
    assert merged["window_id"].tolist() == [0, 1, 2, 3, 4]
    assert merged["host"].tolist() == [0, 0, 1, 1, 1]
    print("GATHER_OK", len(merged))
else:
    assert merged is None
assert "jax" not in sys.modules
distributed.dist.destroy_process_group()
"""

GRID_WORKER = PRELUDE + r"""
from same_tpu_torch import sliding_window_matching

ref_df, query_df = pd.read_pickle(args["tissue"])
local = sliding_window_matching(
    ref_df, query_df, commonCT=args["types"], optim_params=args["optim"],
    solver_params=dict(tpu_pipeline_windows=1), host_shard=True, verbose=True,
    device="cpu",
)
gathered = distributed.gather_matches(local)
if pid == 0:
    gathered.to_pickle(args["out"])
    print("GRID_OK", len(gathered))
else:
    assert gathered is None
assert "jax" not in sys.modules
distributed.dist.destroy_process_group()
"""


def _run_two(tmp_path, worker, args):
    """Run ``worker`` as ranks 0 and 1 of a gloo group; returns their output."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        addr = f"localhost:{s.getsockname()[1]}"
    script = tmp_path / "worker.py"
    script.write_text(worker)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    args = json.dumps(dict(args, group_timeout_s=GROUP_TIMEOUT_S))
    # Output to files, not pipes: a rank blocked on a full pipe that nobody
    # reads would hold its peer in the gather.
    logs = [tmp_path / f"rank{pid}.log" for pid in range(2)]
    procs = []
    try:
        for pid, log in enumerate(logs):
            with open(log, "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, str(script), REPO, str(pid), addr, args],
                    stdout=out, stderr=subprocess.STDOUT, env=env,
                ))
        for p in procs:
            p.wait(timeout=WORKER_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = [log.read_text() for log in logs]
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {pid} failed:\n{out[-3000:]}"
    return outs


def test_two_process_gather(tmp_path):
    outs = _run_two(tmp_path, GATHER_WORKER, {})
    assert "GATHER_OK 5" in outs[0]


def test_two_process_window_grid_is_the_jax_packages(tmp_path):
    """Two ranks each solve their block of the 2 x 2 grid on the CPU; the
    root's gathered frame holds the JAX package's single-process rows, row
    for row, before and after the uniqueness merge."""
    ref_df, query_df, _q, _gt, _e = same_tpu_torch.create_full_benchmark(seed=8899)
    tissue = tuple(
        df[(df["X"] < 9.9) & (df["Y"] < 9.9)].reset_index(drop=True)
        for df in (ref_df, query_df)
    )
    pd.to_pickle(tissue, tmp_path / "tissue.pkl")
    outs = _run_two(tmp_path, GRID_WORKER, {
        "tissue": str(tmp_path / "tissue.pkl"), "out": str(tmp_path / "gathered.pkl"),
        "types": TYPES, "optim": OPTIM,
    })
    assert "GRID_OK" in outs[0]
    owned = [line for out in outs for line in out.splitlines()
             if line.startswith("host_shard:")]
    assert owned == ["host_shard: process owns windows [0, 2) of 4",
                     "host_shard: process owns windows [2, 4) of 4"], owned

    gathered = pd.read_pickle(tmp_path / "gathered.pkl")
    want = same_tpu.sliding_window_matching(
        *tissue, commonCT=TYPES, optim_params=OPTIM,
        solver_params=dict(tpu_pipeline_windows=1), verbose=False,
    )
    assert gathered["window_id"].nunique() >= 3
    pd.testing.assert_frame_equal(
        gathered[KEY].reset_index(drop=True), want[KEY].reset_index(drop=True))
    merged = same_tpu_torch.merge_window_matches_unique_ref([gathered], cell_id_col="cell_idx")
    merged_want = same_tpu.merge_window_matches_unique_ref([want], cell_id_col="cell_idx")
    pd.testing.assert_frame_equal(
        merged[KEY].reset_index(drop=True), merged_want[KEY].reset_index(drop=True))
