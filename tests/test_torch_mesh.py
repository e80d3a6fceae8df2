"""The port's default mesh is the CUDA cards: without one, ``make_mesh`` and
the batched entry points given no mesh raise.

With ``torch.cuda.is_available`` patched to False, so that the test means the
same on a machine with a card. The batched path's parity with the JAX package
is in tests/test_torch_parallel.py.
"""

import pytest
import torch

from same_tpu_torch import parallel
from test_parallel import _problem


@pytest.mark.parametrize("call", [
    lambda: parallel.make_mesh(),
    lambda: parallel.solve_windows_sharded([], mesh=None),
    lambda: parallel.solve_window_batch([_problem(0)[0]], mesh=None),
])
def test_default_mesh_needs_card(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        call()
