"""Port parity of ``same_tpu_torch.graft_entry`` against the root
``__graft_entry__.py``, on the CPU: the auction step's ``choice`` and the
multi-window dry run's summary line."""

import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import __graft_entry__ as graft_jax  # noqa: E402
from same_tpu_torch import graft_entry  # noqa: E402


def test_entry_choice_is_the_jax_packages():
    fn, args = graft_entry.entry(device="cpu")
    got = fn(*args)
    assert got.device.type == "cpu" and got.shape[0] == args[0].shape[0]
    jfn, jargs = graft_jax.entry()
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax.jit(jfn)(*jargs)))


def test_dryrun_multichip_prints_the_jax_packages_line(capsys):
    # Two windows: each JAX call of the vmapped loop compiles anew (4-13 s).
    # The JAX dry run asks for a CPU backend of 2 devices, which only takes
    # where none is up yet: bring up conftest.py's 8 first, as other tests
    # in this process need them.
    assert len(jax.devices()) == 8
    graft_entry.dryrun_multichip(2, device="cpu")
    got = capsys.readouterr().out
    graft_jax.dryrun_multichip(2)
    want = capsys.readouterr().out
    assert got.startswith("dryrun_multichip: 2 devices, ") and "flips" in got
    assert got == want


def test_twins_need_a_card_by_default(monkeypatch):
    """Neither twin falls back to the CPU (or a CPU mesh) on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="CUDA card"):
        graft_entry.dryrun_multichip(2)
