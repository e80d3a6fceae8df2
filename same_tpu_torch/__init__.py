"""SAME on PyTorch and CUDA: the port of ``same_tpu`` to an NVIDIA H100.

Cells are matched between serial tissue sections / modalities by a
capacity-constrained assignment over a kNN candidate graph with Delaunay
triangle-orientation ("space-tearing") penalties, solved by an
epsilon-scaling auction inside a cut-separation loop. This package keeps
the JAX package's public API, DataFrame contract and solver semantics; the
JAX package (``same_tpu``) stays the reference the port is tested against.

It imports ``torch`` and never ``jax``. The hot path of one window runs on
the first CUDA card through two hand-written Hopper kernels, built from
``csrc/`` at first use: ``auction_bid`` (the auction's bidding round) and
``tear_metrics`` (the tear round's flip test and regret). Without a card the
same code runs on the CPU through the kernels' plain PyTorch twins.
"""

from .core import finalize_window, prepare_window, run_same, solve_prepared
from .metacell import MetaCell, greedy_triangle_collapse
from .utils.params import init_gurobi_params, init_optim_params, init_solver_params

__version__ = "0.1.0"

__all__ = [
    "run_same",
    "prepare_window",
    "solve_prepared",
    "finalize_window",
    "greedy_triangle_collapse",
    "MetaCell",
    "init_optim_params",
    "init_solver_params",
    "init_gurobi_params",
]
