"""SAME on PyTorch and CUDA: the port of ``same_tpu`` to an NVIDIA H100.

Cells are matched between serial tissue sections / modalities by a
capacity-constrained assignment over a kNN candidate graph with Delaunay
triangle-orientation ("space-tearing") penalties, solved by an
epsilon-scaling auction inside a cut-separation loop. This package keeps
the JAX package's public API, DataFrame contract and solver semantics; the
JAX package (``same_tpu``) stays the reference the port is tested against.

It imports ``torch`` and never ``jax``. The hot path of a window runs on
the first CUDA card through hand-written Hopper kernels, built from
``csrc/`` at first use: ``auction_loop`` (one whole auction solve per
persistent launch) and ``tear_metrics`` (the tear round's flip test and
regret), and where a window selects them ``radius_knn`` (the device kNN)
and ``sinkhorn_sparse`` (the Sinkhorn warm start). A tissue larger than one
window goes through ``sliding_window_matching``; with
``mesh=parallel.make_mesh()`` its windows are solved as batches
(``auction_loop_batch`` and ``tear_metrics_batch``). The entry points need a
card unless they are given ``device="cpu"``, which runs the kernels' plain
PyTorch versions.
"""

from . import parallel
from .candidates import (
    find_knn_with_cell_type_priority,
    find_knn_within_radius,
    preprocess_data,
)
from .core import finalize_window, prepare_window, run_same, solve_prepared
from .eval import (
    check_alignment,
    check_triangle_violations,
    print_violation_report,
    topk_type_match,
    verify_spatial_preservation,
)
from .geometry import calculate_signed_area, signed_area_terms
from .io import load_matching_results
from .metacell import MetaCell, greedy_triangle_collapse, unpack_metacell_matches
from .robustness import add_dirichlet_mixture_noise
from .synthetic import create_full_benchmark
from .utils.params import init_gurobi_params, init_optim_params, init_solver_params
from .windows import (
    get_unprocessed_windows,
    merge_window_matches_unique_ref,
    sliding_window_matching,
    subset_data,
)

__version__ = "0.1.0"

__all__ = [
    "init_gurobi_params",
    "init_optim_params",
    "sliding_window_matching",
    "run_same",
    "merge_window_matches_unique_ref",
    "MetaCell",
    "greedy_triangle_collapse",
    "unpack_metacell_matches",
    "init_solver_params",
    "find_knn_within_radius",
    "find_knn_with_cell_type_priority",
    "check_alignment",
    "check_triangle_violations",
    "topk_type_match",
    "verify_spatial_preservation",
    "print_violation_report",
    "calculate_signed_area",
    "signed_area_terms",
    "add_dirichlet_mixture_noise",
    "create_full_benchmark",
    "get_unprocessed_windows",
    "subset_data",
    "preprocess_data",
    "load_matching_results",
    "prepare_window",
    "solve_prepared",
    "finalize_window",
]
