from . import distributed
from .shard import (
    make_mesh,
    solve_window_batch,
    solve_windows_sharded,
    stack_problems,
)

__all__ = [
    "distributed",
    "make_mesh",
    "solve_window_batch",
    "solve_windows_sharded",
    "stack_problems",
]
