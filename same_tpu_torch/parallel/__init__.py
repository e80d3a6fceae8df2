from .shard import (
    make_mesh,
    solve_window_batch,
    solve_windows_sharded,
    stack_problems,
)

__all__ = [
    "make_mesh",
    "solve_window_batch",
    "solve_windows_sharded",
    "stack_problems",
]
