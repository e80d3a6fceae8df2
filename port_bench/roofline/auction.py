"""Least bytes one auction solve of a window needs, from the inputs' shapes.

An assignment of ``n_rows`` aligned rows over their candidate entries (one
entry per candidate pair and unit of the reference's capacity) reads each
entry's cost (float32), slot id (int32) and validity flag (one byte) once,
each slot's price (float32) once, and writes each row's assignment (int32)
once. Whatever implements the solve, these are the bytes that its inputs
and its output hold; the time the card needs for them at its peak bandwidth
is the floor that a solve's device time is set against.
"""

from __future__ import annotations

H100_SXM_BYTES_PER_S = 3.35e12   # NVIDIA H100 SXM data sheet, HBM3


def solve_bytes(n_rows, n_entries, n_slots):
    return 9 * int(n_entries) + 4 * int(n_slots) + 4 * int(n_rows)


def floor_seconds(n_rows, n_entries, n_slots, bytes_per_s=H100_SXM_BYTES_PER_S):
    return solve_bytes(n_rows, n_entries, n_slots) / bytes_per_s

