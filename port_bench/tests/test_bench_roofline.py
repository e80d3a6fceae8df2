"""The auction's byte count, on the LUAD window's shapes."""

import numpy as np
import pandas as pd

from port_bench.reference.window import problem_shapes
from port_bench.roofline import auction


def test_bytes_on_the_luad_window_shapes():
    # The LUAD window: 10,681 aligned rows, up to 8 candidates of capacity
    # up to 3 (S = 28,672 slots padded; 24 columns a row).
    n_rows, n_entries, n_slots = 10681, 10681 * 8 * 3, 28672
    b = auction.solve_bytes(n_rows, n_entries, n_slots)
    assert b == 9 * 256344 + 4 * 28672 + 4 * 10681
    assert b == 2464508
    np.testing.assert_allclose(auction.floor_seconds(n_rows, n_entries, n_slots),
                               2464508 / 3.35e12)


def test_shapes_count_capacity_per_candidate():
    ref = pd.DataFrame({"X": [0.0, 100.0, 1000.0], "Y": [0.0, 0.0, 0.0],
                        "size": [3, 1, 1], "metacell_id": [0, 1, 2]})
    aligned = pd.DataFrame({"X": [10.0, 90.0, 5000.0], "Y": [0.0, 0.0, 0.0],
                            "size": [1, 1, 1], "metacell_id": [0, 1, 2]})
    optim = {"radius": 250, "knn": 8, "max_matches": 1,
             "ref_metacell_match_multiplier": 3}
    # rows 0 and 1 see refs 0 (capacity 3) and 1 (capacity 1); row 2 none.
    assert problem_shapes(ref, aligned, optim) == (2, 8, 4)
