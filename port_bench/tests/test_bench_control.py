"""Each cell's control (the reference in the program's place with one
guarantee of the configuration broken) comes out not correct, at a size
that a test run holds."""

import pytest

from port_bench import control, spec

SMALL = {
    "luad.dp25.window": {"traffic": {"n_cells": 3000, "extent": 4500}},
}


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_control_comes_out_not_correct(workload):
    names = control.controls_of(spec.Cell(workload))
    failed_any = False
    for name in names:
        checks, limits = control.control_checks(workload, 2**32 + 1, 1, name,
                                                overrides=SMALL[workload])
        failed = [k for k in limits if checks[k] > limits[k]]
        failed_any = failed_any or bool(failed)
        if name == "capacity_free":
            assert checks["infeasible"] > 0
    assert failed_any
