"""Robustness utilities: cell-type probability noise injection.

Fills the reference's *missing* ``src/robustness_utils.py`` module — the
heart robustness sweep imports ``add_dirichlet_mixture_noise`` with this
exact signature (reference examples/heart/run_robustness.sh:47,64-66):
mix each cell's type-probability vector with an i.i.d. Dirichlet sample,
``noise=0`` leaving the original and ``noise=1`` fully random, keeping the
row sum at ``target_sum``.

Copy of ``same_tpu/robustness.py`` (no device code).
"""

from __future__ import annotations

import numpy as np
import pandas as pd


def add_dirichlet_mixture_noise(
    df: pd.DataFrame,
    cell_type_cols,
    noise: float,
    target_sum: float = 100.0,
    rng: np.random.Generator | None = None,
    inplace: bool = False,
) -> pd.DataFrame:
    """Mix cell-type probability columns with Dirichlet noise.

    new_probs = (1 - noise) * original + noise * Dirichlet(1, ..., 1),
    rescaled so every row sums to ``target_sum``.
    """
    if not 0.0 <= noise <= 1.0:
        raise ValueError(f"noise must be in [0, 1], got {noise}")
    if rng is None:
        rng = np.random.default_rng()
    if not inplace:
        df = df.copy()

    cols = list(cell_type_cols)
    probs = df[cols].to_numpy(dtype=float)
    row_sums = probs.sum(axis=1, keepdims=True)
    safe = np.where(row_sums > 0, row_sums, 1.0)
    probs_norm = probs / safe

    dirichlet = rng.dirichlet(np.ones(len(cols)), size=len(df))
    mixed = (1.0 - noise) * probs_norm + noise * dirichlet
    mixed = mixed / mixed.sum(axis=1, keepdims=True) * target_sum
    df[cols] = mixed
    return df
