"""Artifact I/O: load/save of per-window solve results.

Artifact layout per ``outprefix`` matches the reference
(src/same.py:1455-1481; src/helpers.py:667-689): ``var_out.npy`` (pickled
dict), ``aligned_df.csv``, ``ref_df.csv``, ``matches_df.csv``, plus the
rolling ``matchedDF.csv`` checkpoint at the sliding-window level.

Copy of ``same_tpu/io.py`` (no device code).
"""

from __future__ import annotations

import os

import numpy as np
import pandas as pd


def load_matching_results(outprefix: str):
    """Load saved solve artifacts (reference src/helpers.py:667-689).

    Returns ``(var_out, aligned_df, ref_df, matches_df)``.
    """
    var_out = np.load(
        os.path.join(outprefix, "var_out.npy"), allow_pickle=True
    ).item()
    aligned_df = pd.read_csv(os.path.join(outprefix, "aligned_df.csv"))
    ref_df = pd.read_csv(os.path.join(outprefix, "ref_df.csv"))
    matches_df = pd.read_csv(os.path.join(outprefix, "matches_df.csv"))
    return var_out, aligned_df, ref_df, matches_df
