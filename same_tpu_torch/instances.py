"""The LUAD-scale benchmark window as input data.

Copy of ``bench.py::make_instance`` (numpy and pandas only), so that the
port's scripts build the same window without importing the JAX package's
bench script: one window of LUAD-like tissue, five spatially coherent cell
types with probability columns x100, two jittered copies (the aligned one
keeps 94 % of the cells).
"""

from __future__ import annotations

import numpy as np
import pandas as pd

LUAD_TYPES = ["B cell", "Epithelial", "Mesenchymal", "Myeloid", "T cell"]


def make_instance(n_cells=25000, extent=13000.0, seed=3):
    """One window of LUAD-like tissue: blobby type regions, probs x100."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, extent, (n_cells, 2))
    centers = rng.uniform(0, extent, (len(LUAD_TYPES) * 6, 2))
    center_type = rng.integers(0, len(LUAD_TYPES), len(centers))
    d = ((xy[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
    types = center_type[np.argmin(d, axis=1)]
    probs = np.full((n_cells, len(LUAD_TYPES)), 2.0)
    probs[np.arange(n_cells), types] = 86.0
    probs += rng.uniform(0, 2, probs.shape)
    probs = probs / probs.sum(1, keepdims=True) * 100.0

    def frame(jseed, keep_frac=1.0):
        r = np.random.default_rng(jseed)
        keep = r.random(n_cells) < keep_frac
        df = pd.DataFrame(
            xy[keep] + r.normal(0, 15.0, (int(keep.sum()), 2)),
            columns=["X", "Y"],
        )
        df["cell_type"] = np.asarray(LUAD_TYPES)[types[keep]]
        for k, nm in enumerate(LUAD_TYPES):
            df[nm] = probs[keep, k]
        df["Cell_Num_Old"] = np.arange(len(df))
        return df

    return frame(1), frame(2, keep_frac=0.94), list(LUAD_TYPES)
