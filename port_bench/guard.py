"""The check that a run loaded nothing of JAX or of the JAX package.

Names are compared by their whole top-level part (before the first dot):
``same_tpu_torch`` is the program and passes, ``same_tpu`` is the JAX
package and does not.
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "same_tpu")


def forbidden_loaded(modules=None):
    """Sorted top-level names of loaded modules that are forbidden."""
    modules = sys.modules if modules is None else modules
    tops = {name.split(".", 1)[0] for name in modules}
    return sorted(tops & set(FORBIDDEN))
