"""Shared host-compute lock for the window pipeline.

The solve of one window has two resource phases: device-bound tearing
separation (the auction loop, blocked on accelerator results) and host-bound
finishing (incumbent evaluation + HiGHS component repair — scipy's HiGHS
wrapper releases the GIL, measured >98% free during multi-second solves).
``sliding_window_matching`` overlaps them across windows with a small thread
pool; ``HOST_LOCK`` serializes every host-heavy stage so the wall-clock-
budgeted repair never competes for cores with another window's host work
(repair quality is load-sensitive — see ARCHITECTURE.md). Uncontended in
sequential runs.
"""

from __future__ import annotations

import threading

HOST_LOCK = threading.RLock()
