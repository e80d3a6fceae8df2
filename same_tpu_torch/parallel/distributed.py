"""Multi-process window grid: ``torch.distributed`` set-up and window sharding.

Port of ``same_tpu/parallel/distributed.py``. The reference is
single-process (SURVEY §2.4): windows are embarrassingly parallel and only
the final merge is global. The multi-process mode keeps that shape:

1. every process calls :func:`init_distributed` (torchrun's ``env://``
   variables, or an explicit ``host:port`` address, world size and rank);
2. every process runs the same ``sliding_window_matching(...,
   host_shard=True)`` call: the window grid is computed from the full extent
   on every process, and each keeps the contiguous block of windows that
   :func:`host_window_slice` gives it and solves those on its own ``device``;
3. :func:`gather_matches` brings every process's match frame to the root,
   which runs the uniqueness merge (``merge_window_matches_unique_ref``).

The process group uses the gloo backend, whose collectives run on CPU
tensors. Two ranks may share one card (each with its own CUDA context), and
NCCL refuses two ranks on one GPU; and the only collective is the gather of
the match frames' CSV bytes, which is host data anyway (the JAX package
carries it over jax.distributed's coordination service).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

# torchrun's variables; all four present select the env:// rendezvous.
TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")

# A rank that died or hangs fails its peers' collectives after this long,
# not after torch's default 30 minutes. It also bounds the root's wait in
# gather_matches for the slowest rank's windows: a grid whose ranks finish
# further apart passes a larger ``timeout_s``.
DEFAULT_TIMEOUT_S = 600.0


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Join the gloo process group; returns True when running multi-process.

    With ``coordinator_address`` (``"host:port"``) the group meets there over
    TCP with ``num_processes`` ranks, this one ``process_id``; a failure
    raises ``RuntimeError``. Without it, torchrun's variables (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) are used where they are set,
    and otherwise it returns False without error, so that callers share one
    code path::

        from same_tpu_torch.parallel import distributed
        distributed.init_distributed()
        local = sliding_window_matching(..., host_shard=True)
        merged = distributed.gather_matches(local)   # None off the root

    A group that already exists is kept as it is.
    """
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator_address is not None:
        init_method = f"tcp://{coordinator_address}"
    elif all(v in os.environ for v in TORCHRUN_VARS):
        init_method = "env://"
    else:
        return False
    if not dist.is_available():
        raise RuntimeError("torch.distributed is not available in this torch build")
    try:
        dist.init_process_group(
            "gloo", init_method=init_method,
            world_size=-1 if num_processes is None else int(num_processes),
            rank=-1 if process_id is None else int(process_id),
            timeout=datetime.timedelta(seconds=timeout_s),
        )
    except (RuntimeError, ValueError) as e:
        raise RuntimeError(
            f"torch.distributed initialization ({init_method}) failed: {e}"
        ) from e
    return dist.get_world_size() > 1


def process_index() -> int:
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes; 1 without a process group."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def host_window_slice(n_windows: int) -> slice:
    """The contiguous block of window indices this process solves and
    finalizes. Blocks are balanced to within one window."""
    p = process_index()
    P = process_count()
    bounds = np.linspace(0, n_windows, P + 1).astype(int)
    return slice(int(bounds[p]), int(bounds[p + 1]))


def gather_matches(local_df, root: int = 0):
    """Bring every process's match frame to the root process.

    Returns the frames concatenated in rank order on the root (empty payloads
    skipped) and ``None`` elsewhere. Single-process: returns ``local_df``
    unchanged.
    """
    if process_count() == 1:
        return local_df

    import io

    import pandas as pd

    payload = torch.from_numpy(
        np.frombuffer(local_df.to_csv(index=False).encode(), dtype=np.uint8).copy()
    )
    # all_gather needs equal shapes: agree on the longest payload first.
    lengths = [torch.zeros(1, dtype=torch.int64) for _ in range(process_count())]
    dist.all_gather(lengths, torch.tensor([payload.numel()], dtype=torch.int64))
    max_len = max(int(n) for n in lengths)
    padded = torch.zeros(max_len, dtype=torch.uint8)
    padded[: payload.numel()] = payload
    gathered = [torch.zeros(max_len, dtype=torch.uint8) for _ in lengths]
    dist.all_gather(gathered, padded)
    if process_index() != root:
        return None
    frames = []
    for row, n in zip(gathered, lengths):
        if int(n) == 0:
            continue
        text = row[: int(n)].numpy().tobytes().decode()
        frames.append(pd.read_csv(io.StringIO(text)))
    return pd.concat(frames, ignore_index=True)
