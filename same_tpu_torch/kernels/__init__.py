"""Hand-written Hopper kernels of the port, each beside its plain twin.

``auction_loop`` is one whole auction solve as one persistent launch (the
main path), ``auction_loop_batch`` (K5) the same for a batch of windows in
one launch; ``auction_bid`` (K1) is a single bidding round on the same
phase code, kept as the test entry; ``tear_metrics`` (K2) is the tear
round's flip test and cheapest-to-move vertex, ``tear_metrics_batch`` (K6)
the same for a batch of windows; ``radius_knn`` (K3) is the
device kNN over a grid of cells and ``sinkhorn_sparse`` (K4) the Sinkhorn warm start's
iterations, both run only where a window selects them; ``tear_scalars`` (K7)
and ``register_cuts`` (K8) are the rest of a tear round (the stop rule's
six values; cut registration and surcharge) in both tear loops;
``bid_compute`` (K9) is the compute-only bid step of the Pallas
microbenchmark and ``sinkhorn_dense`` (K10) the dense Sinkhorn op. A wrapper
runs the plain PyTorch twin for CPU tensors and the CUDA kernel for CUDA
tensors; it never falls back from one to the other.
"""

from .auction_bid import auction_bid, auction_bid_plain
from .auction_loop import (
    auction_loop,
    auction_loop_batch,
    auction_loop_batch_plain,
    auction_loop_plain,
)
from .bid_compute import bid_compute, bid_compute_plain
from .radius_knn import radius_knn, radius_knn_plain
from .sinkhorn_dense import sinkhorn_dense, sinkhorn_dense_plain
from .sinkhorn_sparse import sinkhorn_sparse, sinkhorn_sparse_plain
from .tear_metrics import (
    tear_metrics,
    tear_metrics_batch,
    tear_metrics_batch_plain,
    tear_metrics_plain,
)
from .tear_round import (
    register_cuts,
    register_cuts_plain,
    tear_scalars,
    tear_scalars_plain,
)

__all__ = [
    "auction_bid", "auction_bid_plain", "auction_loop", "auction_loop_batch",
    "auction_loop_batch_plain", "auction_loop_plain", "bid_compute",
    "bid_compute_plain", "radius_knn", "radius_knn_plain", "register_cuts",
    "register_cuts_plain", "sinkhorn_dense", "sinkhorn_dense_plain",
    "sinkhorn_sparse", "sinkhorn_sparse_plain", "tear_metrics",
    "tear_metrics_batch", "tear_metrics_batch_plain", "tear_metrics_plain",
    "tear_scalars", "tear_scalars_plain",
]
