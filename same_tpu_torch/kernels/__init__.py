"""Hand-written Hopper kernels of the port, each beside its plain twin.

``auction_loop`` is one whole auction solve as one persistent launch (the
main path), ``auction_loop_batch`` (K5) the same for a batch of windows in
one launch; ``auction_bid`` (K1) is a single bidding round on the same
device bodies, kept as the test entry; ``tear_metrics`` (K2) is the tear
round's flip test and cheapest-to-move vertex, ``tear_metrics_batch`` (K6)
the same for a batch of windows; ``radius_knn`` (K3) is the
brute-force device kNN and ``sinkhorn_sparse`` (K4) the Sinkhorn warm start's
iterations, both run only where a window selects them. A wrapper runs the plain
PyTorch twin for CPU tensors and the CUDA kernel for CUDA tensors; it never
falls back from one to the other.
"""

from .auction_bid import auction_bid, auction_bid_plain
from .auction_loop import (
    auction_loop,
    auction_loop_batch,
    auction_loop_batch_plain,
    auction_loop_plain,
)
from .radius_knn import radius_knn, radius_knn_plain
from .sinkhorn_sparse import sinkhorn_sparse, sinkhorn_sparse_plain
from .tear_metrics import (
    tear_metrics,
    tear_metrics_batch,
    tear_metrics_batch_plain,
    tear_metrics_plain,
)

__all__ = [
    "auction_bid", "auction_bid_plain", "auction_loop", "auction_loop_batch",
    "auction_loop_batch_plain", "auction_loop_plain",
    "radius_knn", "radius_knn_plain", "sinkhorn_sparse", "sinkhorn_sparse_plain",
    "tear_metrics", "tear_metrics_batch", "tear_metrics_batch_plain",
    "tear_metrics_plain",
]
