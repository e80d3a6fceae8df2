"""Hand-written Hopper kernels of the port, each beside its plain twin.

``auction_bid`` (K1) is the auction's bidding round; ``tear_metrics`` (K2)
is the tear round's flip test and cheapest-to-move vertex. A wrapper runs
the plain PyTorch twin for CPU tensors and the CUDA kernel for CUDA tensors;
it never falls back from one to the other.
"""

from .auction_bid import auction_bid, auction_bid_plain
from .tear_metrics import tear_metrics, tear_metrics_plain

__all__ = ["auction_bid", "auction_bid_plain", "tear_metrics", "tear_metrics_plain"]
