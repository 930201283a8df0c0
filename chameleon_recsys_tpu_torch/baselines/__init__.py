"""Classical baselines that run beside CHAMELEON in the temporal harness.

The port's copies of ``chameleon_recsys_tpu/baselines``: the benchmark
contract (``benchmarks.py``) and the two baselines ported so far, recently
popular and sequential rules.  The others (item co-occurrence, item-kNN,
session-kNN, content-based, candidate sampling) and the neural baselines
come with the baselines slice.
"""
from .benchmarks import BenchmarkRecommender, StreamStateView
from .recently_popular import RecentlyPopularRecommender
from .sequential_rules import SequentialRulesRecommender

__all__ = [
    "BenchmarkRecommender",
    "StreamStateView",
    "RecentlyPopularRecommender",
    "SequentialRulesRecommender",
]
