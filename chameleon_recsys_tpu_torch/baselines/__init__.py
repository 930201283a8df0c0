"""Classical baselines that run beside CHAMELEON in the temporal harness.

The port's copies of ``chameleon_recsys_tpu/baselines``: the benchmark
contract (``benchmarks.py``), the six classical baselines of the G1 trainer
(recently popular, item co-occurrence, item-kNN, session-kNN on its numpy
path, content-based, sequential rules) and the host candidate sampler.  The
neural baselines (GRU4Rec, SR-GNN) come with a later slice.
"""
from .benchmarks import BenchmarkRecommender, StreamStateView
from .candidate_sampling import CandidateSamplingManager
from .content_based import ContentBasedRecommender
from .item_cooccurrence import ItemCooccurrenceRecommender
from .item_knn import ItemKNNRecommender
from .recently_popular import RecentlyPopularRecommender
from .sequential_rules import SequentialRulesRecommender
from .session_knn import SessionBasedKNNRecommender

__all__ = [
    "BenchmarkRecommender",
    "StreamStateView",
    "CandidateSamplingManager",
    "ContentBasedRecommender",
    "ItemCooccurrenceRecommender",
    "ItemKNNRecommender",
    "RecentlyPopularRecommender",
    "SequentialRulesRecommender",
    "SessionBasedKNNRecommender",
]
