"""Hand-written CUDA kernels, each beside its plain PyTorch twin."""
from importlib import import_module
from typing import Dict, Mapping

# each count's module and the global its wrapper counts launches in
_COUNTERS = {
    "cand_score_fwd": ("cand_scorer", "launches"),
    "cand_score_fwd_stash": ("cand_scorer", "stash_launches"),
    "cand_score_bwd": ("cand_scorer", "bwd_launches"),
    "cand_score_bwd_recompute": ("cand_scorer", "bwd_recompute_launches"),
    "ugrnn_fwd": ("ugrnn", "launches"),
    "ugrnn_bwd": ("ugrnn", "bwd_launches"),
    "ugrnn_fwd_resident": ("ugrnn", "resident_launches"),
    "ugrnn_fwd_stream": ("ugrnn", "stream_launches"),
    "ugrnn_bwd_resident": ("ugrnn", "bwd_resident_launches"),
    "ugrnn_bwd_stream": ("ugrnn", "bwd_stream_launches"),
}


def _counter(key: str):
    module, name = _COUNTERS[key]
    return import_module(f"{__name__}.{module}"), name


def launch_counts() -> Dict[str, int]:
    """This process's kernel launches so far, by kernel and by UGRNN
    instantiation (each wrapper counts where it launches its kernel)."""
    return {key: getattr(*_counter(key)) for key in _COUNTERS}


def add_launch_counts(counts: Mapping[str, int]) -> None:
    """Add ``counts`` (by ``launch_counts``' keys) to the counters: the
    launches of a replayed CUDA graph, which passes no wrapper."""
    for key, n in counts.items():
        module, name = _counter(key)
        setattr(module, name, getattr(module, name) + n)
