"""Hand-written CUDA kernels, each beside its plain PyTorch twin."""
from typing import Dict


def launch_counts() -> Dict[str, int]:
    """This process's kernel launches so far, by kernel and by UGRNN
    instantiation (each wrapper counts where it launches its kernel)."""
    from . import cand_scorer, ugrnn

    return {
        "cand_score_fwd": cand_scorer.launches,
        "cand_score_fwd_stash": cand_scorer.stash_launches,
        "cand_score_bwd": cand_scorer.bwd_launches,
        "cand_score_bwd_recompute": cand_scorer.bwd_recompute_launches,
        "ugrnn_fwd": ugrnn.launches,
        "ugrnn_bwd": ugrnn.bwd_launches,
        "ugrnn_fwd_resident": ugrnn.resident_launches,
        "ugrnn_fwd_stream": ugrnn.stream_launches,
        "ugrnn_bwd_resident": ugrnn.bwd_resident_launches,
        "ugrnn_bwd_stream": ugrnn.bwd_stream_launches,
    }
