"""PyTorch + CUDA port of chameleon_recsys_tpu, slice by slice.

The JAX package beside this one is the reference: each ported module is held
against it by the ``tests/test_torch_*.py`` parity tests.  This package
imports neither JAX nor anything of the JAX package.  Its entry points run on
``cuda`` unless the caller passes ``device="cpu"``; on the CPU each
hand-written kernel's wrapper runs its plain PyTorch twin.

Float32 parity runs on the card need ``torch.backends.cuda.matmul.allow_tf32``
and ``torch.backends.cudnn.allow_tf32`` off; ``chip_smoke.py`` sets both.

Ported so far: the NAR serving path (``NARServer.recommend`` / ``observe``),
the NAR eval step (``train.steps.eval_step``: the grid sampler, the pooled
and ranked forward) and the NAR train step (``train.steps.train_step``:
valid-row compaction, the row sampler, the pooled train forward, XE + L2 -
novelty, Adam, the stream update), with the UGRNN forward and backward
(``ops/kernels/ugrnn.py``) and the fused candidate scorer's forward, stash
forward and backward (``ops/kernels/cand_scorer.py``) as CUDA kernels.
"""
from .config import (
    ArticleFeaturesSchema,
    FeatureSpec,
    InternalFeaturesConfig,
    NARConfig,
    SessionFeaturesSchema,
)
from .models.nar import NARModel
from .serve import NARServer

__all__ = [
    "ArticleFeaturesSchema",
    "FeatureSpec",
    "InternalFeaturesConfig",
    "NARConfig",
    "NARModel",
    "NARServer",
    "SessionFeaturesSchema",
]
