"""PyTorch + CUDA port of chameleon_recsys_tpu, slice by slice.

The JAX package beside this one is the reference: each ported module is held
against it by the ``tests/test_torch_*.py`` parity tests.  This package
imports neither JAX nor anything of the JAX package.  Its entry points run on
``cuda`` unless the caller passes ``device="cpu"``; on the CPU each
hand-written kernel's wrapper runs its plain PyTorch twin.

Float32 parity runs on the card need ``torch.backends.cuda.matmul.allow_tf32``
and ``torch.backends.cudnn.allow_tf32`` off; ``chip_smoke.py`` sets both.

Ported so far: the NAR serving path (``NARServer.recommend`` / ``observe``)
and the NAR eval step (``train.steps.eval_step``: the grid sampler, the pooled
and ranked forward), with the UGRNN forward (``ops/kernels/ugrnn.py``) and the
fused candidate scorer forward (``ops/kernels/cand_scorer.py``) as CUDA
kernels.
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
