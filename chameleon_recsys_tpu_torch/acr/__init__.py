"""ACR (Article Content Representation): the ACE side-task trainer and the
ACR->NAR handoff (port of ``chameleon_recsys_tpu/acr/``)."""
from .trainer import ACRTrainer, export_ace_pickle

__all__ = ["ACRTrainer", "export_ace_pickle"]
