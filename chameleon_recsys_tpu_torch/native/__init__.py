"""The native host code (C++ for the CPU, built with ``g++`` at first use):
the session-kNN batch predictor (``sknn``) and the session TFRecord loader
(``loader``), the port's copies of ``chameleon_recsys_tpu/native/``."""
from .loader import NativeSessionLoader, native_available

__all__ = ["NativeSessionLoader", "native_available"]
