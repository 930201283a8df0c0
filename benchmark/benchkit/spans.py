"""The system's own spans over a run's profiled stretch.

The system times its spans (``chameleon_recsys_tpu_torch.utils.profiling``:
``span``, the registry ``span_snapshot``) while a torch profiler runs, and
a run profiles once, in ``trace.profile`` after the window, so the registry
holds that stretch: the calls the traced hours or requests made, timed
with the profiler on.  It is read from the module the system loaded;
nothing here imports the system, and a system without the registry gives
nothing to read."""
from __future__ import annotations

import sys
from typing import Dict, Optional, Tuple

REGISTRY = "chameleon_recsys_tpu_torch.utils.profiling"


def snapshot() -> Dict[str, Tuple[float, int]]:
    """{span name: (seconds, calls)}; empty where the system has none."""
    read = getattr(sys.modules.get(REGISTRY), "span_snapshot", None)
    return read() if read is not None else {}


def ms_per_call(run, name: str) -> Optional[float]:
    """Host ms of one call of span ``name`` in the traced stretch."""
    seconds, calls = snapshot().get(name, (0.0, 0))
    if run.trace_summary is None or not calls:
        return None
    return 1e3 * seconds / calls


def stretch_share(run, name: str) -> Optional[float]:
    """Span ``name``'s seconds over the traced stretch's, in %."""
    tr = run.trace_summary
    seconds, calls = snapshot().get(name, (0.0, 0))
    if tr is None or tr.window_s <= 0 or not calls:
        return None
    return 100.0 * seconds / tr.window_s
