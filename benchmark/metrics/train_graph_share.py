"""The share of the traced train steps that replayed a CUDA graph (calls of
the span ``nar.train_step.replay`` over calls of ``nar.train_step``), in %.
Nothing where the system neither captured nor replayed a graph in the
stretch (``nar.train_step.capture``)."""
from benchkit.spans import snapshot


def read(run):
    spans = snapshot()
    replays = spans.get("nar.train_step.replay", (0.0, 0))[1]
    captures = spans.get("nar.train_step.capture", (0.0, 0))[1]
    steps = spans.get("nar.train_step", (0.0, 0))[1]
    if run.trace_summary is None or not steps or not (replays or captures):
        return None
    return 100.0 * replays / steps
