"""The share of the traced eval steps that replayed a CUDA graph (calls of
the span ``nar.eval.replay`` over calls of ``nar.eval.dispatch``), in %.
Nothing where the system neither captured nor replayed a graph in the
stretch (``nar.eval.capture``)."""
from benchkit.spans import snapshot


def read(run):
    spans = snapshot()
    replays = spans.get("nar.eval.replay", (0.0, 0))[1]
    captures = spans.get("nar.eval.capture", (0.0, 0))[1]
    dispatches = spans.get("nar.eval.dispatch", (0.0, 0))[1]
    if run.trace_summary is None or not dispatches or not (replays or captures):
        return None
    return 100.0 * replays / dispatches
