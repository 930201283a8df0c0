"""The share of the traced recommend calls whose scoring replayed a CUDA
graph (calls of the span ``nar.serve.replay`` over calls of
``nar.serve.score``), in %.  Nothing where the system neither captured
nor replayed a graph in the stretch (``nar.serve.capture``)."""
from benchkit.spans import snapshot


def read(run):
    spans = snapshot()
    replays = spans.get("nar.serve.replay", (0.0, 0))[1]
    captures = spans.get("nar.serve.capture", (0.0, 0))[1]
    scores = spans.get("nar.serve.score", (0.0, 0))[1]
    if run.trace_summary is None or not scores or not (replays or captures):
        return None
    return 100.0 * replays / scores
