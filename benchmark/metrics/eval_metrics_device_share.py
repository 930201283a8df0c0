"""The share of the traced eval batches whose metric set the eval step
folded on the card (calls of the span ``nar.eval.metrics.device`` over
calls of ``nar.eval.metrics``), in %.  Nothing where the system folded no
batch in the stretch."""
from benchkit.spans import snapshot


def read(run):
    spans = snapshot()
    folded = spans.get("nar.eval.metrics.device", (0.0, 0))[1]
    batches = spans.get("nar.eval.metrics", (0.0, 0))[1]
    if run.trace_summary is None or not batches or not folded:
        return None
    return 100.0 * folded / batches
