"""The share of the traced eval hours the host spends waiting for each
batch's fetches (the span ``nar.eval.wait``), in %."""
from benchkit.spans import stretch_share


def read(run):
    return stretch_share(run, "nar.eval.wait")
