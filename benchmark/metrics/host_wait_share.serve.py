"""The share of the traced recommend calls the host spends in the copies
of the answer to the host (the span ``nar.serve.wait``), waiting for the
card, in %."""
from benchkit.spans import stretch_share


def read(run):
    return stretch_share(run, "nar.serve.wait")
