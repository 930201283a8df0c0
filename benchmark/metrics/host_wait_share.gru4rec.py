"""The share of the traced train hours the host spends in the hour's
closing fetch of its losses (the span ``neural.wait``), waiting for the
card, in %."""
from benchkit.spans import stretch_share


def read(run):
    return stretch_share(run, "neural.wait")
