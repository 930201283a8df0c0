"""The fused scorer's forward kernel against the least time of the
scorer's work in the traced eval hours, in %."""
from benchkit.layers import scorer_roofline


def read(run):
    return scorer_roofline(run, train=False)
