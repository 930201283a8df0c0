"""The fused scorer's forward and backward kernels against the least time
of the scorer's work in the traced train hours, in %."""
from benchkit.layers import scorer_roofline


def read(run):
    return scorer_roofline(run, train=True)
