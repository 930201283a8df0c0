"""The UGRNN kernels (forward and backward) against the least time of the
recurrences in the traced train hours, in %."""
from benchkit.layers import ugrnn_roofline


def read(run):
    return ugrnn_roofline(run, train=True)
