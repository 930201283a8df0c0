"""The UGRNN forward kernel against the least time of the recurrences in
the traced recommend calls, in %."""
from benchkit.layers import ugrnn_roofline


def read(run):
    return ugrnn_roofline(run, train=False)
