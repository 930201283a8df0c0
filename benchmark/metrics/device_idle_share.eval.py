"""The share of the traced stretch in which no operation ran on the
device, in %."""
from benchkit.layers import idle_share


def read(run):
    return idle_share(run)
