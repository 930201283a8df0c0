"""The model's operations over the window (3x the forward's in training)
over its time at the card's peak for the configuration's type, in %."""
from benchkit.layers import mfu


def read(run):
    return mfu(run)
