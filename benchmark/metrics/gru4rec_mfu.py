"""GRU4Rec's operations over the window (3x the forward's: the GRU's
products and the [T, B, B + n] scores of every batch) over its time at the
card's float32 peak, in %."""
from benchkit.gru4rec_work import mfu


def read(run):
    return mfu(run)
