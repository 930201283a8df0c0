"""GRU4Rec's Adagrad update against the least time its semantics need: the
bytes of every parameter element the traced steps may change (value,
gradient and accumulator read, value and accumulator written: the touched
rows of the item tables, from the system's counter ``gru4rec.rows_touched``,
and the other parameters whole) at the card's HBM rate, over the device
time of the kernels launched under the span ``gru4rec.update``, in %."""
from benchkit.gru4rec_work import update_roofline


def read(run):
    return update_roofline(run)
