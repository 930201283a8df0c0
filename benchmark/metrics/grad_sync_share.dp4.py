"""The share of rank 0's traced train hours spent summing the gradients
over the data group (the span ``nar.train_step.sync``,
``parallel/sharded.py::sync_grads``), in %."""
from benchkit.spans import stretch_share


def read(run):
    return stretch_share(run, "nar.train_step.sync")
