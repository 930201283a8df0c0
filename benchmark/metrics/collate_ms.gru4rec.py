"""Host ms of one pull of a batch from the neural runner's collation
(``data/collate.py::batches_from_sessions``, the span ``neural.collate``)
in the traced train hours."""
from benchkit.spans import ms_per_call


def read(run):
    return ms_per_call(run, "neural.collate")
