"""Host ms of one ``GRU4Rec.fit_batch`` call in the traced train hours (the
span ``neural.step``: the pool, the draw, the forward, the backward and
the update, dispatched)."""
from benchkit.spans import ms_per_call


def read(run):
    return ms_per_call(run, "neural.step")
