"""Host ms of ``NARServer.default_candidates`` a traced recommend call
(the span ``nar.serve.candidates``: the buffer's copy to the host and its
most recent distinct articles)."""
from benchkit.spans import ms_per_call


def read(run):
    return ms_per_call(run, "nar.serve.candidates")
