"""Host ms of the serving collation a traced recommend call (the span
``nar.serve.collate``: ``NARServer._collate_serving`` and the request's
copies to the card)."""
from benchkit.spans import ms_per_call


def read(run):
    return ms_per_call(run, "nar.serve.collate")
