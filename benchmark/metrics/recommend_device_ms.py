"""Device-busy time per recommend call in the traced calls, in ms."""


def read(run):
    tr = run.trace_summary
    if tr is None or not tr.units or tr.busy_s <= 0:
        return None
    return 1e3 * tr.busy_s / tr.units
