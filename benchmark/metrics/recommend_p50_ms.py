"""Median host-clock latency of the window's recommend calls, in ms."""
from benchkit.layers import median_ms


def read(run):
    return median_ms(run.host.get("latency_s"))
