"""The share of the traced training window in which no device operation
ran: 1 - (union of the device intervals) / window."""
from benchmark.readers import idle_percent


def read(run):
    return idle_percent(run)
