"""The card's idle share of the traced slice: 1 − busy / window, busy the
union of the device activities the profiler recorded."""
from perfbench import readers


def read(run):
    return readers.idle_percent(run)
