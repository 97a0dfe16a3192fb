"""Model operations of every token the window processed (prompts and
decoded tokens, from the configuration's shapes) over the window at the
serving dtype's peak."""
from perfbench import readers


def read(run):
    return readers.mfu_percent(run)
