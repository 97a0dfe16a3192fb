"""The card's idle time while the serving session admits (the innermost
open span on its track ``session.admit``, or a request's eager
``session.prefill`` through its first token's read-back), over the span
stretch's Slice (``perfbench/spans.py``)."""
from perfbench import spans


def read(run):
    return spans.idle_share(run, spans.ADMIT)
