"""The card's idle time while the serving session commits a chunk's
tokens (``session.commit``: the per-step, per-slot loop, finishes, page
releases), over the span stretch's Slice (``perfbench/spans.py``)."""
from perfbench import spans


def read(run):
    return spans.idle_share(run, spans.COMMIT)
