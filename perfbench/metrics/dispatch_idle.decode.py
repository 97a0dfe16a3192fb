"""The card's idle time while the serving session schedules a chunk
(``session.schedule``) and dispatches it (``decode.dispatch`` outside its
``decode.wait``: the graph's pointer check, the input copy and the first
replay's launch, before the card has the chunk's work), over the span
stretch's Slice (``perfbench/spans.py``)."""
from perfbench import spans


def read(run):
    return spans.idle_share(run, spans.DISPATCH)
