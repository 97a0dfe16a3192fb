"""Microseconds a product inside the port's launcher (its
``sparse.launch`` span: device checks, work list, output allocation, the
kernel's launch), over the span stretch's products, each enqueued while
a spin kernel holds the card (``perfbench/spans.py``)."""
from perfbench import spans


def read(run):
    return spans.per_product_us(run, "sparse.launch")
