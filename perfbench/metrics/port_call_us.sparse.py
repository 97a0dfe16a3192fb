"""Microseconds a product inside the port's ``core.spmv`` / ``core.spmm``
call (its ``sparse.call`` span: dispatch, plan cache, launcher), over the
span stretch's products, each enqueued while a spin kernel holds the card
(``perfbench/spans.py``): the host's own time, whatever the card's pace."""
from perfbench import spans


def read(run):
    return spans.per_product_us(run, "sparse.call")
