"""K2's share of its roofline at the cell's width (the vectors of each
product): the products' bound (from the CSR's nonzeros) over the device
time of K2's kernels in the traced slice."""
from perfbench import readers


def read(run):
    return readers.product_roofline(run, readers.K2)
