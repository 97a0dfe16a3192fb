"""K1's share of its roofline in the traced slice: the products' bound
(from the CSR's nonzeros) over the device time of K1's kernels."""
from perfbench import readers


def read(run):
    return readers.product_roofline(run, readers.K1)
