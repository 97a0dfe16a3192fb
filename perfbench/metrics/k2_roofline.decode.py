"""K2's share of its roofline in the decode step: the down-projections'
bound at the slots' width (from their nonzeros) for each decode step in
the traced slice, over the device time of the K2 kernels the decode
step's CUDA graph launched."""
from perfbench import readers


def read(run):
    return readers.decode_w_out_roofline(run)
