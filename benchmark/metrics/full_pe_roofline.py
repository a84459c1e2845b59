"""full_pe's share of its roofline: the least time of its launches (their
FLOPs at the peak or bytes at the HBM rate) in their device time."""

from benchmark import readers


def read(sl):
    return readers.roofline(sl, ("full_pe",))
