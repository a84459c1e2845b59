"""% of the traced slice in which no operation ran on the device."""

from benchmark import readers


def read(sl):
    return readers.idle_share(sl)
